"""The port's span recorder (`upgpt_torch/utils/diagnostics.py`) on CPU,
over the tiny model: nothing is recorded while it is off; the pipeline,
the samplers, the U-Net and VAE layers, the serving engine and the train
step record their spans nested as documented, with the ids that tie a
request to its batch; the results are the same bit for bit with the
recorder on and off; and spans read the host wall clock, `time.time_ns`."""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from upgpt_torch.inference.pipeline import GenerationPipeline  # noqa: E402
from upgpt_torch.inference.serving import ServingEngine  # noqa: E402
from upgpt_torch.models.unet import ResBlock, SpatialTransformer  # noqa: E402
from upgpt_torch.training.train_state import (  # noqa: E402
    create_fused_train_state, create_train_state, train_step,
)
from upgpt_torch.utils import diagnostics  # noqa: E402
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

H, W = 32, 24  # tiny's latent grid


def _redraw(model, seed):
    """Every parameter drawn, so no zero-initialised layer hides a path."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if p.dim() >= 2:
                z = z / p[0].numel() ** 0.5
            else:
                z = (1.0 if name.endswith("weight") else 0.0) + 0.1 * z
            p.copy_(z)
    return model


def _cond(seed, batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return {
        "text_emb": rng.normal(size=lead + (77, 768)).astype(np.float32),
        "style_emb": rng.normal(size=lead + (9, 768)).astype(np.float32),
        "smpl": rng.normal(size=lead + (1, 85)).astype(np.float32),
        "person_mask": rng.choice([-1.0, -0.99215686],
                                  size=lead + (H, W, 1)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def model():
    return _redraw(build_latent_diffusion("tiny", device="cpu"), seed=0)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test leaves the recorder off and empty."""
    yield
    diagnostics.stop()
    diagnostics.drain()


def _recorded(fn):
    """(fn's result, the recorder's spans) with the recorder on for fn."""
    diagnostics.start()
    try:
        out = fn()
    finally:
        diagnostics.stop()
    return out, diagnostics.drain()


def _generate(model, sampler, steps=2):
    pipe = GenerationPipeline(model, num_steps=steps, eta=0.0,
                              sampler=sampler, output_uint8=True)
    batch = {k: torch.from_numpy(v) for k, v in _cond(1, batch=2).items()}
    return pipe.generate(batch, torch.Generator().manual_seed(3))


def test_off_records_nothing(model):
    assert diagnostics.span("a") is diagnostics.span("b")
    assert diagnostics.begin("a") is None
    diagnostics.end(None)
    diagnostics.count("a")
    _generate(model, "ddim")
    got = diagnostics.drain()
    assert got["spans"] == [] and got["counters"] == {}
    assert got["dropped"] == 0


def test_buffer_is_bounded_and_counts_what_it_drops():
    diagnostics.start(limit=2)
    for _ in range(5):
        with diagnostics.span("s"):
            pass
    diagnostics.stop()
    got = diagnostics.drain()
    assert len(got["spans"]) == 2 and got["dropped"] == 3


def test_threads_lose_no_span_or_count():
    """Sixteen threads record spans, linked spans and counts at once, with
    the interpreter switching threads as often as it can: every span is
    kept or counted as dropped, and no count is lost."""
    n_threads, n_each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        diagnostics.start(limit=n_threads * n_each)

        def work():
            for i in range(n_each):
                with diagnostics.span("s", step=i):
                    diagnostics.count("c")
                diagnostics.end(diagnostics.begin("q"))

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        diagnostics.stop()
    finally:
        sys.setswitchinterval(old)
    got = diagnostics.drain()
    assert got["counters"] == {"c": n_threads * n_each}
    assert len(got["spans"]) == n_threads * n_each
    assert got["dropped"] == n_threads * n_each
    assert len({s["id"] for s in got["spans"]}) == len(got["spans"])


@pytest.mark.parametrize("sampler", ["ddim", "unipc"])
def test_generate_nests_steps_layers_and_decode(model, sampler):
    steps = 2
    off = _generate(model, sampler, steps)
    on, rec = _recorded(lambda: _generate(model, sampler, steps))
    assert torch.equal(off, on)
    spans = rec["spans"]
    by_id = {s["id"]: s for s in spans}
    names = [s["name"] for s in spans]
    (gen,) = [s for s in spans if s["name"] == "pipeline.generate"]
    assert gen["parent"] == 0
    step_spans = sorted((s for s in spans if s["name"] == "sampler.step"),
                        key=lambda s: s["start_ns"])
    assert [s["step"] for s in step_spans] == list(range(steps))
    for s in spans:
        if s["name"] in ("pipeline.prepare", "pipeline.decode",
                         "sampler.step"):
            assert s["parent"] == gen["id"], s
    unets = [s for s in spans if s["name"] == "unet"]
    assert len(unets) == steps
    assert {by_id[u["parent"]]["name"] for u in unets} == {"sampler.step"}
    n_res = sum(isinstance(m, ResBlock) for m in model.unet.modules())
    n_attn = sum(isinstance(m, SpatialTransformer)
                 for m in model.unet.modules())
    assert n_res and n_attn
    for layer, n in (("unet.resblock", n_res), ("unet.xformer", n_attn)):
        inner = [s for s in spans if s["name"] == layer]
        assert len(inner) == n * steps
        assert {by_id[s["parent"]]["name"] for s in inner} == {"unet"}
        # ids pass down: each layer call carries its step's index
        assert sorted({s["step"] for s in inner}) == list(range(steps))
    (dec,) = [s for s in spans if s["name"] == "vae.decode"]
    assert by_id[dec["parent"]]["name"] == "pipeline.decode"
    assert dec["start_ns"] > step_spans[-1]["end_ns"]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"]:
            up = by_id[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= up["end_ns"]
    assert names.count("pipeline.prepare") == 1


def test_engine_ties_each_request_to_its_batch(model):
    pipe = GenerationPipeline(model, num_steps=2, eta=0.0, output_uint8=True)

    def serve():
        eng = ServingEngine(pipe, batch_size=2, max_delay_s=0.05)
        eng.start()
        futs = [eng.submit(_cond(10 + i)) for i in range(5)]
        out = [f.result(timeout=120) for f in futs]
        eng.stop()
        return out

    out, rec = _recorded(serve)
    assert len(out) == 5
    spans = rec["spans"]
    queue = [s for s in spans if s["name"] == "engine.queue"]
    assert sorted(s["request"] for s in queue) == list(range(5))
    assert all(s["linked"] and s["batch"] is not None for s in queue)

    def per_batch(name):
        got = {}
        for s in spans:
            if s["name"] == name:
                assert s["batch"] not in got, (name, s["batch"])
                got[s["batch"]] = s
        return got

    dispatch, fence, copy, deliver = (per_batch(n) for n in (
        "engine.dispatch", "engine.fence", "engine.copy", "engine.deliver"))
    batches = {s["batch"] for s in queue}
    assert batches == set(dispatch) == set(fence) == set(copy) \
        == set(deliver)
    for s in queue:
        b = s["batch"]
        assert s["end_ns"] <= dispatch[b]["start_ns"]
        assert dispatch[b]["end_ns"] <= fence[b]["start_ns"] \
            <= copy[b]["start_ns"]
        assert fence[b]["parent"] == copy[b]["parent"] == deliver[b]["id"]
    gens = [s for s in spans if s["name"] == "pipeline.generate"]
    assert {s["batch"] for s in gens} == batches
    # the engine's thread records the batch spans, the client's the waits
    engine_threads = {s["thread"] for s in dispatch.values()}
    assert len(engine_threads) == 1
    (tid,) = engine_threads
    assert rec["threads"][tid] == "ServingEngine"
    assert {s["thread"] for s in queue} != engine_threads


def _train_batch(seed, batch=2):
    rng = np.random.default_rng(seed)
    out = {
        "image": rng.uniform(-1.0, 1.0, size=(batch, 2 * H, 2 * W, 3)),
        "person_mask": rng.choice([-1.0, -0.99215686],
                                  size=(batch, H, W, 1)),
        "text_emb": rng.normal(size=(batch, 77, 768)),
        "style_emb": rng.normal(size=(batch, 9, 768)),
        "smpl": rng.normal(size=(batch, 1, 85)),
        "loss_w": rng.uniform(0.5, 1.5, size=(batch, H, W, 1)),
    }
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in out.items()}


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_phases_in_order(fused):
    def run():
        tm = _redraw(build_latent_diffusion("tiny", device="cpu"), seed=5)
        make = create_fused_train_state if fused else create_train_state
        state = make(tm, learning_rate=1e-3)
        draws = tm.training_draws(2, torch.Generator().manual_seed(7))
        state, metrics = train_step(tm, state, _train_batch(6), draws=draws)
        return metrics, state

    (m_off, s_off) = run()
    (m_on, s_on), rec = _recorded(run)
    assert torch.equal(m_off["loss"], m_on["loss"])
    assert torch.equal(m_off["grad_norm"], m_on["grad_norm"])
    for a, b in zip(s_off.params, s_on.params):
        assert torch.equal(a, b)
    for a, b in zip(s_off.ema.shadow, s_on.ema.shadow):
        assert torch.equal(a, b)
    spans = rec["spans"]
    (step,) = [s for s in spans if s["name"] == "train.step"]
    phases = sorted((s for s in spans if s["parent"] == step["id"]),
                    key=lambda s: s["start_ns"])
    assert [s["name"] for s in phases] == [
        "train.forward", "train.backward", "train.grad_norm",
        "train.optimizer", "train.ema"]
    by_id = {s["id"]: s for s in spans}
    res = [s for s in spans if s["name"] == "unet.resblock"]
    assert res and all(by_id[s["parent"]]["name"] == "train.forward"
                       for s in res)


def test_spans_read_the_benchmark_ranges_clock(monkeypatch):
    """Spans and linked spans take their times from `time.time_ns`, the
    clock the benchmark's ranges read: with it replaced by a counter,
    each reading lands in the span that took it."""
    ticks = iter(range(100, 200))
    monkeypatch.setattr(time, "time_ns", lambda: next(ticks))
    diagnostics.start()
    link = diagnostics.begin("linked", request=4)
    with diagnostics.span("outer"):
        with diagnostics.span("inner"):
            pass
    diagnostics.end(link, batch=2)
    diagnostics.stop()
    got = {s["name"]: s for s in diagnostics.drain()["spans"]}
    assert (got["outer"]["start_ns"], got["outer"]["end_ns"]) == (101, 104)
    assert (got["inner"]["start_ns"], got["inner"]["end_ns"]) == (102, 103)
    linked = got["linked"]
    assert (linked["start_ns"], linked["end_ns"]) == (100, 105)
    assert (linked["request"], linked["batch"]) == (4, 2)
