"""The port's serving engine, request builder, debug encoder and config
system on CPU, with the port's `tiny` and `tiny_upscale` models.

The engine cases mirror tests/test_serving.py: batch packing and padding,
several batches, failure isolation, draining on stop, atomic groups and
shared x_T seeds, and the chained upscale. A direct pipeline call with the
engine's batch recipe (the padded batch, `generators(i)`) gives the same
images bit for bit: one process, the same operations on the same inputs.

The deterministic pieces are held to the JAX package's on the same
inputs, exactly: `RequestBuilder.build` and `build_interp` with explicit
seeds, `ServingEngine._pack`, the debug encoder's embeddings, and
`merge_configs` / `apply_dotlist` over `configs/deepfashion/*.yaml`.
"""

import argparse
import glob
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

from upgpt_tpu import config as jax_config  # noqa: E402
from upgpt_tpu.inference import http_serve as jax_http  # noqa: E402
from upgpt_tpu.inference.encoders import (  # noqa: E402
    DebugConditioningEncoder as JaxDebugEncoder,
)
from upgpt_tpu.inference.serving import (  # noqa: E402
    ServingEngine as JaxServingEngine,
)
from upgpt_torch import config  # noqa: E402
from upgpt_torch.cli import _build_serving  # noqa: E402
from upgpt_torch.inference.encoders import (  # noqa: E402
    DebugConditioningEncoder,
)
from upgpt_torch.inference.http_serve import RequestBuilder  # noqa: E402
from upgpt_torch.inference.pipeline import (  # noqa: E402
    ChainedUpscalePipeline, GenerationPipeline,
)
from upgpt_torch.inference.serving import (  # noqa: E402
    ServingEngine, ServingStats,
)
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
H, W = 32, 24  # tiny's latent grid


def _cond(seed):
    rng = np.random.default_rng(seed)
    return {
        "text_emb": rng.normal(size=(77, 768)).astype(np.float32),
        "style_emb": rng.normal(size=(9, 768)).astype(np.float32),
        "smpl": rng.normal(size=(1, 85)).astype(np.float32),
        "person_mask": rng.choice([-1.0, -0.99215686],
                                  size=(H, W, 1)).astype(np.float32),
    }


def _redraw(model, seed):
    """Every parameter drawn (weights N(0, 1/fan_in), norm scales 1 + 0.1 N,
    the rest 0.1 N): no zero-initialised layer hides the conditioning."""
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


@pytest.fixture(scope="module")
def pipe():
    model = _redraw(build_latent_diffusion("tiny", device="cpu"), seed=0)
    return GenerationPipeline(model, num_steps=STEPS, eta=0.0)


def _serve(pipe, groups, **kw):
    eng = ServingEngine(pipe, **kw)
    eng.start()
    futs = [eng.submit_group(g) for g in groups]
    outs = [[f.result(timeout=120) for f in fs] for fs in futs]
    eng.stop()
    return eng, outs


def test_padded_tail_batch_matches_direct_call(pipe):
    """3 requests into a batch-4 engine equal the engine's batch recipe run
    directly: the last row repeated, batch 0's generators."""
    conds = [dict(_cond(i), x_T_seed=np.uint32(i)) for i in range(3)]
    eng, outs = _serve(pipe, [[c] for c in conds], batch_size=4,
                       max_delay_s=0.2)
    assert eng.stats.summary()["requests"] == 3
    assert eng.stats.batches == 1 and eng.stats.padded_slots == 1
    batch = {k: np.stack([c[k] for c in conds] + [conds[-1][k]])
             for k in conds[0]}
    np.testing.assert_array_equal(eng._pack([(conds, None, None)])["smpl"],
                                  batch["smpl"])
    gen, host_gen = eng.generators(0)
    want = pipe.generate(eng.to_device(batch), gen,
                         seed_generator=host_gen).numpy()
    for i, (out,) in enumerate(outs):
        assert out.shape == want.shape[1:] == (64, 48, 3)
        np.testing.assert_array_equal(out, want[i])


def test_many_requests_multiple_batches(pipe):
    eng, outs = _serve(pipe, [[_cond(i)] for i in range(5)], batch_size=2,
                       max_delay_s=0.05)
    assert all(o.shape == (64, 48, 3) for (o,) in outs)
    s = eng.stats.summary()
    assert s["requests"] == 5
    assert eng.stats.batches == 3  # 2 + 2 + padded tail
    assert eng.stats.padded_slots == 1
    assert s["p95_latency_s"] >= s["p50_latency_s"] > 0


def test_stats_percentiles_are_nearest_rank():
    """p50 and p95 of 20 known latencies by nearest rank (`ceil(q n) - 1`
    into the sorted list), as the benchmark reads a tail."""
    stats = ServingStats()
    stats.latencies_s.extend(float(i) for i in range(20, 0, -1))
    s = stats.summary()
    assert (s["p50_latency_s"], s["p95_latency_s"]) == (10.0, 19.0)


def test_bad_request_fails_only_its_batch(pipe):
    eng = ServingEngine(pipe, batch_size=2, max_delay_s=0.01)
    eng.start()
    bad = _cond(0)
    bad["text_emb"] = bad["text_emb"][:, :32]  # wrong embedding width
    with pytest.raises(Exception):
        eng.submit(bad).result(timeout=120)
    # the engine keeps serving after the failed batch
    assert eng.submit(_cond(1)).result(timeout=120).shape == (64, 48, 3)
    eng.stop()


def test_submit_before_start_raises(pipe):
    with pytest.raises(RuntimeError, match="not started"):
        ServingEngine(pipe, batch_size=2).submit(_cond(0))


def test_stop_drains_queue(pipe):
    """Requests still queued when stop() is called are served, not
    dropped, and without waiting out the 60 s window."""
    eng = ServingEngine(pipe, batch_size=2, max_delay_s=60.0)
    eng.start()
    futs = [eng.submit(_cond(i)) for i in range(3)]
    time.sleep(0.01)
    t0 = time.perf_counter()
    eng.stop()
    assert time.perf_counter() - t0 < 60.0
    assert all(f.result(timeout=1).shape == (64, 48, 3) for f in futs)


def test_group_atomicity_and_pushback(pipe):
    """A group never splits across batches: 3 + 2 into a batch-4 engine
    packs as (3 + 1 pad) then (2 + 2 pads), never (3+1, 1+3)."""
    groups = [[_cond(i) for i in range(3)], [_cond(10 + i) for i in range(2)]]
    eng, outs = _serve(pipe, groups, batch_size=4, max_delay_s=0.2)
    assert [len(o) for o in outs] == [3, 2]
    assert eng.stats.summary()["requests"] == 5
    assert eng.stats.batches == 2
    assert eng.stats.padded_slots == (4 - 3) + (4 - 2)


def test_group_larger_than_batch_rejected(pipe):
    eng = ServingEngine(pipe, batch_size=2, max_delay_s=0.01)
    eng.start()
    with pytest.raises(ValueError, match="exceeds batch_size"):
        eng.submit_group([_cond(i) for i in range(3)])
    eng.stop()


def test_x_T_seed_shares_initial_noise(pipe):
    """Equal x_T_seeds in one batch share x_T: identical conditionings with
    the same seed give identical images (eta 0 is deterministic given x_T),
    a different seed a different image."""
    base = _cond(0)
    conds = [dict(base, x_T_seed=np.uint32(s)) for s in (7, 7, 9)]
    _, (outs,) = _serve(pipe, [conds], batch_size=4, max_delay_s=0.2)
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)
    assert np.abs(outs[0] - outs[2]).max() > 1e-3


def test_chained_upscale_serving(pipe):
    """The engine over the 2-stage chain: one submit yields the upscale
    stage's image, and the chain's batch recipe gives it directly."""
    up = _redraw(build_latent_diffusion("tiny_upscale", device="cpu"), 1)
    chain = ChainedUpscalePipeline(pipe.model, up, num_steps=STEPS, eta=0.0,
                                   output_uint8=True)
    conds = [dict(_cond(i), x_T_seed=np.uint32(i)) for i in range(3)]
    eng, outs = _serve(chain, [[c] for c in conds[:2]] + [[conds[2]]],
                       batch_size=2, max_delay_s=0.2)
    assert all(o.shape == (64, 48, 3) and o.dtype == np.uint8
               for (o,) in outs)
    assert eng.stats.summary()["requests"] == 3
    batch = eng._pack([(conds[:2], None, None)])
    gen, host_gen = eng.generators(0)
    want = chain.generate(eng.to_device(batch), gen,
                          seed_generator=host_gen).numpy()
    np.testing.assert_array_equal(outs[0][0], want[0])


@pytest.mark.parametrize("flag,item", [("dp", "--dp 2 exceeds 0 CUDA"),
                                       ("tp", "no tensor parallelism"),
                                       ("sidecar", "R2")])
def test_unported_serving_options_are_refused(tmp_path, flag, item):
    # --dp is ported (replicas on cuda:0..N-1) and exits, as JAX's does,
    # where fewer cards are visible: none here; --tp exits, as JAX's serve
    # has no tensor parallelism (its --tp is on sample and test)
    ckpt = tmp_path / "model.pt"
    if flag == "sidecar":
        # a distilled student under the chain would sample off its grid
        (tmp_path / "model.pt.distill.json").write_text(
            '{"parameterization": "v", "timesteps": [237, 999]}')
    args = argparse.Namespace(
        ckpt=str(ckpt), debug_encoder=True, batch=4, max_delay=0.05,
        seed=0, steps=STEPS, sampler="ddim", schedule=None, in_flight=2,
        upscale_base=["upscale.yaml"] if flag == "sidecar" else None,
        upscale_ckpt=None,
        dp=2 if flag == "dp" else 1, tp=2 if flag == "tp" else 1)
    cfg = {"model": {"target": "upgpt_torch.zoo.build_latent_diffusion",
                     "params": {"variant": "tiny", "device": "cpu"}}}
    with pytest.raises(SystemExit, match=item):
        _build_serving(cfg, args)


def test_cond_encoder_needs_the_debug_flag_and_refuses_clip(pipe):
    from upgpt_torch.cli import _build_cond_encoder

    # CLIP needs its weights and the merges file, as in JAX: text weights
    # alone are no CLIP config, and the debug encoder needs the flag
    with pytest.raises(SystemExit, match="--debug-encoder"):
        _build_cond_encoder({"clip": {"text_params": "clip/text"}},
                            pipe.model)
    with pytest.raises(SystemExit, match="clip.vision_params"):
        _build_cond_encoder({"clip": {"text_params": "clip/text",
                                      "bpe_path": "clip/bpe.txt"}},
                            pipe.model, allow_debug=True)
    with pytest.raises(FileNotFoundError):
        _build_cond_encoder({"clip": {"text_params": "clip/text",
                                      "vision_params": "clip/vision",
                                      "bpe_path": "clip/bpe.txt"}},
                            pipe.model, allow_debug=True)
    with pytest.raises(SystemExit, match="--debug-encoder"):
        _build_cond_encoder({}, pipe.model)
    enc = _build_cond_encoder({"clip": {"text_params": None}}, pipe.model,
                              allow_debug=True)
    assert enc.text_hidden(["x"]).shape == (1, 77, 768)


# ------------------------------------------------ against the JAX package


@pytest.fixture(scope="module")
def encoders():
    return JaxDebugEncoder(), DebugConditioningEncoder()


def test_debug_encoder_is_jaxs_bit_for_bit(encoders):
    jenc, enc = encoders
    texts = ["red coat", "", "a person in blue denim"]
    np.testing.assert_array_equal(enc.text_hidden(texts),
                                  np.asarray(jenc.text_hidden(texts)))
    np.testing.assert_array_equal(enc.text_pooled(texts),
                                  np.asarray(jenc.text_pooled(texts)))
    batch = {"txt": texts[:2], "styles": np.zeros((2, 9, 16, 16, 3),
                                                  np.uint8)}
    got, want = enc.encode_batch(batch), jenc.encode_batch(batch)
    for k in ("text_emb", "style_emb"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    rng = np.random.default_rng(4)
    for styles in (rng.integers(0, 256, size=(2, 3, 32, 24, 3), dtype=np.uint8),
                   rng.normal(size=(2, 3, 32, 24, 3)).astype(np.float32)):
        np.testing.assert_array_equal(
            enc.style_embeddings(styles),
            np.asarray(jenc.style_embeddings(styles)))


def _builders(encoders, mask_hw=(H, W)):
    jenc, enc = encoders
    return (jax_http.RequestBuilder(jenc, mask_hw=mask_hw),
            RequestBuilder(enc, mask_hw=mask_hw))


def _same_cond(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_request_builder_matches_jax(encoders):
    jb, tb = _builders(encoders)
    rng = np.random.default_rng(5)
    texts = [None] * 9
    texts[4] = "blue denim jacket"
    for req in (
        {"txt": "red coat", "seed": 3},
        {"txt": "red coat", "style_texts": texts, "seed": 4,
         "smpl": rng.normal(size=(1, 85)).tolist(),
         "person_mask": rng.normal(size=(H, W)).tolist()},
        {"text_emb": rng.normal(size=(77, 768)).tolist(),
         "style_emb": rng.normal(size=(9, 768)).tolist(), "seed": 5},
    ):
        _same_cond(tb.build(req), jb.build(req))


def test_build_interp_matches_jax(encoders):
    jb, tb = _builders(encoders)
    rng = np.random.default_rng(6)
    src = np.full((H, W, 1), -1.0, np.float32)
    src[4:20, 3:12] = -0.99215686
    req = {"txt": "red coat", "seed": 123, "frames": 4,
           "smpl_src": rng.normal(size=(1, 85)).tolist(),
           "smpl_dst": rng.normal(size=(1, 85)).tolist(),
           "mask_src": src.tolist()}
    got, want = tb.build_interp(req), jb.build_interp(req)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _same_cond(a, b)


def test_pack_matches_jax(encoders):
    _, tb = _builders(encoders)
    conds = [tb.build({"txt": f"coat {i}", "seed": i}) for i in range(3)]
    items = [([conds[0], conds[1]], None, None), ([conds[2]], None, None)]
    want = JaxServingEngine(None, None, batch_size=5)._pack(items)
    got = ServingEngine(GenerationPipeline(
        build_latent_diffusion("tiny", device="meta"), num_steps=STEPS),
        batch_size=5)._pack(items)
    _same_cond(got, want)
    assert got["text_emb"].shape == (5, 77, 768)


CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))


@pytest.mark.parametrize("dotlist", [
    [], ["model.params.variant=tiny", "model.params.device=cpu",
         "sampling.eta=0.0", "trainer.batch_size=4", "new.key=[1, 2]",
         "clip.bpe_path=none"]])
def test_merge_configs_and_dotlist_match_jax(dotlist):
    assert len(CONFIGS) >= 7
    for path in CONFIGS:
        assert (config.merge_configs([path], dotlist)
                == jax_config.merge_configs([path], dotlist)), path
    pair = CONFIGS[:2]
    assert (config.merge_configs(pair, dotlist)
            == jax_config.merge_configs(pair, dotlist))
    base = {"a": {"b": 1}, "c": [1]}
    assert (config.apply_dotlist(base, dotlist)
            == jax_config.apply_dotlist(base, dotlist))
    for bad in (["noequals"], ["c.d=1"]):
        with pytest.raises(ValueError):
            jax_config.apply_dotlist(base, bad)
        with pytest.raises(ValueError):
            config.apply_dotlist(base, bad)


def test_targets_resolve_to_the_port():
    from upgpt_torch.zoo import build_latent_diffusion as port_build

    assert (config.get_obj_from_str("upgpt_tpu.zoo.build_latent_diffusion")
            is port_build)
    from upgpt_torch.data.deepfashion import DeepFashionPair

    assert (config.get_obj_from_str(
        "upgpt_tpu.data.deepfashion.DeepFashionPair") is DeepFashionPair)
    from upgpt_torch.training.distill import distill_step

    assert (config.get_obj_from_str(
        "upgpt_tpu.training.distill.distill_step") is distill_step)
    # a target the port does not have names itself
    with pytest.raises(ImportError, match="upgpt_tpu.parallel.mesh"):
        config.instantiate_from_config(
            {"target": "upgpt_tpu.parallel.mesh.create_mesh"})
    from upgpt_torch.eval.harness import dump_test_results

    assert (config.get_obj_from_str(
        "upgpt_tpu.eval.harness.dump_test_results") is dump_test_results)
    with pytest.raises(ImportError, match="NoSuchBuilder"):
        config.get_obj_from_str("upgpt_tpu.zoo.NoSuchBuilder")


@pytest.mark.parametrize("use_checkpoint", [False, True])
def test_use_checkpoint_is_taken(use_checkpoint):
    cfg = config.load_config(os.path.join(REPO, "configs/deepfashion/"
                                          "pt_256.yaml"))
    cfg = config.apply_dotlist(cfg, ["model.params.variant=tiny",
                                     "model.params.device=meta",
                                     f"model.params.use_checkpoint="
                                     f"{use_checkpoint}"])
    with torch.device("meta"):
        model = config.instantiate_from_config(cfg["model"])
    assert model.config.unet.use_checkpoint is use_checkpoint
    assert model.config == build_latent_diffusion(
        "tiny", dtype="bfloat16", device="meta",
        use_checkpoint=use_checkpoint).config


# ------------------------------------------------ data-parallel replicas


def _dp_batch(eng, n):
    conds = [dict(_cond(i), x_T_seed=np.uint32(i % 3)) for i in range(n)]
    return conds, eng._pack([(conds, None, None)])


@pytest.mark.parametrize("kind", ["ddim-eta0", "ddim-eta1", "chain"])
def test_dp_replicas_match_the_one_device_engine(pipe, kind):
    """Two CPU replicas (`devices`) split each batch 2 + 2 and take their
    rows of the batch's draws: the one-device engine's images for the same
    requests and seeds, gathered in request order."""
    if kind == "ddim-eta1":
        pipe = GenerationPipeline(pipe.model, num_steps=STEPS, eta=1.0)
    elif kind == "chain":
        up = _redraw(build_latent_diffusion("tiny_upscale", device="cpu"), 1)
        pipe = ChainedUpscalePipeline(pipe.model, up, num_steps=STEPS,
                                      eta=1.0)
    one = ServingEngine(pipe, batch_size=4)
    dp = ServingEngine(pipe, batch_size=4, devices=["cpu", "cpu"])
    assert dp.replicas[0] is pipe and len(dp.replicas) == 2
    model = (lambda p: p.base.model if kind == "chain" else p.model)
    assert model(dp.replicas[1]) is not model(pipe)
    _, batch = _dp_batch(one, 4)
    # a replica's U-Net runs at batch 2, the one device's at 4: their sums
    # round apart by 2.6e-6 (measured) on images in [-1, 1]
    want = one.fetch(*one.dispatch(batch, 3))
    out, events = dp.dispatch(batch, 3)
    assert len(out) == 2 and all(o.shape[0] == 2 for o in out)
    got = dp.fetch(out, events)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # through the serving loop: one group of four, one batch
    conds, _ = _dp_batch(one, 4)
    dp.start()
    futs = dp.submit_group(conds)
    served = np.stack([f.result(timeout=120) for f in futs])
    dp.stop()
    np.testing.assert_allclose(served, one.fetch(*one.dispatch(batch, 0)),
                               rtol=0, atol=1e-5)


def test_dp_engine_refuses_a_batch_that_does_not_split(pipe):
    with pytest.raises(ValueError, match="not divisible by the 2 replicas"):
        ServingEngine(pipe, batch_size=3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="at least one"):
        ServingEngine(pipe, batch_size=4, devices=[])


def test_dp_replicas_match_jaxs_dp_engine():
    """The port's two replicas against JAX's engine on a two-device mesh
    (its `--dp 2`, the XLA path), on JAX's weights through the bridge and
    JAX's x_T injected as the batch's draws: eta-0 DDIM latents."""
    import jax

    from test_torch_training import _random_params
    from upgpt_tpu.inference.pipeline import (
        GenerationPipeline as JaxPipeline,
    )
    from upgpt_tpu.parallel.mesh import create_mesh
    from upgpt_tpu.zoo import build_latent_diffusion as jax_build
    from upgpt_torch.convert.from_jax import load_jax_params

    jm = jax_build("tiny", use_flash_attention=False)
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=7)
    jpipe = JaxPipeline(jm, num_steps=STEPS, eta=0.0, decode=False)
    jeng = JaxServingEngine(jpipe, params, batch_size=4, max_delay_s=0.1,
                            mesh=create_mesh((2, 1),
                                             devices=jax.devices()[:2]))
    conds = [dict(_cond(i), x_T_seed=np.uint32(s))
             for i, s in enumerate((5, 5, 8, 9))]
    jeng.start()
    want = np.stack([f.result(timeout=300) for f in jeng.submit_group(conds)])
    jeng.stop()
    # JAX's draws for batch 0: fold_in(PRNGKey(base_seed), 0), split, and
    # a row per x_T_seed keyed by fold_in(k_noise, seed)
    _, k_noise = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                                     0))
    x_T = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(k_noise, int(c["x_T_seed"])), (H, W, 4)))
        for c in conds])
    model = load_jax_params(build_latent_diffusion("tiny", device="cpu",
                                                   use_fused_groupnorm=True),
                            params)
    eng = ServingEngine(GenerationPipeline(model, num_steps=STEPS, eta=0.0,
                                           decode=False),
                        batch_size=4, devices=["cpu", "cpu"])
    eng.pipeline.draws = lambda batch, gen, seed_generator=None: {
        "x_T": torch.from_numpy(x_T)}
    eng.start()
    got = np.stack([f.result(timeout=120) for f in eng.submit_group(conds)])
    eng.stop()
    # float32 on both sides, summed in other orders: 5.1e-6 measured on
    # latents up to 9.5
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
