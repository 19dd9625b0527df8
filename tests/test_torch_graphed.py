"""The U-Net layers' CUDA graphs (`upgpt_torch/models/graphed.py`).

On the CPU: the gate, the signature, the bounded cache, the argument
slots, the launch counters a replay adds (with a stub graph), and the whole
graph path through `UNetModel.forward` and `GenerationPipeline.generate`
with each capture emulated by a stub that runs the layer's body again on
its static buffers and writes its static output in place, as a replay
does; a U-Net called outside a pipeline (the distillation teacher's call)
and the trainer's image log stay eager. On a card (marked `cuda`, skipped
without one): graphs against eager calls at the cells' shapes, a DDIM-4
`GenerationPipeline.generate` and its launch counts, and a capture again
after `load_state_dict`. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphed.py
"""

import copy
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from upgpt_torch.models import graphed  # noqa: E402
from upgpt_torch.models.unet import (  # noqa: E402
    ResBlock, SpatialTransformer, UNetConfig, UNetModel, precompute_cross_kv,
)
from upgpt_torch.ops import fused_resblock as frb  # noqa: E402
from upgpt_torch.ops import fused_transformer as ft  # noqa: E402
from upgpt_torch.utils import diagnostics  # noqa: E402

TINY = UNetConfig(in_channels=5, model_channels=32, out_channels=4,
                  num_res_blocks=1, attention_resolutions=(1, 2),
                  channel_mult=(1, 2), num_heads=4, context_dim=64)


def _redraw(module, seed):
    """Every parameter drawn, so no zero-initialised layer hides a path."""
    dev = next(module.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            z = torch.randn(p.shape, generator=g, device=dev)
            if p.dim() >= 2:
                z = z / p[0].numel() ** 0.5
            else:
                z = (1.0 if name.endswith("weight") else 0.0) + 0.1 * z
            p.copy_(z.to(p.device, p.dtype))
    return module


class _StubGraph:
    """A captured call stood in for on the CPU: a replay runs the body on
    the static buffers and writes the static output in place."""

    def __init__(self, body, args, out):
        self.body, self.args, self.out = body, args, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.out.copy_(self.body(*self.args))


def _on_any_device(monkeypatch):
    """The gate as it reads a card's tensors, for CPU tensors."""
    gate = graphed.refusals
    monkeypatch.setattr(graphed, "refusals", lambda x: [
        w for w in gate(x) if w != "device"])


@pytest.fixture
def emulated(monkeypatch):
    """The graph path on CPU tensors, each capture a `_StubGraph`."""
    captured = []

    def capture(ev, body, args):
        out = body(*args)
        captured.append(_StubGraph(body, args, out))
        return captured[-1], out

    _on_any_device(monkeypatch)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(graphed, "_capture", capture)
    return captured


def _resblock(seed=0):
    return _redraw(ResBlock(32, 32, 128), seed)


# ------------------------------------------------------------------ gate


def test_gate_refuses_cpu_tensors():
    with torch.no_grad(), graphed.sampling():
        assert graphed.refusals(torch.zeros(1)) == ["device"]


def test_gate_refuses_evals_outside_a_sampling_block(monkeypatch):
    """Only a sampling pipeline opens the graph path: the training step,
    the distillation teacher and a loss call the U-Net outside one."""
    _on_any_device(monkeypatch)
    x = torch.zeros(1)
    with torch.no_grad():
        assert graphed.refusals(x) == ["sampling"]
        with graphed.sampling():
            assert graphed.refusals(x) == []
            with graphed.sampling():
                assert graphed.refusals(x) == []
            assert graphed.refusals(x) == []
        assert graphed.refusals(x) == ["sampling"]
        assert graphed.unet_eval(x) is graphed._NO_EVAL


def test_gate_refuses_grad_mode(monkeypatch):
    _on_any_device(monkeypatch)
    x = torch.zeros(1)
    with graphed.sampling():
        assert graphed.refusals(x) == ["grad"]
        with torch.no_grad():
            assert graphed.refusals(x) == []
        with torch.inference_mode():
            assert graphed.refusals(x) == []


def test_gate_refuses_a_capture_in_progress(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    with torch.no_grad(), graphed.sampling():
        assert graphed.refusals(on_card) == ["capturing"]


def _layer_counters(fn):
    """fn's `unet.graph.*` counters."""
    diagnostics.start()
    try:
        fn()
    finally:
        counters = diagnostics.drain()["counters"]
        diagnostics.stop()
    return counters


def test_gate_refuses_layers_outside_a_unet_eval_and_other_modules(
        emulated):
    """A plain layer called three times inside a U-Net eval captures on
    its second call; called outside one, or as a subclass, it stays
    eager."""

    class Sub(ResBlock):
        pass

    x, emb = torch.randn(2, 4, 4, 32), torch.randn(2, 128)
    blk, sub = _resblock(), _redraw(Sub(32, 32, 128), 0)
    with torch.no_grad(), graphed.sampling():
        outside = _layer_counters(lambda: [blk(x, emb) for _ in range(3)])
        with graphed.unet_eval(x):
            assert graphed.refusals(x) == []
            other = _layer_counters(
                lambda: [sub(x, emb) for _ in range(3)])
            inside = _layer_counters(
                lambda: [blk(x, emb) for _ in range(3)])
        with graphed.eager():
            assert graphed.refusals(x) == ["eager"]
            assert graphed.unet_eval(x) is graphed._NO_EVAL
    assert outside == other == {"unet.graph.eager": 3}
    assert inside == {"unet.graph.eager": 1, "unet.graph.capture": 1,
                      "unet.graph.replay": 1}
    assert len(emulated) == 1 and len(sub._graphs) == 0


def test_gate_refuses_the_tp_grids_modules(emulated):
    """The tensor-parallel grid's U-Nets (ResBlocks of a replica,
    ShardedTransformers) run eagerly inside a sampling block."""
    from upgpt_torch.parallel.tp import TPUNet, TPGrid

    unet = _redraw(UNetModel(TINY), 0).eval()
    tpu = TPUNet(unet, TPGrid(["cpu"] * 2, 2))
    x = torch.randn(2, 8, 8, 5)
    ctx = torch.randn(2, 7, 64)

    def calls():
        with torch.inference_mode(), graphed.sampling():
            for _ in range(3):
                tpu(x, torch.tensor([3, 5]), ctx, tpu.cross_kv(ctx))

    counters = _layer_counters(calls)
    assert emulated == []
    assert set(counters) == {"unet.graph.eager"}
    assert all(len(m._graphs) == 0 for m in tpu.modules()
               if isinstance(m, (ResBlock, SpatialTransformer)))


# ------------------------------------------------------- signature, cache


def test_signature_changes_when_a_parameter_storage_is_replaced():
    blk = _resblock()
    args = (torch.zeros(2, 4, 4, 32), torch.zeros(2, 128))
    sig = graphed.signature(blk, args)
    with torch.no_grad():
        blk.conv_in.weight.mul_(2.0)  # in place: the graph reads it
    assert graphed.signature(blk, args) == sig
    blk.conv_in.weight.data = blk.conv_in.weight.data.clone()
    moved = graphed.signature(blk, args)
    assert moved != sig
    blk.conv_out.bias = torch.nn.Parameter(blk.conv_out.bias.detach() + 1)
    assert graphed.signature(blk, args) not in (sig, moved)


def test_signature_follows_shapes_dtypes_and_structure():
    st = _redraw(SpatialTransformer(32, 4, 8, context_dim=64), 0)
    x = torch.zeros(2, 4, 4, 32)
    kv = {"block_0": (torch.zeros(2, 7, 32), torch.zeros(2, 7, 32))}
    sig = graphed.signature(st, (x, None, kv))
    assert graphed.signature(st, (x.clone(), None, kv)) == sig
    assert graphed.signature(st, (torch.zeros(3, 4, 4, 32), None, kv)) != sig
    assert graphed.signature(st, (x.double(), None, kv)) != sig
    kv9 = {"block_0": (torch.zeros(2, 9, 32), torch.zeros(2, 9, 32))}
    assert graphed.signature(st, (x, None, kv9)) != sig
    assert graphed.signature(st, (x, torch.zeros(2, 7, 64), None)) != sig


def test_cache_is_bounded_and_evicts_the_least_recently_used():
    cache = graphed.GraphCache(bound=3)
    for k in "abc":
        cache.put(k, k.upper())
    assert cache.get("a") == "A"  # a is now the most recent
    cache.put("d", "D")
    assert len(cache) == 3 and cache.get("b") is None
    assert [cache.get(k) for k in "acd"] == ["A", "C", "D"]
    cache.put("e", "E")
    assert cache.get("a") is None and len(cache) == 3
    cache.clear()
    assert len(cache) == 0 and cache.params is None


def test_layers_keep_at_most_bound_signatures(emulated):
    blk = _resblock()
    emb = torch.randn(1, 128)
    with torch.inference_mode(), graphed.sampling():
        for n in range(1, 8):
            x = torch.randn(n, 4, 4, 32)
            with graphed.unet_eval(x):
                for _ in range(3):
                    blk(x, emb[[0] * n])
    assert len(blk._graphs) == graphed.BOUND
    # the latest batch sizes are kept, the first ones were dropped
    kept = {spec[1][0][0] for _, (spec, _) in blk._graphs.entries}
    assert kept == {4, 5, 6, 7}


def test_copies_start_empty_and_apply_and_loading_drop_the_graphs(emulated):
    unet = _redraw(UNetModel(TINY), 0)
    x = torch.randn(2, 8, 8, 5)
    ctx = torch.randn(2, 7, 64)

    def run():
        with torch.inference_mode(), graphed.sampling():
            for _ in range(2):
                unet(x, torch.tensor([3, 5]), ctx)

    def sizes(model):
        return [len(m._graphs) for m in model.modules()
                if isinstance(m, (ResBlock, SpatialTransformer))]

    run()
    assert set(sizes(unet)) == {1}
    assert set(sizes(copy.deepcopy(unet))) == {0}
    unet.double()
    assert set(sizes(unet)) == {0}
    unet.float()
    run()
    unet.load_state_dict(unet.state_dict())
    assert set(sizes(unet)) == {0}


# ----------------------------------------------------------- slots, counts


def test_a_slot_copies_only_a_new_tensor_or_a_new_version():
    src = torch.randn(3)
    slot = graphed._Slot(src)
    assert torch.equal(slot.buffer, src) and slot.buffer is not src
    assert not slot.load(src)
    src.add_(1.0)  # a new version of the same tensor
    assert slot.load(src) and torch.equal(slot.buffer, src)
    other = src.clone()
    assert slot.load(other) and not slot.load(other)
    del other  # its memory may come back under a new tensor
    fresh = torch.randn(3)
    assert slot.load(fresh) and torch.equal(slot.buffer, fresh)
    with torch.inference_mode():
        kv = torch.randn(3)  # no version counter: identity decides
        assert slot.load(kv) and not slot.load(kv)


def test_a_borrowed_slot_reads_the_tensor_where_it_is():
    out = torch.randn(3)
    out._graph_output = True  # another graph's static output
    slot = graphed._Slot(out)
    assert slot.buffer is out and not slot.load(out)
    other = torch.randn(3)
    assert slot.load(other) and torch.equal(out, other)


def test_a_replay_adds_the_captured_launch_counts(monkeypatch):
    fn = ft.fused_transformer_block
    monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(frb.fused_gn_silu_conv, "launches_by_shape", {})
    before = diagnostics.launch_state()
    fn.launches += 2
    frb.fused_gn_silu_conv.launches_by_shape[("s", 4)] = 3
    increase = diagnostics.launch_increase(before,
                                           diagnostics.launch_state())
    assert sorted((attr, shape, n) for _, attr, shape, n in increase) == [
        ("launches", None, 2), ("launches_by_shape", ("s", 4), 3)]
    slot = graphed._Slot(torch.ones(2))
    stub = _StubGraph(lambda t: t * 2, (slot.buffer,), torch.zeros(2))
    entry = graphed._Entry(stub, [slot], stub.out, increase)
    start = dict(diagnostics.kernel_launches())
    for k in range(1, 4):
        got = entry.replay([torch.full((2,), float(k))])
        assert torch.equal(got, torch.full((2,), 2.0 * k))
    assert stub.replays == 3
    now = diagnostics.kernel_launches()
    assert {k: now[k] - start[k] for k in now if now[k] != start[k]} == {
        "fused_transformer_block": 6}
    assert frb.fused_gn_silu_conv.launches_by_shape == {("s", 4): 12}
    # counters reset by assignment, as chip_smoke.py does, still count
    frb.fused_gn_silu_conv.launches_by_shape = {}
    entry.replay([torch.ones(2)])
    assert frb.fused_gn_silu_conv.launches_by_shape == {("s", 4): 3}


# ------------------------------------------------ the path through a U-Net


def _evals(unet, steps, batches, seed=0):
    """Each batch's eps over `steps` evals: a new context, K/V and x a
    batch, a new timestep each eval (the sampler's pattern)."""
    g = torch.Generator().manual_seed(seed)
    outs = []
    with torch.inference_mode(), graphed.sampling():
        for _ in range(batches):
            ctx = torch.randn(2, 7, 64, generator=g)
            kv = precompute_cross_kv(unet, ctx)
            x = torch.randn(2, 8, 8, 5, generator=g)
            for s in range(steps):
                t = torch.tensor([900 - 97 * s, 850 - 91 * s])
                eps = unet(x, t, ctx, cross_kv=kv)
                outs.append(eps.clone())
                x = torch.cat([x[..., :4] - 0.1 * eps, x[..., 4:]], -1)
    return outs


def test_the_graph_path_gives_the_eager_eps(emulated):
    """Capture on the second eval, replay after; every layer's static
    inputs follow the new x, emb and K/V, and static outputs stay valid
    through the skip list, bit for bit against the eager U-Net."""
    unet = _redraw(UNetModel(TINY), 3)
    with graphed.eager():
        want = _evals(unet, steps=4, batches=2)
    diagnostics.start()
    try:
        got = _evals(unet, steps=4, batches=2)
    finally:
        counters = diagnostics.drain()["counters"]
        diagnostics.stop()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    layers = sum(isinstance(m, (ResBlock, SpatialTransformer))
                 for m in unet.modules())
    assert len(emulated) == layers
    assert counters == {"unet.graph.eager": layers,
                        "unet.graph.capture": layers,
                        "unet.graph.replay": layers * 6}
    assert sorted(g.replays for g in emulated) == [7] * layers


def test_inputs_are_copied_once_a_batch_or_once_a_step(emulated,
                                                       monkeypatch):
    """K/V once a batch, emb once a step into each ResBlock's buffer,
    and nothing where a layer reads the previous layer's static output."""
    unet = _redraw(UNetModel(TINY), 4)
    copies = []
    load = graphed._Slot.load

    def counted(slot, t):
        moved = load(slot, t)
        if moved:
            copies.append(tuple(t.shape))
        return moved

    monkeypatch.setattr(graphed._Slot, "load", counted)
    _evals(unet, steps=2, batches=1)  # eager, then the captures
    copies.clear()
    _evals(unet, steps=3, batches=1, seed=1)
    attn = sum(kind == "attn" for kind, _ in unet._plan)
    assert sum(len(s) == 3 for s in copies) == 2 * attn  # K and V
    res = sum(isinstance(m, ResBlock) for m in unet.modules())
    assert sum(s == (2, 128) for s in copies) == 3 * res  # emb
    # an eval's: conv_in's output, each downsample's and each concat's
    fed = 1 + sum(kind in ("call", "pop") for kind, name in unet._plan
                  if name is None or "downsample" in name)
    assert sum(len(s) == 4 for s in copies) == 3 * fed


def test_a_signature_seen_once_never_captures(emulated):
    blk = _resblock()
    x, emb = torch.randn(2, 4, 4, 32), torch.randn(2, 128)
    with torch.inference_mode(), graphed.sampling(), graphed.unet_eval(x):
        blk(x, emb)
    assert emulated == [] and len(blk._graphs) == 1


def _tiny_ldm(seed=0):
    from upgpt_torch.zoo import build_latent_diffusion

    torch.manual_seed(seed)
    return _redraw(build_latent_diffusion(
        "tiny", device="cpu", latent_size=(8, 8), param_dtype="float32"),
        seed)


def _tiny_cond(batch, seed=1):
    rng = np.random.default_rng(seed)
    return {
        "text_emb": rng.normal(size=(batch, 77, 768)),
        "style_emb": rng.normal(size=(batch, 9, 768)),
        "smpl": rng.normal(size=(batch, 1, 85)),
        "person_mask": rng.choice([-1.0, -0.99215686], size=(batch, 8, 8, 1)),
    }


def test_the_pipeline_samples_through_graphs_as_eagerly(emulated):
    """`GenerationPipeline.generate` opens the graph path: DDIM-4 eval
    by eval, eager, capture, replay, with the eager latents bit for bit."""
    from upgpt_torch.inference.pipeline import GenerationPipeline

    pipe = GenerationPipeline(_tiny_ldm(), num_steps=4, eta=1.0,
                              decode=False)
    batch = {k: torch.from_numpy(v).float()
             for k, v in _tiny_cond(2).items()}

    def run():
        return pipe.generate(batch, torch.Generator().manual_seed(3))

    with graphed.eager():
        want = run()
    got = []
    counters = _layer_counters(lambda: got.extend([run(), run()]))
    assert all(torch.equal(g, want) for g in got)
    layers = sum(isinstance(m, (ResBlock, SpatialTransformer))
                 for m in pipe.model.modules())
    assert len(emulated) == layers
    assert counters == {"unet.graph.eager": layers,
                        "unet.graph.capture": layers,
                        "unet.graph.replay": layers * 6}


def test_unet_calls_outside_a_pipeline_stay_eager(emulated):
    """The distillation teacher's call (no autograd, a context and no
    K/V) and any other U-Net call outside a sampling pipeline capture
    nothing and keep no graph."""
    unet = _redraw(UNetModel(TINY), 5)
    x = torch.randn(2, 8, 8, 5)
    ctx = torch.randn(2, 7, 64)
    t = torch.tensor([3, 5])

    def calls():
        with torch.no_grad():
            for _ in range(3):
                unet(x, t, ctx)
        with torch.inference_mode():
            for _ in range(3):
                unet(x, t, ctx, cross_kv=precompute_cross_kv(unet, ctx))

    counters = _layer_counters(calls)
    layers = sum(isinstance(m, (ResBlock, SpatialTransformer))
                 for m in unet.modules())
    assert emulated == []
    assert counters == {"unet.graph.eager": 6 * layers}
    assert all(len(m._graphs) == 0 for m in unet.modules()
               if isinstance(m, (ResBlock, SpatialTransformer)))


def test_the_trainers_image_log_stays_eager(emulated, tmp_path,
                                           monkeypatch):
    """The trainer's image log samples through a pipeline, eagerly: its
    graphs' memory would stay reserved through the training run."""
    # TensorBoard's import pulls in TensorFlow where it is installed
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from upgpt_torch.inference.encoders import DebugConditioningEncoder
    from upgpt_torch.training.train_state import create_train_state
    from upgpt_torch.training.trainer import Trainer, TrainerConfig

    model = _tiny_ldm()
    cfg = TrainerConfig(logdir=str(tmp_path / "run"), log_images_every=1,
                        image_log_ddim_steps=4,
                        image_log_progressive_frames=0)
    trainer = Trainer(model, cfg, DebugConditioningEncoder())
    state = create_train_state(model, 1e-4)
    batch = {k: v.astype(np.float32) for k, v in _tiny_cond(2).items()}
    counters = _layer_counters(lambda: trainer.log_images(state, batch, 1))
    assert emulated == []
    assert set(counters) == {"unet.graph.eager"}
    assert (tmp_path / "run" / "images" / "samples_00000001.png").exists()


# ------------------------------------------------------------- on a card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _layer_calls(layer, args, make_args):
    """(eager, graph) outputs over four calls: eager, capture, replay, and
    a replay with new values in every argument."""
    eager, graph = [], []
    calls = [args, args, args, make_args(1)]
    with torch.inference_mode():
        with graphed.eager():
            for a in calls:
                eager.append(layer(*a).clone())
        for a in calls:
            with graphed.sampling(), graphed.unet_eval(a[0]):
                graph.append(layer(*a).clone())
    return eager, graph


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,hw,c,cout", [
    ("interp_256 ds1", 64, (32, 24), 224, 224),
    ("interp_256 up ds1", 64, (32, 24), 448, 224),
    ("mm_512 ds1", 8, (64, 48), 224, 224),
    ("mm_512 ds2", 8, (32, 24), 448, 448),
])
def test_resblock_graph_matches_eager(dev, name, batch, hw, c, cout):
    blk = _redraw(ResBlock(c, cout, 896, torch.bfloat16).to(dev,
                                                            torch.bfloat16),
                  0)

    def make(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randn(batch, *hw, c, generator=g, device=dev,
                            dtype=torch.bfloat16),
                torch.randn(batch, 896, generator=g, device=dev,
                            dtype=torch.bfloat16))

    eager, graph = _layer_calls(blk, make(0), make)
    for e, g in zip(eager, graph):
        assert _rel(g, e) <= 1e-6, name
    assert len(blk._graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,hw,c,k1", [
    ("interp_256 ds1", 64, (32, 24), 224, True),
    ("mm_512 ds1, the twin with K3", 8, (64, 48), 224, False),
    ("mm_512 ds2", 8, (32, 24), 448, True),
])
def test_spatial_transformer_graph_matches_eager(dev, name, batch, hw, c,
                                                 k1):
    st = _redraw(SpatialTransformer(
        c, 8, c // 8, context_dim=768, use_flash=True, fused=True,
        dtype=torch.bfloat16).to(dev, torch.bfloat16), 0)

    def make(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev,  # noqa
                                     dtype=torch.bfloat16)
        return (rnd(batch, *hw, c), None,
                {"block_0": (rnd(batch, 87, c), rnd(batch, 87, c))})

    before = ft.fused_transformer_block.launches
    eager, graph = _layer_calls(st, make(0), make)
    launched = ft.fused_transformer_block.launches - before
    for e, g in zip(eager, graph):
        assert _rel(g, e) <= 1e-6, name
    # four eager calls and four on the graph path, replays counted
    assert launched == (8 if k1 else 0)


@pytest.mark.cuda
def test_ddim4_generate_matches_eager_with_the_same_launches(dev):
    from upgpt_torch.inference.pipeline import GenerationPipeline
    from upgpt_torch.zoo import build_latent_diffusion

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _redraw(build_latent_diffusion(
        "interp_256", dtype="bfloat16", device=dev), 5)
    pipe = GenerationPipeline(model, num_steps=4, eta=1.0,
                              sampler="ddim", output_uint8=False)
    g = torch.Generator(device=dev).manual_seed(7)
    b = 64
    batch = {"text_emb": torch.randn(b, 77, 768, generator=g, device=dev),
             "style_emb": torch.randn(b, 9, 768, generator=g, device=dev),
             "smpl": torch.randn(b, 1, 85, generator=g, device=dev),
             "person_mask": torch.where(
                 torch.rand(b, 32, 24, 1, generator=g, device=dev) < 0.5,
                 -1.0, -0.99215686)}
    draws = {"x_T": torch.randn(b, 32, 24, 4, generator=g, device=dev),
             "noise": torch.randn(4, b, 32, 24, 4, generator=g, device=dev)}

    def run():
        start = diagnostics.kernel_launches()
        img = pipe.generate(batch, **draws)
        torch.cuda.synchronize()
        now = diagnostics.kernel_launches()
        return img.clone(), {k: now[k] - start[k] for k in now}

    with graphed.eager():
        want, want_n = run()
    diagnostics.start()
    try:
        first, first_n = run()  # eager, capture, then two replays
        second, second_n = run()  # replays only
    finally:
        counters = diagnostics.drain()["counters"]
        diagnostics.stop()
    for got in (first, second):
        assert _rel(got, want) <= 1e-6
    assert first_n == want_n == second_n
    assert want_n["fused_transformer_block"] == 4 * 10
    assert counters == {"unet.graph.eager": 38, "unet.graph.capture": 38,
                        "unet.graph.replay": 38 * 6}


@pytest.mark.cuda
def test_graphs_capture_again_after_load_state_dict(dev):
    blk = _redraw(ResBlock(224, 224, 896, torch.bfloat16).to(
        dev, torch.bfloat16), 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 32, 24, 224, generator=g, device=dev,
                    dtype=torch.bfloat16)
    emb = torch.randn(8, 896, generator=g, device=dev, dtype=torch.bfloat16)

    def graph_call():
        with (torch.inference_mode(), graphed.sampling(),
              graphed.unet_eval(x)):
            return blk(x, emb).clone()

    def eager_call():
        with torch.inference_mode(), graphed.eager():
            return blk(x, emb).clone()

    for _ in range(3):
        graph_call()
    (_, entry), = blk._graphs.entries.items()
    old = entry.graph
    new = {k: v.clone() for k, v in _redraw(
        copy.deepcopy(blk), 1).state_dict().items()}
    blk.load_state_dict(new)
    assert len(blk._graphs) == 0
    got = [graph_call() for _ in range(3)]
    (_, entry), = blk._graphs.entries.items()
    assert entry.graph is not old
    want = eager_call()
    assert all(_rel(t, want) <= 1e-6 for t in got)
    # in place, the parameters' addresses stay: the graph reads the values
    with torch.no_grad():
        blk.conv_in.weight.mul_(0.5)
    got = graph_call()
    assert _rel(got, eager_call()) <= 1e-6
    assert blk._graphs.get(next(iter(blk._graphs.entries))) is entry
