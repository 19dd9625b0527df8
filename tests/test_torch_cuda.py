"""upgpt_torch's CUDA kernels against their plain versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device: the
kernels have no CPU mode. The file imports no JAX, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.) Tolerances are
relative to max|plain|: 2e-2 in bf16, where both sides round the same
intermediates but accumulate in different orders, and 1e-5 in float32.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from upgpt_torch.models.unet import SpatialTransformer  # noqa: E402
from upgpt_torch.ops import flash_attention as fa  # noqa: E402
from upgpt_torch.ops import fused_gn as fg  # noqa: E402
from upgpt_torch.ops import fused_resblock as frb  # noqa: E402
from upgpt_torch.ops import fused_transformer as ft  # noqa: E402
from upgpt_torch.ops import gemm_plan as gp  # noqa: E402
from upgpt_torch.ops import selfattn_leg as sl  # noqa: E402

TK, CTX = 87, 768


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def _routes(*fns):
    """(tensor-core, FMA) launch counts of each wrapper."""
    return [(f.launches, f.fma_launches) for f in fns]


def _moved(before, after, route):
    """Each wrapper moved its counter of `route` by one, the other not."""
    step = (1, 0) if route == "mma" else (0, 1)
    return all((a[0] - b[0], a[1] - b[1]) == step
               for a, b in zip(after, before))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 1, 768, 512), torch.bfloat16, 2e-2),   # VAE mid AttnBlock
    ((2, 1, 3072, 512), torch.bfloat16, 2e-2),  # its kl-f8 512px mid (K2)
    ((6, 1, 768, 512), torch.bfloat16, 2e-2),   # a rank's VAE encode
    ((6, 8, 768, 28), torch.bfloat16, 2e-2),    # a rank's ds1 recompute
    ((4, 1, 3072, 512), torch.bfloat16, 2e-2),  # a dp replica's decode
    ((4, 8, 3072, 28), torch.bfloat16, 2e-2),   # a dp replica's ds1
    ((1, 8, 3072, 64), torch.bfloat16, 2e-2),   # 512px upscale
    ((1, 8, 3072, 28), torch.bfloat16, 2e-2),   # 512px mm_512 ds1
    ((2, 8, 192, 56), torch.bfloat16, 2e-2),    # K1's ds2 head width
    ((1, 2, 200, 28), torch.bfloat16, 2e-2),    # ragged T
    ((1, 2, 512, 28), torch.float32, 1e-5),
])
def test_flash_kernel_matches_plain(dev, shape, dtype, tol):
    # bf16 takes the tensor-core kernel, float32 the FMA kernel
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=dtype)
               for _ in range(3))
    before = _routes(fa.flash_attention)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    route = "mma" if dtype == torch.bfloat16 else "fma"
    assert _moved(before, _routes(fa.flash_attention), route)
    assert _rel(got, fa._reference_attention(q, k, v)) < tol


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 1, 512, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 512, 640, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 64, 512, device=dev).transpose(2, 3)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    # the float32 kernel's score tile bounds T (the C side refuses the
    # launch); bf16 has no bound
    q = torch.zeros(1, 1, 8192, 64, device=dev)
    with pytest.raises(RuntimeError):
        fa.flash_attention(q, q, q)


def _random_tree(c, dev, seed=1):
    """bf16 block parameters: weights N(0, 1/fan_in), nothing at zero."""
    g = torch.Generator().manual_seed(seed)

    def w(o, i):
        return (torch.randn(o, i, generator=g) / math.sqrt(i)).to(
            dev, torch.bfloat16)

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=g)).to(
            dev, torch.bfloat16)

    def attn(cd):
        return {"to_q": {"weight": w(c, c)}, "to_k": {"weight": w(c, cd)},
                "to_v": {"weight": w(c, cd)},
                "to_out": {"weight": w(c, c), "bias": vec(c)}}

    norm = lambda: {"weight": vec(c, 1.0), "bias": vec(c)}
    return {
        "norm": norm(), "proj_in": {"weight": w(c, c), "bias": vec(c)},
        "proj_out": {"weight": w(c, c), "bias": vec(c)},
        "block_0": {
            "attn1": attn(c), "attn2": attn(CTX),
            "ff": {"proj_in": {"weight": w(8 * c, c), "bias": vec(8 * c)},
                   "proj_out": {"weight": w(c, 4 * c), "bias": vec(c)}},
            "norm1": norm(), "norm2": norm(), "norm3": norm()},
    }


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,heads", [
    (4, 768, 224, 8), (4, 192, 448, 8), (2, 64, 64, 4), (3, 40, 96, 3),
    (2, 768, 448, 8),  # mm_512's ds2, past JAX's gate (ROADMAP P5)
    (4, 768, 448, 8),  # a dp replica's mm_512 ds2
])
def test_fused_kernel_matches_twin(dev, b, t, c, heads):
    p = _random_tree(c, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, t, c, generator=g, device=dev).bfloat16()
    k = torch.randn(b, TK, c, generator=g, device=dev).bfloat16()
    v = torch.randn(b, TK, c, generator=g, device=dev).bfloat16()
    before = ft.fused_transformer_block.launches
    with torch.no_grad():
        got = ft.fused_transformer_block(x, p, heads, kv=(k, v))
        want = ft.transformer_block_reference(x, p, heads, kv=(k, v))
    assert ft.fused_transformer_block.launches == before + 1
    assert _rel(got, want) < 2e-2


@pytest.mark.cuda
def test_fused_kernel_raises_on_what_it_does_not_take(dev):
    p = _random_tree(64, dev)
    x = torch.zeros(2, 64, 64, device=dev, dtype=torch.bfloat16)
    ctx = torch.zeros(2, TK, CTX, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # to_k/to_v take 768 wide, not 767
        ft.fused_transformer_block(x, p, 4, context=ctx[..., :-1])
    kv = torch.zeros(2, TK, 64, device=dev)
    with pytest.raises(TypeError):
        ft.fused_transformer_block(x.float(), p, 4, kv=(kv, kv))
    big = torch.zeros(1, 2048, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ft.fused_transformer_block(big, p, 4, kv=(kv[:1].bfloat16(),) * 2)


@pytest.mark.cuda
def test_spatial_transformer_with_context_only_raises(dev):
    # a qualifying block given a context and no precomputed K/V reaches the
    # kernel's training variant, which takes even context widths only
    mod = SpatialTransformer(64, 4, 16, context_dim=CTX - 1, fused=True).to(
        dev, torch.bfloat16)
    x = torch.randn(2, 8, 8, 64, device=dev).bfloat16()
    ctx = torch.randn(2, TK, CTX - 1, device=dev).bfloat16()
    with torch.no_grad(), pytest.raises(ValueError):
        mod(x, ctx)


@pytest.mark.cuda
def test_spatial_transformer_dispatches_to_the_kernel(dev):
    mod = SpatialTransformer(64, 4, 16, context_dim=CTX, fused=True).to(
        dev, torch.bfloat16)
    x = torch.randn(2, 8, 8, 64, device=dev).bfloat16()
    kv = {"block_0": tuple(torch.randn(2, TK, 64, device=dev).bfloat16()
                           for _ in range(2))}
    before = ft.fused_transformer_block.launches
    with torch.no_grad():
        got = mod(x, kv=kv)
        mod.fused = False
        want = mod(x, kv=kv)
    assert ft.fused_transformer_block.launches == before + 1
    assert _rel(got, want) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,heads", [
    (4, 768, 224, 8), (4, 192, 448, 8), (2, 64, 64, 4), (3, 40, 96, 3),
    (6, 768, 224, 8), (6, 192, 448, 8),  # a data-parallel rank's ds1, ds2
])
def test_fused_kernel_with_context_matches_twin(dev, b, t, c, heads):
    p = _random_tree(c, dev, seed=2)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(b, t, c, generator=g, device=dev).bfloat16()
    ctx = torch.randn(b, TK, CTX, generator=g, device=dev).bfloat16()
    before = ft.fused_transformer_block.launches
    with torch.no_grad():
        got = ft.fused_transformer_block(x, p, heads, context=ctx)
        want = ft.transformer_block_reference(x, p, heads, context=ctx)
    assert ft.fused_transformer_block.launches == before + 1
    assert _rel(got, want) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,tol", [
    ((12, 8, 768, 28), torch.bfloat16, 2e-2),   # 256px training ds1
    ((6, 8, 768, 28), torch.bfloat16, 2e-2),    # a data-parallel rank's
    ((4, 8, 3072, 64), torch.bfloat16, 2e-2),   # upscale ds2, in JAX's gate
    ((1, 2, 200, 28), torch.bfloat16, 2e-2),    # ragged T
    ((1, 2, 256, 128), torch.bfloat16, 2e-2),   # the widest tensor-core D
    ((2, 1, 768, 512), torch.bfloat16, 2e-2),   # VAE mid AttnBlock: FMA
    ((1, 2, 512, 28), torch.float32, 1e-5),
    ((1, 2, 200, 28), torch.float32, 1e-5),   # ragged T
])
def test_flash_backward_kernels_match_twin(dev, shape, dtype, tol):
    # bf16 up to D = 128 takes the tensor-core passes, the rest the FMA ones
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev, dtype=dtype)
                   for _ in range(4))
    o = fa._reference_attention(q, k, v)
    counters = (fa.flash_backward_dq, fa.flash_backward_dkv)
    before = _routes(*counters)
    dq, lse, di = fa.flash_backward_dq(q, k, v, o, do)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    route = fa._backward_route(shape[2], shape[3], dtype)
    assert route == ("mma" if dtype == torch.bfloat16 and shape[3] <= 128
                     else "fma")
    assert _moved(before, _routes(*counters), route)
    wdq, wlse, wdi = fa._reference_backward_dq(q, k, v, o, do)
    wdk, wdv = fa._reference_backward_dkv(q, k, v, do, wlse, wdi)
    for got, want in ((lse, wlse), (di, wdi), (dq, wdq), (dk, wdk),
                      (dv, wdv)):
        assert _rel(got, want) < tol


@pytest.mark.cuda
def test_flash_attention_gradient_runs_the_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(2, 4, 768, 28, generator=g, device=dev)
               .bfloat16().requires_grad_() for _ in range(3))
    counters = (fa.flash_attention, fa.flash_backward_dq,
                fa.flash_backward_dkv)
    before = _routes(*counters)
    falls = fa.flash_attention.reference_backwards
    fa.flash_attention(q, k, v).float().square().sum().backward()
    assert _moved(before, _routes(*counters), "mma")
    assert fa.flash_attention.reference_backwards == falls
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.cuda
def test_flash_backward_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 1, 512, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_backward_dq(q, q, q, q, q)
    q = torch.zeros(1, 1, 64, 512, device=dev).transpose(2, 3)
    with pytest.raises(ValueError):
        fa.flash_backward_dq(q, q, q, q, q)
    # float32 at T = 4096: JAX's condition refuses it (17.0 MiB of VMEM by
    # its arithmetic) and the FMA passes' score row outgrows shared memory
    q = torch.zeros(1, 1, 4096, 64, device=dev)
    assert not fa.flash_backward_fits(4096, 64, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_backward_dq(q, q, q, q, q)


# K5's shapes on the paths: the U-Net's GroupNorm(+SiLU) inputs and out
# head at the training batch, the out head and the kl-f8 decoder's 32x24
# norms at the chain batch
K5_PATH_SHAPES = [
    (12, 32, 24, 224), (12, 32, 24, 448), (12, 32, 24, 672),
    (12, 16, 12, 224), (12, 16, 12, 448), (12, 16, 12, 672),
    (12, 16, 12, 896), (12, 16, 12, 1344), (12, 8, 6, 448),
    (12, 8, 6, 896), (12, 8, 6, 1344), (12, 8, 6, 1792), (12, 4, 3, 896),
    (12, 4, 3, 1792), (4, 32, 24, 224), (4, 32, 24, 512),
]
# a data-parallel rank's batch: a global batch of 12 over two ranks
DDP_RANK_BATCH = 6
# K6's shapes on the chain: the kl-f8 and kl-f4 decoders past K5's gate
K6_PATH_SHAPES = [
    (4, 64, 48, 512), (4, 128, 96, 256), (4, 128, 96, 512),
    (4, 256, 192, 128), (4, 256, 192, 256), (4, 256, 192, 512),
    (4, 512, 384, 128), (4, 512, 384, 256),
]
# K7's chain shapes, whose first launch is K6's statistics
K7_STATS_SHAPES = [
    (4, 32, 24, 224), (4, 32, 24, 448), (4, 32, 24, 672), (4, 16, 12, 224),
    (4, 16, 12, 448), (4, 16, 12, 672), (4, 16, 12, 896), (4, 8, 6, 448),
    (4, 32, 24, 512),
]


def _gn_inputs(shape, dtype, dev, seed, groups=32):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (2 * torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)
    bias = 0.1 * torch.randn(shape[-1], generator=g, device=dev)
    return x, scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,silu,tol", [
    *((s, torch.bfloat16, True, 2e-2) for s in K5_PATH_SHAPES),
    # each data-parallel rank's fourteen training shapes at batch 6
    *(((DDP_RANK_BATCH,) + s[1:], torch.bfloat16, True, 2e-2)
      for s in K5_PATH_SHAPES[:14]),
    ((12, 16, 12, 448), torch.bfloat16, False, 2e-2),
    ((3, 7, 13, 224), torch.bfloat16, True, 2e-2),   # 91 rows, 8 blocks
    ((2, 4, 3, 2304), torch.bfloat16, True, 2e-2),   # two column passes
    ((2, 3, 3, 2048), torch.bfloat16, True, 2e-2),   # blocks with no rows
    ((2, 1, 3, 64), torch.bfloat16, True, 2e-2),     # one block an image
    ((8, 64, 48, 256), torch.bfloat16, True, 2e-2),  # 1.5 MB an image
    ((2, 8, 6, 224), torch.float32, True, 1e-5),
    ((2, 32, 24, 672), torch.float32, True, 1e-5),   # a 16-block cluster
])
def test_fused_gn_kernel_matches_twin(dev, shape, dtype, silu, tol):
    x, scale, bias = _gn_inputs(shape, dtype, dev, 5)
    before = fg.fused_group_norm.launches, fg.fused_group_norm.clusters
    got = fg.fused_group_norm(x, scale, bias, 32, 1e-5, silu)
    torch.cuda.synchronize()
    # one launch, one cluster per image
    assert (fg.fused_group_norm.launches - before[0],
            fg.fused_group_norm.clusters - before[1]) == (1, shape[0])
    assert got.dtype == dtype
    assert _rel(got, fg._reference_gn(x, scale, bias, 32, 1e-5, silu)) < tol


@pytest.mark.cuda
def test_fused_gn_rejects_what_it_does_not_take(dev):
    ones, zeros = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    x = torch.zeros(1, 4, 4, 128, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fg.fused_group_norm(x, ones, zeros)
    x = torch.zeros(1, 4, 128, 4, device=dev).transpose(2, 3)
    with pytest.raises(ValueError):
        fg.fused_group_norm(x, ones, zeros)
    # where JAX takes the row-tiled statistics kernel, the port launches K6
    x = torch.zeros(1, 256, 192, 128, device=dev, dtype=torch.bfloat16)
    before = fg.fused_group_norm.launches, fg.tiled_group_norm.launches
    out = fg.fused_group_norm(x, ones, zeros)
    torch.cuda.synchronize()
    assert (fg.fused_group_norm.launches,
            fg.tiled_group_norm.launches) == (before[0], before[1] + 1)
    assert torch.equal(out, torch.zeros_like(x))
    # past the one-pass gate, the one-pass kernel itself refuses
    with pytest.raises(ValueError):
        fg._launch(x, ones, zeros, 32, 1e-5, True)
    # channels that are not a multiple of 8
    x = torch.zeros(1, 64, 64, 36, device=dev)
    with pytest.raises(ValueError):
        fg.tiled_group_norm(x, ones[:36], zeros[:36], 4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,groups,tol", [
    *((s, torch.bfloat16, 32, 1e-5) for s in K6_PATH_SHAPES),
    *((s, torch.bfloat16, 32, 1e-5) for s in K7_STATS_SHAPES),
    ((2, 37, 23, 2048), torch.bfloat16, 32, 1e-5),  # two column slabs
    ((3, 37, 23, 200), torch.bfloat16, 8, 1e-5),    # ragged chunks, 25 a group
    ((3, 50, 30, 96), torch.float32, 32, 1e-5),     # 96 / 32 groups, float32
])
def test_gn_stats_kernel_matches_twin(dev, shape, dtype, groups, tol):
    # float32 statistics of a shifted-mean input on both sides, summed in
    # other orders: relative 1e-5; with gamma and beta the launch writes
    # the half-step's [a; b] instead
    x, scale, bias = _gn_inputs(shape, dtype, dev, 7)
    want = fg._reference_gn_stats(x, groups, 1e-6)
    got = fg._stats_launch(x, groups, 1e-6)
    coef = fg._stats_launch(x, groups, 1e-6, scale, bias)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (shape[0], 2, shape[-1])
    assert _rel(got, want) < tol
    a = want[:, 1] * scale
    assert _rel(coef, torch.stack([a, bias - want[:, 0] * a], 1)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,silu,tol", [
    *((s, torch.bfloat16, True, 2e-2) for s in K6_PATH_SHAPES),
    ((4, 128, 96, 512), torch.bfloat16, False, 2e-2),
    ((3, 37, 23, 2048), torch.bfloat16, True, 2e-2),  # ragged, two slabs
    ((2, 64, 48, 256), torch.float32, True, 1e-5),
])
def test_tiled_group_norm_kernels_match_twin(dev, shape, dtype, silu, tol):
    x, scale, bias = _gn_inputs(shape, dtype, dev, 8)
    before = fg.tiled_group_norm.launches
    got = fg.tiled_group_norm(x, scale, bias, 32, 1e-6, silu)
    torch.cuda.synchronize()
    assert fg.tiled_group_norm.launches == before + 1
    assert got.dtype == dtype
    want = fg._reference_tiled(x, scale, bias, 32, 1e-6, silu)
    assert _rel(got, want) < tol


def _gn_routes():
    """The GroupNorm kernels as calls: K5, K6 and K6's statistics with the
    half-step's affine, at shapes that take each."""
    return [
        lambda x, s, b: fg.fused_group_norm(x, s, b, 32, 1e-5, True),
        lambda x, s, b: fg.tiled_group_norm(x, s, b, 32, 1e-6, True),
        lambda x, s, b: fg._stats_launch(x, 32, 1e-5, s, b),
    ], [(4, 32, 24, 512), (4, 64, 48, 512), (4, 16, 12, 896)]


@pytest.mark.cuda
def test_group_norm_kernels_repeat_bit_for_bit(dev):
    """Fixed-order sums, no float atomics: two calls give the same bits."""
    calls, shapes = _gn_routes()
    for call, shape in zip(calls, shapes):
        args = _gn_inputs(shape, torch.bfloat16, dev, 11)
        assert torch.equal(call(*args), call(*args))


@pytest.mark.cuda
def test_group_norm_kernels_on_two_streams_match_one_stream(dev):
    """Launches running at once on two streams count their images in
    counters of their own, so each gives the bits it gives alone."""
    calls, shapes = _gn_routes()
    for call, shape in zip(calls, shapes):
        inputs = [_gn_inputs(shape, torch.bfloat16, dev, seed)
                  for seed in (12, 13)]
        want = [call(*a) for a in inputs]
        streams = [torch.cuda.Stream(dev) for _ in inputs]
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        got = [[], []]
        for _ in range(20):
            for k, s in enumerate(streams):
                with torch.cuda.stream(s):
                    got[k].append(call(*inputs[k]))
        torch.cuda.synchronize()
        for k in range(2):
            assert all(torch.equal(t, want[k]) for t in got[k])


@pytest.mark.cuda
def test_group_norm_kernels_replay_from_a_cuda_graph(dev):
    """A statistics launch captured in a CUDA graph zeroes image counters
    of its own in the graph; replays give the eager call's bits."""
    calls, shapes = _gn_routes()
    for call, shape in zip(calls, shapes):
        args = _gn_inputs(shape, torch.bfloat16, dev, 14)
        want = call(*args)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call(*args)
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want)


def _resblock_inputs(shape, o, dtype, dev, seed=9):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = (2 * torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
    gs = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    gb = 0.1 * torch.randn(c, generator=g, device=dev)
    w = (torch.randn(o, c, 3, 3, generator=g, device=dev)
         / math.sqrt(9 * c)).to(dtype)
    cb = (0.1 * torch.randn(o, generator=g, device=dev)).to(dtype)
    return x, gs, gb, w, cb


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,dtype,groups,tol", [
    ((4, 32, 24, 224), 224, torch.bfloat16, 32, 2e-2),   # interp_256 ds1
    ((4, 32, 24, 672), 224, torch.bfloat16, 32, 2e-2),   # its widest concat
    ((4, 16, 12, 448), 448, torch.bfloat16, 32, 2e-2),   # ds2
    ((4, 32, 24, 512), 512, torch.bfloat16, 32, 2e-2),   # upscale ds4
    ((2, 128, 96, 256), 256, torch.bfloat16, 32, 2e-2),  # beyond the gate
    ((3, 1, 1, 64), 40, torch.bfloat16, 32, 2e-2),       # every tap outside
    ((2, 5, 7, 48), 70, torch.bfloat16, 16, 2e-2),       # ragged tiles
    ((2, 9, 6, 64), 96, torch.float32, 32, 1e-5),
])
def test_fused_resblock_kernel_matches_twin(dev, shape, o, dtype, groups,
                                            tol):
    x, gs, gb, w, cb = _resblock_inputs(shape, o, dtype, dev)
    before = _conv_routes()
    got = frb.fused_gn_silu_conv(x, gs, gb, w, cb, groups, 1e-5)
    torch.cuda.synchronize()
    # bf16 counts in `launches`, the float32 instantiation in its own count
    step = (1, 0) if dtype == torch.bfloat16 else (0, 1)
    assert tuple(a - b for a, b in zip(_conv_routes(), before)) == step
    assert got.shape == shape[:3] + (o,) and got.dtype == dtype
    want = frb._reference(x, gs, gb, w, cb, groups, 1e-5)
    assert _rel(got, want) < tol


def _conv_routes():
    f = frb.fused_gn_silu_conv
    return f.launches, f.fp32_launches


def _split_conv_plan(plan, split):
    """The plan with its channel chunks split in two (or not at all)."""
    per = plan.chunks if not split else -(-plan.chunks // 2)
    return dataclasses.replace(plan, splits=-(-plan.chunks // per),
                               chunks_per_split=per)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,o,dtype,split", [
    ((4, 32, 24, 224), 224, torch.bfloat16, False),  # C = 224: a half chunk
    ((4, 32, 24, 224), 224, torch.bfloat16, True),
    ((4, 32, 24, 672), 224, torch.bfloat16, False),  # C = 672
    ((4, 32, 24, 672), 224, torch.bfloat16, True),
    ((4, 16, 12, 448), 448, torch.bfloat16, False),  # one image per tile
    ((4, 16, 12, 448), 448, torch.bfloat16, True),
    ((2, 7, 13, 200), 72, torch.bfloat16, True),     # C = 8 x 25, ragged O
    ((1, 3, 300, 64), 64, torch.bfloat16, False),    # rows cut in segments
    ((2, 9, 6, 136), 96, torch.float32, True),       # float32, split
])
def test_fused_resblock_schedules_match_twin(dev, shape, o, dtype, split,
                                             monkeypatch):
    """The conv kernel with its channel chunks split in two and unsplit, at
    the chain's channel counts and at ragged shapes, against the twin."""
    plan = _split_conv_plan(gp.plan_conv(shape, o, torch.finfo(dtype).bits
                                         // 8), split)
    assert (plan.splits > 1) == split
    monkeypatch.setattr(gp, "cached_conv_plan",
                        lambda *a: (plan, gp.int_array(plan.as_ints())))
    x, gs, gb, w, cb = _resblock_inputs(shape, o, dtype, dev)
    before = _conv_routes()
    got = frb.fused_gn_silu_conv(x, gs, gb, w, cb, 32 if shape[-1] % 32 == 0
                                 else 8, 1e-5)
    torch.cuda.synchronize()
    step = (1, 0) if dtype == torch.bfloat16 else (0, 1)
    assert tuple(a - b for a, b in zip(_conv_routes(), before)) == step
    want = frb._reference(x, gs, gb, w, cb, 32 if shape[-1] % 32 == 0 else 8,
                          1e-5)
    assert _rel(got, want) < (2e-2 if dtype == torch.bfloat16 else 1e-5)


def _split_products(plans, split):
    """K1's plans with every streamed product's K split in two (or not)."""
    out = []
    for p in plans:
        if p is not None and not p.prologue:
            per = p.ksteps if not split else -(-p.ksteps // 2)
            p = dataclasses.replace(p, splits=-(-p.ksteps // per),
                                    steps_per_split=per)
        out.append(p)
    return (out, gp.int_array(gp.plan_array(out)),
            gp.product_workspace(out))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,variant,split", [
    (3, 250, 224, "kv", False),   # M = 750: no tile size divides it
    (3, 250, 224, "kv", True),    # N = 224 and 672
    (3, 250, 224, "ctx", True),
    (2, 100, 448, "kv", False),
    (2, 100, 448, "ctx", True),
])
def test_fused_kernel_schedules_match_twin(dev, b, t, c, variant, split,
                                           monkeypatch):
    """K1 with its streamed products' K split in two and unsplit, at
    ragged row counts, in both variants, against the twin."""
    p = _random_tree(c, dev, seed=3)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(b, t, c, generator=g, device=dev).bfloat16()
    if variant == "kv":
        kw = {"kv": tuple(torch.randn(b, TK, c, generator=g, device=dev)
                          .bfloat16() for _ in range(2))}
        ctx_dim = None
    else:
        kw = {"context": torch.randn(b, TK, CTX, generator=g, device=dev)
              .bfloat16()}
        ctx_dim = CTX
    forced = _split_products(gp.transformer_plans(b, t, c, TK, ctx_dim),
                             split)
    assert any(q is not None and q.splits > 1 for q in forced[0]) == split
    monkeypatch.setattr(gp, "cached_transformer_plans", lambda *a: forced)
    before = ft.fused_transformer_block.launches
    with torch.no_grad():
        got = ft.fused_transformer_block(x, p, 8, **kw)
        want = ft.transformer_block_reference(x, p, 8, **kw)
    assert ft.fused_transformer_block.launches == before + 1
    assert _rel(got, want) < 2e-2


@pytest.mark.cuda
def test_split_products_repeat_bit_for_bit(dev, monkeypatch):
    """Split partial sums are added in split order by whichever block
    arrives last, so two calls give the same bits."""
    c = 448
    forced = _split_products(gp.transformer_plans(4, 192, c, TK), True)
    assert any(q is not None and q.splits > 1 for q in forced[0])
    monkeypatch.setattr(gp, "cached_transformer_plans", lambda *a: forced)
    p = _random_tree(c, dev, seed=4)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(4, 192, c, generator=g, device=dev).bfloat16()
    kv = tuple(torch.randn(4, TK, c, generator=g, device=dev).bfloat16()
               for _ in range(2))
    with torch.no_grad():
        first = ft.fused_transformer_block(x, p, 8, kv=kv)
        assert torch.equal(first, ft.fused_transformer_block(x, p, 8, kv=kv))
    shape, o = (4, 32, 24, 672), 224
    assert gp.plan_conv(shape, o).splits > 1
    x, gs, gb, w, cb = _resblock_inputs(shape, o, torch.bfloat16, dev)
    first = frb.fused_gn_silu_conv(x, gs, gb, w, cb, 32, 1e-5)
    assert torch.equal(first, frb.fused_gn_silu_conv(x, gs, gb, w, cb, 32,
                                                     1e-5))


@pytest.mark.cuda
def test_split_launches_on_two_streams_match_one_stream(dev):
    """Split launches running at once on two streams count their tiles in
    counters of their own, so each gives the bits it gives alone."""
    shape, o = (4, 32, 24, 672), 224
    assert gp.plan_conv(shape, o).splits > 1
    inputs = [_resblock_inputs(shape, o, torch.bfloat16, dev, seed)
              for seed in (5, 6)]
    want = [frb.fused_gn_silu_conv(*a, 32, 1e-5) for a in inputs]
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[k].append(frb.fused_gn_silu_conv(*inputs[k], 32, 1e-5))
    torch.cuda.synchronize()
    for k in range(2):
        assert all(torch.equal(t, want[k]) for t in got[k])


@pytest.mark.cuda
def test_split_launch_replays_from_a_cuda_graph(dev):
    """A split launch captured in a CUDA graph zeroes counters of its own
    in the graph; its replays give the eager call's bits."""
    shape, o = (4, 32, 24, 672), 224
    assert gp.plan_conv(shape, o).splits > 1
    args = _resblock_inputs(shape, o, torch.bfloat16, dev, 7)
    want = frb.fused_gn_silu_conv(*args, 32, 1e-5)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        frb.fused_gn_silu_conv(*args, 32, 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = frb.fused_gn_silu_conv(*args, 32, 1e-5)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_fused_resblock_gradients_recompute_the_twin(dev):
    x, gs, gb, w, cb = _resblock_inputs((2, 16, 12, 448), 448,
                                        torch.bfloat16, dev)
    leaves = [a.detach().requires_grad_() for a in (x, gs, gb, w, cb)]
    out = frb.fused_gn_silu_conv(*leaves, 32, 1e-5)
    ct = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, ct)
    ref = [a.detach().requires_grad_() for a in (x, gs, gb, w, cb)]
    want = torch.autograd.grad(frb._reference(*ref, 32, 1e-5), ref, ct)
    # the same recompute; cuDNN may sum the conv backward in another order,
    # which flips bf16 roundings of the x, weight and bias gradients by one
    # step (2^-8): two steps of max|gradient|
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _rel(a, b) < 8e-3


@pytest.mark.cuda
def test_fused_resblock_rejects_what_it_does_not_take(dev):
    x, gs, gb, w, cb = _resblock_inputs((1, 4, 4, 64), 64, torch.float16,
                                        dev)
    with pytest.raises(TypeError):
        frb.fused_gn_silu_conv(x, gs, gb, w, cb)
    x = torch.zeros(1, 4, 64, 4, device=dev).transpose(2, 3)
    with pytest.raises(ValueError):
        frb.fused_gn_silu_conv(x, gs, gb, w.float(), cb.float())
    x = torch.zeros(1, 4, 4, 36, device=dev)
    w = torch.zeros(8, 36, 3, 3, device=dev)
    with pytest.raises(ValueError):  # channels not a multiple of 8
        frb.fused_gn_silu_conv(x, gs[:36], gb[:36], w, cb[:8], 4)


@pytest.mark.cuda
def test_build_latent_diffusion_lands_on_cuda(dev):
    from upgpt_torch.zoo import build_latent_diffusion

    model = build_latent_diffusion("tiny")
    assert all(p.device.type == "cuda" for p in model.parameters())
    model = build_latent_diffusion("upscale", dtype="bfloat16",
                                   use_fused_groupnorm=True,
                                   use_fused_resblock=True,
                                   use_fused_vae_groupnorm=True)
    assert all(p.device.type == "cuda" for p in model.parameters())
    assert model.unet.config.fused_level == 2 and model.pose is None


@pytest.mark.cuda
def test_served_batch_dispatch_makes_no_sync(dev):
    """The serving engine's dispatch (pinned copies, the batch's device and
    host generators, the sampler, the decode) raises no sync under the
    sync debug mode, and its images equal the pipeline's on the same batch
    and generators."""
    import numpy as np

    from upgpt_torch.inference.http_serve import RequestBuilder
    from upgpt_torch.inference.encoders import DebugConditioningEncoder
    from upgpt_torch.inference.pipeline import GenerationPipeline
    from upgpt_torch.inference.serving import ServingEngine
    from upgpt_torch.zoo import build_latent_diffusion

    model = build_latent_diffusion("tiny", dtype="bfloat16")
    pipe = GenerationPipeline(model, num_steps=4, eta=0.0, sampler="unipc",
                              schedule_method="karras", output_uint8=True)
    engine = ServingEngine(pipe, batch_size=4)
    builder = RequestBuilder(DebugConditioningEncoder(), mask_hw=(32, 24))
    batch = engine._pack([([builder.build({"txt": f"r {i}", "seed": i})],
                           None, None) for i in range(3)])
    engine.fetch(*engine.dispatch(batch, 0))  # warm-up
    torch.cuda.synchronize()
    before = ft.fused_transformer_block.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, event = engine.dispatch(batch, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = engine.fetch(out, event)
    assert ft.fused_transformer_block.launches > before
    gen, host_gen = engine.generators(1)
    want = pipe.generate(engine.to_device(batch), gen,
                         seed_generator=host_gen).cpu().numpy()
    assert got.shape == (4, 64, 48, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_tiny_chain_moves_the_kernel_counters(dev):
    from upgpt_torch.inference.pipeline import ChainedUpscalePipeline
    from upgpt_torch.zoo import build_latent_diffusion

    switches = dict(dtype="bfloat16", use_fused_groupnorm=True,
                    use_fused_resblock=True, use_fused_vae_groupnorm=True)
    base = build_latent_diffusion("tiny", **switches)
    up = build_latent_diffusion("tiny_upscale", **switches)
    g = torch.Generator(device=dev).manual_seed(10)
    b = 2
    batch = {"text_emb": torch.randn(b, 77, 768, generator=g, device=dev),
             "style_emb": torch.randn(b, 9, 768, generator=g, device=dev),
             "smpl": torch.randn(b, 1, 85, generator=g, device=dev),
             "person_mask": -torch.ones(b, 32, 24, 1, device=dev)}
    # every tiny GroupNorm fits the one-pass kernel; the row-tiled route is
    # held above and by chip_smoke.py's chain phase
    counters = [fg.fused_group_norm, frb.fused_gn_silu_conv]
    before = [f.launches for f in counters]
    out = ChainedUpscalePipeline(base, up, num_steps=4, output_uint8=True
                                 ).generate(batch, g)
    torch.cuda.synchronize()
    assert out.shape == (b, 64, 48, 3) and out.dtype == torch.uint8
    assert all(f.launches > n for f, n in zip(counters, before))


@pytest.mark.cuda
def test_tiny_train_step_moves_every_launch_counter(dev):
    from upgpt_torch.training.train_state import create_train_state, train_step
    from upgpt_torch.zoo import build_latent_diffusion

    model = build_latent_diffusion("tiny", dtype="bfloat16",
                                   param_dtype="float32",
                                   use_fused_groupnorm=True)
    state = create_train_state(model, learning_rate=1e-4)
    g = torch.Generator(device=dev).manual_seed(6)
    b = 2
    batch = {"image": torch.rand(b, 64, 48, 3, generator=g, device=dev) * 2 - 1,
             "person_mask": -torch.ones(b, 32, 24, 1, device=dev),
             "text_emb": torch.randn(b, 77, 768, generator=g, device=dev),
             "style_emb": torch.randn(b, 9, 768, generator=g, device=dev),
             "smpl": torch.randn(b, 1, 85, generator=g, device=dev),
             "loss_w": torch.ones(b, 32, 24, 1, device=dev)}
    counters = [(ft.fused_transformer_block, "launches"),
                (fg.fused_group_norm, "launches"),
                (fa.flash_attention, "launches"),
                (fa.flash_backward_dq, "launches"),
                (fa.flash_backward_dkv, "launches")]
    before = [getattr(f, a) for f, a in counters]
    falls = fa.flash_attention.reference_backwards
    start = [p.detach().clone() for p in state.params]
    state, metrics = train_step(model, state, batch, g)
    torch.cuda.synchronize()
    after = [getattr(f, a) for f, a in counters]
    assert all(n > m for n, m in zip(after, before)), (before, after)
    assert fa.flash_attention.reference_backwards == falls
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    assert all(p.dtype == torch.float32 for p in state.params)
    assert any(not torch.equal(a, p) for a, p in zip(start, state.params))


@pytest.mark.cuda
def test_tiny_distill_update_kernels_match_plain(dev):
    """One distillation update (the teacher eps under no_grad, the student
    its v copy) with the kernels on and off, on the same float32 masters,
    batch and draws: every kernel counter moves on the kernel path, the
    teacher's blocks run K1 without a recompute, and the loss agrees
    within 2e-2 (bf16 rounding in three U-Net evals on both sides)."""
    from upgpt_torch.training import distill as td
    from upgpt_torch.training.train_state import create_train_state
    from upgpt_torch.zoo import build_latent_diffusion

    def build(kernels):
        return build_latent_diffusion(
            "tiny", dtype="bfloat16", param_dtype="float32", device=dev,
            use_flash_attention=kernels, use_fused_transformer=kernels,
            use_fused_groupnorm=kernels)

    model, plain = build(True), build(False)
    g = torch.Generator(device=dev).manual_seed(8)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev)
                    / max(1, p[0].numel()) ** 0.5 if p.dim() > 1
                    else 1 + 0.1 * torch.randn(p.shape, generator=g,
                                               device=dev))
    plain.load_state_dict(model.state_dict())
    b = 2
    batch = {"image": torch.rand(b, 64, 48, 3, generator=g, device=dev) * 2 - 1,
             "person_mask": -torch.ones(b, 32, 24, 1, device=dev),
             "text_emb": torch.randn(b, 77, 768, generator=g, device=dev),
             "style_emb": torch.randn(b, 9, 768, generator=g, device=dev),
             "smpl": torch.randn(b, 1, 85, generator=g, device=dev),
             "loss_w": torch.ones(b, 32, 24, 1, device=dev)}
    tables = td.make_stage_tables(model.schedule, td.make_distill_grids(
        model.schedule, 8, 4, method="karras")[0])
    counters = [ft.fused_transformer_block, fg.fused_group_norm,
                fa.flash_attention, fa.flash_backward_dq,
                fa.flash_backward_dkv]
    losses = {}
    for tag, teacher in (("kernel", model), ("plain", plain)):
        student = td.v_student(teacher)
        teacher.requires_grad_(False)
        draws = td.distill_draws(student, b, tables.num_steps,
                                 torch.Generator(device=dev).manual_seed(9))
        state = create_train_state(student, 1e-4)
        before = [f.launches for f in counters]
        state, metrics = td.distill_step(student, state, teacher, "eps",
                                         batch, tables, draws=draws)
        torch.cuda.synchronize()
        moved = [f.launches - n for f, n in zip(counters, before)]
        losses[tag] = metrics["loss"].item()
        assert all(torch.isfinite(v) for v in metrics.values())
        if tag == "kernel":
            assert all(m > 0 for m in moved), moved
            # the teacher's two evals and the student's forward, each over
            # the same blocks: three K1 launches per block
            assert moved[0] % 3 == 0
        else:
            assert moved == [0] * len(counters), moved
    assert abs(losses["kernel"] - losses["plain"]) <= 2e-2 * abs(
        losses["plain"]), losses


def _selfattn_inputs(dev, b, t, c, heads, seed=0):
    """bf16 tokens and attn1 weights in both layouts (std 1/sqrt(C),
    a float32 bias)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, c, generator=g).to(dev, torch.bfloat16)
    leaves = {n: {"kernel": (torch.randn(c, c, generator=g)
                             / math.sqrt(c)).numpy()}
              for n in ("to_q", "to_k", "to_v", "to_out")}
    leaves["to_out"]["bias"] = (0.1 * torch.randn(c, generator=g)).numpy()
    full, per_head = sl.selfattn_weights(leaves, heads, torch.bfloat16, dev)
    return x, full, per_head


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,heads", [
    (4, 768, 224, 8),   # micro_block's ds1 geometry (dh 28)
    (2, 700, 224, 8),   # ragged T
    (2, 100, 56, 2),    # dh 28, one N tile
    (1, 64, 64, 4),     # dh 16
    (2, 33, 96, 3),     # dh 32, ragged T and N
    (2, 192, 448, 8),   # interp_256's ds2 geometry (dh 56)
    (2, 48, 896, 8),    # interp_256's ds4 geometry (dh 112)
    (2, 40, 56, 8),     # odd dh 7: 2-byte copies, pairs across heads
])
def test_selfattn_leg_kernels_match_twins(dev, b, t, c, heads):
    x, full, per_head = _selfattn_inputs(dev, b, t, c, heads)
    before = (sl.selfattn_fullwidth.launches, sl.selfattn_perhead.launches)
    got_fw = sl.selfattn_fullwidth(x, *full, heads)
    got_ph = sl.selfattn_perhead(x, *per_head)
    torch.cuda.synchronize()
    assert (sl.selfattn_fullwidth.launches,
            sl.selfattn_perhead.launches) == (before[0] + 1, before[1] + 1)
    assert _rel(got_fw, sl.selfattn_fullwidth_reference(x, *full, heads)) \
        < 2e-2
    assert _rel(got_ph, sl.selfattn_perhead_reference(x, *per_head)) < 2e-2
    assert _rel(got_ph, got_fw) < 2e-2


@pytest.mark.cuda
def test_selfattn_leg_kernels_repeat_bit_for_bit(dev):
    # no split reduction and no atomics: two calls, and calls on two
    # streams at once, give the same bits
    x, full, per_head = _selfattn_inputs(dev, 2, 700, 224, 8, seed=1)
    calls = [lambda: sl.selfattn_fullwidth(x, *full, 8),
             lambda: sl.selfattn_perhead(x, *per_head)]
    for call in calls:
        want = call()
        assert torch.equal(call(), want)
        streams = [torch.cuda.Stream() for _ in range(2)]
        got = []
        for st in streams:
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                got.append(call())
        torch.cuda.synchronize()
        assert all(torch.equal(a, want) for a in got)


@pytest.mark.cuda
def test_selfattn_leg_kernels_replay_from_a_cuda_graph(dev):
    x, full, per_head = _selfattn_inputs(dev, 2, 128, 224, 8, seed=2)
    for call in (lambda: sl.selfattn_fullwidth(x, *full, 8),
                 lambda: sl.selfattn_perhead(x, *per_head)):
        want = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_selfattn_leg_kernels_reject_what_they_do_not_take(dev):
    x, full, per_head = _selfattn_inputs(dev, 1, 64, 64, 4)
    wq, wk, wv, wo, bo = full
    with pytest.raises(TypeError):
        sl.selfattn_fullwidth(x.float(), *full, 4)
    with pytest.raises(TypeError):  # the bias is float32
        sl.selfattn_fullwidth(x, wq, wk, wv, wo, bo.bfloat16(), 4)
    with pytest.raises(ValueError):
        sl.selfattn_fullwidth(x, wq.t(), wk, wv, wo, bo, 4)
    with pytest.raises(ValueError):
        sl.selfattn_fullwidth(x, *full, 3)
    with pytest.raises(ValueError):  # K9 takes the per-head layouts
        sl.selfattn_perhead(x, wq, wk, wv, wo, bo)


@pytest.mark.cuda
def test_selfattn_leg_kernels_reject_heads_past_128_lanes(dev):
    x, full, per_head = _selfattn_inputs(dev, 1, 16, 256, 1)
    before = (sl.selfattn_fullwidth.launches, sl.selfattn_perhead.launches)
    with pytest.raises(ValueError, match="128"):
        sl.selfattn_fullwidth(x, *full, 1)
    with pytest.raises(ValueError, match="128"):
        sl.selfattn_perhead(x, *per_head)
    assert (sl.selfattn_fullwidth.launches,
            sl.selfattn_perhead.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,heads", [(2, 200, 224, 8), (2, 70, 448, 8),
                                         (1, 40, 896, 8)])
def test_selfattn_leg_kernels_write_every_pad_lane(dev, monkeypatch, b, t,
                                                   c, heads):
    # the workspaces are handed to the kernels filled with NaN, so an
    # element they leave unwritten, a pad lane above all, reaches Q K^T or
    # to_out as NaN and stays NaN in the workspace
    x, full, per_head = _selfattn_inputs(dev, b, t, c, heads, seed=3)
    dh, dp = c // heads, sl.padded_head(c // heads)
    assert dh < dp
    given, allocate = [], sl._workspaces

    def poisoned(*args):
        given.append(tuple(w.fill_(float("nan")) for w in allocate(*args)))
        return given[-1]

    monkeypatch.setattr(sl, "_workspaces", poisoned)
    for call, plain in (
            (lambda: sl.selfattn_fullwidth(x, *full, heads),
             lambda: sl.selfattn_fullwidth_reference(x, *full, heads)),
            (lambda: sl.selfattn_perhead(x, *per_head),
             lambda: sl.selfattn_perhead_reference(x, *per_head))):
        got = call()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert _rel(got, plain()) < 2e-2
        qkv, o = given[-1]
        for ws, planes in ((qkv, 3 * b * heads), (o, b * heads)):
            ws = ws.reshape(planes, t, dp)
            assert torch.isfinite(ws).all()
            assert torch.equal(ws[..., dh:], torch.zeros_like(ws[..., dh:]))
    assert len(given) == 2


# ------------------------------------------------ training on the card


@pytest.mark.cuda
def test_decode_transport_on_the_card_is_exact(dev):
    from upgpt_torch.training.trainer import decode_transport

    q = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16, 1)
    emb = torch.randn(2, 77, 768).bfloat16()
    got = decode_transport({"image": q.to(dev), "text_emb": emb.to(dev)})
    want = decode_transport({"image": q, "text_emb": emb})
    assert got["image"].dtype == torch.float32
    assert torch.equal(got["image"].cpu(), want["image"])
    assert torch.equal(got["text_emb"].cpu(), want["text_emb"])


@pytest.mark.cuda
def test_tiny_fit_on_the_card_then_cli_sample(dev, tmp_path, monkeypatch):
    """`cli train` for two steps of the tiny model on the card (pinned
    copies on a side stream, the compact transport, CUDA generators),
    then `cli sample` from its last checkpoint."""
    import sys

    from upgpt_torch import cli
    from upgpt_torch.data.tree import write_fashion_tree

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tree = write_fashion_tree(tmp_path / "tree", {"train": (2, 0),
                                                  "validation": (2, 0)},
                              image_hw=(16, 16), seed=4)
    dotlist = [f"data.{s}.params.{k}={v}"
               for s in ("train", "validation", "test")
               for k, v in (("folder", tree["folder"]),
                            ("data_file", tree["data_file"]),
                            ("image_size", "[16,16]"), ("f", 2))]
    dotlist += [f"data.train.params.pair_file=['{tree['train']}']",
                f"data.validation.params.pair_file=['{tree['validation']}']",
                f"data.test.params.pair_file=['{tree['validation']}']",
                "model.params.variant=tiny", "model.params.latent_size=(8,8)",
                "model.params.use_fused_groupnorm=True",
                "trainer.batch_size=2", "trainer.max_epochs=2",
                "trainer.log_every=1", "trainer.log_images_every=2",
                "trainer.image_log_ddim_steps=2",
                f"trainer.logdir={tmp_path / 'run'}"]
    import os

    config = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "deepfashion",
        "interp_256.yaml")
    state = cli.main(["train", "--base", config, "--debug-encoder"]
                     + dotlist)
    assert state.step == 2
    assert all(p.is_cuda and p.dtype == torch.float32 for p in state.params)
    last = tmp_path / "run" / "checkpoints" / "last"
    assert last.exists() and (tmp_path / "run" / "images"
                              / "samples_00000002.png").exists()
    imgs = cli.main(["sample", "--base", config, "--debug-encoder",
                     "--ckpt", str(last), "--batch", "2", "--steps", "4",
                     "--out", str(tmp_path / "out")] + dotlist)
    assert imgs.shape == (2, 16, 16, 3)
    assert torch.isfinite(torch.from_numpy(imgs)).all()
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "sample_000.jpg", "sample_001.jpg"]


@pytest.mark.cuda
def test_clip_encode_on_the_card_matches_the_cpu(dev, tmp_path, monkeypatch):
    """The trainer's split CLIP encode on the card (tokens on the host,
    pinned copies and the towers on the copy stream, the step's stream
    waiting on its event) against the whole encode on the CPU, float32
    with TF32 off on both backends (cuDNN takes the patch conv in TF32 by
    default), small towers read from port-layout state dicts."""
    from upgpt_torch.inference.encoders import CLIPConditioningEncoder
    from upgpt_torch.models.clip import (
        CLIPTextConfig, CLIPTextTower, CLIPVisionConfig, CLIPVisionTower,
    )
    from upgpt_torch.training.trainer import Trainer, TrainerConfig
    from upgpt_torch.zoo import build_latent_diffusion

    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.manual_seed(0)
    merges = [("r", "e"), ("re", "d</w>"), ("c", "o"), ("co", "at</w>")]
    (tmp_path / "bpe.txt").write_text("\n".join(" ".join(m) for m in merges))
    torch.save(CLIPTextTower(CLIPTextConfig(
        vocab_size=600, num_layers=1)).state_dict(), tmp_path / "text.pt")
    torch.save(CLIPVisionTower(CLIPVisionConfig(
        hidden_size=128, num_layers=1, num_heads=2)).state_dict(),
        tmp_path / "vision.pt")
    files = [str(tmp_path / n) for n in ("text.pt", "vision.pt", "bpe.txt")]
    card = CLIPConditioningEncoder.from_files(*files, device=dev)
    cpu = CLIPConditioningEncoder.from_files(*files, device="cpu")
    g = torch.Generator().manual_seed(1)
    raw = {"txt": ["a red coat", "red red coat coat"],
           "styles": torch.randint(0, 256, (2, 9, 224, 224, 3), generator=g,
                                   dtype=torch.uint8).numpy(),
           "smpl": torch.randn(2, 1, 85, generator=g).numpy()}
    trainer = Trainer(build_latent_diffusion("tiny", device=dev),
                      TrainerConfig(compact_transport=True,
                                    logdir=str(tmp_path / "run")), card)
    host = trainer.host_encode(raw)
    assert set(host) == {"token_ids", "styles", "smpl"}
    got = trainer._ready(trainer._device_batch(host))
    want = cpu.encode_batch(raw)
    assert set(got) == {"text_emb", "style_emb", "smpl"}
    for k in ("text_emb", "style_emb"):
        assert got[k].is_cuda and got[k].dtype == torch.float32
        assert _rel(got[k].cpu(), want[k]) <= 1e-5, k
