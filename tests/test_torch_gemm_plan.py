"""The plans of the Hopper mainloop (`upgpt_torch/ops/gemm_plan.py`) and
float32 emulations of the schedules the kernels run, on the CPU.

(a) For every product K1 runs and every K7 shape on the three paths, at
    their batches, and for K8/K9's two products at every shape
    `chip_smoke.py` and the CUDA tests give them: the tiles cover M x N exactly once, the splits cover K
    exactly once and in order, shared memory stays within the card's
    227 KB, each plan is the one its rule picks (K1: unsplit, the least
    work on the busiest SM; K7: the least modelled cost), and wherever the
    shape allows 132 work units the plan's waves are at least half full.
(b) K7's schedule, emulated as the kernel runs it (per tile and split: the
    halo of each 64-channel chunk activated once as x * a + b and SiLU,
    rounded to bf16, zero outside the image after the activation; the nine
    taps as shifted reads of that halo; the split partials summed in split
    order, split 0 starting from the bias), against JAX's
    `fused_gn_silu_conv` in interpret mode. And K1's panel LayerNorm
    (statistics once per BM-row panel, two passes in float32) against
    `_ln_f32` of both packages.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from upgpt_tpu.ops import fused_resblock as jrb  # noqa: E402
from upgpt_tpu.ops import fused_transformer as jft  # noqa: E402
from upgpt_torch.ops import fused_transformer as tft  # noqa: E402
from upgpt_torch.ops import gemm_plan as gp  # noqa: E402
from upgpt_torch.ops import selfattn_leg as sl  # noqa: E402

# K1 on the paths: (b, t, c, tk, ctx_dim) at the sampling batch (8), the
# chain batch (4, both nets), the training batch (12, context projected)
# and inshop_laion's 78-token context at batch 12 (its `cli sample` with
# K/V, its training with the context)
K1_SHAPES = [
    (8, 768, 224, 87, None), (8, 192, 448, 87, None),
    (4, 768, 224, 87, None), (4, 192, 448, 87, None),
    (4, 768, 512, 86, None),
    (12, 768, 224, 87, 768), (12, 192, 448, 87, 768),
    (12, 768, 224, 78, None), (12, 192, 448, 78, None),
    (12, 768, 224, 78, 768), (12, 192, 448, 78, 768),
]
# K7 on the chain at batch 4: every (shape, O) the two U-Nets give it
# (interp_256's level-2 half-steps at 32x24, 16x12 and 8x6; the upscale
# net's ds4)
K7_SHAPES = [
    ((4, 32, 24, 224), 224), ((4, 32, 24, 448), 224),
    ((4, 32, 24, 672), 224), ((4, 16, 12, 224), 448),
    ((4, 16, 12, 448), 448), ((4, 16, 12, 672), 448),
    ((4, 16, 12, 896), 448), ((4, 8, 6, 448), 896),
    ((4, 32, 24, 512), 512),
]


# K8/K9 (the self-attention leg): chip_smoke.SELFATTN_SHAPES and the
# shapes of tests/test_torch_cuda.py, (b, t, c, heads)
LEG_SHAPES = [
    (32, 768, 224, 8), (32, 700, 224, 8),
    (4, 768, 224, 8), (2, 700, 224, 8), (2, 100, 56, 2), (1, 64, 64, 4),
    (2, 33, 96, 3), (2, 192, 448, 8), (2, 48, 896, 8),
    (2, 200, 224, 8), (2, 70, 448, 8), (1, 40, 896, 8), (2, 128, 224, 8),
]


def _k1_products():
    for shape in K1_SHAPES:
        for name, p in zip(gp.PRODUCTS, gp.transformer_plans(*shape)):
            if p is not None:
                yield shape, name, p


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_plans_cover_each_output_and_k_once(shape):
    for p in gp.transformer_plans(*shape):
        if p is None:
            continue
        seen = np.zeros((p.M, p.N), np.uint8)
        for m0, m1, n0, n1 in p.tile_boxes():
            seen[m0:m1, n0:n1] += 1
        assert (seen == 1).all()
        # a block's N tile never crosses a piece of W (to_q | to_k | to_v)
        pn = p.N // p.parts
        assert all(n0 // pn == (n1 - 1) // pn
                   for _, _, n0, n1 in p.tile_boxes())
        ranges = p.k_ranges()
        assert len(ranges) == p.splits and ranges[0][0] == 0
        assert ranges[-1][1] == p.K
        assert all(a < b for a, b in ranges)
        assert all(ranges[i][1] == ranges[i + 1][0]
                   for i in range(len(ranges) - 1))


def test_k1_plans_fit_the_card_and_fill_it():
    for shape, name, p in _k1_products():
        assert p.smem + gp.STATIC_SMEM <= gp.SMEM_LIMIT, (shape, name)
        assert gp.MIN_STAGES <= p.stages <= gp.MAX_STAGES
        assert p.bn in gp.BN_MENU and p.nb * p.bn <= 256
        assert p.wg <= gp.max_warpgroups(p.bn, p.nb)
        if p.prologue:  # the panel holds all of K
            assert p.splits == 1
        # unsplit, and no unsplit plan puts less work on its busiest SM
        cands = [q for q in gp.product_candidates(
            p.M, p.N, p.K, p.parts, p.prologue, p.gated) if q.splits == 1]
        assert p.splits == 1 and p in cands
        assert gp.product_critical_path(p) == min(
            gp.product_critical_path(q) for q in cands)
        # the most unsplit units any plan could make: 64 x 64 tiles
        most = _cdiv(p.M, 64) * p.parts * _cdiv(p.N // p.parts, 64)
        if most >= gp.SMS:
            assert 2 * p.units >= _cdiv(p.units, gp.SMS) * gp.SMS, (
                shape, name, p)
        # the split workspace holds every split of every tile
        if p.splits > 1:
            assert p.workspace_floats == p.tiles * p.splits * p.bm * p.bn


@pytest.mark.parametrize("shape,o", K7_SHAPES)
def test_k7_plans_cover_each_output_and_chunk_once(shape, o):
    p = gp.plan_conv(shape, o)
    n, h, w, c = shape
    assert p.smem + gp.STATIC_SMEM <= gp.SMEM_LIMIT
    assert p.rows * p.cols <= 64 * p.wg and p.wg <= gp.max_warpgroups(p.bn)
    assert p.cols == w or (p.rows == 1 and p.cols < w)
    seen = np.zeros((n, h, w, o), np.uint8)
    for img, y0, y1, x0, x1 in p.tile_pixels():
        for t in range(p.n_tiles):
            seen[img, y0:y1, x0:x1, t * p.bn:(t + 1) * p.bn] += 1
    assert (seen == 1).all()
    chunks = p.chunk_ranges()
    assert chunks[0][0] == 0 and chunks[-1][1] == _cdiv(c, 64)
    assert all(a < b for a, b in chunks)
    assert all(chunks[i][1] == chunks[i + 1][0]
               for i in range(len(chunks) - 1))
    rows64 = min(h, 64 // w) if w <= 64 else 1
    cols64 = w if w <= 64 else 64
    most = (n * _cdiv(h, rows64) * _cdiv(w, cols64) * _cdiv(o, 64)
            * _cdiv(c, 64))
    if most >= gp.SMS:
        assert 2 * p.units >= _cdiv(p.units, gp.SMS) * gp.SMS
    # no candidate is cheaper by the cost model
    assert gp._conv_cost(p) == min(gp._conv_cost(q)
                                   for q in gp.conv_candidates(shape, o))
    # the plan is a pure function of the shape: the same order every call
    assert gp.plan_conv(shape, o) == p


# ------------------------------------------------------- K7 emulation


def _coefficients(x, gs, gb, groups, eps):
    """K6's affine coefficients: float32 group statistics, var clamped."""
    n, h, w, c = x.shape
    g = x.reshape(n, h * w, groups, c // groups)
    mean = g.mean(dim=(1, 3))
    var = ((g * g).mean(dim=(1, 3)) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    a = rstd.repeat_interleave(c // groups, dim=1) * gs
    return a, gb - mean.repeat_interleave(c // groups, dim=1) * a


def emulate_conv(x, gs, gb, w_oihw, cb, groups, eps, plan):
    """K7's schedule in float32, tile by tile as the kernel runs it."""
    n, h, wd, c = x.shape
    o = w_oihw.shape[0]
    a, b = _coefficients(x, gs, gb, groups, eps)
    packed = w_oihw.permute(2, 3, 0, 1).reshape(9, o, c)
    packed = packed.to(torch.bfloat16).float()
    out = torch.zeros(n, h, wd, o)
    rows, cols = plan.rows, plan.cols
    for img, y0, y1, x0, x1 in plan.tile_pixels():
        for t in range(plan.n_tiles):
            o0, o1 = t * plan.bn, min((t + 1) * plan.bn, o)
            partials = []
            for split, (first, last) in enumerate(plan.chunk_ranges()):
                acc = (cb[o0:o1].expand(rows * cols, -1).clone() if split == 0
                       else torch.zeros(rows * cols, o1 - o0))
                for chunk in range(first, last):
                    c0, c1 = chunk * 64, min(chunk * 64 + 64, c)
                    halo = torch.zeros(rows + 2, cols + 2, 64)
                    for hy in range(rows + 2):
                        yy = y0 - 1 + hy
                        for hx in range(cols + 2):
                            xx = x0 - 1 + hx
                            if 0 <= yy < h and 0 <= xx < wd:
                                v = x[img, yy, xx, c0:c1] * a[img, c0:c1] \
                                    + b[img, c0:c1]
                                v = v / (1 + torch.exp(-v))
                                halo[hy, hx, :c1 - c0] = v.to(
                                    torch.bfloat16).float()
                    for tap in range(9):
                        dy, dx = tap // 3, tap % 3
                        patch = halo[dy:dy + rows, dx:dx + cols, :c1 - c0]
                        acc += patch.reshape(-1, c1 - c0) @ \
                            packed[tap, o0:o1, c0:c1].T
                partials.append(acc)
            total = torch.zeros_like(partials[0])
            for part in partials:  # split order
                total = total + part
            total = total.reshape(rows, cols, o1 - o0)
            out[img, y0:y1, x0:x1, o0:o1] = total[:y1 - y0, :x1 - x0]
    return out


def _conv_inputs(shape, o, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    gs = rng.normal(size=(c,)).astype(np.float32)
    gb = rng.normal(size=(c,)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, o)) * 0.05).astype(np.float32)
    b = rng.normal(size=(o,)).astype(np.float32)
    return x, gs, gb, k, b


@pytest.mark.parametrize("shape,o,groups,split", [
    ((2, 6, 5, 224), 96, 32, True),    # C = 224: three chunks and a half
    ((2, 6, 5, 224), 96, 32, False),
    ((1, 5, 7, 200), 72, 8, True),     # C = 8 x 25
    ((1, 2, 130, 64), 16, 32, False),  # rows cut in two segments
])
def test_k7_schedule_matches_jax_kernel(shape, o, groups, split):
    """Tolerance: the emulation activates x * a + b, as the kernel does,
    where JAX computes (x - mean) * rstd * scale + shift. The two differ in
    float32 rounding, so an activation that lies on a bf16 rounding
    boundary can round one step (2^-8 of it) apart, and one such flip moves
    an output by up to 2^-8 * |activation| * |weight| ~ 2e-3 here. The
    mean error stays at the float32 summation level of 9C-term sums."""
    x, gs, gb, k, b = _conv_inputs(shape, o, 5)
    plan = gp.plan_conv(shape, o)
    if shape[2] > 64:  # the schedule with each row cut in segments
        plan = next(p for p in gp.conv_candidates(shape, o)
                    if p.cols < shape[2])
    chunks = plan.chunks
    per = _cdiv(chunks, 2) if split else chunks
    plan = dataclasses.replace(plan, splits=_cdiv(chunks, per),
                               chunks_per_split=per)
    assert (plan.splits > 1) == split
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jrb.fused_gn_silu_conv(
            *map(jnp.asarray, (x, gs, gb, k, b)), groups, 1e-5))
    got = emulate_conv(torch.from_numpy(x), torch.from_numpy(gs),
                       torch.from_numpy(gb),
                       torch.from_numpy(np.ascontiguousarray(
                           k.transpose(3, 2, 0, 1))),
                       torch.from_numpy(b), groups, 1e-5, plan).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-4)
    assert np.abs(got - want).mean() < 1e-4


# ------------------------------------------------------- K8/K9 plans


def test_leg_shapes_are_chip_smokes():
    import chip_smoke

    assert all(shape in LEG_SHAPES for shape, _ in chip_smoke.SELFATTN_SHAPES)


@pytest.mark.parametrize("shape", LEG_SHAPES)
def test_leg_plans_fit_and_cover_each_output_once(shape):
    """Both products of K8/K9: 227 KB with B resident for the whole K, no
    split (one K loop over every step), every (M, N) tile of the output
    computed by exactly one block, the grid a whole number of blocks per
    N tile and at most one wave, and the plan the one its rule picks."""
    b, t, c, heads = shape
    dp = sl.padded_head(c // heads)
    qkv, out = sl.leg_plans(b, t, c, heads)
    assert (qkv.N, qkv.K, qkv.parts, qkv.per_image) == (c, c, 3, False)
    assert (out.N, out.K, out.parts, out.per_image) == (c, heads * dp, 1,
                                                         True)
    for p in (qkv, out):
        assert p.smem + gp.STATIC_SMEM <= gp.SMEM_LIMIT
        assert gp.LEG_MIN_STAGES <= p.stages <= gp.MAX_STAGES
        assert p.bn in gp.BN_MENU and p.wg in (1, 2)
        assert p.ksteps * gp.BK >= p.K > (p.ksteps - 1) * gp.BK
        assert p.grid % p.units == 0 and p.grid <= max(gp.SMS, p.units)
        assert 1 <= p.blocks_per_unit <= p.m_tiles
        seen = np.zeros((b * t, p.parts * p.N), np.uint8)
        for m0, m1, n0, n1 in p.tile_boxes():
            seen[m0:m1, n0:n1] += 1
        assert (seen == 1).all()
        # a tile never crosses a piece (q | k | v) or, per image, an image
        pieces = [n0 // p.N == (n1 - 1) // p.N
                  for _, _, n0, n1 in p.tile_boxes()]
        assert all(pieces)
        if p.per_image:
            assert all(m0 // t == (m1 - 1) // t
                       for m0, m1, _, _ in p.tile_boxes())
        cands = gp.leg_product_candidates(p.b, p.t, p.N, p.K, p.parts,
                                          p.per_image)
        assert p in cands and gp.leg_critical_path(p) == min(
            gp.leg_critical_path(q) for q in cands)
    ints = sl.leg_plan_ints(b, t, c, heads)
    assert ints[:8] == qkv.as_ints() + out.as_ints()
    assert ints[8:10] == (sl.flash_keys(dp), sl.FLASH_STAGES)
    assert ints[10] == min(sl.flash_tiles(b, t, heads), gp.SMS)
    assert (gp.ALIGN_SLACK + sl.flash_smem(dp) + gp.STATIC_SMEM
            <= gp.SMEM_LIMIT)


def test_leg_plans_refuse_what_does_not_fit():
    with pytest.raises(ValueError, match="multiple of 8"):
        gp.plan_leg_product(2, 64, 60, 60, 3)
    # B for the whole K must fit beside the ring: K up to 1,536
    assert gp.plan_leg_product(2, 64, 1536, 1536, 3).bn == 64
    with pytest.raises(ValueError, match="fits shared memory"):
        gp.plan_leg_product(2, 64, 1600, 1600, 3)


# ------------------------------------------------------- K1 panel LN


def emulate_panel_layernorm(z, gamma, beta, bm):
    """LayerNorm as K1's prologue runs it: per BM-row panel, each row's
    mean and then variance from the panel (two passes, float32), applied
    in place; rows past M stay zero and are never stored."""
    m, k = z.shape
    out = torch.zeros(_cdiv(m, bm) * bm, k)
    for m0 in range(0, m, bm):
        panel = torch.zeros(bm, k)
        rows = min(bm, m - m0)
        panel[:rows] = z[m0:m0 + rows]
        mean = panel.mean(dim=1, keepdim=True)
        var = ((panel - mean) ** 2).mean(dim=1, keepdim=True)
        normed = (panel - mean) * torch.rsqrt(var + 1e-5) * gamma + beta
        out[m0:m0 + rows] = normed[:rows]
    return out[:m]


@pytest.mark.parametrize("b,t,c", [(2, 100, 224), (3, 40, 448)])
def test_k1_panel_layernorm_matches_ln_f32(b, t, c):
    """The panel's statistics against both packages' `_ln_f32` on the same
    float32 rows: the same two-pass formula, summed in another order
    (atol 1e-5 on outputs of magnitude ~3)."""
    rng = np.random.default_rng(7)
    z = rng.normal(size=(b * t, c)).astype(np.float32) * 2 + 0.5
    gamma = (1 + 0.1 * rng.normal(size=(c,))).astype(np.float32)
    beta = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    plan = gp.transformer_plans(b, t, c, 87)[gp.PRODUCTS.index("qkv")]
    assert plan.prologue
    got = emulate_panel_layernorm(torch.from_numpy(z), torch.from_numpy(gamma),
                                  torch.from_numpy(beta), plan.bm)
    want_jax = np.asarray(jft._ln_f32(jnp.asarray(z), jnp.asarray(gamma),
                                      jnp.asarray(beta)))
    want_torch = tft._ln_f32(torch.from_numpy(z), torch.from_numpy(gamma),
                             torch.from_numpy(beta))
    np.testing.assert_allclose(got.numpy(), want_jax, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_torch.numpy(), atol=1e-5,
                               rtol=1e-5)
