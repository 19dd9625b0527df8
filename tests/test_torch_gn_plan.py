"""The GroupNorm kernels' plans (`upgpt_torch/ops/fused_gn.py`) and float32
emulations of the orders they sum in, on the CPU.

(a) At every GroupNorm shape of the three paths: the route each takes (the
    one-pass cluster kernel K5, the row-tiled K6, or K6's statistics at the
    head of the half-step kernel K7), that K5's gate admits a bf16 image
    that fits a portable cluster (8 blocks of at most 227 KB) and its plan
    spreads the images over one wave of the card, that K6's chunks follow
    their rule (one block for a small image, else about PASSES_PER_BLOCK
    row passes a block, at most one block per SM), and that the route
    totals are the launch counts chip_smoke.py expects from the models'
    structure.
(b) Each kernel's order of summation, emulated in float32 as the kernel
    runs it, against JAX's Pallas kernels in interpret mode at two tiny
    shapes (one with C/G = 7): K6's per-thread row sums, row lanes in
    order, the last block's walk over the chunks in order, then the group
    fold (a few threads per group, each its channels in order, then a
    butterfly); K5's slab per block, its row lanes in order, the same
    fold, then the cluster's blocks in rank order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from upgpt_tpu.ops import fused_gn as jgn  # noqa: E402
from upgpt_torch.ops import fused_gn as tgn  # noqa: E402

# launches per train step (batch 12) and per chain run (batch 4) of the
# GroupNorm kernels, by shape: the U-Net's level-1 GroupNorm+SiLU inputs
# and its out head; the out head and the kl-f8 decoder's 32x24 norms; the
# two decoders' larger norms
TRAIN_K5 = {
    (12, 32, 24, 224): 8, (12, 32, 24, 448): 2, (12, 32, 24, 672): 1,
    (12, 16, 12, 224): 1, (12, 16, 12, 448): 6, (12, 16, 12, 672): 1,
    (12, 16, 12, 896): 1, (12, 16, 12, 1344): 1, (12, 8, 6, 448): 1,
    (12, 8, 6, 896): 6, (12, 8, 6, 1344): 1, (12, 8, 6, 1792): 2,
    (12, 4, 3, 896): 11, (12, 4, 3, 1792): 3,
}
CHAIN_K5 = {(4, 32, 24, 224): 50, (4, 32, 24, 512): 11}
CHAIN_K6 = {
    (4, 64, 48, 512): 6, (4, 128, 96, 256): 5, (4, 128, 96, 512): 12,
    (4, 256, 192, 128): 6, (4, 256, 192, 256): 6, (4, 256, 192, 512): 1,
    (4, 512, 384, 128): 6, (4, 512, 384, 256): 1,
}
# K7's nine chain shapes, whose first launch is K6's statistics
K7_SHAPES = [
    (4, 32, 24, 224), (4, 32, 24, 448), (4, 32, 24, 672), (4, 16, 12, 224),
    (4, 16, 12, 448), (4, 16, 12, 672), (4, 16, 12, 896), (4, 8, 6, 448),
    (4, 32, 24, 512),
]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("shape", [*TRAIN_K5, *CHAIN_K5])
def test_k5_cluster_holds_each_path_image(shape):
    n, h, w, c = shape
    assert tgn.fused_group_norm_qualifies(shape, 32)
    # the gate: a bf16 image fits a portable cluster's shared memory
    assert tgn.cluster_plan(shape, 32, 2, 8) is not None
    for itemsize in (2, 4):
        p = tgn.fused_gn_plan(shape, 32, itemsize)
        assert p is not None and p.cluster <= 16
        assert p.cluster & (p.cluster - 1) == 0
        # every row staged once, by blocks of at most `rows` rows
        assert p.cluster * p.rows >= h * w >= p.rows
        # 256 threads a block for a slab of at most 16 KB, else 512
        slab = p.rows * c * itemsize
        assert p.threads == (256 if slab <= 16 * 1024 else 512)
        lanes = p.threads // min(c * itemsize // 16, p.threads)
        assert p.smem == slab + 4 * ((lanes + 1) * 2 * c + 4 * 32)
        assert p.smem <= tgn.SMEM_LIMIT
    # one block for an image it keeps in registers (32 KB), else the most
    # blocks one wave of the card holds, up to 16 and the rows
    k = tgn.fused_gn_plan(shape, 32, 2).cluster
    assert n * k <= tgn.SMS
    if h * w * c * 2 <= 32 * 1024:
        assert k == 1
    else:
        assert k == 16 or 2 * n * k > tgn.SMS or 2 * k > h * w


@pytest.mark.parametrize("shape", list(CHAIN_K6))
def test_k6_takes_the_decoders_past_the_one_pass_gate(shape):
    assert not tgn.fused_group_norm_qualifies(shape, 32)
    assert not jgn.fused_group_norm_qualifies(shape, 32)
    assert tgn.tiled_group_norm_qualifies(shape, 32)


@pytest.mark.parametrize("shape", [*CHAIN_K6, *K7_SHAPES])
def test_k6_chunks_follow_the_rule(shape):
    n, h, w, c = shape
    chunks = tgn.stats_chunks(shape, 2)
    vectors = c * 2 // 16
    slabs = _cdiv(vectors, 256)
    passes = _cdiv(h * w, 256 // min(vectors, 256))
    assert 1 <= chunks <= h * w
    # a small image is one block, which finalizes it alone
    assert (chunks == 1) == (slabs == 1 and passes <= tgn.SINGLE_PASSES)
    if chunks > 1:
        # at most one block per SM; about PASSES_PER_BLOCK passes a block
        # (each thread's loads in flight at once); past 16 chunks, a
        # multiple of 16 for the last block's walk
        assert n * slabs * chunks <= tgn.SMS
        assert _cdiv(passes, chunks) >= tgn.PASSES_PER_BLOCK - 1
        assert chunks <= 16 or chunks % 16 == 0
    # the last block's statistics fit without opting in to more shared
    # memory
    assert 4 * 2 * (c + 32) <= 32 * 1024


def test_route_totals_are_chip_smokes_counts():
    """The shapes above, routed by the gates, give the launch counts
    chip_smoke.py expects on the card from the models' structure."""
    import chip_smoke
    from upgpt_torch.zoo import build_latent_diffusion

    def build(variant, **kw):  # structure only: no weights are drawn
        with torch.device("meta"):
            return build_latent_diffusion(variant, dtype="bfloat16",
                                          device="meta", **kw)

    train = chip_smoke.expected_train_counts(build(
        "interp_256", param_dtype="float32", use_fused_groupnorm=True))
    assert train["fused_group_norm"] == sum(TRAIN_K5.values()) == 45
    assert train["fused_group_norm_plain_routes"] == 0
    kernels = dict(use_fused_groupnorm=True, use_fused_resblock=True,
                   use_fused_vae_groupnorm=True)
    base, up = build("interp_256", **kernels), build("upscale", **kernels)
    chain = [chip_smoke.expected_sampling_counts(m, chip_smoke.CHAIN_BATCH,
                                                 tk)
             for m, tk in ((base, chip_smoke.CONTEXT_TOKENS),
                           (up, chip_smoke.UP_CONTEXT_TOKENS))]
    per_run = lambda k: sum(c[k] for c in chain)  # noqa: E731
    assert per_run("fused_group_norm") == sum(CHAIN_K5.values()) == 61
    assert per_run("tiled_group_norm") == sum(CHAIN_K6.values()) == 43
    assert per_run("fused_resblock") == 1350
    # the same launches by shape that chip_smoke.py checks on the card
    assert chip_smoke.GN_LAUNCHES == {
        "training": {(k, "fused_group_norm"): n for k, n in TRAIN_K5.items()},
        "chain": {**{(k, "fused_group_norm"): n for k, n in CHAIN_K5.items()},
                  **{(k, "tiled_group_norm"): n
                     for k, n in CHAIN_K6.items()}}}


# ---------------------------------------------------------------- (b)
# float32 emulations against JAX's kernels in interpret mode. The orders
# differ from JAX's (one VMEM sum per channel over all rows, then a (C, G)
# matmul), and JAX normalizes as (x - mean) * rstd * scale + shift where
# the port takes x * a + b: float32 rounding alone, so the JAX package's
# own tolerance for these kernels holds (atol 2e-5, rtol 1e-4).

def _lane_sums(xs, lanes):
    """Each row lane's sums over its rows lane, lane + lanes, ... in order,
    float32 throughout: (n, rows, c) -> (lanes, n, c), for x and x * x."""
    s1 = np.zeros((lanes, xs.shape[0], xs.shape[2]), np.float32)
    s2 = np.zeros_like(s1)
    for lane in range(lanes):
        for r in range(lane, xs.shape[1], lanes):
            s1[lane] += xs[:, r]
            s2[lane] += xs[:, r] * xs[:, r]
    return s1, s2


def _in_order(parts):
    """parts[0] + parts[1] + ... in order, from zero."""
    out = np.zeros_like(parts[0])
    for p in parts:
        out += p
    return out


def _fold_groups(s, num_groups, threads):
    """csrc/gn_fold.cuh: the tpg threads of a group (threads / G rounded
    down to a power of two, at most 32) each add, part by part, the
    group's channels i, i + tpg, ... in order, then add their sums in a
    butterfly (xor tpg / 2, ..., 1): (parts, n, c) -> (n, g)."""
    parts, n, c = s.shape
    cpg = c // num_groups
    tpg = 1
    while tpg * 2 <= 32 and tpg * 2 * num_groups <= threads:
        tpg *= 2
    g = s.reshape(parts, n, num_groups, cpg)
    lanes = np.zeros((n, num_groups, tpg), np.float32)
    for p in range(parts):
        for j in range(cpg):
            lanes[:, :, j % tpg] += g[p, :, :, j]
    idx = np.arange(tpg)
    o = tpg // 2
    while o:
        lanes = lanes + lanes[:, :, idx ^ o]
        o //= 2
    return lanes[:, :, 0]


def _normalize(x, g1, g2, cnt, scale, bias, eps, with_silu):
    mean = g1 / np.float32(cnt)
    var = np.maximum(g2 / np.float32(cnt) - mean * mean, np.float32(0))
    rstd = (1 / np.sqrt(var + np.float32(eps))).astype(np.float32)
    cpg = x.shape[-1] // g1.shape[1]
    a = np.repeat(rstd, cpg, axis=1) * scale
    b = bias - np.repeat(mean, cpg, axis=1) * a
    y = x * a[:, None, None] + b[:, None, None]
    if with_silu:
        y = y / (1 + np.exp(-y))
    return y.astype(np.float32)


def _emulate_k6(x, scale, bias, num_groups, eps, with_silu):
    n, h, w, c = x.shape
    hw, v = h * w, 4  # float32: four channels a 16-byte load
    cv = c // v
    chunks = tgn.stats_chunks(x.shape, 4)
    rows = _cdiv(hw, chunks)
    xr = x.reshape(n, hw, c)
    partial = np.zeros((chunks, 2, n, c), np.float32)
    for slab in range(_cdiv(cv, 256)):
        width = min(cv - slab * 256, 256)
        cols = slice(slab * 256 * v, (slab * 256 + width) * v)
        for k in range(chunks):
            xs = xr[:, k * rows:min(hw, (k + 1) * rows), cols]
            s1, s2 = _lane_sums(xs, 256 // width)
            partial[k, 0, :, cols] = _in_order(s1)
            partial[k, 1, :, cols] = _in_order(s2)
    # the last block of each image: the chunks in order, then the groups
    s1, s2 = _in_order(partial[:, 0]), _in_order(partial[:, 1])
    g1 = _fold_groups(s1[None], num_groups, 256)
    g2 = _fold_groups(s2[None], num_groups, 256)
    return _normalize(x, g1, g2, hw * (c // num_groups), scale, bias, eps,
                      with_silu)


def _emulate_k5(x, scale, bias, num_groups, eps, with_silu):
    n, h, w, c = x.shape
    hw = h * w
    p = tgn.fused_gn_plan(x.shape, num_groups, 4)
    lanes = tgn.row_lanes(c, 4, p.threads)
    xr = x.reshape(n, hw, c)
    g1 = np.zeros((n, num_groups), np.float32)
    g2 = np.zeros_like(g1)
    for rank in range(p.cluster):  # the cluster's blocks in rank order
        s1, s2 = _lane_sums(xr[:, rank * p.rows:min(hw, (rank + 1) * p.rows)],
                            lanes)
        g1 += _fold_groups(_in_order(s1)[None], num_groups, p.threads)
        g2 += _fold_groups(_in_order(s2)[None], num_groups, p.threads)
    return _normalize(x, g1, g2, hw * (c // num_groups), scale, bias, eps,
                      with_silu)


@pytest.mark.parametrize("shape", [(2, 9, 7, 224), (2, 40, 30, 128)])
@pytest.mark.parametrize("with_silu", [False, True])
def test_emulated_orders_match_jax_kernels(shape, with_silu):
    rng = np.random.default_rng(3)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    # one K6 block finalizing alone, or several chunks and the last
    # block's walk; a cluster of at least 8 blocks for K5
    assert tgn.stats_chunks(shape, 4) == (1 if shape[1] == 9 else 13)
    assert tgn.fused_gn_plan(shape, 32, 4).cluster >= 8
    args = [jnp.asarray(a) for a in (x, scale, bias)]
    with pltpu.force_tpu_interpret_mode():
        want6 = jgn._tiled_gn_forward(*args, 32, 1e-6, with_silu)
        want5 = jgn._fused_gn_forward(*args, 32, 1e-5, with_silu)
    np.testing.assert_allclose(
        _emulate_k6(x, scale, bias, 32, 1e-6, with_silu), np.asarray(want6),
        atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(
        _emulate_k5(x, scale, bias, 32, 1e-5, with_silu), np.asarray(want5),
        atol=2e-5, rtol=1e-4)
