"""The self-attention leg (K8, K9) and the micro-benchmark, on the CPU.

The twins of `upgpt_torch.ops.selfattn_leg` against the JAX package's
`CrossAttention` run as self-attention on a tiny `SpatialTransformer`'s
`block_0/attn1` leaves, carried into both weight layouts through the split
helpers. float32, atol 1e-5: both sides compute the same float32 products
and softmax and differ only in summation order (and JAX splits the 1/sqrt
scale over q and k). The CUDA kernels themselves are held against these
twins in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.models.unet import (  # noqa: E402
    CrossAttention, SpatialTransformer, _BlockParams,
)
from upgpt_tpu.ops import fused_transformer as jft  # noqa: E402
from upgpt_torch.benchmarks import micro_block  # noqa: E402
from upgpt_torch.ops import selfattn_leg as sl  # noqa: E402

CASES = [(32, 4, 24), (56, 2, 40)]  # (C, heads, T): dh 8, and dh 28


def _attn1(c, heads, seed):
    """A tiny SpatialTransformer's block_0/attn1, every leaf re-drawn
    (std 1/sqrt(fan_in), the bias too), as numpy. A width that GroupNorm's
    32 groups do not divide (56) takes the holder that makes block_0 of
    the SpatialTransformer, `_BlockParams`, alone."""
    if c % 32 == 0:
        shapes = jax.eval_shape(
            SpatialTransformer(c, heads, c // heads, context_dim=c).init,
            jax.random.PRNGKey(0), jnp.zeros((1, 2, 3, c)),
            jnp.zeros((1, 5, c)))["params"]["block_0"]
    else:
        shapes = jax.eval_shape(_BlockParams(c, c).init,
                                jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)
    return {name: {leaf: (rng.normal(size=s.shape) / np.sqrt(
                c if leaf == "bias" else s.shape[0])).astype(np.float32)
                   for leaf, s in node.items()}
            for name, node in shapes["attn1"].items()}


@pytest.mark.parametrize("c,heads,t", CASES)
def test_twins_match_jax_self_attention(c, heads, t):
    attn1 = _attn1(c, heads, seed=c)
    x = np.random.default_rng(1).normal(size=(2, t, c)).astype(np.float32)
    want = CrossAttention(heads, c // heads, c).apply(
        {"params": jax.tree.map(jnp.asarray, attn1)}, jnp.asarray(x))
    full, per_head = sl.selfattn_weights(attn1, heads, torch.float32,
                                         device="cpu")
    tx = torch.from_numpy(x)
    got_full = sl.selfattn_fullwidth_reference(tx, *full, heads)
    got_heads = sl.selfattn_perhead_reference(tx, *per_head)
    np.testing.assert_allclose(got_full.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_heads.numpy(), np.asarray(want), atol=1e-5)
    # the two layouts agree with each other
    np.testing.assert_allclose(got_heads.numpy(), got_full.numpy(), atol=1e-5)


def test_library_yardstick_computes_the_same_function():
    # chip_smoke times one F.multi_head_attention_forward beside K8/K9: the
    # three weights transposed and stacked as in_proj_weight, wo^T and bo
    # as the out projection
    import torch.nn.functional as F

    c, heads = 56, 2
    full, _ = sl.selfattn_weights(_attn1(c, heads, seed=5), heads,
                                  torch.float32, device="cpu")
    wq, wk, wv, wo, bo = full
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 24, c)).astype(np.float32))
    xt = x.transpose(0, 1)
    got = F.multi_head_attention_forward(
        xt, xt, xt, c, heads, torch.cat([wq.t(), wk.t(), wv.t()]), None,
        None, None, False, 0.0, wo.t(), bo.reshape(-1), training=False,
        need_weights=False)[0].transpose(0, 1)
    want = sl.selfattn_fullwidth_reference(x, *full, heads)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("c,heads", [(32, 4), (56, 2)])
def test_split_helpers_match_jax(c, heads):
    w = np.random.default_rng(2).normal(size=(c, c)).astype(np.float32)
    np.testing.assert_array_equal(
        sl._split_heads_kernel(torch.from_numpy(w), heads).numpy(),
        np.asarray(jft._split_heads_kernel(jnp.asarray(w), heads)))
    np.testing.assert_array_equal(
        sl._split_heads_out(torch.from_numpy(w), heads).numpy(),
        np.asarray(jft._split_heads_out(jnp.asarray(w), heads)))


def test_wrappers_run_their_twins_on_cpu_tensors():
    attn1 = _attn1(56, 2, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 16, 56)).astype(np.float32)).bfloat16()
    full, per_head = sl.selfattn_weights(attn1, 2, torch.bfloat16,
                                         device="cpu")
    before = (sl.selfattn_fullwidth.launches, sl.selfattn_perhead.launches)
    assert torch.equal(sl.selfattn_fullwidth(x, *full, 2),
                       sl.selfattn_fullwidth_reference(x, *full, 2))
    assert torch.equal(sl.selfattn_perhead(x, *per_head),
                       sl.selfattn_perhead_reference(x, *per_head))
    # no kernel ran
    assert (sl.selfattn_fullwidth.launches,
            sl.selfattn_perhead.launches) == before


@pytest.mark.parametrize("dh,dp", [(28, 32), (56, 64), (112, 128),
                                   (16, 32), (1, 32), (32, 32), (33, 64),
                                   (64, 64), (128, 128)])
def test_heads_pad_to_32_64_or_128_lanes(dh, dp):
    assert sl.padded_head(dh) == dp


@pytest.mark.parametrize("dh", [0, 129, 256])
def test_heads_past_128_lanes_are_refused(dh):
    with pytest.raises(ValueError, match="128"):
        sl.padded_head(dh)


def test_geometry_refuses_before_any_launch():
    # the CUDA wrappers check the geometry before they allocate or launch
    with pytest.raises(ValueError, match="128"):
        sl._geometry("k", torch.empty(1, 16, 256), 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        sl._geometry("k", torch.empty(1, 16, 60), 2)
    assert sl._geometry("k", torch.empty(2, 16, 224), 8) == (2, 16, 224, 28)


@pytest.mark.parametrize("b,t,c,heads", [(32, 768, 224, 8), (2, 192, 448, 8),
                                         (2, 48, 896, 8), (2, 33, 96, 3)])
def test_workspaces_hold_padded_head_major_planes(b, t, c, heads):
    dp = sl.padded_head(c // heads)
    assert sl.workspace_elements(b, t, c, heads) == (
        3 * b * heads * t * dp, b * heads * t * dp)


def emulate_leg(x, wq, wk, wv, wo, bo, heads, bias_first):
    """The kernels' data flow in float32 (csrc/selfattn_leg.cu): the Q/K/V
    product tile by tile of its plan into the padded head-major workspace
    (3, B, H, T, Dp), each pad lane written as zero by the tile that holds
    its head's last lane; softmax(Q K^T / sqrt(dh)) V over the padded
    heads; to_out tile by tile of its plan as a K loop over the heads'
    padded segments of o against wo read as (H, dh, C) with zero rows to
    Dp, the bias first (K9) or last (K8). Returns the output and how often
    each workspace element was written."""
    b, t, c = x.shape
    dh = c // heads
    dp = sl.padded_head(dh)
    qkv_plan, out_plan = sl.leg_plans(b, t, c, heads)
    xm, w = x.reshape(b * t, c), torch.cat([wq, wk, wv], dim=1)
    ws = torch.full((3, b, heads, t, dp), float("nan"))
    written = torch.zeros(ws.shape, dtype=torch.int32)
    for m0, m1, n0, n1 in qkv_plan.tile_boxes():
        part, lo = n0 // c, n0 % c
        rows = torch.arange(m0, m1)
        img, tok = (rows // t)[:, None], (rows % t)[:, None]
        col = torch.arange(lo, lo + n1 - n0)
        ws[part, img, col // dh, tok, col % dh] = xm[m0:m1] @ w[:, n0:n1]
        written[part, img, col // dh, tok, col % dh] += 1
        for h in range(lo // dh, (lo + n1 - n0 - 1) // dh + 1):
            if lo <= h * dh + dh - 1 < lo + n1 - n0:
                ws[part, img, h, tok, dh:] = 0.0
                written[part, img, h, tok, dh:] += 1
    q, k, v = ws
    p = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(dh), dim=-1)
    o = p @ v  # (B, H, T, dp), pad lanes zero
    wo_pad = torch.zeros(heads, dp, c)
    wo_pad[:, :dh] = wo.reshape(heads, dh, c)
    out = torch.empty(b * t, c)
    om = o.permute(0, 2, 1, 3).reshape(b * t, heads, dp)
    for m0, m1, n0, n1 in out_plan.tile_boxes():
        acc = (bo.reshape(-1)[n0:n1].expand(m1 - m0, -1).clone() if bias_first
               else torch.zeros(m1 - m0, n1 - n0))
        for h in range(heads):
            acc = acc + om[m0:m1, h] @ wo_pad[h, :, n0:n1]
        out[m0:m1, n0:n1] = acc if bias_first else acc + bo.reshape(-1)[n0:n1]
    return out.reshape(b, t, c), written, o


@pytest.mark.parametrize("c,heads,t", [(56, 2, 40), (96, 3, 33), (448, 8, 20),
                                       (32, 4, 24), (56, 8, 12)])
def test_kernel_layouts_match_jax_self_attention(c, heads, t):
    """Both kernels' layouts and schedules, emulated in float32, against
    JAX's CrossAttention as self-attention: every workspace element is
    written once (pad lanes too), the pad lanes of o stay zero, and the
    output agrees to 1e-5 (float32 sums in another order). C = 448 cuts
    its 56-lane heads at the Q/K/V tiles' 64-column edges; 8 heads of
    C = 56 are 7 lanes wide."""
    attn1 = _attn1(c, heads, seed=c + t)
    x = np.random.default_rng(9).normal(size=(2, t, c)).astype(np.float32)
    want = np.asarray(CrossAttention(heads, c // heads, c).apply(
        {"params": jax.tree.map(jnp.asarray, attn1)}, jnp.asarray(x)))
    full, _ = sl.selfattn_weights(attn1, heads, torch.float32,
                                  device="cpu")
    dh = c // heads
    for bias_first in (False, True):
        got, written, o = emulate_leg(torch.from_numpy(x), *full, heads,
                                      bias_first)
        assert (written == 1).all()
        assert (o[..., dh:] == 0).all()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_micro_block_main_on_the_cpu(capsys):
    out = micro_block.main(["--device", "cpu", "--batch", "2", "--tokens",
                            "16", "--channels", "64", "--heads", "2",
                            "--context-tokens", "8", "--iters", "1"])
    lines = capsys.readouterr().out.splitlines()
    for name in ("fused_full_block", "selfattn_perhead",
                 "selfattn_fullwidth", "torch_twin"):
        assert sum(ln.startswith(f"{name}: ") and "ms/op" in ln
                   for ln in lines) == 1, name
    # on CPU tensors every wrapper is its twin; the layouts agree up to
    # float32 summation order, so within one bf16 ulp of the largest value
    assert out["rel_err"]["selfattn_fullwidth"] == 0.0
    assert out["rel_err"]["selfattn_perhead"] == 0.0
    assert out["rel_err"]["perhead_vs_fullwidth"] <= 2.0 ** -7


def test_micro_block_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would run on it")
    with pytest.raises(RuntimeError, match="--device cpu"):
        micro_block.main(["--iters", "1"])
