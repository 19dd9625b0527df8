"""upgpt_torch fused GroupNorm(+SiLU) against the JAX Pallas kernel.

On CPU the port's `fused_group_norm` runs its plain twin inside the same
autograd.Function the card uses (the backward recomputes through the twin);
the JAX side runs its Pallas kernel in interpret mode, as
tests/test_fused_gn.py does. float32: the two compute the same statistics
up to summation order, so the JAX package's own tolerances hold (atol 2e-5
forward; atol 1e-4 / rtol 1e-3 on gradients). The CUDA kernel itself is
held against the twin on a card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from upgpt_tpu.models.unet import ResBlock as JaxResBlock  # noqa: E402
from upgpt_tpu.ops import fused_gn as jgn  # noqa: E402
from upgpt_torch.convert.from_jax import load_jax_params  # noqa: E402
from upgpt_torch.models.unet import ResBlock  # noqa: E402
from upgpt_torch.ops import fused_gn as tgn  # noqa: E402


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    bias = (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    ct = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, ct


@pytest.mark.parametrize("shape", [(2, 8, 6, 224), (1, 4, 3, 896)])
@pytest.mark.parametrize("with_silu", [False, True])
def test_fused_gn_and_gradients_match_jax_kernel(shape, with_silu):
    x, scale, bias, ct = _inputs(shape, 0)

    def jloss(x_, s_, b_):
        out = jgn.fused_group_norm(x_, s_, b_, 32, 1e-5, with_silu)
        return jnp.sum(out * ct), out

    with pltpu.force_tpu_interpret_mode():
        (_, want), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    before = tgn.fused_group_norm.launches
    got = tgn.fused_group_norm(*leaves, 32, 1e-5, with_silu)
    assert tgn.fused_group_norm.launches == before  # CPU: the twin
    assert got.grad_fn.name() == "_FusedGNBackward"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    tgrads = torch.autograd.grad(got, leaves, torch.from_numpy(ct))
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-3)


def test_resblock_fused_level_1_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 6, 64)).astype(np.float32)
    emb = rng.normal(size=(2, 128)).astype(np.float32)
    jmod = JaxResBlock(96, fused=1)
    params = JaxResBlock(96).init(jax.random.PRNGKey(0), jnp.asarray(x),
                                  jnp.asarray(emb))["params"]
    params = jax.tree.map(  # conv_out is zero-initialised
        lambda a: np.asarray(rng.normal(size=a.shape) * 0.1, np.float32),
        params)
    with pltpu.force_tpu_interpret_mode():
        want = jmod.apply({"params": params}, jnp.asarray(x),
                          jnp.asarray(emb))
    tmod = load_jax_params(ResBlock(64, 96, 128, fused=1), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("shape,ok", [
    ((12, 32, 24, 224), True),    # ds1 resblocks, batch 12
    ((12, 32, 24, 672), True),    # the widest U-Net concat: 63 KB a group
    ((12, 4, 3, 1792), True),     # the deepest level
    ((8, 64, 48, 256), True),     # 512px ds1: 96 KB a group
    ((8, 64, 48, 448), False),    # 168 KB a group
    ((8, 256, 192, 128), False),  # 256px VAE decoder tensor
    ((8, 8, 8, 100), False),      # channels not a multiple of 32
    ((8, 64, 256), False),        # not NHWC
])
def test_qualifies(shape, ok):
    assert tgn.fused_group_norm_qualifies(shape, 32) is ok


def test_twin_is_group_norm_then_silu():
    x, scale, bias, _ = _inputs((2, 4, 4, 64), 2)
    from upgpt_torch.ops.basic import group_norm, silu

    args = [torch.from_numpy(a) for a in (x, scale, bias)]
    got = tgn.fused_group_norm(*args, 32, 1e-6, True)
    want = silu(group_norm(*args, 32, 1e-6))
    assert torch.equal(got, want)


# ---- the row-tiled route (K6) ----
# The twin computes what `_tiled_gn_forward` computes: per-channel float32
# sums, group statistics, then x * a + b in float32. The two differ only in
# summation order over up to 49,152 rows, so the JAX package's own
# tolerance for this kernel holds (atol 2e-5, rtol 1e-4).


@pytest.mark.parametrize("shape", [(2, 64, 48, 128), (1, 32, 24, 256)])
@pytest.mark.parametrize("with_silu", [False, True])
def test_tiled_gn_twin_matches_jax_kernel(shape, with_silu):
    rng = np.random.default_rng(5)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.3).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    assert tgn.tiled_group_norm_qualifies(shape, 32)
    with pltpu.force_tpu_interpret_mode():
        want = jgn._tiled_gn_forward(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias), 32, 1e-6, with_silu)
    before = tgn.tiled_group_norm.launches
    got = tgn.tiled_group_norm(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), 32, 1e-6, with_silu)
    assert tgn.tiled_group_norm.launches == before  # CPU: the twin
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_gn_stats_twin_is_group_mean_and_rstd():
    # float64 statistics of a shifted-mean input: the twin's float32
    # E[x^2] - E[x]^2 over 3,072 x 4 values per group stays within 1e-5
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 64, 48, 128)) * 2.0 + 0.3).astype(np.float32)
    stats = tgn._reference_gn_stats(torch.from_numpy(x), 32, 1e-6).numpy()
    assert stats.shape == (2, 2, 128) and stats.dtype == np.float32
    g = x.astype(np.float64).reshape(2, -1, 32, 4)
    mean = g.mean(axis=(1, 3))
    rstd = 1.0 / np.sqrt(g.var(axis=(1, 3)) + 1e-6)
    np.testing.assert_allclose(stats[:, 0], np.repeat(mean, 4, axis=1),
                               atol=1e-5)
    np.testing.assert_allclose(stats[:, 1], np.repeat(rstd, 4, axis=1),
                               rtol=1e-5)


def test_decode_shape_dispatches_to_the_tiled_route():
    # (1, 256, 192, 128) fails both packages' one-pass gates: the port's
    # fused_group_norm takes the tiled route, as the JAX one does
    shape = (1, 256, 192, 128)
    assert not tgn.fused_group_norm_qualifies(shape, 32)
    assert not jgn.fused_group_norm_qualifies(shape, 32)
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(128,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(128,))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jgn.fused_group_norm(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias), 32, 1e-6, True)
    args = [torch.from_numpy(a) for a in (x, scale, bias)]
    before = tgn.tiled_group_norm.launches, tgn.fused_group_norm.launches
    got = tgn.fused_group_norm(*args, 32, 1e-6, True)
    assert torch.equal(got, tgn._reference_tiled(*args, 32, 1e-6, True))
    assert (tgn.tiled_group_norm.launches,
            tgn.fused_group_norm.launches) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("shape", [
    (4, 512, 384, 128), (4, 128, 96, 512), (4, 64, 48, 512), (8, 8, 8, 100),
    (2, 4, 4, 16), (8, 64, 256)])
def test_tiled_qualifies_is_the_jax_gate(shape):
    assert (tgn.tiled_group_norm_qualifies(shape, 32)
            is jgn.tiled_group_norm_qualifies(shape, 32))


@pytest.mark.parametrize("shape,with_silu", [
    ((2, 8, 6, 128), True),     # one-pass route on both sides
    ((1, 64, 48, 256), True),   # row-tiled route on both sides
    ((1, 64, 48, 256), False),  # the AttnBlock's norm: no SiLU
])
def test_vae_group_norm_matches_jax(shape, with_silu):
    from upgpt_tpu.models.vae import VAEGroupNorm as JaxVAEGroupNorm
    from upgpt_torch.models.vae import VAEGroupNorm

    rng = np.random.default_rng(8)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2.0 + 0.3).astype(np.float32)
    params = {"scale": (1 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
              "bias": (0.1 * rng.normal(size=(c,))).astype(np.float32)}
    with pltpu.force_tpu_interpret_mode():
        want = JaxVAEGroupNorm(c, fused=True, with_silu=with_silu).apply(
            {"params": params}, jnp.asarray(x))
    mod = load_jax_params(VAEGroupNorm(c, fused=True, with_silu=with_silu),
                          params)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_unet_groupnorm_past_the_gate_runs_plain_and_is_counted():
    # (1, 64, 48, 448) stages 168 KB a group: the one-pass gate refuses it,
    # and the U-Net's fused GroupNorm+SiLU runs plain, as the JAX
    # GroupNorm32 does past its gate
    from upgpt_torch.models.layers import Norm
    from upgpt_torch.models.unet import group_norm_silu
    from upgpt_torch.ops.basic import group_norm, silu

    x = torch.from_numpy(_inputs((1, 64, 48, 448), 9)[0])
    norm = Norm(448)
    routes = tgn.fused_group_norm.plain_routes
    got = group_norm_silu(x, norm, fused=True)
    assert tgn.fused_group_norm.plain_routes == routes + 1
    assert torch.equal(got, silu(group_norm(x, norm.weight, norm.bias, 32,
                                            1e-5)))
    group_norm_silu(x[:, :8, :6, :224].contiguous(), Norm(224), fused=True)
    assert tgn.fused_group_norm.plain_routes == routes + 1
