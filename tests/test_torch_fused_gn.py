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
    tmod = load_jax_params(ResBlock(64, 96, 128, fused_gn=True), params)
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
