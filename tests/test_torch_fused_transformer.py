"""upgpt_torch fused SpatialTransformer block against the JAX Pallas kernel.

On CPU the port's `fused_transformer_block` runs its plain twin; the JAX
side runs its Pallas kernel in interpret mode, as
tests/test_fused_transformer.py does. float32 throughout, B=2, T=64, C=64,
4 heads and an 87-token precomputed K/V: the two compute the same block up
to float32 summation order and the kernel's folded 1/sqrt(dh) q scale
(the JAX package's own kernel-vs-twin tolerance, atol 2e-5 / rtol 1e-4).
The CUDA kernel itself is held against the twin on a card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from upgpt_tpu.models.unet import SpatialTransformer as JaxST  # noqa: E402
from upgpt_tpu.ops import fused_transformer as jft  # noqa: E402
from upgpt_torch.convert.from_jax import load_jax_params  # noqa: E402
from upgpt_torch.models.unet import SpatialTransformer  # noqa: E402
from upgpt_torch.ops import fused_transformer as tft  # noqa: E402

B, H, W, C, HEADS, TK, CTX = 2, 8, 8, 64, 4, 87, 768
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    ctx = rng.normal(size=(B, TK, CTX)).astype(np.float32)
    params = JaxST(C, HEADS, C // HEADS, context_dim=CTX).init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx))["params"]
    # every weight random and non-zero (proj_out is zero-initialised)
    params = jax.tree.map(
        lambda a: np.asarray(rng.normal(size=a.shape) * 0.05, np.float32),
        params)
    a2 = params["block_0"]["attn2"]
    kv = (ctx @ a2["to_k"]["kernel"], ctx @ a2["to_v"]["kernel"])
    module = load_jax_params(
        SpatialTransformer(C, HEADS, C // HEADS, context_dim=CTX, fused=True),
        params)
    return x, ctx, params, kv, module


def test_fused_block_matches_jax_kernel(setup):
    x, _, params, kv, module = setup
    tokens = x.reshape(B, H * W, C)
    jtree = jax.tree.map(jnp.asarray, params)
    with pltpu.force_tpu_interpret_mode():
        want = jft.fused_transformer_block(
            jnp.asarray(tokens), jtree, HEADS, None,
            tuple(jnp.asarray(a) for a in kv))
    before = tft.fused_transformer_block.launches
    with torch.no_grad():
        got = tft.fused_transformer_block(
            torch.from_numpy(tokens), tft.param_tree(module), HEADS,
            kv=tuple(torch.from_numpy(a) for a in kv))
    assert tft.fused_transformer_block.launches == before  # CPU: the twin
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_spatial_transformer_module_matches_jax(setup):
    x, ctx, params, kv, module = setup
    jmod = JaxST(C, HEADS, C // HEADS, context_dim=CTX, fused=True)
    jkv = {"block_0": tuple(jnp.asarray(a) for a in kv)}
    with pltpu.force_tpu_interpret_mode():
        want = jmod.apply({"params": params}, jnp.asarray(x), None, kv=jkv)
        want_ctx = jmod.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(ctx))
    with torch.no_grad():
        got = module(torch.from_numpy(x),
                     kv={"block_0": tuple(torch.from_numpy(a) for a in kv)})
        got_ctx = module(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx), **TOL)


def test_param_tree_has_the_jax_keys(setup):
    _, _, params, _, module = setup
    tree = tft.param_tree(module)

    def keys(t):
        return {k: keys(v) for k, v in t.items() if isinstance(v, dict)}

    assert keys(tree) == keys(jax.tree.map(lambda a: a, params))


@pytest.mark.parametrize("args,ok", [
    ((768, 224, 8, 87), True),    # ds1 of the 256px nets
    ((192, 448, 8, 87), True),    # ds2
    ((48, 896, 8, 87), False),    # ds4: C > 512
    ((12, 896, 8, 87), False),    # mid
    ((3072, 224, 8, 87), False),  # 512px ds1: T > 1024
    ((768, 200, 8, 87), False),   # C not a multiple of 32
])
def test_qualifies(args, ok):
    assert tft.fused_transformer_qualifies(*args) is ok
    assert not tft.fused_transformer_qualifies(*args, depth=2)


def test_spatial_transformer_follows_reloaded_weights(setup):
    x, ctx, params, kv, module = setup
    # the module caches its parameter tree; loading with assign=True
    # replaces the parameters, and the next call must use the new ones
    fresh = SpatialTransformer(C, HEADS, C // HEADS, context_dim=CTX,
                               fused=True)
    with torch.no_grad():
        fresh(torch.from_numpy(x), torch.from_numpy(ctx))  # builds its tree
        fresh.load_state_dict(module.state_dict(), assign=True)
        got = fresh(torch.from_numpy(x), torch.from_numpy(ctx))
        want = module(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
