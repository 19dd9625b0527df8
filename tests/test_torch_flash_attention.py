"""upgpt_torch flash attention against the JAX Pallas kernel.

On CPU the port's `flash_attention` runs its plain version; the JAX side
runs its Pallas kernel in interpret mode, as tests/test_flash_attention.py
does. float32 throughout: both compute exact softmax attention, so they
agree to float32 rounding of the score and value reductions (2e-5).
The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from upgpt_tpu.models.vae import AttnBlock as JaxAttnBlock  # noqa: E402
from upgpt_tpu.ops import flash_attention as jflash  # noqa: E402
from upgpt_torch.convert.from_jax import load_jax_params  # noqa: E402
from upgpt_torch.models.vae import AttnBlock  # noqa: E402
from upgpt_torch.ops import flash_attention as tflash  # noqa: E402

ATOL = 2e-5


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 1, 512, 64), (1, 2, 512, 28)])
def test_flash_matches_jax_kernel(shape):
    q, k, v = _qkv(shape, 0)
    with pltpu.force_tpu_interpret_mode():
        want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert tflash.flash_attention.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("args", [
    (8, 8, 768, 768, 28), (8, 8, 3072, 3072, 64), (8, 1, 768, 768, 512),
    (8, 8, 192, 192, 56), (8, 8, 768, 87, 28), (8, 8, 8192, 8192, 64),
    (1, 1, 640, 640, 64), (1, 1, 512, 512, 513),
])
def test_qualifies_is_the_jax_gate(args):
    for jd, td in [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
                   (jnp.float16, torch.float16)]:
        assert (tflash.flash_attention_qualifies(*args, td)
                == jflash.flash_attention_qualifies(*args, jnp.dtype(jd)))


def test_vae_attn_block_with_flash_matches_jax():
    rng = np.random.default_rng(1)
    b, h, w, c = 1, 16, 32, 64  # T = 512: the flash path qualifies
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    jmod = JaxAttnBlock(c, use_flash=True)
    params = JaxAttnBlock(c).init(jax.random.PRNGKey(0),
                                  jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda a: np.asarray(rng.normal(size=a.shape) * 0.1, np.float32),
        params)
    with pltpu.force_tpu_interpret_mode():
        want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = load_jax_params(AttnBlock(c, use_flash=True), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_backward_is_not_ported():
    q, k, v = (torch.randn(1, 1, 8, 4, requires_grad=True) for _ in range(3))
    # the CPU path is the plain, differentiable version
    tflash.flash_attention(q, k, v).sum().backward()
    with pytest.raises(NotImplementedError):
        tflash._FlashForward.backward(None, torch.zeros(1))
