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
    # Named when the backward raised. It now checks that the backward is the
    # ported two-pass one (plain versions on CPU) and not plain autograd of
    # the forward, and that both give the same gradients in float32.
    q, k, v = (torch.randn(1, 1, 8, 4, requires_grad=True) for _ in range(3))
    falls = tflash.flash_attention.reference_backwards
    out = tflash.flash_attention(q, k, v)
    assert out.grad_fn.name() == "_FlashForwardBackward"
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert tflash.flash_attention.reference_backwards == falls
    want = torch.autograd.grad(
        tflash._reference_attention(q, k, v).square().sum(), (q, k, v))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2, 512, 16), (1, 2, 512, 28)])
def test_flash_backward_matches_jax_kernel(shape):
    """The port's backward passes (plain versions on CPU) against jax.grad
    through the Pallas forward and blocked backward in interpret mode."""
    q, k, v = _qkv(shape, 3)
    ct = np.random.default_rng(4).normal(size=shape).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jflash.flash_attention(q_, k_, v_) * ct)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (tflash.flash_backward_dq.launches,
              tflash.flash_backward_dkv.launches,
              tflash.flash_attention.reference_backwards)
    got = torch.autograd.grad(tflash.flash_attention(*leaves), leaves,
                              torch.from_numpy(ct))
    assert (tflash.flash_backward_dq.launches,
            tflash.flash_backward_dkv.launches,
            tflash.flash_attention.reference_backwards) == before
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-3)


def test_flash_backward_statistics():
    """Pass 1's row statistics: the log2-space LSE and Di = rowsum(dO*O)."""
    q, k, v, do = _qkv((1, 2, 64, 8), 5) + [np.random.default_rng(6).normal(
        size=(1, 2, 64, 8)).astype(np.float32)]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = tflash._reference_attention(tq, tk, tv)
    _, lse, di = tflash.flash_backward_dq(tq, tk, tv, o, tdo)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(8)
    want = np.log(np.exp(s.astype(np.float64)).sum(-1)) / np.log(2.0)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(di.numpy(), (do * o.numpy()).sum(-1),
                               atol=1e-5)


def test_flash_backward_beyond_the_gate_is_plain_autograd():
    shape = (1, 1, 3072, 8)  # T = 3072: past the Hopper gate
    assert not tflash.flash_backward_fits(3072, 8)
    leaves = [torch.from_numpy(a).requires_grad_() for a in _qkv(shape, 7)]
    before = tflash.flash_attention.reference_backwards
    got = torch.autograd.grad(tflash.flash_attention(*leaves).sum(), leaves)
    assert tflash.flash_attention.reference_backwards == before + 1
    want = torch.autograd.grad(
        tflash._reference_attention(*leaves).sum(), leaves)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t,d,ok", [
    (768, 28, True),     # the 256px training path's ds1 self-attention
    (768, 512, True),    # the VAE's mid AttnBlock
    (2880, 64, True),
    (2944, 64, False),
    (3072, 32, False),   # 512px ds1: plain autograd until a wider kernel
])
def test_backward_gate(t, d, ok):
    assert tflash.flash_backward_fits(t, d) is ok
