"""upgpt_torch flash attention against the JAX Pallas kernel.

On CPU the port's `flash_attention` runs its plain version; the JAX side
runs its Pallas kernel in interpret mode, as tests/test_flash_attention.py
does. float32 where the point is the function: both compute exact softmax
attention, so they agree to float32 rounding of the score and value
reductions (2e-5). bf16 where the point is the tensor-core forward's
rounding order (`_tiled_reference_attention`). The CUDA kernels themselves
are held against the plain versions on a card by tests/test_torch_cuda.py.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

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
    # the forward, and that both give the same gradients in float32. T is a
    # multiple of 256, as JAX's backward dispatch condition asks.
    q, k, v = (torch.randn(1, 1, 256, 8, requires_grad=True)
               for _ in range(3))
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
    # float32 at T = 3072: JAX's VMEM arithmetic gives 13.0 MiB (D pads to
    # 128 lanes) against its 12 MiB budget, so JAX takes jax.vjp here
    shape = (1, 1, 3072, 8)
    assert not tflash.flash_backward_fits(3072, 8, torch.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in _qkv(shape, 7)]
    before = tflash.flash_attention.reference_backwards
    got = torch.autograd.grad(tflash.flash_attention(*leaves).sum(), leaves)
    assert tflash.flash_attention.reference_backwards == before + 1
    want = torch.autograd.grad(
        tflash._reference_attention(*leaves).sum(), leaves)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t,d", [
    (768, 28),    # the 256px training path's ds1 self-attention
    (768, 512),   # the VAE's mid AttnBlock
    (2880, 64),   # not a multiple of 256
    (3072, 64),   # the upscale net's ds2: bf16 only
    (3072, 32),   # 512px ds1: bf16 only
    (1536, 512),  # bf16's widest T at D = 512
    (1792, 512),
    (3072, 8),    # float32: 13.0 MiB
])
def test_backward_gate(t, d, dtype):
    """`flash_backward_fits` is JAX's backward dispatch condition."""
    want = (t <= 4096 and t % 256 == 0 and jflash._bwd_blocked_fits(
        t, d, jnp.dtype(dtype).itemsize))
    assert tflash.flash_backward_fits(t, d, getattr(torch, dtype)) is want


def test_every_admitted_backward_shape_has_a_kernel():
    """Every shape JAX's condition admits has a backward instantiation on
    the card: the tensor-core passes for bf16 up to D = 128, the FMA passes
    (bounded by shared memory) for float32 and for bf16 beyond D = 128."""
    admitted = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in (8, 28, 32, 56, 64, 96, 128, 129, 256, 320, 512):
            for t in range(256, 4097, 256):
                if not tflash.flash_backward_fits(t, d, dtype):
                    continue
                admitted += 1
                route = tflash._backward_route(t, d, dtype)
                want = ("mma" if dtype == torch.bfloat16 and d <= 128
                        else "fma")
                assert route == want, (t, d, dtype, route)
    assert admitted > 100
    # the FMA passes are bounded, the tensor-core passes are not
    assert tflash._backward_route(4096, 64, torch.float32) is None
    assert tflash._backward_route(8192, 64, torch.bfloat16) == "mma"


def _bf16_step(x: np.ndarray) -> float:
    """One bf16 rounding step (8 significant bits) at max|x|."""
    return 2.0 ** (math.floor(math.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("shape", [(1, 2, 512, 28), (1, 1, 1024, 64)])
def test_tiled_forward_matches_jax_kernel_in_bf16(shape):
    """The tensor-core forward's algorithm (64-key tiles, online exp2
    softmax, P rounded to bf16 against the running max) against JAX's
    Pallas forward, which rounds P against the row's final max, both in
    bf16. Each rounds its output to bf16 once, and P's roundings differ by
    at most one bf16 step per element, which the value product averages
    over the keys: at most two bf16 steps at max|ref| (one measured)."""
    q, k, v = _qkv(shape, 8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jflash.flash_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        ).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = tflash._tiled_reference_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    step = _bf16_step(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 * step,
                               rtol=0)
    ref = tflash._reference_attention(tq, tk, tv).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2 * step,
                               rtol=0)


@pytest.mark.parametrize("tq,tk,d", [(200, 87, 28), (192, 200, 56)])
def test_tiled_forward_ragged_keys(tq, tk, d):
    """Key counts that leave the last 64-key tile partly empty, as K1's
    cross-attention (87 context tokens) does: against the plain version in
    bf16 (two bf16 steps, as above) and in float32, where the two are the
    same function summed in another order (2e-6)."""
    rng = np.random.default_rng(9)
    q = rng.normal(size=(1, 2, tq, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, tk, d)).astype(np.float32)
            for _ in range(2))
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    got = tflash._tiled_reference_attention(tq_, tk_, tv_)
    want = tflash._reference_attention(tq_, tk_, tv_)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)
    bq, bk, bv = (x.bfloat16() for x in (tq_, tk_, tv_))
    got = tflash._tiled_reference_attention(bq, bk, bv).float().numpy()
    want = tflash._reference_attention(bq, bk, bv).float().numpy()
    np.testing.assert_allclose(got, want, atol=2 * _bf16_step(want), rtol=0)
