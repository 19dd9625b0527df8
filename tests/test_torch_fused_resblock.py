"""upgpt_torch's fused GroupNorm+SiLU+conv3x3 (the ResBlock half-step)
against the JAX Pallas kernel.

On CPU the port's `fused_gn_silu_conv` runs its twin inside the same
autograd.Function the card uses; the JAX side runs its Pallas kernel in
interpret mode, as tests/test_fused_resblock.py does. Both round the
activation and the weights to bf16 at the same points and accumulate in
float32, so forwards agree to the float32 summation order of 9*C-term dot
products (measured: 9e-6 on outputs of magnitude ~9; atol 5e-5 with rtol
1e-5). The backward recomputes each package's plain version: JAX's keeps
the float32 weights, the port's the kernel's bf16 roundings, so gradients
differ by bf16 rounding of the weights (JAX's own test of its gradient:
atol 2e-2, rtol 5e-2). The CUDA kernel itself is held against the twin on a
card by tests/test_torch_cuda.py.
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
from upgpt_tpu.ops import fused_resblock as jrb  # noqa: E402
from upgpt_torch.convert.from_jax import load_jax_params  # noqa: E402
from upgpt_torch.models.unet import ResBlock  # noqa: E402
from upgpt_torch.ops import fused_resblock as trb  # noqa: E402


def _inputs(shape, out_ch, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    gs = rng.normal(size=(c,)).astype(np.float32)
    gb = rng.normal(size=(c,)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, out_ch)) * 0.05).astype(np.float32)
    b = rng.normal(size=(out_ch,)).astype(np.float32)
    return x, gs, gb, k, b


def _torch_args(x, gs, gb, k, b, grad=False):
    oihw = np.ascontiguousarray(k.transpose(3, 2, 0, 1))
    return [torch.from_numpy(a).requires_grad_(grad)
            for a in (x, gs, gb, oihw, b)]


@pytest.mark.parametrize("shape,out_ch", [
    ((2, 8, 6, 224), 224),   # level-1 geometry (downscaled spatial)
    ((1, 4, 3, 448), 896),   # channel change
    ((2, 4, 4, 64), 64),
])
def test_twin_matches_jax_kernel(shape, out_ch):
    x, gs, gb, k, b = _inputs(shape, out_ch, 0)
    with pltpu.force_tpu_interpret_mode():
        want = jrb.fused_gn_silu_conv(*map(jnp.asarray, (x, gs, gb, k, b)),
                                      32, 1e-5)
    before = trb.fused_gn_silu_conv.launches
    got = trb.fused_gn_silu_conv(*_torch_args(x, gs, gb, k, b), 32, 1e-5)
    assert trb.fused_gn_silu_conv.launches == before  # CPU: the twin
    assert got.shape == shape[:3] + (out_ch,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=1e-5)


def test_zero_padding_edges():
    """Border pixels see zeros after the activation, as a SAME conv of the
    activation does, not SiLU(GN(0))."""
    x = np.ones((1, 4, 4, 32), np.float32)
    gs, gb = np.ones(32, np.float32), np.zeros(32, np.float32)
    k = np.full((3, 3, 32, 8), 0.01, np.float32)
    b = np.zeros(8, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jrb.fused_gn_silu_conv(*map(jnp.asarray, (x, gs, gb, k, b)),
                                      32, 1e-5)
    got = trb.fused_gn_silu_conv(*_torch_args(x, gs, gb, k, b), 32, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # a constant input normalises to 0 and SiLU(0) = 0 inside; shift the
    # norm so the inside is not 0 and the corner sees 4 of 9 taps
    gb = np.full(32, 1.0, np.float32)
    got = trb.fused_gn_silu_conv(*_torch_args(x, gs, gb, k, b), 32, 1e-5)
    inside = float(torch.nn.functional.silu(torch.tensor(1.0)))
    inside = float(torch.tensor(inside).bfloat16())
    w = float(torch.tensor(0.01).bfloat16())
    corner, centre = got[0, 0, 0, 0].item(), got[0, 1, 1, 0].item()
    assert corner == pytest.approx(4 * 32 * inside * w, rel=1e-5)
    assert centre == pytest.approx(9 * 32 * inside * w, rel=1e-5)


def test_gradients_match_jax_vjp():
    x, gs, gb, k, b = _inputs((1, 4, 4, 64), 32, 1)
    ct = np.random.default_rng(2).normal(size=(1, 4, 4, 32)).astype(
        np.float32)

    def loss(*a):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jrb.fused_gn_silu_conv(*a, 32, 1e-5) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, gs, gb, k, b)))
    args = _torch_args(x, gs, gb, k, b, grad=True)
    out = trb.fused_gn_silu_conv(*args, 32, 1e-5)
    assert out.grad_fn.name() == "_FusedResblockBackward"
    got = torch.autograd.grad(out, args, torch.from_numpy(ct))
    got = list(got)
    got[3] = got[3].permute(2, 3, 1, 0)  # OIHW -> HWIO
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-2,
                                   rtol=5e-2)


@pytest.mark.parametrize("shape,out_ch,ok", [
    ((8, 32, 24, 224), 224, True),
    ((8, 16, 12, 448), 448, True),
    # 896x896x9 bf16 weights alone are ~14 MB -> stays plain
    ((8, 8, 6, 896), 896, False),
    ((8, 256, 192, 128), 128, False),  # VAE size
    ((8, 8, 8, 100), 100, False),
    ((4, 32, 24, 512), 512, True),     # the upscale net's ds4 half-steps
    ((4, 128, 96, 256), 256, False),   # its ds1
    ((8, 64, 256), 256, False),        # not NHWC
])
def test_qualifies_is_the_jax_gate(shape, out_ch, ok):
    assert trb.fused_resblock_qualifies(shape, out_ch) is ok
    assert jrb.fused_resblock_qualifies(shape, out_ch) is ok


def test_packed_weight_follows_the_weight_version():
    w = torch.nn.Parameter(torch.randn(8, 16, 3, 3))
    p1 = trb.packed_conv_weight(w)
    assert p1.shape == (9, 8, 16) and p1.dtype == torch.bfloat16
    assert torch.equal(p1[3 * 1 + 2], w.detach()[:, :, 1, 2].bfloat16())
    assert trb.packed_conv_weight(w) is p1  # same version: reused
    with torch.no_grad():
        w.mul_(2.0)
    p2 = trb.packed_conv_weight(w)
    assert p2 is not p1 and torch.equal(p2, (2 * p1.float()).bfloat16())


def _resblock_params(cin, cout, emb, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((1, 4, 4, cin), np.float32)
    params = JaxResBlock(cout).init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    jnp.zeros((1, emb)))["params"]
    # std 0.1 everywhere: conv_out is zero-initialised
    return jax.tree.map(
        lambda a: np.asarray(rng.normal(size=a.shape) * 0.1, np.float32),
        params)


@pytest.mark.parametrize("shape,cout", [
    ((2, 8, 6, 64), 96),      # both half-steps through the kernel
    ((1, 128, 112, 64), 64),  # past the gate (11 MB): both plain
])
def test_resblock_fused_level_2_matches_jax(shape, cout, monkeypatch):
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    emb = rng.normal(size=(shape[0], 128)).astype(np.float32)
    params = _resblock_params(shape[-1], cout, 128, 4)
    with pltpu.force_tpu_interpret_mode():
        want = JaxResBlock(cout, fused=2).apply(
            {"params": params}, jnp.asarray(x), jnp.asarray(emb))
    tmod = load_jax_params(ResBlock(shape[-1], cout, 128, fused=2), params)
    fits = trb.fused_resblock_qualifies(shape, cout)
    before = trb.fused_gn_silu_conv.launches
    routes = trb.fused_gn_silu_conv.plain_routes
    calls = []
    apply = trb._FusedResblock.apply

    def counted(*a):
        calls.append(1)
        return apply(*a)

    monkeypatch.setattr(trb._FusedResblock, "apply", staticmethod(counted))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(emb))
    assert len(calls) == (2 if fits else 0)
    # a half-step the gate refuses runs plain and is counted
    assert trb.fused_gn_silu_conv.plain_routes == routes + (0 if fits else 2)
    assert trb.fused_gn_silu_conv.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


def test_float32_vectors_follow_the_tensor_version():
    """The norm and bias vectors the kernel reads as float32 are cast once
    per version of the bf16 parameter, as the packed weights are."""
    b = torch.nn.Parameter(torch.randn(8).bfloat16())
    f1 = trb._float32(b, b.device)
    assert f1.dtype == torch.float32 and torch.equal(f1, b.detach().float())
    assert trb._float32(b, b.device) is f1  # same version: reused
    with torch.no_grad():
        b.add_(1.0)
    f2 = trb._float32(b, b.device)
    assert f2 is not f1 and torch.equal(f2, b.detach().float())
    already = torch.randn(8)
    assert trb._float32(already, already.device) is already
