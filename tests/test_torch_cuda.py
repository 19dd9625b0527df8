"""upgpt_torch's CUDA kernels against their plain versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device: the
kernels have no CPU mode. The file imports no JAX, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.) Tolerances are
relative to max|plain|: 2e-2 in bf16, where both sides round the same
intermediates but accumulate in different orders, and 1e-5 in float32.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from upgpt_torch.models.unet import SpatialTransformer  # noqa: E402
from upgpt_torch.ops import flash_attention as fa  # noqa: E402
from upgpt_torch.ops import fused_transformer as ft  # noqa: E402

TK, CTX = 87, 768


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 1, 768, 512), torch.bfloat16, 2e-2),   # VAE mid AttnBlock
    ((1, 8, 3072, 64), torch.bfloat16, 2e-2),   # 512px upscale
    ((1, 8, 3072, 28), torch.bfloat16, 2e-2),   # 512px mm_512 ds1
    ((1, 2, 512, 28), torch.float32, 1e-5),
])
def test_flash_kernel_matches_plain(dev, shape, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=dtype)
               for _ in range(3))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert _rel(got, fa._reference_attention(q, k, v)) < tol


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 1, 512, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 512, 640, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 64, 512, device=dev).transpose(2, 3)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)


def _random_tree(c, dev, seed=1):
    """bf16 block parameters: weights N(0, 1/fan_in), nothing at zero."""
    g = torch.Generator().manual_seed(seed)

    def w(o, i):
        return (torch.randn(o, i, generator=g) / math.sqrt(i)).to(
            dev, torch.bfloat16)

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=g)).to(
            dev, torch.bfloat16)

    def attn(cd):
        return {"to_q": {"weight": w(c, c)}, "to_k": {"weight": w(c, cd)},
                "to_v": {"weight": w(c, cd)},
                "to_out": {"weight": w(c, c), "bias": vec(c)}}

    norm = lambda: {"weight": vec(c, 1.0), "bias": vec(c)}
    return {
        "norm": norm(), "proj_in": {"weight": w(c, c), "bias": vec(c)},
        "proj_out": {"weight": w(c, c), "bias": vec(c)},
        "block_0": {
            "attn1": attn(c), "attn2": attn(CTX),
            "ff": {"proj_in": {"weight": w(8 * c, c), "bias": vec(8 * c)},
                   "proj_out": {"weight": w(c, 4 * c), "bias": vec(c)}},
            "norm1": norm(), "norm2": norm(), "norm3": norm()},
    }


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,heads", [
    (4, 768, 224, 8), (4, 192, 448, 8), (2, 64, 64, 4), (3, 40, 96, 3),
])
def test_fused_kernel_matches_twin(dev, b, t, c, heads):
    p = _random_tree(c, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, t, c, generator=g, device=dev).bfloat16()
    k = torch.randn(b, TK, c, generator=g, device=dev).bfloat16()
    v = torch.randn(b, TK, c, generator=g, device=dev).bfloat16()
    before = ft.fused_transformer_block.launches
    with torch.no_grad():
        got = ft.fused_transformer_block(x, p, heads, kv=(k, v))
        want = ft.transformer_block_reference(x, p, heads, kv=(k, v))
    assert ft.fused_transformer_block.launches == before + 1
    assert _rel(got, want) < 2e-2


@pytest.mark.cuda
def test_fused_kernel_raises_on_what_it_does_not_take(dev):
    p = _random_tree(64, dev)
    x = torch.zeros(2, 64, 64, device=dev, dtype=torch.bfloat16)
    ctx = torch.zeros(2, TK, CTX, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):  # in-kernel projection
        ft.fused_transformer_block(x, p, 4, context=ctx)
    kv = torch.zeros(2, TK, 64, device=dev)
    with pytest.raises(TypeError):
        ft.fused_transformer_block(x.float(), p, 4, kv=(kv, kv))
    big = torch.zeros(1, 2048, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ft.fused_transformer_block(big, p, 4, kv=(kv[:1].bfloat16(),) * 2)


@pytest.mark.cuda
def test_spatial_transformer_with_context_only_raises(dev):
    # a qualifying block given a context and no precomputed K/V reaches the
    # kernel's wrapper, which does not take that variant
    mod = SpatialTransformer(64, 4, 16, context_dim=CTX, fused=True).to(
        dev, torch.bfloat16)
    x = torch.randn(2, 8, 8, 64, device=dev).bfloat16()
    ctx = torch.randn(2, TK, CTX, device=dev).bfloat16()
    with torch.no_grad(), pytest.raises(NotImplementedError):
        mod(x, ctx)


@pytest.mark.cuda
def test_spatial_transformer_dispatches_to_the_kernel(dev):
    mod = SpatialTransformer(64, 4, 16, context_dim=CTX, fused=True).to(
        dev, torch.bfloat16)
    x = torch.randn(2, 8, 8, 64, device=dev).bfloat16()
    kv = {"block_0": tuple(torch.randn(2, TK, 64, device=dev).bfloat16()
                           for _ in range(2))}
    before = ft.fused_transformer_block.launches
    with torch.no_grad():
        got = mod(x, kv=kv)
        mod.fused = False
        want = mod(x, kv=kv)
    assert ft.fused_transformer_block.launches == before + 1
    assert _rel(got, want) < 2e-2
