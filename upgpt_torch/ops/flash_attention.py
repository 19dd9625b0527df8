"""Exact attention over (B, H, T, D) tensors: CUDA kernels and their twins.

Port of `upgpt_tpu.ops.flash_attention`. The forward kernel is
`csrc/flash_attention.cu`, which replaces both Pallas forwards,
`_flash_forward_headloop` and `_flash_forward`, and also runs K1's two
attention passes. It has two instantiations, chosen by dtype:

- bf16 (`flash_attention.launches`): a tensor-core flash forward. Blocks of
  64 query rows stream K and V through shared memory in tiles (cp.async),
  run both products on mma.sync (bf16 in, float32 accumulate) and keep an
  online softmax in the exp2 domain: a running max and a float32 sum per
  row, P rounded to bf16 against the running max, O divided by the sum at
  the end. Any T; D up to 512 (the VAE's mid AttnBlock splits O's columns
  over the grid). `_tiled_reference_attention` is that algorithm in plain
  PyTorch, for the tests;
- float32 (`flash_attention.fma_launches`): the float32 FMA kernel, which
  keeps a (16 x T) float32 score tile per block in shared memory, so T is
  bounded. No path calls it.

The backward kernels are `csrc/flash_backward.cu`, which replace
`_flash_backward_blocked`: pass 1 (`flash_backward_dq`) forms dQ, the
log2-space row LSE and Di = rowsum(dO * O); pass 2 (`flash_backward_dkv`)
rebuilds the normalised probabilities from the LSE and forms dK and dV.
bf16 with D <= 128 runs tensor-core passes (`.launches`, no T limit);
float32, and bf16 with D > 128, run FMA passes whose (16 x T) score rows
bound T (`.fma_launches`). Their plain versions are written from the Pallas
kernels, with the same bf16 casts of dS and P before their products; they
are not autograd of the forward.

`flash_attention` is an autograd.Function on both devices. Its forward takes
the plain version for a CPU tensor and launches a kernel for a CUDA tensor
(or raises on what neither instantiation takes); its backward runs the two
passes (kernels on CUDA, plain versions on CPU) wherever
`flash_backward_fits`, JAX's dispatch condition, admits the shape, and
plain autograd of `_reference_attention` beyond it, as the JAX rule takes
`jax.vjp(_reference_attention)`. Those falls are counted in
`flash_attention.reference_backwards`.
"""

from __future__ import annotations

import math

import torch

from upgpt_torch.ops import _build

_MAX_RESIDENT_T = 4096
_LOG2E = math.log2(math.e)
_LANES = 128
# opt-in shared memory per block on sm_90, less room for static arrays, as
# the csrc FMA kernels count it
_SMEM_LIMIT = 232448 - 1024


def flash_attention_qualifies(b: int, h: int, tq: int, tk: int, d: int,
                              dtype) -> bool:
    """The JAX package's dispatch gate, unchanged: self-attention with
    512 <= T <= 4096, T a multiple of 256, D <= 512."""
    if dtype not in (torch.bfloat16, torch.float32):
        return False
    if tq != tk or tq < 512 or tk > _MAX_RESIDENT_T:
        return False
    if tq % 256 != 0:
        return False
    return d <= 512


def _reference_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: float32 scores, probabilities in v's dtype."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs.float(),
                        v.float()).to(q.dtype)


def _tiled_reference_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """The bf16 forward kernel's algorithm in plain PyTorch, for the tests:
    keys in tiles of 64 (the kernel's tile up to D = 128; 32 at D = 512),
    log2-domain scores (scale * log2(e) folded in), a running max and a
    running float32 sum of the unrounded p per row, p rounded to v's dtype
    against the running max before the value product, the float32 output
    rescaled as the max moves and divided by the sum at the end.
    q (..., Tq, D), k and v (..., Tk, D)."""
    block_k = 64
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), -math.inf, device=q.device)
    l = torch.zeros(q.shape[:-1] + (1,), device=q.device)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device)
    for k0 in range(0, k.shape[-2], block_k):
        kt = k[..., k0:k0 + block_k, :].float()
        vt = v[..., k0:k0 + block_k, :]
        s = torch.einsum("...qd,...kd->...qk", qf, kt) * (scale * _LOG2E)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "...qk,...kd->...qd", p.to(v.dtype).float(), vt.float())
        m = m_new
    return (acc / l).to(q.dtype)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash kernel takes equal (B, H, T, D) q/k/v, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash kernel takes bf16 or float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q/k/v")
    b, h, t, d = q.shape
    if d > 512:  # the dispatch gate's bound; the C side rejects a float32
        # T whose score tile outgrows shared memory
        raise ValueError(f"flash kernel takes D <= 512, got {d}")
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    _build.launch(
        q.device, "upgpt_flash_attention", "flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, t, d, int(bf16), torch.cuda.current_stream(q.device).cuda_stream)
    if bf16:
        flash_attention.launches += 1
    else:
        flash_attention.fma_launches += 1
    return out


def _bwd_blocked_fits(t: int, d: int, itemsize: int, block: int = 256) -> bool:
    """JAX's VMEM budget for one blocked-backward program, copied as a
    dispatch rule: double-buffered resident K/V (or Q/dO), two live float32
    (block, T) score rows and the double-buffered (block, D) tiles, with D
    padded to 128 lanes, within 12 MiB."""
    d_pad = _round_up(d, _LANES)
    vmem = (2 * 2 * t * d_pad * itemsize
            + 2 * block * t * 4
            + 4 * 2 * block * d_pad * itemsize)
    return vmem <= 12 * 1024 * 1024


def flash_backward_fits(t: int, d: int, dtype) -> bool:
    """JAX's backward dispatch condition (`_flash_bwd_rule`), verbatim:
    T <= 4096, T a multiple of 256, and `_bwd_blocked_fits`. It admits the
    512px training geometry (3072, <= 64) in bf16, and bf16 at D = 512 up to
    T = 1536, float32 at D <= 128 up to T = 2816."""
    return (t <= _MAX_RESIDENT_T and t % 256 == 0
            and _bwd_blocked_fits(t, d, dtype.itemsize))


def _backward_route(t: int, d: int, dtype) -> str | None:
    """The backward instantiation that takes (T, D) in `dtype`: "mma"
    (bf16, D <= 128, any T), "fma" (float32, or bf16 with D > 128, while a
    block's (16 x T) float32 score row, its 16 rows of one operand and a
    staged (64 x 64) chunk fit shared memory), or None."""
    if dtype == torch.bfloat16 and d <= 128:
        return "mma"
    t_pad, d_pad = _round_up(t, 64), _round_up(d, 32)
    if 4 * (16 * t_pad + 16 * d_pad + 64 * 64) <= _SMEM_LIMIT:
        return "fma"
    return None


def _reference_backward_dq(q, k, v, o, do):
    """Pass 1 in plain PyTorch, from `_attn_bwd_dq_kernel`: (dq, lse, di),
    lse in log2 space, both (B, H, T) float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        scale * _LOG2E)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    recip = 1.0 / denom
    di = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * ((dp - di) * recip)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(q.dtype).float(),
                      k.float()) * scale
    return (dq.to(q.dtype), (m + torch.log2(denom)).squeeze(-1),
            di.squeeze(-1))


def _reference_backward_dkv(q, k, v, do, lse, di):
    """Pass 2 in plain PyTorch, from `_attn_bwd_dkv_kernel`: (dk, dv)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    st = torch.einsum("bhkd,bhqd->bhkq", k.float(), q.float()) * (
        scale * _LOG2E)
    pn_t = torch.exp2(st - lse[..., None, :])
    dv = torch.einsum("bhkq,bhqd->bhkd", pn_t.to(do.dtype).float(),
                      do.float())
    dp_t = torch.einsum("bhkd,bhqd->bhkq", v.float(), do.float())
    ds_t = pn_t * (dp_t - di[..., None, :])
    dk = torch.einsum("bhkq,bhqd->bhkd", ds_t.to(q.dtype).float(),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_backward(*xs):
    """(B, H, T, D, route) of the equal, contiguous operands, or raise."""
    shape, dtype, dev = xs[0].shape, xs[0].dtype, xs[0].device
    if len(shape) != 4 or any(x.shape != shape for x in xs):
        raise ValueError(f"flash backward takes equal (B, H, T, D) tensors, "
                         f"got {[tuple(x.shape) for x in xs]}")
    if dtype not in (torch.bfloat16, torch.float32) or any(
            x.dtype != dtype for x in xs):
        raise TypeError(f"flash backward takes bf16 or float32, got "
                        f"{[x.dtype for x in xs]}")
    if any(x.device != dev or not x.is_contiguous() for x in xs):
        raise ValueError("flash backward takes contiguous tensors on one "
                         "device")
    b, h, t, d = shape
    route = _backward_route(t, d, dtype)
    if route is None:
        raise ValueError(f"flash backward kernels do not take T={t}, D={d} "
                         f"in {dtype}")
    return b, h, t, d, route


def _count(fn, route: str) -> None:
    if route == "mma":
        fn.launches += 1
    else:
        fn.fma_launches += 1


def flash_backward_dq(q, k, v, o, do):
    """Backward pass 1: (dq, lse, di) for o = flash_attention(q, k, v) and
    the output cotangent `do`; lse (log2) and di are (B, H, T) float32."""
    if q.device.type == "cpu":
        return _reference_backward_dq(q, k, v, o, do)
    b, h, t, d, route = _check_backward(q, k, v, o, do)
    dq = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    di = torch.empty_like(lse)
    _build.launch(
        q.device, "upgpt_flash_backward_dq", "flash_backward_dq",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), lse.data_ptr(), di.data_ptr(), b, h, t, d,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _count(flash_backward_dq, route)
    return dq, lse, di


def flash_backward_dkv(q, k, v, do, lse, di):
    """Backward pass 2: (dk, dv) from pass 1's lse and di."""
    if q.device.type == "cpu":
        return _reference_backward_dkv(q, k, v, do, lse, di)
    b, h, t, d, route = _check_backward(q, k, v, do)
    for name, x in (("lse", lse), ("di", di)):
        if (x.shape != (b, h, t) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"flash backward: {name} must be a contiguous "
                             f"({b}, {h}, {t}) float32 tensor")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch(
        q.device, "upgpt_flash_backward_dkv", "flash_backward_dkv",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t,
        d, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _count(flash_backward_dkv, route)
    return dk, dv


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            out = _reference_attention(q, k, v)
        else:
            out = _launch(q, k, v)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, o = ctx.saved_tensors
        if flash_backward_fits(q.shape[2], q.shape[3], q.dtype):
            do = grad.contiguous()
            dq, lse, di = flash_backward_dq(q, k, v, o, do)
            dk, dv = flash_backward_dkv(q, k, v, do, lse, di)
            return dq, dk, dv
        flash_attention.reference_backwards += 1
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            return torch.autograd.grad(_reference_attention(*leaves), leaves,
                                       grad)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D); returns (B, H, T, D)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashForward.apply(q, k, v)


# kernel launches since the last reset, by route: `launches` the bf16
# tensor-core kernels, `fma_launches` the FMA kernels
flash_attention.launches = 0
flash_attention.fma_launches = 0
# backward passes beyond `flash_backward_fits` (plain autograd)
flash_attention.reference_backwards = 0
flash_backward_dq.launches = flash_backward_dq.fma_launches = 0
flash_backward_dkv.launches = flash_backward_dkv.fma_launches = 0
