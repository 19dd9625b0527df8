"""Exact attention over (B, H, T, D) tensors: CUDA kernels and their twins.

Port of `upgpt_tpu.ops.flash_attention`. The forward kernel is
`csrc/flash_attention.cu`, which replaces both Pallas forwards,
`_flash_forward_headloop` and `_flash_forward`: scores, row max and row sum
in float32 with the whole key row resident, probabilities cast to the input
type for the value product, and the output divided by the row sum at the
end. On this card it keeps a (16 x T) float32 score tile per block in shared
memory and walks D in chunks, so D up to 512 (the VAE's mid AttnBlock) fits.

The backward kernels are `csrc/flash_backward.cu`, which replace
`_flash_backward_blocked`: pass 1 (`flash_backward_dq`) forms dQ, the
log2-space row LSE and Di = rowsum(dO * O); pass 2 (`flash_backward_dkv`)
rebuilds the normalised probabilities from the LSE and forms dK and dV. Their
plain versions are written from the Pallas kernels, with the same bf16 casts
of dS and P before their products; they are not autograd of the forward.

`flash_attention` is an autograd.Function on both devices. Its forward takes
the plain version for a CPU tensor and launches the kernel for a CUDA tensor
(or raises on what the kernel does not take); its backward runs the two
passes (kernels on CUDA, plain versions on CPU) wherever
`flash_backward_fits`, and plain autograd of `_reference_attention` beyond
that gate, as the JAX rule takes `jax.vjp(_reference_attention)`. Those
falls are counted in `flash_attention.reference_backwards`.
"""

from __future__ import annotations

import math

import torch

from upgpt_torch.ops import _build

_MAX_RESIDENT_T = 4096
_LOG2E = math.log2(math.e)
# opt-in shared memory per block on sm_90, less room for static arrays, as
# csrc/flash_backward.cu counts it
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
    if d > 512:  # the dispatch gate's bound; the C side rejects a T whose
        # score tile outgrows shared memory
        raise ValueError(f"flash kernel takes D <= 512, got {d}")
    out = torch.empty_like(q)
    lib = _build.library()
    code = lib.upgpt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, t, d, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def flash_backward_fits(t: int, d: int) -> bool:
    """The backward kernels' gate, re-derived for Hopper in place of the
    TPU's `_bwd_blocked_fits` (VMEM arithmetic): a pass-2 block keeps a
    (16 x T) float32 score row, its 16 rows of one operand, a staged
    (64 x 64) chunk and the L and Di rows in shared memory (the dQ pass
    needs less), and that must fit the 227 KB a block may use. T <= 2880 at
    D <= 64; the training path's (768, 28) needs 72 KB.
    """
    t_pad, d_pad = _round_up(t, 64), _round_up(d, 32)
    return 4 * (16 * t_pad + 16 * d_pad + 64 * 64 + 2 * t_pad) <= _SMEM_LIMIT


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
    if not flash_backward_fits(t, d):
        raise ValueError(f"flash backward kernels do not take T={t}, D={d}")
    return b, h, t, d


def flash_backward_dq(q, k, v, o, do):
    """Backward pass 1: (dq, lse, di) for o = flash_attention(q, k, v) and
    the output cotangent `do`; lse (log2) and di are (B, H, T) float32."""
    if q.device.type == "cpu":
        return _reference_backward_dq(q, k, v, o, do)
    b, h, t, d = _check_backward(q, k, v, o, do)
    dq = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    di = torch.empty_like(lse)
    code = _build.library().upgpt_flash_backward_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), lse.data_ptr(), di.data_ptr(), b, h, t, d,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_backward_dq")
    flash_backward_dq.launches += 1
    return dq, lse, di


def flash_backward_dkv(q, k, v, do, lse, di):
    """Backward pass 2: (dk, dv) from pass 1's lse and di."""
    if q.device.type == "cpu":
        return _reference_backward_dkv(q, k, v, do, lse, di)
    b, h, t, d = _check_backward(q, k, v, do)
    for name, x in (("lse", lse), ("di", di)):
        if (x.shape != (b, h, t) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"flash backward: {name} must be a contiguous "
                             f"({b}, {h}, {t}) float32 tensor")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = _build.library().upgpt_flash_backward_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t,
        d, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
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
        if flash_backward_fits(q.shape[2], q.shape[3]):
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


flash_attention.launches = 0  # forward kernel launches since the last reset
# backward passes beyond `flash_backward_fits` (plain autograd)
flash_attention.reference_backwards = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0
