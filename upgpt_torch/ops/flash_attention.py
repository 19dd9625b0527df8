"""Exact attention over (B, H, T, D) tensors: a CUDA kernel and its twin.

Port of `upgpt_tpu.ops.flash_attention` (forward only). The kernel is
`csrc/flash_attention.cu`, which replaces both Pallas forwards,
`_flash_forward_headloop` and `_flash_forward`: scores, row max and row sum
in float32 with the whole key row resident, probabilities cast to the input
type for the value product, and the output divided by the row sum at the
end. On this card it keeps a (16 x T) float32 score tile per block in shared
memory and walks D in chunks, so D up to 512 (the VAE's mid AttnBlock) fits.

`flash_attention` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor (or raises on what the kernel does not take).
The backward pass belongs to the training slice and raises.
"""

from __future__ import annotations

import math

import torch

from upgpt_torch.ops import _build

_MAX_RESIDENT_T = 4096


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


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("flash backward: training slice")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D); returns (B, H, T, D)."""
    if q.device.type == "cpu":
        return _reference_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashForward.apply(q, k, v)


flash_attention.launches = 0  # kernel launches since the last reset
