"""GroupNorm(+SiLU) over NHWC in one pass: a CUDA kernel and its twin.

Port of `upgpt_tpu.ops.fused_gn`. The kernel is `csrc/fused_gn.cu`, which
replaces `_fused_gn_forward` / `_gn_kernel`: per image and group, float32
statistics with var = E[x^2] - E[x]^2 (clamped at 0, as the plain
`group_norm` does), scale and shift, an optional SiLU, and one write in the
input dtype. On this card one block per (image, group) stages the group's
values in shared memory, so the gate is about one group's slice, not one
image's as on the TPU.

`fused_group_norm` is an autograd.Function, as the JAX function is a
custom_vjp: the forward is the kernel (the twin `_reference_gn` for CPU
tensors), and the backward recomputes through the twin under autograd, as
`_fused_gn_bwd` does. The JAX package has no backward kernel here.

Where the JAX function routes a shape to the row-tiled `_tiled_gn_forward`
(not ported), `fused_group_norm` raises on CUDA; callers check
`fused_group_norm_qualifies` first and take the plain path otherwise.
"""

from __future__ import annotations

import torch

from upgpt_torch.ops import _build
from upgpt_torch.ops.basic import group_norm, silu

# one group's float32 slice in shared memory: two blocks fit an SM's 227 KB
_SMEM_BUDGET = 112 * 1024


def fused_group_norm_qualifies(shape, num_groups: int) -> bool:
    """Whether the one-pass kernel takes an NHWC tensor of this shape.

    Re-derived for Hopper: a block stages one (image, group) slice of
    H*W x C/G float32 values in shared memory, at most 112 KB. Every U-Net
    GroupNorm of the 256px nets qualifies at any batch (the largest, the
    672-channel concat at 32x24, stages 63 KB); the 256px VAE's decode
    tensors do not.
    """
    if len(shape) != 4:
        return False
    _, h, w, c = shape
    if c % num_groups:
        return False
    return h * w * (c // num_groups) * 4 <= _SMEM_BUDGET


def _reference_gn(x, scale, bias, num_groups, eps, with_silu):
    out = group_norm(x, scale, bias, num_groups=num_groups, eps=eps)
    return silu(out) if with_silu else out


def _launch(x, scale, bias, num_groups, eps, with_silu):
    if x.dim() != 4:
        raise ValueError(f"fused GroupNorm takes NHWC, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if not fused_group_norm_qualifies(x.shape, num_groups):
        raise NotImplementedError(
            f"fused GroupNorm: {tuple(x.shape)} with {num_groups} groups "
            f"needs the row-tiled statistics kernel (JAX _tiled_gn_forward), "
            f"which is not ported")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused GroupNorm takes bf16 or float32, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused GroupNorm takes a contiguous NHWC tensor")
    scale = scale.to(x.device, torch.float32).contiguous()
    bias = bias.to(x.device, torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"fused GroupNorm: scale and shift must be ({c},)")
    out = torch.empty_like(x)
    code = _build.library().upgpt_fused_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n,
        h * w, c, num_groups, eps, int(with_silu),
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "fused_group_norm")
    fused_group_norm.launches += 1
    return out


class _FusedGN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, with_silu):
        if x.device.type == "cpu":
            out = _reference_gn(x, scale, bias, num_groups, eps, with_silu)
        else:
            out = _launch(x, scale, bias, num_groups, eps, with_silu)
        ctx.save_for_backward(x, scale, bias)
        ctx.config = (num_groups, eps, with_silu)
        return out

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_(n)
                      for a, n in zip(ctx.saved_tensors, needs)]
            out = _reference_gn(*inputs, *ctx.config)
            wanted = [a for a, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if n else None for n in needs), None, None,
                None)


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5,
                     with_silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over an NHWC tensor; returns x's shape and dtype.

    A CPU tensor takes `_reference_gn`; a CUDA tensor launches the kernel,
    or raises where the kernel does not take the shape.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    return _FusedGN.apply(x, scale, bias, num_groups, eps, with_silu)


fused_group_norm.launches = 0  # kernel launches since the last reset
