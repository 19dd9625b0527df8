"""GroupNorm + SiLU + 3x3 conv, the ResBlock half-step: a CUDA kernel and its
twin.

Port of `upgpt_tpu.ops.fused_resblock`. The kernel is
`csrc/fused_resblock.cu`, which replaces `_fused_forward` / `_kernel`:
GroupNorm(32) with float32 statistics, SiLU, the activation rounded to bf16,
and a SAME-padded 3x3 conv against bf16 weights with float32 accumulation
from the conv bias, stored in x's dtype. On this card it is two launches:
the GroupNorm statistics of `csrc/gn_stats.cu` (one launch, each image
finalized by its last block), then an implicit GEMM
(M = B*H*W, N = O, K = 9*C) on the pipelined wgmma mainloop of
`csrc/gemm_sm90.cuh`: a block activates its tile's halo once per 64-channel
chunk into shared memory and the nine taps read it at shifted rows, with
the weights fed by TMA. Tiles, splits and ring depth come from
`gemm_plan.plan_conv`. bf16 runs count in `launches`, float32 (the same
kernel, instantiated for float32, on no path) in `fp32_launches`. The
variance is clamped at 0, as the port's plain `group_norm` does (the TPU
kernel does not clamp).

The kernel takes any NHWC shape whose channels are a multiple of 8;
`fused_resblock_qualifies` is the JAX package's VMEM arithmetic, kept as the
dispatch rule, so the port fuses exactly the half-steps that JAX fuses.

Weights: the port's `Conv2d` keeps (O, C, 3, 3). The kernel reads a
(9, O, C) bf16 packing, channels contiguous, which TMA reads as
(tap, output, 64-channel) boxes. `packed_conv_weight` keeps that packing on the weight tensor
and redoes it only when the weight's version changes (an optimizer step,
a `copy_`, a state-dict load), so sampling packs each weight once instead
of permuting and casting on every call, as the JAX function does.

`fused_gn_silu_conv` is an autograd.Function, as the JAX function is a
custom_vjp: the forward is the kernel (the twin `_reference` for CPU
tensors), and the backward recomputes the twin under autograd, as `_bwd`
does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from upgpt_torch.ops import _build, gemm_plan
from upgpt_torch.ops.basic import group_norm, silu
from upgpt_torch.ops.fused_gn import _sm_count, stats_chunks

_VMEM_BUDGET_BYTES = 10 * 1024 * 1024


def fused_resblock_qualifies(shape, out_channels: int,
                             num_groups: int = 32) -> bool:
    """The JAX package's gate (fused_resblock.py:40-49): the float32 image,
    its padded copy and the output plus the bf16 weights within 10 MB."""
    if len(shape) != 4:
        return False
    _, h, w, c = shape
    if c % num_groups != 0:
        return False
    need = (h * w * c + (h + 2) * (w + 2) * c + h * w * out_channels) * 4 \
        + 9 * c * out_channels * 2
    return need <= _VMEM_BUDGET_BYTES


def _reference(x, gn_scale, gn_bias, weight, conv_bias, num_groups, eps):
    """Plain version with the kernel's roundings: GroupNorm and SiLU in
    float32, the activation and the (O, C, 3, 3) weights rounded to bf16,
    the conv accumulated in float32 from the bias, cast to x's dtype."""
    y = silu(group_norm(x.float(), gn_scale, gn_bias, num_groups, eps))
    y = y.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    out = F.conv2d(y, weight.to(torch.bfloat16).float(), conv_bias.float(),
                   padding=1)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def packed_conv_weight(weight: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) -> (9, O, C) bf16, tap-major (tap = 3 * ky + kx); cached
    on the weight tensor per version."""
    key = (weight._version, weight.dtype, weight.device)
    cached = getattr(weight, "_upgpt_packed", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    o, c = weight.shape[:2]
    with torch.no_grad():
        packed = weight.detach().permute(2, 3, 0, 1).reshape(9, o, c).to(
            torch.bfloat16).contiguous()
    weight._upgpt_packed = (key, packed)
    return packed


def _float32(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous float32 copy of a norm or bias vector on `device`,
    cached on the tensor per version, as the packed weights are: the
    sampling loop passes the same bf16 parameters on every call."""
    if t.dtype == torch.float32 and t.device == device and t.is_contiguous():
        return t
    key = (t._version, t.dtype, device)
    cached = getattr(t, "_upgpt_float32", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        out = t.detach().to(device, torch.float32).contiguous()
    t._upgpt_float32 = (key, out)
    return out


def _launch(x, gn_scale, gn_bias, packed, conv_bias, num_groups, eps):
    if x.dim() != 4:
        raise ValueError(f"fused ResBlock half-step takes NHWC, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused ResBlock half-step takes bf16 or float32, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused ResBlock half-step takes a contiguous NHWC "
                         "tensor")
    n, h, w, c = x.shape
    o = packed.shape[1]
    if c % 8 or c % num_groups:
        raise ValueError(f"fused ResBlock half-step: {c} channels must be a "
                         f"multiple of 8 and of {num_groups} groups")
    if packed.shape != (9, o, c) or packed.device != x.device:
        raise ValueError(f"fused ResBlock half-step: packed weights "
                         f"{tuple(packed.shape)} for {c} channels")
    gn_scale, gn_bias, conv_bias = (_float32(t, x.device)
                                    for t in (gn_scale, gn_bias, conv_bias))
    if gn_scale.shape != (c,) or gn_bias.shape != (c,) or (
            conv_bias.shape != (o,)):
        raise ValueError("fused ResBlock half-step: norm and bias widths")
    chunks = stats_chunks(x.shape, x.element_size(), _sm_count(x.device))
    ws = torch.empty((n, chunks, 2, c), device=x.device, dtype=torch.float32)
    coef = torch.empty((n, 2, c), device=x.device, dtype=torch.float32)
    out = torch.empty((n, h, w, o), device=x.device, dtype=x.dtype)
    plan, plan_ints = gemm_plan.cached_conv_plan((n, h, w, c), o,
                                                 x.element_size())
    # one set of counters: the statistics' images first, then the conv's
    # tiles where its plan splits the chunks
    split = plan.workspace_floats > 0
    counters = gemm_plan.stream_counters(x.device,
                                         n + (plan.tiles if split else 0))
    partials = (torch.empty(plan.workspace_floats, dtype=torch.float32,
                            device=x.device) if split else None)
    _build.launch(
        x.device, "upgpt_fused_resblock", "fused_gn_silu_conv",
        x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(),
        packed.data_ptr(), conv_bias.data_ptr(), out.data_ptr(),
        ws.data_ptr(), coef.data_ptr(), counters.data_ptr(), plan_ints,
        partials.data_ptr() if split else None, plan.workspace_floats,
        counters.data_ptr() + 4 * n if split else None,
        counters.numel() - n if split else 0, n, h, w, c, o,
        num_groups, chunks, eps, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if x.dtype == torch.bfloat16:
        fused_gn_silu_conv.launches += 1
        by_shape = fused_gn_silu_conv.launches_by_shape
        by_shape[(n, h, w, c, o)] = by_shape.get((n, h, w, c, o), 0) + 1
    else:
        fused_gn_silu_conv.fp32_launches += 1
    return out


class _FusedResblock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, weight, conv_bias, packed,
                num_groups, eps):
        inputs = (x, gn_scale, gn_bias, weight, conv_bias)
        if packed is None:
            out = _reference(*inputs, num_groups, eps)
        else:
            out = _launch(x, gn_scale, gn_bias, packed, conv_bias,
                          num_groups, eps)
        ctx.save_for_backward(*inputs)
        ctx.config = (num_groups, eps)
        return out

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_(n)
                      for a, n in zip(ctx.saved_tensors, needs)]
            out = _reference(*inputs, *ctx.config)
            wanted = [a for a, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if n else None for n in needs), None, None,
                None)


def fused_gn_silu_conv(x: torch.Tensor, gn_scale: torch.Tensor,
                       gn_bias: torch.Tensor, weight: torch.Tensor,
                       conv_bias: torch.Tensor, num_groups: int = 32,
                       eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm (float32 statistics) -> SiLU -> SAME 3x3 conv over NHWC.

    `weight` is (O, C, 3, 3) as the port's Conv2d keeps it, `conv_bias`
    (O,). Returns (B, H, W, O) in x's dtype. A CPU tensor takes `_reference`;
    a CUDA tensor launches the kernel, or raises on what it does not take.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_gn_silu_conv: unsupported device {x.device}")
    if weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"fused_gn_silu_conv: weight must be (O, C, 3, 3), "
                         f"got {tuple(weight.shape)}")
    packed = None if x.device.type == "cpu" else packed_conv_weight(weight)
    return _FusedResblock.apply(x, gn_scale, gn_bias, weight, conv_bias,
                                packed, num_groups, eps)


fused_gn_silu_conv.launches = 0  # kernel launches since the last reset
# the same bf16 launches by (B, H, W, C, O); reset by assigning {}
fused_gn_silu_conv.launches_by_shape = {}
# launches of the kernel's float32 instantiation (no path runs float32)
fused_gn_silu_conv.fp32_launches = 0
# level-2 half-steps that the gate sent to the plain path instead
fused_gn_silu_conv.plain_routes = 0
