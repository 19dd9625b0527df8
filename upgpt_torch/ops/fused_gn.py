"""GroupNorm(+SiLU) over NHWC: two CUDA routes and their twins.

Port of `upgpt_tpu.ops.fused_gn`, whose `fused_group_norm` takes a shape to
one of two Pallas kernels:

- the one-pass kernel `csrc/fused_gn.cu` (K5), which replaces
  `_fused_gn_forward` / `_gn_kernel`: per image and group, float32
  statistics with var = E[x^2] - E[x]^2 (clamped at 0, as the plain
  `group_norm` does), scale and shift, an optional SiLU, and one write in
  the input dtype. On this card one block per (image, group) stages the
  group's values in shared memory, so its gate
  (`fused_group_norm_qualifies`) is about one group's slice, not one
  image's as on the TPU;
- everything else goes to the row-tiled route `tiled_group_norm` (K6),
  `csrc/gn_stats.cu`, which replaces `_tiled_gn_forward` /
  `_gn_stats_kernel`: a split reduction gives the (n, 2, c) float32
  [mean_c; rstd_c] statistics, then a normalize pass computes
  a = rstd * scale, b = shift - mean * a, x * a + b, an optional SiLU and a
  cast to x's dtype, as the JAX function does in XLA after its kernel.

`fused_group_norm` is an autograd.Function, as the JAX function is a
custom_vjp: the forward takes the route (the twins `_reference_gn` and
`_reference_tiled` for CPU tensors), and the backward recomputes through
the plain GroupNorm under autograd, as `_fused_gn_bwd` does. The JAX
package has no backward kernel here.
"""

from __future__ import annotations

import torch

from upgpt_torch.ops import _build
from upgpt_torch.ops.basic import group_norm, silu

# one group's float32 slice in shared memory: two blocks fit an SM's 227 KB
_SMEM_BUDGET = 112 * 1024
# the JAX package's row-tile budget for the statistics kernel's input block
_TILE_BUDGET = 2 * 1024 * 1024


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


def _stats_tile(hw: int, c: int, itemsize: int) -> int:
    """Largest row-tile divisor of hw with a <= 2 MB input block (the JAX
    package's `_stats_tile`, kept for its dispatch rule)."""
    if hw * c * itemsize <= _TILE_BUDGET:
        return hw
    for tiles in range(2, hw + 1):
        if hw % tiles == 0 and (hw // tiles) * c * itemsize <= _TILE_BUDGET:
            return hw // tiles
    return 0


def tiled_group_norm_qualifies(shape, num_groups: int) -> bool:
    """The JAX package's gate of the row-tiled route, unchanged: NHWC,
    channels a multiple of the groups, and a row tile of bf16 that fits
    2 MB (every decode-size VAE tensor)."""
    if len(shape) != 4:
        return False
    _, h, w, c = shape
    return (c % num_groups == 0 and c >= num_groups
            and _stats_tile(h * w, c, 2) != 0)


def _reference_gn(x, scale, bias, num_groups, eps, with_silu):
    out = group_norm(x, scale, bias, num_groups=num_groups, eps=eps)
    return silu(out) if with_silu else out


def _reference_gn_stats(x, num_groups, eps):
    """Plain version of the statistics kernel: (n, 2, c) float32
    [mean_c; rstd_c], each channel carrying its group's value; per-channel
    sums first, then groups, var clamped at 0 (fused_gn.py:103-116)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, c)
    cnt = xf.shape[1] * (c // num_groups)
    s1 = xf.sum(dim=1).reshape(n, num_groups, -1).sum(dim=-1) / cnt
    s2 = xf.square().sum(dim=1).reshape(n, num_groups, -1).sum(dim=-1) / cnt
    rstd = torch.rsqrt(torch.clamp(s2 - s1.square(), min=0.0) + eps)
    per_channel = lambda g: g.repeat_interleave(c // num_groups, dim=1)
    return torch.stack([per_channel(s1), per_channel(rstd)], dim=1)


def _reference_gn_apply(x, stats, scale, bias, with_silu):
    """Plain version of the normalize pass, as fused_gn.py:148-157 writes it:
    a = rstd * scale, b = shift - mean * a, x * a + b in float32, optional
    SiLU, cast to x's dtype."""
    view = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    a = stats[:, 1].reshape(view) * scale.float()
    b = bias.float() - stats[:, 0].reshape(view) * a
    out = x.float() * a + b
    if with_silu:
        out = silu(out)
    return out.to(x.dtype)


def _reference_tiled(x, scale, bias, num_groups, eps, with_silu):
    return _reference_gn_apply(x, _reference_gn_stats(x, num_groups, eps),
                               scale, bias, with_silu)


def _check(x, num_groups, what):
    if x.dim() != 4:
        raise ValueError(f"{what} takes NHWC, got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous NHWC tensor")
    if x.shape[-1] % num_groups:
        raise ValueError(f"{what}: {x.shape[-1]} channels in {num_groups} "
                         f"groups")


def _affine(x, scale, bias):
    c = x.shape[-1]
    scale = scale.to(x.device, torch.float32).contiguous()
    bias = bias.to(x.device, torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"GroupNorm: scale and shift must be ({c},)")
    return scale, bias


def stats_chunks(x: torch.Tensor) -> int:
    """Row chunks per image of the split statistics reduction: about four
    blocks per SM over (chunk, column slab, image), and each block at least
    four passes of its rows."""
    n, h, w, c = x.shape
    vectors = c * x.element_size() // 16  # 16-byte loads per NHWC row
    slabs = -(-vectors // 256)
    rows_per_pass = 256 // min(vectors, 256)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    per_image = -(-4 * sms // (n * slabs))
    return max(1, min(-(-(h * w) // (4 * rows_per_pass)), per_image))


def _stats_launch(x, num_groups, eps):
    """The statistics kernels on a CUDA tensor: (n, 2, c) float32
    [mean_c; rstd_c], as `_reference_gn_stats` computes them."""
    _check(x, num_groups, "GroupNorm statistics")
    n, h, w, c = x.shape
    if c % 8:
        raise ValueError(f"GroupNorm statistics: {c} channels, not a "
                         f"multiple of 8")
    chunks = stats_chunks(x)
    ws = torch.empty((n, chunks, 2, c), device=x.device, dtype=torch.float32)
    out = torch.empty((n, 2, c), device=x.device, dtype=torch.float32)
    code = _build.library().upgpt_gn_stats(
        x.data_ptr(), ws.data_ptr(), out.data_ptr(), n, h * w, c, num_groups,
        chunks, eps, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "gn_stats")
    return out


def _apply_launch(x, stats, scale, bias, with_silu):
    """The normalize pass on a CUDA tensor, as `_reference_gn_apply`."""
    n, h, w, c = x.shape
    if stats.shape != (n, 2, c) or stats.dtype != torch.float32 or (
            not stats.is_contiguous()):
        raise ValueError(f"GroupNorm apply: statistics must be contiguous "
                         f"float32 ({n}, 2, {c})")
    scale, bias = _affine(x, scale, bias)
    out = torch.empty_like(x)
    code = _build.library().upgpt_gn_apply(
        x.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h * w, c, int(with_silu),
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "gn_apply")
    return out


def tiled_group_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, num_groups: int = 32,
                     eps: float = 1e-5, with_silu: bool = False
                     ) -> torch.Tensor:
    """The row-tiled GroupNorm(+SiLU) route, forward only: the twin on a
    CPU tensor, statistics and normalize kernels on a CUDA tensor."""
    if x.device.type == "cpu":
        return _reference_tiled(x, scale, bias, num_groups, eps, with_silu)
    out = _apply_launch(x, _stats_launch(x, num_groups, eps), scale, bias,
                        with_silu)
    tiled_group_norm.launches += 1
    return out


tiled_group_norm.launches = 0  # kernel launches since the last reset


def _launch(x, scale, bias, num_groups, eps, with_silu):
    _check(x, num_groups, "fused GroupNorm")
    n, h, w, c = x.shape
    if not fused_group_norm_qualifies(x.shape, num_groups):
        raise ValueError(f"fused GroupNorm: {tuple(x.shape)} is past the "
                         f"one-pass kernel's gate")
    scale, bias = _affine(x, scale, bias)
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
        args = (x, scale, bias, num_groups, eps, with_silu)
        if not fused_group_norm_qualifies(x.shape, num_groups):
            out = tiled_group_norm(*args)
        elif x.device.type == "cpu":
            out = _reference_gn(*args)
        else:
            out = _launch(*args)
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

    Shapes that `fused_group_norm_qualifies` admits take the one-pass route
    (counted in `fused_group_norm.launches`), every other the row-tiled one
    (`tiled_group_norm.launches`). A CPU tensor takes the route's twin; a
    CUDA tensor launches its kernels, or raises on what they do not take.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    return _FusedGN.apply(x, scale, bias, num_groups, eps, with_silu)


fused_group_norm.launches = 0  # kernel launches since the last reset
# fused GroupNorms that a model's gate sent to the plain path instead
fused_group_norm.plain_routes = 0
