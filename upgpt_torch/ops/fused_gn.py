"""GroupNorm(+SiLU) over NHWC: two CUDA routes and their twins.

Port of `upgpt_tpu.ops.fused_gn`, whose `fused_group_norm` takes a shape to
one of two Pallas kernels:

- the one-pass kernel `csrc/fused_gn.cu` (K5), which replaces
  `_fused_gn_forward` / `_gn_kernel`: per image and group, float32
  statistics with var = E[x^2] - E[x]^2 (clamped at 0, as the plain
  `group_norm` does), a = rstd * scale, b = shift - mean * a, x * a + b,
  an optional SiLU, and one write in the input dtype. The TPU kernel holds
  one image per grid step; on this card a cluster of K blocks holds it,
  each block a slab of its rows in shared memory, and the blocks add their
  group sums through distributed shared memory (`fused_gn_plan`);
- everything else goes to the row-tiled route `tiled_group_norm` (K6),
  `csrc/gn_stats.cu`, which replaces `_tiled_gn_forward` /
  `_gn_stats_kernel`: one statistics launch gives the (n, 2, c) float32
  [mean_c; rstd_c] (each image finalized by its last block to count
  itself in), then a normalize pass computes a = rstd * scale,
  b = shift - mean * a, x * a + b, an optional SiLU and a cast to x's
  dtype, as the JAX function does in XLA after its kernel.

`fused_group_norm` is an autograd.Function, as the JAX function is a
custom_vjp: the forward takes the route (the twins `_reference_gn` and
`_reference_tiled` for CPU tensors), and the backward recomputes through
the plain GroupNorm under autograd, as `_fused_gn_bwd` does. The JAX
package has no backward kernel here.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from upgpt_torch.ops import _build, gemm_plan
from upgpt_torch.ops.basic import group_norm, silu

# the JAX package's row-tile budget for the statistics kernel's input block
_TILE_BUDGET = 2 * 1024 * 1024
THREADS = 256  # K6's blocks
SMS = 132  # the H100's streaming multiprocessors
# shared memory a block can take on sm_90 (opt-in)
SMEM_LIMIT = 232448
# K5's blocks per image: one where a block keeps the image in registers
# (REG_IMAGE bytes: 512 threads, four 16-byte rows each); else as many as
# one wave of the card holds (one block an SM), at most MAX_CLUSTER
# (non-portable, 16), at least enough to hold the image; 256 threads a
# block for a slab of at most SMALL_SLAB bytes, else 512
# (profile_slice.py --gn-plans)
MAX_CLUSTER = 16
REG_IMAGE = 512 * 4 * 16
SMALL_SLAB = 16 * 1024
# the one-pass gate admits a bf16 image that fits a portable cluster, so
# that a float32 image of the same shape fits MAX_CLUSTER blocks
GATE_CLUSTER = 8
# K6: an image of at most SINGLE_PASSES row passes is one block;
# otherwise chunks of about PASSES_PER_BLOCK passes, at most one block per
# SM, and past WALK_CHUNKS a multiple of it (the last block walks the
# chunks WALK_CHUNKS at a time, csrc/gn_stats.cu:kWalkChunks)
SINGLE_PASSES = 64
PASSES_PER_BLOCK = 12
WALK_CHUNKS = 16


@dataclasses.dataclass(frozen=True)
class GNPlan:
    """K5's launch: `cluster` blocks per image (a power of two) of
    `threads` threads, each staging `rows` rows of the image (the last
    blocks fewer, or none), with `smem` bytes of dynamic shared memory
    (csrc/fused_gn.cu:smem_bytes)."""
    cluster: int
    rows: int
    smem: int
    threads: int


def _pow2_at_least(k: int) -> int:
    return 1 << max(0, (k - 1).bit_length())


def row_lanes(c: int, itemsize: int, threads: int) -> int:
    """Rows a K5 block covers at once, one 16-byte column a thread
    (csrc/fused_gn.cu:row_lanes)."""
    return threads // min(c * itemsize // 16, threads)


def cluster_plan(shape, num_groups: int, itemsize: int, cluster: int):
    """K5's launch with `cluster` blocks per image, or None where a block's
    slab does not fit its shared memory. Each block stages its slab of
    whole rows in x's type beside its row lanes' float32 sums
    ([lanes][2][C]), scale and shift ([2][C]) and the [2][G] group sums
    and statistics."""
    if len(shape) != 4:
        return None
    _, h, w, c = shape
    if (c % num_groups or (c * itemsize) % 16
            or not 1 <= cluster <= MAX_CLUSTER):
        return None
    rows = -(-(h * w) // cluster)
    threads = 256 if rows * c * itemsize <= SMALL_SLAB else 512
    smem = (rows * c * itemsize
            + 4 * ((row_lanes(c, itemsize, threads) + 1) * 2 * c
                   + 4 * num_groups))
    return (GNPlan(cluster, rows, smem, threads) if smem <= SMEM_LIMIT
            else None)


def fused_gn_plan(shape, num_groups: int, itemsize: int,
                  max_cluster: int = MAX_CLUSTER):
    """K5's cluster for an NHWC shape and element size, or None where an
    image does not fit `max_cluster` blocks' shared memory: one block for
    an image of at most REG_IMAGE bytes; else a power of two, the most
    blocks one wave of the card holds (N x K <= SMS, one block an SM) up
    to MAX_CLUSTER and the image's rows, or else the fewest that hold the
    image."""
    if len(shape) != 4:
        return None
    n, h, w, c = shape
    fill = 1
    while (fill * 2 <= min(MAX_CLUSTER, h * w) and n * fill * 2 <= SMS
           and h * w * c * itemsize > REG_IMAGE):
        fill *= 2
    k = _pow2_at_least(min(fill, max_cluster))
    while k <= max_cluster:
        plan = cluster_plan(shape, num_groups, itemsize, k)
        if plan is not None:
            return plan
        k *= 2
    return None


def fused_group_norm_qualifies(shape, num_groups: int) -> bool:
    """Whether the one-pass kernel takes an NHWC tensor of this shape.

    Re-derived for the cluster kernel: one bf16 image fits the shared
    memory of a portable cluster (8 blocks of 227 KB, less each block's
    sums; C a multiple of 8), so that the same shape in float32 fits 16.
    Every U-Net GroupNorm of the 256px nets qualifies at any batch (the
    largest, the 672-channel concat at 32x24, is 1.0 MB an image); the
    256px VAE's decode tensors from 64x48 up do not.
    """
    return fused_gn_plan(shape, num_groups, 2, GATE_CLUSTER) is not None


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


def stats_chunks(shape, itemsize: int, sms: int = SMS) -> int:
    """Row chunks per image of K6's statistics (and its normalize pass).
    An image of at most SINGLE_PASSES passes of a block's rows is one
    block, which finalizes it alone; a larger one is cut into chunks of
    about PASSES_PER_BLOCK passes (each thread eight 16-byte loads in
    flight, and the last block's walk short), at most one block per SM
    over (chunk, column slab, image), and past WALK_CHUNKS a multiple of
    it. Chosen from the chip's sweep (profile_slice.py --gn-plans)."""
    n, h, w, c = shape
    vectors = c * itemsize // 16  # 16-byte loads per NHWC row
    slabs = -(-vectors // THREADS)
    rows_per_pass = THREADS // min(vectors, THREADS)
    passes = -(-(h * w) // rows_per_pass)
    if slabs == 1 and passes <= SINGLE_PASSES:
        return 1
    chunks = max(1, min(-(-passes // PASSES_PER_BLOCK), sms // (n * slabs)))
    if chunks > WALK_CHUNKS:
        chunks -= chunks % WALK_CHUNKS
    return chunks


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    """Contiguous float32 scale and shift on x's device, 16-byte aligned
    (the one-pass kernel copies them 16 bytes at a time)."""
    c = x.shape[-1]
    out = []
    for t in (scale, bias):
        t = t.to(x.device, torch.float32).contiguous()
        if t.shape != (c,):
            raise ValueError(f"GroupNorm: scale and shift must be ({c},)")
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return tuple(out)


def _stats_launch(x, num_groups, eps, scale=None, bias=None):
    """The statistics kernel on a CUDA tensor: (n, 2, c) float32
    [mean_c; rstd_c], as `_reference_gn_stats` computes them, or with
    `scale` and `bias` the affine [a_c; b_c] that the ResBlock half-step's
    launch computes (a = rstd * scale, b = bias - mean * a)."""
    _check(x, num_groups, "GroupNorm statistics")
    n, h, w, c = x.shape
    if c % 8:
        raise ValueError(f"GroupNorm statistics: {c} channels, not a "
                         f"multiple of 8")
    chunks = stats_chunks(x.shape, x.element_size(), _sm_count(x.device))
    ws = torch.empty((n, chunks, 2, c), device=x.device, dtype=torch.float32)
    out = torch.empty((n, 2, c), device=x.device, dtype=torch.float32)
    if scale is not None:
        scale, bias = _affine(x, scale, bias)
    counters = gemm_plan.stream_counters(x.device, n)
    _build.launch(
        x.device, "upgpt_gn_stats", "gn_stats",
        x.data_ptr(), ws.data_ptr(), out.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), counters.data_ptr(), n,
        h * w, c, num_groups, chunks, eps, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
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
    _build.launch(
        x.device, "upgpt_gn_apply", "gn_apply",
        x.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h * w, c,
        stats_chunks(x.shape, x.element_size(), _sm_count(x.device)),
        int(with_silu), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    return out


def _count(fn, shape) -> None:
    fn.launches += 1
    key = tuple(shape)
    fn.launches_by_shape[key] = fn.launches_by_shape.get(key, 0) + 1


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
    _count(tiled_group_norm, x.shape)
    return out


tiled_group_norm.launches = 0  # kernel launches since the last reset
# the same launches by (N, H, W, C); reset by assigning {}
tiled_group_norm.launches_by_shape = {}


def _launch(x, scale, bias, num_groups, eps, with_silu, plan=None):
    """The one-pass kernel on a CUDA tensor, with `fused_gn_plan`'s launch
    or, for profile_slice.py's sweep of cluster sizes, the given one."""
    _check(x, num_groups, "fused GroupNorm")
    n, h, w, c = x.shape
    if plan is None:
        plan = (fused_gn_plan(x.shape, num_groups, x.element_size())
                if fused_group_norm_qualifies(x.shape, num_groups) else None)
    if plan is None:
        raise ValueError(f"fused GroupNorm: {tuple(x.shape)} {x.dtype} is "
                         f"past the one-pass kernel's gate")
    scale, bias = _affine(x, scale, bias)
    out = torch.empty_like(x)
    _build.launch(
        x.device, "upgpt_fused_group_norm", "fused_group_norm",
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n,
        h * w, c, num_groups, plan.cluster, plan.rows, plan.threads, eps,
        int(with_silu),
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _count(fused_group_norm, x.shape)
    fused_group_norm.clusters += n
    return out


def _one_pass(x, num_groups) -> bool:
    """The route: the one-pass kernel where the gate admits the shape and
    an image in x's dtype fits a cluster, the row-tiled one otherwise."""
    return (fused_group_norm_qualifies(x.shape, num_groups)
            and fused_gn_plan(x.shape, num_groups, x.element_size())
            is not None)


class _FusedGN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, with_silu):
        args = (x, scale, bias, num_groups, eps, with_silu)
        if not _one_pass(x, num_groups):
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
# the same launches by (N, H, W, C); reset by assigning {}
fused_group_norm.launches_by_shape = {}
# clusters launched (one per image)
fused_group_norm.clusters = 0
# fused GroupNorms that a model's gate sent to the plain path instead
fused_group_norm.plain_routes = 0
