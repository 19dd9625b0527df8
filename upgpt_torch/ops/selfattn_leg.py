"""The self-attention leg of the SpatialTransformer block: two CUDA kernels
and their twins.

Port of the two Pallas kernels of `benchmarks/micro_block.py`, the A/B that
chose K1's full-width layout on the TPU. Both compute

    x -> Q, K, V -> per-head softmax(Q K^T / sqrt(dh)) V -> to_out + bias

over (B, T, C) tokens, with weights in the JAX package's (in, out) layout:

- `selfattn_fullwidth` (K8, replaces `fw_kernel`) takes the (C, C) weights
  `wq`, `wk`, `wv`, `wo` and slices heads out of the packed activations;
- `selfattn_perhead` (K9, replaces `ph_kernel`) takes them pre-split,
  (H, C, dh) for Q/K/V and (H, dh, C) for `to_out`, and sums `to_out`
  over heads in float32, in head order, starting from the bias.

The twins round exactly where the TPU kernels do: the Q/K/V products
accumulate in float32 and are cast to x's dtype; the softmax runs in
float32 with the 1/sqrt(dh) scale; p is normalised before the value product
and cast; each head's o is cast; the full-width `to_out` is one float32
product of the concatenated heads plus the float32 bias, the per-head one
`bo + sum_h o_h @ wo[h]`.

The kernels are `csrc/selfattn_leg.cu`: three launches from one C call
each, counted once per call in `.launches`. The Q/K/V product and `to_out`
run on the wgmma pieces of `csrc/gemm_sm90.cuh` with plans from
`gemm_plan.plan_leg_product`; between them a flash pass for small heads
(`flash_keys`, `FLASH_STAGES`) reads Q, K and V from a workspace the first
launch writes head-major with each head padded to `padded_head(dh)` lanes
of zeros, and writes o the same way (`workspace_elements`). A CPU tensor takes the
twin; a CUDA tensor launches the kernels or raises. The kernels take
dh <= 128 and C % 8 == 0 (TMA reads x's rows in 16-byte multiples). The
flash pass normalises o after the value product, where the twins
normalise p before it, so kernel and twin round differently within a few
bf16 steps.
"""

from __future__ import annotations

import functools
import math
from typing import Mapping, Tuple

import numpy as np
import torch

from upgpt_torch.ops import _build, gemm_plan

HEAD_PADS = (32, 64, 128)  # the flash pass's head widths
FLASH_BQ = 128             # query rows of a flash tile: 64 a warpgroup
FLASH_STAGES = 4           # K/V tiles in flight


def _split_heads_kernel(w: torch.Tensor, heads: int) -> torch.Tensor:
    """(C_in, H*Dh) -> (H, C_in, Dh): one head's columns per slice."""
    cin, inner = w.shape
    return w.reshape(cin, heads, inner // heads).permute(1, 0, 2).contiguous()


def _split_heads_out(w: torch.Tensor, heads: int) -> torch.Tensor:
    """(H*Dh, C) -> (H, Dh, C)."""
    inner, c = w.shape
    return w.reshape(heads, inner // heads, c).contiguous()


def selfattn_weights(attn1: Mapping, heads: int, dtype=torch.bfloat16,
                     device="cuda") -> Tuple[tuple, tuple]:
    """A JAX `CrossAttention`'s leaves (`to_q`/`to_k`/`to_v`/`to_out`, each
    {"kernel": (in, out)[, "bias"]}, numpy or anything `np.asarray` takes)
    in both layouts: (wq, wk, wv, wo, bo) full-width and (wq_h, wk_h, wv_h,
    wo_h, bo) per head, the latter through the split helpers, on `device`
    (the card unless the caller names another). `bo` is float32 (1, C), as
    the TPU kernels take it."""
    def leaf(name, key="kernel"):
        return torch.from_numpy(np.array(attn1[name][key], np.float32)).to(
            device)

    wq, wk, wv, wo = (leaf(n).to(dtype)
                      for n in ("to_q", "to_k", "to_v", "to_out"))
    bo = leaf("to_out", "bias").reshape(1, -1)
    per_head = (_split_heads_kernel(wq, heads), _split_heads_kernel(wk, heads),
                _split_heads_kernel(wv, heads), _split_heads_out(wo, heads),
                bo)
    return (wq, wk, wv, wo, bo), per_head


# ---------------------------------------------------------------- twins


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            comp) -> torch.Tensor:
    """(B, H, T, dh) heads: float32 scores and softmax, p normalised and
    cast before the value product, o cast."""
    s = (q.float() @ k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(q.shape[-1]))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(comp)
    return (p.float() @ v.float()).to(comp)


def selfattn_fullwidth_reference(x, wq, wk, wv, wo, bo,
                                 heads: int) -> torch.Tensor:
    """Plain PyTorch `fw_kernel`: (B, T, C) -> (B, T, C) in x's dtype."""
    comp = x.dtype
    b, t, c = x.shape
    xf = x.float()

    def heads_of(w):
        z = (xf @ w.float()).to(comp)
        return z.reshape(b, t, heads, c // heads).transpose(1, 2)

    o = _attend(heads_of(wq), heads_of(wk), heads_of(wv), comp)
    o = o.transpose(1, 2).reshape(b, t, c)
    return (o.float() @ wo.float() + bo.float().reshape(1, c)).to(comp)


def selfattn_perhead_reference(x, wq_h, wk_h, wv_h, wo_h,
                               bo) -> torch.Tensor:
    """Plain PyTorch `ph_kernel`: per-head products from the split weights,
    `to_out` summed in float32 in head order, starting from the bias."""
    comp = x.dtype
    xf = x.float()

    def proj(w):
        return torch.einsum("btc,hcd->bhtd", xf, w.float()).to(comp)

    o = _attend(proj(wq_h), proj(wk_h), proj(wv_h), comp)
    acc = bo.float().reshape(1, 1, -1)
    for h in range(wq_h.shape[0]):
        acc = acc + o[:, h].float() @ wo_h[h].float()
    return acc.to(comp)


# ---------------------------------------------------------------- kernels


def padded_head(dh: int) -> int:
    """The head width the kernels work in: dh rounded up to 32, 64 or 128
    lanes, the pad lanes zeros. The TPU kernels hold a whole image and a
    head's (T, T) scores in VMEM; the flash pass here takes heads of at
    most 128 lanes."""
    if dh < 1 or dh > HEAD_PADS[-1]:
        raise ValueError(f"head width {dh}: the self-attention leg's kernels "
                         f"take 1 <= dh <= {HEAD_PADS[-1]}")
    return next(p for p in HEAD_PADS if dh <= p)


def workspace_elements(b: int, t: int, c: int, heads: int) -> Tuple[int, int]:
    """bf16 elements of the two workspaces a call allocates: Q, K and V as
    (3, B, H, T, Dp), and o as (B, H, T, Dp)."""
    o = b * heads * t * padded_head(c // heads)
    return 3 * o, o


def flash_keys(dp: int) -> int:
    """Keys of a K/V tile: 128, or 64 for 128-lane heads, whose S, P, O and
    Q fragments then fit the consumer's 232 registers."""
    return 64 if dp == 128 else 128


def flash_smem(dp: int, stages: int = FLASH_STAGES) -> int:
    """Bytes of the flash pass's dynamic shared memory past the alignment
    slack: the 128-row Q tile and `stages` K/V tiles."""
    return FLASH_BQ * dp * 2 + stages * 2 * flash_keys(dp) * dp * 2


def flash_tiles(b: int, t: int, heads: int) -> int:
    """(b, h, 128-query) tiles the persistent blocks walk."""
    return b * heads * -(-t // FLASH_BQ)


@functools.lru_cache(maxsize=64)
def leg_plans(b: int, t: int, c: int, heads: int, sms: int = gemm_plan.SMS):
    """(Q/K/V plan, to_out plan) of `gemm_plan.plan_leg_product`."""
    dp = padded_head(c // heads)
    return (gemm_plan.plan_leg_product(b, t, c, c, 3, sms=sms),
            gemm_plan.plan_leg_product(b, t, c, heads * dp, 1,
                                       per_image=True, sms=sms))


def leg_plan_ints(b: int, t: int, c: int, heads: int,
                  sms: int = gemm_plan.SMS) -> Tuple[int, ...]:
    """The C entry points' eleven plan ints: each product's (wg, bn,
    stages, grid), then the flash pass's keys per tile, stages and grid
    (one persistent block an SM, at most one a tile)."""
    qkv, out = leg_plans(b, t, c, heads, sms)
    dp = padded_head(c // heads)
    return (*qkv.as_ints(), *out.as_ints(), flash_keys(dp), FLASH_STAGES,
            min(flash_tiles(b, t, heads), sms))


def _check(name: str, x: torch.Tensor, args) -> None:
    """`args` are (tensor, shape, dtype) triples the kernel takes."""
    for i, (a, shape, dtype) in enumerate(args):
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name} argument {i}: shape {tuple(a.shape)}, "
                             f"expected {tuple(shape)}")
        if a.dtype != dtype:
            raise TypeError(f"{name} argument {i}: {a.dtype}, the kernel "
                            f"takes {dtype}")
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"{name} argument {i} must be a contiguous "
                             f"tensor on {x.device}")


def _geometry(name: str, x: torch.Tensor, heads: int):
    if x.dim() != 3:
        raise ValueError(f"{name} takes (B, T, C) tokens, got {tuple(x.shape)}")
    b, t, c = x.shape
    if heads < 1 or c % heads:
        raise ValueError(f"{name}: C={c} does not split into {heads} heads")
    if c % 8:
        raise ValueError(f"{name}: C={c} is not a multiple of 8 (TMA reads "
                         f"x's rows in 16-byte multiples)")
    padded_head(c // heads)  # raises past 128 lanes
    leg_plans(b, t, c, heads)  # raises where no tile of B fits
    return b, t, c, c // heads


@functools.lru_cache(maxsize=64)
def _plan_array(b: int, t: int, c: int, heads: int, sms: int):
    return gemm_plan.int_array(leg_plan_ints(b, t, c, heads, sms))


@functools.lru_cache(maxsize=8)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _workspaces(b: int, t: int, c: int, heads: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Q/K/V and o workspaces of one call, uninitialised: the kernels
    write every element, pad lanes included."""
    return tuple(torch.empty(n, dtype=torch.bfloat16, device=device)
                 for n in workspace_elements(b, t, c, heads))


def _launch(entry: str, fn, x, weights, bo, heads: int) -> torch.Tensor:
    """Both kernels' C call: workspaces for Q/K/V and o, then one call that
    launches the leg's three kernels on the current stream."""
    b, t, c, _ = _geometry(fn.__name__, x, heads)
    bias = bo.reshape(-1)
    _check(fn.__name__, x, [(x, (b, t, c), torch.bfloat16)]
           + [(w, s, torch.bfloat16) for w, s in weights]
           + [(bias, (c,), torch.float32)])
    qkv, o = _workspaces(b, t, c, heads, x.device)
    out = torch.empty_like(x)
    _build.launch(
        x.device, entry, fn.__name__,
        x.data_ptr(), *(w.data_ptr() for w, _ in weights), bias.data_ptr(),
        qkv.data_ptr(), o.data_ptr(), out.data_ptr(),
        _plan_array(b, t, c, heads, _sms(x.device)), b, t, c, heads,
        torch.cuda.current_stream(x.device).cuda_stream)
    fn.launches += 1
    return out


def _device(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def selfattn_fullwidth(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                       wv: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """K8: (B, T, C) bf16 tokens, (C, C) bf16 weights in (in, out) layout,
    a float32 (C,) or (1, C) bias -> (B, T, C)."""
    if _device("selfattn_fullwidth", x) == "cpu":
        return selfattn_fullwidth_reference(x, wq, wk, wv, wo, bo, heads)
    c = x.shape[-1]
    return _launch("upgpt_selfattn_fullwidth", selfattn_fullwidth, x,
                   [(w, (c, c)) for w in (wq, wk, wv, wo)], bo, heads)


def selfattn_perhead(x: torch.Tensor, wq_h: torch.Tensor, wk_h: torch.Tensor,
                     wv_h: torch.Tensor, wo_h: torch.Tensor,
                     bo: torch.Tensor) -> torch.Tensor:
    """K9: (B, T, C) bf16 tokens, (H, C, dh) Q/K/V and (H, dh, C) `to_out`
    bf16 weights as given, a float32 bias -> (B, T, C)."""
    if _device("selfattn_perhead", x) == "cpu":
        return selfattn_perhead_reference(x, wq_h, wk_h, wv_h, wo_h, bo)
    heads, c = wq_h.shape[0], x.shape[-1]
    dh = c // heads
    return _launch("upgpt_selfattn_perhead", selfattn_perhead, x,
                   [(w, (heads, c, dh)) for w in (wq_h, wk_h, wv_h)]
                   + [(wo_h, (heads, dh, c))], bo, heads)


selfattn_fullwidth.launches = 0  # C calls since the last reset
selfattn_perhead.launches = 0
