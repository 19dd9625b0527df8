"""Tile, split and pipeline-depth plans for the products of the Hopper
mainloop in `csrc/gemm_sm90.cuh`.

Two kernels run on that mainloop: the SpatialTransformer block's eight (nine
with a context) matrix products (`csrc/fused_transformer.cu`, K1) and the
ResBlock half-step's implicit 3x3 conv (`csrc/fused_resblock.cu`, K7). The
self-attention leg's two products (`csrc/selfattn_leg.cu`, K8/K9) use its
pieces in persistent blocks with B resident, planned by `plan_leg_product`
at the end of this module. For each K1 and K7 product a pure function here
picks

- the tile: BM rows (64 per consumer warpgroup, 1 to 3 warpgroups) by BN
  columns (one of `BN_MENU`, at most 256, the widest wgmma; K7 takes 64 or
  128);
- a split of K into contiguous ranges of 64-deep steps (K1's kernel takes
  one; its rule below picks none) or of 64-channel chunks (K7). The partial
  sums go to a float32 workspace and the block that
  arrives last sums them in split order, so the result does not depend on
  which block finishes first;
- the number of stages of the shared-memory ring that feeds the weights by
  TMA (3 or 4 here; the kernels take up to 6).

The rules differ because the two kernels respond differently to the plan
(measured by `python3 profile_slice.py --plans` on an NVIDIA H100 80GB
HBM3 at 700 W). Among the plans that fit 227 KB of shared memory and the
register file:

- K1 takes no split, and of the unsplit plans the one whose busiest SM
  does least: waves of 132 units, each wave a unit's BM x BN x K
  multiply-adds plus a fixed cost for filling the pipeline, the prologue
  and the epilogue (`WAVE_OVERHEAD_MACS`). On the sweep no split plan of
  K1's was the fastest, and over all plans the whole block moved by at
  most about 12%.
- K7 takes the plan that a cost model fitted to the sweep puts cheapest
  (below). Its plan moves the conv up to ~3x, and its fastest plan often
  has fewer units than the 132 SMs: a fuller grid costs smaller tiles or
  more splits, which cost more than the idle SMs.

The C entry points take the plan as ints and check it again; the CPU
tests hold the coverage and limits of every plan the three paths use.

The byte counts here mirror the kernels' shared-memory layout exactly
(`product_smem` and `conv_smem` in the .cu files); change both together.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

SMS = 132                # H100 SXM streaming multiprocessors
SMEM_LIMIT = 232448      # bytes of shared memory one block may use
STATIC_SMEM = 1024       # allowance for each kernel's static shared memory
ALIGN_SLACK = 1024       # the ring is aligned to 1024 bytes (128B swizzle)
BK = 64                  # bf16 elements per K step: one 128-byte TMA row
BN_MENU = (64, 128, 224, 256)
BM_MENU = (64, 128, 192)
MIN_STAGES, MAX_STAGES = 3, 6  # what the kernels take
PLAN_STAGES = 4  # what the plans use: more stages cost blocks per SM

_SM_SMEM = 233472        # shared memory of one SM
_SM_REGS = 65536

# K7's cost model: a plan's time on the card as a weighted sum of the terms
# `conv_terms` computes from it (ns per unit of each term), with
# non-negative least-squares weights fitted to the device times of all 250
# candidate plans at the chain's nine (shape, O) on an NVIDIA H100 80GB
# HBM3 (700 W), as `python3 profile_slice.py --plans` prints them. With
# these weights the chosen plan was the fastest candidate at each of the
# nine.
TERMS = ("launch", "waves x K steps", "waves x prologue/thread",
         "waves x epilogue/thread", "waves x split sum/thread", "L2 MB",
         "MFLOP per SM")
CONV_WEIGHTS = (11647.109, 943.016, 32.425, 0.0, 10.332, 0.0, 194.361)


def max_warpgroups(bn: int, nb: int = 1) -> int:
    """Consumer warpgroups a block may hold: each thread keeps nb * bn / 2
    float32 accumulators, and 3 consumer warpgroups and the producer
    warpgroup fit the 64K-register file only up to 64 of them."""
    return 3 if nb * bn // 2 <= 64 else 2


def _stages(fixed: int, stage: int, staging: int) -> int:
    """The deepest ring (MIN_STAGES..PLAN_STAGES) that fits, else 0."""
    for s in range(PLAN_STAGES, MIN_STAGES - 1, -1):
        if _fits(max(fixed + s * stage, staging)):
            return s
    return 0


def _fits(main: int) -> bool:
    return ALIGN_SLACK + main + STATIC_SMEM <= SMEM_LIMIT


# ------------------------------------------------------------------ K1


@dataclass(frozen=True)
class ProductPlan:
    """One product C[M, N] = A[M, K] W[N, K]^T, W in `parts` pieces of N /
    parts rows; with `gated` the block also multiplies the gate rows of W
    (GEGLU) into a second accumulator. `prologue` products (a GroupNorm or
    LayerNorm of A) hold their whole BM x K panel in shared memory and take
    no split."""
    M: int
    N: int
    K: int
    parts: int
    prologue: bool
    gated: bool
    wg: int          # consumer warpgroups: BM = 64 * wg
    bn: int
    splits: int
    steps_per_split: int
    stages: int

    @property
    def bm(self) -> int:
        return 64 * self.wg

    @property
    def nb(self) -> int:
        return 2 if self.gated else 1

    @property
    def ksteps(self) -> int:
        return -(-self.K // BK)

    @property
    def n_tiles(self) -> int:   # per piece
        return -(-(self.N // self.parts) // self.bn)

    @property
    def m_tiles(self) -> int:
        return -(-self.M // self.bm)

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.parts * self.n_tiles

    @property
    def units(self) -> int:
        return self.tiles * self.splits

    @property
    def smem(self) -> int:
        return ALIGN_SLACK + product_smem(self.bm, self.bn, self.nb, self.K,
                                          self.prologue, self.stages)

    @property
    def workspace_floats(self) -> int:
        """float32 partial sums of a split product (0 without a split)."""
        if self.splits == 1:
            return 0
        return self.tiles * self.splits * self.bm * self.bn * self.nb

    def as_ints(self) -> Tuple[int, int, int, int, int]:
        return (self.wg, self.bn, self.splits, self.steps_per_split,
                self.stages)

    def k_ranges(self) -> List[Tuple[int, int]]:
        """[start, end) of K, in elements, of each split, in split order."""
        per = self.steps_per_split * BK
        return [(s * per, min((s + 1) * per, self.K))
                for s in range(self.splits)]

    def tile_boxes(self) -> List[Tuple[int, int, int, int]]:
        """(m0, m1, n0, n1) of every output tile, N in output columns."""
        pn = self.N // self.parts
        out = []
        for mt in range(self.m_tiles):
            for p in range(self.parts):
                for nt in range(self.n_tiles):
                    n0 = p * pn + nt * self.bn
                    out.append((mt * self.bm, min((mt + 1) * self.bm, self.M),
                                n0, min(n0 + self.bn, (p + 1) * pn)))
        return out


def product_smem(bm: int, bn: int, nb: int, k: int, prologue: bool,
                 stages: int) -> int:
    """Bytes of the product kernel's dynamic shared memory past the
    alignment slack: the ring (B boxes, and the streamed A box), the
    normalised A panel with its float32 scale and shift, and the bf16
    epilogue staging tile, which reuses the ring's memory."""
    stage = nb * bn * 128 + (0 if prologue else bm * 128)
    panel = bm * (k + 8) * 2 + 2 * k * 4 if prologue else 0
    staging = bm * (bn + 8) * 2
    return max(panel + stages * stage, staging)


# A wave's fixed cost in multiply-adds: 2^22 is ~1.1 us of one SM's share
# of the bf16 peak (989 TFLOP/s over 132 SMs). Without it the rule took
# 64-wide tiles by the thousand for GEGLU, 11% slower for the whole block
# at ds1; with it, the rule's plan was the sweep's fastest, or within 1.2%
# of the block's time, at every product of the sampling and chain shapes
# but the upscale net's QKV (3%) (`profile_slice.py --plans`, NVIDIA H100
# 80GB HBM3, 700 W).
WAVE_OVERHEAD_MACS = 2 ** 22


def product_critical_path(p: ProductPlan) -> int:
    """The busiest SM's work in multiply-adds: waves of 132 units, each
    a unit's BM x BN (x2 gated) x K and the wave's fixed cost."""
    return -(-p.units // SMS) * (p.bm * p.bn * p.nb * p.steps_per_split * BK
                                 + WAVE_OVERHEAD_MACS)


def plan_product(M: int, N: int, K: int, parts: int = 1,
                 prologue: bool = False, gated: bool = False) -> ProductPlan:
    """The plan of one K1 product (see the module docstring): unsplit, the
    least critical path, then the fewest units, then the deepest ring."""
    return min((p for p in product_candidates(M, N, K, parts, prologue,
                                               gated) if p.splits == 1),
               key=lambda p: (product_critical_path(p), p.units, -p.stages))


def product_candidates(M: int, N: int, K: int, parts: int = 1,
                       prologue: bool = False,
                       gated: bool = False) -> List[ProductPlan]:
    """Every plan of a K1 product that the kernel takes and the card fits."""
    if N % parts or K % 16 or M <= 0:
        raise ValueError(f"product ({M}, {N}, {K}) in {parts} pieces")
    nb = 2 if gated else 1
    ksteps = -(-K // BK)
    cands = []
    for bn in BN_MENU:
        if nb * bn > 256:
            continue
        for wg in range(1, max_warpgroups(bn, nb) + 1):
            bm = 64 * wg
            if 64 * (wg - 1) >= M and wg > 1:
                continue  # a warpgroup with no row at all
            splits_opts = [1] if prologue else range(1, ksteps + 1)
            for s in splits_opts:
                per = -(-ksteps // s)
                if -(-ksteps // per) != s:
                    continue  # an empty split
                stage = nb * bn * 128 + (0 if prologue else bm * 128)
                fixed = bm * (K + 8) * 2 + 2 * K * 4 if prologue else 0
                st = _stages(fixed, stage, bm * (bn + 8) * 2)
                if not st:
                    continue
                cands.append(ProductPlan(M, N, K, parts, prologue, gated, wg,
                                         bn, s, per, st))
    if not cands:
        raise ValueError(f"no plan fits product ({M}, {N}, {K})")
    return cands


# the order of the products in the C entry point's plan array
PRODUCTS = ("context_kv", "proj_in", "qkv", "to_out1", "q2", "to_out2",
            "ff1", "ff2", "proj_out")


def transformer_plans(b: int, t: int, c: int, tk: int,
                      ctx_dim: Optional[int] = None) -> List[Optional[ProductPlan]]:
    """K1's products in `PRODUCTS` order; the context's K/V projection is
    None when the caller passes K/V precomputed."""
    m = b * t
    sq = lambda pro=False: plan_product(m, c, c, 1, pro)  # noqa: E731
    return [
        None if ctx_dim is None else plan_product(b * tk, 2 * c, ctx_dim, 2),
        sq(True),                                   # proj_in (GroupNorm)
        plan_product(m, 3 * c, c, 3, True),         # packed QKV (LN1)
        sq(),                                       # attn1 to_out + h
        sq(True),                                   # cross q (LN2)
        sq(),                                       # attn2 to_out + h2
        plan_product(m, 4 * c, c, 1, True, True),   # GEGLU (LN3)
        plan_product(m, c, 4 * c),                  # FF out + h
        sq(),                                       # proj_out + x
    ]


def plan_array(plans) -> List[int]:
    """Five ints per product for the C entry point; zeros where absent."""
    out = []
    for p in plans:
        out.extend((0,) * 5 if p is None else p.as_ints())
    return out


def product_workspace(plans) -> Tuple[int, int]:
    """(float32 partial sums, int tile counters) the products need; the
    products run one after another on one stream, so they share both."""
    live = [p for p in plans if p is not None]
    return (max(p.workspace_floats for p in live),
            max(p.tiles if p.splits > 1 else 0 for p in live))


# ------------------------------------------------------- K8/K9 products


@dataclass(frozen=True)
class LegProductPlan:
    """One product of the self-attention leg (`csrc/selfattn_leg.cu`):
    Q/K/V, (B T, C) x (C, 3C) in three pieces of N = C with K = C, whose
    M tiles run over the B T token rows; or to_out, whose K loop runs over
    the H heads' segments of `dp` padded lanes (K = H dp) and whose M tiles
    run over each image's T rows (`per_image`). The blocks are persistent:
    each owns one N tile of one piece (a "unit"), holds that tile of B for
    the whole K in shared memory (64-wide chunks of N, 64 K rows of 128
    bytes each) and walks every `grid / units`-th M tile of BM = 64 wg
    rows, A streaming through a ring. No split."""
    b: int
    t: int
    N: int       # per piece
    K: int
    parts: int
    per_image: bool
    wg: int
    bn: int
    stages: int
    sms: int = SMS

    @property
    def bm(self) -> int:
        return 64 * self.wg

    @property
    def ksteps(self) -> int:
        return -(-self.K // BK)

    @property
    def n_tiles(self) -> int:   # per piece
        return -(-self.N // self.bn)

    @property
    def m_tiles(self) -> int:
        if self.per_image:
            return self.b * -(-self.t // self.bm)
        return -(-(self.b * self.t) // self.bm)

    @property
    def units(self) -> int:
        return self.parts * self.n_tiles

    @property
    def blocks_per_unit(self) -> int:
        return max(1, min(self.m_tiles, self.sms // self.units))

    @property
    def grid(self) -> int:
        return self.units * self.blocks_per_unit

    @property
    def smem(self) -> int:
        return ALIGN_SLACK + leg_product_smem(self.wg, self.bn, self.ksteps,
                                              self.stages)

    def as_ints(self) -> Tuple[int, int, int, int]:
        return (self.wg, self.bn, self.stages, self.grid)

    def m_rows(self) -> List[Tuple[int, int]]:
        """[m0, m1) rows of the (B T) token matrix of each M tile."""
        if self.per_image:
            return [(i * self.t + t0, i * self.t + min(t0 + self.bm, self.t))
                    for i in range(self.b)
                    for t0 in range(0, self.t, self.bm)]
        m = self.b * self.t
        return [(m0, min(m0 + self.bm, m)) for m0 in range(0, m, self.bm)]

    def block_tiles(self, block: int) -> List[Tuple[int, int, int, int]]:
        """(m0, m1, n0, n1) of the output tiles block `block` computes, in
        order: columns of the (parts N)-wide output."""
        unit = block % self.units
        p, nt = divmod(unit, self.n_tiles)
        n0 = p * self.N + nt * self.bn
        n1 = p * self.N + min((nt + 1) * self.bn, self.N)
        rows = self.m_rows()
        return [(*rows[mt], n0, n1) for mt in
                range(block // self.units, self.m_tiles,
                      self.blocks_per_unit)]

    def tile_boxes(self) -> List[Tuple[int, int, int, int]]:
        """Every block's tiles, block by block."""
        return [box for blk in range(self.grid)
                for box in self.block_tiles(blk)]


def leg_product_smem(wg: int, bn: int, ksteps: int, stages: int) -> int:
    """Bytes past the alignment slack: B resident (every K step's 64-wide
    chunks of 8 KB), the ring of `stages` A boxes (64 wg rows of 128
    bytes), the bf16 epilogue staging tile and the float32 bias of the
    block's columns."""
    return (ksteps * -(-bn // 64) * 8192 + wg * stages * 8192
            + wg * 64 * (bn + 8) * 2 + bn * 4)


LEG_MIN_STAGES = 2  # the leg's ring holds A only: two 64-deep steps will do


def leg_product_candidates(b: int, t: int, n: int, k: int, parts: int,
                           per_image: bool,
                           sms: int = SMS) -> List[LegProductPlan]:
    """Every plan the kernel takes (1 or 2 consumer warpgroups) that fits."""
    if min(b, t, n, k) <= 0 or n % 8 or k % 8:
        raise ValueError(f"leg product ({b}, {t}) x ({k}, {n}): C must be "
                         f"a positive multiple of 8 (TMA reads rows of "
                         f"16-byte multiples)")
    ksteps = -(-k // BK)
    cands = []
    for bn in BN_MENU:
        for wg in (1, 2):
            if wg > 1 and (t if per_image else b * t) <= 64:
                continue  # a warpgroup with no row at all
            fixed = (ksteps * -(-bn // 64) * 8192
                     + 64 * wg * (bn + 8) * 2 + bn * 4)
            st = next((s for s in range(PLAN_STAGES, LEG_MIN_STAGES - 1, -1)
                       if _fits(fixed + wg * s * 8192)), 0)
            if st:
                cands.append(LegProductPlan(b, t, n, k, parts, per_image, wg,
                                            bn, st, sms))
    if not cands:
        raise ValueError(f"leg product ({b}, {t}) x ({k}, {n}): no tile of "
                         f"B for the whole K fits shared memory")
    return cands


def leg_critical_path(p: LegProductPlan) -> int:
    """The busiest block's work in multiply-adds: its M tiles, each BM x
    BN x K and a fixed cost (`WAVE_OVERHEAD_MACS`)."""
    return -(-p.m_tiles // p.blocks_per_unit) * (
        p.bm * p.bn * p.ksteps * BK + WAVE_OVERHEAD_MACS)


def plan_leg_product(b: int, t: int, n: int, k: int, parts: int = 1,
                     per_image: bool = False,
                     sms: int = SMS) -> LegProductPlan:
    """Unsplit, the least critical path, then the fewest units, then the
    deepest ring."""
    return min(leg_product_candidates(b, t, n, k, parts, per_image, sms),
               key=lambda p: (leg_critical_path(p), p.units, -p.stages))


# ------------------------------------------------------------------ K7

HALO_PITCH = 72  # bf16 elements per halo pixel: 64 channels + 16 bytes
# the conv keeps at most 64 accumulators a thread: wider tiles spilled
# kilobytes a thread on the card (ptxas, sm_90a), its halo loop's
# registers on top of 112 or 128 accumulators
CONV_BN_MENU = (64, 128)


@dataclass(frozen=True)
class ConvPlan:
    """The half-step's implicit GEMM over NHWC (n, h, w, c) -> o: an
    M-tile is `rows` image rows of `cols` pixels (whole rows when W fits
    the tile, else one row cut in segments) of one image; K is 9 taps for
    each 64-channel chunk, split over chunks; `itemsize` is x's."""
    n: int
    h: int
    w: int
    c: int
    o: int
    itemsize: int
    wg: int
    rows: int
    cols: int
    bn: int
    splits: int
    chunks_per_split: int
    stages: int

    @property
    def chunks(self) -> int:
        return -(-self.c // BK)

    @property
    def tiles_y(self) -> int:
        return -(-self.h // self.rows)

    @property
    def tiles_x(self) -> int:
        return -(-self.w // self.cols)

    @property
    def m_tiles(self) -> int:
        return self.n * self.tiles_y * self.tiles_x

    @property
    def n_tiles(self) -> int:
        return -(-self.o // self.bn)

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def units(self) -> int:
        return self.tiles * self.splits

    @property
    def smem(self) -> int:
        return ALIGN_SLACK + conv_smem(self.wg, self.rows, self.cols, self.bn,
                                       self.itemsize, self.stages)

    @property
    def workspace_floats(self) -> int:
        if self.splits == 1:
            return 0
        return self.tiles * self.splits * 64 * self.wg * self.bn

    def as_ints(self) -> Tuple[int, ...]:
        return (self.wg, self.rows, self.cols, self.bn, self.splits,
                self.chunks_per_split, self.stages)

    def chunk_ranges(self) -> List[Tuple[int, int]]:
        """[first, last) channel chunk of each split, in split order."""
        per = self.chunks_per_split
        return [(s * per, min((s + 1) * per, self.chunks))
                for s in range(self.splits)]

    def tile_pixels(self):
        """(image, y0, y1, x0, x1) of every M-tile."""
        return [(i, ty * self.rows, min((ty + 1) * self.rows, self.h),
                 tx * self.cols, min((tx + 1) * self.cols, self.w))
                for i in range(self.n) for ty in range(self.tiles_y)
                for tx in range(self.tiles_x)]


def conv_smem(wg: int, rows: int, cols: int, bn: int, itemsize: int,
              stages: int) -> int:
    """Bytes of the conv kernel's dynamic shared memory past the alignment
    slack: the activated bf16 halo tile of one 64-channel chunk, its raw
    copy in x's type, and the weight ring, or the epilogue staging tile in
    x's type, which reuses them."""
    halo = (rows + 2) * (cols + 2) * (HALO_PITCH * 2 + BK * itemsize)
    staging = 64 * wg * (bn * itemsize + 16)
    return max(halo + stages * bn * 128, staging)


def _resident(smem: int, wg: int, max_wg: int) -> int:
    """Blocks of a plan that fit one SM at once: shared memory (1 KB of
    each block's is the system's) and registers (the kernel is built for
    128 * (max_wg + 1) threads: 128 registers a thread at three consumer
    warpgroups, 168 at two)."""
    regs = 128 * (wg + 1) * (128 if max_wg == 3 else 168)
    return max(1, min(_SM_SMEM // (smem + STATIC_SMEM + 1024),
                      _SM_REGS // regs))


def conv_terms(p: ConvPlan):
    """The cost model's terms (see TERMS) of a K7 plan: per-thread work is
    counted once per wave of blocks, since blocks of one wave overlap."""
    waves = -(-p.units // (SMS * _resident(p.smem, p.wg,
                                           max_warpgroups(p.bn))))
    steps = 9 * p.chunks_per_split
    halo = (p.rows + 2) * (p.cols + 2) * BK
    tile = 64 * p.wg * p.bn
    threads = 128 * p.wg
    l2 = p.units * (steps * p.bn * BK * 2
                    + p.chunks_per_split * halo * p.itemsize)
    split_sum = p.splits * tile if p.splits > 1 else 0
    l2 += 2 * p.units * tile * 4 if p.splits > 1 else 0
    return (1.0, waves * steps, waves * p.chunks_per_split * halo / threads,
            waves * tile / threads, waves * split_sum / threads, l2 / 1e6,
            p.units * steps * 2.0 * tile * BK / SMS / 1e6)


def _conv_cost(p: ConvPlan) -> float:
    return sum(w * t for w, t in zip(CONV_WEIGHTS, conv_terms(p)))


def plan_conv(shape, o: int, itemsize: int = 2) -> ConvPlan:
    """The plan of one K7 launch on NHWC `shape` with `o` outputs: the
    cheapest by the cost model, then the fewest splits, then the deepest
    ring."""
    return min(conv_candidates(shape, o, itemsize),
               key=lambda p: (_conv_cost(p), p.splits, -p.stages))


def conv_candidates(shape, o: int, itemsize: int = 2) -> List[ConvPlan]:
    """Every plan of a K7 launch that the kernel takes and the card fits."""
    n, h, w, c = shape
    chunks = -(-c // BK)
    cands = []
    for bm in BM_MENU:
        if w <= bm:
            cols, rows = w, min(h, bm // w)
        else:
            cols, rows = bm, 1
        wg = -(-(rows * cols) // 64)
        if 64 * wg != bm:
            continue  # the same tile as a smaller BM gives
        for bn in CONV_BN_MENU:
            if wg > max_warpgroups(bn):
                continue
            for s in range(1, chunks + 1):
                per = -(-chunks // s)
                if -(-chunks // per) != s:
                    continue
                halo = (rows + 2) * (cols + 2) * (HALO_PITCH * 2
                                                   + BK * itemsize)
                st = _stages(halo, bn * 128, 64 * wg * (bn * itemsize + 16))
                if not st:
                    continue
                cands.append(ConvPlan(n, h, w, c, o, itemsize, wg, rows,
                                      cols, bn, s, per, st))
    if not cands:
        raise ValueError(f"no plan fits the conv {tuple(shape)} -> {o}")
    return cands


# --------------------------------------------------------------- launch


def int_array(values) -> ctypes.Array:
    """A plan as the host int array a C entry point reads."""
    return (ctypes.c_int * len(values))(*values)


_counters = {}


def stream_counters(device: torch.device, count: int) -> torch.Tensor:
    """At least `count` int32 counters, zero, for kernels whose last block
    to count itself in finishes the work and resets its counter before it
    exits (split K here, the GroupNorm statistics' images in
    `fused_gn._stats_launch`). Launches in order on one stream can share
    them: they are zeroed once per (device, stream) and kept. A launch
    captured into a CUDA graph gets counters of its own, zeroed in the
    graph, since a replay may run beside any stream."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(count, dtype=torch.int32, device=device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < count:
        cnt = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
        _counters[key] = cnt
    return cnt


def split_scratch(device: torch.device, floats: int, tiles: int):
    """(partials, counters) for a launch whose plan splits K: a fresh
    float32 workspace of `floats` and `stream_counters` for its tiles.
    (None, None) without a split."""
    if floats == 0:
        return None, None
    partials = torch.empty(floats, dtype=torch.float32, device=device)
    return partials, stream_counters(device, tiles)


@functools.lru_cache(maxsize=256)
def cached_conv_plan(shape, o: int, itemsize: int):
    """plan_conv and its C plan array."""
    plan = plan_conv(shape, o, itemsize)
    return plan, int_array(plan.as_ints())


@functools.lru_cache(maxsize=64)
def cached_transformer_plans(b, t, c, tk, ctx_dim):
    """transformer_plans, their C plan array and their scratch sizes."""
    plans = transformer_plans(b, t, c, tk, ctx_dim)
    return plans, int_array(plan_array(plans)), product_workspace(plans)
