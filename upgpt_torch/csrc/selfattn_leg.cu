// The self-attention leg of the SpatialTransformer block for Hopper
// (sm_90a): x -> Q, K, V -> per-head softmax(Q K^T / sqrt(dh)) V -> to_out
// + bias, over (B, T, C) bf16 tokens.
//
// Replaces benchmarks/micro_block.py::fw_kernel (K8, full-width (C, C)
// weights in (in, out) layout) and ::ph_kernel (K9, weights pre-split per
// head: (H, C, dh) for Q/K/V, (H, dh, C) for to_out). Both TPU kernels hold
// one whole image per grid step in VMEM: x alone is 768 x 224 bf16 (344 KB)
// and one head's (768, 768) float32 score matrix 2.36 MB, where a Hopper
// block has 227 KB. So each C call here is three launches, and no score
// matrix is ever materialised:
//
// 1. leg_product_kernel<kQkvTma or kQkvCopy>: Q, K and V as one product
//    (B T, C) x (C, 3C) on the wgmma pieces of gemm_sm90.cuh (a TMA ring
//    of 64-deep K steps, a producer warpgroup, one or two consumer
//    warpgroups, register-A wgmma, no split). The blocks are persistent:
//    each owns one N tile of one piece (q, k or v), loads that tile of B
//    for the whole K once and keeps it in shared memory, and walks its M
//    tiles with only x streaming through the ring. The weights are
//    N-major for this product and are read where they lie through wgmma's
//    transpose bit: K8's (C, C) pieces by TMA; K9's (H, C, dh) pieces,
//    whose 56-byte rows TMA cannot address (strides must be multiples of
//    16 bytes), by cp.async from the producer warpgroup into the same
//    swizzled layout (column n of a piece is head n / dh, lane n % dh).
//    The epilogue stages the tile in shared memory and writes Q, K and V
//    head-major and padded, (3, B, H, T, Dp) with Dp = dh rounded up to
//    32, 64 or 128, the pad lanes as zeros, 16 bytes a thread over
//    consecutive tokens of a head's plane.
// 2. flash_kernel<Dp>: one persistent block per SM walks (b, h, 128-query)
//    tiles. Its producer thread streams Q and then K/V key tiles by TMA
//    through a ring of mbarrier stages (a 3-D descriptor over (Dp, T,
//    planes), so a plane's ragged end reads zeros, never the next plane);
//    two consumer warpgroups own 64 query rows each. S = Q K^T and O += P V
//    run on wgmma, P straight from the S accumulators as register A
//    fragments, V read MN-major through the transpose bit. The online
//    softmax is in the exp2 domain with scale * log2(e) folded into one
//    FFMA, keys >= T masked to -inf; o is divided by the row sum at the
//    end, where the TPU kernels normalise p before the value product (a
//    rounding divergence within a bf16 step). The two warpgroups take
//    turns at the tensor cores (named barriers 4 and 5): one issues its
//    products (S of tile j, P V of tile j - 1) while the other computes its
//    exponentials, and a warpgroup's own softmax of tile j runs under its
//    P V of tile j - 1 (P double-buffered in registers).
// 3. leg_product_kernel<kOut>: to_out as one product whose K loop runs over
//    the heads' padded segments, o (B, H, T, Dp) against wo read as
//    (H, dh, C) (K8's (C, C) weights and K9's pre-split ones lie alike);
//    TMA zero-fills wo's rows dh..Dp of each head, so the pad lanes meet
//    zero rows of B. K9's accumulators start from the float32 bias and add
//    head by head in head order, as ph_kernel sums; K8 adds the bias in the
//    epilogue. Persistent with B resident, as the Q/K/V product.
//
// What bounds each launch on an H100 at (32, 768, 224, 8 heads): the
// products move bytes (Q/K/V: x 11 MB in, 37.7 MB of padded Q/K/V out,
// 0.015 ms at 3.35 TB/s, against 7.4 GFLOP, 0.0075 ms at 989 TFLOP/s); the
// flash pass is bound by the softmax's 151 M exponentials on the
// special-function units (16 a clock per SM: 0.036 ms), its padded
// products needing 0.0195 ms in 2 + 8 small wgmmas (m64n128k16 and
// m64n32k16) per warpgroup and key tile; the turns between the two
// warpgroups let each one's exponentials run under the other's products.
// Resident B bounds the products' K: every K step of a B tile must fit
// shared memory beside the ring and the staging tile (gemm_plan), so K =
// C (Q/K/V) and K = H Dp (to_out) stay within 1,536 (64-wide tiles). No split reduction and no
// atomics: each output element is summed by one thread in a fixed order,
// so a call repeats bit for bit.
#include <math.h>

#include "gemm_sm90.cuh"

namespace {

using sm90::bf16;
using sm90::kBK;

constexpr int kMaxWg = 2;  // consumer warpgroups a block is built for
constexpr int kThreads = sm90::block_threads(kMaxWg);
constexpr int kMaxHead = 128;
constexpr int kBQ = 128;  // query rows of a flash tile: 64 per warpgroup
constexpr int kTurn = 4;  // named barriers kTurn + wg: a warpgroup's turn
constexpr int kLegMinStages = 2;  // gemm_plan.LEG_MIN_STAGES

enum Mode { kQkvTma = 0, kQkvCopy = 1, kOut = 2 };

struct LegArgs {
  int B, T, C, H, dh, dp;
  int wg, stages, n_tiles;  // n_tiles: N tiles per piece (q, k, v)
  int units;                // parts * n_tiles: the N tiles of the grid
  int m_tiles;              // Q/K/V: of the B T rows; to_out: of each image
  const bf16* w[3];         // kQkvCopy: the (H, C, dh) pieces
  int vec;                  // kQkvCopy: bytes per copy of them
  bf16* out;                // Q/K/V: (3, B, H, T, dp); to_out: (B, T, C)
  const float* bias;        // to_out: (C,)
  int bias_first;           // to_out: the accumulators start from the bias
};

// the product's 64-column chunks of B, each 64 K rows of 128 bytes
__host__ __device__ constexpr int b_chunks(int bn) { return (bn + 63) / 64; }

// gemm_plan.leg_product_smem: B resident (every K step's chunks), the
// ring of A boxes (64 rows a consumer warpgroup), the bf16 epilogue
// staging tile and the bias
__host__ __device__ inline int leg_product_smem(int wg, int bn, int ksteps,
                                                int stages) {
  return ksteps * b_chunks(bn) * 8192 + stages * wg * 64 * 128 +
         wg * 64 * sm90::staging_pitch<bf16>(bn) * 2 + bn * 4;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// V bytes of a K9 weight row from src, or zeros where !in
template <int V>
__device__ __forceinline__ void copy_piece(uint8_t* dst, const bf16* src,
                                           bool in) {
  if constexpr (V >= 4) {
    mma::cp_async<V>(dst, src, in);
  } else {
    *reinterpret_cast<bf16*>(dst) = in ? *src : __float2bfloat16(0.f);
  }
}

// K9's piece w, columns [n0, n0 + BN), as the product's resident MN-major
// B: K step s, chunk j at dst + (s * NCH + j) * 8192, each 64 K rows of
// 128 bytes, 128-byte swizzled as TMA would write them. Column n0 + n of
// the piece is lane (n0 + n) % dh of head (n0 + n) / dh, so a thread keeps
// one column and walks K. Rows past C and columns past the piece are
// zeros.
template <int V, int BN>
__device__ __forceinline__ void copy_b(uint8_t* dst, const bf16* w, int n0,
                                       int ksteps, const LegArgs& g,
                                       int tid) {
  constexpr int E = V / 2;  // elements per copy
  constexpr int PER_ROW = BN / E;
  constexpr int COLS = PER_ROW < 128 ? PER_ROW : 128;
  constexpr int ROWS = 128 / COLS;  // K rows a pass of the threads covers
  constexpr int NCH = b_chunks(BN);
  if (tid >= ROWS * COLS) return;
  const int krows = ksteps * kBK;
  for (int cs = tid % COLS; cs < PER_ROW; cs += COLS) {
    const int n = cs * E, col = n0 + n;
    const int h = col / g.dh, d = col - h * g.dh;
    const bool col_in = col < g.C;
    const bf16* src = w + (static_cast<size_t>(h) * g.C + tid / COLS) * g.dh + d;
    uint8_t* chunk = dst + (n / 64) * 8192;
    const int byte = (n % 64) * 2;
    for (int k = tid / COLS; k < krows; k += ROWS, src += ROWS * g.dh) {
      const bool in = col_in && k < g.C;
      copy_piece<V>(chunk + (k / kBK) * NCH * 8192 +
                        sm90::swizzle((k % kBK) * 128 + byte, 128),
                    in ? src : w, in);
    }
  }
}

// Q/K/V head-major: tile column c is lane (n0 + c) % dh of head
// (n0 + c) / dh, each head a padded (T, dp) plane of its image. A thread
// keeps 8 lanes (CH = dp / 8 threads a row) of every 128 / CH-th of the
// warpgroup's 64 staged rows and writes them for each head of the tile,
// so a warp stores consecutive tokens of one plane, 16 bytes a thread. A
// head cut by the tile's edge is written element by element, its pad
// lanes (zeros) by the tile that holds its last lane.
template <int CH>
__device__ __forceinline__ void store_heads(const bf16* staged, int P,
                                            bf16* qkv, long long mrow,
                                            int n0, int cols,
                                            const LegArgs& g) {
  constexpr int RPP = 128 / CH;  // rows a pass of the warpgroup covers
  const int tid = threadIdx.x % 128, c8 = (tid % CH) * 8;
  const int h_lo = n0 / g.dh, h_hi = (n0 + cols - 1) / g.dh;
  const long long M = static_cast<long long>(g.B) * g.T;
  const size_t plane = static_cast<size_t>(g.T) * g.dp;
  for (int r = tid / CH; r < 64 && mrow + r < M; r += RPP) {
    const long long m = mrow + r;
    const int bb = static_cast<int>(m / g.T);
    const int t = static_cast<int>(m - static_cast<long long>(bb) * g.T);
    bf16* base =
        qkv + (static_cast<size_t>(bb) * g.H * g.T + t) * g.dp + c8;
    const bf16* src = staged + r * P;
    for (int h = h_lo; h <= h_hi; ++h) {
      const int c0 = h * g.dh + c8 - n0;  // tile column of lane c8
      bf16* dst = base + static_cast<size_t>(h) * plane;
      if (!(g.dh & 1) && h * g.dh >= n0 && h * g.dh + g.dh <= n0 + cols) {
        // an even-width head inside the tile: its lanes in pairs, the pad
        // pairs zeros
        const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src + c0);
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = c8 + 2 * k + 2 <= g.dh ? s32[k] : 0u;
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        continue;
      }
      const int last = h * g.dh + g.dh - 1 - n0;
      const bool pads = last >= 0 && last < cols;
      __align__(16) bf16 v[8];
      unsigned ok = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool real = c8 + e < g.dh;
        const bool mine = real ? c0 + e >= 0 && c0 + e < cols : pads;
        v[e] = real && mine ? src[c0 + e] : __float2bfloat16(0.f);
        ok |= static_cast<unsigned>(mine) << e;
      }
      if (ok == 0xffu) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (ok >> e & 1u) dst[e] = v[e];
      }
    }
  }
}

// Q/K/V (kQkvTma: K8, kQkvCopy: K9) or to_out (kOut) of the leg, one
// persistent block an SM. Block i owns the N tile i % units (a piece and
// its columns [n0, n0 + BN)) and walks the M tiles i / units, + grid /
// units, ...: B for the whole K is loaded once and stays in shared memory;
// only A streams through the ring, so the next tile's loads run under a
// tile's epilogue. Block: wg consumer warpgroups of 64 rows of each M
// tile, then the producer warpgroup.
template <int MODE, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    leg_product_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b0,
                       const __grid_constant__ CUtensorMap map_b1,
                       const __grid_constant__ CUtensorMap map_b2,
                       const LegArgs g) {
  constexpr int NCH = b_chunks(BN);
  constexpr int R = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[sm90::kMaxStages], empty[sm90::kMaxStages];
  __shared__ uint64_t b_full;
  uint8_t* smem = sm90::align1024(smem_raw);

  const int threads = 128 * g.wg, bm = 64 * g.wg;
  const int a_bytes = bm * 128;
  // to_out's A boxes: dpb lanes of o a row (64-byte swizzle for dp = 32)
  const int dpb = g.dp < kBK ? g.dp : kBK;
  const int unit = blockIdx.x % g.units, stride = gridDim.x / g.units;
  const int part = unit / g.n_tiles, n0 = (unit % g.n_tiles) * BN;
  const int ksteps =
      ((MODE == kOut ? g.H * g.dp : g.C) + kBK - 1) / kBK;
  uint8_t* bs = smem;  // resident B
  const sm90::Ring ring{smem + ksteps * NCH * 8192, full, empty, g.stages,
                        a_bytes};
  constexpr int P = sm90::staging_pitch<bf16>(BN);
  bf16* staging = reinterpret_cast<bf16*>(ring.base + g.stages * a_bytes);
  float* sbias = reinterpret_cast<float*>(staging + bm * P);
  // first row of M tile mt: of the B T rows, or (image, row) for to_out
  auto tile_rows = [&](int mt, int& b, int& t0) {
    if (MODE == kOut) {
      const int per = (g.T + bm - 1) / bm;
      b = mt / per;
      t0 = (mt % per) * bm;
    } else {
      b = 0;
      t0 = mt * bm;
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], 4 * g.wg);
    }
    // K9: each producer thread counts itself in once its copies landed
    sm90::bar_init(&b_full, MODE == kQkvCopy ? 128 : 1);
    sm90::bar_fence_init();
  }
  __syncthreads();

  const int wg = sm90::warpgroup_index();
  if (wg == g.wg) {  // the producer warpgroup
    sm90::producer_registers<kMaxWg>();
    const int tid = threadIdx.x - threads;
    if (MODE == kQkvCopy) {
      const bf16* w = part == 0 ? g.w[0] : part == 1 ? g.w[1] : g.w[2];
      switch (g.vec) {
        case 16: copy_b<16, BN>(bs, w, n0, ksteps, g, tid); break;
        case 8: copy_b<8, BN>(bs, w, n0, ksteps, g, tid); break;
        case 4: copy_b<4, BN>(bs, w, n0, ksteps, g, tid); break;
        default: copy_b<2, BN>(bs, w, n0, ksteps, g, tid);
      }
      mma::cp_async_commit();
      mma::cp_async_wait<0>();
      fence_proxy_async();  // visible to wgmma (the async proxy)
      sm90::bar_arrive(&b_full);
    }
    if (tid != 0) return;
    if (MODE != kQkvCopy) {
      // a constant index: a kernel parameter read at a run-time index
      // would be copied to the stack
      const CUtensorMap* mb =
          part == 0 ? &map_b0 : part == 1 ? &map_b1 : &map_b2;
      sm90::bar_expect_tx(&b_full, ksteps * NCH * 8192);
      for (int s = 0; s < ksteps; ++s) {
        uint8_t* dst = bs + s * NCH * 8192;
        if (MODE == kOut) {
          // step s: heads 2s, 2s + 1 (dp 32), head s (dp 64), or half of
          // head s / 2 (dp 128); wo's rows past dh read zeros
          const int per = kBK / dpb;
          for (int i = 0; i < per; ++i) {
            const int h = g.dp > kBK ? s / 2 : s * per + i;
            const int d0 = g.dp > kBK ? (s % 2) * kBK : 0;
            for (int j = 0; j < NCH; ++j)
              sm90::tma_3d(dst + j * 8192 + i * dpb * 128, mb, &b_full,
                           n0 + j * 64, d0, h);
          }
        } else {
          for (int j = 0; j < NCH; ++j)
            sm90::tma_2d(dst + j * 8192, mb, &b_full, n0 + j * 64, s * kBK);
        }
      }
    }
    int it = 0;
    for (int mt = blockIdx.x / g.units; mt < g.m_tiles; mt += stride) {
      int b, t0;
      tile_rows(mt, b, t0);
      for (int s = 0; s < ksteps; ++s, ++it) {
        const int st = it % g.stages;
        uint64_t* bar = &full[st];
        sm90::bar_wait(&empty[st], ((it / g.stages) & 1) ^ 1);
        sm90::bar_expect_tx(bar, a_bytes);
        uint8_t* dst = ring.stage(st);
        if (MODE == kOut) {
          const int per = kBK / dpb;
          for (int i = 0; i < per; ++i) {
            const int h = g.dp > kBK ? s / 2 : s * per + i;
            const int d0 = g.dp > kBK ? (s % 2) * kBK : 0;
            sm90::tma_4d(dst + i * bm * dpb * 2, &map_a, bar, d0, t0, h, b);
          }
        } else {
          sm90::tma_2d(dst, &map_a, bar, s * kBK, t0);
        }
      }
    }
    return;
  }
  sm90::consumer_registers<kMaxWg>();

  const int lane = threadIdx.x % 32, w4 = (threadIdx.x / 32) % 4;
  const int t4 = lane % 4;
  const int row = wg * 64 + w4 * 16 + (lane & 15);
  const int span = MODE == kOut ? dpb * 2 : 128;  // bytes of an A box row
  const int kper = span / 32;                     // 16-deep slices a box
  const size_t plane = static_cast<size_t>(g.T) * g.dp;
  bf16* qkv = g.out + static_cast<size_t>(part) * g.B * g.H * plane;
  const uint64_t b_desc = sm90::desc_swz(bs, 8192, 1024, 128);
  const int cols = min(BN, g.C - n0);
  if (MODE == kOut) {
    for (int c = threadIdx.x; c < BN; c += threads)
      sbias[c] = c < cols ? g.bias[n0 + c] : 0.f;
    sm90::consumer_sync(threads);
  }
  bf16* staged = staging + wg * 64 * P;
  sm90::bar_wait(&b_full, 0);

  for (int mt = blockIdx.x / g.units, first = 0; mt < g.m_tiles;
       mt += stride, first += ksteps) {
    int b, t0;
    tile_rows(mt, b, t0);
    float acc[1][R];
    const bool from_bias = MODE == kOut && g.bias_first;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const float b0 = from_bias ? sbias[c] : 0.f;
      const float b1 = from_bias ? sbias[c + 1] : 0.f;
      acc[0][4 * j] = acc[0][4 * j + 2] = b0;
      acc[0][4 * j + 1] = acc[0][4 * j + 3] = b1;
    }
    // K step s of B: NCH chunks of 8 KB; a 16-deep slice is 16 rows
    // (2048 bytes, 128 in the descriptor's units) on
    sm90::consume_desc<BN, 1, 1>(
        ring, first, ksteps, acc,
        [&](int, int kk, uint8_t* stage, uint32_t(&a)[4]) {
          const int box = kk / kper, chunk = (kk % kper) * 2 + (lane >> 4);
          mma::ldsm_x4(a, reinterpret_cast<const bf16*>(
                              stage + box * bm * span +
                              sm90::swizzle(row * span + chunk * 16, span)));
        },
        [&](int s, int, int kk) {
          return b_desc + static_cast<uint64_t>(s * NCH * 512 + kk * 128);
        });

    // the epilogue: the warpgroup's 64 x BN tile rounded once into its
    // staging rows, then written out in 16-byte stores, consecutive
    // threads on consecutive addresses
    sm90::warpgroup_sync(wg);  // the previous tile's rows are out
    sm90::for_pairs<BN>(acc[0], [&](int r, int c, float v0, float v1) {
      if (MODE == kOut && !g.bias_first) {
        v0 += sbias[c];
        v1 += sbias[c + 1];
      }
      sm90::put2(staged + r * P + c, v0, v1);
    });
    sm90::warpgroup_sync(wg);
    if (MODE == kOut) {
      sm90::copy_rows<bf16, BN>(staged, cols, true, [&](int r) -> bf16* {
        const int t = t0 + wg * 64 + r;
        return t < g.T ? g.out + (static_cast<size_t>(b) * g.T + t) * g.C + n0
                       : nullptr;
      });
      continue;
    }
    switch (g.dp) {
      case 32: store_heads<4>(staged, P, qkv, t0 + wg * 64, n0, cols, g); break;
      case 64: store_heads<8>(staged, P, qkv, t0 + wg * 64, n0, cols, g); break;
      default: store_heads<16>(staged, P, qkv, t0 + wg * 64, n0, cols, g);
    }
  }
}

// ---------------------------------------------------------------- flash

struct FlashArgs {
  int T, dh, q_blocks, tiles, planes;  // planes: B * H
  float scale_log2;                    // log2(e) / sqrt(dh)
  bf16* o;                             // (B, H, T, dp)
};

template <int DP, int BK>
struct FlashTile {
  static constexpr int DB = DP < 64 ? DP : 64;  // lanes of a box row
  static constexpr int SPAN = DB * 2;           // its bytes (the swizzle)
  static constexpr int NBOX = DP / DB;
  static constexpr int Q_BYTES = kBQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;  // K or V of a key tile
  static constexpr int STAGE = 2 * KV_BYTES;
};

// gemm_plan.flash_smem (the selfattn_leg module's)
template <int DP, int BK>
__host__ inline int flash_smem(int stages) {
  using Tl = FlashTile<DP, BK>;
  return Tl::Q_BYTES + stages * Tl::STAGE;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// Persistent: block i takes tiles i, i + grid, ... of (plane, 128-query
// block), the query block fastest. Warpgroups 0 and 1 consume, 2 produces.
template <int DP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_kv,
                 const FlashArgs f, int stages) {
  using Tl = FlashTile<DP, BK>;
  constexpr int SPAN = Tl::SPAN;
  constexpr int KPER = Tl::DB / 16;  // 16-deep slices of a box row
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[sm90::kMaxStages], empty[sm90::kMaxStages];
  __shared__ uint64_t q_full, q_empty;
  uint8_t* smem = sm90::align1024(smem_raw);
  uint8_t* qs = smem;
  const sm90::Ring ring{smem + Tl::Q_BYTES, full, empty, stages, Tl::STAGE};
  const int nkv = (f.T + BK - 1) / BK;
  if (threadIdx.x == 0) {
    sm90::ring_init(ring, 8);  // both warpgroups release each stage
    sm90::bar_init(&q_full, 1);
    sm90::bar_init(&q_empty, 8);
    sm90::bar_fence_init();
  }
  __syncthreads();

  const int wg = sm90::warpgroup_index();
  if (wg == 2) {
    sm90::producer_registers<kMaxWg>();
    if (threadIdx.x == 256) {
      int it = 0, qn = 0;
      for (int tile = blockIdx.x; tile < f.tiles; tile += gridDim.x, ++qn) {
        const int plane = tile / f.q_blocks, q0 = (tile % f.q_blocks) * kBQ;
        sm90::bar_wait(&q_empty, (qn & 1) ^ 1);
        sm90::bar_expect_tx(&q_full, Tl::Q_BYTES);
        for (int x = 0; x < Tl::NBOX; ++x)
          sm90::tma_3d(qs + x * kBQ * SPAN, &map_q, &q_full, x * 64, q0,
                       plane);
        for (int j = 0; j < nkv; ++j, ++it) {
          const int st = it % stages;
          sm90::bar_wait(&empty[st], ((it / stages) & 1) ^ 1);
          sm90::bar_expect_tx(&full[st], Tl::STAGE);
          uint8_t* dst = ring.stage(st);
          for (int x = 0; x < Tl::NBOX; ++x) {
            sm90::tma_3d(dst + x * BK * SPAN, &map_kv, &full[st], x * 64,
                         j * BK, f.planes + plane);
            sm90::tma_3d(dst + Tl::KV_BYTES + x * BK * SPAN, &map_kv,
                         &full[st], x * 64, j * BK, 2 * f.planes + plane);
          }
        }
      }
    }
    return;
  }
  sm90::consumer_registers<kMaxWg>();

  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int t4 = lane % 4;
  const float c = f.scale_log2;
  // K: keys are rows of SPAN bytes along dp (K-major); V: the same rows
  // read MN-major, the next 64 lanes BK rows on
  auto kdesc = [&](uint8_t* stage, int kk) {
    return sm90::desc_swz(stage + (kk / KPER) * BK * SPAN + (kk % KPER) * 32,
                          16, 8 * SPAN, SPAN);
  };
  auto vdesc = [&](uint8_t* stage, int kk) {
    return sm90::desc_swz(stage + Tl::KV_BYTES + kk * 16 * SPAN, BK * SPAN,
                          8 * SPAN, SPAN);
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) sm90::bar_arrive(&empty[st]);
  };

  if (wg == 1) named_arrive(kTurn);  // warpgroup 0 takes the first turn
  int it = 0, qn = 0;
  for (int tile = blockIdx.x; tile < f.tiles; tile += gridDim.x, ++qn) {
    const bool last_tile = tile + static_cast<int>(gridDim.x) >= f.tiles;
    const int plane = tile / f.q_blocks, q0 = (tile % f.q_blocks) * kBQ;
    uint32_t qf[DP / 16][4];
    sm90::bar_wait(&q_full, qn & 1);
    {
      const int qrow = wg * 64 + warp * 16 + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int chunk = (kk % KPER) * 2 + (lane >> 4);
        mma::ldsm_x4(qf[kk], reinterpret_cast<const bf16*>(
                                 qs + (kk / KPER) * kBQ * SPAN +
                                 sm90::swizzle(qrow * SPAN + chunk * 16,
                                               SPAN)));
      }
    }
    __syncwarp();
    if (lane == 0) sm90::bar_arrive(&q_empty);

    float o[DP / 2], s[BK / 2];
    uint32_t pa[BK / 16][4], pb[BK / 16][4];  // P of two key tiles
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float a0 = 1.f, a1 = 1.f;  // o's pending rescale

    auto issue_s = [&](uint8_t* stage) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        sm90::Mma<BK>::rs(s, qf[kk], kdesc(stage, kk), kk > 0);
    };
    auto issue_pv = [&](uint8_t* stage, const uint32_t(&p)[BK / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::Mma<DP>::template rs<1>(o, p[kk], vdesc(stage, kk));
    };
    // Rows g and g + 8 of the warp's 16: the running max, the rescale of
    // o and l it implies (o's waits until the products reading o are
    // done), p rounded to bf16 as the A fragments of P V. Four partial
    // maxima and sums a row keep the dependency chains short.
    auto softmax = [&](int j, uint32_t(&p)[BK / 16][4]) {
      const int kv0 = j * BK;
      if (kv0 + BK > f.T) {
#pragma unroll
        for (int q = 0; q < BK / 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kv0 + 8 * q + 2 * t4 + (e & 1) >= f.T) s[4 * q + e] = -INFINITY;
      }
      float x0[4] = {m0, m0, m0, m0}, x1[4] = {m1, m1, m1, m1};
#pragma unroll
      for (int q = 0; q < BK / 8; ++q) {
        x0[q % 4] = fmaxf(x0[q % 4], fmaxf(s[4 * q], s[4 * q + 1]));
        x1[q % 4] = fmaxf(x1[q % 4], fmaxf(s[4 * q + 2], s[4 * q + 3]));
      }
      const float mx0 = mma::quad_max(fmaxf(fmaxf(x0[0], x0[1]),
                                            fmaxf(x0[2], x0[3])));
      const float mx1 = mma::quad_max(fmaxf(fmaxf(x1[0], x1[1]),
                                            fmaxf(x1[2], x1[3])));
      a0 = ex2((m0 - mx0) * c);
      a1 = ex2((m1 - mx1) * c);
      m0 = mx0;
      m1 = mx1;
      const float b0 = -mx0 * c, b1 = -mx1 * c;
      float u0[4] = {0.f, 0.f, 0.f, 0.f}, u1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < BK / 8; ++q) {
        s[4 * q] = ex2(fmaf(s[4 * q], c, b0));
        s[4 * q + 1] = ex2(fmaf(s[4 * q + 1], c, b0));
        s[4 * q + 2] = ex2(fmaf(s[4 * q + 2], c, b1));
        s[4 * q + 3] = ex2(fmaf(s[4 * q + 3], c, b1));
        u0[q % 4] += s[4 * q] + s[4 * q + 1];
        u1[q % 4] += s[4 * q + 2] + s[4 * q + 3];
      }
      l0 = l0 * a0 + ((u0[0] + u0[1]) + (u0[2] + u0[3]));
      l1 = l1 * a1 + ((u1[0] + u1[1]) + (u1[2] + u1[3]));
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[kk][0] = mma::pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = mma::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = mma::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = mma::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int q = 0; q < DP / 8; ++q) {
        o[4 * q] *= a0;
        o[4 * q + 1] *= a0;
        o[4 * q + 2] *= a1;
        o[4 * q + 3] *= a1;
      }
    };

    // Turn 0: S of key tile 0. Turn j: S of tile j, then P V of tile
    // j - 1 as a second group; the softmax of tile j runs once S is in,
    // under P V, into the other P buffer. Turn nkv: P V of the last tile.
    int prev = it % stages;
    sm90::bar_wait(&full[prev], (it / stages) & 1);
    named_sync(kTurn + wg);
    sm90::fence_regs(s);
    sm90::wgmma_fence();
    issue_s(ring.stage(prev));
    sm90::wgmma_commit();
    named_arrive(kTurn + 1 - wg);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    softmax(0, pa);
    ++it;
    auto turn = [&](int j, const uint32_t(&p_prev)[BK / 16][4],
                    uint32_t(&p_next)[BK / 16][4]) {
      const int st = it % stages;
      sm90::bar_wait(&full[st], (it / stages) & 1);
      named_sync(kTurn + wg);
      sm90::fence_regs(s);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      issue_s(ring.stage(st));
      sm90::wgmma_commit();
      issue_pv(ring.stage(prev), p_prev);
      sm90::wgmma_commit();
      named_arrive(kTurn + 1 - wg);
      sm90::wgmma_wait<1>();  // S of tile j
      sm90::fence_regs(s);
      softmax(j, p_next);
      sm90::wgmma_wait<0>();  // P V of tile j - 1
      sm90::fence_regs(o);
      release(prev);
      rescale();
      prev = st;
      ++it;
    };
    int j = 1;
    for (; j + 1 < nkv; j += 2) {
      turn(j, pa, pb);
      turn(j + 1, pb, pa);
    }
    if (j < nkv) {
      turn(j, pa, pb);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pb[kk][e];
    }
    named_sync(kTurn + wg);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
    issue_pv(ring.stage(prev), pa);
    sm90::wgmma_commit();
    // the other warpgroup's last turn needs no arrival
    if (wg == 0 || !last_tile) named_arrive(kTurn + 1 - wg);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    release(prev);

    // o / rowsum, rows past T dropped, lanes dh..dp written as zeros
    const float inv0 = 1.f / mma::quad_sum(l0), inv1 = 1.f / mma::quad_sum(l1);
    bf16* ob = f.o + static_cast<size_t>(plane) * f.T * DP;
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int q = 0; q < DP / 8; ++q) {
      const int col = 8 * q + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r0 + 8 * h;
        const float inv = h ? inv1 : inv0;
        if (t < f.T)
          sm90::put2(ob + static_cast<size_t>(t) * DP + col,
                     col < f.dh ? o[4 * q + 2 * h] * inv : 0.f,
                     col + 1 < f.dh ? o[4 * q + 2 * h + 1] * inv : 0.f);
      }
    }
  }
}

// ---------------------------------------------------------------- host

int padded_head(int dh) {
  return dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= kMaxHead ? 128 : 0;
}

template <int MODE, int BN>
cudaError_t launch_product(const LegArgs& g, const CUtensorMap* maps,
                           int grid, int smem, cudaStream_t stream) {
  auto kernel = leg_product_kernel<MODE, BN>;
  static const cudaError_t opted = sm90::allow_smem(kernel);
  if (opted != cudaSuccess) return opted;
  kernel<<<grid, sm90::block_threads(g.wg), smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], g);
  return cudaGetLastError();
}

// One product of the leg: plan p = (wg, bn, stages, grid), checked against
// the kernel and the card; g's B, T, C, H, dh, dp are set.
template <int MODE>
cudaError_t product(LegArgs g, const int* p, const CUtensorMap* maps,
                    cudaStream_t stream) {
  g.wg = p[0];
  g.stages = p[2];
  const int bn = p[1], grid = p[3], bm = 64 * g.wg;
  const int ksteps = ((MODE == kOut ? g.H * g.dp : g.C) + kBK - 1) / kBK;
  g.n_tiles = (g.C + bn - 1) / bn;
  g.units = (MODE == kOut ? 1 : 3) * g.n_tiles;
  g.m_tiles = MODE == kOut
                  ? g.B * ((g.T + bm - 1) / bm)
                  : static_cast<int>((static_cast<long long>(g.B) * g.T +
                                      bm - 1) / bm);
  if (g.wg < 1 || g.wg > kMaxWg || !sm90::bn_in_menu(bn) ||
      g.stages < kLegMinStages || g.stages > sm90::kMaxStages ||
      grid < g.units || grid % g.units || grid / g.units > g.m_tiles ||
      !sm90::smem_fits(leg_product_smem(g.wg, bn, ksteps, g.stages)))
    return cudaErrorInvalidValue;
  const int smem =
      sm90::kAlignSlack + leg_product_smem(g.wg, bn, ksteps, g.stages);
  switch (bn) {
    case 64: return launch_product<MODE, 64>(g, maps, grid, smem, stream);
    case 128: return launch_product<MODE, 128>(g, maps, grid, smem, stream);
    case 224: return launch_product<MODE, 224>(g, maps, grid, smem, stream);
    default: return launch_product<MODE, 256>(g, maps, grid, smem, stream);
  }
}

template <int DP, int BK>
cudaError_t launch_flash(const FlashArgs& f, const CUtensorMap* maps,
                         int stages, int grid, cudaStream_t stream) {
  auto kernel = flash_kernel<DP, BK>;
  static const cudaError_t opted = sm90::allow_smem(kernel);
  if (opted != cudaSuccess) return opted;
  if (!sm90::smem_fits(flash_smem<DP, BK>(stages)))
    return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, sm90::kAlignSlack + flash_smem<DP, BK>(stages),
           stream>>>(maps[0], maps[1], f, stages);
  return cudaGetLastError();
}

#define UPGPT_TRY(expr)               \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

// Both kernels. plan: the Q/K/V product's (wg, bn, stages, grid), to_out's,
// and the flash pass's keys per tile, stages and grid.
cudaError_t leg(bool per_head, const void* x, const void* const* wqkv,
                const void* wo, const void* bo, void* qkv_ws, void* o_ws,
                void* out, const int* plan, int B, int T, int C, int H,
                cudaStream_t stream) {
  if (B <= 0 || T <= 0 || C <= 0 || H <= 0 || C % H || C % 8 ||
      plan == nullptr)
    return cudaErrorInvalidValue;
  const int dh = C / H, dp = padded_head(dh);
  if (dp == 0) return cudaErrorInvalidValue;
  const int dpb = dp < kBK ? dp : kBK, span = dpb * 2;
  const long long M = static_cast<long long>(B) * T;
  LegArgs g = {};
  g.B = B;
  g.T = T;
  g.C = C;
  g.H = H;
  g.dh = dh;
  g.dp = dp;

  {  // Q/K/V into the padded head-major workspace
    LegArgs q = g;
    q.out = static_cast<bf16*>(qkv_ws);
    CUtensorMap maps[4];
    memset(maps, 0, sizeof(maps));
    const uint64_t xd[2] = {static_cast<uint64_t>(C),
                            static_cast<uint64_t>(M)};
    const uint32_t xb[2] = {kBK, static_cast<uint32_t>(64 * plan[0])};
    UPGPT_TRY(sm90::make_map(&maps[0], x, 2, xd, xb));
    if (per_head) {
      unsigned long long mask = 2ull * dh;
      for (int i = 0; i < 3; ++i) {
        q.w[i] = static_cast<const bf16*>(wqkv[i]);
        mask |= reinterpret_cast<unsigned long long>(wqkv[i]);
      }
      q.vec = mma::copy_bytes(mask);
      UPGPT_TRY(product<kQkvCopy>(q, plan, maps, stream));
    } else {
      const uint64_t wd[2] = {static_cast<uint64_t>(C),
                              static_cast<uint64_t>(C)};
      const uint32_t wb[2] = {64, kBK};
      for (int i = 0; i < 3; ++i)
        UPGPT_TRY(sm90::weight_map(&maps[1 + i], wqkv[i], 2, wd, wb));
      UPGPT_TRY(product<kQkvTma>(q, plan, maps, stream));
    }
  }

  {  // the flash pass, o into the padded workspace
    const int bk = plan[8], stages = plan[9], grid = plan[10];
    const int q_blocks = (T + kBQ - 1) / kBQ;
    FlashArgs f = {};
    f.T = T;
    f.dh = dh;
    f.q_blocks = q_blocks;
    f.planes = B * H;
    f.tiles = B * H * q_blocks;
    f.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(double(dh)));
    f.o = static_cast<bf16*>(o_ws);
    if (bk != (dp == 128 ? 64 : 128)) return cudaErrorInvalidValue;
    if (stages < 2 || stages > sm90::kMaxStages || grid < 1 ||
        grid > f.tiles)
      return cudaErrorInvalidValue;
    CUtensorMap maps[2];
    const uint64_t d[3] = {static_cast<uint64_t>(dp),
                           static_cast<uint64_t>(T),
                           static_cast<uint64_t>(3) * B * H};
    const uint32_t qb[3] = {static_cast<uint32_t>(dpb), kBQ, 1};
    const uint32_t kb[3] = {static_cast<uint32_t>(dpb),
                            static_cast<uint32_t>(bk), 1};
    UPGPT_TRY(sm90::make_map(&maps[0], qkv_ws, 3, d, qb, span));
    UPGPT_TRY(sm90::make_map(&maps[1], qkv_ws, 3, d, kb, span));
    switch (dp) {
      case 32: UPGPT_TRY((launch_flash<32, 128>(f, maps, stages, grid, stream))); break;
      case 64: UPGPT_TRY((launch_flash<64, 128>(f, maps, stages, grid, stream))); break;
      default: UPGPT_TRY((launch_flash<128, 64>(f, maps, stages, grid, stream)));
    }
  }

  {  // to_out over the heads' padded segments
    const int* p = plan + 4;
    LegArgs q = g;
    q.out = static_cast<bf16*>(out);
    q.bias = static_cast<const float*>(bo);
    q.bias_first = per_head;
    CUtensorMap maps[4];
    memset(maps, 0, sizeof(maps));
    const uint64_t od[4] = {static_cast<uint64_t>(dp),
                            static_cast<uint64_t>(T),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(B)};
    const uint32_t ob[4] = {static_cast<uint32_t>(dpb),
                            static_cast<uint32_t>(64 * p[0]), 1, 1};
    UPGPT_TRY(sm90::make_map(&maps[0], o_ws, 4, od, ob, span));
    const uint64_t wd[3] = {static_cast<uint64_t>(C),
                            static_cast<uint64_t>(dh),
                            static_cast<uint64_t>(H)};
    const uint32_t wb[3] = {64, static_cast<uint32_t>(dpb), 1};
    UPGPT_TRY(sm90::weight_map(&maps[1], wo, 3, wd, wb));
    UPGPT_TRY(product<kOut>(q, p, maps, stream));
  }
  return cudaSuccess;
}

}  // namespace

// K8: x (B, T, C); wq, wk, wv, wo (C, C) in (in, out) layout; bo (C,)
// float32; qkv_ws 3 B H T Dp and o_ws B H T Dp bf16 workspaces (Dp: dh
// rounded up to 32, 64 or 128); out (B, T, C); plan: 11 host ints
// (selfattn_leg.leg_plan_ints).
extern "C" int upgpt_selfattn_fullwidth(const void* x, const void* wq,
                                        const void* wk, const void* wv,
                                        const void* wo, const void* bo,
                                        void* qkv_ws, void* o_ws, void* out,
                                        const int* plan, int B, int T, int C,
                                        int heads, void* stream) {
  const void* w[3] = {wq, wk, wv};
  return static_cast<int>(leg(false, x, w, wo, bo, qkv_ws, o_ws, out, plan,
                              B, T, C, heads,
                              static_cast<cudaStream_t>(stream)));
}

// K9: x (B, T, C); wq_h, wk_h, wv_h (H, C, dh); wo_h (H, dh, C); the rest
// as K8's.
extern "C" int upgpt_selfattn_perhead(const void* x, const void* wq_h,
                                      const void* wk_h, const void* wv_h,
                                      const void* wo_h, const void* bo,
                                      void* qkv_ws, void* o_ws, void* out,
                                      const int* plan, int B, int T, int C,
                                      int heads, void* stream) {
  const void* w[3] = {wq_h, wk_h, wv_h};
  return static_cast<int>(leg(true, x, w, wo_h, bo, qkv_ws, o_ws, out, plan,
                              B, T, C, heads,
                              static_cast<cudaStream_t>(stream)));
}
