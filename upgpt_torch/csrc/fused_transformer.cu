// The SpatialTransformer block (depth 1) for Hopper (sm_90a), bf16 in and
// out with float32 accumulation:
//
//   GN32(eps) -> proj_in -> LN1 -> self-attn (+res) -> LN2 -> cross-attn
//   (+res) -> LN3 -> GEGLU FF (+res) -> proj_out + input
//
// Replaces upgpt_tpu/ops/fused_transformer.py::_fused_forward (_block_kernel),
// which runs the whole block per sample in one TPU program, in both of its
// variants: cross-attention K/V precomputed by the caller (sampling), or the
// context (B, Tk, Cd) projected through attn2's to_k and to_v inside the same
// call (training, kv=None).
//
// What bounds it on this card: one block per sample does not fit. At ds2
// (T=192, C=448) the bf16 weights alone are 9.2 MB, forty times a block's
// 227 KB of shared memory, and the ds1 token stream (768 x 224) needs many
// SMs to keep the card busy. The work is a chain of matrix products with
// cheap prologues and epilogues (40 M C^2 of the block's operations), so the
// block is split into eleven launches (twelve with the context projection)
// on one stream, all hand-written here:
//   (a) gn_stats_kernel: GroupNorm statistics per (sample, group), float32,
//       var = E[x^2] - E[x]^2 clamped at 0, as _block_kernel computes them;
//   (b) product_kernel: the products on the pipelined wgmma mainloop of
//       gemm_sm90.cuh, the weights fed by TMA through a ring of stages.
//       Products with a norm prologue (proj_in with the GroupNorm apply;
//       the packed QKV, the cross q and the GEGLU FF1 with a LayerNorm,
//       eps 1e-5) have K = C <= 512: a block loads its BM x C panel of A
//       into shared memory once, computes the LayerNorm's two-pass float32
//       row statistics from it (or reads (a)'s), normalises the panel in
//       place in float32 and rounds it to bf16, as the A tile was rounded
//       before, and every K step then reads its fragments from the panel.
//       Products without one (both to_out, FF2 with K = 4C, proj_out and,
//       in the training variant, the context's K/V projection) stream A
//       through the ring beside W and may split K. Epilogues run on the
//       accumulator registers: bias, the q columns' 1/sqrt(dh) scale, the
//       residual added in float32 before the one rounding, or the GEGLU
//       gate x * gelu_erf(g) with the x and gate rows of W in two
//       accumulators of the same block; the tile leaves in 16-byte stores.
//       The packed QKV product reads to_q, to_k and to_v where they lie, one
//       descriptor each; a block's N tile lies inside one piece;
//   (c) the shared attention routine of flash_attention.cu, reading head h
//       of the packed (B, T, C) activations at column offset h * dh, so no
//       head transpose is ever materialised.
// Head dims 28 and 56 need no padding in memory: (b) runs over C, and (c)
// zero-pads its D chunks in shared memory. Intermediates (~10 B*T*C bf16,
// plus 2 B*Tk*C for projected K/V) live in a workspace the caller allocates;
// the bf16 residual stream is rounded after every sub-block, as in
// _block_kernel. Tiles, splits of K and ring depths come from the caller's
// plan (upgpt_torch/ops/gemm_plan.py), checked here again.
#include "attention.cuh"
#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using sm90::kBK;

constexpr int kGroups = 32;
constexpr float kLnEps = 1e-5f;
constexpr int kMaxNormK = 512;  // widest norm prologue (the gate's C bound)
constexpr int kPlanInts = 5;    // wg, bn, splits, steps_per_split, stages

enum Prologue { kNone = 0, kLayerNorm = 1, kGroupNorm = 2 };

struct Product {
  const bf16* A;         // (M, K) row-major
  int M, N, K;
  int parts;             // W in `parts` pieces of N / parts rows each
  const bf16* bias;      // per output column, or null
  const bf16* residual;  // (M, N), or null
  bf16* out;             // (M, N)
  int gate_offset;       // GEGLU: the gate's rows of W start here
  int q_cols;            // columns [0, q_cols) are scaled by q_scale
  float q_scale;
  const bf16* gamma;     // (K) norm scale
  const bf16* beta;      // (K) norm shift
  const float* gn_stats; // (samples, 32, 2) mean, rstd
  int rows_per_sample;
  // the plan
  int wg, bn, splits, steps_per_split, stages;
  float* ws;             // split partials, [tile][split][nb][bn/2][threads]
  int* counters;         // one per tile, 0 between launches
};

// gemm_plan.product_smem
__host__ __device__ inline int product_smem(int bm, int bn, int nb, int k,
                                            bool prologue, int stages) {
  const int stage = nb * bn * 128 + (prologue ? 0 : bm * 128);
  const int panel = prologue ? bm * (k + 8) * 2 + 2 * k * 4 : 0;
  const int staging = bm * sm90::staging_pitch<bf16>(bn) * 2;
  return panel + stages * stage > staging ? panel + stages * stage : staging;
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(256)
gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int T,
                int C, float eps) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int cpg = C / kGroups;
  const bf16* xb = x + static_cast<size_t>(b) * T * C + g * cpg;
  const int n = T * cpg;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = bf(xb[static_cast<size_t>(i / cpg) * C + i % cpg]);
    s1 += v;
    s2 += v * v;
  }
  __shared__ float red[2][8];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s1 = s2 = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) {
      s1 += red[0][w];
      s2 += red[1][w];
    }
    const float mean = s1 / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.f);
    stats[(b * kGroups + g) * 2] = mean;
    stats[(b * kGroups + g) * 2 + 1] = rsqrtf(var + eps);
  }
}

// Loads the block's BM x K panel of A (rows past M zero) and normalises it
// in place: LayerNorm with two-pass float32 row statistics, or the
// GroupNorm apply from gn_stats; float32 arithmetic, one bf16 rounding.
template <int PRO>
__device__ __forceinline__ void load_panel(const Product& g, bf16* panel,
                                           float* gam, float* bet, int m0,
                                           int bm, int threads) {
  const int tid = threadIdx.x, K = g.K, P = K + 8;
  for (int k = tid; k < K; k += threads) {
    gam[k] = bf(g.gamma[k]);
    bet[k] = bf(g.beta[k]);
  }
  // every row's 16-byte pieces in flight at once (rows past M read 0)
  const int vecs = K / 8;
  for (int i = tid; i < bm * vecs; i += threads) {
    const int r = i / vecs, c = (i % vecs) * 8, m = m0 + r;
    const bool in = m < g.M;
    mma::cp_async<16>(panel + r * P + c,
                      in ? g.A + static_cast<size_t>(m) * K + c : g.A, in);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  sm90::consumer_sync(threads);
  const int warp = tid / 32, lane = tid % 32, warps = threads / 32;
  // kRows rows per warp at a time, so that their reductions overlap
  constexpr int kRows = 4;
  for (int r0 = warp; r0 < bm; r0 += kRows * warps) {
    __nv_bfloat162* row[kRows];
    bool live[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + j * warps;
      live[j] = r < bm && m0 + r < g.M;
      row[j] = reinterpret_cast<__nv_bfloat162*>(panel + (live[j] ? r : 0) * P);
    }
    if (PRO == kLayerNorm) {
      float mean[kRows], rstd[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        float acc = 0.f;
        for (int k = lane; k < K / 2; k += 32) {
          const float2 v = __bfloat1622float2(row[j][k]);
          acc += v.x + v.y;
        }
        mean[j] = acc;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) mean[j] = warp_sum(mean[j]) / K;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        float acc = 0.f;
        for (int k = lane; k < K / 2; k += 32) {
          const float2 v = __bfloat1622float2(row[j][k]);
          acc += (v.x - mean[j]) * (v.x - mean[j]) +
                 (v.y - mean[j]) * (v.y - mean[j]);
        }
        rstd[j] = acc;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        rstd[j] = rsqrtf(warp_sum(rstd[j]) / K + kLnEps);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (!live[j]) continue;
        for (int k = lane; k < K / 2; k += 32) {
          const float2 v = __bfloat1622float2(row[j][k]);
          row[j][k] = __floats2bfloat162_rn(
              (v.x - mean[j]) * rstd[j] * gam[2 * k] + bet[2 * k],
              (v.y - mean[j]) * rstd[j] * gam[2 * k + 1] + bet[2 * k + 1]);
        }
      }
    } else {
      const int cpg = K / kGroups;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (!live[j]) continue;
        const float* st = g.gn_stats +
                          static_cast<size_t>((m0 + r0 + j * warps) /
                                              g.rows_per_sample) * kGroups * 2;
        for (int k = lane; k < K / 2; k += 32) {
          const float2 v = __bfloat1622float2(row[j][k]);
          const int g0 = 2 * k / cpg, g1 = (2 * k + 1) / cpg;
          row[j][k] = __floats2bfloat162_rn(
              (v.x - st[2 * g0]) * st[2 * g0 + 1] * gam[2 * k] + bet[2 * k],
              (v.y - st[2 * g1]) * st[2 * g1 + 1] * gam[2 * k + 1] +
                  bet[2 * k + 1]);
        }
      }
    }
  }
  sm90::consumer_sync(threads);
}

// grid (parts * N tiles per piece, M tiles, splits); block 128 * (wg + 1):
// wg consumer warpgroups of 64 rows, then the producer warpgroup
template <int PRO, bool GEGLU, int BN>
__global__ void __launch_bounds__(
    sm90::block_threads(sm90::max_warpgroups(BN, GEGLU ? 2 : 1)), 1)
product_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b0,
               const __grid_constant__ CUtensorMap map_b1,
               const __grid_constant__ CUtensorMap map_b2, const Product g) {
  constexpr int NB = GEGLU ? 2 : 1;
  constexpr int R = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[sm90::kMaxStages], empty[sm90::kMaxStages];
  __shared__ int last;
  uint8_t* smem = sm90::align1024(smem_raw);

  const int threads = 128 * g.wg, bm = 64 * g.wg, K = g.K;
  const int pn = g.N / g.parts, nt = (pn + BN - 1) / BN;
  const int part = blockIdx.x / nt, n0 = (blockIdx.x % nt) * BN;
  const int m0 = blockIdx.y * bm;
  const int ksteps = (K + kBK - 1) / kBK;
  const int s0 = blockIdx.z * g.steps_per_split;
  const int steps = min(g.steps_per_split, ksteps - s0);
  const int stage_bytes = NB * BN * 128 + (PRO == kNone ? bm * 128 : 0);
  const sm90::Ring ring{smem, full, empty, g.stages, stage_bytes};
  bf16* panel = reinterpret_cast<bf16*>(smem + g.stages * stage_bytes);
  float* gam = reinterpret_cast<float*>(panel + bm * (K + 8));
  float* bet = gam + K;
  if (threadIdx.x == 0) sm90::ring_init(ring, 4 * g.wg);
  __syncthreads();

  constexpr int kMaxWg = sm90::max_warpgroups(BN, NB);
  const int wg = sm90::warpgroup_index();
  if (wg == g.wg) {  // the producer warpgroup
    sm90::producer_registers<kMaxWg>();
    if (threadIdx.x == threads) {
      const CUtensorMap* mb =
          part == 0 ? &map_b0 : part == 1 ? &map_b1 : &map_b2;
      sm90::produce(ring, steps, stage_bytes,
                    [&](int s, uint8_t* dst, uint64_t* bar) {
                      const int k0 = (s0 + s) * kBK;
                      sm90::tma_2d(dst, mb, bar, k0, n0);
                      if (GEGLU)
                        sm90::tma_2d(dst + BN * 128, mb, bar, k0,
                                     n0 + g.gate_offset);
                      if (PRO == kNone)
                        sm90::tma_2d(dst + NB * BN * 128, &map_a, bar, k0,
                                     m0);
                    });
    }
    return;
  }
  sm90::consumer_registers<kMaxWg>();

  const int lane = threadIdx.x % 32;
  const int row = wg * 64 + ((threadIdx.x / 32) % 4) * 16 + (lane & 15);
  if (PRO != kNone) load_panel<PRO>(g, panel, gam, bet, m0, bm, threads);

  float acc[NB][R];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[b][i] = 0.f;
  sm90::consume<BN, NB>(
      ring, steps, acc, [](int) {},
      [&](int s, int kk, uint8_t* stage, uint32_t(&a)[4]) {
        if ((s0 + s) * kBK + kk * 16 >= K) {  // past K (K % 16 == 0)
          a[0] = a[1] = a[2] = a[3] = 0u;
        } else if (PRO != kNone) {
          mma::ldsm_x4(a, panel + row * (K + 8) + (s0 + s) * kBK + kk * 16 +
                              (lane >> 4) * 8);
        } else {  // the stage's A box, 128-byte rows, 16-byte chunks XOR row
          const int chunk = kk * 2 + (lane >> 4);
          mma::ldsm_x4(a, reinterpret_cast<const bf16*>(
                              stage + NB * BN * 128 + row * 128 +
                              ((chunk ^ (row & 7)) << 4)));
        }
      });
  sm90::consumer_sync(threads);  // the staging tile reuses the ring

  if (g.splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* ws = g.ws + static_cast<size_t>(tile) * g.splits * NB * R * threads;
    if (!sm90::split_reduce(acc, ws, g.counters + tile, blockIdx.z, g.splits,
                            threads, &last))
      return;
  }

  constexpr int P = sm90::staging_pitch<bf16>(BN);
  bf16* staged = reinterpret_cast<bf16*>(smem) + wg * 64 * P;
  const int col0 = part * pn + n0;
  if constexpr (GEGLU) {
    // x * gelu_erf(gate), each with its bias, from the two accumulators
    const int q = lane / 4, t = lane % 4, w = (threadIdx.x / 32) % 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = w * 16 + q + 8 * h, c = 8 * j + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = acc[0][4 * j + 2 * h + e];
          float gt = acc[NB - 1][4 * j + 2 * h + e];
          if (g.bias && n0 + c < pn) {
            x += bf(g.bias[col0 + c + e]);
            gt += bf(g.bias[col0 + c + e + g.gate_offset]);
          }
          v[e] = x * (0.5f * gt * (1.f + erff(gt * 0.70710678118654752f)));
        }
        sm90::put2(staged + r * P + c, v[0], v[1]);
      }
  } else {
    sm90::for_pairs<BN>(acc[0], [&](int r, int c, float v0, float v1) {
      const int m = m0 + wg * 64 + r, col = col0 + c;
      if (m < g.M && n0 + c < pn) {
        if (col < g.q_cols) {
          v0 *= g.q_scale;
          v1 *= g.q_scale;
        }
        if (g.bias) {
          v0 += bf(g.bias[col]);
          v1 += bf(g.bias[col + 1]);
        }
        if (g.residual) {
          const float2 res = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  g.residual + static_cast<size_t>(m) * g.N + col));
          v0 += res.x;
          v1 += res.y;
        }
      }
      sm90::put2(staged + r * P + c, v0, v1);
    });
  }
  sm90::warpgroup_sync(wg);
  sm90::copy_rows<bf16, BN>(
      staged, min(BN, pn - n0), true, [&](int r) -> bf16* {
        const int m = m0 + wg * 64 + r;
        return m < g.M ? g.out + static_cast<size_t>(m) * g.N + col0
                       : nullptr;
      });
}

template <int PRO, bool GEGLU, int BN>
cudaError_t launch_bn(const Product& g, const CUtensorMap* maps,
                      cudaStream_t stream) {
  auto kernel = product_kernel<PRO, GEGLU, BN>;
  static const cudaError_t opted = sm90::allow_smem(kernel);
  if (opted != cudaSuccess) return opted;
  const int nb = GEGLU ? 2 : 1, bm = 64 * g.wg;
  const int pn = g.N / g.parts;
  const dim3 grid(g.parts * ((pn + BN - 1) / BN), (g.M + bm - 1) / bm,
                  g.splits);
  const int smem = sm90::kAlignSlack +
                   product_smem(bm, BN, nb, g.K, PRO != kNone, g.stages);
  kernel<<<grid, sm90::block_threads(g.wg), smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], g);
  return cudaGetLastError();
}

// Checks the plan against the product and the card, builds the product's
// descriptors (A's for a streamed A, one per piece of W, cached) and
// launches.
template <int PRO, bool GEGLU>
cudaError_t gemm(Product g, const int* plan, const bf16* const* W,
                 float* ws, long long ws_floats, int* counters,
                 int n_counters, cudaStream_t stream) {
  const int nb = GEGLU ? 2 : 1;
  g.wg = plan[0];
  g.bn = plan[1];
  g.splits = plan[2];
  g.steps_per_split = plan[3];
  g.stages = plan[4];
  const int bm = 64 * g.wg, pn = g.N / g.parts;
  const int ksteps = (g.K + kBK - 1) / kBK;
  if (!sm90::bn_in_menu(g.bn) || nb * g.bn > 256 || g.wg < 1 ||
      g.wg > sm90::max_warpgroups(g.bn, nb) || g.stages < sm90::kMinStages ||
      g.stages > sm90::kMaxStages || g.splits < 1 ||
      g.steps_per_split < 1 ||
      (g.splits - 1) * g.steps_per_split >= ksteps ||
      g.splits * g.steps_per_split < ksteps ||
      (PRO != kNone && (g.splits != 1 || g.K > kMaxNormK)) || g.K % 16 ||
      g.N % g.parts || pn % 8 ||
      !sm90::smem_fits(product_smem(bm, g.bn, nb, g.K, PRO != kNone,
                                    g.stages)))
    return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>(g.parts) *
                          ((pn + g.bn - 1) / g.bn) * ((g.M + bm - 1) / bm);
  if (g.splits > 1 &&
      (tiles > n_counters ||
       tiles * g.splits * nb * g.bn / 2 * 128 * g.wg > ws_floats))
    return cudaErrorInvalidValue;
  g.ws = ws;
  g.counters = counters;

  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  if (PRO == kNone) {
    const uint64_t dims[2] = {static_cast<uint64_t>(g.K),
                              static_cast<uint64_t>(g.M)};
    const uint32_t box[2] = {kBK, static_cast<uint32_t>(bm)};
    const cudaError_t e = sm90::make_map(&maps[0], g.A, 2, dims, box);
    if (e != cudaSuccess) return e;
  }
  for (int p = 0; p < g.parts; ++p) {
    // GEGLU: one piece holding the x rows and, gate_offset further, the
    // gate rows
    const uint64_t dims[2] = {static_cast<uint64_t>(g.K),
                              static_cast<uint64_t>(GEGLU ? 2 * pn : pn)};
    const uint32_t box[2] = {kBK, static_cast<uint32_t>(g.bn)};
    const cudaError_t e = sm90::weight_map(&maps[1 + p], W[p], 2, dims, box);
    if (e != cudaSuccess) return e;
  }
  switch (g.bn) {
    case 64: return launch_bn<PRO, GEGLU, 64>(g, maps, stream);
    case 128: return launch_bn<PRO, GEGLU, 128>(g, maps, stream);
    default: break;
  }
  if constexpr (!GEGLU) {
    if (g.bn == 224) return launch_bn<PRO, false, 224>(g, maps, stream);
    if (g.bn == 256) return launch_bn<PRO, false, 256>(g, maps, stream);
  }
  return cudaErrorInvalidValue;
}

Product product(const bf16* A, int M, int K, int N, bf16* out) {
  Product g = {};
  g.A = A;
  g.M = M;
  g.K = K;
  g.N = N;
  g.parts = 1;
  g.out = out;
  return g;
}

Product with_norm(Product g, const void* gamma, const void* beta) {
  g.gamma = static_cast<const bf16*>(gamma);
  g.beta = static_cast<const bf16*>(beta);
  return g;
}

AttnArgs packed_attention(const bf16* q, long long q_row, const bf16* k,
                          const bf16* v, long long kv_row, bf16* o, int B,
                          int heads, int T, int Tk, int C) {
  const int dh = C / heads;
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.B = B;
  a.H = heads;
  a.Tq = T;
  a.Tk = Tk;
  a.D = dh;
  a.sqb = q_row * T;
  a.sqh = dh;
  a.sqt = q_row;
  a.skb = a.svb = kv_row * Tk;
  a.skh = a.svh = dh;
  a.skt = a.svt = kv_row;
  a.sob = static_cast<long long>(C) * T;
  a.soh = dh;
  a.sot = C;
  a.scale = 1.f;  // q arrives pre-scaled by 1/sqrt(dh)
  return a;
}

}  // namespace

#define UPGPT_TRY(expr)                 \
  do {                                  \
    const cudaError_t e_ = (expr);      \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

// x, out: (B, T, C) bf16. Weights in nn.Linear layout (out, in), bf16:
// w_q1, w_k1, w_v1 (C, C) of attn1, w_ff1 (8C, C) with the GEGLU
// x half first, w_ff2 (C, 4C). Cross K/V: either k2, v2 precomputed
// (B, Tk, C) with ctx null, or ctx (B, Tk, ctx_dim) with attn2's w_k2, w_v2
// (C, ctx_dim) and k2, v2 null. ws: 10*B*T*C (+ 2*B*Tk*C with ctx) bf16
// workspace; stats: B*64 float32. plan: 9 x 5 host ints in
// gemm_plan.PRODUCTS order (wg, bn, splits, steps_per_split, stages; the
// context row unread without ctx); split_ws: ws_floats float32 and
// counters: n_counters int32, zero, for the products the plan splits.
extern "C" int upgpt_fused_transformer_block(
    const void* x, void* out, const void* gn_w, const void* gn_b,
    const void* w_pi, const void* b_pi, const void* ln1_w, const void* ln1_b,
    const void* w_q1, const void* w_k1, const void* w_v1, const void* w_o1,
    const void* b_o1, const void* ln2_w, const void* ln2_b, const void* w_q2,
    const void* k2, const void* v2, const void* w_o2, const void* b_o2,
    const void* ln3_w, const void* ln3_b, const void* w_ff1,
    const void* b_ff1, const void* w_ff2, const void* b_ff2,
    const void* w_po, const void* b_po, const void* ctx, const void* w_k2,
    const void* w_v2, void* ws, void* stats, const int* plan, void* split_ws,
    long long ws_floats, void* counters, int n_counters, int B, int T, int C,
    int heads, int Tk, int ctx_dim, float gn_eps, float q_scale,
    void* stream_ptr) {
  if (B <= 0 || T <= 0 || C <= 0 || C % kGroups || C > kMaxNormK ||
      heads <= 0 || C % heads || Tk <= 0 || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA reads the context in rows of 16-byte multiples
  if (ctx != nullptr ? (ctx_dim <= 0 || ctx_dim % 8 || !w_k2 || !w_v2)
                     : (!k2 || !v2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * T;
  const size_t mc = static_cast<size_t>(M) * C;
  const bf16* xin = static_cast<const bf16*>(x);
  bf16* h = static_cast<bf16*>(ws);
  bf16* h2 = h + mc;
  bf16* qkv = h2 + mc;  // (M, 3C); later the cross q as (M, C)
  bf16* att = qkv + 3 * mc;
  bf16* ff = att + mc;  // (M, 4C)
  bf16* kv = ff + 4 * mc;  // (B*Tk, 2C) projected cross K | V, with ctx
  float* st = static_cast<float*>(stats);
  float* sws = static_cast<float*>(split_ws);
  int* cnt = static_cast<int*>(counters);
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  auto row = [&](int i) { return plan + i * kPlanInts; };

  auto launch = [&]() -> cudaError_t {
    // training variant: project the context through to_k | to_v first
    const bf16* ck = w(k2);
    const bf16* cv = w(v2);
    long long kv_row = C;
    if (ctx != nullptr) {
      Product g = product(w(ctx), B * Tk, ctx_dim, 2 * C, kv);
      g.parts = 2;
      const bf16* W[2] = {w(w_k2), w(w_v2)};
      UPGPT_TRY((gemm<kNone, false>(g, row(0), W, sws, ws_floats, cnt,
                                    n_counters, stream)));
      ck = kv;
      cv = kv + C;
      kv_row = 2LL * C;
    }

    // GroupNorm statistics, then proj_in with the GroupNorm-apply prologue
    gn_stats_kernel<<<dim3(kGroups, B), 256, 0, stream>>>(xin, st, T, C, gn_eps);
    UPGPT_TRY(cudaGetLastError());
    Product g = with_norm(product(xin, M, C, C, h), gn_w, gn_b);
    g.bias = w(b_pi);
    g.gn_stats = st;
    g.rows_per_sample = T;
    const bf16* W_pi[1] = {w(w_pi)};
    UPGPT_TRY((gemm<kGroupNorm, false>(g, row(1), W_pi, sws, ws_floats, cnt,
                                       n_counters, stream)));

    // self-attention: LN1 -> packed QKV (q scaled) -> attention -> to_out + h
    g = with_norm(product(h, M, C, 3 * C, qkv), ln1_w, ln1_b);
    g.parts = 3;
    g.q_cols = C;
    g.q_scale = q_scale;
    const bf16* W_qkv[3] = {w(w_q1), w(w_k1), w(w_v1)};
    UPGPT_TRY((gemm<kLayerNorm, false>(g, row(2), W_qkv, sws, ws_floats, cnt,
                                       n_counters, stream)));
    UPGPT_TRY(upgpt_attention_launch(
        packed_attention(qkv, 3LL * C, qkv + C, qkv + 2 * C, 3LL * C, att, B,
                         heads, T, T, C),
        1, stream));
    g = product(att, M, C, C, h2);
    g.bias = w(b_o1);
    g.residual = h;
    const bf16* W_o1[1] = {w(w_o1)};
    UPGPT_TRY((gemm<kNone, false>(g, row(3), W_o1, sws, ws_floats, cnt,
                                  n_counters, stream)));

    // cross-attention on the precomputed or projected K/V
    g = with_norm(product(h2, M, C, C, qkv), ln2_w, ln2_b);
    g.q_cols = C;
    g.q_scale = q_scale;
    const bf16* W_q2[1] = {w(w_q2)};
    UPGPT_TRY((gemm<kLayerNorm, false>(g, row(4), W_q2, sws, ws_floats, cnt,
                                       n_counters, stream)));
    UPGPT_TRY(upgpt_attention_launch(
        packed_attention(qkv, C, ck, cv, kv_row, att, B, heads, T, Tk, C), 1,
        stream));
    g = product(att, M, C, C, h);
    g.bias = w(b_o2);
    g.residual = h2;
    const bf16* W_o2[1] = {w(w_o2)};
    UPGPT_TRY((gemm<kNone, false>(g, row(5), W_o2, sws, ws_floats, cnt,
                                  n_counters, stream)));

    // GEGLU feed-forward
    g = with_norm(product(h, M, C, 4 * C, ff), ln3_w, ln3_b);
    g.bias = w(b_ff1);
    g.gate_offset = 4 * C;
    const bf16* W_ff1[1] = {w(w_ff1)};
    UPGPT_TRY((gemm<kLayerNorm, true>(g, row(6), W_ff1, sws, ws_floats, cnt,
                                      n_counters, stream)));
    g = product(ff, M, 4 * C, C, h2);
    g.bias = w(b_ff2);
    g.residual = h;
    const bf16* W_ff2[1] = {w(w_ff2)};
    UPGPT_TRY((gemm<kNone, false>(g, row(7), W_ff2, sws, ws_floats, cnt,
                                  n_counters, stream)));

    // proj_out + the block's input residual
    g = product(h2, M, C, C, static_cast<bf16*>(out));
    g.bias = w(b_po);
    g.residual = xin;
    const bf16* W_po[1] = {w(w_po)};
    return gemm<kNone, false>(g, row(8), W_po, sws, ws_floats, cnt,
                              n_counters, stream);
  };
  return static_cast<int>(launch());
}
