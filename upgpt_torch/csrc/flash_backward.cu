// Exact attention backward for Hopper (sm_90a): the two passes of the
// blocked flash backward, over contiguous (B, H, T, D) tensors.
//
// Replaces upgpt_tpu/ops/flash_attention.py::_flash_backward_blocked:
//   pass 1 (_attn_bwd_dq_kernel): log2-space scores S = Q K^T * scale*log2e,
//     L = rowmax + log2(rowsum exp2(S - rowmax)), Di = rowsum(dO * O), and
//     dQ = round(dS) K * scale with dS = P * (dO V^T - Di);
//   pass 2 (_attn_bwd_dkv_kernel): P^T = exp2(K Q^T * scale*log2e - L),
//     dV = round(P^T) dO, dS^T = P^T * (V dO^T - Di), dK = round(dS^T) Q *
//     scale.
// The bf16 roundings sit where the Pallas kernels cast (dS before dQ and dK,
// P^T before dV); everything else is float32. Pass 1 forms dS from the
// normalised P = exp2(S - L), where JAX takes p * ((dp - di) * recip) with
// p = exp2(S - max) unnormalised and recip = 1 / rowsum: the same quantity,
// rounded in another order in float32.
//
// What bounds it on this card: the products. At the training path's
// (12, 8, 768, 28), padded to D = 32, the two passes run eight T x T x D
// products (S twice, dP and dQ in pass 1; S, dV, dP and dK in pass 2):
// 29 GFLOP, 0.029 ms at 989 TFLOP/s (bf16 tensor cores), against 3.3 MB of
// tensors (0.001 ms). The (T, T) score, probability and dS matrices must
// stay out of device memory.
//
// Design of the bf16 route (D <= 128): one block of four warps owns 64 rows
// of one (batch, head), queries in pass 1 and keys in pass 2, 16 per warp.
// Its own rows are staged once by cp.async and held as mma A fragments (Q
// and dO in pass 1; K and V in pass 2, read from shared memory per tile at
// D = 128 to keep registers below 255); the other operands stream through
// shared memory in double-buffered tiles of BN rows (K and V in pass 1; Q,
// dO, L and Di in pass 2). Pass 1 sweeps the keys twice: first for the
// running max and sum that give L, then for dS and dQ. Every product runs
// on mma.sync m16n8k16 (bf16 in, float32 accumulate) with operands from
// ldmatrix (.trans where the streamed tile is the k side), and every bf16
// rounding turns accumulators straight into the next product's A
// fragments. D pads to 32, 64 or 128 with zeros in shared memory; rows
// past T are zero and masked. Nothing in shared memory grows with T, so
// this route has no T limit. Nothing carries over between blocks: pass 2
// reads L and Di, which pass 1 wrote for every row. mma.sync, not wgmma;
// cp.async, not TMA.
//
// float32, and bf16 with D > 128, take the FMA passes: one block per 16
// rows keeps their (16 x T) float32 score row in shared memory, so T is
// bounded (3264 at D <= 64, 2816 at D = 512); the operand streams through
// shared memory in 64-row chunks, and the products are float32 FMAs. Pass 2
// reads L and Di from device memory, so that bf16 at (2816, 256) fits too:
// every shape JAX's dispatch gate admits fits one of the two routes.
#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

#include "mma.cuh"

namespace {

using mma::bf16;

constexpr int kMmaThreads = 128;  // four warps
constexpr int kBM = 64;           // rows a block owns

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Store this thread's two rows (r0 + g, r0 + g + 8) of a (16 x DP) float32
// accumulator, times `mul`, as bf16 rows of a contiguous (n, D) matrix.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[DP / 8][4],
                                           float mul, int row0, int n, int D,
                                           bool pairs) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + 8 * r;
    if (row >= n) continue;
    bf16* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      const float x0 = acc[j][2 * r] * mul, x1 = acc[j][2 * r + 1] * mul;
      if (pairs && col + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < D) orow[col] = __float2bfloat16(x0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DP, int BN>
struct DqTile {
  static constexpr int kP = DP + 8;  // +16 bytes: conflict-free ldmatrix
  static constexpr size_t kSmem = sizeof(bf16) * (2 * kBM * kP + 4 * BN * kP);
};

// Pass 1: one block per (64 queries, batch * head).
template <int DP, int BN>
__global__ void __launch_bounds__(kMmaThreads)
    dq_mma_kernel(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                  const bf16* dout, bf16* dq, float* lse, float* di, int n,
                  int D, float scale, float scale_log2, int vec) {
  constexpr int P = DqTile<DP, BN>::kP, NT = BN / 8, KD = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBM][P]
  bf16* Ds = Qs + kBM * P;                       // dO [kBM][P]
  bf16* Ks = Ds + kBM * P;                       // [2][BN][P]
  bf16* Vs = Ks + 2 * BN * P;                    // [2][BN][P]
  __shared__ float row_di[kBM];

  const int q0 = blockIdx.x * kBM;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  q += base; k += base; v += base; o += base; dout += base; dq += base;
  lse += static_cast<size_t>(blockIdx.y) * n;
  di += static_cast<size_t>(blockIdx.y) * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int tiles = (n + BN - 1) / BN;

  auto stage = [&](int t, bool with_v) {
    const int buf = t & 1;
    mma::load_tile<BN, DP, P, kMmaThreads>(Ks + buf * BN * P, k, D, t * BN, n,
                                           D, vec);
    if (with_v)
      mma::load_tile<BN, DP, P, kMmaThreads>(Vs + buf * BN * P, v, D, t * BN,
                                             n, D, vec);
  };
  mma::load_tile<kBM, DP, P, kMmaThreads>(Qs, q, D, q0, n, D, vec);
  mma::load_tile<kBM, DP, P, kMmaThreads>(Ds, dout, D, q0, n, D, vec);
  stage(0, false);
  mma::cp_async_commit();

  // Di = rowsum(dO * O) in float32 for the warp's rows
  for (int i = 0; i < 16; ++i) {
    const int t = q0 + r0 + i;
    float s = 0.f;
    if (t < n)
      for (int d = lane; d < D; d += 32)
        s += __bfloat162float(dout[static_cast<size_t>(t) * D + d]) *
             __bfloat162float(o[static_cast<size_t>(t) * D + d]);
    s = warp_sum(s);
    if (lane == 0) row_di[r0 + i] = s;
  }
  __syncwarp();
  const float dii[2] = {row_di[r0 + lane / 4], row_di[r0 + lane / 4 + 8]};

  uint32_t qf[KD][4], df[KD][4];
  // S = Q K^T of tile `buf`, log2-scaled, keys >= n at -inf
  auto scores = [&](float (&s)[NT][4], const bf16* Kb, int t) {
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        mma::load_bt(b, Kb, P, j * 8, kk * 16);
        mma::mma16816(s[j], qf[kk], b[0], b[1]);
        mma::mma16816(s[j + 1], qf[kk], b[2], b[3]);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * BN + j * 8 + (lane & 3) * 2 + (e & 1);
        s[j][e] = key < n ? s[j][e] * scale_log2 : -INFINITY;
      }
  };

  // sweep 1: running max and sum of exp2(S - max), float32
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage(t + 1, false);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma::load_a(qf[kk], Qs, P, r0, kk * 16);
        mma::load_a(df[kk], Ds, P, r0, kk * 16);
      }
    }
    float s[NT][4];
    scores(s, Ks + (t & 1) * BN * P, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = mma::quad_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        sum += exp2f(s[j][2 * r] - mx) + exp2f(s[j][2 * r + 1] - mx);
      l[r] = l[r] * exp2f(m[r] - mx) + sum;
      m[r] = mx;
    }
    __syncthreads();
  }
  float L[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) L[r] = m[r] + log2f(mma::quad_sum(l[r]));

  // sweep 2: dS = P * (dO V^T - Di), dQ += round(dS) K
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  stage(0, true);
  mma::cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage(t + 1, true);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + (t & 1) * BN * P;
    const bf16* Vb = Vs + (t & 1) * BN * P;
    float s[NT][4], dp[NT][4];
    scores(s, Kb, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        mma::load_bt(b, Vb, P, j * 8, kk * 16);
        mma::mma16816(dp[j], df[kk], b[0], b[1]);
        mma::mma16816(dp[j + 1], df[kk], b[2], b[3]);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2f(s[j][e] - L[e >> 1]) * (dp[j][e] - dii[e >> 1]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DP / 8; j += 2) {
        uint32_t b[4];
        mma::load_b(b, Kb, P, kk * 16, j * 8);
        mma::mma16816(acc[j], a, b[0], b[1]);
        mma::mma16816(acc[j + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  store_rows<DP>(dq, acc, scale, q0 + r0, n, D, vec >= 4);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + r0 + lane / 4 + 8 * r;
      if (t < n) {
        lse[t] = L[r];
        di[t] = dii[r];
      }
    }
  }
}

template <int DP, int BN, bool A_REGS>
struct DkvTile {
  static constexpr int kP = DP + 8;
  static constexpr size_t kSmem = sizeof(bf16) * (2 * kBM * kP + 4 * BN * kP) +
                                  sizeof(float) * 4 * BN;
};

// Pass 2: one block per (64 keys, batch * head).
template <int DP, int BN, bool A_REGS>
__global__ void __launch_bounds__(kMmaThreads)
    dkv_mma_kernel(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* lse, const float* di,
                   bf16* dk, bf16* dv, int n, int D, float scale,
                   float scale_log2, int vec) {
  constexpr int P = DkvTile<DP, BN, A_REGS>::kP, NT = BN / 8, KD = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kBM][P]
  bf16* Vs = Ks + kBM * P;                       // [kBM][P]
  bf16* Qs = Vs + kBM * P;                       // [2][BN][P]
  bf16* Ds = Qs + 2 * BN * P;                    // dO [2][BN][P]
  float* Ls = reinterpret_cast<float*>(Ds + 2 * BN * P);  // [2][BN]
  float* Is = Ls + 2 * BN;                                // Di [2][BN]

  const int k0 = blockIdx.x * kBM;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  q += base; k += base; v += base; dout += base; dk += base; dv += base;
  lse += static_cast<size_t>(blockIdx.y) * n;
  di += static_cast<size_t>(blockIdx.y) * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int tiles = (n + BN - 1) / BN;

  auto stage = [&](int t) {
    const int buf = t & 1;
    mma::load_tile<BN, DP, P, kMmaThreads>(Qs + buf * BN * P, q, D, t * BN, n,
                                           D, vec);
    mma::load_tile<BN, DP, P, kMmaThreads>(Ds + buf * BN * P, dout, D, t * BN,
                                           n, D, vec);
    for (int i = threadIdx.x; i < BN; i += kMmaThreads) {
      const int row = t * BN + i;
      const bool in = row < n;
      mma::cp_async<4>(Ls + buf * BN + i, in ? lse + row : lse, in);
      mma::cp_async<4>(Is + buf * BN + i, in ? di + row : di, in);
    }
  };
  mma::load_tile<kBM, DP, P, kMmaThreads>(Ks, k, D, k0, n, D, vec);
  mma::load_tile<kBM, DP, P, kMmaThreads>(Vs, v, D, k0, n, D, vec);
  stage(0);
  mma::cp_async_commit();

  uint32_t kf[A_REGS ? KD : 1][4], vf[A_REGS ? KD : 1][4];
  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage(t + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (A_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          mma::load_a(kf[kk], Ks, P, r0, kk * 16);
          mma::load_a(vf[kk], Vs, P, r0, kk * 16);
        }
      }
    }
    const bf16* Qb = Qs + (t & 1) * BN * P;
    const bf16* Db = Ds + (t & 1) * BN * P;
    const float* Lb = Ls + (t & 1) * BN;
    const float* Ib = Is + (t & 1) * BN;

    // S^T = K Q^T and dP^T = V dO^T over this tile's queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (A_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = kf[kk][i];
          va[i] = vf[kk][i];
        }
      } else {
        mma::load_a(ka, Ks, P, r0, kk * 16);
        mma::load_a(va, Vs, P, r0, kk * 16);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        mma::load_bt(b, Qb, P, j * 8, kk * 16);
        mma::mma16816(s[j], ka, b[0], b[1]);
        mma::mma16816(s[j + 1], ka, b[2], b[3]);
        mma::load_bt(b, Db, P, j * 8, kk * 16);
        mma::mma16816(dp[j], va, b[0], b[1]);
        mma::mma16816(dp[j + 1], va, b[2], b[3]);
      }
    }
    // P^T = exp2(S^T - L), queries >= n at 0; dS^T = P^T (dP^T - Di)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + (lane & 3) * 2 + (e & 1);
        const float p =
            t * BN + c < n ? exp2f(s[j][e] * scale_log2 - Lb[c]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Ib[c]);
      }
    // dV += round(P^T) dO, dK += round(dS^T) Q
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t da[4] = {
          mma::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
          mma::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
          mma::pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          mma::pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DP / 8; j += 2) {
        uint32_t b[4];
        mma::load_b(b, Db, P, kk * 16, j * 8);
        mma::mma16816(dva[j], pa, b[0], b[1]);
        mma::mma16816(dva[j + 1], pa, b[2], b[3]);
        mma::load_b(b, Qb, P, kk * 16, j * 8);
        mma::mma16816(dka[j], da, b[0], b[1]);
        mma::mma16816(dka[j + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  store_rows<DP>(dk, dka, scale, k0 + r0, n, D, vec >= 4);
  store_rows<DP>(dv, dva, 1.f, k0 + r0, n, D, vec >= 4);
}

// ---- the FMA passes: float32, and bf16 with D > 128 ----
constexpr int kFmaThreads = 256;
constexpr int kBQ = 16;   // the block's own rows
constexpr int kBK = 64;   // columns per staged chunk
constexpr int kDC = 32;   // head-dim chunk of the row products
constexpr int kDV = 64;   // head-dim chunk of the column products
constexpr int kRowStep = kFmaThreads / kBK;  // rows between a thread's outputs
constexpr int kRows = kBQ / kRowStep;     // outputs per thread per chunk
// opt-in shared memory per block on sm_90, less room for static arrays
constexpr size_t kSmemLimit = 232448 - 1024;

static_assert(kDV == kBK, "column-product thread mapping assumes kDV == kBK");

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: the Pallas kernels' casts before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory of either pass, in floats: S [kBQ][n_pad],
// A [kBQ][d_pad] and a staged chunk [kBK][kDV] (also holds [kBK][kDC + 1]).
size_t smem_bytes(int n, int d) {
  const size_t n_pad = round_up(n, kBK), d_pad = round_up(d, kDC);
  return sizeof(float) * (kBQ * n_pad + kBQ * d_pad + kBK * kDV);
}

// A = rows [row0, row0 + kBQ) of X (n, D), as float32, zero-padded.
template <typename T>
__device__ void load_rows(float* A, const T* X, int row0, int n, int D,
                          int d_pad) {
  for (int i = threadIdx.x; i < kBQ * d_pad; i += kFmaThreads) {
    const int r = i / d_pad, d = i % d_pad, t = row0 + r;
    A[i] = (t < n && d < D) ? to_f(X[static_cast<size_t>(t) * D + d]) : 0.f;
  }
}

// Row products: for every column col < n_pad of B (n, D) and each of this
// thread's rows r, acc = sum_d A[r][d] * B[col][d]; then epi(r, col, acc).
// A thread owns the (r, col) pairs it is handed, so epi may update S there.
template <typename T, typename Epi>
__device__ void row_products(const float* A, int d_pad, const T* B, int n,
                             int n_pad, int D, float* stage, Epi epi) {
  const int tid = threadIdx.x, j = tid % kBK, r0 = tid / kBK;
  for (int kc = 0; kc < n_pad; kc += kBK) {
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
    for (int dc = 0; dc < d_pad; dc += kDC) {
      __syncthreads();
      for (int i = tid; i < kBK * kDC; i += kFmaThreads) {
        const int jj = i / kDC, dd = i % kDC, col = kc + jj, d = dc + dd;
        stage[jj * (kDC + 1) + dd] =
            (col < n && d < D) ? to_f(B[static_cast<size_t>(col) * D + d])
                               : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kDC; ++dd) {
        const float b = stage[j * (kDC + 1) + dd];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i] += A[(r0 + i * kRowStep) * d_pad + dc + dd] * b;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) epi(r0 + i * kRowStep, kc + j, acc[i]);
  }
  __syncthreads();
}

// Column products: for each of this thread's rows r and head-dim entries d
// of B (n, D), acc = sum_col S[r][col] * B[col][d] (S rounded to T first
// when ROUND); then epi(r, d, acc) for d < D.
template <typename T, bool ROUND, typename Epi>
__device__ void col_products(const float* S, int n_pad, const T* B, int n,
                             int D, float* stage, Epi epi) {
  const int tid = threadIdx.x, dcol = tid % kDV, r0 = tid / kDV;
  for (int dv = 0; dv < D; dv += kDV) {
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < n_pad; kc += kBK) {
      __syncthreads();
      for (int i = tid; i < kBK * kDV; i += kFmaThreads) {
        const int jj = i / kDV, dd = i % kDV, col = kc + jj, d = dv + dd;
        stage[jj * kDV + dd] =
            (col < n && d < D) ? to_f(B[static_cast<size_t>(col) * D + d])
                               : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < kBK; ++jj) {
        const float b = stage[jj * kDV + dcol];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float s = S[(r0 + i * kRowStep) * n_pad + kc + jj];
          if (ROUND) s = round_to<T>(s);
          acc[i] += s * b;
        }
      }
    }
    const int d = dv + dcol;
    if (d < D) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) epi(r0 + i * kRowStep, d, acc[i]);
    }
  }
  __syncthreads();
}

// Pass 1: one block per (16 queries, batch * head).
template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
dq_fma_kernel(const T* q, const T* k, const T* v, const T* o, const T* dout,
          T* dq, float* lse, float* di, int n, int D, float scale,
          float scale_log2) {
  extern __shared__ float smem[];
  __shared__ float row_recip[kBQ], row_di[kBQ];
  const int n_pad = round_up(n, kBK), d_pad = round_up(D, kDC);
  float* S = smem;
  float* A = S + kBQ * n_pad;
  float* stage = A + kBQ * d_pad;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  q += base; k += base; v += base; o += base; dout += base; dq += base;
  lse += static_cast<size_t>(blockIdx.y) * n;
  di += static_cast<size_t>(blockIdx.y) * n;

  // S = Q K^T * scale * log2(e); padding columns at -inf
  load_rows(A, q, q0, n, D, d_pad);
  row_products(A, d_pad, k, n, n_pad, D, stage,
               [&](int r, int col, float acc) {
                 S[r * n_pad + col] = col < n ? acc * scale_log2 : -INFINITY;
               });

  // row statistics; P = exp2(S - max) in place, unnormalised, float32
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBQ; r += kFmaThreads / 32) {
    float* row = S + r * n_pad;
    float m = -INFINITY;
    for (int c = lane; c < n; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < n_pad; c += 32) {
      const float p = c < n ? exp2f(row[c] - m) : 0.f;
      s += p;
      row[c] = p;
    }
    s = warp_sum(s);
    const int t = q0 + r;
    float dsum = 0.f;
    if (t < n)
      for (int d = lane; d < D; d += 32)
        dsum += to_f(dout[static_cast<size_t>(t) * D + d]) *
                to_f(o[static_cast<size_t>(t) * D + d]);
    dsum = warp_sum(dsum);
    if (lane == 0) {
      row_recip[r] = 1.f / s;
      row_di[r] = dsum;
      if (t < n) {
        lse[t] = m + log2f(s);
        di[t] = dsum;
      }
    }
  }
  __syncthreads();

  // dS = P * ((dO V^T - Di) * recip), rounded to T, in place
  load_rows(A, dout, q0, n, D, d_pad);
  row_products(A, d_pad, v, n, n_pad, D, stage,
               [&](int r, int col, float acc) {
                 float& s = S[r * n_pad + col];
                 s = col < n ? round_to<T>(s * ((acc - row_di[r]) * row_recip[r]))
                             : 0.f;
               });

  // dQ = dS K * scale
  col_products<T, false>(S, n_pad, k, n, D, stage,
                         [&](int r, int d, float acc) {
                           const int t = q0 + r;
                           if (t < n)
                             dq[static_cast<size_t>(t) * D + d] =
                                 from_f<T>(acc * scale);
                         });
}

// Pass 2: one block per (16 keys, batch * head).
template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
dkv_fma_kernel(const T* q, const T* k, const T* v, const T* dout,
           const float* lse, const float* di, T* dk, T* dv, int n, int D,
           float scale, float scale_log2) {
  extern __shared__ float smem[];
  const int n_pad = round_up(n, kBK), d_pad = round_up(D, kDC);
  float* S = smem;
  float* A = S + kBQ * n_pad;
  float* stage = A + kBQ * d_pad;
  const int k0 = blockIdx.x * kBQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  q += base; k += base; v += base; dout += base; dk += base; dv += base;
  lse += static_cast<size_t>(blockIdx.y) * n;
  di += static_cast<size_t>(blockIdx.y) * n;

  // P^T = exp2(K Q^T * scale * log2(e) - L): normalised, float32; L and Di
  // are read where they lie, through the cache

  load_rows(A, k, k0, n, D, d_pad);
  row_products(A, d_pad, q, n, n_pad, D, stage,
               [&](int r, int col, float acc) {
                 S[r * n_pad + col] =
                     col < n ? exp2f(acc * scale_log2 - lse[col]) : 0.f;
               });

  // dV = round(P^T) dO
  col_products<T, true>(S, n_pad, dout, n, D, stage,
                        [&](int r, int d, float acc) {
                          const int t = k0 + r;
                          if (t < n)
                            dv[static_cast<size_t>(t) * D + d] = from_f<T>(acc);
                        });

  // dS^T = P^T * (V dO^T - Di), rounded to T, in place
  load_rows(A, v, k0, n, D, d_pad);
  row_products(A, d_pad, dout, n, n_pad, D, stage,
               [&](int r, int col, float acc) {
                 float& s = S[r * n_pad + col];
                 s = col < n ? round_to<T>(s * (acc - di[col])) : 0.f;
               });

  // dK = dS^T Q * scale
  col_products<T, false>(S, n_pad, q, n, D, stage,
                         [&](int r, int d, float acc) {
                           const int t = k0 + r;
                           if (t < n)
                             dk[static_cast<size_t>(t) * D + d] =
                                 from_f<T>(acc * scale);
                         });
}


struct Shape {
  int B, H, T, D;
  float scale, scale_log2;
};

cudaError_t check_shape(int B, int H, int T, int D, Shape* s) {
  if (B <= 0 || H <= 0 || T <= 0 || D <= 0 ||
      static_cast<long long>(B) * H > 65535)
    return cudaErrorInvalidValue;
  const double scale = 1.0 / sqrt(static_cast<double>(D));
  *s = {B, H, T, D, static_cast<float>(scale),
        static_cast<float>(scale * 1.4426950408889634)};
  return cudaSuccess;
}

// The tensor-core route takes bf16 up to D = 128.
bool mma_route(int is_bf16, int D) { return is_bf16 && D <= 128; }

// The widest cp.async every row of the contiguous (n, D) operands keeps
// aligned.
int copy_bytes(int D, std::initializer_list<const void*> ptrs) {
  unsigned long long mask = 2ull * D;
  for (const void* p : ptrs) mask |= reinterpret_cast<unsigned long long>(p);
  return mma::copy_bytes(mask);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DP, int BN>
cudaError_t launch_dq_mma(const Shape& s, const void* q, const void* k,
                          const void* v, const void* o, const void* dout,
                          void* dq, void* lse, void* di, cudaStream_t stream) {
  const size_t smem = DqTile<DP, BN>::kSmem;
  cudaError_t e = set_smem(dq_mma_kernel<DP, BN>, smem);
  if (e != cudaSuccess) return e;
  const int vec = copy_bytes(s.D, {q, k, v, o, dout, dq});
  const dim3 grid((s.T + kBM - 1) / kBM, s.B * s.H);
  dq_mma_kernel<DP, BN><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<float*>(lse), static_cast<float*>(di), s.T, s.D, s.scale,
      s.scale_log2, vec);
  return cudaGetLastError();
}

template <int DP, int BN, bool A_REGS>
cudaError_t launch_dkv_mma(const Shape& s, const void* q, const void* k,
                           const void* v, const void* dout, const void* lse,
                           const void* di, void* dk, void* dv,
                           cudaStream_t stream) {
  const size_t smem = DkvTile<DP, BN, A_REGS>::kSmem;
  cudaError_t e = set_smem(dkv_mma_kernel<DP, BN, A_REGS>, smem);
  if (e != cudaSuccess) return e;
  const int vec = copy_bytes(s.D, {q, k, v, dout, dk, dv});
  const dim3 grid((s.T + kBM - 1) / kBM, s.B * s.H);
  dkv_mma_kernel<DP, BN, A_REGS><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s.T, s.D, s.scale,
      s.scale_log2, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_fma(const Shape& s, const void* q, const void* k,
                          const void* v, const void* o, const void* dout,
                          void* dq, void* lse, void* di, cudaStream_t stream) {
  const size_t smem = smem_bytes(s.T, s.D);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = set_smem(dq_fma_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.T + kBQ - 1) / kBQ, s.B * s.H);
  dq_fma_kernel<T><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<float*>(lse), static_cast<float*>(di), s.T, s.D, s.scale,
      s.scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_fma(const Shape& s, const void* q, const void* k,
                           const void* v, const void* dout, const void* lse,
                           const void* di, void* dk, void* dv,
                           cudaStream_t stream) {
  const size_t smem = smem_bytes(s.T, s.D);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t e = set_smem(dkv_fma_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.T + kBQ - 1) / kBQ, s.B * s.H);
  dkv_fma_kernel<T><<<grid, kFmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), s.T, s.D, s.scale,
      s.scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Pass 1. q, k, v, o, dout, dq: contiguous (B, H, T, D), bf16 (is_bf16 = 1)
// or float32; lse, di: (B*H, T) float32 outputs.
extern "C" int upgpt_flash_backward_dq(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, void* dq, void* lse,
                                       void* di, int B, int H, int T, int D,
                                       int is_bf16, void* stream) {
  Shape s;
  cudaError_t e = check_shape(B, H, T, D, &s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_route(is_bf16, D)) {
    if (D <= 32)
      e = launch_dq_mma<32, 64>(s, q, k, v, o, dout, dq, lse, di, st);
    else if (D <= 64)
      e = launch_dq_mma<64, 64>(s, q, k, v, o, dout, dq, lse, di, st);
    else
      e = launch_dq_mma<128, 32>(s, q, k, v, o, dout, dq, lse, di, st);
  } else {
    e = is_bf16
            ? launch_dq_fma<__nv_bfloat16>(s, q, k, v, o, dout, dq, lse, di, st)
            : launch_dq_fma<float>(s, q, k, v, o, dout, dq, lse, di, st);
  }
  return static_cast<int>(e);
}

// Pass 2. q, k, v, dout, dk, dv: contiguous (B, H, T, D); lse, di from pass 1.
extern "C" int upgpt_flash_backward_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* di,
                                        void* dk, void* dv, int B, int H,
                                        int T, int D, int is_bf16,
                                        void* stream) {
  Shape s;
  cudaError_t e = check_shape(B, H, T, D, &s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_route(is_bf16, D)) {
    if (D <= 32)
      e = launch_dkv_mma<32, 64, true>(s, q, k, v, dout, lse, di, dk, dv, st);
    else if (D <= 64)
      e = launch_dkv_mma<64, 64, true>(s, q, k, v, dout, lse, di, dk, dv, st);
    else
      e = launch_dkv_mma<128, 32, false>(s, q, k, v, dout, lse, di, dk, dv,
                                         st);
  } else {
    e = is_bf16 ? launch_dkv_fma<__nv_bfloat16>(s, q, k, v, dout, lse, di, dk,
                                                dv, st)
                : launch_dkv_fma<float>(s, q, k, v, dout, lse, di, dk, dv, st);
  }
  return static_cast<int>(e);
}
