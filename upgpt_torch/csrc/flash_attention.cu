// Exact attention for Hopper (sm_90a): softmax(Q K^T * scale) V.
//
// Replaces upgpt_tpu/ops/flash_attention.py::_flash_forward_headloop
// (_attn_kernel_headloop) and ::_flash_forward (_attn_kernel), and runs the
// two attention passes of csrc/fused_transformer.cu (K1) through
// upgpt_attention_launch.
//
// What bounds it on this card: the products. At the chain's upscale ds2,
// (4, 8, 3072, 64), the work is 4 B H T^2 D = 77.3 GFLOP against 25 MB of
// q, k, v and o, about 3,000 operations a byte: at 989 TFLOP/s (bf16 tensor
// cores) that is 0.078 ms, with the memory bound at 0.008 ms. The TPU
// kernels keep K and V resident in VMEM and take an exact row softmax; a
// Hopper block has 227 KB, so that design caps T and leaves the tensor
// cores idle.
//
// Design of the bf16 route (attention_mma_kernel): one block of four warps
// owns 64 query rows of one (batch, head); each warp owns 16 of them. Q is
// staged once in shared memory and, for D <= 128, held in registers as
// mma A fragments. K and V stream through shared memory in tiles of BK
// keys, double-buffered with cp.async (16-byte copies where the layout
// allows, 8 bytes for K1's dh = 28 heads, which start 56 bytes apart); a
// copy outside the matrix fills zeros, so D pads to the tile width with
// zeros and keys >= Tk are zero rows, masked to -inf before the max. S =
// Q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, float32
// accumulate), operands from ldmatrix. The softmax is online in the exp2
// domain with scale * log2(e) folded into the scores, as the TPU kernel
// does: each row keeps a running max and a running float32 sum of the
// unrounded p; P is rounded to bf16 straight from the S accumulators, which
// are already the A fragments of P V, and O is divided by the row sum once
// at the end. P is rounded against the running max rather than the row's
// final max: a different rounding of the same function, within a bf16 step
// per element. Nothing in shared memory grows with T. D = 512 (the VAE's
// mid AttnBlock) splits O's columns over the grid in 128-wide slices, each
// block recomputing S over the whole D with Q read from shared memory,
// 32-key tiles to fit 151 KB. mma.sync, not wgmma; cp.async, not TMA.
//
// float32 inputs take attention_fma_kernel: a (BQ x Tk) float32 score tile
// in shared memory (so Tk is bounded), an exact row softmax, float32 FMA
// products. No path calls it; it keeps JAX's float32 admission exact
// instead of rounding to TF32.
#include <math.h>

#include <initializer_list>

#include "attention.cuh"
#include "mma.cuh"

namespace {

using mma::bf16;

constexpr int kThreads = 128;  // attention_mma_kernel: four warps
constexpr int kBQ = 64;        // query rows a block owns
// opt-in shared memory per block on sm_90, less room for static arrays
constexpr size_t kSmemLimit = 232448 - 1024;

// DK: Q/K width in shared memory (D zero-padded to it); DV: O columns a
// block owns; BK: keys per staged tile; Q_REGS: Q held as A fragments.
template <int DK, int DV, int BK, bool Q_REGS>
struct MmaTile {
  static constexpr int kPq = DK + 8;  // row pitches: +16 bytes keeps the
  static constexpr int kPv = DV + 8;  // eight rows of an ldmatrix apart
  static constexpr size_t kSmem =
      sizeof(bf16) * (kBQ * kPq + 2 * BK * kPq + 2 * BK * kPv);
};

template <int DK, int DV, int BK, bool Q_REGS>
__global__ void __launch_bounds__(kThreads)
    attention_mma_kernel(AttnArgs a, int splits, int vec, float scale_log2) {
  using Tile = MmaTile<DK, DV, BK, Q_REGS>;
  constexpr int PQ = Tile::kPq, PV = Tile::kPv;
  constexpr int NT = BK / 8;   // n-tiles of S per warp
  constexpr int NO = DV / 8;   // n-tiles of O per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][PQ]
  bf16* Ks = Qs + kBQ * PQ;                      // [2][BK][PQ]
  bf16* Vs = Ks + 2 * BK * PQ;                   // [2][BK][PV]

  const int split = blockIdx.x % splits;
  const int q0 = (blockIdx.x / splits) * kBQ, d0 = split * DV;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sqb + h * a.sqh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.skb + h * a.skh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.svb + h * a.svh + d0;
  bf16* o = static_cast<bf16*>(a.o) + b * a.sob + h * a.soh + d0;
  const int dv = min(DV, a.D - d0);  // O columns of this slice
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int tiles = (a.Tk + BK - 1) / BK;

  auto stage = [&](int t) {
    const int buf = t & 1;
    mma::load_tile<BK, DK, PQ, kThreads>(Ks + buf * BK * PQ, k, a.skt, t * BK,
                                         a.Tk, a.D, vec);
    mma::load_tile<BK, DV, PV, kThreads>(Vs + buf * BK * PV, v, a.svt, t * BK,
                                         a.Tk, dv, vec);
  };
  mma::load_tile<kBQ, DK, PQ, kThreads>(Qs, q, a.sqt, q0, a.Tq, a.D, vec);
  stage(0);
  mma::cp_async_commit();

  uint32_t qf[Q_REGS ? DK / 16 : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max and sum of this thread's rows r0 + g and r0 + g + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage(t + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + (t & 1) * BK * PQ;
    const bf16* Vb = Vs + (t & 1) * BK * PV;
    if constexpr (Q_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          mma::load_a(qf[kk], Qs, PQ, r0, kk * 16);
      }
    }

    // S = Q K^T over this tile's keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t af[4];
      if constexpr (Q_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) af[i] = qf[kk][i];
      } else {
        mma::load_a(af, Qs, PQ, r0, kk * 16);
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bfr[4];
        mma::load_bt(bfr, Kb, PQ, n * 8, kk * 16);
        mma::mma16816(s[n], af, bfr[0], bfr[1]);
        mma::mma16816(s[n + 1], af, bfr[2], bfr[3]);
      }
    }

    // log2-domain scores, keys >= Tk at -inf; new running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * BK + n * 8 + (lane & 3) * 2 + (e & 1);
        const float x = key < a.Tk ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = mma::quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // p = exp2(s - m), summed unrounded; rescale O by alpha
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += bf16(P) V, P's A fragments straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pf[4] = {
          mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bfr[4];
        mma::load_b(bfr, Vb, PV, kk * 16, n * 8);
        mma::mma16816(acc[n], pf, bfr[0], bfr[1]);
        mma::mma16816(acc[n + 1], pf, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }

  // O / rowsum, rows < Tq and columns < dv only
  const bool pairs = vec >= 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = mma::quad_sum(l[r]);
    const int row = q0 + r0 + lane / 4 + 8 * r;
    if (row >= a.Tq) continue;
    bf16* orow = o + row * a.sot;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      const float x0 = acc[n][2 * r] / sum, x1 = acc[n][2 * r + 1] / sum;
      if (pairs && col + 1 < dv) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < dv) orow[col] = __float2bfloat16(x0);
        if (col + 1 < dv) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DK, int DV, int BK, bool Q_REGS>
cudaError_t launch_mma(const AttnArgs& a, int vec, cudaStream_t stream) {
  const size_t smem = MmaTile<DK, DV, BK, Q_REGS>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      attention_mma_kernel<DK, DV, BK, Q_REGS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int splits = (a.D + DV - 1) / DV;
  const dim3 grid(((a.Tq + kBQ - 1) / kBQ) * splits, a.H, a.B);
  const float scale_log2 =
      static_cast<float>(static_cast<double>(a.scale) * 1.4426950408889634);
  attention_mma_kernel<DK, DV, BK, Q_REGS>
      <<<grid, kThreads, smem, stream>>>(a, splits, vec, scale_log2);
  return cudaGetLastError();
}

// The widest cp.async every row of q, k, v and o keeps aligned.
int copy_bytes(const AttnArgs& a) {
  unsigned long long mask = 2ull * a.D;
  for (const void* p : {a.q, a.k, a.v, static_cast<const void*>(a.o)})
    mask |= reinterpret_cast<unsigned long long>(p);
  for (long long s : {a.sqb, a.sqh, a.sqt, a.skb, a.skh, a.skt, a.svb, a.svh,
                      a.svt, a.sob, a.soh, a.sot})
    mask |= 2ull * static_cast<unsigned long long>(s);
  return mma::copy_bytes(mask);
}

cudaError_t launch_bf16(const AttnArgs& a, cudaStream_t stream) {
  const int vec = copy_bytes(a);
  if (a.D <= 32) return launch_mma<32, 32, 64, true>(a, vec, stream);
  if (a.D <= 64) return launch_mma<64, 64, 64, true>(a, vec, stream);
  if (a.D <= 128) return launch_mma<128, 128, 64, true>(a, vec, stream);
  if (a.D <= 512) return launch_mma<512, 128, 32, false>(a, vec, stream);
  return cudaErrorInvalidValue;
}

// ---- the float32 route ----

constexpr int kFmaThreads = 256;
constexpr int kBK = 64;  // keys per staged chunk
constexpr int kDC = 32;  // head-dim chunk of the score product
constexpr int kDV = 64;  // head-dim chunk of the value product

static_assert(kDV == kBK, "value-product thread mapping assumes kDV == kBK");

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory of attention_fma_kernel for `bq` query rows.
size_t fma_smem_bytes(int bq, int tk, int d) {
  return sizeof(float) * (static_cast<size_t>(bq) * round_up(tk, kBK) +
                          static_cast<size_t>(bq) * round_up(d, kDC) +
                          static_cast<size_t>(kBK) * kDV);
}

// One block owns BQ query rows of one (batch, head) and keeps their (BQ x
// Tk) float32 scores in shared memory; S = Q K^T over 32-wide chunks of D
// with K staged through shared memory, an exact row softmax in place, then
// O = P V one 64-wide chunk of D at a time.
template <int BQ>
__global__ void __launch_bounds__(kFmaThreads) attention_fma_kernel(AttnArgs a) {
  constexpr int kRowStep = kFmaThreads / kBK;  // rows between a thread's outputs
  constexpr int kRows = BQ / kRowStep;         // outputs per thread per chunk
  extern __shared__ float smem[];
  __shared__ float row_inv[BQ];

  const int tk_pad = round_up(a.Tk, kBK);
  const int d_pad = round_up(a.D, kDC);
  float* S = smem;                   // [BQ][tk_pad] scores, then probabilities
  float* Qs = S + BQ * tk_pad;       // [BQ][d_pad]
  float* stage = Qs + BQ * d_pad;    // K chunk [kBK][kDC+1] or V chunk [kBK][kDV]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* q = static_cast<const float*>(a.q) + b * a.sqb + h * a.sqh;
  const float* k = static_cast<const float*>(a.k) + b * a.skb + h * a.skh;
  const float* v = static_cast<const float*>(a.v) + b * a.svb + h * a.svh;
  float* o = static_cast<float*>(a.o) + b * a.sob + h * a.soh;

  for (int i = tid; i < BQ * d_pad; i += kFmaThreads) {
    const int r = i / d_pad, d = i % d_pad, t = q0 + r;
    Qs[i] = (t < a.Tq && d < a.D) ? q[t * a.sqt + d] : 0.f;
  }

  // ---- S = scale * Q K^T, one chunk of kBK keys at a time ----
  const int j = tid % kBK;    // key within the chunk
  const int r0 = tid / kBK;   // first of this thread's rows
  for (int kc = 0; kc < tk_pad; kc += kBK) {
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
    for (int dc = 0; dc < d_pad; dc += kDC) {
      __syncthreads();
      for (int i = tid; i < kBK * kDC; i += kFmaThreads) {
        const int jj = i / kDC, dd = i % kDC;
        const int key = kc + jj, d = dc + dd;
        stage[jj * (kDC + 1) + dd] =
            (key < a.Tk && d < a.D) ? k[key * a.skt + d] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < kDC; ++dd) {
        const float kv = stage[j * (kDC + 1) + dd];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i] += Qs[(r0 + i * kRowStep) * d_pad + dc + dd] * kv;
      }
    }
    const int key = kc + j;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      S[(r0 + i * kRowStep) * tk_pad + key] =
          key < a.Tk ? acc[i] * a.scale : -INFINITY;
  }
  __syncthreads();

  // ---- exact row softmax, float32 ----
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BQ; r += kFmaThreads / 32) {
    float* row = S + r * tk_pad;
    float m = -INFINITY;
    for (int c = lane; c < a.Tk; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < tk_pad; c += 32) {
      const float p = c < a.Tk ? expf(row[c] - m) : 0.f;
      s += p;
      row[c] = p;
    }
    s = warp_sum(s);
    if (lane == 0) row_inv[r] = 1.f / s;
  }

  // ---- O = P V / rowsum, one kDV-wide chunk of D at a time ----
  const int dcol = tid % kDV;
  for (int dv = 0; dv < a.D; dv += kDV) {
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < tk_pad; kc += kBK) {
      __syncthreads();
      for (int i = tid; i < kBK * kDV; i += kFmaThreads) {
        const int jj = i / kDV, dd = i % kDV;
        const int key = kc + jj, d = dv + dd;
        stage[jj * kDV + dd] = (key < a.Tk && d < a.D) ? v[key * a.svt + d] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < kBK; ++jj) {
        const float vv = stage[jj * kDV + dcol];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          acc[i] += S[(r0 + i * kRowStep) * tk_pad + kc + jj] * vv;
      }
    }
    const int d = dv + dcol;
    if (d < a.D) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i * kRowStep, t = q0 + r;
        if (t < a.Tq) o[t * a.sot + d] = acc[i] * row_inv[r];
      }
    }
  }
}

template <int BQ>
cudaError_t launch_fma(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(BQ, a.Tk, a.D);
  cudaError_t e = cudaFuncSetAttribute(
      attention_fma_kernel<BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  attention_fma_kernel<BQ><<<grid, kFmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Long rows halve BQ to stay within the 227 KB a block may use.
cudaError_t launch_float32(const AttnArgs& a, cudaStream_t stream) {
  if (fma_smem_bytes(16, a.Tk, a.D) <= kSmemLimit)
    return launch_fma<16>(a, stream);
  if (fma_smem_bytes(8, a.Tk, a.D) <= kSmemLimit)
    return launch_fma<8>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t upgpt_attention_launch(const AttnArgs& a, int is_bf16,
                                   cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.D <= 0 ||
      a.H > 65535 || a.B > 65535)
    return cudaErrorInvalidValue;
  return is_bf16 ? launch_bf16(a, stream) : launch_float32(a, stream);
}

// Contiguous (B, H, T, D) q, k, v -> o, scale 1/sqrt(D).
extern "C" int upgpt_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int T, int D, int is_bf16, void* stream) {
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.B = B;
  a.H = H;
  a.Tq = T;
  a.Tk = T;
  a.D = D;
  const long long sh = static_cast<long long>(T) * D;
  a.sqb = a.skb = a.svb = a.sob = sh * H;
  a.sqh = a.skh = a.svh = a.soh = sh;
  a.sqt = a.skt = a.svt = a.sot = D;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  return static_cast<int>(
      upgpt_attention_launch(a, is_bf16, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* upgpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
