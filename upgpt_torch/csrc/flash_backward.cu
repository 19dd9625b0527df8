// Exact attention backward for Hopper (sm_90a): the two passes of the
// blocked flash backward, over contiguous (B, H, T, D) tensors.
//
// Replaces upgpt_tpu/ops/flash_attention.py::_flash_backward_blocked:
//   pass 1 (_attn_bwd_dq_kernel): log2-space scores S = Q K^T * scale*log2e,
//     P = exp2(S - rowmax), L = rowmax + log2(rowsum), Di = rowsum(dO * O),
//     dS = P * ((dO V^T - Di) / rowsum) rounded to the input type, and
//     dQ = dS K * scale;
//   pass 2 (_attn_bwd_dkv_kernel): P^T = exp2(K Q^T * scale*log2e - L),
//     dV = round(P^T) dO, dS^T = P^T * (V dO^T - Di) rounded to the input
//     type, and dK = dS^T Q * scale.
// The bf16 roundings sit where the Pallas kernels cast (dS before dQ and dK,
// P^T before dV); everything else is float32.
//
// What bounds it on this card: at the training path's (12, 8, 768, 28) the
// work is 14 T^2 D multiply-adds per (batch, head), and the (T, T) score,
// probability and dS matrices must stay out of device memory. Design: one
// block owns 16 rows (queries in pass 1, keys in pass 2) of one (batch, head)
// and keeps their (16 x T) float32 row of scores in shared memory (48 KB at
// T = 768), as the forward kernel does. The other operand streams through
// shared memory in 64-row chunks: "row products" (the block's rows against
// every column, reducing over D in 32-wide chunks) build S, dP and the
// P^T / dS^T tiles, and "column products" (the 16 x T tile against a (T, D)
// operand, D in 64-wide chunks) build dQ, dK and dV. D = 28 is zero-padded to
// 32 in shared memory. Nothing carries over between blocks: the TPU grid
// walked q-blocks in order, Hopper blocks run in any order, so pass 2 reads
// L and Di, which pass 1 wrote to device memory for every row. The products
// are plain float32 FMAs; tensor-core tiles are later work.
#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 16;   // the block's own rows
constexpr int kBK = 64;   // columns per staged chunk
constexpr int kDC = 32;   // head-dim chunk of the row products
constexpr int kDV = 64;   // head-dim chunk of the column products
constexpr int kRowStep = kThreads / kBK;  // rows between a thread's outputs
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
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory, in floats: S [kBQ][n_pad], A [kBQ][d_pad], a staged
// chunk [kBK][kDV] (also holds [kBK][kDC + 1]), and with `stats` the L and
// Di rows [n_pad] each.
size_t smem_bytes(int n, int d, bool stats) {
  const size_t n_pad = round_up(n, kBK), d_pad = round_up(d, kDC);
  return sizeof(float) * (kBQ * n_pad + kBQ * d_pad + kBK * kDV +
                          (stats ? 2 * n_pad : 0));
}

// A = rows [row0, row0 + kBQ) of X (n, D), as float32, zero-padded.
template <typename T>
__device__ void load_rows(float* A, const T* X, int row0, int n, int D,
                          int d_pad) {
  for (int i = threadIdx.x; i < kBQ * d_pad; i += kThreads) {
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
      for (int i = tid; i < kBK * kDC; i += kThreads) {
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
      for (int i = tid; i < kBK * kDV; i += kThreads) {
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
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* q, const T* k, const T* v, const T* o, const T* dout,
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
  for (int r = warp; r < kBQ; r += kThreads / 32) {
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
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* q, const T* k, const T* v, const T* dout,
           const float* lse, const float* di, T* dk, T* dv, int n, int D,
           float scale, float scale_log2) {
  extern __shared__ float smem[];
  const int n_pad = round_up(n, kBK), d_pad = round_up(D, kDC);
  float* S = smem;
  float* A = S + kBQ * n_pad;
  float* stage = A + kBQ * d_pad;
  float* Ls = stage + kBK * kDV;
  float* Ds = Ls + n_pad;
  const int k0 = blockIdx.x * kBQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * D;
  q += base; k += base; v += base; dout += base; dk += base; dv += base;
  lse += static_cast<size_t>(blockIdx.y) * n;
  di += static_cast<size_t>(blockIdx.y) * n;

  for (int i = threadIdx.x; i < n_pad; i += kThreads) {
    Ls[i] = i < n ? lse[i] : INFINITY;
    Ds[i] = i < n ? di[i] : 0.f;
  }
  // P^T = exp2(K Q^T * scale * log2(e) - L): normalised, float32
  load_rows(A, k, k0, n, D, d_pad);
  row_products(A, d_pad, q, n, n_pad, D, stage,
               [&](int r, int col, float acc) {
                 S[r * n_pad + col] =
                     col < n ? exp2f(acc * scale_log2 - Ls[col]) : 0.f;
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
                 s = col < n ? round_to<T>(s * (acc - Ds[col])) : 0.f;
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

cudaError_t check_shape(int B, int H, int T, int D, bool stats, Shape* s) {
  if (B <= 0 || H <= 0 || T <= 0 || D <= 0 ||
      static_cast<long long>(B) * H > 65535 ||
      smem_bytes(T, D, stats) > kSmemLimit)
    return cudaErrorInvalidValue;
  const double scale = 1.0 / sqrt(static_cast<double>(D));
  *s = {B, H, T, D, static_cast<float>(scale),
        static_cast<float>(scale * 1.4426950408889634)};
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dq(const Shape& s, const void* q, const void* k,
                      const void* v, const void* o, const void* dout,
                      void* dq, void* lse, void* di, cudaStream_t stream) {
  const size_t smem = smem_bytes(s.T, s.D, false);
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((s.T + kBQ - 1) / kBQ, s.B * s.H);
  dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq),
      static_cast<float*>(lse), static_cast<float*>(di), s.T, s.D, s.scale,
      s.scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const Shape& s, const void* q, const void* k,
                       const void* v, const void* dout, const void* lse,
                       const void* di, void* dk, void* dv,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes(s.T, s.D, true);
  cudaError_t e = cudaFuncSetAttribute(
      dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((s.T + kBQ - 1) / kBQ, s.B * s.H);
  dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
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
  cudaError_t e = check_shape(B, H, T, D, false, &s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_dq<__nv_bfloat16>(s, q, k, v, o, dout, dq, lse, di, st)
              : launch_dq<float>(s, q, k, v, o, dout, dq, lse, di, st));
}

// Pass 2. q, k, v, dout, dk, dv: contiguous (B, H, T, D); lse, di from pass 1.
extern "C" int upgpt_flash_backward_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* di,
                                        void* dk, void* dv, int B, int H,
                                        int T, int D, int is_bf16,
                                        void* stream) {
  Shape s;
  cudaError_t e = check_shape(B, H, T, D, true, &s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16
          ? launch_dkv<__nv_bfloat16>(s, q, k, v, dout, lse, di, dk, dv, st)
          : launch_dkv<float>(s, q, k, v, dout, lse, di, dk, dv, st));
}
