// Exact attention for Hopper (sm_90a): softmax(Q K^T / sqrt(D)) V.
//
// Replaces upgpt_tpu/ops/flash_attention.py::_flash_forward_headloop
// (_attn_kernel_headloop) and ::_flash_forward (_attn_kernel): scores, row
// max and row sum in float32, the whole key row resident, probabilities cast
// to the input type before the value product, and the output divided by the
// row sum at the end.
//
// What bounds it on this card: the main path's shape is the VAE decoder's
// mid AttnBlock, (B, 1, 768, 512). A 512-wide row pair of Q and K does not fit
// one block's registers, and the (T, T) score matrix must stay out of device
// memory. Design: one block owns BQ query rows of one (batch, head). It keeps
// its Q rows and a (BQ x Tk) float32 score tile in shared memory (48 KB for
// 16 x 768), accumulates S = Q K^T over 32-wide chunks of D with K staged
// through shared memory, takes an exact row softmax in place, then forms
// O = P V one 64-wide chunk of D at a time with V staged the same way. Any D
// works: the chunks are zero-padded in shared memory. The products are plain
// float32 FMAs, so bf16 and float32 inputs share one code path; tensor-core
// tiles are later work. Long rows (Tk > ~3000) halve BQ to stay within the
// 227 KB a block may use.
#include <math.h>

#include "attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;  // keys per staged chunk
constexpr int kDC = 32;  // head-dim chunk of the score product
constexpr int kDV = 64;  // head-dim chunk of the value product
// opt-in shared memory per block on sm_90, less room for static arrays
constexpr size_t kSmemLimit = 232448 - 1024;

static_assert(kDV == kBK, "value-product thread mapping assumes kDV == kBK");

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int BQ>
__global__ void __launch_bounds__(kThreads) attention_kernel(AttnArgs a) {
  constexpr int kRowStep = kThreads / kBK;   // rows between a thread's outputs
  constexpr int kRows = BQ / kRowStep;       // outputs per thread per chunk
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
  const T* q = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
  const T* k = static_cast<const T*>(a.k) + b * a.skb + h * a.skh;
  const T* v = static_cast<const T*>(a.v) + b * a.svb + h * a.svh;
  T* o = static_cast<T*>(a.o) + b * a.sob + h * a.soh;

  for (int i = tid; i < BQ * d_pad; i += kThreads) {
    const int r = i / d_pad, d = i % d_pad, t = q0 + r;
    Qs[i] = (t < a.Tq && d < a.D) ? to_f(q[t * a.sqt + d]) : 0.f;
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
      for (int i = tid; i < kBK * kDC; i += kThreads) {
        const int jj = i / kDC, dd = i % kDC;
        const int key = kc + jj, d = dc + dd;
        stage[jj * (kDC + 1) + dd] =
            (key < a.Tk && d < a.D) ? to_f(k[key * a.skt + d]) : 0.f;
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

  // ---- exact row softmax; the sum stays float32, P is rounded to T ----
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BQ; r += kThreads / 32) {
    float* row = S + r * tk_pad;
    float m = -INFINITY;
    for (int c = lane; c < a.Tk; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < tk_pad; c += 32) {
      const float p = c < a.Tk ? expf(row[c] - m) : 0.f;
      s += p;
      row[c] = to_f(from_f<T>(p));
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
      for (int i = tid; i < kBK * kDV; i += kThreads) {
        const int jj = i / kDV, dd = i % kDV;
        const int key = kc + jj, d = dv + dd;
        stage[jj * kDV + dd] =
            (key < a.Tk && d < a.D) ? to_f(v[key * a.svt + d]) : 0.f;
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
        if (t < a.Tq) o[t * a.sot + d] = from_f<T>(acc[i] * row_inv[r]);
      }
    }
  }
}

template <typename T, int BQ>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = upgpt_attention_smem_bytes(BQ, a.Tk, a.D);
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<T, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  attention_kernel<T, BQ><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

size_t upgpt_attention_smem_bytes(int bq, int tk, int d) {
  return sizeof(float) * (static_cast<size_t>(bq) * round_up(tk, kBK) +
                          static_cast<size_t>(bq) * round_up(d, kDC) +
                          static_cast<size_t>(kBK) * kDV);
}

cudaError_t upgpt_attention_launch(const AttnArgs& a, int is_bf16,
                                   cudaStream_t stream) {
  if (a.B <= 0 || a.H <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.D <= 0 ||
      a.H > 65535 || a.B > 65535)
    return cudaErrorInvalidValue;
  const bool wide = upgpt_attention_smem_bytes(16, a.Tk, a.D) <= kSmemLimit;
  if (!wide && upgpt_attention_smem_bytes(8, a.Tk, a.D) > kSmemLimit)
    return cudaErrorInvalidValue;
  if (is_bf16)
    return wide ? launch<__nv_bfloat16, 16>(a, stream)
                : launch<__nv_bfloat16, 8>(a, stream);
  return wide ? launch<float, 16>(a, stream) : launch<float, 8>(a, stream);
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
