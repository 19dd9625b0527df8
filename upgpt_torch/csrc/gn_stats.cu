// Row-tiled GroupNorm(+SiLU) over NHWC for Hopper (sm_90a): the statistics
// kernels and the normalize pass.
//
// Replaces upgpt_tpu/ops/fused_gn.py::_tiled_gn_forward (_gn_stats_kernel)
// and the normalize+SiLU that function leaves to XLA (fused_gn.py:148-157):
// per image and channel, float32 sum and sum of squares over all rows; per
// group, mean and var = E[x^2] - E[x]^2 clamped at 0; then
// a = rstd * scale, b = shift - mean * a, out = x * a + b, an optional SiLU,
// and one write in x's type. It takes the GroupNorms too big for the
// one-pass kernel of csrc/fused_gn.cu: the VAE decoders' tensors, up to
// (4, 512, 384, 128) bf16, 201 MB.
//
// What bounds it on this card: bytes. The statistics read x once (4 float
// operations per value); the normalize pass reads x again and writes the
// output. Design:
// - The TPU kernel carries its per-channel sums in VMEM scratch across the
//   sequential row-tile axis of its grid. Hopper blocks run in no order, so
//   the reduction is split: blocks over (row chunk, column slab, image)
//   write per-channel partial sums to a workspace, and a second small
//   kernel sums the chunks in a fixed order and folds channels into groups.
//   No float atomics, so runs repeat bit for bit.
// - An NHWC row of 128 bf16 channels is 256 bytes, so one row would leave
//   most of a warp idle: each thread loads 16 bytes (8 bf16 or 4 float32
//   channels) and the block covers 256 / (C / 8) rows at a time, each
//   thread keeping float32 sums of its own channels in registers.
// - Chunks: enough (row chunk, image) blocks for about four per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gn_stats.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);  // values in one 16-byte load
};

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// grid (chunks, slabs, N). Slab s covers channels [s * 256 * V, ...): each
// of its `width` 16-byte columns is walked by the threads t with
// t % width == column, rows t / width, t / width + rpi, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const T* __restrict__ x, float* __restrict__ ws, int HW, int C,
               int rows_per_chunk) {
  constexpr int V = Vec<T>::n;
  __shared__ float red[2][kThreads * V];
  const int chunk = blockIdx.x, slab = blockIdx.y, n = blockIdx.z;
  const int cv = C / V;
  const int width = min(cv - slab * kThreads, kThreads);
  const int rpi = kThreads / width;
  const int t = threadIdx.x, col = t % width, r0 = t / width;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(HW, row_begin + rows_per_chunk);
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (r0 < rpi) {
    const T* base = x + static_cast<size_t>(n) * HW * C +
                    static_cast<size_t>(slab * kThreads + col) * V;
    for (int r = row_begin + r0; r < row_end; r += rpi) {
      float v[V];
      load_vec(base + static_cast<size_t>(r) * C, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += v[i];
        s2[i] += v[i] * v[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[0][t * V + i] = s1[i];
    red[1][t * V + i] = s2[i];
  }
  __syncthreads();
  float* w = ws + (static_cast<size_t>(n) * gridDim.x + chunk) * 2 * C +
             slab * kThreads * V;
  // value j of the slab: column j / V, lane j % V, summed over the rows
  for (int j = t; j < width * V; j += kThreads) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rpi; ++r) {
      a += red[0][r * width * V + j];
      b += red[1][r * width * V + j];
    }
    w[j] = a;
    w[C + j] = b;
  }
}

// grid (N); dynamic shared memory (2 C + 2 G) floats.
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ ws, float* __restrict__ out,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                int chunks, int C, int G, float cnt, float eps) {
  extern __shared__ float sh[];
  float* tot = sh;           // [2][C]
  float* grp = sh + 2 * C;   // [2][G] mean, rstd
  const int n = blockIdx.x, cpg = C / G;
  const float* w = ws + static_cast<size_t>(n) * chunks * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < chunks; ++k) {
      a += w[static_cast<size_t>(k) * 2 * C + c];
      b += w[static_cast<size_t>(k) * 2 * C + C + c];
    }
    tot[c] = a;
    tot[C + c] = b;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < cpg; ++j) {
      a += tot[g * cpg + j];
      b += tot[C + g * cpg + j];
    }
    const float mean = a / cnt;
    grp[g] = mean;
    grp[G + g] = rsqrtf(fmaxf(b / cnt - mean * mean, 0.f) + eps);
  }
  __syncthreads();
  float* o = out + static_cast<size_t>(n) * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float mean = grp[c / cpg], rstd = grp[G + c / cpg];
    if (gamma) {
      const float a = rstd * gamma[c];
      o[c] = a;
      o[C + c] = beta[c] - mean * a;
    } else {
      o[c] = mean;
      o[C + c] = rstd;
    }
  }
}

// grid-stride over 16-byte vectors of x (N, HW, C); stats (N, 2, C)
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
             const float* __restrict__ scale, const float* __restrict__ shift,
             T* __restrict__ out, long long vectors, int HW, int C,
             int with_silu) {
  constexpr int V = Vec<T>::n;
  const long long image = static_cast<long long>(HW) * C;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < vectors; i += stride) {
    const long long e = i * V;
    const int n = static_cast<int>(e / image), c0 = static_cast<int>(e % C);
    const float* st = stats + static_cast<size_t>(n) * 2 * C;
    float v[V];
    load_vec(x + e, v);
#pragma unroll
    for (int l = 0; l < V; ++l) {
      const int c = c0 + l;
      const float a = st[C + c] * scale[c];
      const float b = shift[c] - st[c] * a;
      float y = v[l] * a + b;
      if (with_silu) y = y / (1.f + expf(-y));
      v[l] = y;
    }
    store_vec(out + e, v);
  }
}

template <typename T>
cudaError_t stats(const void* x, float* ws, float* out, const float* gamma,
                  const float* beta, int N, int HW, int C, int G, int chunks,
                  float eps, cudaStream_t stream) {
  const int cv = C / Vec<T>::n;
  const int slabs = (cv + kThreads - 1) / kThreads;
  const int rows_per_chunk = (HW + chunks - 1) / chunks;
  partial_kernel<T><<<dim3(chunks, slabs, N), kThreads, 0, stream>>>(
      static_cast<const T*>(x), ws, HW, C, rows_per_chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(C) + 2 * G);
  finalize_kernel<<<N, kThreads, smem, stream>>>(
      ws, out, gamma, beta, chunks, C, G,
      static_cast<float>(HW) * static_cast<float>(C / G), eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply(const void* x, const float* st, const float* scale,
                  const float* shift, void* out, int N, int HW, int C,
                  int with_silu, cudaStream_t stream) {
  const long long vectors =
      static_cast<long long>(N) * HW * C / Vec<T>::n;
  const long long want = (vectors + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  apply_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), st, scale, shift, static_cast<T*>(out),
      vectors, HW, C, with_silu);
  return cudaGetLastError();
}

bool bad_shape(int N, int HW, int C, int G, int chunks) {
  // the finalize kernel's 2 (C + G) floats of dynamic shared memory stay
  // within the 48 KB a launch gets without opting in
  return N <= 0 || N > 65535 || HW <= 0 || C <= 0 || C % 8 || G <= 0 ||
         C % G || chunks <= 0 || chunks > HW ||
         sizeof(float) * 2 * (static_cast<size_t>(C) + G) > 48 * 1024;
}

}  // namespace

namespace upgpt {

cudaError_t group_stats(const void* x, float* ws, float* out,
                        const float* gamma, const float* beta, int N, int HW,
                        int C, int G, int chunks, float eps, int is_bf16,
                        cudaStream_t stream) {
  if (bad_shape(N, HW, C, G, chunks)) return cudaErrorInvalidValue;
  return is_bf16 ? stats<__nv_bfloat16>(x, ws, out, gamma, beta, N, HW, C, G,
                                        chunks, eps, stream)
                 : stats<float>(x, ws, out, gamma, beta, N, HW, C, G, chunks,
                                eps, stream);
}

}  // namespace upgpt

// x: contiguous (N, HW, C), bf16 (is_bf16 = 1) or float32; ws: (N, chunks,
// 2, C) float32 scratch; out: (N, 2, C) float32 [mean_c; rstd_c].
extern "C" int upgpt_gn_stats(const void* x, void* ws, void* out, int N,
                              int HW, int C, int G, int chunks, float eps,
                              int is_bf16, void* stream) {
  return static_cast<int>(upgpt::group_stats(
      x, static_cast<float*>(ws), static_cast<float*>(out), nullptr, nullptr,
      N, HW, C, G, chunks, eps, is_bf16, static_cast<cudaStream_t>(stream)));
}

// out = x * a + b (then SiLU) with a = rstd * scale, b = shift - mean * a,
// from stats (N, 2, C) [mean_c; rstd_c]; x, out: contiguous (N, HW, C) of
// one type; scale, shift: (C) float32.
extern "C" int upgpt_gn_apply(const void* x, const void* stats,
                              const void* scale, const void* shift, void* out,
                              int N, int HW, int C, int with_silu,
                              int is_bf16, void* stream) {
  if (bad_shape(N, HW, C, 1, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(stats);
  const float* a = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  return static_cast<int>(
      is_bf16 ? apply<__nv_bfloat16>(x, s, a, b, out, N, HW, C, with_silu, st)
              : apply<float>(x, s, a, b, out, N, HW, C, with_silu, st));
}
