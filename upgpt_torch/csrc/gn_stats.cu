// Row-tiled GroupNorm(+SiLU) over NHWC for Hopper (sm_90a): the statistics
// kernel and the normalize pass.
//
// Replaces upgpt_tpu/ops/fused_gn.py::_tiled_gn_forward (_gn_stats_kernel)
// and the normalize+SiLU that function leaves to XLA (fused_gn.py:148-157):
// per image and channel, float32 sum and sum of squares over all rows; per
// group, mean and var = E[x^2] - E[x]^2 clamped at 0; then
// a = rstd * scale, b = shift - mean * a, out = x * a + b, an optional SiLU,
// and one write in x's type. It takes the GroupNorms too big for the
// one-pass kernel of csrc/fused_gn.cu: the VAE decoders' tensors, up to
// (4, 512, 384, 256) bf16, 403 MB.
//
// What bounds it on this card: bytes. The statistics read x once (4 float
// operations per value); the normalize pass reads x again and writes the
// output. Where x fits the 50 MB L2 (the kl-f8 decoder's (4, 64, 48, 512),
// 12.6 MB), the second read can be served from L2 and the floor is one read
// and one write of device memory; where it does not ((4, 512, 384, 128),
// 201 MB), two reads and one write are unavoidable: 3 x 201 MB / 3.35 TB/s
// = 0.18 ms there, against 0.12 ms for one read and one write.
//
// Design:
// - The TPU kernel carries its per-channel sums in VMEM scratch across the
//   sequential row-tile axis of its grid. Hopper blocks run in no order, so
//   blocks over (row chunk, column slab, image) write per-channel partial
//   sums to a workspace, and the block of an image that counts itself in
//   last (an int counter per image, fenced) sums that image's chunks in
//   chunk order, folds channels into groups, writes the statistics and
//   resets the counter. One launch; no float atomics, so runs repeat bit
//   for bit. The counters are per stream, so two streams never share one.
// - An NHWC row of 128 bf16 channels is 256 bytes, so one row would leave
//   most of a warp idle: each thread loads 16 bytes (8 bf16 or 4 float32
//   channels), the block covers 256 / (C / 8) rows at a time, and each
//   thread keeps float32 sums of its own channels in registers, with eight
//   independent 16-byte loads in flight (32 KB a block).
// - Chunks (ops/fused_gn.py:stats_chunks): one block for an image of at
//   most 64 row passes; otherwise about 12 passes a block, at most one
//   block per SM and, past 16, a multiple of 16, so that the last block's
//   walk stays short.
// - The last block spreads its walk over its 256 threads (four values of
//   the image's [2][C] sums each, sixteen chunks' loads in flight), then
//   all its threads fold channels into groups (csrc/gn_fold.cuh: a few
//   threads per group, each its channels in order, then a fixed
//   butterfly). An image small enough for one block
//   (ops/fused_gn.py:stats_chunks) is finalized by that block from shared
//   memory, with no workspace, fence or counter.
// - The normalize pass runs over the same (chunk, slab, image) grid in the
//   reverse order, so that the rows the statistics read last, the likeliest
//   to be in L2, are read first. Each thread keeps one 16-byte column, so
//   it computes a and b for its channels once, in registers, and walks its
//   rows with eight loads in flight; no division per element, and SiLU by
//   the fast exponential and division (__expf, __fdividef), since at the
//   kl-f8 decoder's sizes IEEE expf and division cost as much time as the
//   bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_fold.cuh"
#include "gn_stats.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowLoads = 8;     // 16-byte loads in flight per thread
constexpr int kWalkValues = 4;   // values per thread in the last block's walk
constexpr int kWalkChunks = 16;  // chunks in flight in that walk
constexpr int kApplyLoads = 8;   // rows in flight per thread when normalizing

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);  // values in one 16-byte load
};

__device__ __forceinline__ void unpack(const uint4& u, __nv_bfloat16*,
                                       float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float*, float* v) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
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

// The thread's place in a (chunk, slab, image) block: slab s covers the
// 16-byte columns [s * 256, ...); each of its `width` columns is walked by
// the threads t with t % width == column, rows t / width, + rpi, ...
struct Lanes {
  int width, rpi, col, r0;
  __device__ Lanes(int cv, int slab, int t) {
    width = min(cv - slab * kThreads, kThreads);
    rpi = kThreads / width;
    col = t % width;
    r0 = t / width;
  }
};

// The last block's walk: tot[j] = the sum over chunks k, in order, of
// p[k * c2 + j], for j < c2; each thread takes four values at once with
// sixteen chunks' loads in flight.
__device__ __forceinline__ void walk_chunks(const float* __restrict__ p,
                                            float* tot, int chunks, int c2,
                                            int t) {
  for (int j0 = t; j0 < c2; j0 += kWalkValues * kThreads) {
    float acc[kWalkValues];
#pragma unroll
    for (int q = 0; q < kWalkValues; ++q) acc[q] = 0.f;
    for (int k0 = 0; k0 < chunks; k0 += kWalkChunks) {
      float v[kWalkChunks][kWalkValues];
#pragma unroll
      for (int u = 0; u < kWalkChunks; ++u)
#pragma unroll
        for (int q = 0; q < kWalkValues; ++q) {
          const int j = j0 + q * kThreads, k = k0 + u;
          v[u][q] = k < chunks && j < c2
                        ? __ldcg(p + static_cast<size_t>(k) * c2 + j)
                        : 0.f;
        }
#pragma unroll
      for (int u = 0; u < kWalkChunks; ++u)
#pragma unroll
        for (int q = 0; q < kWalkValues; ++q) acc[q] += v[u][q];
    }
#pragma unroll
    for (int q = 0; q < kWalkValues; ++q)
      if (j0 + q * kThreads < c2) tot[j0 + q * kThreads] = acc[q];
  }
}

// grid (chunks, slabs, N); dynamic shared memory (2 C + 2 G) floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tiled_stats_kernel(const T* __restrict__ x, float* __restrict__ ws,
                   float* __restrict__ out, const float* __restrict__ gamma,
                   const float* __restrict__ beta, int* __restrict__ counters,
                   int HW, int C, int G, int rows_per_chunk, float cnt,
                   float eps) {
  constexpr int V = Vec<T>::n;
  __shared__ float red[2][kThreads * V];
  __shared__ int last;
  extern __shared__ float sh[];
  const int chunk = blockIdx.x, slab = blockIdx.y, n = blockIdx.z;
  const int chunks = gridDim.x, t = threadIdx.x;
  const Lanes ln(C / V, slab, t);
  const int row_end = min(HW, (chunk + 1) * rows_per_chunk);
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (ln.r0 < ln.rpi) {
    const T* base = x + static_cast<size_t>(n) * HW * C +
                    static_cast<size_t>(slab * kThreads + ln.col) * V;
    // rows r, r + rpi, ... in order; a row past the chunk adds zeros
    for (int r = chunk * rows_per_chunk + ln.r0; r < row_end;
         r += kRowLoads * ln.rpi) {
      uint4 raw[kRowLoads];
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        const int rr = r + u * ln.rpi;
        raw[u] = rr < row_end ? __ldg(reinterpret_cast<const uint4*>(
                                    base + static_cast<size_t>(rr) * C))
                              : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kRowLoads; ++u) {
        float v[V];
        unpack(raw[u], static_cast<T*>(nullptr), v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += v[i];
          s2[i] += v[i] * v[i];
        }
      }
    }
  }
  // 16-byte stores (scalar ones at a stride of V floats would conflict V
  // ways in the banks)
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    *reinterpret_cast<float4*>(&red[0][t * V + i]) =
        make_float4(s1[i], s1[i + 1], s1[i + 2], s1[i + 3]);
    *reinterpret_cast<float4*>(&red[1][t * V + i]) =
        make_float4(s2[i], s2[i + 1], s2[i + 2], s2[i + 3]);
  }
  __syncthreads();
  // a block that is the whole image finalizes it from shared memory,
  // with no workspace, fence or counter
  const bool single = chunks * gridDim.y == 1;
  float* tot = sh;          // [2][C]: channel sums, chunks in order
  float* grp = sh + 2 * C;  // [2][G]: group sums, then mean, rstd
  const size_t image = static_cast<size_t>(n) * chunks * 2 * C;
  float* w = ws + image + static_cast<size_t>(chunk) * 2 * C +
             slab * kThreads * V;
  // value j of the slab: column j / V, lane j % V, summed over the row lanes
  for (int j = t; j < ln.width * V; j += kThreads) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < ln.rpi; ++r) {
      a += red[0][r * ln.width * V + j];
      b += red[1][r * ln.width * V + j];
    }
    if (single) {
      tot[j] = a;
      tot[C + j] = b;
    } else {
      __stcg(w + j, a);
      __stcg(w + C + j, b);
    }
  }
  if (!single) {
    // count in; the last block of the image finalizes it
    __threadfence();
    __syncthreads();
    if (t == 0)
      last = atomicAdd(counters + n, 1) == chunks * gridDim.y - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    walk_chunks(ws + image, tot, chunks, 2 * C, t);
  }
  __syncthreads();
  upgpt::fold_groups(tot, 1, 0, C, G, grp);  // grp: group sums
  __syncthreads();
  for (int g = t; g < G; g += kThreads) {
    const float mean = grp[g] / cnt;
    const float var = fmaxf(grp[G + g] / cnt - mean * mean, 0.f);
    grp[g] = mean;
    grp[G + g] = rsqrtf(var + eps);
  }
  __syncthreads();
  float* o = out + static_cast<size_t>(n) * 2 * C;
  const int cpg = C / G;
  for (int c = t; c < C; c += kThreads) {
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
  if (t == 0 && !single) counters[n] = 0;
}

// grid (chunks, slabs, N), walked in reverse; x, out (N, HW, C); stats
// (N, 2, C) [mean_c; rstd_c]
template <typename T>
__global__ void __launch_bounds__(kThreads)
tiled_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, T* __restrict__ out,
                   int HW, int C, int rows_per_chunk, int with_silu) {
  constexpr int V = Vec<T>::n;
  const int chunk = gridDim.x - 1 - blockIdx.x, slab = blockIdx.y;
  const int n = gridDim.z - 1 - blockIdx.z;
  const Lanes ln(C / V, slab, threadIdx.x);
  if (ln.r0 >= ln.rpi) return;
  const int c0 = (slab * kThreads + ln.col) * V;
  const float* st = stats + static_cast<size_t>(n) * 2 * C;
  float a[V], b[V], mean[V];  // 16-byte loads of the thread's channels
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 r = *reinterpret_cast<const float4*>(st + C + c0 + i);
    const float4 s = *reinterpret_cast<const float4*>(scale + c0 + i);
    *reinterpret_cast<float4*>(mean + i) =
        *reinterpret_cast<const float4*>(st + c0 + i);
    *reinterpret_cast<float4*>(b + i) =
        *reinterpret_cast<const float4*>(shift + c0 + i);
    a[i] = r.x * s.x;
    a[i + 1] = r.y * s.y;
    a[i + 2] = r.z * s.z;
    a[i + 3] = r.w * s.w;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) b[i] -= mean[i] * a[i];
  const size_t base = static_cast<size_t>(n) * HW * C + c0;
  const int row_end = min(HW, (chunk + 1) * rows_per_chunk);
  for (int r = chunk * rows_per_chunk + ln.r0; r < row_end;
       r += kApplyLoads * ln.rpi) {
    uint4 raw[kApplyLoads];
#pragma unroll
    for (int u = 0; u < kApplyLoads; ++u) {
      const int rr = r + u * ln.rpi;
      if (rr < row_end)
        raw[u] = *reinterpret_cast<const uint4*>(
            x + base + static_cast<size_t>(rr) * C);
    }
#pragma unroll
    for (int u = 0; u < kApplyLoads; ++u) {
      const int rr = r + u * ln.rpi;
      if (rr >= row_end) break;
      float v[V];
      unpack(raw[u], static_cast<T*>(nullptr), v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float y = v[i] * a[i] + b[i];
        if (with_silu) y = __fdividef(y, 1.f + __expf(-y));
        v[i] = y;
      }
      store_vec(out + base + static_cast<size_t>(rr) * C, v);
    }
  }
}

int slabs_of(int C, size_t itemsize) {
  const int cv = static_cast<int>(C * itemsize / 16);
  return (cv + kThreads - 1) / kThreads;
}

template <typename T>
cudaError_t stats(const void* x, float* ws, float* out, const float* gamma,
                  const float* beta, int* counters, int N, int HW, int C,
                  int G, int chunks, float eps, cudaStream_t stream) {
  const int rows_per_chunk = (HW + chunks - 1) / chunks;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(C) + 2 * G);
  tiled_stats_kernel<T>
      <<<dim3(chunks, slabs_of(C, sizeof(T)), N), kThreads, smem, stream>>>(
          static_cast<const T*>(x), ws, out, gamma, beta, counters, HW, C, G,
          rows_per_chunk,
          static_cast<float>(HW) * static_cast<float>(C / G), eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply(const void* x, const float* st, const float* scale,
                  const float* shift, void* out, int N, int HW, int C,
                  int chunks, int with_silu, cudaStream_t stream) {
  const int rows_per_chunk = (HW + chunks - 1) / chunks;
  tiled_apply_kernel<T>
      <<<dim3(chunks, slabs_of(C, sizeof(T)), N), kThreads, 0, stream>>>(
          static_cast<const T*>(x), st, scale, shift, static_cast<T*>(out),
          HW, C, rows_per_chunk, with_silu);
  return cudaGetLastError();
}

bool bad_shape(int N, int HW, int C, int G, int chunks) {
  // the last block's 2 (C + G) floats of dynamic shared memory stay within
  // the 48 KB a launch gets without opting in, beside the 16 KB of `red`
  return N <= 0 || N > 65535 || HW <= 0 || C <= 0 || C % 8 || G <= 0 ||
         C % G || chunks <= 0 || chunks > HW ||
         sizeof(float) * 2 * (static_cast<size_t>(C) + G) > 32 * 1024;
}

}  // namespace

namespace upgpt {

cudaError_t group_stats(const void* x, float* ws, float* out,
                        const float* gamma, const float* beta, int* counters,
                        int N, int HW, int C, int G, int chunks, float eps,
                        int is_bf16, cudaStream_t stream) {
  if (bad_shape(N, HW, C, G, chunks) || counters == nullptr ||
      (gamma == nullptr) != (beta == nullptr))
    return cudaErrorInvalidValue;
  return is_bf16 ? stats<__nv_bfloat16>(x, ws, out, gamma, beta, counters, N,
                                        HW, C, G, chunks, eps, stream)
                 : stats<float>(x, ws, out, gamma, beta, counters, N, HW, C,
                                G, chunks, eps, stream);
}

}  // namespace upgpt

// x: contiguous (N, HW, C), bf16 (is_bf16 = 1) or float32; ws: (N, chunks,
// 2, C) float32 scratch; counters: N int32, zero, reset by the launch;
// out: (N, 2, C) float32, [mean_c; rstd_c], or with gamma and beta (C
// float32 each) [a_c; b_c].
extern "C" int upgpt_gn_stats(const void* x, void* ws, void* out,
                              const void* gamma, const void* beta,
                              void* counters, int N, int HW, int C, int G,
                              int chunks, float eps, int is_bf16,
                              void* stream) {
  return static_cast<int>(upgpt::group_stats(
      x, static_cast<float*>(ws), static_cast<float*>(out),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<int*>(counters), N, HW, C, G, chunks, eps, is_bf16,
      static_cast<cudaStream_t>(stream)));
}

// out = x * a + b (then SiLU) with a = rstd * scale, b = shift - mean * a,
// from stats (N, 2, C) [mean_c; rstd_c]; x, out: contiguous (N, HW, C) of
// one type; scale, shift: (C) float32, 16-byte aligned like stats; chunks:
// the statistics' row chunks.
extern "C" int upgpt_gn_apply(const void* x, const void* stats,
                              const void* scale, const void* shift, void* out,
                              int N, int HW, int C, int chunks, int with_silu,
                              int is_bf16, void* stream) {
  if (bad_shape(N, HW, C, 1, chunks) ||
      (reinterpret_cast<uintptr_t>(stats) | reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(shift)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(stats);
  const float* a = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  return static_cast<int>(
      is_bf16 ? apply<__nv_bfloat16>(x, s, a, b, out, N, HW, C, chunks,
                                     with_silu, st)
              : apply<float>(x, s, a, b, out, N, HW, C, chunks, with_silu,
                             st));
}
