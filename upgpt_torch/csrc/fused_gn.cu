// One-pass GroupNorm (+SiLU) over NHWC for Hopper (sm_90a).
//
// Replaces upgpt_tpu/ops/fused_gn.py::_fused_gn_forward (_gn_kernel): per
// image and group, float32 sum and sum of squares, var = E[x^2] - E[x]^2,
// then (x - mean) * rstd * scale + shift, optionally x * sigmoid(x), written
// once in the input type. The variance is clamped at 0 as the plain
// group_norm does (ops/basic.py); _gn_kernel does not clamp, which only
// matters where rounding would drive E[x^2] - E[x]^2 below zero.
//
// What bounds it on this card: bytes. It does ~10 float operations per
// element and must read and write the activation once each (the U-Net's
// ResBlock inputs at batch 12: 0.6 to 12.4 MB in bf16). Design: one block per
// (image, group) stages the group's H*W x C/G values in shared memory as
// float32 (at most 112 KB, see fused_group_norm_qualifies), so the
// activation is read from device memory once, not once for the statistics
// and again for the output. A group's channels are C/G contiguous values of
// each NHWC row (7 to 56 on the U-Net), so the loads are short runs; widening
// them is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// opt-in shared memory per block on sm_90, less room for static arrays
constexpr size_t kSmemLimit = 232448 - 1024;

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_kernel(const T* __restrict__ x, const float* __restrict__ scale,
          const float* __restrict__ shift, T* __restrict__ out, int HW, int C,
          int G, float eps, int with_silu) {
  extern __shared__ float vals[];  // [HW * cpg]
  __shared__ float red[2][kThreads / 32];
  const int g = blockIdx.x, cpg = C / G;
  const size_t base = static_cast<size_t>(blockIdx.y) * HW * C + g * cpg;
  const int count = HW * cpg;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const float v = to_f(x[base + static_cast<size_t>(i / cpg) * C + i % cpg]);
    vals[i] = v;
    s1 += v;
    s2 += v * v;
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  s1 = s2 = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) {
    s1 += red[0][w];
    s2 += red[1][w];
  }
  const float mean = s1 / count;
  const float rstd = rsqrtf(fmaxf(s2 / count - mean * mean, 0.f) + eps);
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int c = g * cpg + i % cpg;
    float y = (vals[i] - mean) * rstd * scale[c] + shift[c];
    if (with_silu) y = y / (1.f + expf(-y));
    out[base + static_cast<size_t>(i / cpg) * C + i % cpg] = from_f<T>(y);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   void* out, int N, int HW, int C, int G, float eps,
                   int with_silu, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(HW) * (C / G);
  cudaError_t e = cudaFuncSetAttribute(
      gn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  gn_kernel<T><<<dim3(G, N), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(out), HW, C, G, eps,
      with_silu);
  return cudaGetLastError();
}

}  // namespace

// x, out: contiguous (N, HW, C), bf16 (is_bf16 = 1) or float32; scale,
// shift: (C) float32.
extern "C" int upgpt_fused_group_norm(const void* x, const void* scale,
                                      const void* shift, void* out, int N,
                                      int HW, int C, int G, float eps,
                                      int with_silu, int is_bf16,
                                      void* stream) {
  if (N <= 0 || N > 65535 || HW <= 0 || C <= 0 || G <= 0 || C % G ||
      sizeof(float) * static_cast<size_t>(HW) * (C / G) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(x, scale, shift, out, N, HW, C, G, eps,
                                      with_silu, st)
              : launch<float>(x, scale, shift, out, N, HW, C, G, eps,
                              with_silu, st));
}
