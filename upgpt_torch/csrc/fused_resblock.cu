// The ResBlock half-step GroupNorm(32) + SiLU + 3x3 SAME conv over NHWC for
// Hopper (sm_90a), bf16 operands with float32 accumulation.
//
// Replaces upgpt_tpu/ops/fused_resblock.py::_fused_forward (_kernel), which
// keeps one whole image, a zero-padded copy of its activation and the output
// in VMEM and runs the conv as nine shifted (H*W, C) @ (C, O) products.
//
// What bounds it on this card: operations at the U-Net's widths (2 B H W 9 C
// O, 14.5 GFLOP for (4, 32, 24, 512) -> 512, against 6.4 MB of activations
// and 4.7 MB of weights). A 32x24x672 bf16 image alone is 1 MB, against 227
// KB of shared memory per block, so nothing is held per image. Two steps:
// (1) the GroupNorm statistics of csrc/gn_stats.cu, written as per-image,
//     per-channel affine coefficients a = rstd * gamma, b = beta - mean * a;
// (2) an implicit GEMM with M = B*H*W pixels, N = O and K = 9*C (tap-major):
//     64x64 output tiles, four warps of 2x2 bf16 WMMA 16x16x16 tiles, float32
//     accumulators loaded from the conv bias before the K loop (as _kernel
//     starts from the bias). The A-tile loader applies x * a + b and SiLU in
//     float32 and rounds to bf16, as the TPU kernel rounds its padded
//     activation; taps that fall outside the image load 0 after the
//     activation, as the TPU kernel zeroes its padding.
// The variance is clamped at 0, as the port's plain group_norm does; _kernel
// does not clamp, which only matters where rounding drives E[x^2] - E[x]^2
// below zero.
// Weights come packed by the caller as (9, O, C) bf16, channels contiguous,
// so a B tile is rows of 16-byte loads; the wrapper packs once per version
// of the conv weight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "gn_stats.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLds = kBK + 8;  // bf16 row pitch of the A/B tiles (80 bytes)
constexpr int kLdc = kBN + 4;  // float row pitch of the bias/epilogue tile
constexpr int kThreads = 128;

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// grid (ceil(M / 64), ceil(O / 64)); coef (N, 2, C) [a; b]; w (9, O, C)
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ x, const float* __restrict__ coef,
            const bf16* __restrict__ w, const float* __restrict__ cbias,
            T* __restrict__ out, int N, int H, int W, int C, int O) {
  constexpr int kTileBytes = 2 * kBM * kLds * sizeof(bf16);
  constexpr int kEpiBytes = kBM * kLdc * sizeof(float);
  constexpr int kSmemBytes = kTileBytes > kEpiBytes ? kTileBytes : kEpiBytes;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ int row_n[kBM], row_y[kBM], row_x[kBM];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [kBM][kLds] pixels x channels
  bf16* Bs = As + kBM * kLds;                // [kBN][kLds] outputs x channels
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 2x2 warps, 32x32 outputs each
  const long long M = static_cast<long long>(N) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  for (int r = tid; r < kBM; r += kThreads) {
    const long long m = m0 + r;
    const int hw = H * W;
    row_n[r] = m < M ? static_cast<int>(m / hw) : -1;
    const int rem = static_cast<int>(m % hw);
    row_y[r] = rem / W;
    row_x[r] = rem % W;
  }
  // the accumulators start from the conv bias
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int c = i % kBN;
    Cs[(i / kBN) * kLdc + c] = n0 + c < O ? cbias[n0 + c] : 0.f;
  }
  __syncthreads();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(acc[i][j],
                             Cs + (wm * 32 + i * 16) * kLdc + wn * 32 + j * 16,
                             kLdc, wmma::mem_row_major);
  __syncthreads();  // Cs shares its memory with the A/B tiles

  const int chunks = (C + kBK - 1) / kBK;  // channel chunks per tap
  for (int step = 0; step < 9 * chunks; ++step) {
    const int tap = step / chunks, c0 = (step % chunks) * kBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    // A tile: 64 pixels x 32 channels as 8-channel vectors, GN + SiLU
    // applied in float32, rounded to bf16; 0 outside the image
    for (int i = tid; i < kBM * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), cv = (i % (kBK / 8)) * 8, c = c0 + cv;
      const int n = row_n[r], yy = row_y[r] + dy, xx = row_x[r] + dx;
      float v[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) v[l] = 0.f;
      if (n >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W && c < C) {
        load8(x + ((static_cast<size_t>(n) * H + yy) * W + xx) * C + c, v);
        const float* a = coef + static_cast<size_t>(n) * 2 * C + c;
        const float* b = a + C;
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          const float y = v[l] * a[l] + b[l];
          v[l] = y / (1.f + expf(-y));
        }
      }
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        h[l] = __floats2bfloat162_rn(v[2 * l], v[2 * l + 1]);
      *reinterpret_cast<uint4*>(As + r * kLds + cv) = u;
    }
    // B tile: 64 output channels x 32 input channels of tap `tap`
    for (int i = tid; i < kBN * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), cv = (i % (kBK / 8)) * 8;
      const int o = n0 + r, c = c0 + cv;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (o < O && c < C)
        u = *reinterpret_cast<const uint4*>(
            w + (static_cast<size_t>(tap) * O + o) * C + c);
      *reinterpret_cast<uint4*>(Bs + r * kLds + cv) = u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kLds + kk, kLds);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * kLds + kk, kLds);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdc + wn * 32 + j * 16,
                              acc[i][j], kLdc, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const long long m = m0 + r;
    if (m < M && n0 + c < O)
      out[m * O + n0 + c] = from_f<T>(Cs[r * kLdc + c]);
  }
}

template <typename T>
cudaError_t conv(const void* x, const float* coef, const void* w,
                 const float* cbias, void* out, int N, int H, int W, int C,
                 int O, cudaStream_t stream) {
  const long long M = static_cast<long long>(N) * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  (O + kBN - 1) / kBN);
  conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), coef, static_cast<const bf16*>(w), cbias,
      static_cast<T*>(out), N, H, W, C, O);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous NHWC (N, H, W, C), bf16 (is_bf16 = 1) or float32, C a
// multiple of 8; gamma, beta: (C) float32; w: (9, O, C) bf16, tap-major
// (tap = 3 * ky + kx); cbias: (O) float32; out: (N, H, W, O) in x's type;
// ws: (N, chunks, 2, C) and coef: (N, 2, C) float32 scratch.
extern "C" int upgpt_fused_resblock(const void* x, const void* gamma,
                                    const void* beta, const void* w,
                                    const void* cbias, void* out, void* ws,
                                    void* coef, int N, int H, int W, int C,
                                    int O, int G, int chunks, float eps,
                                    int is_bf16, void* stream) {
  if (H <= 0 || W <= 0 || O <= 0 || O > 65535 * kBN ||
      (static_cast<long long>(N) * H * W + kBM - 1) / kBM > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* cf = static_cast<float*>(coef);
  cudaError_t e = upgpt::group_stats(
      x, static_cast<float*>(ws), cf, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), N, H * W, C, G, chunks, eps, is_bf16,
      st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* cb = static_cast<const float*>(cbias);
  return static_cast<int>(
      is_bf16 ? conv<bf16>(x, cf, w, cb, out, N, H, W, C, O, st)
              : conv<float>(x, cf, w, cb, out, N, H, W, C, O, st));
}
