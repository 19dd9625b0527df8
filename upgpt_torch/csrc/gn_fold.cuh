// The group fold shared by the GroupNorm kernels (csrc/fused_gn.cu,
// csrc/gn_stats.cu): per-channel sums folded into per-group sums by all of
// a block's threads at once, in a fixed order, with no float atomics.
#pragma once

#include <cuda_runtime.h>

namespace upgpt {

// a / d for 0 <= a < 2^20, given inv = 1 / d rounded to float: the
// quotient plus one half is at least 0.5 / d from an integer, far more than
// the product's rounding error, so no integer division is needed.
__device__ __forceinline__ int quot(int a, float inv) {
  return __float2int_rz((static_cast<float>(a) + 0.5f) * inv);
}

// Threads folding one group: 256 / G rounded down to a power of two, at
// most a warp, so that every group's threads share a warp.
__host__ __device__ inline int fold_threads(int G, int threads) {
  int tpg = 1;
  while (tpg * 2 <= 32 && tpg * 2 * G <= threads) tpg *= 2;
  return tpg;
}

// out[g] = the sum over parts p < parts and channels j < C / G of
// in[p * stride + g * (C / G) + j], and out[G + g] the same over
// in[p * stride + C + ...], for g < G. The `tpg` threads of group g take
// the channels j = s, s + tpg, ... (s the thread's place among them), part
// by part, in order; then they add their sums in a butterfly (xor tpg / 2,
// ..., 1), so every one of them holds the same bits and the first writes
// them. All threads of the block call it; it does not synchronise.
__device__ __forceinline__ void fold_groups(const float* in, int parts,
                                            size_t stride, int C, int G,
                                            float* out) {
  const int threads = blockDim.x, t = threadIdx.x;
  const int tpg = fold_threads(G, threads), cpg = C / G, s = t & (tpg - 1);
  const int shift = __ffs(tpg) - 1;  // tpg is a power of two
  for (int base = 0; base < G; base += threads >> shift) {
    const int g = base + (t >> shift);
    float a = 0.f, b = 0.f;
    if (g < G) {
      for (int p = 0; p < parts; ++p) {
        const float* q = in + p * stride + g * cpg;
        for (int j = s; j < cpg; j += tpg) {
          a += q[j];
          b += q[C + j];
        }
      }
    }
    for (int o = tpg / 2; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (g < G && s == 0) {
      out[g] = a;
      out[G + g] = b;
    }
  }
}

}  // namespace upgpt
