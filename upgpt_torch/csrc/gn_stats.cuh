// Row-tiled GroupNorm statistics over NHWC, shared by csrc/gn_stats.cu (the
// tiled GroupNorm) and csrc/fused_resblock.cu (the ResBlock half-step, whose
// first launch is these statistics).
#pragma once

#include <cuda_runtime.h>

namespace upgpt {

// Launches the statistics kernel on `stream`, one launch: blocks over
// (row chunk, column slab, image) write per-channel float32 sums and sums
// of squares of x (N, HW, C) into ws (N, chunks, 2, C), and the block of an
// image that counts itself in last at counters[n] sums the chunks in chunk
// order, folds channels into G groups, var = E[x^2] - E[x]^2 clamped at 0,
// rstd = rsqrt(var + eps), and resets counters[n] to 0. counters holds N
// int32, zero before the launch; launches in order on one stream may share
// them. Without gamma/beta, out (N, 2, C) holds [mean_c; rstd_c] (each
// channel carrying its group's value). With gamma and beta (C float32
// each), out holds the affine coefficients [a_c; b_c] with
// a = rstd * gamma and b = beta - mean * a, so that GroupNorm(x) = x * a + b.
// x is bf16 (is_bf16 = 1) or float32; C must be a multiple of 8.
cudaError_t group_stats(const void* x, float* ws, float* out,
                        const float* gamma, const float* beta, int* counters,
                        int N, int HW, int C, int G, int chunks, float eps,
                        int is_bf16, cudaStream_t stream);

}  // namespace upgpt
