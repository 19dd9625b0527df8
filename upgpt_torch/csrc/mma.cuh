// Tensor-core and asynchronous-copy primitives shared by the attention
// kernels (flash_attention.cu, flash_backward.cu), for sm_80 and later.
//
// - cp.async global -> shared copies of 16, 8 or 4 bytes; a copy whose
//   source lies outside the matrix fills its destination with zeros;
// - ldmatrix x4 (and .trans) loads of four 8x8 bf16 tiles from shared memory;
// - mma.sync m16n8k16, bf16 in, float32 accumulate.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
//                           a[2] = (g, 2t+8..),   a[3] = (g+8, 2t+8..);
//   B (16 x 8):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g);
//   C (16 x 8):  c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1).
// So the C tiles of two neighbouring n-tiles, rounded to bf16 pairs, are
// exactly the A fragment of a product over those 16 columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES from src to dst, or BYTES of zeros where !in (src is then not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  const int n = in ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a row-major
// [rows][pitch] tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int pitch, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, s + (r0 + (lane & 15)) * pitch + c0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles for a product with the TRANSPOSE of a
// row-major tile X [n][k]: n-rows [n0, n0 + 16), k-columns [k0, k0 + 16).
// b[0], b[1] serve n-tile n0, b[2], b[3] n-tile n0 + 8.
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* s,
                                        int pitch, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles for a product with a row-major tile X [k][n]
// itself: k-rows [k0, k0 + 16), n-columns [n0, n0 + 16).
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* s,
                                       int pitch, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 +
                   (lane >> 4) * 8);
}

// Rows [row0, row0 + ROWS) of a bf16 matrix whose row r starts at
// src + r * stride, columns [0, COLS), into dst [ROWS][PITCH]. Rows >= rows
// and columns >= cols are zero. Each copy moves BYTES; the caller has
// checked that src, stride and cols keep every copy inside one row and
// aligned (BYTES = 2: plain loads and stores).
template <int BYTES, int ROWS, int COLS, int PITCH, int THREADS>
__device__ __forceinline__ void load_tile_v(bf16* dst, const bf16* src,
                                            long long stride, int row0,
                                            int rows, int cols) {
  constexpr int E = BYTES / 2;  // elements per copy
  constexpr int PER_ROW = COLS / E;
  static_assert(COLS % E == 0, "tile width must hold whole copies");
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * E, row = row0 + r;
    const bool in = row < rows && c < cols;
    const bf16* p = in ? src + row * stride + c : src;
    if constexpr (BYTES == 2) {
      dst[r * PITCH + c] = in ? *p : __float2bfloat16(0.f);
    } else {
      cp_async<BYTES>(dst + r * PITCH + c, p, in);
    }
  }
}

template <int ROWS, int COLS, int PITCH, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int rows, int cols, int vec) {
  switch (vec) {
    case 16:
      load_tile_v<16, ROWS, COLS, PITCH, THREADS>(dst, src, stride, row0,
                                                  rows, cols);
      break;
    case 8:
      load_tile_v<8, ROWS, COLS, PITCH, THREADS>(dst, src, stride, row0, rows,
                                                 cols);
      break;
    case 4:
      load_tile_v<4, ROWS, COLS, PITCH, THREADS>(dst, src, stride, row0, rows,
                                                 cols);
      break;
    default:
      load_tile_v<2, ROWS, COLS, PITCH, THREADS>(dst, src, stride, row0, rows,
                                                 cols);
  }
}

// The widest copy (16, 8, 4 or 2 bytes) that every row start of a bf16
// matrix keeps aligned: its base address and each byte stride (element
// strides times 2, and the row width 2 * cols) must be multiples of it.
__host__ inline int copy_bytes(unsigned long long mask) {
  int v = 16;
  while (v > 2 && (mask & (v - 1))) v >>= 1;
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace mma
