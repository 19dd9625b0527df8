// A pipelined tensor-core mainloop for Hopper (sm_90a), shared by the
// SpatialTransformer block's products (csrc/fused_transformer.cu, K1) and
// the ResBlock half-step's implicit conv (csrc/fused_resblock.cu, K7). The
// self-attention leg (csrc/selfattn_leg.cu, K8/K9) uses its pieces:
// consume_desc (a ring position offset, B's descriptor from the caller,
// MN-major B through wgmma's transpose bit), Mma<32>, the 64-byte swizzle
// (desc_swz, swizzle) and 4-D TMA.
//
// The shape of one block:
// - a ring of 3 to 6 stages in dynamic shared memory, each stage a 64-deep
//   K slice of the weights (B, (N, K) K-major bf16) and, for products whose
//   A needs no prologue, of A as well, written by TMA with the 128-byte
//   swizzle and tracked by a pair of mbarriers (full: the bytes arrived;
//   empty: every consumer warp is done with it);
// - one producer warpgroup, whose first thread keeps the ring full, and
//   which gives most of its registers to the consumers;
// - 1 to 3 consumer warpgroups of 64 rows each. A reaches wgmma from
//   registers (the register-A form, m64nNk16, bf16 in, float32
//   accumulators): each warp loads its 16 x 16 fragment with ldmatrix from
//   wherever the caller keeps A (a normalised panel, the swizzled stage, or
//   an activated halo tile at a tap's shift), so a prologue runs once, on
//   data in shared memory, before any product reads it. B is read by wgmma
//   straight from the swizzled stage through a matrix descriptor.
// - the epilogue works on the accumulator registers (the caller's bias,
//   scale, residual or gate), rounds once, stages the warpgroup's 64 x BN
//   tile in shared memory and writes it out in 16-byte stores;
// - a split of K: each split writes its float32 partial tile to a
//   workspace in the register layout (coalesced), and the block that
//   arrives last at the tile's counter sums all partials in split order,
//   so the result is the same whichever block finishes first (no float
//   atomics), and resets the counter for the next launch.
//
// TMA descriptors are made on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint so that the library needs no -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "mma.cuh"

namespace sm90 {

using bf16 = __nv_bfloat16;
using mma::smem_u32;

constexpr int kBK = 64;            // bf16 elements per K step (128 bytes)
constexpr int kMinStages = 3, kMaxStages = 6;
constexpr int kSmemLimit = 232448;  // shared memory one block may use
constexpr int kStaticAllowance = 1024;
constexpr int kAlignSlack = 1024;   // the ring starts 1024-byte aligned

// Consumer warpgroups a block may hold (gemm_plan.max_warpgroups): each
// thread keeps NB * BN / 2 accumulators; three consumer warpgroups and the
// producer warpgroup fit the register file only up to 64 of them.
__host__ __device__ constexpr int max_warpgroups(int bn, int nb) {
  return nb * bn / 2 <= 64 ? 3 : 2;
}

// consumer warpgroups, then the producer warpgroup (a whole warpgroup, so
// that it can hand its registers to the consumers)
__host__ __device__ constexpr int block_threads(int wg) { return 128 * (wg + 1); }

// Register rebalancing. A kernel built for at most two consumer
// warpgroups (384 threads, 168 registers each at launch) moves registers
// from the producer (40) to the consumers (232), whose up to 128
// accumulators then stay in registers; one built for three (512 threads,
// 128 each) keeps the split it was launched with.
template <int MAX_WG>
__device__ __forceinline__ void producer_registers() {
  if constexpr (MAX_WG == 2)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}

template <int MAX_WG>
__device__ __forceinline__ void consumer_registers() {
  if constexpr (MAX_WG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

__host__ inline bool smem_fits(int main_bytes) {
  return kAlignSlack + main_bytes + kStaticAllowance <= kSmemLimit;
}

__host__ inline bool bn_in_menu(int bn) {
  return bn == 64 || bn == 128 || bn == 224 || bn == 256;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// Spins until the barrier's phase of this parity has completed. A wait
// that never ends (a lost copy, a wrong parity) traps after 2^26 polls
// (seconds), so a fault surfaces as a launch error, not a hung card.
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// the consumer warpgroups of a block (threads [0, threads)), barrier 1
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// one consumer warpgroup, barrier 2 + wg
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// ---------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Matrix descriptor of a K-major tile as TMA writes it with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused; the next 16-deep slice starts 32 bytes on (+2).
__device__ __forceinline__ uint64_t desc_b128(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Matrix descriptor of a tile with the 128-byte (span 128) or 64-byte
// (span 64) swizzle as TMA writes it: K-major tiles (rows of `span` bytes
// along K) take sbo = 8 rows and ignore lbo; MN-major tiles (read with
// the transpose bit: rows of `span` bytes along N, one per K index) take
// sbo = the next 8 K rows and lbo = the next span-wide block of N.
__device__ __forceinline__ uint64_t desc_swz(const void* p, uint32_t lbo,
                                             uint32_t sbo, int span) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(span == 128 ? 1 : 2) << 62);
}

// Byte offset `off` of a row-major tile with rows of `span` (128 or 64)
// bytes, as the matching TMA swizzle places it: the 16-byte chunk index
// XOR bits 7.. of the offset (the tile starts 1024-byte aligned).
__device__ __forceinline__ uint32_t swizzle(uint32_t off, int span) {
  return off ^ (((off >> 7) & (span == 128 ? 7u : 3u)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, float32) += a (64 x 16 bf16, registers) * B (16 x N, the
// descriptor's K-major tile, or MN-major with rs<1>; scale_d 0 overwrites
// d instead of adding to it); the accumulator layout: per warp w of the
// warpgroup, rows 16 w + g and 16 w + g + 8 (g = lane / 4), and for each
// 8-column group j, d[4 j], d[4 j + 1] at row g, columns 8 j + 2 t, +1
// (t = lane % 4), d[4 j + 2], d[4 j + 3] at row g + 8. The A fragment is
// mma.m16n8k16's, so mma::ldsm_x4 gives it.
template <int N>
struct Mma;

template <>
struct Mma<32> {
  template <int TB = 0>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Mma<64> {
  template <int TB = 0>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Mma<128> {
  template <int TB = 0>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Mma<224> {
  template <int TB = 0>
  static __device__ __forceinline__ void rs(float (&d)[112], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111"
        "}, {%112, %113, %114, %115}, %116, p, 1, 1, %118;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Mma<256> {
  template <int TB = 0>
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TB));
  }
};

// ---------------------------------------------------------------- ring

// The warpgroup of the calling thread, read from lane 0 so that the
// compiler knows it is the same across the warp: wgmma behind a branch it
// cannot prove uniform is serialised.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

struct Ring {
  uint8_t* base;  // 1024-aligned; stages * stage_bytes
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int stage_bytes;
  __device__ __forceinline__ uint8_t* stage(int s) const {
    return base + s * stage_bytes;
  }
};

// Called by thread 0 before the block's __syncthreads: full barriers take
// the producer's one arrival (with its bytes), empty ones each consumer
// warp's.
__device__ __forceinline__ void ring_init(const Ring& r, int consumer_warps) {
  for (int s = 0; s < r.stages; ++s) {
    bar_init(&r.full[s], 1);
    bar_init(&r.empty[s], consumer_warps);
  }
  bar_fence_init();
}

// The producer lane: `steps` K steps; load(step, stage, bar) issues the
// step's TMA copies, `bytes` in all, completing on bar.
template <class Load>
__device__ __forceinline__ void produce(const Ring& r, int steps,
                                        uint32_t bytes, Load load) {
  for (int s = 0; s < steps; ++s) {
    const int st = s % r.stages;
    bar_wait(&r.empty[st], ((s / r.stages) & 1) ^ 1);
    bar_expect_tx(&r.full[st], bytes);
    load(s, r.stage(st), &r.full[st]);
  }
}

// One consumer warpgroup over `steps` K steps: before(step) first (it may
// synchronise the consumers and rewrite what frag reads), then, once the
// stage has arrived, for each 16-deep slice kk of the step the A fragment
// frag(step, kk, stage, a) and one wgmma per B box b (box b of the stage at
// b * BN * 128 bytes) into acc[b]. Every step issues all four slices, so
// that no wgmma sits on a branch (ptxas serialises those): frag returns
// zeros for slices past K, whose B rows TMA fills with zeros. One step's
// products stay in flight while the next step's fragments load: a step's
// stage is released once the following step has been issued and the
// products before it have retired. The fragments of neighbouring steps
// live in two register sets, so the loop runs two steps per trip.
template <int BN, int NB, class Before, class Frag>
__device__ __forceinline__ void consume(const Ring& r, int steps,
                                        float (&acc)[NB][BN / 2],
                                        Before before, Frag frag) {
  const int lane = threadIdx.x % 32;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) bar_arrive(&r.empty[s % r.stages]);
  };
  auto step = [&](int s, uint32_t(&a)[4][4]) {
    before(s);
    const int st = s % r.stages;
    uint8_t* stage = r.stage(st);
    bar_wait(&r.full[st], (s / r.stages) & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag(s, kk, stage, a[kk]);
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        Mma<BN>::rs(acc[b], a[kk], desc_b128(stage + b * BN * 128) + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products have retired
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    if (s > 0) release(s - 1);
  };
  uint32_t a0[4][4], a1[4][4];
  for (int s = 0; s < steps; s += 2) {
    step(s, a0);
    if (s + 1 < steps) step(s + 1, a1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
  if (steps > 0) release(steps - 1);
}


// consume_desc: the same loop over ring positions first, ..., first +
// steps - 1 (a persistent block's ring runs on from tile to tile), with no
// before(); B's descriptor comes from bdesc(step, b, kk) and is read with
// the transpose bit TB (1: MN-major tiles). consume stays a loop of its
// own: written as a call of this one, it compiled K1's and K7's kernels
// to other code.
template <int BN, int NB, int TB, class Frag, class BDesc>
__device__ __forceinline__ void consume_desc(const Ring& r, int first,
                                             int steps,
                                             float (&acc)[NB][BN / 2],
                                             Frag frag, BDesc bdesc) {
  const int lane = threadIdx.x % 32;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) bar_arrive(&r.empty[(first + s) % r.stages]);
  };
  auto step = [&](int s, uint32_t(&a)[4][4]) {
    const int pos = first + s, st = pos % r.stages;
    uint8_t* stage = r.stage(st);
    bar_wait(&r.full[st], (pos / r.stages) & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag(s, kk, stage, a[kk]);
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        Mma<BN>::template rs<TB>(acc[b], a[kk], bdesc(s, b, kk));
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products have retired
#pragma unroll
    for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
    if (s > 0) release(s - 1);
  };
  uint32_t a0[4][4], a1[4][4];
  for (int s = 0; s < steps; s += 2) {
    step(s, a0);
    if (s + 1 < steps) step(s + 1, a1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
  if (steps > 0) release(steps - 1);
}

// ---------------------------------------------------------------- epilogue

// fn(row, col, v0, v1) for each accumulator pair of the calling thread:
// row in [0, 64) of its warpgroup's tile, col even in [0, BN)
template <int BN, class Fn>
__device__ __forceinline__ void for_pairs(float (&acc)[BN / 2], Fn fn) {
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      fn(w * 16 + g + 8 * h, 8 * j + 2 * t, acc[4 * j + 2 * h],
         acc[4 * j + 2 * h + 1]);
}

__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Elements of a staging row: BN and 16 bytes more, so rows stay 16-byte
// aligned and a column's elements do not all fall in one bank.
template <typename T>
__host__ __device__ constexpr int staging_pitch(int bn) {
  return bn + 16 / static_cast<int>(sizeof(T));
}

// Copy a warpgroup's staged 64 x BN tile out: row r goes to row_ptr(r)
// (null: not stored), columns [0, cols). With vec, every row start and
// cols are multiples of 16 bytes and each thread moves 16 bytes at a time.
template <typename T, int BN, class RowPtr>
__device__ __forceinline__ void copy_rows(const T* stage, int cols, bool vec,
                                          RowPtr row_ptr) {
  constexpr int P = staging_pitch<T>(BN);
  const int tid = threadIdx.x % 128;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int PER_ROW = BN / V;
    for (int i = tid; i < 64 * PER_ROW; i += 128) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * V;
      T* dst = row_ptr(r);
      if (dst == nullptr || c >= cols) continue;
      *reinterpret_cast<uint4*>(dst + c) =
          *reinterpret_cast<const uint4*>(stage + r * P + c);
    }
  } else {
    for (int i = tid; i < 64 * BN; i += 128) {
      const int r = i / BN, c = i % BN;
      T* dst = row_ptr(r);
      if (dst == nullptr || c >= cols) continue;
      dst[c] = stage[r * P + c];
    }
  }
}

// ---------------------------------------------------------------- split K

// Every split of a tile stores its partial accumulators at ws (the tile's
// [splits][NB][R][threads] float32 block) and counts itself in; the block
// that arrives last sums the partials in split order into acc and returns
// true, having reset the counter; the others return false.
template <int NB, int R>
__device__ __forceinline__ bool split_reduce(float (&acc)[NB][R], float* ws,
                                             int* counter, int split,
                                             int splits, int threads,
                                             int* last) {
  const int tid = threadIdx.x;
  float* mine = ws + static_cast<size_t>(split) * NB * R * threads;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < R; ++i) __stcg(mine + (b * R + i) * threads + tid, acc[b][i]);
  __threadfence();
  consumer_sync(threads);
  if (tid == 0) *last = atomicAdd(counter, 1) == splits - 1;
  consumer_sync(threads);
  if (!*last) return false;
  __threadfence();
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < R; ++i) acc[b][i] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = ws + static_cast<size_t>(s) * NB * R * threads;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < R; ++i) acc[b][i] += __ldcg(p + (b * R + i) * threads + tid);
  }
  if (tid == 0) *counter = 0;
  return true;
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor of `rank` dims (dims innermost first, rows dense), read in
// boxes of `box` with the 128-byte swizzle (or 64-byte: span 64);
// out-of-bounds elements read 0.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int rank,
                            const uint64_t* dims, const uint32_t* box,
                            int span = 128) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16)
    return cudaErrorMisalignedAddress;
  cuuint64_t gd[5], gs[4];
  cuuint32_t bd[5], es[5];
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gd[i] = dims[i];
    bd[i] = box[i];
    es[i] = 1;
    if (i > 0) gs[i - 1] = stride;
    stride *= dims[i];
  }
  if (gs[0] % 16) return cudaErrorInvalidValue;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                         const_cast<void*>(ptr), gd, gs, bd, es,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// make_map for weights, cached: a descriptor holds the address and shape
// only, never the values, so (address, dims, box) keys it for as long as
// any tensor lives there, and a weight updated in place keeps its entry.
inline cudaError_t weight_map(CUtensorMap* map, const void* ptr, int rank,
                              const uint64_t* dims, const uint32_t* box) {
  struct Entry {
    const void* ptr;
    int rank;
    uint64_t dims[3];
    uint32_t box[3];
    CUtensorMap map;
  };
  constexpr int kEntries = 256;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex lock;
  if (rank > 3) return make_map(map, ptr, rank, dims, box);
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.rank == rank &&
        !memcmp(e.dims, dims, rank * sizeof(uint64_t)) &&
        !memcmp(e.box, box, rank * sizeof(uint32_t))) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = make_map(map, ptr, rank, dims, box);
  if (err != cudaSuccess) return err;
  Entry& e = cache[next];
  e.ptr = ptr;
  e.rank = rank;
  memcpy(e.dims, dims, rank * sizeof(uint64_t));
  memcpy(e.box, box, rank * sizeof(uint32_t));
  e.map = *map;
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return cudaSuccess;
}

// Opts a kernel into all the dynamic shared memory a plan may take; the
// caller keeps the result in a static, so this runs once per kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemLimit - kStaticAllowance);
}

}  // namespace sm90
