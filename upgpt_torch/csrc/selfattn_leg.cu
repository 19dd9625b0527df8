// The self-attention leg of the SpatialTransformer block for Hopper
// (sm_90a): x -> Q, K, V -> per-head softmax(Q K^T / sqrt(dh)) V -> to_out
// + bias, over (B, T, C) bf16 tokens.
//
// Replaces benchmarks/micro_block.py::fw_kernel (K8, full-width (C, C)
// weights) and ::ph_kernel (K9, weights pre-split per head: (H, C, dh) for
// Q/K/V, (H, dh, C) for to_out). Both TPU kernels hold one whole image per
// grid step in VMEM: x alone is 768 x 224 bf16 (344 KB) and one head's
// (768, 768) float32 score matrix 2.36 MB, where a Hopper block has 227 KB.
// So each C call here is three launches, and no score matrix is ever
// materialised:
//
// 1. proj_kernel over a grid of (N tile, M tile, product): the Q, K and V
//    products as one launch. K8: three products of width C (together the
//    3C-wide product) into a (3, B*T, C) workspace. K9: 3 H products of
//    width dh from the per-head weights as given, into (3, H, B*T, dh).
// 2. the tensor-core flash routine of csrc/flash_attention.cu
//    (upgpt_attention_launch), with strides: K8's heads are lane slices of
//    the packed (B*T, C) activations at offsets h * dh, K9's are
//    contiguous (B*T, dh) planes. Keys stream in tiles with an online
//    softmax; o is divided by the row sum after the value product, where
//    the TPU kernels normalise p before it and round it to bf16.
// 3. proj_kernel for to_out, float32 accumulators, one bf16 rounding. K8:
//    one (B*T, C) x (C, C) product, then the float32 bias. K9: the
//    accumulators start from the bias and add o_h @ wo[h] head by head, in
//    head order, each head a segment of the K loop: the sum ph_kernel
//    forms.
//
// dh = 28 is not a multiple of the mma.sync depth (16): a head's columns
// pad to 32 in shared memory with zero lanes (cp.async zero-fills copies
// past a matrix's columns), and no copy reads past a head's 28 columns in
// device memory. No split reduction and no atomics: each output element is
// summed by one thread in a fixed order, so a call repeats bit for bit.
//
// What bounds it on an H100: at (32, 768, 224, 8 heads) the products are
// 9.87 GFLOP and QK^T / PV 16.91 GFLOP, 26.8 GFLOP in all (0.027 ms at 989
// TFLOP/s, bf16) against ~22 MB of bytes (0.0067 ms at 3.35 TB/s): the
// operations. The softmax's 151 M exponentials take 0.036 ms by
// themselves on the special-function units (16 a clock per SM, 132 SMs,
// 1,980 MHz). proj_kernel is a plain mma.sync m16n8k16 GEMM (64 x BN
// tiles, cp.async double buffering), not the wgmma mainloop of
// gemm_sm90.cuh: a right kernel first.
#include <math.h>

#include "attention.cuh"
#include "mma.cuh"

namespace {

using mma::bf16;

constexpr int kThreads = 128;  // four warps, 16 rows of the tile each
constexpr int kBM = 64;
constexpr int kBK = 32;

// out_z[m, n] = bf16(bias[n] (first or last) + sum_s A_s[m, :K] B_zs[:K, n])
// for z = which * zh + j: A_s = a + s * a_seg, B_zs = b[which] + j * b_zh +
// s * b_seg, out_z = c[which] + j * c_zh. Row-major, element strides.
struct ProjArgs {
  const bf16* a;
  long long lda, a_seg;
  const bf16* b[3];
  long long ldb, b_seg, b_zh;
  bf16* c[3];
  long long ldc, c_zh;
  const float* bias;  // (N,) float32 or null
  int bias_first;     // 1: accumulators start from the bias
  int M, N, K, segs, zh;
  int vec_a, vec_b;   // widest aligned copy of A's and B's rows, bytes
  int pairs;          // 1: out rows keep bf16 pairs 4-byte aligned
};

template <int BN>
__global__ void __launch_bounds__(kThreads) proj_kernel(ProjArgs p) {
  constexpr int PA = kBK + 8, PB = BN + 8;  // +16 bytes: ldmatrix rows apart
  constexpr int NT = BN / 8;
  __shared__ __align__(16) bf16 As[2][kBM * PA];
  __shared__ __align__(16) bf16 Bs[2][kBK * PB];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int which = blockIdx.z / p.zh, j = blockIdx.z % p.zh;
  const bf16* a = p.a + static_cast<long long>(m0) * p.lda;
  const bf16* b = p.b[which] + j * p.b_zh + n0;
  bf16* c = p.c[which] + j * p.c_zh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int rows = min(kBM, p.M - m0), cols = min(BN, p.N - n0);
  const int ktiles = (p.K + kBK - 1) / kBK, iters = p.segs * ktiles;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n0 + n * 8 + (lane & 3) * 2;
    const float b0 = p.bias_first && col < p.N ? p.bias[col] : 0.f;
    const float b1 = p.bias_first && col + 1 < p.N ? p.bias[col + 1] : 0.f;
    acc[n][0] = acc[n][2] = b0;
    acc[n][1] = acc[n][3] = b1;
  }

  // iteration i: segment i / ktiles, K columns [kt * kBK, kt * kBK + kBK)
  auto stage = [&](int i) {
    const int s = i / ktiles, k0 = (i % ktiles) * kBK;
    const int kcols = min(kBK, p.K - k0);
    mma::load_tile<kBM, kBK, PA, kThreads>(As[i & 1], a + s * p.a_seg + k0,
                                           p.lda, 0, rows, kcols, p.vec_a);
    mma::load_tile<kBK, BN, PB, kThreads>(
        Bs[i & 1], b + s * p.b_seg + static_cast<long long>(k0) * p.ldb,
        p.ldb, 0, kcols, cols, p.vec_b);
  };
  stage(0);
  mma::cp_async_commit();
  for (int i = 0; i < iters; ++i) {
    if (i + 1 < iters) {
      stage(i + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* At = As[i & 1];
    const bf16* Bt = Bs[i & 1];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4];
      mma::load_a(af, At, PA, r0, kk * 16);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bfr[4];
        mma::load_b(bfr, Bt, PB, kk * 16, n * 8);
        mma::mma16816(acc[n], af, bfr[0], bfr[1]);
        mma::mma16816(acc[n + 1], af, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // the buffer is refilled two iterations on
  }

  // epilogue: the bias last where it is not first, one bf16 rounding
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + r0 + lane / 4 + 8 * r;
    if (row >= p.M) continue;
    bf16* orow = c + static_cast<long long>(row) * p.ldc;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n0 + n * 8 + (lane & 3) * 2;
      float x0 = acc[n][2 * r], x1 = acc[n][2 * r + 1];
      if (p.bias && !p.bias_first) {
        if (col < p.N) x0 += p.bias[col];
        if (col + 1 < p.N) x1 += p.bias[col + 1];
      }
      if (p.pairs && col + 1 < p.N) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < p.N) orow[col] = __float2bfloat16(x0);
        if (col + 1 < p.N) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

unsigned long long addr(const void* ptr) {
  return reinterpret_cast<unsigned long long>(ptr);
}

cudaError_t launch_proj(ProjArgs p, int products, cudaStream_t stream) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.segs <= 0 || p.zh <= 0 ||
      products <= 0 || products > 65535)
    return cudaErrorInvalidValue;
  unsigned long long ma = addr(p.a) | 2ull * (p.lda | p.a_seg | p.K);
  unsigned long long mb = 2ull * (p.ldb | p.b_seg | p.b_zh | p.N);
  unsigned long long mc = 2ull * (p.ldc | p.c_zh);
  for (int i = 0; i < products / p.zh; ++i) {
    mb |= addr(p.b[i]);
    mc |= addr(p.c[i]);
  }
  p.vec_a = mma::copy_bytes(ma);
  p.vec_b = mma::copy_bytes(mb);
  p.pairs = (mc & 3) == 0;
  const int mt = (p.M + kBM - 1) / kBM;
  if (p.N <= 32) {
    proj_kernel<32><<<dim3((p.N + 31) / 32, mt, products), kThreads, 0,
                      stream>>>(p);
  } else {
    proj_kernel<64><<<dim3((p.N + 63) / 64, mt, products), kThreads, 0,
                      stream>>>(p);
  }
  return cudaGetLastError();
}

// Heads of the attention pass: q, k, v in three planes `plane` elements
// apart, each (B, T) rows of `row` elements with head h at h * head_off.
cudaError_t attend(const bf16* qkv, long long plane, long long row,
                   long long head_off, bf16* o, int B, int T, int H, int dh,
                   cudaStream_t stream) {
  AttnArgs a;
  a.q = qkv;
  a.k = qkv + plane;
  a.v = qkv + 2 * plane;
  a.o = o;
  a.B = B;
  a.H = H;
  a.Tq = a.Tk = T;
  a.D = dh;
  a.sqb = a.skb = a.svb = a.sob = static_cast<long long>(T) * row;
  a.sqh = a.skh = a.svh = a.soh = head_off;
  a.sqt = a.skt = a.svt = a.sot = row;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  return upgpt_attention_launch(a, 1, stream);
}

bool bad_geometry(int B, int T, int C, int heads) {
  return B <= 0 || T <= 0 || C <= 0 || heads <= 0 || C % heads ||
         C / heads > 512 || B > 65535 || heads > 65535 / 3;
}

}  // namespace

// K8: x (B, T, C); wq, wk, wv, wo (C, C) in (in, out) layout; bo (C,)
// float32; qkv_ws 3 B T C and o_ws B T C bf16 workspaces; out (B, T, C).
extern "C" int upgpt_selfattn_fullwidth(const void* x, const void* wq,
                                        const void* wk, const void* wv,
                                        const void* wo, const void* bo,
                                        void* qkv_ws, void* o_ws, void* out,
                                        int B, int T, int C, int heads,
                                        void* stream) {
  if (bad_geometry(B, T, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(B) * T, plane = M * C;
  bf16* qkv = static_cast<bf16*>(qkv_ws);
  bf16* o = static_cast<bf16*>(o_ws);
  ProjArgs p = {};
  p.a = static_cast<const bf16*>(x);
  p.lda = C;
  p.b[0] = static_cast<const bf16*>(wq);
  p.b[1] = static_cast<const bf16*>(wk);
  p.b[2] = static_cast<const bf16*>(wv);
  p.ldb = C;
  for (int i = 0; i < 3; ++i) p.c[i] = qkv + i * plane;
  p.ldc = C;
  p.M = static_cast<int>(M);
  p.N = p.K = C;
  p.segs = p.zh = 1;
  cudaError_t e = launch_proj(p, 3, st);
  if (e != cudaSuccess) return e;
  e = attend(qkv, plane, C, C / heads, o, B, T, heads, C / heads, st);
  if (e != cudaSuccess) return e;
  ProjArgs q = {};
  q.a = o;
  q.lda = C;
  q.b[0] = static_cast<const bf16*>(wo);
  q.ldb = C;
  q.c[0] = static_cast<bf16*>(out);
  q.ldc = C;
  q.bias = static_cast<const float*>(bo);
  q.M = static_cast<int>(M);
  q.N = q.K = C;
  q.segs = q.zh = 1;
  return static_cast<int>(launch_proj(q, 1, st));
}

// K9: x (B, T, C); wq_h, wk_h, wv_h (H, C, dh); wo_h (H, dh, C); bo (C,)
// float32; qkv_ws 3 H B T dh and o_ws H B T dh bf16; out (B, T, C).
extern "C" int upgpt_selfattn_perhead(const void* x, const void* wq_h,
                                      const void* wk_h, const void* wv_h,
                                      const void* wo_h, const void* bo,
                                      void* qkv_ws, void* o_ws, void* out,
                                      int B, int T, int C, int heads,
                                      void* stream) {
  if (bad_geometry(B, T, C, heads)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dh = C / heads;
  const long long M = static_cast<long long>(B) * T, head = M * dh;
  bf16* qkv = static_cast<bf16*>(qkv_ws);
  bf16* o = static_cast<bf16*>(o_ws);
  ProjArgs p = {};
  p.a = static_cast<const bf16*>(x);
  p.lda = C;
  p.b[0] = static_cast<const bf16*>(wq_h);
  p.b[1] = static_cast<const bf16*>(wk_h);
  p.b[2] = static_cast<const bf16*>(wv_h);
  p.ldb = dh;
  p.b_zh = static_cast<long long>(C) * dh;  // the next head's (C, dh)
  for (int i = 0; i < 3; ++i) p.c[i] = qkv + i * heads * head;
  p.ldc = dh;
  p.c_zh = head;  // each head a (B T, dh) plane
  p.M = static_cast<int>(M);
  p.N = dh;
  p.K = C;
  p.segs = 1;
  p.zh = heads;
  cudaError_t e = launch_proj(p, 3 * heads, st);
  if (e != cudaSuccess) return e;
  e = attend(qkv, heads * head, dh, head, o, B, T, heads, dh, st);
  if (e != cudaSuccess) return e;
  ProjArgs q = {};
  q.a = o;
  q.lda = dh;
  q.a_seg = head;  // segment s: head s's o plane ...
  q.b[0] = static_cast<const bf16*>(wo_h);
  q.ldb = C;
  q.b_seg = static_cast<long long>(dh) * C;  // ... against wo[s]
  q.c[0] = static_cast<bf16*>(out);
  q.ldc = C;
  q.bias = static_cast<const float*>(bo);
  q.bias_first = 1;
  q.M = static_cast<int>(M);
  q.N = C;
  q.K = dh;
  q.segs = heads;
  q.zh = 1;
  return static_cast<int>(launch_proj(q, 1, st));
}
