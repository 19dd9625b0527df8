// The SpatialTransformer block (depth 1, precomputed cross K/V) for Hopper
// (sm_90a), bf16 in and out with float32 accumulation:
//
//   GN32(eps) -> proj_in -> LN1 -> self-attn (+res) -> LN2 -> cross-attn on
//   precomputed K/V (+res) -> LN3 -> GEGLU FF (+res) -> proj_out + input
//
// Replaces upgpt_tpu/ops/fused_transformer.py::_fused_forward (_block_kernel),
// which runs the whole block per sample in one TPU program.
//
// What bounds it on this card: one block per sample does not fit. At ds2
// (T=192, C=448) the bf16 weights alone are 9.2 MB, forty times a block's
// 227 KB of shared memory, and the ds1 token stream (768 x 224) needs many
// SMs to keep the card busy. The work is a chain of matrix products with
// cheap prologues and epilogues, so the block is split into eleven launches
// on one stream, all hand-written here:
//   (a) gn_stats_kernel: GroupNorm statistics per (sample, group), float32,
//       var = E[x^2] - E[x]^2 clamped at 0, as _block_kernel computes them;
//   (b) gemm_kernel: a 64x64-tiled bf16 tensor-core (WMMA 16x16x16) product
//       with float32 accumulation and a selectable prologue (GroupNorm apply
//       or LayerNorm, eps 1e-5, applied in float32 as the A tile is staged,
//       LayerNorm row statistics computed in the block) and epilogue (bias,
//       q-column scale, residual add, or the GEGLU gate x * gelu_erf(g) with
//       the x and gate halves of W multiplied side by side). It covers
//       proj_in, packed QKV, both to_out, the cross to_q, both FF products
//       and proj_out;
//   (c) the shared attention routine of flash_attention.cu, reading head h
//       of the packed (B, T, C) activations at column offset h * dh, so no
//       head transpose is ever materialised.
// Head dims 28 and 56 need no padding in memory: (b) runs over C, and (c)
// zero-pads its D chunks in shared memory. Intermediates (~10 B*T*C bf16)
// live in a workspace the caller allocates; the bf16 residual stream is
// rounded after every sub-block, as in _block_kernel.
#include <mma.h>

#include "attention.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kGroups = 32;
constexpr float kLnEps = 1e-5f;

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLds = kBK + 8;   // bf16 row pitch of the A/B tiles
constexpr int kLdc = kBN + 4;   // float row pitch of the epilogue tile
constexpr int kGemmThreads = 128;
constexpr int kMaxNormK = 512;  // widest row the norm prologues stage

enum Prologue { kNone = 0, kLayerNorm = 1, kGroupNorm = 2 };

struct GemmArgs {
  const bf16* A;         // (M, K) row-major
  // (N, K) row-major, nn.Linear layout, in `parts` pieces of N / parts rows
  // each: W[i] holds output columns [i * N / parts, (i + 1) * N / parts).
  // The QKV product reads to_q, to_k and to_v where they lie (parts = 3);
  // every other product has one piece.
  const bf16* W[3];
  int parts;
  const bf16* bias;      // per output column, or null
  const bf16* residual;  // (M, N), or null
  bf16* out;             // (M, N)
  int M, N, K;
  int gate_offset;       // GEGLU: the gate's rows of W start here
  int q_cols;            // columns [0, q_cols) are scaled by q_scale
  float q_scale;
  const bf16* gamma;     // (K) norm scale
  const bf16* beta;      // (K) norm shift
  const float* gn_stats; // (samples, 32, 2) mean, rstd
  int rows_per_sample;
};

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(256)
gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats, int T,
                int C, float eps) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int cpg = C / kGroups;
  const bf16* xb = x + static_cast<size_t>(b) * T * C + g * cpg;
  const int n = T * cpg;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = bf(xb[static_cast<size_t>(i / cpg) * C + i % cpg]);
    s1 += v;
    s2 += v * v;
  }
  __shared__ float red[2][8];
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s1 = s2 = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) {
      s1 += red[0][w];
      s2 += red[1][w];
    }
    const float mean = s1 / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.f);
    stats[(b * kGroups + g) * 2] = mean;
    stats[(b * kGroups + g) * 2 + 1] = rsqrtf(var + eps);
  }
}

template <int PRO, bool GEGLU>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs g) {
  constexpr int kTileBytes = (GEGLU ? 3 : 2) * kBM * kLds * sizeof(bf16);
  constexpr int kEpiBytes = (GEGLU ? 2 : 1) * kBM * kLdc * sizeof(float);
  constexpr int kSmemBytes = kTileBytes > kEpiBytes ? kTileBytes : kEpiBytes;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ float row_mean[kBM], row_rstd[kBM];
  __shared__ float gam[PRO == kNone ? 1 : kMaxNormK];
  __shared__ float bet[PRO == kNone ? 1 : kMaxNormK];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [kBM][kLds]
  bf16* Bs = As + kBM * kLds;                // [kBN][kLds]: W rows = B columns
  bf16* Gs = Bs + kBN * kLds;                // gate rows (GEGLU)
  float* Cs = reinterpret_cast<float*>(smem);  // [kBM][kLdc] after the loop
  float* Cg = Cs + kBM * kLdc;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int K = g.K;
  // each block works inside one piece of W: columns [n0, n0 + kBN) of the
  // piece's pn, which are output columns col0 + n
  const int pn = g.N / g.parts;
  const int tiles = (pn + kBN - 1) / kBN;
  const int part = blockIdx.x / tiles;
  const int m0 = blockIdx.y * kBM, n0 = (blockIdx.x % tiles) * kBN;
  const int col0 = part * pn;
  const bf16* W = part == 0 ? g.W[0] : part == 1 ? g.W[1] : g.W[2];
  if (PRO != kNone) {
    for (int k = tid; k < K; k += kGemmThreads) {
      gam[k] = bf(g.gamma[k]);
      bet[k] = bf(g.beta[k]);
    }
  }
  if (PRO == kLayerNorm) {
    // two-pass row statistics in float32, as the twin's _ln_f32
    for (int r = warp; r < kBM; r += kGemmThreads / 32) {
      const int m = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (m < g.M) {
        const bf16* row = g.A + static_cast<size_t>(m) * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += bf(row[k]);
        mean = warp_sum(s) / K;
        float v = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float d = bf(row[k]) - mean;
          v += d * d;
        }
        rstd = rsqrtf(warp_sum(v) / K + kLnEps);
      }
      if (lane == 0) {
        row_mean[r] = mean;
        row_rstd[r] = rstd;
      }
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2], acc_g[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      if (GEGLU) wmma::fill_fragment(acc_g[i][j], 0.f);
    }
  const int wm = warp / 2, wn = warp % 2;  // 2x2 warps, 32x32 outputs each

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A tile, prologue applied in float32, stored bf16. K is even, so a
    // bf16 pair is either wholly inside or wholly outside the matrix.
    for (int i = tid; i < kBM * kBK / 2; i += kGemmThreads) {
      const int r = i / (kBK / 2), c = (i % (kBK / 2)) * 2;
      const int m = m0 + r, k = k0 + c;
      float2 v = make_float2(0.f, 0.f);
      if (m < g.M && k < K) {
        v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            g.A + static_cast<size_t>(m) * K + k));
        if (PRO == kLayerNorm) {
          const float mu = row_mean[r], rs = row_rstd[r];
          v.x = (v.x - mu) * rs * gam[k] + bet[k];
          v.y = (v.y - mu) * rs * gam[k + 1] + bet[k + 1];
        } else if (PRO == kGroupNorm) {
          const int cpg = K / kGroups;
          const float* st =
              g.gn_stats + static_cast<size_t>(m / g.rows_per_sample) * kGroups * 2;
          const int g0 = k / cpg, g1 = (k + 1) / cpg;
          v.x = (v.x - st[2 * g0]) * st[2 * g0 + 1] * gam[k] + bet[k];
          v.y = (v.y - st[2 * g1]) * st[2 * g1 + 1] * gam[k + 1] + bet[k + 1];
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(As + r * kLds + c) =
          __floats2bfloat162_rn(v.x, v.y);
    }
    // B tile(s): rows n of W, contiguous in k
    for (int i = tid; i < kBN * kBK / 2; i += kGemmThreads) {
      const int r = i / (kBK / 2), c = (i % (kBK / 2)) * 2;
      const int n = n0 + r, k = k0 + c;
      const bool in = n < pn && k < K;
      const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(Bs + r * kLds + c) =
          in ? *reinterpret_cast<const __nv_bfloat162*>(
                   W + static_cast<size_t>(n) * K + k)
             : zero;
      if (GEGLU)
        *reinterpret_cast<__nv_bfloat162*>(Gs + r * kLds + c) =
            in ? *reinterpret_cast<const __nv_bfloat162*>(
                     W + static_cast<size_t>(n + g.gate_offset) * K + k)
               : zero;
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
      if (GEGLU) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Gs + (wn * 32 + j * 16) * kLds + kk, kLds);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc_g[i][j], fa[i], fb[j], acc_g[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int off = (wm * 32 + i * 16) * kLdc + wn * 32 + j * 16;
      wmma::store_matrix_sync(Cs + off, acc[i][j], kLdc, wmma::mem_row_major);
      if (GEGLU)
        wmma::store_matrix_sync(Cg + off, acc_g[i][j], kLdc, wmma::mem_row_major);
    }
  __syncthreads();

  for (int i = tid; i < kBM * kBN; i += kGemmThreads) {
    const int r = i / kBN, c = i % kBN;
    const int m = m0 + r, n = n0 + c, col = col0 + n;
    if (m >= g.M || n >= pn) continue;
    float v = Cs[r * kLdc + c];
    if (GEGLU) {
      const float x = v + (g.bias ? bf(g.bias[col]) : 0.f);
      const float gate =
          Cg[r * kLdc + c] + (g.bias ? bf(g.bias[col + g.gate_offset]) : 0.f);
      v = x * (0.5f * gate * (1.f + erff(gate * 0.70710678118654752f)));
    } else {
      if (col < g.q_cols) v *= g.q_scale;
      if (g.bias) v += bf(g.bias[col]);
      if (g.residual) v += bf(g.residual[static_cast<size_t>(m) * g.N + col]);
    }
    g.out[static_cast<size_t>(m) * g.N + col] = __float2bfloat16(v);
  }
}

template <int PRO, bool GEGLU>
cudaError_t gemm(const GemmArgs& g, cudaStream_t stream) {
  const int tiles = (g.N / g.parts + kBN - 1) / kBN;
  const dim3 grid(g.parts * tiles, (g.M + kBM - 1) / kBM);
  gemm_kernel<PRO, GEGLU><<<grid, kGemmThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

GemmArgs product(const bf16* A, int M, int K, const void* W, int N,
                 bf16* out) {
  GemmArgs g = {};
  g.A = A;
  g.M = M;
  g.K = K;
  g.W[0] = static_cast<const bf16*>(W);
  g.parts = 1;
  g.N = N;
  g.out = out;
  return g;
}

GemmArgs with_norm(GemmArgs g, const void* gamma, const void* beta) {
  g.gamma = static_cast<const bf16*>(gamma);
  g.beta = static_cast<const bf16*>(beta);
  return g;
}

AttnArgs packed_attention(const bf16* q, long long q_row, const bf16* k,
                          const bf16* v, long long kv_row, bf16* o, int B,
                          int heads, int T, int Tk, int C) {
  const int dh = C / heads;
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.B = B;
  a.H = heads;
  a.Tq = T;
  a.Tk = Tk;
  a.D = dh;
  a.sqb = q_row * T;
  a.sqh = dh;
  a.sqt = q_row;
  a.skb = a.svb = kv_row * Tk;
  a.skh = a.svh = dh;
  a.skt = a.svt = kv_row;
  a.sob = static_cast<long long>(C) * T;
  a.soh = dh;
  a.sot = C;
  a.scale = 1.f;  // q arrives pre-scaled by 1/sqrt(dh)
  return a;
}

}  // namespace

#define UPGPT_TRY(expr)                 \
  do {                                  \
    const cudaError_t e_ = (expr);      \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

// x, out: (B, T, C) bf16. Weights in nn.Linear layout (out, in), bf16:
// w_q1, w_k1, w_v1 (C, C) of attn1, w_ff1 (8C, C) with the GEGLU
// x half first, w_ff2 (C, 4C). k2, v2: precomputed cross K/V (B, Tk, C).
// ws: 10*B*T*C bf16 workspace; stats: B*64 float32.
extern "C" int upgpt_fused_transformer_block(
    const void* x, void* out, const void* gn_w, const void* gn_b,
    const void* w_pi, const void* b_pi, const void* ln1_w, const void* ln1_b,
    const void* w_q1, const void* w_k1, const void* w_v1, const void* w_o1,
    const void* b_o1, const void* ln2_w, const void* ln2_b, const void* w_q2,
    const void* k2, const void* v2, const void* w_o2, const void* b_o2,
    const void* ln3_w, const void* ln3_b, const void* w_ff1,
    const void* b_ff1, const void* w_ff2, const void* b_ff2,
    const void* w_po, const void* b_po, void* ws,
    void* stats, int B, int T, int C, int heads, int Tk, float gn_eps,
    float q_scale, void* stream_ptr) {
  if (B <= 0 || T <= 0 || C <= 0 || C % kGroups || C > kMaxNormK ||
      heads <= 0 || C % heads || Tk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = B * T;
  const size_t mc = static_cast<size_t>(M) * C;
  const bf16* xin = static_cast<const bf16*>(x);
  bf16* h = static_cast<bf16*>(ws);
  bf16* h2 = h + mc;
  bf16* qkv = h2 + mc;  // (M, 3C); later the cross q as (M, C)
  bf16* att = qkv + 3 * mc;
  bf16* ff = att + mc;  // (M, 4C)
  float* st = static_cast<float*>(stats);

  auto launch = [&]() -> cudaError_t {
    // GroupNorm statistics, then proj_in with the GroupNorm-apply prologue
    gn_stats_kernel<<<dim3(kGroups, B), 256, 0, stream>>>(xin, st, T, C, gn_eps);
    UPGPT_TRY(cudaGetLastError());
    GemmArgs g = with_norm(product(xin, M, C, w_pi, C, h), gn_w, gn_b);
    g.bias = static_cast<const bf16*>(b_pi);
    g.gn_stats = st;
    g.rows_per_sample = T;
    UPGPT_TRY((gemm<kGroupNorm, false>(g, stream)));

    // self-attention: LN1 -> packed QKV (q scaled) -> attention -> to_out + h
    g = with_norm(product(h, M, C, w_q1, 3 * C, qkv), ln1_w, ln1_b);
    g.W[1] = static_cast<const bf16*>(w_k1);
    g.W[2] = static_cast<const bf16*>(w_v1);
    g.parts = 3;
    g.q_cols = C;
    g.q_scale = q_scale;
    UPGPT_TRY((gemm<kLayerNorm, false>(g, stream)));
    UPGPT_TRY(upgpt_attention_launch(
        packed_attention(qkv, 3LL * C, qkv + C, qkv + 2 * C, 3LL * C, att, B,
                         heads, T, T, C),
        1, stream));
    g = product(att, M, C, w_o1, C, h2);
    g.bias = static_cast<const bf16*>(b_o1);
    g.residual = h;
    UPGPT_TRY((gemm<kNone, false>(g, stream)));

    // cross-attention on the precomputed K/V
    g = with_norm(product(h2, M, C, w_q2, C, qkv), ln2_w, ln2_b);
    g.q_cols = C;
    g.q_scale = q_scale;
    UPGPT_TRY((gemm<kLayerNorm, false>(g, stream)));
    UPGPT_TRY(upgpt_attention_launch(
        packed_attention(qkv, C, static_cast<const bf16*>(k2),
                         static_cast<const bf16*>(v2), C, att, B, heads, T, Tk,
                         C),
        1, stream));
    g = product(att, M, C, w_o2, C, h);
    g.bias = static_cast<const bf16*>(b_o2);
    g.residual = h2;
    UPGPT_TRY((gemm<kNone, false>(g, stream)));

    // GEGLU feed-forward
    g = with_norm(product(h, M, C, w_ff1, 4 * C, ff), ln3_w, ln3_b);
    g.bias = static_cast<const bf16*>(b_ff1);
    g.gate_offset = 4 * C;
    UPGPT_TRY((gemm<kLayerNorm, true>(g, stream)));
    g = product(ff, M, 4 * C, w_ff2, C, h2);
    g.bias = static_cast<const bf16*>(b_ff2);
    g.residual = h;
    UPGPT_TRY((gemm<kNone, false>(g, stream)));

    // proj_out + the block's input residual
    g = product(h2, M, C, w_po, C, static_cast<bf16*>(out));
    g.bias = static_cast<const bf16*>(b_po);
    g.residual = xin;
    return gemm<kNone, false>(g, stream);
  };
  return static_cast<int>(launch());
}
