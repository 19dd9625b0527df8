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
// (1) the GroupNorm statistics of csrc/gn_stats.cu (one launch, finalized
//     by each image's last block), written as per-image, per-channel
//     affine coefficients a = rstd * gamma, b = beta - mean * a;
// (2) an implicit GEMM on the pipelined wgmma mainloop of gemm_sm90.cuh,
//     with M = B*H*W pixels, N = O and K = 9*C. An M-tile is `rows` whole
//     image rows (or, for images wider than the tile, a segment of one
//     row). For each 64-channel chunk the consumers fetch the tile's
//     (rows + 2) x (cols + 2) halo by cp.async (the next chunk's while the
//     current chunk's taps run), then apply x * a + b and SiLU in float32,
//     round to bf16, as the TPU kernel rounds its padded activation, and
//     write it to shared memory; halo pixels outside the image and channels
//     past C are 0 after the activation, as the TPU kernel zeroes its
//     padding. The nine taps then read that one tile at shifted row
//     addresses (ldmatrix -> register-A wgmma) against the weights of the
//     tap, which TMA brings through the ring from the (9, O, C) packing.
//     So each input element is activated (rows + 2) / rows times per N
//     tile instead of once per tap. The accumulators start from the conv
//     bias (as _kernel starts from the bias); where the tiles are fewer than
//     the SMs, the plan splits the channel chunks and the last block of a
//     tile sums the partials in split order.
// The variance is clamped at 0, as the port's plain group_norm does; _kernel
// does not clamp, which only matters where rounding drives E[x^2] - E[x]^2
// below zero. x may be float32: the same kernel, instantiated for float32
// loads and stores, with its own launch count in the wrapper.
// Weights come packed by the caller as (9, O, C) bf16, channels contiguous;
// the wrapper packs once per version of the conv weight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_sm90.cuh"
#include "gn_stats.cuh"

namespace {

using bf16 = __nv_bfloat16;
using sm90::kBK;

constexpr int kHaloPitch = 72;  // bf16 per halo pixel: 64 channels + 16 B

struct Conv {
  const void* x;       // (N, H, W, C) in T
  const float* coef;   // (N, 2, C): a; b
  const float* cbias;  // (O)
  void* out;           // (N, H, W, O) in T
  int N, H, W, C, O;
  int wg, rows, cols, bn, splits, chunks_per_split, stages;
  float* ws;
  int* counters;
};

// gemm_plan.conv_smem
__host__ __device__ inline int conv_smem(int wg, int rows, int cols, int bn,
                                         int itemsize, int stages) {
  // the activated bf16 halo, then its raw copy in x's type
  const int halo = (rows + 2) * (cols + 2) * (kHaloPitch * 2 + kBK * itemsize);
  const int staging = 64 * wg * (bn * itemsize + 16);
  const int main = halo + stages * bn * 128;
  return main > staging ? main : staging;
}

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

// grid (O tiles, M tiles, splits); block 128 * (wg + 1): wg
// consumer warpgroups of 64 pixels, then the producer warpgroup
template <typename T, int BN>
__global__ void __launch_bounds__(
    sm90::block_threads(sm90::max_warpgroups(BN, 1)), 1)
conv_kernel(const __grid_constant__ CUtensorMap map_w, const Conv a) {
  constexpr int R = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[sm90::kMaxStages], empty[sm90::kMaxStages];
  __shared__ int last;
  uint8_t* smem = sm90::align1024(smem_raw);

  const int threads = 128 * a.wg;
  const int tiles_x = (a.W + a.cols - 1) / a.cols;
  const int tiles_y = (a.H + a.rows - 1) / a.rows;
  const int img = blockIdx.y / (tiles_y * tiles_x);
  const int rem = blockIdx.y % (tiles_y * tiles_x);
  const int y0 = (rem / tiles_x) * a.rows, x0 = (rem % tiles_x) * a.cols;
  const int n0 = blockIdx.x * BN;
  const int chunks = (a.C + kBK - 1) / kBK;
  const int c_first = blockIdx.z * a.chunks_per_split;
  const int steps = 9 * min(a.chunks_per_split, chunks - c_first);
  const sm90::Ring ring{smem, full, empty, a.stages, BN * 128};
  bf16* halo = reinterpret_cast<bf16*>(smem + a.stages * BN * 128);
  const int hcols = a.cols + 2;
  if (threadIdx.x == 0) sm90::ring_init(ring, 4 * a.wg);
  __syncthreads();

  constexpr int kMaxWg = sm90::max_warpgroups(BN, 1);
  const int wg = sm90::warpgroup_index();
  if (wg == a.wg) {  // the producer warpgroup
    sm90::producer_registers<kMaxWg>();
    if (threadIdx.x == threads)
      sm90::produce(ring, steps, BN * 128,
                    [&](int s, uint8_t* dst, uint64_t* bar) {
                      sm90::tma_3d(dst, &map_w, bar, (c_first + s / 9) * kBK,
                                   n0, s % 9);
                    });
    return;
  }
  sm90::consumer_registers<kMaxWg>();

  const int lane = threadIdx.x % 32;
  // this lane's A row: pixel p of the tile, its halo position (pixels past
  // the tile read pixel 0's and are never stored)
  int p = wg * 64 + ((threadIdx.x / 32) % 4) * 16 + (lane & 15);
  if (p >= a.rows * a.cols) p = 0;
  const int hbase = (p / a.cols + 1) * hcols + p % a.cols + 1;
  const T* x = static_cast<const T*>(a.x);
  const float* ca = a.coef + static_cast<size_t>(img) * 2 * a.C;
  const float* cb = ca + a.C;
  // the halo's raw values of one chunk, [pixel][64 channels] in x's type,
  // fetched by cp.async (zeros outside the image and past C)
  const int hpx = (a.rows + 2) * hcols;
  T* raw = reinterpret_cast<T*>(halo + hpx * kHaloPitch);
  auto fetch_raw = [&](int chunk) {
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
    const int c0 = chunk * kBK;
    for (int i = threadIdx.x; i < hpx * (kBK / E); i += threads) {
      const int hp = i / (kBK / E), c = c0 + (i % (kBK / E)) * E;
      const int yy = y0 - 1 + hp / hcols, xx = x0 - 1 + hp % hcols;
      const bool in = yy >= 0 && yy < a.H && xx >= 0 && xx < a.W && c < a.C;
      mma::cp_async<16>(
          raw + hp * kBK + (i % (kBK / E)) * E,
          in ? x + ((static_cast<size_t>(img) * a.H + yy) * a.W + xx) * a.C + c
             : x,
          in);
    }
    mma::cp_async_commit();
  };

  float acc[1][R];
  sm90::for_pairs<BN>(acc[0], [&](int, int c, float& v0, float& v1) {
    const bool first = blockIdx.z == 0;
    v0 = first && n0 + c < a.O ? a.cbias[n0 + c] : 0.f;
    v1 = first && n0 + c + 1 < a.O ? a.cbias[n0 + c + 1] : 0.f;
  });
  sm90::consume<BN, 1>(
      ring, steps, acc,
      [&](int s) {
        if (s % 9) return;
        // a new channel chunk: activate its halo once, from the raw copy
        // that was fetched while the last chunk's taps ran
        const int k = s / 9;
        if (k == 0) fetch_raw(c_first);
        mma::cp_async_wait<0>();
        sm90::consumer_sync(threads);  // raw arrived; the last taps are done
        const int c0 = (c_first + k) * kBK;
        for (int i = threadIdx.x; i < hpx * (kBK / 8); i += threads) {
          const int hp = i / (kBK / 8), v = i % (kBK / 8), c = c0 + v * 8;
          const int yy = y0 - 1 + hp / hcols, xx = x0 - 1 + hp % hcols;
          float f[8];
          load8(raw + hp * kBK + v * 8, f);
          const bool in = yy >= 0 && yy < a.H && xx >= 0 && xx < a.W &&
                          c < a.C;
          uint4 q;
          __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            float y[2] = {0.f, 0.f};
            if (in) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float z = f[2 * l + e] * ca[c + 2 * l + e] +
                                cb[c + 2 * l + e];
                y[e] = z / (1.f + expf(-z));
              }
            }
            h2[l] = __floats2bfloat162_rn(y[0], y[1]);
          }
          *reinterpret_cast<uint4*>(halo + hp * kHaloPitch + v * 8) = q;
        }
        sm90::consumer_sync(threads);  // the halo is ready, raw is free
        if (k + 1 < steps / 9) fetch_raw(c_first + k + 1);
      },
      [&](int s, int kk, uint8_t*, uint32_t(&frag)[4]) {
        const int tap = s % 9;
        const int hp = hbase + (tap / 3 - 1) * hcols + tap % 3 - 1;
        // channels past C are 0 in the halo and in the weights' boxes
        mma::ldsm_x4(frag, halo + hp * kHaloPitch + kk * 16 + (lane >> 4) * 8);
      });
  sm90::consumer_sync(threads);  // the staging tile reuses the halo

  if (a.splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* ws = a.ws + static_cast<size_t>(tile) * a.splits * R * threads;
    if (!sm90::split_reduce(acc, ws, a.counters + tile, blockIdx.z, a.splits,
                            threads, &last))
      return;
  }

  constexpr int P = sm90::staging_pitch<T>(BN);
  T* staged = reinterpret_cast<T*>(smem) + wg * 64 * P;
  sm90::for_pairs<BN>(acc[0], [&](int r, int c, float v0, float v1) {
    sm90::put2(staged + r * P + c, v0, v1);
  });
  sm90::warpgroup_sync(wg);
  constexpr int V = 16 / sizeof(T);
  T* out = static_cast<T*>(a.out);
  sm90::copy_rows<T, BN>(staged, min(BN, a.O - n0), a.O % V == 0,
                         [&](int r) -> T* {
                           const int q = wg * 64 + r;
                           const int y = y0 + q / a.cols, xx = x0 + q % a.cols;
                           if (q >= a.rows * a.cols || y >= a.H || xx >= a.W)
                             return nullptr;
                           return out + ((static_cast<size_t>(img) * a.H + y) *
                                             a.W + xx) * a.O + n0;
                         });
}

template <typename T, int BN>
cudaError_t launch_bn(const Conv& a, const CUtensorMap& map,
                      cudaStream_t stream) {
  auto kernel = conv_kernel<T, BN>;
  static const cudaError_t opted = sm90::allow_smem(kernel);
  if (opted != cudaSuccess) return opted;
  const long long m_tiles = static_cast<long long>(a.N) *
                            ((a.H + a.rows - 1) / a.rows) *
                            ((a.W + a.cols - 1) / a.cols);
  const dim3 grid((a.O + BN - 1) / BN, static_cast<unsigned>(m_tiles),
                  a.splits);
  const int smem = sm90::kAlignSlack +
                   conv_smem(a.wg, a.rows, a.cols, BN, sizeof(T), a.stages);
  kernel<<<grid, sm90::block_threads(a.wg), smem, stream>>>(map, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t conv(Conv a, const int* plan, const void* w, float* ws,
                 long long ws_floats, int* counters, int n_counters,
                 cudaStream_t stream) {
  a.wg = plan[0];
  a.rows = plan[1];
  a.cols = plan[2];
  a.bn = plan[3];
  a.splits = plan[4];
  a.chunks_per_split = plan[5];
  a.stages = plan[6];
  const int chunks = (a.C + kBK - 1) / kBK;
  const bool whole_rows = a.cols == a.W;
  // 64 or 128 columns: wider accumulators spill next to the halo loop
  if ((a.bn != 64 && a.bn != 128) || a.wg < 1 ||
      a.wg > sm90::max_warpgroups(a.bn, 1) || a.rows < 1 || a.cols < 1 ||
      a.rows * a.cols > 64 * a.wg ||
      !(whole_rows || (a.rows == 1 && a.cols < a.W)) ||
      a.stages < sm90::kMinStages || a.stages > sm90::kMaxStages ||
      a.splits < 1 || a.chunks_per_split < 1 ||
      (a.splits - 1) * a.chunks_per_split >= chunks ||
      a.splits * a.chunks_per_split < chunks ||
      !sm90::smem_fits(conv_smem(a.wg, a.rows, a.cols, a.bn, sizeof(T),
                                 a.stages)))
    return cudaErrorInvalidValue;
  const long long m_tiles = static_cast<long long>(a.N) *
                            ((a.H + a.rows - 1) / a.rows) *
                            ((a.W + a.cols - 1) / a.cols);
  const long long tiles = m_tiles * ((a.O + a.bn - 1) / a.bn);
  if (m_tiles > 2147483647LL || (a.O + a.bn - 1) / a.bn > 65535 ||
      (a.splits > 1 && (tiles > n_counters ||
                        tiles * a.splits * a.bn / 2 * 128 * a.wg > ws_floats)))
    return cudaErrorInvalidValue;
  a.ws = ws;
  a.counters = counters;
  CUtensorMap map;
  const uint64_t dims[3] = {static_cast<uint64_t>(a.C),
                            static_cast<uint64_t>(a.O), 9};
  const uint32_t box[3] = {kBK, static_cast<uint32_t>(a.bn), 1};
  const cudaError_t e = sm90::weight_map(&map, w, 3, dims, box);
  if (e != cudaSuccess) return e;
  return a.bn == 64 ? launch_bn<T, 64>(a, map, stream)
                    : launch_bn<T, 128>(a, map, stream);
}

}  // namespace

// x: contiguous NHWC (N, H, W, C), bf16 (is_bf16 = 1) or float32, C a
// multiple of 8; gamma, beta: (C) float32; w: (9, O, C) bf16, tap-major
// (tap = 3 * ky + kx); cbias: (O) float32; out: (N, H, W, O) in x's type;
// ws: (N, chunks, 2, C) and coef: (N, 2, C) float32 scratch; stats_counters:
// N int32, zero, reset by the statistics launch; plan: 7 host ints
// (gemm_plan.ConvPlan.as_ints); split_ws: ws_floats float32 and counters:
// n_counters int32, zero, where the plan splits the chunks.
extern "C" int upgpt_fused_resblock(const void* x, const void* gamma,
                                    const void* beta, const void* w,
                                    const void* cbias, void* out, void* ws,
                                    void* coef, void* stats_counters,
                                    const int* plan,
                                    void* split_ws, long long ws_floats,
                                    void* counters, int n_counters, int N,
                                    int H, int W, int C, int O, int G,
                                    int chunks, float eps, int is_bf16,
                                    void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || O <= 0 || C <= 0 || C % 8 ||
      plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* cf = static_cast<float*>(coef);
  cudaError_t e = upgpt::group_stats(
      x, static_cast<float*>(ws), cf, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<int*>(stats_counters), N,
      H * W, C, G, chunks, eps, is_bf16, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  Conv a = {};
  a.x = x;
  a.coef = cf;
  a.cbias = static_cast<const float*>(cbias);
  a.out = out;
  a.N = N;
  a.H = H;
  a.W = W;
  a.C = C;
  a.O = O;
  float* sws = static_cast<float*>(split_ws);
  int* cnt = static_cast<int*>(counters);
  return static_cast<int>(
      is_bf16 ? conv<bf16>(a, plan, w, sws, ws_floats, cnt, n_counters, st)
              : conv<float>(a, plan, w, sws, ws_floats, cnt, n_counters, st));
}
