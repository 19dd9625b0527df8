// One-pass GroupNorm (+SiLU) over NHWC for Hopper (sm_90a): one thread-block
// cluster per image.
//
// Replaces upgpt_tpu/ops/fused_gn.py::_fused_gn_forward (_gn_kernel): per
// image and group, float32 sum and sum of squares, var = E[x^2] - E[x]^2
// clamped at 0 (as the plain group_norm of ops/basic.py; _gn_kernel does not
// clamp, which only matters where rounding drives it below zero), then
// a = rstd * scale, b = shift - mean * a, x * a + b, optionally x *
// sigmoid(x), written once in the input type.
//
// What bounds it on this card: bytes, and at the paths' small shapes the
// latency of one launch. It does ~10 float operations per element and must
// read and write the activation once each (the U-Net's GroupNorm inputs at
// batch 12: 0.1 to 12.4 MB in bf16).
//
// The TPU kernel holds one whole image per grid step. Its Hopper
// counterpart is a cluster of K blocks per image, grid (K, N): K a power of
// two, as many as one wave of the card holds (N K <= 132) up to 16 (the
// non-portable cluster size), and at least enough to hold the image:
// - block r of an image takes the contiguous slab of rows
//   [r * rows, (r + 1) * rows) across all C channels and copies it into its
//   shared memory by 16-byte cp.async, in x's own type (bf16 staging is
//   exact and halves the footprint of float32 staging); a slab of at most
//   four rows a thread stays in registers instead, loaded straight from x;
// - 512 threads a block for a slab over 16 KB, so that an SM holding one
//   block has 16 warps to hide the latency of the shared-memory walks and
//   of SiLU's two MUFU operations an element; 256 for a smaller one, whose
//   barriers then cost less; each thread keeps one 16-byte column of the
//   slab (8 bf16 or 4 float32 channels) and sums its rows t / width,
//   + threads / width, ... in registers, four rows' loads at a time;
//   each channel's row lanes are added in order, then all threads fold
//   the channels into the block's [2][G] group sums (csrc/gn_fold.cuh: a
//   few threads per group, each its channels in order, then a fixed
//   butterfly);
// - a cluster barrier (barrier.cluster arrive.release / wait.acquire), then
//   every block reads the K blocks' group sums through distributed shared
//   memory (mapa to a peer's address, then plain loads) in rank order, so
//   all K compute the same statistics, bit for bit, with no float atomics;
// - each block normalizes its own slab from shared memory with a and b in
//   registers, and writes it with 16-byte stores. A second cluster barrier
//   before exit keeps every block resident until its peers have read its
//   group sums. One read and one write of x, one launch.
// The rows per block and K come from ops/fused_gn.py:fused_gn_plan; the
// entry point re-checks them and refuses a cluster the card cannot hold
// (cudaOccupancyMaxActiveClusters below 1).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "gn_fold.cuh"

namespace {

constexpr int kRows = 4;  // rows a thread has in flight when it walks them
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
// opt-in dynamic shared memory per block on sm_90
constexpr size_t kSmemLimit = 232448;

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);  // values in one 16-byte load
};

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the generic address of `p`'s counterpart in block `rank` of the cluster
__device__ __forceinline__ const float* peer(const float* p, int rank) {
  uint64_t q;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(q)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(q);
}

// Shared memory, in bytes: the slab [rows][C] in T; the row lanes' sums
// [lanes][2][C] float; scale and shift [2][C]; the block's group sums
// [2][G] (read by the peers) and the image's [2][G] mean, rstd.
int row_lanes(int C, size_t itemsize, int threads) {
  const int cv = static_cast<int>(C * itemsize / 16);
  return threads / (cv < threads ? cv : threads);
}

size_t smem_bytes(int rows, int C, int G, size_t itemsize, int threads) {
  return static_cast<size_t>(rows) * C * itemsize +
         sizeof(float) *
             ((static_cast<size_t>(row_lanes(C, itemsize, threads)) + 1) * 2 *
                  C +
              4 * static_cast<size_t>(G));
}

// grid (K, N), cluster (K, 1, 1): block `rank` of image n; kThreads is 256
// for a slab of at most 16 KB, 512 for a larger one (fewer warps pass a
// block's barriers sooner; more hide the latency of a larger slab's walks)
template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads)
cluster_gn_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, T* __restrict__ out, int HW,
                  int C, int G, int rows, float cnt, float eps,
                  int with_silu) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = gridDim.x, rank = blockIdx.x, n = blockIdx.y;
  const int t = threadIdx.x;
  const int row0 = rank * rows;
  const int nrows = max(0, min(HW - row0, rows));
  const int cv = C / V, width = min(cv, kThreads);
  const float inv_width = __frcp_rn(static_cast<float>(width));
  const int lanes = upgpt::quot(kThreads, inv_width);
  const int rl = upgpt::quot(t, inv_width), lane_col = t - rl * width;
  T* slab = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + static_cast<size_t>(rows) * C *
                                                   sizeof(T));
  float* aff = red + static_cast<size_t>(lanes) * 2 * C;  // scale; shift
  float* grp = aff + 2 * C;                               // [2][G] sums
  float* gstat = grp + 2 * G;                             // [2][G] mean, rstd
  const size_t first = (static_cast<size_t>(n) * HW + row0) * C;

  // (1) the slab, contiguous in NHWC. A slab of at most kRows rows a
  // thread (one column each) stays in registers, loaded straight from x;
  // a larger one is staged in shared memory by 16-byte cp.async.
  const bool in_regs = cv <= kThreads && nrows <= kRows * lanes;
  const T* src = in_regs ? x + first : slab;  // row r at src + r * C
  // scale and shift ride along, so that (4) finds them in shared memory
  for (int i = t; i < C / 4; i += kThreads) {
    cp_async16(aff + 4 * i, scale + 4 * i);
    cp_async16(aff + C + 4 * i, shift + 4 * i);
  }
  if (!in_regs) {
    const char* from = reinterpret_cast<const char*>(x + first);
    char* dst = reinterpret_cast<char*>(slab);
    const int copies = static_cast<int>(static_cast<size_t>(nrows) * C *
                                        sizeof(T) / 16);
    for (int i = t; i < copies; i += kThreads)
      cp_async16(dst + static_cast<size_t>(i) * 16,
                 from + static_cast<size_t>(i) * 16);
    cp_async_wait_all();
    __syncthreads();
  }

  // (2) per-channel sums: each row lane in registers, kRows rows' loads
  // at a time, then the row lanes' sums folded into groups
  float v[kRows][V];  // with in_regs, the thread's rows until (4)
  if (rl < lanes) {
    for (int col = lane_col; col < cv; col += width) {
      float s1[V], s2[V];
#pragma unroll
      for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
      const T* p = src + col * V;
      for (int r = rl; r < nrows; r += kRows * lanes) {
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (r + u * lanes < nrows) {
            load_vec(p + static_cast<size_t>(r + u * lanes) * C, v[u]);
          } else {
#pragma unroll
            for (int i = 0; i < V; ++i) v[u][i] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i) {
            s1[i] += v[u][i];
            s2[i] += v[u][i] * v[u][i];
          }
      }
      float* o = red + static_cast<size_t>(rl) * 2 * C + col * V;
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        *reinterpret_cast<float4*>(o + i) =
            make_float4(s1[i], s1[i + 1], s1[i + 2], s1[i + 3]);
        *reinterpret_cast<float4*>(o + C + i) =
            make_float4(s2[i], s2[i + 1], s2[i + 2], s2[i + 3]);
      }
    }
  }
  cp_async_wait_all();  // scale and shift
  __syncthreads();
  // each channel's row lanes in order, into lane 0's row (in place: only
  // this thread reads index c), then the channels into groups
  for (int c = t; c < C; c += kThreads) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < lanes; ++l) {
      a += red[static_cast<size_t>(l) * 2 * C + c];
      b += red[static_cast<size_t>(l) * 2 * C + C + c];
    }
    red[c] = a;
    red[C + c] = b;
  }
  __syncthreads();
  upgpt::fold_groups(red, 1, 0, C, G, grp);

  // (3) the image's statistics: the K blocks' group sums in rank order
  // (a block that is the whole image needs no cluster barrier)
  if (K > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  for (int g = t; g < G; g += kThreads) {
    float v[2][kMaxCluster];  // every peer's loads in flight at once
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < K) {
        const float* q = K > 1 ? peer(grp, r) : grp;
        v[0][r] = q[g];
        v[1][r] = q[G + g];
      }
    }
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < K) {
        a += v[0][r];
        b += v[1][r];
      }
    }
    const float mean = a / cnt;
    gstat[g] = mean;
    gstat[G + g] = rsqrtf(fmaxf(b / cnt - mean * mean, 0.f) + eps);
  }
  if (K > 1) cluster_arrive();  // this block has read its peers' sums
  __syncthreads();

  // (4) normalize the slab from shared memory, kRows rows at a time,
  // 16-byte stores
  if (rl < lanes) {
    for (int col = lane_col; col < cv; col += width) {
      // scale and shift by 16-byte loads (scalar loads at a stride of V
      // floats would conflict V ways in the banks)
      float a[V], b[V];
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        *reinterpret_cast<float4*>(a + i) =
            *reinterpret_cast<const float4*>(aff + col * V + i);
        *reinterpret_cast<float4*>(b + i) =
            *reinterpret_cast<const float4*>(aff + C + col * V + i);
      }
      const float inv_cpg = __frcp_rn(static_cast<float>(C / G));
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int g = upgpt::quot(col * V + i, inv_cpg);
        a[i] *= gstat[G + g];
        b[i] -= gstat[g] * a[i];
      }
      const T* p = slab + col * V;
      T* q = out + first + col * V;
      for (int r = rl; r < nrows; r += kRows * lanes) {
        if (!in_regs) {
#pragma unroll
          for (int u = 0; u < kRows; ++u)
            if (r + u * lanes < nrows)
              load_vec(p + static_cast<size_t>(r + u * lanes) * C, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (r + u * lanes >= nrows) break;
          float y[V];
#pragma unroll
          for (int i = 0; i < V; ++i) {
            y[i] = v[u][i] * a[i] + b[i];
            if (with_silu) y[i] = __fdividef(y[i], 1.f + __expf(-y[i]));
          }
          store_vec(q + static_cast<size_t>(r + u * lanes) * C, y);
        }
      }
    }
  }
  if (K > 1) cluster_wait();  // no block leaves while a peer reads its sums
}

// The kernel's shared-memory attribute only grows (it is the function's,
// not the launch's), and the occupancy query runs once per (type, K,
// bytes).
std::mutex g_lock;
size_t g_smem_set[2][2] = {};
std::map<std::tuple<int, int, int, size_t>, cudaError_t> g_checked;

template <typename T, int kThreads>
cudaError_t prepare(const cudaLaunchConfig_t& cfg, int K, size_t smem) {
  const int type = sizeof(T) == 2 ? 0 : 1, wide = kThreads == 512;
  const auto key = std::make_tuple(type, wide, K, smem);
  std::lock_guard<std::mutex> hold(g_lock);
  const auto it = g_checked.find(key);
  if (it != g_checked.end()) return it->second;
  cudaError_t e = cudaSuccess;
  const auto kernel = cluster_gn_kernel<T, kThreads>;
  if (smem > g_smem_set[type][wide]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess) g_smem_set[type][wide] = smem;
  }
  if (e == cudaSuccess && K > kPortableCluster)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int clusters = 1;
  if (e == cudaSuccess && K > 1)
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e == cudaSuccess && clusters < 1) e = cudaErrorInvalidConfiguration;
  g_checked[key] = e;
  return e;
}

template <typename T, int kThreads>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   void* out, int N, int HW, int C, int G, int K, int rows,
                   float eps, int with_silu, cudaStream_t stream) {
  const size_t smem = smem_bytes(rows, C, G, sizeof(T), kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, N, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1;  // a one-block image is a plain launch
  cudaError_t e = prepare<T, kThreads>(cfg, K, smem);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, cluster_gn_kernel<T, kThreads>,
                         static_cast<const T*>(x),
                         static_cast<const float*>(scale),
                         static_cast<const float*>(shift), static_cast<T*>(out),
                         HW, C, G, rows,
                         static_cast<float>(HW) * static_cast<float>(C / G),
                         eps, with_silu);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t launch_threads(int threads, const void* x, const void* scale,
                           const void* shift, void* out, int N, int HW, int C,
                           int G, int K, int rows, float eps, int with_silu,
                           cudaStream_t stream) {
  return threads == 256
             ? launch<T, 256>(x, scale, shift, out, N, HW, C, G, K, rows, eps,
                              with_silu, stream)
             : launch<T, 512>(x, scale, shift, out, N, HW, C, G, K, rows, eps,
                              with_silu, stream);
}

// x, out: contiguous (N, HW, C), bf16 (is_bf16 = 1) or float32, C * the
// type's size a multiple of 16 bytes; scale, shift: (C) float32, 16-byte
// aligned; K: blocks per image, a power of two up to 16; rows: rows per
// block, K * rows >= HW (blocks past the image's rows stage nothing);
// threads: 256 or 512 a block (ops/fused_gn.py:cluster_plan).
extern "C" int upgpt_fused_group_norm(const void* x, const void* scale,
                                      const void* shift, void* out, int N,
                                      int HW, int C, int G, int K, int rows,
                                      int threads, float eps, int with_silu,
                                      int is_bf16, void* stream) {
  const size_t itemsize = is_bf16 ? 2 : 4;
  if (N <= 0 || N > 65535 || HW <= 0 || C <= 0 || G <= 0 || C % G ||
      (C * itemsize) % 16 || K < 1 || K > kMaxCluster || (K & (K - 1)) ||
      rows < 1 || rows > HW || static_cast<long long>(K) * rows < HW ||
      (threads != 256 && threads != 512) ||
      smem_bytes(rows, C, G, itemsize, threads) > kSmemLimit ||
      reinterpret_cast<uintptr_t>(scale) % 16 ||
      reinterpret_cast<uintptr_t>(shift) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_threads<__nv_bfloat16>(threads, x, scale, shift, out,
                                              N, HW, C, G, K, rows, eps,
                                              with_silu, st)
              : launch_threads<float>(threads, x, scale, shift, out, N, HW, C,
                                      G, K, rows, eps, with_silu, st));
}

__global__ void empty_kernel() {}

// An empty kernel of `blocks` blocks of 32 threads, launched as clusters of
// `cluster` blocks (0: a plain launch): the device time of a launch that
// does nothing, the latency floor beside the GroupNorm kernels' bounds.
extern "C" int upgpt_empty(int blocks, int cluster, void* stream) {
  if (blocks < 1 || cluster < 0 || cluster > kMaxCluster ||
      (cluster > 0 && blocks % cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(32, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0;
  if (cluster > kPortableCluster) {
    const cudaError_t e = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
