// The uPIT table: negative SI-SNR of every (estimate i, source j) pair,
//   e = est[i, b] - mean,  s = src[j, b] - mean        (rows of T samples)
//   dots = <e, s>,  ss = |s|^2,  scale = dots / (ss + eps)   (1 without
//   scale invariance),  num2 = scale^2 * ss,
//   den2 = sum_t (e - scale * s)^2,
//   out[b, i, j] = max(-20 log10(e) * log(eps + sqrt(num2) /
//                                       (sqrt(den2) + eps)), clamp).
// den2 is summed explicitly, not expanded as |e|^2 - 2 scale dots +
// scale^2 ss, which cancels catastrophically at high SI-SNR.
//
// Replaces: sepreformer_tpu/ops/pallas/pit.py::sisnr_pairwise_neg_fused
//           (_pit_kernel).  Its gradient is the plain version's autograd,
//           as the JAX package's custom_vjp recomputes through XLA.
//
// What bounds it on the H100: it reads est and src once (2 * S * B * T
// floats, 1 MB at S=2, B=2, T=32000) and does ~10 operations per sample
// and pair, so the bound is the bytes, a fraction of a microsecond; a
// launch's own device time (pit_empty_kernel, an empty launch of the same
// shape: about a microsecond) and the passes' dependent reductions and
// cluster barriers are what the time is made of.
//
// Design: the TPU kernel holds one batch entry's [S, T] rows of est and
// src in VMEM and makes its passes there.  Here a thread-block cluster of
// kCluster blocks on neighbouring SMs takes one batch entry b: block r
// holds samples [r chunk, (r + 1) chunk) of all S estimate and S source
// rows in its shared memory, read from device memory once by cp.async
// (16-byte copies where T % 4 == 0).  The three passes stay, because den2
// needs the scale and the scale needs the means: (1) the 2S row sums,
// (2) the S*S dots and the S energies, (3) den2 of every pair as the
// explicit residual.  In each pass a thread sums its samples as float4s,
// kGroup values at a time (independent chains), the block reduces in a
// fixed order (warp shuffles, then the warps' partials in shared memory)
// and writes its partials into slot [rank] of every block's shared memory
// (distributed shared memory; pass 3 into block 0's alone); after one
// cluster.sync() each block adds the slots in rank order, so all hold the
// same bits, and block 0 writes the [S, S] table of b after pass 3.  The
// cluster barrier that lets a block write into the others' shared memory
// is arrived at before the rows land and waited on after pass 1's sums,
// so its latency hides behind them.  8 blocks of 256 threads: the largest
// portable cluster (16, which needs the non-portable size, ran about a
// microsecond faster at the train crop; PERF.md §6).  Where a chunk exceeds
// what a block holds (kCacheBytes: T past 97,984 samples, 12 s, at S = 2),
// the samples past the held part are read from global memory in each pass
// (from L2 after the first).  No atomics: two runs give the same bits.  chip_smoke.py's K11 row holds
// the time against an empty launch of the same shape.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;              // blocks per batch entry
constexpr int kMaxS = 16;                // speakers the partials hold
constexpr int kGroup = 6;                // values a thread sums at once
constexpr int kCacheBytes = 192 * 1024;  // held samples per block, at most

struct Params {
  const float* est;   // [S, B, T]
  const float* src;
  float* out;         // [B, S, S]
  int S, B, T, scale_inv, has_clamp;
  float eps, clamp_db;
  int chunk;          // samples per block (a multiple of 4)
  int held;           // samples per row held in shared memory (the same)
};

// The block's layout in dynamic shared memory, in floats: the held rows
// (est rows 0 .. S-1, then src rows), the warps' partials, and the three
// passes' partials of every block of the cluster, [kCluster][values],
// which the blocks write into each other's.
struct Layout {
  int rows, red, part1, part2, part3, total;
  __host__ __device__ Layout(int S, int held) {
    rows = 0;
    red = 2 * S * held;
    part1 = red + kWarps * (S * S + S);
    part2 = part1 + kCluster * 2 * S;
    part3 = part2 + kCluster * (S * S + S);
    total = part3 + kCluster * S * S;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row v of batch entry b: estimate v, or source v - S.
__device__ __forceinline__ const float* row_of(const Params& p, int v,
                                               int b) {
  return v < p.S ? p.est + ((size_t)v * p.B + b) * p.T
                 : p.src + ((size_t)(v - p.S) * p.B + b) * p.T;
}

// One value of a pass, summed over the batch entry's samples: for rows i
// and j (estimates 0 .. S-1, then sources)
//   kind 0: x_i                                  (the means' pass),
//   kind 1: (x_i - m_i) (x_j - m_j)              (dots and energies),
//   kind 2: ((x_i - m_i) - c (x_j - m_j))^2      (den2).
struct Term {
  int i, j;
  float mi, mj, c;
};

template <int kKind>
__device__ __forceinline__ float term(const Term& a, float xi, float xj) {
  if (kKind == 0) return xi;
  const float ei = xi - a.mi, ej = xj - a.mj;
  if (kKind == 1) return ei * ej;
  const float r = ei - a.c * ej;
  return r * r;
}

// The block's partials of the nv values term_of(v): each thread sums its
// samples in order, kGroup values at a time: first the held float4s
// x4 = tid + kThreads k (samples 4 x4 .. 4 x4 + 3, from shared memory),
// then the rest of the chunk (past the block's room: from global memory,
// float4s where T % 4 == 0; a held tail of scalars otherwise); each warp
// by xor shuffles, then the warps' sums in order.  The block's partial of
// value v goes to slot [rank][v] of part in the shared memory of every
// block of the cluster (all), or of block 0 alone.
template <int kKind, class TermOf>
__device__ __forceinline__ void block_partials(cg::cluster_group& cluster,
                                               const Params& p, int b, int t0,
                                               int n, int held,
                                               const float* rows,
                                               TermOf term_of, int nv,
                                               float* red, float* part,
                                               bool all) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  const int stride4 = p.held / 4, h4 = held / 4;
  const bool vec = (p.T & 3) == 0;   // then held % 4 == 0 and n % 4 == 0
  for (int v0 = 0; v0 < nv; v0 += kGroup) {
    Term a[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      a[u] = term_of(min(v0 + u, nv - 1));  // repeats past nv are dropped
    float acc[kGroup] = {};
    auto add4 = [&](const float4 (&xi)[kGroup], const float4 (&xj)[kGroup]) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        acc[u] += term<kKind>(a[u], xi[u].x, xj[u].x);
        acc[u] += term<kKind>(a[u], xi[u].y, xj[u].y);
        acc[u] += term<kKind>(a[u], xi[u].z, xj[u].z);
        acc[u] += term<kKind>(a[u], xi[u].w, xj[u].w);
      }
    };
#pragma unroll 2
    for (int x4 = tid; x4 < h4; x4 += kThreads) {
      float4 xi[kGroup], xj[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        xi[u] = rows4[a[u].i * stride4 + x4];
        xj[u] = rows4[a[u].j * stride4 + x4];
      }
      add4(xi, xj);
    }
    if (vec) {
      for (int x4 = h4 + tid; x4 < n / 4; x4 += kThreads) {
        float4 xi[kGroup], xj[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          xi[u] = reinterpret_cast<const float4*>(row_of(p, a[u].i, b) +
                                                  t0)[x4];
          xj[u] = reinterpret_cast<const float4*>(row_of(p, a[u].j, b) +
                                                  t0)[x4];
        }
        add4(xi, xj);
      }
    } else {
      for (int x = 4 * h4 + tid; x < n; x += kThreads) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float xi = x < held ? rows[a[u].i * p.held + x]
                                    : row_of(p, a[u].i, b)[t0 + x];
          const float xj = x < held ? rows[a[u].j * p.held + x]
                                    : row_of(p, a[u].j, b)[t0 + x];
          acc[u] += term<kKind>(a[u], xi, xj);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) acc[u] = warp_sum(acc[u]);
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (v0 + u < nv) red[(v0 + u) * kWarps + warp] = acc[u];
    }
  }
  __syncthreads();
  if (kKind == 0)  // the cluster has started (the arrival in the kernel)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int rank = (int)cluster.block_rank();
  for (int v = tid; v < nv; v += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[v * kWarps + w];
    for (int r = 0; r < (all ? kCluster : 1); ++r)
      cluster.map_shared_rank(part, r)[rank * nv + v] = s;
  }
}

// After every block's partials are in part ([rank][v]): their sums over
// the cluster, in the order of the ranks, into total[v] (in every block
// the same bits).
__device__ __forceinline__ void cluster_totals(const float* part, int nv,
                                               float* total) {
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) s += part[r * nv + v];
    total[v] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
pit_sisnr_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float mean[2 * kMaxS], dss[kMaxS * kMaxS + kMaxS];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.S, b = blockIdx.y, tid = threadIdx.x;
  const Layout lay(S, p.held);
  float* rows = smem + lay.rows;
  float* red = smem + lay.red;
  const int t0 = (int)cluster.block_rank() * p.chunk;
  const int n = max(0, min(p.chunk, p.T - t0));  // the block's samples
  const int held = min(n, p.held);

  // the held samples of the 2S rows, read once
  const bool vec = (p.T & 3) == 0;
  for (int v = 0; v < 2 * S; ++v) {
    const float* g = row_of(p, v, b) + t0;
    float* s = rows + v * p.held;
    if (vec) {
      for (int x = 4 * tid; x < held; x += 4 * kThreads)
        tf32x3::cp_async16(s + x, g + x, true);
    } else {
      for (int x = tid; x < held; x += kThreads)
        tf32x3::cp_async4(s + x, g + x, true);
    }
  }
  tf32x3::cp_async_commit();
  // a block writes into the others' shared memory only once every block
  // of the cluster has started: this block's arrival, waited on before
  // its first write (in block_partials)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  tf32x3::cp_async_wait<0>();
  __syncthreads();

  // pass 1: the rows' sums, then their means
  block_partials<0>(
      cluster, p, b, t0, n, held, rows,
      [&](int v) { return Term{v, v, 0.f, 0.f, 0.f}; }, 2 * S, red,
      smem + lay.part1, true);
  cluster.sync();
  cluster_totals(smem + lay.part1, 2 * S, mean);
  __syncthreads();
  for (int v = tid; v < 2 * S; v += kThreads) mean[v] /= p.T;
  __syncthreads();

  // pass 2: dots[i][j] = <e_i, s_j> at i * S + j, then ss[j] at S*S + j
  block_partials<1>(
      cluster, p, b, t0, n, held, rows,
      [&](int v) {
        const int i = v < S * S ? v / S : S + v - S * S, j = S + v % S;
        return Term{i, j, mean[i], mean[j], 0.f};
      },
      S * S + S, red, smem + lay.part2, true);
  cluster.sync();
  cluster_totals(smem + lay.part2, S * S + S, dss);
  __syncthreads();

  // pass 3: den2 of every pair, the explicit residual, summed by block 0
  auto scale_of = [&](int v) {
    return p.scale_inv ? dss[v] / (dss[S * S + v % S] + p.eps) : 1.f;
  };
  block_partials<2>(
      cluster, p, b, t0, n, held, rows,
      [&](int v) {
        const int i = v / S, j = S + v % S;
        return Term{i, j, mean[i], mean[j], scale_of(v)};
      },
      S * S, red, smem + lay.part3, false);
  cluster.sync();
  if (cluster.block_rank() == 0) {
    float* den2 = red;   // free since the pass's partials were summed
    cluster_totals(smem + lay.part3, S * S, den2);
    for (int v = tid; v < S * S; v += kThreads) {
      const float scale = scale_of(v);
      const float num2 = scale * scale * dss[S * S + v % S];
      const float log10e = 0.43429448190325176f;
      float loss = -20.f * log10e *
                   logf(p.eps + sqrtf(num2) / (sqrtf(den2[v]) + p.eps));
      if (p.has_clamp) loss = fmaxf(loss, p.clamp_db);
      p.out[(size_t)b * S * S + v] = loss;
    }
  }
}

// The yardstick: a launch of the same grid, cluster and shared memory
// that does nothing.
__global__ void __launch_bounds__(kThreads) pit_empty_kernel(Params) {}

// The shape of the launch for (S, T): samples per block, held samples
// per row, dynamic shared memory bytes.
void shape(int S, int T, Params& p, size_t& smem) {
  const int chunk = ((T + kCluster - 1) / kCluster + 3) & ~3;
  const int room = (kCacheBytes / (int)sizeof(float) - Layout(S, 0).total) /
                   (2 * S) & ~3;
  p.chunk = chunk;
  p.held = max(0, min(chunk, room));
  smem = sizeof(float) * (size_t)Layout(S, p.held).total;
}

cudaError_t launch(void (*kernel)(Params), const Params& p, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, p.B);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, p);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

int check(int S, int B, int T) {
  return T <= 0 || S > kMaxS || B > 65535 ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// est, src: device float32 [S, B, T] (16-byte aligned); out: device
// float32 [B, S, S]; S <= 16.
extern "C" int sep_pit_sisnr_f32(const void* est, const void* src, void* out,
                                 int S, int B, int T, int scale_inv,
                                 float eps, float clamp_db, int has_clamp,
                                 void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (int err = check(S, B, T)) return err;
  Params p{static_cast<const float*>(est), static_cast<const float*>(src),
           static_cast<float*>(out), S, B, T, scale_inv, has_clamp, eps,
           clamp_db, 0, 0};
  size_t smem = 0;
  shape(S, T, p, smem);
  return (int)launch(pit_sisnr_kernel, p, smem,
                     static_cast<cudaStream_t>(stream));
}

// The empty launch of the same shape as sep_pit_sisnr_f32's at (S, B, T).
extern "C" int sep_pit_empty(int S, int B, int T, void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (int err = check(S, B, T)) return err;
  Params p{};
  p.S = S;
  p.B = B;
  p.T = T;
  size_t smem = 0;
  shape(S, T, p, smem);
  return (int)launch(pit_empty_kernel, p, smem,
                     static_cast<cudaStream_t>(stream));
}

// K11's launch at (S, T): o = {blocks per cluster, held samples per row,
// dynamic shared memory bytes, registers, local (spill) bytes, clusters
// the card holds at once}.
extern "C" int sep_pit_occupancy(int S, int T, int* o) {
  if (int err = check(S, 1, T)) return err;
  Params p{};
  p.S = S;
  p.B = 1;
  p.T = T;
  size_t smem = 0;
  shape(S, T, p, smem);
  cudaError_t err = cudaFuncSetAttribute(
      pit_sisnr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, pit_sisnr_kernel);
  if (err != cudaSuccess) return (int)err;
  o[0] = kCluster;
  o[1] = p.held;
  o[2] = (int)smem;
  o[3] = attr.numRegs;
  o[4] = (int)attr.localSizeBytes;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, 1);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = kCluster;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  config.attrs = cl;
  config.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(&o[5], pit_sisnr_kernel, &config);
}
