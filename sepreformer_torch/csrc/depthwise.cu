// The CLA's large-kernel "same" depthwise conv, its forward (K4) and its
// backward (K5, K6):
//   y[b, t, c] = sum_tap x[b, t + tap - h, c] * w[c, tap] + bias[c],
//   h = (K - 1) / 2, zero padding outside [0, T):
//   dx[b, t, c] = sum_tap w[c, tap] * dy[b, t + h - tap, c]
//   dw[c, tap]  = sum_{b,t} x[b, t + tap - h, c] * dy[b, t, c]
//   db[c]       = sum_{b,t} dy[b, t, c]
// x, dy and dx are channels-last [B, T, C]; w and dw are in the Conv1d
// weight's own layout [C, 1, K], so the parameter reaches the kernel, and
// its gradient leaves it, without a copy.
//
// Replaces: K4, sepreformer_tpu/ops/pallas/depthwise.py::_impl_fwd (body
//           _fwd_kernel), the Pallas forward that no route of either
//           package takes (depthwise_large's forward is the library
//           convolution); K5, depthwise_large's
//           backward (_impl_bwd, body _bwd_kernel), and K6, its dw/db-only
//           form (_impl_bwd_w, body _bwd_w_kernel) that the JAX package's
//           BWD_MODE = "conv" runs, with dx left to a library convolution
//           of dy with the flipped kernel.  The forward stays the library
//           convolution, as the JAX package's forward stays XLA's.  The JAX
//           package takes its kernels only where C % 128 == 0 (a TPU tiling
//           rule); these serve any T and any C, odd K <= 81.
//
// What bounds it on the H100: K4 reads x once and writes y once (32.8 MB
// at [4, 8000, 128], 0.0098 ms) and does K FMAs per element (0.008 ms):
// bound by the bytes.  K5 reads x and dy once and writes dx once
// (3 * B*T*C floats, 49 MB at [4, 8000, 128]) and does 2K FMAs per
// element (1.1 GFLOP at K=65), so the bytes and the float32 operations
// give about the same bound, ~0.016 ms.  K6 reads x and dy once (33 MB,
// 0.0098 ms) and does K FMAs per element (0.008 ms): bound by the bytes.
// A depthwise conv is a per-channel Toeplitz product (a matrix-vector
// product per channel), so all three run on the CUDA cores, whose FMA
// rate an SM reaches only if its shared memory feeds it: 128 bytes a
// clock against 128 FMAs, so at least 4 FMAs per float loaded.
//
// Design of K5 and K6 (namespace tiled).  The TPU summed dw and db across
// a sequential grid in VMEM.  Here blocks run in parallel and in no
// order, so each block writes its own partial sums [K + 1, C] (the last
// row is db) and a second launch adds the partials in a fixed order: the
// result is the same on every run, with no float atomics.  A block takes
// 32 channels (one per lane) of one row b and a chunk of consecutive
// tiles; the launcher sizes the chunks so that the blocks fill the SMs
// about once (geometry and plan below).  The K taps are G groups of Q <=
// 16 (Q * G = KP >= K; taps past K carry a zero weight in dx and are not
// stored in dw); a block has G * S warps (S row splits, at least 8 warps)
// and its tiles TT = G * S * Q rows.  A ring of two buffers stages each
// tile's x and dy rows with their halo (TT + KP rows, zero outside [0,
// T)) by cp.async, 16-byte copies along channels (4-byte ones where C %
// 4 != 0), the next tile in flight while the current one is computed.
// Every warp takes an equal share of both products, each through a
// register window that slides one row per step, so Q FMAs cost two
// shared loads:
//   dx: Q consecutive rows of the tile, every tap; the window holds Q dy
//       rows, and each tap loads one weight (flipped) and one new row;
//   dw: Q consecutive taps (group g) over KP rows of the tile (split s);
//       the window holds Q x rows, each row loads one dy and one new x;
//       db rides on group 0's dy loads.  The partial dw stays in
//       registers across the chunk; the S splits are added in order
//       through shared memory at its end.
// Within a block of Q steps, window slot (step + r) % Q holds row r of
// the step, so the slide is a renaming of registers, not moves.  K6 is
// the same kernel without the dx products and the weight's staging.  On
// the card the FMA loops set the pace, at about half the CUDA cores'
// rate with or without their shared loads (PERF.md has the ablations).
//
// K4 (depthwise_fwd_kernel) is K5's dx with the weight unflipped: the
// same geometry, chunk plan, ring (Stager, of x rows alone) and register
// window (dx_rows), the weight staged as it is, the bias as the sums'
// start, and no dy, dw or partials, so one launch a call.  Every warp
// computes kFwdWindows windows of Q rows of a tile over all KP taps.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"  // cp_async16, cp_async4 and their group helpers

namespace {
namespace tiled {

constexpr int kLanes = 32;         // channels per block, one per lane
constexpr int kMaxK = 81;          // the widest kernel (taps)
constexpr int kMaxQ = 16;          // the widest register window
constexpr int kMinWarps = 8;       // row splits fill a block to this
constexpr int kMaxThreads = 384;   // 12 warps at K 81 (G 6, S 2)
constexpr int kSlices = 8;         // the reduction's partial slices
constexpr int kFwdWindows = 2;     // K4's register windows a warp

// The tiling for K taps: G groups of Q taps (KP = G * Q >= K), S row
// splits, G * S warps and tiles of TT = G * S * Q rows.  A tile stages
// SR = TT + KP rows from K / 2 rows before its first: the windows read
// rows up to TT + KP - 2, and their last slide loads row TT + KP - 1.
// K4's tiles are kFwdWindows times as tall (a warp runs that many
// windows of Q rows), and stage their rows the same way.
struct Geometry {
  int G, Q, S, warps, TT, KP, SR;
};

inline __host__ __device__ Geometry fwd_geometry(Geometry g) {
  g.TT *= kFwdWindows;
  g.SR = g.TT + g.KP;
  return g;
}

inline __host__ __device__ Geometry geometry(int K) {
  Geometry g;
  g.G = (K + kMaxQ - 1) / kMaxQ;
  g.Q = (K + g.G - 1) / g.G;
  g.S = (kMinWarps + g.G - 1) / g.G;
  g.warps = g.G * g.S;
  g.TT = g.warps * g.Q;
  g.KP = g.G * g.Q;
  g.SR = g.TT + g.KP;
  return g;
}

// K4 (the forward), K5 (dx, dw, db) or K6 (dw, db)
enum class Kind { kFwd, kBwd, kDw };

// two buffers of x rows [SR][kLanes] (and of dy rows, in the backward),
// then the weight [KP][kLanes] (flipped for K5's dx; none for K6); g is
// the kind's own geometry
size_t smem_bytes(const Geometry& g, Kind kind) {
  const size_t rows = (size_t)(kind == Kind::kFwd ? 2 : 4) * g.SR * kLanes;
  return sizeof(float) *
         (rows + (kind == Kind::kDw ? 0 : (size_t)g.KP * kLanes));
}

// N windows of Q consecutive rows of one channel's correlation, window n
// from row n * Q: acc[n][r] = start + sum_{j < KP} wf[j] * col[n Q + r +
// j] (rows of kLanes floats): K5's dx with wf the weight flipped along
// its taps (N = 1), K4's y with the weight as it is (N = kFwdWindows).
// Window slot (j + r) % Q holds row r + j: each tap takes one weight for
// all N windows and one new row for each into the slot of the row it no
// longer needs.
template <int Q, int N>
__device__ __forceinline__ void dx_rows(const float* col, const float* wf,
                                        int KP, float start,
                                        float (&acc)[N][Q]) {
  float win[N][Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      acc[n][q] = start;
      win[n][q] = col[(n * Q + q) * kLanes];
    }
  }
  for (int jb = 0; jb < KP; jb += Q) {
#pragma unroll
    for (int jj = 0; jj < Q; ++jj) {
      const float wv = wf[(jb + jj) * kLanes];
#pragma unroll
      for (int r = 0; r < Q; ++r) {
#pragma unroll
        for (int n = 0; n < N; ++n)
          acc[n][r] = fmaf(wv, win[n][(jj + r) % Q], acc[n][r]);
      }
#pragma unroll
      for (int n = 0; n < N; ++n)
        win[n][jj] = col[(n * Q + jb + jj + Q) * kLanes];
    }
  }
}

// dw of Q consecutive taps of one channel over n rows (a multiple of Q):
// acc[q] += xcol[i + q] * dcol[i], and db += dcol[i] where kDb.  Window
// slot (i + q) % Q holds x row i + q: each row takes one dy and one new
// x row.
template <int Q, bool kDb>
__device__ __forceinline__ void dw_rows(const float* xcol, const float* dcol,
                                        int n, float (&acc)[Q], float& db) {
  float win[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) win[q] = xcol[q * kLanes];
  for (int ib = 0; ib < n; ib += Q) {
#pragma unroll
    for (int ii = 0; ii < Q; ++ii) {
      const float d = dcol[(ib + ii) * kLanes];
      if (kDb) db += d;
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] = fmaf(win[(ii + q) % Q], d, acc[q]);
      win[ii] = xcol[(ib + ii + Q) * kLanes];
    }
  }
}

// The ring's staging of row b, channels c0 .. c0 + 31: tile -> the rows
// [tile * TT - h, tile * TT - h + SR) of each of kN tensors into
// dst + i * buf (tensor i), zeros outside [0, T) and past C, by cp.async
// (16-byte copies along channels where vec, else 4-byte ones), one
// commit group a tile.  A thread copies columns jc .. jc + width - 1 of
// every step-th row.  K5 and K6 stage x and dy, K4 x alone.
struct Stager {
  int TT, SR, h, T, C, c0, per_row, jc, step, vec;
  size_t base;
  bool jc_ok;
  __device__ Stager(const Geometry& geo, int h_, int T_, int C_,
                    size_t base_, int c0_, int vec_, int nthreads)
      : TT(geo.TT), SR(geo.SR), h(h_), T(T_), C(C_), c0(c0_),
        per_row(kLanes / (vec_ ? 4 : 1)),
        jc((vec_ ? 4 : 1) * (threadIdx.x % per_row)),
        step(nthreads / per_row), vec(vec_), base(base_),
        jc_ok(c0 + jc < C) {}

  template <int kN>
  __device__ __forceinline__ void operator()(const float* const (&src)[kN],
                                             float* dst, size_t buf,
                                             int tile) const {
    dst += jc;
    const int t_lo = tile * TT - h;
    for (int r = threadIdx.x / per_row; r < SR; r += step) {
      const int t = t_lo + r;
      const bool ok = jc_ok && t >= 0 && t < T;
      const size_t off = ok ? base + (size_t)t * C + c0 + jc : 0;
      if (vec) {
#pragma unroll
        for (int i = 0; i < kN; ++i)
          tf32x3::cp_async16(dst + i * buf + r * kLanes, src[i] + off, ok);
      } else {
#pragma unroll
        for (int i = 0; i < kN; ++i)
          tf32x3::cp_async4(dst + i * buf + r * kLanes, src[i] + off, ok);
      }
    }
    tf32x3::cp_async_commit();
  }
};

// kDx: K5 (dx, and the partial dw and db); else K6 (the partials only).
// Block (channel group, chunk, b) walks tiles [chunk * tiles_per_block,
// ...) of row b; vec: 16-byte copies (C % 4 == 0, x and dy aligned).
template <int Q, bool kDx>
__device__ __forceinline__ void bwd_body(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ w, float* __restrict__ dx,
    float* __restrict__ partial, int T, int C, int K, int tiles_per_block,
    int vec) {
  extern __shared__ __align__(16) float bwd_smem[];
  float* smem = bwd_smem;
  const Geometry geo = geometry(K);
  const int h = (K - 1) / 2, nthreads = geo.warps * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = warp % geo.G, s = warp / geo.G;
  const int c0 = blockIdx.x * kLanes, chunk = blockIdx.y, b = blockIdx.z;
  const int c = c0 + lane;
  const size_t buf = (size_t)geo.SR * kLanes;  // floats of one staged tensor
  float* ws = smem + 4 * buf;
  const size_t base = (size_t)b * T * C;
  const int first = chunk * tiles_per_block;
  const int n = min(tiles_per_block, (T + geo.TT - 1) / geo.TT - first);

  // tile -> buffer `slot`: x rows, then dy rows
  const Stager stager(geo, h, T, C, base, c0, vec, nthreads);
  const float* const srcs[2] = {x, dy};
  auto stage = [&](int tile, int slot) {
    stager(srcs, smem + 2 * slot * buf, buf, tile);
  };

  stage(first, 0);
  if (kDx) {
    for (int e = threadIdx.x; e < geo.KP * kLanes; e += nthreads) {
      const int j = e / kLanes, cc = c0 + e % kLanes;
      ws[e] = j < K && cc < C ? w[(size_t)cc * K + K - 1 - j] : 0.f;
    }
  }
  float dw_acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) dw_acc[q] = 0.f;
  float db_acc = 0.f;

  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) {
      stage(first + k + 1, (k + 1) & 1);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();  // tile k (and the weight) in place
    const float* xs = smem + 2 * (k & 1) * buf;
    const float* ds = xs + buf;
    if (kDx) {
      // rows r0 .. r0 + Q - 1: dx[t] = sum_j wf[j] dy-row r0 + r + j
      const int r0 = warp * Q, t0 = (first + k) * geo.TT + r0;
      float acc[1][Q];
      dx_rows<Q, 1>(ds + r0 * kLanes + lane, ws + lane, geo.KP, 0.f, acc);
      if (c < C) {
#pragma unroll
        for (int r = 0; r < Q; ++r)
          if (t0 + r < T) dx[base + (size_t)(t0 + r) * C + c] = acc[0][r];
      }
    }
    // taps g*Q .. over rows i0 .. i0 + KP - 1: dw[tap] += x-row i + tap *
    // dy-row i + h
    const int i0 = s * geo.KP;
    const float* xcol = xs + (i0 + g * Q) * kLanes + lane;
    const float* dcol = ds + (i0 + h) * kLanes + lane;
    if (g == 0)
      dw_rows<Q, true>(xcol, dcol, geo.KP, dw_acc, db_acc);
    else
      dw_rows<Q, false>(xcol, dcol, geo.KP, dw_acc, db_acc);
    __syncthreads();  // the buffer is read before it is staged again
  }

  // the block's partial [K + 1][C] (the last row db): the S splits of
  // each tap added in order through shared memory
  float* red = smem;  // [S][KP][kLanes], then db [S][kLanes]
#pragma unroll
  for (int q = 0; q < Q; ++q)
    red[((size_t)s * geo.KP + g * Q + q) * kLanes + lane] = dw_acc[q];
  if (g == 0) red[((size_t)geo.S * geo.KP + s) * kLanes + lane] = db_acc;
  __syncthreads();
  float* p = partial + ((size_t)b * gridDim.y + chunk) * (size_t)(K + 1) * C;
  for (int e = threadIdx.x; e < (K + 1) * kLanes; e += nthreads) {
    const int tap = e / kLanes, l = e % kLanes;
    if (c0 + l >= C) continue;
    const bool is_db = tap == K;
    const float* src =
        red + (is_db ? (size_t)geo.S * geo.KP : (size_t)tap) * kLanes + l;
    const size_t stride = (is_db ? 1 : (size_t)geo.KP) * kLanes;
    float sum = 0.f;
    for (int ss = 0; ss < geo.S; ++ss) sum += src[ss * stride];
    p[(size_t)tap * C + c0 + l] = sum;
  }
}

template <int Q>
__global__ void __launch_bounds__(kMaxThreads)
depthwise_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ w, float* __restrict__ dx,
                     float* __restrict__ partial, int T, int C, int K,
                     int tiles_per_block, int vec) {
  bwd_body<Q, true>(x, dy, w, dx, partial, T, C, K, tiles_per_block, vec);
}

template <int Q>
__global__ void __launch_bounds__(kMaxThreads)
depthwise_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                    const float* __restrict__ w, float* __restrict__ dx,
                    float* __restrict__ partial, int T, int C, int K,
                    int tiles_per_block, int vec) {
  bwd_body<Q, false>(x, dy, w, dx, partial, T, C, K, tiles_per_block, vec);
}

// K4: y = the "same" conv of x plus the bias.  Block (channel group,
// chunk, b) walks tiles [chunk * tiles_per_block, ...) of row b through
// the ring of x rows; warp w computes rows w * N Q .. (w + 1) N Q - 1 of
// each tile (N = kFwdWindows) from the weight staged as it is (zero past
// K).
template <int Q>
__global__ void __launch_bounds__(kMaxThreads)
depthwise_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int T, int C, int K, int tiles_per_block, int vec) {
  extern __shared__ __align__(16) float fwd_smem[];
  float* smem = fwd_smem;
  const Geometry geo = fwd_geometry(geometry(K));
  const int h = (K - 1) / 2, nthreads = geo.warps * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kLanes, chunk = blockIdx.y, b = blockIdx.z;
  const int c = c0 + lane;
  const size_t buf = (size_t)geo.SR * kLanes;  // floats of one staged tile
  float* ws = smem + 2 * buf;
  const size_t base = (size_t)b * T * C;
  const int first = chunk * tiles_per_block;
  const int n = min(tiles_per_block, (T + geo.TT - 1) / geo.TT - first);

  // tile -> buffer `slot`: x rows
  const Stager stager(geo, h, T, C, base, c0, vec, nthreads);
  const float* const srcs[1] = {x};
  auto stage = [&](int tile, int slot) {
    stager(srcs, smem + slot * buf, buf, tile);
  };

  stage(first, 0);
  for (int e = threadIdx.x; e < geo.KP * kLanes; e += nthreads) {
    const int j = e / kLanes, cc = c0 + e % kLanes;
    ws[e] = j < K && cc < C ? w[(size_t)cc * K + j] : 0.f;
  }
  const float start = c < C ? bias[c] : 0.f;
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) {
      stage(first + k + 1, (k + 1) & 1);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();  // tile k (and the weight) in place
    constexpr int N = kFwdWindows;
    const int r0 = warp * N * Q, t0 = (first + k) * geo.TT + r0;
    float acc[N][Q];
    dx_rows<Q, N>(smem + (k & 1) * buf + r0 * kLanes + lane, ws + lane,
                  geo.KP, start, acc);
    if (c < C) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int r = 0; r < Q; ++r) {
          const int t = t0 + n * Q + r;
          if (t < T) y[base + (size_t)t * C + c] = acc[n][r];
        }
      }
    }
    __syncthreads();  // the buffer is read before it is staged again
  }
}

// dw[c, tap] and db[c]: the parts' partials, one output a lane; slice j
// of a block adds parts j, j + kSlices, ... in order, then lane's
// slices are added in order.
__device__ __forceinline__ void reduce_partials(
    const float* __restrict__ partial, float* __restrict__ dw,
    float* __restrict__ db, int parts, int C, int K) {
  __shared__ float red[kSlices][kLanes];
  const int n = (K + 1) * C;
  const int lane = threadIdx.x % kLanes, slice = threadIdx.x / kLanes;
  const int o = blockIdx.x * kLanes + lane;
  float sum = 0.f;
  if (o < n) {
#pragma unroll 4
    for (int q = slice; q < parts; q += kSlices)
      sum += partial[(size_t)q * n + o];
  }
  red[slice][lane] = sum;
  __syncthreads();
  if (slice == 0 && o < n) {
    float t = red[0][lane];
#pragma unroll
    for (int j = 1; j < kSlices; ++j) t += red[j][lane];
    const int tap = o / C, c = o - tap * C;
    if (tap < K)
      dw[(size_t)c * K + tap] = t;
    else
      db[c] = t;
  }
}

__global__ void __launch_bounds__(kSlices* kLanes)
depthwise_bwd_reduce_kernel(const float* __restrict__ partial,
                            float* __restrict__ dw, float* __restrict__ db,
                            int parts, int C, int K) {
  reduce_partials(partial, dw, db, parts, C, K);
}

__global__ void __launch_bounds__(kSlices* kLanes)
depthwise_dw_reduce_kernel(const float* __restrict__ partial,
                           float* __restrict__ dw, float* __restrict__ db,
                           int parts, int C, int K) {
  reduce_partials(partial, dw, db, parts, C, K);
}

using BwdKernel = void (*)(const float*, const float*, const float*, float*,
                           float*, int, int, int, int, int);
using FwdKernel = void (*)(const float*, const float*, const float*, float*,
                           int, int, int, int, int);

template <int Q>
const void* pick(Kind kind) {
  switch (kind) {
    case Kind::kFwd: return (const void*)&depthwise_fwd_kernel<Q>;
    case Kind::kBwd: return (const void*)&depthwise_bwd_kernel<Q>;
    case Kind::kDw: return (const void*)&depthwise_dw_kernel<Q>;
  }
  return nullptr;
}

// every Q that geometry gives an odd K <= kMaxK: K itself below 17,
// else 9 .. 16
const void* kernel_for(int Q, Kind kind) {
  switch (Q) {
    case 1: return pick<1>(kind);
    case 3: return pick<3>(kind);
    case 5: return pick<5>(kind);
    case 7: return pick<7>(kind);
    case 9: return pick<9>(kind);
    case 10: return pick<10>(kind);
    case 11: return pick<11>(kind);
    case 12: return pick<12>(kind);
    case 13: return pick<13>(kind);
    case 14: return pick<14>(kind);
    case 15: return pick<15>(kind);
    case 16: return pick<16>(kind);
  }
  return nullptr;
}

// The launch: the kernel for K's window, its shared memory, and chunks of
// tiles_per_block tiles sized so that the blocks fill every SM's slots
// about once (in the backward, fewer partials than blocks of one tile
// each).
struct Plan {
  const void* kernel;
  Geometry geo;
  size_t smem;
  int blocks_per_sm, tiles_per_block, chunks;
};

bool bad_k(int K) { return K < 1 || K % 2 == 0 || K > kMaxK; }

cudaError_t make_plan(int B, int T, int C, int K, Kind kind, Plan* p) {
  p->geo = kind == Kind::kFwd ? fwd_geometry(geometry(K)) : geometry(K);
  p->kernel = kernel_for(p->geo.Q, kind);
  if (p->kernel == nullptr) return cudaErrorInvalidValue;
  p->smem = smem_bytes(p->geo, kind);
  cudaError_t err = cudaFuncSetAttribute(
      p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &p->blocks_per_sm, p->kernel, p->geo.warps * 32, p->smem);
  if (err != cudaSuccess) return err;
  if (p->blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (T + p->geo.TT - 1) / p->geo.TT;
  const long long blocks = (long long)((C + kLanes - 1) / kLanes) * B * tiles;
  const long long slots = (long long)p->blocks_per_sm * sms;
  p->tiles_per_block = (int)((blocks + slots - 1) / slots);
  p->chunks = (tiles + p->tiles_per_block - 1) / p->tiles_per_block;
  return cudaSuccess;
}

long long partial_floats_needed(int B, int C, int K, const Plan& p) {
  return (long long)B * p.chunks * (K + 1) * C;
}

int launch(const void* x, const void* dy, const void* w, void* dx, void* dw,
           void* db, void* partial, long long partial_floats, int B, int T,
           int C, int K, bool kDx, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  if (bad_k(K) || B > 65535) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err =
      make_plan(B, T, C, K, kDx ? Kind::kBwd : Kind::kDw, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.chunks > 65535 || partial_floats < partial_floats_needed(B, C, K, p))
    return (int)cudaErrorInvalidValue;
  const int vec =
      C % 4 == 0 && ((uintptr_t)x | (uintptr_t)dy) % 16 == 0 ? 1 : 0;
  auto st = static_cast<cudaStream_t>(stream);
  dim3 grid((C + kLanes - 1) / kLanes, p.chunks, B);
  const auto kernel = reinterpret_cast<BwdKernel>(p.kernel);
  kernel<<<grid, p.geo.warps * 32, p.smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(w), static_cast<float*>(dx),
      static_cast<float*>(partial), T, C, K, p.tiles_per_block, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = (K + 1) * C;
  const auto reduce =
      kDx ? &depthwise_bwd_reduce_kernel : &depthwise_dw_reduce_kernel;
  reduce<<<(n + kLanes - 1) / kLanes, kSlices * kLanes, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw),
      static_cast<float*>(db), B * p.chunks, C, K);
  return (int)cudaGetLastError();
}

int launch_fwd(const void* x, const void* w, const void* bias, void* y,
               int B, int T, int C, int K, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  if (bad_k(K) || B > 65535) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(B, T, C, K, Kind::kFwd, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.chunks > 65535) return (int)cudaErrorInvalidValue;
  const int vec = C % 4 == 0 && (uintptr_t)x % 16 == 0 ? 1 : 0;
  dim3 grid((C + kLanes - 1) / kLanes, p.chunks, B);
  const auto kernel = reinterpret_cast<FwdKernel>(p.kernel);
  kernel<<<grid, p.geo.warps * 32, p.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), T, C, K,
      p.tiles_per_block, vec);
  return (int)cudaGetLastError();
}

}  // namespace tiled
}  // namespace

// K4: x, y device float32 [B, T, C]; w [C, 1, K]; bias [C].
extern "C" int sep_depthwise_fwd_f32(const void* x, const void* w,
                                     const void* bias, void* y, int B, int T,
                                     int C, int K, void* stream) {
  return tiled::launch_fwd(x, w, bias, y, B, T, C, K, stream);
}

// K5: x, dy, dx device float32 [B, T, C]; w, dw: [C, 1, K]; db: [C];
// partial: device float32 scratch of partial_floats floats, at least
// sep_depthwise_bwd_partial_floats(B, T, C, K, 1).
extern "C" int sep_depthwise_bwd_f32(const void* x, const void* dy,
                                     const void* w, void* dx, void* dw,
                                     void* db, void* partial,
                                     long long partial_floats, int B, int T,
                                     int C, int K, void* stream) {
  return tiled::launch(x, dy, w, dx, dw, db, partial, partial_floats, B, T,
                       C, K, true, stream);
}

// K6: dw and db only, as sep_depthwise_bwd_f32 without w and dx (the
// scratch: sep_depthwise_bwd_partial_floats(B, T, C, K, 0)).
extern "C" int sep_depthwise_bwd_w_f32(const void* x, const void* dy,
                                       void* dw, void* db, void* partial,
                                       long long partial_floats, int B,
                                       int T, int C, int K, void* stream) {
  return tiled::launch(x, dy, nullptr, nullptr, dw, db, partial,
                       partial_floats, B, T, C, K, false, stream);
}

// Floats of K5's (with_dx) or K6's scratch of block partials for these
// sizes on the current card; -1 for a K the kernels do not take or a
// failed query.
extern "C" long long sep_depthwise_bwd_partial_floats(int B, int T, int C,
                                                      int K, int with_dx) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  tiled::Plan p;
  if (tiled::bad_k(K) ||
      tiled::make_plan(B, T, C, K,
                       with_dx ? tiled::Kind::kBwd : tiled::Kind::kDw,
                       &p) != cudaSuccess)
    return -1;
  return tiled::partial_floats_needed(B, C, K, p);
}

// out: int[12] = K4's blocks per SM, registers, local (spill) bytes and
// warps per block at K taps, then K5's, then K6's.
extern "C" int sep_depthwise_occupancy(int K, void* out) {
  if (tiled::bad_k(K)) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  const tiled::Kind kinds[3] = {tiled::Kind::kFwd, tiled::Kind::kBwd,
                                tiled::Kind::kDw};
  for (int i = 0; i < 3; ++i) {
    tiled::Plan p;
    cudaError_t err = tiled::make_plan(1, 1, 1, K, kinds[i], &p);
    cudaFuncAttributes a;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, p.kernel);
    if (err != cudaSuccess) return (int)err;
    o[4 * i] = p.blocks_per_sm;
    o[4 * i + 1] = a.numRegs;
    o[4 * i + 2] = (int)a.localSizeBytes;
    o[4 * i + 3] = p.geo.warps;
  }
  return 0;
}
