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
// product per channel), so K5 and K6 run on the CUDA cores, whose FMA
// rate an SM reaches only if its shared memory feeds it: 128 bytes a
// clock against 128 FMAs, so at least 4 FMAs per float loaded.
//
// Design of K5 and K6 (namespace bwd).  The TPU summed dw and db across
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
// K4 takes a block of 32 channels and 256 rows, in tiles of 64 rows that
// it stages with their halo, and the weight, in shared memory by plain
// loads; each warp runs the tap loop (tap_rows) over its 8 rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"  // cp_async16, cp_async4 and their group helpers

namespace {

constexpr int kCW = 32;          // channels per block (one per lane)
constexpr int kTT = 64;          // rows per tile
constexpr int kTiles = 4;        // tiles per block: 256 rows
constexpr int kThreads = 256;    // 8 warps
constexpr int kGroups = kThreads / 32;
constexpr int kRowsPerWarp = kTT / kGroups;
constexpr int kMaxK = 81;        // the shared memory below stays <= 48 KB

// K4's tiles: x [kTT + K - 1][kCW] and the weight [K][kCW]
size_t smem_bytes(int K) {
  return sizeof(float) * ((size_t)(kTT + K - 1) * kCW + (size_t)K * kCW);
}

// The "same" conv's tap loop for one channel of R consecutive output rows:
//   acc[r] += sum_tap w[tap] * v[r + tap],  r < R,
// where v is a window in shared memory whose row 0 lies K / 2 rows before
// the first output row (zero rows stand for the padding outside [0, T)).
// The caller sets acc to the bias first.  Strides are in floats: the
// window's rows and the staged weight's taps; lanes of a warp take
// neighbouring channels, so every shared access is free of bank conflicts.
template <int R>
__device__ __forceinline__ void tap_rows(const float* v, int v_stride,
                                         const float* w, int w_stride, int K,
                                         float (&acc)[R]) {
  for (int tap = 0; tap < K; ++tap) {
    const float wv = w[tap * w_stride];
    const float* row = v + tap * v_stride;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += wv * row[r * v_stride];
  }
}

// K4: y = the "same" conv of x, one tile of kTT rows at a time.
__global__ void __launch_bounds__(kThreads)
depthwise_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int T, int C, int K) {
  extern __shared__ float smem[];
  const int halo = (K - 1) / 2, rows = kTT + K - 1;
  float* xs = smem;                 // [rows][kCW]
  float* ws = xs + rows * kCW;      // [K][kCW]
  const int c0 = blockIdx.x * kCW, chunk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int c = c0 + lane;
  const bool c_ok = c < C;
  for (int e = threadIdx.x; e < K * kCW; e += kThreads) {
    const int tap = e / kCW, cc = c0 + e % kCW;
    ws[e] = cc < C ? w[(size_t)cc * K + tap] : 0.f;
  }
  const float bv = c_ok ? bias[c] : 0.f;
  const size_t base = (size_t)b * T * C;
  for (int tile = 0; tile < kTiles; ++tile) {
    const int t0 = (chunk * kTiles + tile) * kTT;
    if (t0 >= T) break;  // the same for every thread of the block
    __syncthreads();     // the previous tile is consumed
    for (int e = threadIdx.x; e < rows * kCW; e += kThreads) {
      const int r = e / kCW, cc = c0 + e % kCW, t = t0 - halo + r;
      xs[e] = t >= 0 && t < T && cc < C ? x[base + (size_t)t * C + cc] : 0.f;
    }
    __syncthreads();
    const int i0 = grp * kRowsPerWarp;
    float acc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = bv;
    tap_rows<kRowsPerWarp>(xs + i0 * kCW + lane, kCW, ws + lane, kCW, K,
                           acc);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = t0 + i0 + r;
      if (t < T && c_ok) y[base + (size_t)t * C + c] = acc[r];
    }
  }
}

// ---- K5 and K6 ----
namespace bwd {

constexpr int kLanes = 32;         // channels per block, one per lane
constexpr int kMaxQ = 16;          // the widest register window
constexpr int kMinWarps = 8;       // row splits fill a block to this
constexpr int kMaxThreads = 384;   // 12 warps at K 81 (G 6, S 2)
constexpr int kSlices = 8;         // the reduction's partial slices

// The tiling for K taps: G groups of Q taps (KP = G * Q >= K), S row
// splits, G * S warps and tiles of TT = G * S * Q rows.  A tile stages
// SR = TT + KP rows from K / 2 rows before its first: the windows read
// rows up to TT + KP - 2, and their last slide loads row TT + KP - 1.
struct Geometry {
  int G, Q, S, warps, TT, KP, SR;
};

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

// two buffers of x and dy rows [SR][kLanes], then the flipped weight
// [KP][kLanes] for dx
size_t smem_bytes(const Geometry& g, bool kDx) {
  return sizeof(float) *
         ((size_t)4 * g.SR * kLanes + (kDx ? (size_t)g.KP * kLanes : 0));
}

// dx of Q consecutive rows of one channel: acc[r] = sum_{j < KP} wf[j] *
// col[r + j] (rows of kLanes floats), wf the weight flipped along its
// taps.  Window slot (j + r) % Q holds row r + j: each tap takes one
// weight and one new row into the slot of the row it no longer needs.
template <int Q>
__device__ __forceinline__ void dx_rows(const float* col, const float* wf,
                                        int KP, float (&acc)[Q]) {
  float win[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    acc[q] = 0.f;
    win[q] = col[q * kLanes];
  }
  for (int jb = 0; jb < KP; jb += Q) {
#pragma unroll
    for (int jj = 0; jj < Q; ++jj) {
      const float wv = wf[(jb + jj) * kLanes];
#pragma unroll
      for (int r = 0; r < Q; ++r) acc[r] = fmaf(wv, win[(jj + r) % Q], acc[r]);
      win[jj] = col[(jb + jj + Q) * kLanes];
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

  // tile -> buffer `slot` (x rows, then dy rows), zeros outside [0, T):
  // a thread copies columns jc .. jc + width - 1 of every step-th row
  const int width = vec ? 4 : 1, per_row = kLanes / width;
  const int jc = width * (threadIdx.x % per_row), step = nthreads / per_row;
  const bool jc_ok = c0 + jc < C;
  auto stage = [&](int tile, int slot) {
    float* xs = smem + 2 * slot * buf + jc;
    float* ds = xs + buf;
    const int t_lo = tile * geo.TT - h;
    for (int r = threadIdx.x / per_row; r < geo.SR; r += step) {
      const int t = t_lo + r;
      const bool ok = jc_ok && t >= 0 && t < T;
      const size_t off = ok ? base + (size_t)t * C + c0 + jc : 0;
      if (vec) {
        tf32x3::cp_async16(xs + r * kLanes, x + off, ok);
        tf32x3::cp_async16(ds + r * kLanes, dy + off, ok);
      } else {
        tf32x3::cp_async4(xs + r * kLanes, x + off, ok);
        tf32x3::cp_async4(ds + r * kLanes, dy + off, ok);
      }
    }
    tf32x3::cp_async_commit();
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
      float acc[Q];
      dx_rows<Q>(ds + r0 * kLanes + lane, ws + lane, geo.KP, acc);
      if (c < C) {
#pragma unroll
        for (int r = 0; r < Q; ++r)
          if (t0 + r < T) dx[base + (size_t)(t0 + r) * C + c] = acc[r];
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

using Kernel = void (*)(const float*, const float*, const float*, float*,
                        float*, int, int, int, int, int);

template <int Q>
Kernel pick(bool kDx) {
  return kDx ? &depthwise_bwd_kernel<Q> : &depthwise_dw_kernel<Q>;
}

// every Q that geometry gives an odd K <= kMaxK: K itself below 17,
// else 9 .. 16
Kernel kernel_for(int Q, bool kDx) {
  switch (Q) {
    case 1: return pick<1>(kDx);
    case 3: return pick<3>(kDx);
    case 5: return pick<5>(kDx);
    case 7: return pick<7>(kDx);
    case 9: return pick<9>(kDx);
    case 10: return pick<10>(kDx);
    case 11: return pick<11>(kDx);
    case 12: return pick<12>(kDx);
    case 13: return pick<13>(kDx);
    case 14: return pick<14>(kDx);
    case 15: return pick<15>(kDx);
    case 16: return pick<16>(kDx);
  }
  return nullptr;
}

// The launch: the kernel for K's window, its shared memory, and chunks of
// tiles_per_block tiles sized so that the blocks fill every SM's slots
// about once (fewer partials than blocks of one tile each).
struct Plan {
  Kernel kernel;
  Geometry geo;
  size_t smem;
  int blocks_per_sm, tiles_per_block, chunks;
};

bool bad_k(int K) { return K < 1 || K % 2 == 0 || K > kMaxK; }

cudaError_t make_plan(int B, int T, int C, int K, bool kDx, Plan* p) {
  p->geo = geometry(K);
  p->kernel = kernel_for(p->geo.Q, kDx);
  if (p->kernel == nullptr) return cudaErrorInvalidValue;
  p->smem = smem_bytes(p->geo, kDx);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)p->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p->smem);
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
  const cudaError_t err = make_plan(B, T, C, K, kDx, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.chunks > 65535 || partial_floats < partial_floats_needed(B, C, K, p))
    return (int)cudaErrorInvalidValue;
  const int vec =
      C % 4 == 0 && ((uintptr_t)x | (uintptr_t)dy) % 16 == 0 ? 1 : 0;
  auto st = static_cast<cudaStream_t>(stream);
  dim3 grid((C + kLanes - 1) / kLanes, p.chunks, B);
  const Kernel kernel = p.kernel;
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

}  // namespace bwd
}  // namespace

// K5: x, dy, dx device float32 [B, T, C]; w, dw: [C, 1, K]; db: [C];
// partial: device float32 scratch of partial_floats floats, at least
// sep_depthwise_bwd_partial_floats(B, T, C, K, 1).
extern "C" int sep_depthwise_bwd_f32(const void* x, const void* dy,
                                     const void* w, void* dx, void* dw,
                                     void* db, void* partial,
                                     long long partial_floats, int B, int T,
                                     int C, int K, void* stream) {
  return bwd::launch(x, dy, w, dx, dw, db, partial, partial_floats, B, T, C,
                     K, true, stream);
}

// K6: dw and db only, as sep_depthwise_bwd_f32 without w and dx (the
// scratch: sep_depthwise_bwd_partial_floats(B, T, C, K, 0)).
extern "C" int sep_depthwise_bwd_w_f32(const void* x, const void* dy,
                                       void* dw, void* db, void* partial,
                                       long long partial_floats, int B,
                                       int T, int C, int K, void* stream) {
  return bwd::launch(x, dy, nullptr, nullptr, dw, db, partial,
                     partial_floats, B, T, C, K, false, stream);
}

// Floats of K5's (with_dx) or K6's scratch of block partials for these
// sizes on the current card; -1 for a K the kernels do not take or a
// failed query.
extern "C" long long sep_depthwise_bwd_partial_floats(int B, int T, int C,
                                                      int K, int with_dx) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  bwd::Plan p;
  if (bwd::bad_k(K) ||
      bwd::make_plan(B, T, C, K, with_dx != 0, &p) != cudaSuccess)
    return -1;
  return bwd::partial_floats_needed(B, C, K, p);
}

// out: int[8] = K5's blocks per SM, registers, local (spill) bytes and
// warps per block at K taps, then K6's.
extern "C" int sep_depthwise_bwd_occupancy(int K, void* out) {
  if (bwd::bad_k(K)) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  for (int i = 0; i < 2; ++i) {
    bwd::Plan p;
    cudaError_t err = bwd::make_plan(1, 1, 1, K, i == 0, &p);
    cudaFuncAttributes a;
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&a, (const void*)p.kernel);
    if (err != cudaSuccess) return (int)err;
    o[4 * i] = p.blocks_per_sm;
    o[4 * i + 1] = a.numRegs;
    o[4 * i + 2] = (int)a.localSizeBytes;
    o[4 * i + 3] = p.geo.warps;
  }
  return 0;
}

// K4: x, y device float32 [B, T, C]; w [C, 1, K]; bias [C].
extern "C" int sep_depthwise_fwd_f32(const void* x, const void* w,
                                     const void* bias, void* y, int B, int T,
                                     int C, int K, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  if (K < 1 || K % 2 == 0 || K > kMaxK || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int chunks = (T + kTT * kTiles - 1) / (kTT * kTiles);
  dim3 grid((C + kCW - 1) / kCW, chunks, B);
  depthwise_fwd_kernel<<<grid, kThreads, smem_bytes(K),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), T, C, K);
  return (int)cudaGetLastError();
}
