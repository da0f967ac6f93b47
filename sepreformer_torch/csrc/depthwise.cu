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
//
// Design: the TPU summed dw and db across a sequential grid in VMEM.  Here
// blocks run in parallel and in no order, so each block writes its own
// partial sums [K + 1, C] (the last row is db) and a second small kernel
// adds the partials in a fixed order: the result is the same on every run,
// with no float atomics.  A block takes 32 channels of one row b and a
// chunk of 256 time steps, in tiles of 64 rows that it stages, with their
// halo of K - 1 rows, in shared memory (x and dy, zero outside [0, T)).
// Lanes run along channels, so every global access is 128 contiguous
// bytes per warp and every shared access is free of bank conflicts.  For
// dx each warp takes 8 consecutive rows and walks the taps; for dw each
// warp takes every 8th tap and walks the rows, reusing each dy value for
// all of its taps.  The partial dw stays in registers across the tiles.
// K6 is the same kernel without the dx loop and the weight's staging
// (depthwise_dw_kernel), and the same fixed-order reduction.  K4 stages
// x and the weight as K5 stages dy and the weight, and each warp runs
// the tap loop (tap_rows) over its 8 rows, with the weight unflipped.
#include <cuda_runtime.h>

namespace {

constexpr int kCW = 32;          // channels per block (one per lane)
constexpr int kTT = 64;          // rows per tile
constexpr int kTiles = 4;        // tiles per block: 256 rows
constexpr int kThreads = 256;    // 8 warps
constexpr int kGroups = kThreads / 32;
constexpr int kRowsPerWarp = kTT / kGroups;
constexpr int kMaxK = 81;        // the shared memory below stays <= 48 KB
constexpr int kTapsPerWarp = (kMaxK + kGroups - 1) / kGroups;

size_t smem_bytes(int K) {
  return sizeof(float) * ((size_t)2 * (kTT + K - 1) * kCW + (size_t)K * kCW);
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

// kDx: K5 (dx, and the partial dw and db); else K6 (the partials only)
template <bool kDx>
__device__ __forceinline__ void depthwise_bwd_body(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ w, float* __restrict__ dx,
    float* __restrict__ partial, int T, int C, int K) {
  extern __shared__ float smem[];
  const int halo = (K - 1) / 2, rows = kTT + K - 1;
  float* xs = smem;                 // [rows][kCW]
  float* dys = xs + rows * kCW;     // [rows][kCW]
  float* ws = dys + rows * kCW;     // [K][kCW]
  const int c0 = blockIdx.x * kCW, chunk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int c = c0 + lane;
  const bool c_ok = c < C;

  if (kDx) {
    for (int e = threadIdx.x; e < K * kCW; e += kThreads) {
      const int tap = e / kCW, cc = c0 + e % kCW;
      ws[e] = cc < C ? w[(size_t)cc * K + tap] : 0.f;
    }
  }
  float dw_acc[kTapsPerWarp];
#pragma unroll
  for (int m = 0; m < kTapsPerWarp; ++m) dw_acc[m] = 0.f;
  float db_acc = 0.f;

  const size_t base = (size_t)b * T * C;
  for (int tile = 0; tile < kTiles; ++tile) {
    const int t0 = (chunk * kTiles + tile) * kTT;
    if (t0 >= T) break;  // the same for every thread of the block
    __syncthreads();     // the previous tile is consumed
    for (int e = threadIdx.x; e < rows * kCW; e += kThreads) {
      const int r = e / kCW, cc = c0 + e % kCW, t = t0 - halo + r;
      const bool ok = t >= 0 && t < T && cc < C;
      const size_t off = base + (size_t)t * C + cc;
      xs[e] = ok ? x[off] : 0.f;
      dys[e] = ok ? dy[off] : 0.f;
    }
    __syncthreads();

    if (kDx) {
      // dx for rows i0 .. i0 + 7 of the tile: dx[i] = sum_tap w[tap] *
      // dys[i + K - 1 - tap]
      const int i0 = grp * kRowsPerWarp;
      float acc[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;
      for (int tap = 0; tap < K; ++tap) {
        const float wv = ws[tap * kCW + lane];
        const float* d = dys + (i0 + K - 1 - tap) * kCW + lane;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r] += wv * d[r * kCW];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int t = t0 + i0 + r;
        if (t < T && c_ok) dx[base + (size_t)t * C + c] = acc[r];
      }
    }

    // dw[tap] += sum_i xs[i + tap] * dys[i + halo], taps grp, grp + 8, ...
    for (int i = 0; i < kTT; ++i) {
      const float d = dys[(i + halo) * kCW + lane];
      if (grp == 0) db_acc += d;
#pragma unroll
      for (int m = 0; m < kTapsPerWarp; ++m) {
        const int tap = grp + kGroups * m;
        if (tap < K) dw_acc[m] += xs[(i + tap) * kCW + lane] * d;
      }
    }
  }

  float* p = partial + ((size_t)b * gridDim.y + chunk) * (size_t)(K + 1) * C;
  if (c_ok) {
#pragma unroll
    for (int m = 0; m < kTapsPerWarp; ++m) {
      const int tap = grp + kGroups * m;
      if (tap < K) p[(size_t)tap * C + c] = dw_acc[m];
    }
    if (grp == 0) p[(size_t)K * C + c] = db_acc;
  }
}

__global__ void __launch_bounds__(kThreads)
depthwise_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     const float* __restrict__ w, float* __restrict__ dx,
                     float* __restrict__ partial, int T, int C, int K) {
  depthwise_bwd_body<true>(x, dy, w, dx, partial, T, C, K);
}

__global__ void __launch_bounds__(kThreads)
depthwise_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                    float* __restrict__ partial, int T, int C, int K) {
  depthwise_bwd_body<false>(x, dy, nullptr, nullptr, partial, T, C, K);
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

// dw[c, tap] and db[c]: the block partials summed in order.
__device__ __forceinline__ void reduce_partials(
    const float* __restrict__ partial, float* __restrict__ dw,
    float* __restrict__ db, int parts, int C, int K) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = (K + 1) * C;
  if (idx >= n) return;
  float s = 0.f;
  for (int q = 0; q < parts; ++q) s += partial[(size_t)q * n + idx];
  const int tap = idx / C, c = idx - tap * C;
  if (tap < K)
    dw[(size_t)c * K + tap] = s;
  else
    db[c] = s;
}

__global__ void depthwise_bwd_reduce_kernel(const float* __restrict__ partial,
                                            float* __restrict__ dw,
                                            float* __restrict__ db, int parts,
                                            int C, int K) {
  reduce_partials(partial, dw, db, parts, C, K);
}

__global__ void depthwise_dw_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ dw,
                                           float* __restrict__ db, int parts,
                                           int C, int K) {
  reduce_partials(partial, dw, db, parts, C, K);
}

bool bad_args(int B, int T, int C, int K, long long partial_floats) {
  const int chunks = (T + kTT * kTiles - 1) / (kTT * kTiles);
  return K < 1 || K % 2 == 0 || K > kMaxK || B > 65535 ||
         partial_floats < (long long)B * chunks * (K + 1) * C;
}

}  // namespace

// x, dy, dx: device float32 [B, T, C]; w, dw: [C, 1, K]; db: [C];
// partial: device float32 scratch of partial_floats >= B * ceil(T / 256)
// * (K + 1) * C floats.
extern "C" int sep_depthwise_bwd_f32(const void* x, const void* dy,
                                     const void* w, void* dx, void* dw,
                                     void* db, void* partial,
                                     long long partial_floats, int B, int T,
                                     int C, int K, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  if (bad_args(B, T, C, K, partial_floats)) return (int)cudaErrorInvalidValue;
  const int chunks = (T + kTT * kTiles - 1) / (kTT * kTiles);
  auto st = static_cast<cudaStream_t>(stream);
  dim3 grid((C + kCW - 1) / kCW, chunks, B);
  depthwise_bwd_kernel<<<grid, kThreads, smem_bytes(K), st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(w), static_cast<float*>(dx),
      static_cast<float*>(partial), T, C, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (K + 1) * C;
  depthwise_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw),
      static_cast<float*>(db), B * chunks, C, K);
  return (int)cudaGetLastError();
}

// K6: dw and db only, as sep_depthwise_bwd_f32 without w and dx.
extern "C" int sep_depthwise_bwd_w_f32(const void* x, const void* dy,
                                       void* dw, void* db, void* partial,
                                       long long partial_floats, int B,
                                       int T, int C, int K, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  if (bad_args(B, T, C, K, partial_floats)) return (int)cudaErrorInvalidValue;
  const int chunks = (T + kTT * kTiles - 1) / (kTT * kTiles);
  auto st = static_cast<cudaStream_t>(stream);
  dim3 grid((C + kCW - 1) / kCW, chunks, B);
  // the shared weight tile is not staged: only x and dy
  const size_t smem = smem_bytes(K) - sizeof(float) * (size_t)K * kCW;
  depthwise_dw_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<float*>(partial), T, C, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = (K + 1) * C;
  depthwise_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw),
      static_cast<float*>(db), B * chunks, C, K);
  return (int)cudaGetLastError();
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
  // x and the weight: smem_bytes less K5's second [rows][kCW] tile
  const size_t smem =
      smem_bytes(K) - sizeof(float) * (size_t)(kTT + K - 1) * kCW;
  depthwise_fwd_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), T, C, K);
  return (int)cudaGetLastError();
}
