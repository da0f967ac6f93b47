// The tile of K16 (csrc/ega_gcfn.cu): a GlobalBlock's EGA tail, then the
// GCFN -- LayerNorm -> Linear F->6F -> depthwise k3 (zero pad in u-space)
// -> GLU -> Linear 3F->F -> LayerScale residual -- in float32 on the CUDA
// cores.
//
// K1 and K7 ran this tile too until they moved to gcfn_tile_mma.cuh,
// which takes the two products on the tensor cores at float32 accuracy
// (3xTF32) over 62-row tiles with the weights staged in shared memory.
// K16 waits for that move until the spread of its time between machines
// (0.38 to 0.51 ms on the same code) is settled, so that its change can
// be timed.
//
// Design: one block of 256 threads per (batch row, tile of TT frames).
// The tail first runs over the tile's R = TT + 2 rows, halo rows included:
// y = x + sigmoid(LN_g(x) Wg + bg) * x_down[t / r] with r = T / L, the
// nearest upsample of the attention output read in place, into a shared
// [R][F] buffer past the tile's others; rows outside [0, T) of y are
// zero.  The block then recomputes LayerNorm of y and the F->6F product
// for one halo row on each side, so tiles are independent and the 6F-wide
// u never leaves shared memory.  u rows outside [0, T) are set to zero,
// the conv's zero padding.  Each thread keeps a register tile (all rows x
// 3F/128 columns) for the first product and (TT*F/256 rows x 1 column)
// for the second; the weights stream from L2 in coalesced rows.  That
// needs the two products' weights as [in, out] in memory: the GCFN module
// stores its Linear weights so (transposed views with nn.Linear's
// [out, in] shape), and passes weight.t() without a copy.  Reading the
// [out, in] rows instead, where a warp's 32 rows lie 512 or 1536 bytes
// apart, ran 1.6x slower on an H100, straight from global memory or
// staged through shared memory; double-buffered cp.async staging closed
// only part of the gap.  The residual adds to y.
#pragma once

#include <cuda_runtime.h>

namespace gcfn {

constexpr int kThreads = 256;

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The EGA tail's inputs.
struct Pair {
  const float* x_down;    // [B, L, F], the attention's output
  int L;                  // the bottleneck length; T = L * (T / L)
  const float* gns;       // the gate's LayerNorm scale and bias [F]
  const float* gnb;
  const float* wg;        // the gate's Linear [F, F], [in, out]
  const float* bg;        // [F]
};

template <int F, int TT>
struct Shape {
  static constexpr int H6 = 6 * F;
  static constexpr int H3 = 3 * F;
  static constexpr int R = TT + 2;  // tile rows plus one halo row per side
  // xn [R][F], u [R][H6], g [TT][H3], then the tail's output y [R][F]
  static constexpr size_t smem_bytes =
      sizeof(float) * (size_t)(R * F + R * H6 + TT * H3 + R * F);
};

// LayerNorm of one row of F values (src, in global or shared memory) into
// dst, by one warp.
template <int F>
__device__ __forceinline__ void layer_norm_row(
    const float* src, float* dst, const float* __restrict__ scale,
    const float* __restrict__ shift, float eps, int lane) {
  float v[F / 32];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < F / 32; ++q) {
    v[q] = src[lane + 32 * q];
    s += v[q];
  }
  const float mean = warp_sum(s) * (1.f / F);
  float s2 = 0.f;
#pragma unroll
  for (int q = 0; q < F / 32; ++q) {
    v[q] -= mean;
    s2 += v[q] * v[q];
  }
  const float inv = rsqrtf(warp_sum(s2) * (1.f / F) + eps);
#pragma unroll
  for (int q = 0; q < F / 32; ++q) {
    const int k = lane + 32 * q;
    dst[k] = v[q] * inv * scale[k] + shift[k];
  }
}

template <int F, int TT>
__device__ __forceinline__ void tile(
    float* smem, const float* __restrict__ x, Pair pair,
    const float* __restrict__ lns, const float* __restrict__ lnb,
    const float* __restrict__ win, const float* __restrict__ bin,
    const float* __restrict__ wdw, const float* __restrict__ bdw,
    const float* __restrict__ wout, const float* __restrict__ bout,
    const float* __restrict__ ls, float* __restrict__ out, int T, float eps) {
  using S = Shape<F, TT>;
  constexpr int H6 = S::H6, H3 = S::H3, R = S::R;
  float* xn = smem;          // [R][F]  normalized rows
  float* u = xn + R * F;     // [R][H6] projected rows (masked)
  float* g = u + R * H6;     // [TT][H3] gated rows
  float* y = g + TT * H3;    // [R][F]  the EGA tail's output

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xb = x + (size_t)b * T * F;

  {  // 0. the EGA tail
    // 0a. y <- x and xn <- LN_g(x) for frames t0-1 .. t0+TT (zero rows
    //     outside [0, T)), one warp per row.
    for (int r = warp; r < R; r += kThreads / 32) {
      const int t = t0 - 1 + r;
      if (t < 0 || t >= T) {
        for (int k = lane; k < F; k += 32) xn[r * F + k] = y[r * F + k] = 0.f;
        continue;
      }
      for (int k = lane; k < F; k += 32) y[r * F + k] = xb[(size_t)t * F + k];
      layer_norm_row<F>(xb + (size_t)t * F, xn + r * F, pair.gns, pair.gnb,
                        eps, lane);
    }
    __syncthreads();
    // 0b. y += sigmoid(xn Wg + bg) * x_down[t / (T / L)]: a thread takes
    //     column c of every other row.
    constexpr int RP = (R + 1) / 2;
    const int c = tid % F, half = tid / F;
    static_assert(2 * F == kThreads, "two threads per column of the gate");
    float acc[RP];
#pragma unroll
    for (int q = 0; q < RP; ++q) acc[q] = 0.f;
    for (int k = 0; k < F; k += 4) {
      float w[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) w[kk] = pair.wg[(size_t)(k + kk) * F + c];
#pragma unroll
      for (int q = 0; q < RP; ++q) {
        const int r = half + 2 * q;
        if (r < R) {
          const float4 a = *reinterpret_cast<const float4*>(xn + r * F + k);
          acc[q] += a.x * w[0] + a.y * w[1] + a.z * w[2] + a.w * w[3];
        }
      }
    }
    const int ratio = T / pair.L;
    const float* db = pair.x_down + (size_t)b * pair.L * F;
#pragma unroll
    for (int q = 0; q < RP; ++q) {
      const int r = half + 2 * q, t = t0 - 1 + r;
      if (r < R && t >= 0 && t < T) {
        const float gate = 1.f / (1.f + expf(-(acc[q] + pair.bg[c])));
        y[r * F + c] += gate * db[(size_t)(t / ratio) * F + c];
      }
    }
    __syncthreads();
  }

  // 1. LayerNorm of y for frames t0-1 .. t0+TT, one warp per row.
  for (int r = warp; r < R; r += kThreads / 32) {
    const int t = t0 - 1 + r;
    float* dst = xn + r * F;
    if (t < 0 || t >= T) {
      for (int k = lane; k < F; k += 32) dst[k] = 0.f;
      continue;
    }
    layer_norm_row<F>(y + r * F, dst, lns, lnb, eps, lane);
  }
  __syncthreads();

  // 2. u = xn @ win + bin for all R rows; rows outside [0, T) -> 0.
  {
    constexpr int NC = H6 / kThreads;
    float acc[R][NC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < F; k += 4) {
      float w[4][NC];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          w[kk][c] = win[(size_t)(k + kk) * H6 + tid + c * kThreads];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(xn + r * F + k);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] += a.x * w[0][c] + a.y * w[1][c] + a.z * w[2][c] +
                       a.w * w[3][c];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 - 1 + r;
      const bool keep = t >= 0 && t < T;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int o = tid + c * kThreads;
        u[r * H6 + o] = keep ? acc[r][c] + bin[o] : 0.f;
      }
    }
  }
  __syncthreads();

  // 3. depthwise k3 over time, then GLU: g = y[:H3] * sigmoid(y[H3:]).
  for (int idx = tid; idx < TT * H3; idx += kThreads) {
    const int i = idx / H3, c = idx - (idx / H3) * H3;
    const float* u0 = u + i * H6;  // frame t-1 (tile row i is u row i+1)
    const int c2 = c + H3;
    const float* wa = wdw + 3 * c;   // wdw [H6][3]: channel, tap
    const float* wb = wdw + 3 * c2;
    const float ya = u0[c] * wa[0] + u0[H6 + c] * wa[1] +
                     u0[2 * H6 + c] * wa[2] + bdw[c];
    const float yb = u0[c2] * wb[0] + u0[H6 + c2] * wb[1] +
                     u0[2 * H6 + c2] * wb[2] + bdw[c2];
    g[i * H3 + c] = ya * (1.f / (1.f + expf(-yb)));
  }
  __syncthreads();

  // 4. out = y + ls * (g @ wout + bout).
  {
    constexpr int RPT = TT * F / kThreads;  // rows per thread
    const int col = tid % F, row_a = (tid / F) * RPT;
    float acc[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
    for (int k = 0; k < H3; ++k) {
      const float w = wout[(size_t)k * F + col];
#pragma unroll
      for (int q = 0; q < RPT; ++q) acc[q] += g[(row_a + q) * H3 + k] * w;
    }
    const float scale = ls[col], bias = bout[col];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int t = t0 + row_a + q;
      if (t < T) {
        const float o = acc[q] + bias;
        const size_t off = (size_t)t * F + col;
        out[(size_t)b * T * F + off] = y[(row_a + q + 1) * F + col] + scale * o;
      }
    }
  }
}

}  // namespace gcfn
