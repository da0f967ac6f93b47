// One tile of the fused GCFN forward, shared by K1 (eval, csrc/gcfn.cu) and
// K7 (train, csrc/gcfn_train.cu): LayerNorm -> Linear F->6F -> optional
// u-row length mask -> depthwise k3 (zero pad in u-space) -> GLU ->
// [hash dropout, site 0] -> Linear 3F->F -> [hash dropout, site 1] ->
// LayerScale residual, in float32.
//
// Design: one block of 256 threads per (batch row, tile of TT frames).
// The block recomputes LayerNorm and the F->6F product for one halo row
// on each side of its tile, so tiles are independent and the 6F-wide u
// never leaves shared memory.  u rows outside [0, min(lens[b], T)) are
// set to zero, which is both the conv's zero padding and the length mask
// of masked eval.  Each thread keeps a register tile (all rows x 3F/128
// columns) for the first product and (TT*F/256 rows x 1 column) for the
// second; the weights stream from L2 in coalesced rows.  That needs the
// two products' weights as [in, out] in memory: the GCFN module stores
// its Linear weights so (transposed views with nn.Linear's [out, in]
// shape), and passes weight.t() without a copy.  Reading the [out, in]
// rows instead, where a warp's 32 rows lie 512 or 1536 bytes apart, ran
// 1.6x slower on an H100, straight from global memory or staged through
// shared memory; double-buffered cp.async staging closed only part of
// the gap.  Tensor cores (mma.sync / wgmma in TF32 or bf16) are later
// work: they would change the float32 numerics the reference is held to.
//
// With kDrop the tile drops the GLU output g at site 0 (columns 0..3F-1)
// and the down-projection o at site 1 (columns 0..F-1) by the hash of
// hash_dropout.cuh at the global row b*T + t, and scales the kept values
// by 1 / (1 - p): the JAX package's gcfn_train.py::_fwd_train_kernel.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_dropout.cuh"

namespace gcfn {

constexpr int kThreads = 256;

// The hash-dropout arguments of a train tile (unused in eval).
struct Drop {
  uint32_t seed0, seed1;  // seed words of sites 0 and 1
  uint32_t threshold;     // int(p * 2^24)
  float scale;            // 1 / (1 - p)
};

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int F, int TT>
struct Shape {
  static constexpr int H6 = 6 * F;
  static constexpr int H3 = 3 * F;
  static constexpr int R = TT + 2;  // tile rows plus one halo row per side
  static constexpr size_t smem_bytes =
      sizeof(float) * (size_t)(R * F + R * H6 + TT * H3);
};

template <int F, int TT, bool kDrop>
__device__ __forceinline__ void tile(
    float* smem, const float* __restrict__ x, const int* __restrict__ lens,
    const float* __restrict__ lns, const float* __restrict__ lnb,
    const float* __restrict__ win, const float* __restrict__ bin,
    const float* __restrict__ wdw, const float* __restrict__ bdw,
    const float* __restrict__ wout, const float* __restrict__ bout,
    const float* __restrict__ ls, float* __restrict__ out, int T, float eps,
    Drop drop) {
  using S = Shape<F, TT>;
  constexpr int H6 = S::H6, H3 = S::H3, R = S::R;
  float* xn = smem;          // [R][F]  normalized rows
  float* u = xn + R * F;     // [R][H6] projected rows (masked)
  float* g = u + R * H6;     // [TT][H3] gated rows

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int valid = lens ? min(lens[b], T) : T;
  const float* xb = x + (size_t)b * T * F;
  const uint32_t row0 = (uint32_t)b * (uint32_t)T + (uint32_t)t0;

  // 1. LayerNorm of frames t0-1 .. t0+TT, one warp per row.
  for (int r = warp; r < R; r += kThreads / 32) {
    const int t = t0 - 1 + r;
    float* dst = xn + r * F;
    if (t < 0 || t >= T) {
      for (int k = lane; k < F; k += 32) dst[k] = 0.f;
      continue;
    }
    const float* src = xb + (size_t)t * F;
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
      dst[k] = v[q] * inv * lns[k] + lnb[k];
    }
  }
  __syncthreads();

  // 2. u = xn @ win + bin for all R rows; rows outside [0, valid) -> 0.
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
      const bool keep = t >= 0 && t < valid;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int o = tid + c * kThreads;
        u[r * H6 + o] = keep ? acc[r][c] + bin[o] : 0.f;
      }
    }
  }
  __syncthreads();

  // 3. depthwise k3 over time, then GLU: g = y[:H3] * sigmoid(y[H3:]),
  //    dropped at site 0 in training.
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
    float gv = ya * (1.f / (1.f + expf(-yb)));
    if (kDrop)
      gv = sep_keep(drop.seed0, row0 + i, (uint32_t)c, drop.threshold)
               ? gv * drop.scale
               : 0.f;
    g[i * H3 + c] = gv;
  }
  __syncthreads();

  // 4. out = x + ls * (g @ wout + bout), the sum dropped at site 1 in
  //    training.
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
        float o = acc[q] + bias;
        if (kDrop)
          o = sep_keep(drop.seed1, row0 + row_a + q, (uint32_t)col,
                       drop.threshold)
                  ? o * drop.scale
                  : 0.f;
        const size_t off = (size_t)t * F + col;
        out[(size_t)b * T * F + off] = xb[off] + scale * o;
      }
    }
  }
}

}  // namespace gcfn
