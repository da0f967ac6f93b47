// Fused CLA local block (eval), K15: LayerNorm -> Linear F->2F -> GLU ->
// depthwise k65 "same" (zero padding of the GLU output v) -> Linear F->2F
// -> folded BatchNorm y*s + t -> exact GELU -> Linear 2F->F -> x + ls*out,
// in float32, with the three products on the tensor cores at float32
// accuracy (3xTF32, mma_tf32x3.cuh).
//
// Replaces: sepreformer_tpu/ops/pallas/cla.py::fused_cla (_fused_cla_impl,
//           body _cla_kernel).
//
// What bounds it on the H100: three products of 2*F*2F flops per row
// (65.5 kflop each at F = 128, 262 at F = 256), at the 3xTF32 rate
// (495 / 3 TFLOP/s) 0.038 ms at [4, 8000, 128] and 0.153 ms at
// [4, 8000, 256]; the conv's 2*65*F and the elementwise work (~0.68
// GFLOP at F = 128, ~0.010 ms on the CUDA cores) and the bytes (x and
// out, ~0.010 ms at 3.35 TB/s at F = 128; ~0.020 ms with v's round trip)
// lie under it.  On the CUDA cores alone the products would take 0.104
// ms at F = 128.
//
// Design: two launches of 256 threads per tile of TT = 64 rows.  The k65
// conv reads 32 v rows past each edge of a tile,
// and v = GLU(LN(x) W_in + b_in) must be zero outside [0, T) (the conv
// pads its input, v, not x: GLU of a zero x row is not zero).  One launch
// that recomputed LN and the first product on the halo would do that
// product twice at a tile of 64 rows; here the first launch writes v
// [B, T, F] to device memory, 16.4 MB at [4, 8000, 128], and the second
// stages each tile's window of v rows with zeros outside [0, T): the halo
// is right by construction.
//   - cla_glu_kernel: LayerNorm of the tile into xn [TT][F + 8], then
//     W_in in F / 32 chunks of 32 GLU pairs (value column c and its gate
//     c + F side by side), double-buffered by cp.async.  Each warp's two
//     n-tiles are the value and the gate columns of the same 8 pairs, so
//     the GLU runs on the fragments and v leaves from registers.
//   - cla_tail_kernel: the window of TT + 64 v rows and the conv weight
//     staged, the conv as a sliding window of R rows in registers per
//     (channel, R-row part of the tile), one shared load per tap and row
//     instead of one per tap and output row; its output y [TT][F + 8]
//     overlays the dead window.  Then the hidden width in 2F / 32 chunks
//     of 32 columns:
//     z_c = GELU((y W_mid[:, c] + b_mid) s + t) on the fragments into
//     shared memory, o += z_c W_out[c rows, :] in float32 fragments that
//     stay in registers across the chunks.  W_mid's and W_out's chunks
//     are staged by cp.async over the dead conv weight, one buffer each
//     as in the GCFN tile (gcfn_tile_mma.cuh): W_out_c lands during the
//     z product, W_mid_{c+1} during the o product.  The epilogue writes
//     out = x + ls * (o + b_out) from the fragments, for the rows t < T.
// Each weight crosses from L2 once per 64 rows (the CUDA-core design read
// all three once per 32).  Each chunk's products start from zeroed
// fragments and are added to float32 sums (mma_tf32x3.cuh says why).
// GELU is exact (erff): the TPU kernel approximated erf only because
// Mosaic had no erf lowering.  No atomics: the same bits on every call.
//
// Two instances, one code: the shapes below give each launch its blocks
// per SM (blocks_for), and __launch_bounds__ takes it.
//   - Base's F = 128: the GLU launch 102 KB, the tail 98.5 KB, two
//     blocks per SM each (a thread at most 128 registers); the conv's
//     R = 32 rows a thread, two threads a channel.
//   - Large's F = 256: the GLU launch 202 KB (xn 64 x 264 floats and two
//     W_in buffers of 256 x 68), the tail 196.5 KB (the 128-row window of
//     v, then the weights), one block per SM each, as K1, K7 and K8 at
//     F = 256.  The SM's eight warps are then the block's own, and a
//     thread may take 255 registers: the conv keeps R = 64 rows of one
//     channel (acc[64] and win[64], 128 registers, which would spill
//     under two blocks' 128), the o product 64 accumulators a thread
//     (OMT 2 x ONT 8 fragments).  Smaller tiles that kept two blocks
//     (32 rows, or the conv in two 32-row halves) would read every weight
//     twice as often and stage a 64-row halo for 32 rows of output.
// Each shape asserts its budget; tests/test_torch_large_fused_tiling.py
// reads the numbers back from this file.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 65;              // the CLA's depthwise kernel
constexpr int kHalo = (kK - 1) / 2;
constexpr int kTT = 64;             // rows per tile, both launches
constexpr int kCH = 32;             // GLU pairs, or hidden columns, a chunk
// Of an SM's 228 KB, with 1 KB reserved per block: two blocks of at most
// 113 KB, or one of at most 227 KB.
constexpr size_t kTwoBlocks = 113 * 1024, kOneBlock = 227 * 1024;

// Blocks per SM of a launch whose block takes `bytes` of shared memory.
constexpr int blocks_for(size_t bytes) { return bytes <= kTwoBlocks ? 2 : 1; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row and stride layout of launch 1.  Row strides are 8 mod 32 where a
// fragment takes 8 bytes of a row (the A operand xn), 4 mod 32 where it
// takes rows 2t and 2t+1 of a column (the staged B operand): no bank
// conflicts.
template <int F>
struct GluShape {
  static constexpr int NC = 2 * kCH;          // a chunk's W_in columns
  static constexpr int chunks = F / kCH;
  // warps 2 x 4: rows 32 wm .., the 8 pairs 8 wn .. of the chunk
  static constexpr int WN = 4, WM = kWarps / WN, MT = kTT / 16 / WM;
  static constexpr int LX = F + 8, LW = NC + 4;
  static constexpr int xn = 0, wi = xn + kTT * LX, floats = wi + 2 * F * LW;
  static constexpr size_t smem_bytes = sizeof(float) * (size_t)floats;
  static constexpr int blocks_per_sm = blocks_for(smem_bytes);
  static_assert(kCH == 8 * WN && kTT == 16 * MT * WM, "warp tiling");
  static_assert(smem_bytes <= kOneBlock, "at least one block per SM");
  static_assert(F != 128 || blocks_per_sm == 2, "Base: two blocks per SM");
};

// LayerNorm of rows t0 .. t0+kTT-1 of xb into xn [kTT][LX], zero past T;
// each warp takes every kWarps-th row, all its rows' loads in flight.
template <int F, int LX>
__device__ __forceinline__ void layer_norm_tile(
    float* xn, const float* __restrict__ xb, const float* __restrict__ lns,
    const float* __restrict__ lnb, int t0, int T, float eps) {
  constexpr int RW = kTT / kWarps, Q = F / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[RW][Q];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int t = t0 + warp + i * kWarps;
    const float* src = xb + (size_t)(t < T ? t : 0) * F + lane;
#pragma unroll
    for (int q = 0; q < Q; ++q) v[i][q] = t < T ? src[32 * q] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + i * kWarps;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) s += v[i][q];
    const float mean = warp_sum(s) * (1.f / F);
    float s2 = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      v[i][q] -= mean;
      s2 += v[i][q] * v[i][q];
    }
    const float inv = rsqrtf(warp_sum(s2) * (1.f / F) + eps);
    const bool in = t0 + r < T;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      xn[r * LX + k] = in ? v[i][q] * inv * lns[k] + lnb[k] : 0.f;
    }
  }
}

// Launch 1: v[b, t] = GLU(LN(x[b, t]) W_in + b_in) for kTT rows a block.
template <int F>
__global__ void __launch_bounds__(kThreads, GluShape<F>::blocks_per_sm)
cla_glu_kernel(const float* __restrict__ x, const float* __restrict__ lns,
               const float* __restrict__ lnb, const float* __restrict__ w_in,
               const float* __restrict__ b_in, float* __restrict__ v, int T,
               float eps) {
  using S = GluShape<F>;
  constexpr int NC = S::NC, LX = S::LX, LW = S::LW, MT = S::MT;
  extern __shared__ __align__(16) float smem[];
  float* xn = smem + S::xn;  // [kTT][LX] LN rows t0 ..
  const int b = blockIdx.y, t0 = blockIdx.x * kTT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = warp / S::WN, wn = warp - wm * S::WN;

  // chunk c's columns of W_in [F, 2F] into buffer c % 2 [F][LW]: local
  // column j < kCH is value column c*kCH + j, j >= kCH its gate, F later
  auto stage = [&](int c) {
    float* dst = smem + S::wi + (c & 1) * F * LW;
#pragma unroll
    for (int q = 0; q < F * NC / 4 / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int k = e / (NC / 4), j = 4 * (e - k * (NC / 4));
      const int col = c * kCH + j + (j < kCH ? 0 : F - kCH);
      tf32x3::cp_async16(dst + k * LW + j, w_in + (size_t)k * 2 * F + col,
                         true);
    }
    tf32x3::cp_async_commit();
  };
  stage(0);
  layer_norm_tile<F, LX>(xn, x + (size_t)b * T * F, lns, lnb, t0, T, eps);

  for (int c = 0; c < S::chunks; ++c) {
    if (c + 1 < S::chunks) {
      stage(c + 1);  // into the buffer chunk c-1 read
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and xn) in place
    const float* wi = smem + S::wi + (c & 1) * F * LW;
    // n-tile 0: the values of pairs 8 wn .., n-tile 1: their gates
    float a[MT][2][4] = {};
    tf32x3::warp_product<MT, 2, F / 8>(
        a, xn + 16 * MT * wm * LX, LX, [&](int ks, int nt) {
          const float* w = wi + (8 * ks + 2 * t4) * LW + nt * kCH + 8 * wn + g8;
          return make_float2(w[0], w[LW]);
        });
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + 16 * (MT * wm + mt) + g8 + 8 * h;
        if (t >= T) continue;
        const int p = c * kCH + 8 * wn + 2 * t4;  // the pair (column of v)
        float g[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float val = a[mt][0][2 * h + q] + b_in[p + q];
          const float gate = a[mt][1][2 * h + q] + b_in[F + p + q];
          g[q] = val * __fdividef(1.f, 1.f + expf(-gate));
        }
        *reinterpret_cast<float2*>(v + ((size_t)b * T + t) * F + p) =
            make_float2(g[0], g[1]);
      }
    __syncthreads();  // every warp has read buffer c % 2
  }
}

// Launch 2's layout.  During the conv: the window [W][F] of v rows and the
// conv weight [F][kK] (the Conv1d's own layout: lanes take channels, and
// the odd stride 65 keeps them on distinct banks).  Then y [kTT][LY] and
// z [kTT][LZ] over the window, and W_mid's chunk [F][LM] and W_out's
// [kCH][LO] over the conv weight.
template <int F>
struct TailShape {
  static constexpr int H = 2 * F, chunks = H / kCH;
  static constexpr int W = kTT + kK - 1;  // window rows t0-32 .. t0+95
  static constexpr int R = kTT * F / kThreads;  // conv rows a thread
  // the z product: warps 4 x 2, rows 16 wm .., columns 16 wn ..
  static constexpr int ZWN = 2, ZWM = kWarps / ZWN, ZMT = kTT / 16 / ZWM,
                       ZNT = kCH / 8 / ZWN;
  // the o product: warps 2 x 4, rows 32 wm .., columns 32 wn ..
  static constexpr int OWN = 4, OWM = kWarps / OWN, OMT = kTT / 16 / OWM,
                       ONT = F / 8 / OWN;
  static constexpr int LY = F + 8, LZ = kCH + 8, LM = kCH + 4, LO = F + 4;
  static constexpr int vw = 0, y = 0, z = y + kTT * LY;
  static constexpr int ws = vw + W * F, wm = ws, wo = wm + F * LM;
  static constexpr int weights = F * LM + kCH * LO > F * kK
                                     ? F * LM + kCH * LO
                                     : F * kK;
  static constexpr int floats = ws + weights;
  static constexpr size_t smem_bytes = sizeof(float) * (size_t)floats;
  static constexpr int blocks_per_sm = blocks_for(smem_bytes);
  static_assert(z + kTT * LZ <= ws, "y and z fit over the window");
  static_assert(kTT == 16 * ZMT * ZWM && kTT == 16 * OMT * OWM,
                "warp tiling");
  static_assert(kThreads % F == 0 && R * (kThreads / F) == kTT,
                "conv: a thread per (channel, R rows)");
  static_assert(smem_bytes <= kOneBlock, "at least one block per SM");
  static_assert(F != 128 || blocks_per_sm == 2, "Base: two blocks per SM");
  // the conv's acc[R] and win[R] within a thread's registers: 255 at one
  // block per SM, 128 at two
  static_assert(2 * R <= (blocks_per_sm == 1 ? 128 : 64),
                "conv registers");
};

// Launch 2: out = x + ls * (GELU((conv(v) W_mid + b_mid) * s + t) W_out +
// b_out) for kTT rows a block.
template <int F>
__global__ void __launch_bounds__(kThreads, TailShape<F>::blocks_per_sm)
cla_tail_kernel(const float* __restrict__ x, const float* __restrict__ v,
                const float* __restrict__ wdw, const float* __restrict__ bdw,
                const float* __restrict__ w_mid,
                const float* __restrict__ b_mid,
                const float* __restrict__ bn_s, const float* __restrict__ bn_t,
                const float* __restrict__ w_out,
                const float* __restrict__ b_out, const float* __restrict__ ls,
                float* __restrict__ out, int T) {
  using S = TailShape<F>;
  constexpr int R = S::R, LY = S::LY, LZ = S::LZ, LM = S::LM, LO = S::LO;
  constexpr int ZMT = S::ZMT, ZNT = S::ZNT, OMT = S::OMT, ONT = S::ONT,
                H = S::H;
  extern __shared__ __align__(16) float smem[];
  float* vw = smem + S::vw;  // [W][F] v rows t0-32 .. (conv)
  float* ws = smem + S::ws;  // [F][kK] the conv weight (conv)
  float* y = smem + S::y;    // [kTT][LY] the conv's output (chunk loop)
  float* z = smem + S::z;    // [kTT][LZ] the chunk's GELU output
  float* wm = smem + S::wm;  // [F][LM] W_mid[:, chunk]
  float* wo = smem + S::wo;  // [kCH][LO] W_out[chunk rows, :]
  const int b = blockIdx.y, t0 = blockIdx.x * kTT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const float* vb = v + (size_t)b * T * F;

  // the window, zero outside [0, T), and the conv weight [F, 1, kK]
#pragma unroll
  for (int q = 0; q < S::W * F / 4 / kThreads; ++q) {
    const int e = tid + q * kThreads;
    const int r = e / (F / 4), j = 4 * (e - r * (F / 4)), t = t0 - kHalo + r;
    const bool in = t >= 0 && t < T;
    tf32x3::cp_async16(vw + r * F + j, vb + (size_t)(in ? t : 0) * F + j, in);
  }
  tf32x3::cp_async_commit();
  for (int e = tid; e < F * kK; e += kThreads) ws[e] = wdw[e];

  // chunk c's columns of W_mid [F, 2F] and rows of W_out [2F, F]
  auto stage_mid = [&](int c) {
#pragma unroll
    for (int q = 0; q < F * kCH / 4 / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int k = e / (kCH / 4), j = 4 * (e - k * (kCH / 4));
      tf32x3::cp_async16(wm + k * LM + j, w_mid + (size_t)k * H + c * kCH + j,
                         true);
    }
    tf32x3::cp_async_commit();
  };
  auto stage_out = [&](int c) {
#pragma unroll
    for (int q = 0; q < kCH * F / 4 / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int k = e / (F / 4), j = 4 * (e - k * (F / 4));
      tf32x3::cp_async16(wo + k * LO + j, w_out + (size_t)(c * kCH + k) * F + j,
                         true);
    }
    tf32x3::cp_async_commit();
  };

  tf32x3::cp_async_wait<0>();
  __syncthreads();  // the window and the weight are in place

  // conv: thread takes channel ch over the R output rows r0 ..; window
  // row r0 + r + tap is output row r0 + r's tap, so R window rows slide
  // through registers, one new row per tap.  acc = bias + the taps in
  // order.
  float acc[R];
  {
    const int ch = tid % F, r0 = (tid / F) * R;
    const float* col = vw + r0 * F + ch;
    const float* wc = ws + ch * kK;
    float win[R];
    const float bias = bdw[ch];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r] = bias;
      win[r] = col[r * F];
    }
#pragma unroll
    for (int tap = 0; tap < kK; ++tap) {
      const float w = wc[tap];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(w, win[r], acc[r]);
      if (tap + 1 < kK) {
#pragma unroll
        for (int r = 0; r + 1 < R; ++r) win[r] = win[r + 1];
        win[R - 1] = col[(R + tap) * F];
      }
    }
  }
  __syncthreads();  // the window and the conv weight are read
  stage_mid(0);     // over the conv weight
  {
    const int ch = tid % F, r0 = (tid / F) * R;
#pragma unroll
    for (int r = 0; r < R; ++r) y[(r0 + r) * LY + ch] = acc[r];
  }

  const int zwm = warp / S::ZWN, zwn = warp - zwm * S::ZWN;
  const int owm = warp / S::OWN, own = warp - owm * S::OWN;
  float o[OMT][ONT][4] = {};
  for (int c = 0; c < S::chunks; ++c) {
    tf32x3::cp_async_wait<0>();
    // W_mid's chunk c (and y) in place; chunk c-1 has read z and wo
    __syncthreads();
    stage_out(c);

    // z_c = GELU((y wm + b_mid) * s + t): rows 16 ZMT zwm ..,
    // columns 8 ZNT zwn ..
    {
      float a[ZMT][ZNT][4] = {};
      tf32x3::warp_product<ZMT, ZNT, F / 8>(
          a, y + 16 * ZMT * zwm * LY, LY, [&](int ks, int nt) {
            const float* w =
                wm + (8 * ks + 2 * t4) * LM + 8 * (ZNT * zwn + nt) + g8;
            return make_float2(w[0], w[LM]);
          });
#pragma unroll
      for (int mt = 0; mt < ZMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < ZNT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * (ZMT * zwm + mt) + g8 + 8 * h;
            const int j = 8 * (ZNT * zwn + nt) + 2 * t4, hc = c * kCH + j;
            float g[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float hv =
                  (a[mt][nt][2 * h + q] + b_mid[hc + q]) * bn_s[hc + q] +
                  bn_t[hc + q];
              g[q] = 0.5f * hv * (1.f + erff(hv * 0.70710678118654752f));
            }
            *reinterpret_cast<float2*>(z + r * LZ + j) =
                make_float2(g[0], g[1]);
          }
    }
    tf32x3::cp_async_wait<0>();  // W_out's chunk c
    __syncthreads();             // z is written, wm read and wo in place
    if (c + 1 < S::chunks) stage_mid(c + 1);  // lands during the o product

    // o += z_c wo: rows 32 owm .., columns 32 own ..
    tf32x3::warp_product<OMT, ONT, kCH / 8>(
        o, z + 16 * OMT * owm * LZ, LZ, [&](int ks, int nt) {
          const float* w =
              wo + (8 * ks + 2 * t4) * LO + 8 * (ONT * own + nt) + g8;
          return make_float2(w[0], w[LO]);
        });
  }

  // out = x + ls * (o + b_out) for the rows t < T
#pragma unroll
  for (int mt = 0; mt < OMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + 16 * (OMT * owm + mt) + g8 + 8 * h;
      if (t >= T) continue;
      const size_t off = ((size_t)b * T + t) * F;
#pragma unroll
      for (int nt = 0; nt < ONT; ++nt) {
        const int col = 8 * (ONT * own + nt) + 2 * t4;
        const float2 xv = *reinterpret_cast<const float2*>(x + off + col);
        const float o0 = xv.x + ls[col] * (o[mt][nt][0 + 2 * h] + b_out[col]);
        const float o1 =
            xv.y + ls[col + 1] * (o[mt][nt][1 + 2 * h] + b_out[col + 1]);
        *reinterpret_cast<float2*>(out + off + col) = make_float2(o0, o1);
      }
    }
}

// Both kernels' dynamic shared memory, and the carveout at its most shared
// memory, so that two blocks share an SM at F = 128 and one fits at 256.
template <int F>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      cla_glu_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GluShape<F>::smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cla_tail_kernel<F>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)TailShape<F>::smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cla_glu_kernel<F>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cla_tail_kernel<F>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int F>
int launch(const float* x, const float* lns, const float* lnb,
           const float* w_in, const float* b_in, const float* wdw,
           const float* bdw, const float* w_mid, const float* b_mid,
           const float* bn_s, const float* bn_t, const float* w_out,
           const float* b_out, const float* ls, float* v, float* out, int B,
           int T, float eps, cudaStream_t stream) {
  cudaError_t err = set_attributes<F>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kTT - 1) / kTT, B);
  cla_glu_kernel<F><<<grid, kThreads, GluShape<F>::smem_bytes, stream>>>(
      x, lns, lnb, w_in, b_in, v, T, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cla_tail_kernel<F><<<grid, kThreads, TailShape<F>::smem_bytes, stream>>>(
      x, v, wdw, bdw, w_mid, b_mid, bn_s, bn_t, w_out, b_out, ls, out, T);
  return (int)cudaGetLastError();
}

template <int F>
cudaError_t blocks_per_sm(int* n) {
  cudaError_t err = set_attributes<F>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, cla_glu_kernel<F>, kThreads, GluShape<F>::smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n + 1, cla_tail_kernel<F>, kThreads, TailShape<F>::smem_bytes);
  return err;
}

}  // namespace

// Pointers are device pointers to float32, x, v and out 16-byte aligned.
// w_in, w_mid [F, 2F] and w_out [2F, F] are [in, out], contiguous and
// 16-byte aligned; wdw is the Conv1d weight [F, 1, 65]; bn_s, bn_t [2F]
// the folded BatchNorm; v [B, T, F] is scratch.  Built for Base's
// F = 128 and Large's F = 256.
extern "C" int sep_cla_f32(const void* x, const void* lns, const void* lnb,
                           const void* w_in, const void* b_in,
                           const void* wdw, const void* bdw,
                           const void* w_mid, const void* b_mid,
                           const void* bn_s, const void* bn_t,
                           const void* w_out, const void* b_out,
                           const void* ls, void* v, void* out, int B, int T,
                           int F, float eps, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (B <= 0 || T <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  auto run = [&](auto launcher) {
    return launcher(f(x), f(lns), f(lnb), f(w_in), f(b_in), f(wdw), f(bdw),
                    f(w_mid), f(b_mid), f(bn_s), f(bn_t), f(w_out), f(b_out),
                    f(ls), static_cast<float*>(v), static_cast<float*>(out),
                    B, T, eps, static_cast<cudaStream_t>(stream));
  };
  if (F == 128) return run(launch<128>);
  if (F == 256) return run(launch<256>);
  return (int)cudaErrorInvalidValue;
}

// Blocks of each K15 launch at width F that one SM holds at once, with the
// launch's attributes set (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// into blocks[0] (the GLU launch) and blocks[1] (the tail).
extern "C" int sep_cla_blocks_per_sm(int F, void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (F == 128) return (int)blocks_per_sm<128>(n);
  if (F == 256) return (int)blocks_per_sm<256>(n);
  return (int)cudaErrorInvalidValue;
}
