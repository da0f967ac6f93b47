// The GCFN forward tile of K1 (eval, csrc/gcfn.cu), K7 (train,
// csrc/gcfn_train.cu) and K16 (the EGA tail + GCFN, csrc/ega_gcfn.cu):
// [K16's EGA tail] -> LayerNorm -> Linear F->6F -> optional u-row length
// mask -> depthwise k3 (zero pad in u-space) -> GLU -> [hash dropout,
// site 0] -> Linear 3F->F -> [hash dropout, site 1] -> LayerScale
// residual, with every product on the tensor cores at float32 accuracy
// (3xTF32, mma_tf32x3.cuh) and the rest in float32 on the CUDA cores.
//
// Design: one block of 256 threads per (batch row, tile of TT = 62
// frames), two blocks per SM at F = 128 (one at F = 256, whose tile
// takes 199 KB of shared memory: Shape::blocks_per_sm).  The block recomputes LayerNorm and the
// F->6F product for one halo row on each side, so tiles are independent:
// R = TT + 2 = 64 u rows, four m16 fragments.  It walks the hidden width
// in chunks of CH = 32 GLU pairs (columns c and c + 3F together, since
// the k3 conv and the GLU act per column), as K8's row pass does.  Per
// chunk:
//   - u = xn win_c + bin, each warp a 32 x 16 block of the [64, 2 CH]
//     chunk; u rows outside [0, min(lens[b], T)) are zero, which is both
//     the conv's zero padding and the length mask of masked eval (a tile
//     whose rows all lie past lens[b] skips the product);
//   - dw3 and the GLU give g_c for the TT tile rows;
//   - o += g_c wout_c, each warp a 32 x 32 block of o [64, F], which
//     stays in float32 registers across the chunks.
// win[:, chunk] and wout[chunk rows, :] are staged in shared memory by
// cp.async, one buffer each: win_{c+1} is issued once the u product has
// read win_c and lands during the GLU and the second product; wout_c is
// issued at the chunk's start and lands during the first product and the
// GLU.  Each chunk's products start from zeroed fragments and are added
// to the float32 sums (mma_tf32x3.cuh says why).  The epilogue writes
// out = x + ls * (o + bout) from the fragments, for the rows t < T.
//
// Why: a CUDA-core tile (every multiply-add on the CUDA cores, all 590 KB
// of win and wout read from L2 for each tile of 16 rows) moves 1.2 GB per
// [4, 8000, 128] call.
// Here the products run at the 3xTF32 rate (their bound falls from 0.145
// to 0.057 ms at that shape) and the weights cross from L2 once per 62
// rows, 0.3 GB.  mma.sync and not wgmma, for the reason mma_tf32x3.cuh
// gives: a chunk's product is 64 rows by one chunk deep, and the float32
// LayerNorm, conv and GLU between the products set the pace.  The single
// buffers keep the block at 113 KB of shared memory and 128 registers, so
// two blocks share an SM and one's GLU overlaps the other's products: a
// double-buffered tile of 163 KB ran one block per SM and slower on an
// H100, and so did 30-row tiles, 16-pair chunks and 126-row tiles of 512
// threads (one block per SM, and half the blocks for the narrow stages).
// The A operands (xn, g) are split into TF32 parts per fragment, as K8
// splits them: split once they would need twice the shared memory.  The
// GLU loop has a fixed trip count and no branch (its division is
// __fdividef, 2 ulp): an IEEE division's slow-path call kept its rows
// from overlapping.
//
// With kPair (K16) a prologue first runs the EGA tail over the R rows,
// y = x + sigmoid(LN_g(x) wg + bg) * x_down[t / r] (zero outside
// [0, T)): LN_g(x) into xn, the gate product as F / NC warp products of
// NC columns each (wg's parts), the u product's call, with the parts
// staged through wi by cp.async, and the gated residual in the
// fragments.  Its tile rows also go to out, where the epilogue reads
// its residual.  Where y [R][F + 8] lies (Shape's y_over_wo):
//   - F = 128: two parts; y (34 KB) overlays wo and u, which the chunk
//     loop fills only after it, so the block keeps its 113 KB and two
//     blocks per SM; each part's y is stored as it comes, and win's
//     first chunk is staged during the second part's epilogue.
//   - F = 256: four parts; y (66 KB) is larger than wo and u (50.5 KB)
//     and the tile (199 KB, one block per SM) has no 66 KB to spare, so
//     y overlays wi, which holds it (64 x 264 <= 256 x 68 floats) once
//     the last part is read.  Until then each part's y waits in
//     registers: 16 floats a part, 64 in all, within the 255 registers
//     a thread has at one block per SM.  win's first chunk is staged
//     after LayerNorm of y has read wi.
// LayerNorm of y then fills xn, and the chunk loop runs as K1's.
//
// With kDrop the tile drops g at site 0 (columns 0..3F-1) and o at site
// 1 (columns 0..F-1) by the hash of hash_dropout.cuh at the global row
// b*T + t, and scales the kept values by 1 / (1 - p): the JAX package's
// gcfn_train.py::_fwd_train_kernel.
//
// With In = __nv_bfloat16 (K1's and K7's bfloat16 instances) x and out
// are bfloat16 and the tile takes the JAX kernels' rounding steps
// (gcfn.py:162-211, gcfn_train.py:557-559): x is upcast as it is read,
// the LayerNorm runs in float32 and its rows are rounded to bfloat16 as
// they land in xn, g is rounded (after K7's drop at site 0) as it lands
// in g, the weights are rounded as the products read
// them, and each product is one TF32 mma.sync on those exact values
// (mma_tf32x3.cuh) in place of three; u, the conv, the GLU and the
// residual stay float32, and out is stored rounded.  The weights stay
// float32 in memory and in the stages, so the shared-memory plan (and
// the blocks per SM) is the float32 instance's; x's and out's bytes
// halve.  K16's bfloat16 instance (kPair) takes the same steps after the
// JAX kernel's tail (ega_gcfn.py:57-90): x and x_down bfloat16, LN_g(x)
// rounded as it lands in xn, wg rounded as the gate product reads it, the
// gate and y = x + gate * up float32; y's tile rows go to a float32
// scratch (Pair::yres), since the bfloat16 out would round them, and the
// epilogue reads its residual there.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hash_dropout.cuh"
#include "mma_tf32x3.cuh"

namespace gcfn_mma {

constexpr int kThreads = 256;
constexpr int kTT = 62;  // output rows per tile
constexpr int kCH = 32;  // GLU pairs per hidden chunk

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int F>
struct Shape {
  static constexpr int TT = kTT, CH = kCH;
  static constexpr int H6 = 6 * F, H3 = 3 * F, R = TT + 2, NC = 2 * CH;
  static constexpr int chunks = H3 / CH;
  // the eight warps as 2 x 4 blocks of the u chunk [R, NC] and of o [R, F]
  static constexpr int WN = 4, WM = kThreads / 32 / WN;
  static constexpr int UMT = R / 16 / WM, UNT = NC / 8 / WN;
  static constexpr int OMT = UMT, ONT = F / 8 / WN;
  // row strides: 8 mod 32 where a fragment takes 8 bytes of a row (the A
  // operands xn and g, the u stores), 4 mod 32 where it takes rows 2t and
  // 2t+1 of a column (the staged B operands): no bank conflicts
  static constexpr int LX = F + 8, LW = NC + 4, LO = F + 4, LU = NC + 8,
                       LG = CH + 8;
  static constexpr int xn = 0, wi = xn + R * LX, wo = wi + F * LW,
                       u = wo + CH * LO, g = u + R * LU,
                       floats = g + R * LG;
  static constexpr size_t smem_bytes = sizeof(float) * (size_t)floats;
  // Blocks per SM, of an SM's 228 KB with 1 KB reserved per block: two
  // at F = 128 (113 KB); one at F = 256, where xn alone is 64 x 264
  // floats and the tile takes 199 KB.  The kernels' __launch_bounds__
  // take it, so the F = 256 instance may hold o (64 floats a thread)
  // in up to 255 registers.
  static constexpr int blocks_per_sm = smem_bytes <= 113 * 1024 ? 2 : 1;
  static_assert(R == 16 * UMT * WM && smem_bytes <= 227 * 1024,
                "four m16 fragments of rows; at least one block per SM");
  // K16's prologue: wg's gate_parts parts of NC columns pass through wi
  // as win's chunks do; the EGA tail's output y [R][LY] lies over wo and
  // u where they hold it (the chunk loop fills them only after it), else
  // over wi, with y held in registers until the last part is read, which
  // needs one block per SM (tile() asserts that it fits, for K16's
  // instances alone)
  static constexpr int LY = F + 8, gate_parts = F / NC;
  static constexpr bool y_over_wo = wo + R * LY <= g;
  static constexpr int y = y_over_wo ? wo : wi;
  static constexpr bool pair_fits =
      F % NC == 0 &&
      (y_over_wo || (R * LY <= F * LW && blocks_per_sm == 1));
};

// The EGA tail's inputs (K16), x_down in the stream's type In.
template <class In = float>
struct Pair {
  const In* x_down;     // [B, L, F], the attention's output
  int L;                // the bottleneck length; T = L * (T / L)
  const float* gns;     // the gate's LayerNorm scale and bias [F]
  const float* gnb;
  const float* wg;      // the gate's Linear [F, F], [in, out]
  const float* bg;      // [F]
  float* yres;          // [B, T, F]: y's tile rows (bfloat16 In alone)
};

// LayerNorm of frames t0-1 .. t0+TT into xn [R][LX], a warp taking every
// (kThreads/32)th row, all its rows' loads in flight at once; rows outside
// [0, T) are zero.  row(r, t) points at the F values (float or bfloat16)
// of tile row r, frame t (in [0, T)), in global or shared memory.  With
// kRound the rows are rounded to bfloat16 as they are stored.
template <int F, bool kRound = false, class Row>
__device__ __forceinline__ void layer_norm_rows(
    float* xn, Row row, const float* __restrict__ lns,
    const float* __restrict__ lnb, int t0, int T, float eps) {
  constexpr int R = Shape<F>::R, LX = Shape<F>::LX;
  constexpr int kWarps = kThreads / 32, RW = R / kWarps, Q = F / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[RW][Q];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + i * kWarps, t = t0 - 1 + r;
    const bool in = t >= 0 && t < T;
    const auto* src = row(r, in ? t : 0) + lane;
#pragma unroll
    for (int q = 0; q < Q; ++q) v[i][q] = in ? bf16s::to_f(src[32 * q]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + i * kWarps, t = t0 - 1 + r;
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
    const bool in = t >= 0 && t < T;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      if (kRound)
        xn[r * LX + k] =
            in ? bf16s::rounded(v[i][q] * inv * lns[k] + lnb[k]) : 0.f;
      else
        xn[r * LX + k] = in ? v[i][q] * inv * lns[k] + lnb[k] : 0.f;
    }
  }
}

// Hidden column of a chunk's local column j: the first CH are GLU values
// c*CH + j, the next CH their gates 3F + c*CH + j - CH.
template <int CH, int H3>
__device__ __forceinline__ int hidden_col(int c, int j) {
  return c * CH + j + (j < CH ? 0 : H3 - CH);
}

template <int F, bool kDrop, bool kPair = false, class In = float>
__device__ __forceinline__ void tile(
    float* smem, const In* __restrict__ x, const int* __restrict__ lens,
    const float* __restrict__ lns, const float* __restrict__ lnb,
    const float* __restrict__ win, const float* __restrict__ bin,
    const float* __restrict__ wdw, const float* __restrict__ bdw,
    const float* __restrict__ wout, const float* __restrict__ bout,
    const float* __restrict__ ls, In* __restrict__ out, int T, float eps,
    GcfnDrop drop, Pair<In> pair = Pair<In>{}) {
  static_assert(!(kDrop && kPair), "K16 runs at dropout 0");
  constexpr bool kBf16 = !std::is_same<In, float>::value;
  using S = Shape<F>;
  static_assert(!kPair || S::pair_fits,
                "K16: y overlays wo and u, or wi at one block per SM");
  using tf32x3::frag_col;
  using tf32x3::frag_row;
  constexpr int TT = S::TT, CH = S::CH, H6 = S::H6, H3 = S::H3, R = S::R,
                NC = S::NC, LX = S::LX, LW = S::LW, LO = S::LO, LU = S::LU,
                LG = S::LG;
  constexpr int UMT = S::UMT, UNT = S::UNT, OMT = S::OMT, ONT = S::ONT;
  float* xn = smem + S::xn;  // [R][LX] LN rows t0-1 .. t0+TT
  float* wi = smem + S::wi;  // [F][LW] win[:, chunk]
  float* wo = smem + S::wo;  // [CH][LO] wout[chunk rows, :]
  float* u = smem + S::u;    // [R][LU] the chunk's u rows (masked)
  float* g = smem + S::g;    // [R][LG] the chunk's g, tile rows (rows
                             // TT.. zero)

  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = warp / S::WN, wn = warp - wm * S::WN;
  const int valid = lens ? min(lens[b], T) : T;
  const uint32_t row0 = (uint32_t)b * (uint32_t)T + (uint32_t)t0;

  // chunk c's win columns, then its wout rows, each one cp.async group of
  // 16-byte copies (fixed counts per thread)
  auto stage_in = [&](int c) {
#pragma unroll
    for (int q = 0; q < F * NC / 4 / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int k = e / (NC / 4), j = 4 * (e - k * (NC / 4));
      tf32x3::cp_async16(wi + k * LW + j,
                         win + (size_t)k * H6 + hidden_col<CH, H3>(c, j),
                         true);
    }
    tf32x3::cp_async_commit();
  };
  auto stage_out = [&](int c) {
#pragma unroll
    for (int q = 0; q < CH * F / 4 / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int k = e / (F / 4), j = 4 * (e - k * (F / 4));
      tf32x3::cp_async16(wo + k * LO + j,
                         wout + (size_t)(c * CH + k) * F + j, true);
    }
    tf32x3::cp_async_commit();
  };
  if (!kPair) stage_in(0);  // K16's prologue stages wg first

  for (int e = tid; e < (R - TT) * LG; e += kThreads) g[TT * LG + e] = 0.f;
  auto x_row = [&](int, int t) { return x + ((size_t)b * T + t) * F; };
  if constexpr (kPair) {
    // K16's prologue, the EGA tail over the R rows:
    //   y = x + sigmoid(LN_g(x) wg + bg) * x_down[t / r],  r = T / L,
    // zero outside [0, T).  y lands in shared memory (Shape's y), and its
    // tile rows also in out, where the epilogue reads its residual (only
    // this block writes those rows, and the barriers between make them
    // visible to it).  wg's parts of NC columns pass through wi as win's
    // chunks do, and the gate product is the u product's call.  Where y
    // overlays wi (kHold), each part's y waits in registers until every
    // warp has read the last part.
    constexpr int P = S::gate_parts;
    constexpr bool kHold = !S::y_over_wo;
    float* y = smem + S::y;
    float held[kHold ? P : 1][UMT][UNT][4];
    auto stage_gate = [&](int h) {
#pragma unroll
      for (int q = 0; q < F * NC / 4 / kThreads; ++q) {
        const int e = tid + q * kThreads;
        const int k = e / (NC / 4), j = 4 * (e - k * (NC / 4));
        tf32x3::cp_async16(wi + k * LW + j,
                           pair.wg + (size_t)k * F + h * NC + j, true);
      }
      tf32x3::cp_async_commit();
    };
    stage_gate(0);
    layer_norm_rows<F, kBf16>(xn, x_row, pair.gns, pair.gnb, t0, T, eps);
    const int ratio = T / pair.L;
    const In* xd = pair.x_down + (size_t)b * pair.L * F;
    // where y's tile rows wait for the epilogue: out, or (bfloat16) the
    // float32 scratch
    float* yres;
    if constexpr (kBf16)
      yres = pair.yres;
    else
      yres = out;
    // unrolled where held[h] must be a register
#pragma unroll (kHold ? P : 1)
    for (int h = 0; h < P; ++h) {
      tf32x3::cp_async_wait<0>();
      __syncthreads();  // wg's part h (and LN_g(x)) are in place
      float a[UMT][UNT][4] = {};
      auto wg_frag = [&](int ks, int nt) {
        const float* w =
            wi + (8 * ks + 2 * t4) * LW + 8 * (UNT * wn + nt) + g8;
        return make_float2(w[0], w[LW]);
      };
      if constexpr (kBf16)
        bf16s::warp_product<UMT, UNT, F / 8>(a, xn + 16 * UMT * wm * LX, LX,
                                             wg_frag);
      else
        tf32x3::warp_product<UMT, UNT, F / 8>(a, xn + 16 * UMT * wm * LX,
                                              LX, wg_frag);
      __syncthreads();  // every warp has read wi
      if (h + 1 < P)
        stage_gate(h + 1);
      else if (!kHold)
        stage_in(0);  // lands during the epilogue and LN(y)
#pragma unroll
      for (int mt = 0; mt < UMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < UNT; ++nt)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = 16 * (UMT * wm + mt) + g8 + 8 * hr, t = t0 - 1 + r;
            const int col = h * NC + 8 * (UNT * wn + nt) + 2 * t4;
            float yv[2] = {0.f, 0.f};
            if (t >= 0 && t < T) {
              const size_t off = ((size_t)b * T + t) * F + col;
              const float2 xv = bf16s::load2(x + off);
              const float2 dv =
                  bf16s::load2(xd + (size_t)(t / ratio) * F + col);
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const float z = a[mt][nt][2 * hr + q] + pair.bg[col + q];
                const float gate = __fdividef(1.f, 1.f + expf(-z));
                yv[q] = (q ? xv.y : xv.x) + gate * (q ? dv.y : dv.x);
              }
              if (r >= 1 && r <= TT)  // a tile row: the residual
                *reinterpret_cast<float2*>(yres + off) =
                    make_float2(yv[0], yv[1]);
            }
            if (kHold) {
              held[kHold ? h : 0][mt][nt][2 * hr] = yv[0];
              held[kHold ? h : 0][mt][nt][2 * hr + 1] = yv[1];
            } else {
              *reinterpret_cast<float2*>(y + r * S::LY + col) =
                  make_float2(yv[0], yv[1]);
            }
          }
    }
    if (kHold) {  // every warp has read wi's last part: y goes over it
#pragma unroll
      for (int h = 0; h < P; ++h)
#pragma unroll
        for (int mt = 0; mt < UMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < UNT; ++nt)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = 16 * (UMT * wm + mt) + g8 + 8 * hr;
              const int col = h * NC + 8 * (UNT * wn + nt) + 2 * t4;
              *reinterpret_cast<float2*>(y + r * S::LY + col) = make_float2(
                  held[kHold ? h : 0][mt][nt][2 * hr],
                  held[kHold ? h : 0][mt][nt][2 * hr + 1]);
            }
    }
    __syncthreads();  // y is whole and LN_g(x) read
    layer_norm_rows<F, kBf16>(
        xn, [&](int r, int) { return (const float*)(y + r * S::LY); }, lns,
        lnb, t0, T, eps);
    if (kHold) {
      __syncthreads();  // every warp has read y out of wi
      stage_in(0);
    }
  } else {
    layer_norm_rows<F, kBf16>(xn, x_row, lns, lnb, t0, T, eps);
  }

  float o[OMT][ONT][4] = {};
  // One buffer of each weight: win_c lands during chunk c-1's GLU and
  // second product, wout_c during chunk c's first product and GLU.
  for (int c = 0; c < S::chunks; ++c) {
    tf32x3::cp_async_wait<0>();
    // win_c (and xn) are in place, and chunk c-1 has read wout and g
    __syncthreads();
    stage_out(c);

    // a. u = xn win_c + bin; rows outside [0, valid) -> 0, and no product
    //    where that is every row of the tile.  This warp: rows
    //    16 UMT wm .., local columns 8 UNT wn ..
    {
      float a[UMT][UNT][4] = {};
      auto win_frag = [&](int ks, int nt) {
        const float* w =
            wi + (8 * ks + 2 * t4) * LW + 8 * (UNT * wn + nt) + g8;
        return make_float2(w[0], w[LW]);
      };
      if (t0 - 1 < valid) {
        if constexpr (kBf16)
          bf16s::warp_product<UMT, UNT, F / 8>(
              a, xn + 16 * UMT * wm * LX, LX, win_frag);
        else
          tf32x3::warp_product<UMT, UNT, F / 8>(
              a, xn + 16 * UMT * wm * LX, LX, win_frag);
      }
#pragma unroll
      for (int mt = 0; mt < UMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < UNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * (UMT * wm + mt) + frag_row(e);
            const int j = 8 * (UNT * wn + nt) + frag_col(e);
            const int t = t0 - 1 + r;
            u[r * LU + j] = (t >= 0 && t < valid)
                                ? a[mt][nt][e] + bin[hidden_col<CH, H3>(c, j)]
                                : 0.f;
          }
    }
    __syncthreads();  // u is written and win_c read
    if (c + 1 < S::chunks) stage_in(c + 1);

    // b. depthwise k3 over time, then GLU: g = y[:H3] * sigmoid(y[H3:]),
    //    dropped at site 0 in training (the global GLU column).  A thread
    //    keeps one column and its weights and takes a fixed count of rows
    //    (the last pass's rows past TT read row TT-1 and store nothing):
    //    with no branch in the loop its rows overlap.  The sigmoid's
    //    division is __fdividef (2 ulp): the IEEE division's slow-path call
    //    kept the rows apart.
    {
      constexpr int RS = kThreads / CH;  // rows per pass
      const int cl = tid % CH, ca = c * CH + cl, cb = H3 + ca;  // value, gate
      const float wa0 = wdw[3 * ca], wa1 = wdw[3 * ca + 1],
                  wa2 = wdw[3 * ca + 2], ba = bdw[ca];  // wdw [H6][3]
      const float wb0 = wdw[3 * cb], wb1 = wdw[3 * cb + 1],
                  wb2 = wdw[3 * cb + 2], bb = bdw[cb];
#pragma unroll
      for (int q = 0; q < (TT + RS - 1) / RS; ++q) {
        const int i = tid / CH + q * RS;
        // frame t-1 (tile row i: u row i+1)
        const float* u0 = u + min(i, TT - 1) * LU;
        const float ya = u0[cl] * wa0 + u0[LU + cl] * wa1 +
                         u0[2 * LU + cl] * wa2 + ba;
        const float yb = u0[CH + cl] * wb0 + u0[LU + CH + cl] * wb1 +
                         u0[2 * LU + CH + cl] * wb2 + bb;
        float gv = __fdividef(ya, 1.f + expf(-yb));
        if (kDrop)
          gv = sep_keep(drop.seed0, row0 + i, (uint32_t)ca, drop.threshold)
                   ? gv * drop.scale
                   : 0.f;
        if (i < TT) g[i * LG + cl] = kBf16 ? bf16s::rounded(gv) : gv;
      }
    }
    if (c + 1 < S::chunks)
      tf32x3::cp_async_wait<1>();  // wout_c; win_{c+1} may be in flight
    else
      tf32x3::cp_async_wait<0>();
    __syncthreads();

    // c. o += g_c wout_c.  This warp: rows 16 OMT wm .., columns 8 ONT wn ..
    auto wout_frag = [&](int ks, int nt) {
      const float* w = wo + (8 * ks + 2 * t4) * LO + 8 * (ONT * wn + nt) + g8;
      return make_float2(w[0], w[LO]);
    };
    if constexpr (kBf16)
      bf16s::warp_product<OMT, ONT, CH / 8>(o, g + 16 * OMT * wm * LG, LG,
                                            wout_frag);
    else
      tf32x3::warp_product<OMT, ONT, CH / 8>(o, g + 16 * OMT * wm * LG, LG,
                                             wout_frag);
  }

  // out = x + ls * (o + bout), o dropped at site 1 in training; tile rows
  // past TT and rows t >= T are not written.
#pragma unroll
  for (int mt = 0; mt < OMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * (OMT * wm + mt) + g8 + 8 * h, t = t0 + i;
      if (i >= TT || t >= T) continue;
      const size_t off = ((size_t)b * T + t) * F;
#pragma unroll
      for (int nt = 0; nt < ONT; ++nt) {
        const int col = 8 * (ONT * wn + nt) + 2 * t4;
        // the residual: x, or K16's y, which its prologue wrote to out
        // (bfloat16: to the float32 scratch)
        float2 xv;
        if constexpr (kPair && kBf16)
          xv = bf16s::load2(pair.yres + off + col);
        else
          xv = bf16s::load2((kPair ? out : x) + off + col);
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float ov = o[mt][nt][2 * h + q] + bout[col + q];
          if (kDrop)
            ov = sep_keep(drop.seed1, row0 + i, (uint32_t)(col + q),
                          drop.threshold)
                     ? ov * drop.scale
                     : 0.f;
          v[q] = (q ? xv.y : xv.x) + ls[col + q] * ov;
        }
        bf16s::store2(out + off + col, v[0], v[1]);
      }
    }
}

}  // namespace gcfn_mma
