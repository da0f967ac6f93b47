// The masked softmax·V tile of K3 and K3b (csrc/softmax_pv.cu) and of K9
// and K9b (csrc/softmax_pv_train.cu).  For each (b, h, query row i), with
// lim = min(length, lens[b], Lp) valid keys and s = scores (+ bias):
//   m = max_{j<lim} s[j],  e[j] = exp(s[j] - m),  l = sum_{j<lim} e[j],
//   out[b, i, h*D:(h+1)*D] = sum_{j<lim} e[j] * w[j] * v[b, j, h*D:] / l,
// where w[j] = 1 in eval (K3) and, in training (K9), w[j] = keep[j] / (1-p)
// with the hash mask of hash_dropout.cuh at row (b*H + h)*Lp + i, column
// j; l is taken before the drop.  K9 also writes m and l per row, which
// its backward (K10) reads.  Keys j >= lim have weight 0 (the -1e30 keys
// of the reference); no tile at or past lim is read.
//
// What bounds it on the H100: each valid score (and bias) is read once,
// so the bytes of the scores tensor set the least time at the H100 SXM's
// 3.35 TB/s (53 MB, 0.0170 ms at K3's [8, 8, 512, 512] with ragged lens;
// 33 MB, 0.0104 ms at K9's [4, 8, 512, 512]).  PERF.md §6 says why the
// design below keeps V's reads and the row statistics off the per-row
// path.
//
// Design, after K12's P·V (csrc/flash_relpos.cu): a block of 8 warps per
// (rows, h, b) walks the key tiles of 64 keys below lim in warp tiles of
// 16 query rows.  A lane holds the scores of rows g and g+8 at the keys
// key_of(nt, e, t), the four neighbours 4t .. 4t+3 of each 16-key group:
// one 16-byte load per row and group, straight into registers, the next
// tile's issued before this tile's math, so a warp keeps a tile (4 KB,
// 8 KB with the bias) in flight while it computes.  The tile that crosses
// lim alone takes the key mask; tiles at or past lim are not visited.
// The online softmax keeps each row's max and sum with the quad of lanes
// that holds the row (two quad shuffles per row and tile, the sums' quad
// reduction once at the end) and takes exp as 2^x on the SFU.  P·V runs
// on the tensor cores at float32 accuracy (3xTF32, mma_tf32x3.cuh): P's
// C fragment is reused as the A fragment (a lane's two keys of k-step nt
// in slots t and t+4); V's key tiles are staged once per block in shared
// memory by cp.async, double-buffered, rows at stride D + 4 with the
// columns of rows whose bit 3 is set stored XOR 8, so the B fragments'
// scalar reads fall in 32 distinct banks; each tile's product starts from
// zeroed fragments and is added to the running output in float32
// registers.  K9's hash is taken in its row and column halves
// (hash_dropout.cuh), and the kept weights' 1 / (1 - p) with 1 / l at the
// end.
//
// The head width D is a template parameter: Base's 16 (K3, K3b, K9,
// K9b) and Large's 32 (K3).  At D = 32 a lane holds four n-fragments of
// the output and P·V runs one chain of fresh accumulators a tile (four
// independent fragments, as D = 16's two chains of two), V's rows are
// staged at stride 36 with the same XOR 8 (the B fragments' reads still
// fall in 32 distinct banks: rows 4t + c sit 16 t banks apart), and a
// thread stages 16 bytes of every 32nd row instead of every 64th.
//
// SPLIT warps per row tile: with 1, a block holds 8 row tiles (128 rows),
// each walked by one warp; with 2, 4 row tiles (64 rows), each walked by
// two warps taking alternate key tiles, whose states merge at the end
// (the larger max, each side scaled by exp(m_side - m)).  The launchers
// take 2 where blocks of 128 rows would give no SM a second block and
// blocks of 64 fit the card in one wave (split_for): K9's grid then
// fills the card.  Every sum has a fixed
// order and there are no atomics: two runs give the same bits.  Query
// rows past Lp load row Lp - 1 and are not written.
//
// The element types SC (the scores) and VT (V and the output) are float
// or __nv_bfloat16 (K3's bfloat16 instances; the JAX kernel's rounding
// steps, softmax_pv.py:94-103): the scores are read in their dtype and
// upcast (8-byte loads of a lane's four keys for bfloat16), the mask, the
// max, p = exp(s - m) and the sum l stay float32, and with a bfloat16 V,
// p is rounded to bfloat16 after its sum and before ·V, which is one
// TF32 mma.sync on those exact values (mma_tf32x3.cuh) in place of
// three; V's tiles are staged as bfloat16 rows at stride D + 8 (no XOR),
// and the output, divided by l in float32, is stored rounded.  With a
// float32 V the P·V stays 3xTF32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hash_dropout.cuh"
#include "mma_tf32x3.cuh"

namespace softmax_pv_tile {

constexpr int kBaseD = 16;             // Base's head width (128 / 8 heads):
                                       // K3's, K3b's, K9's and K9b's D
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;              // keys per tile
// blocks an SM holds: two (16 warps at up to 128 registers a thread); the
// bias forms hold twice the scores in registers, up to 255, so one
constexpr int kMinBlocks = 2, kMinBlocksBias = 1;

// A block's shape for SPLIT warps per row tile of 16 rows (the row tile's
// key tiles n with n % SPLIT == the warp's), at head width D.
template <int SPLIT, int D>
struct Shape {
  static_assert(D == 16 || D == 32, "head widths 16 and 32");
  static constexpr int kNN = D / 8;                   // output n-fragments
  static constexpr int kChains = D == 16 ? 2 : 1;     // P·V chains a tile
  static constexpr int kVS = D + 4;     // staged V row stride in floats
  static constexpr int kRowTiles = kWarps / SPLIT;
  static constexpr int kRows = 16 * kRowTiles;        // query rows a block
  static constexpr int kStepKeys = kKeys * SPLIT;     // keys staged a step
  static constexpr int kStage = kStepKeys * kVS;      // floats a V stage
  static constexpr int kPerRow = D / 4;               // 16-byte pieces a row
  static constexpr int kRowShift = D == 16 ? 2 : 3;   // log2(kPerRow)
  static constexpr int kPieces = kStepKeys * D / 4 / kThreads;  // copies
  static_assert(kPieces * kThreads * 4 == kStepKeys * D,
                "the threads stage a V stage in 16-byte pieces");
  // a split warp's state per lane: two maxes, two sums, its output
  static constexpr int kXch = 4 + 4 * kNN;
  static_assert((SPLIT - 1) * kRowTiles * 32 * kXch <= 2 * kStage,
                "the split warps' states fit over the V stages");
};

struct Args {
  const float* scores;  // [B, H, Lp, Lp]
  const float* bias;    // the same, or null
  const float* v;       // [B, Lp, F], F = H * D
  const int* lens;      // [B], each >= 1
  float* out;           // [B, Lp, F]
  float* row_max;       // [B, H, Lp] (training) or null
  float* row_sum;       // [B, H, Lp] (training) or null
  int H, Lp, F, length;
  uint32_t seed_word, threshold;  // threshold 0: no dropout
  float keep_scale;               // 1 / (1 - p)
};

// 2^x on the SFU (relative error about 2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The key of x[nt][e] in a tile, for lane t: 16-key group nt / 2, the
// lane's four keys 4t .. 4t+3 of it, the pair nt % 2 of those, e % 2 in
// the pair (e / 2 is the row: g, then g + 8).
__device__ __forceinline__ int key_of(int nt, int e, int t) {
  return 16 * (nt >> 1) + 4 * t + 2 * (nt & 1) + (e & 1);
}

// A lane's scores of tile j0 in rows lo and hi, x[nt][e] at key
// j0 + key_of(nt, e, t); 0 at keys >= lim.  vec: the rows are 16-byte
// aligned (Lp % 4 == 0), so a lane's four keys are one load, taken when
// the first is below lim; its others may lie at or past lim (the caller
// masks them) but end below Lp.  Otherwise no key at or past lim is read.
// Four consecutive values as floats: one 16-byte load of floats, one
// 8-byte load of bfloat16 values.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// load_tile of bfloat16 scores: the same keys, upcast.
__device__ __forceinline__ void load_tile(float (&x)[8][4],
                                          const __nv_bfloat16* lo,
                                          const __nv_bfloat16* hi, int j0,
                                          int lim, bool vec) {
  const int t = threadIdx.x & 3;
  using bf16s::to_f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + 16 * q + 4 * t;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (vec) {
      if (j < lim) {
        a = load4(lo + j);
        b = load4(hi + j);
      }
    } else {
      a.x = j < lim ? to_f(lo[j]) : 0.f;
      a.y = j + 1 < lim ? to_f(lo[j + 1]) : 0.f;
      a.z = j + 2 < lim ? to_f(lo[j + 2]) : 0.f;
      a.w = j + 3 < lim ? to_f(lo[j + 3]) : 0.f;
      b.x = j < lim ? to_f(hi[j]) : 0.f;
      b.y = j + 1 < lim ? to_f(hi[j + 1]) : 0.f;
      b.z = j + 2 < lim ? to_f(hi[j + 2]) : 0.f;
      b.w = j + 3 < lim ? to_f(hi[j + 3]) : 0.f;
    }
    x[2 * q][0] = a.x;
    x[2 * q][1] = a.y;
    x[2 * q][2] = b.x;
    x[2 * q][3] = b.y;
    x[2 * q + 1][0] = a.z;
    x[2 * q + 1][1] = a.w;
    x[2 * q + 1][2] = b.z;
    x[2 * q + 1][3] = b.w;
  }
}

__device__ __forceinline__ void load_tile(float (&x)[8][4], const float* lo,
                                          const float* hi, int j0, int lim,
                                          bool vec) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + 16 * q + 4 * t;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (vec) {
      if (j < lim) {
        a = *reinterpret_cast<const float4*>(lo + j);
        b = *reinterpret_cast<const float4*>(hi + j);
      }
    } else {
      a.x = j < lim ? lo[j] : 0.f;
      a.y = j + 1 < lim ? lo[j + 1] : 0.f;
      a.z = j + 2 < lim ? lo[j + 2] : 0.f;
      a.w = j + 3 < lim ? lo[j + 3] : 0.f;
      b.x = j < lim ? hi[j] : 0.f;
      b.y = j + 1 < lim ? hi[j + 1] : 0.f;
      b.z = j + 2 < lim ? hi[j + 2] : 0.f;
      b.w = j + 3 < lim ? hi[j + 3] : 0.f;
    }
    x[2 * q][0] = a.x;
    x[2 * q][1] = a.y;
    x[2 * q][2] = b.x;
    x[2 * q][3] = b.y;
    x[2 * q + 1][0] = a.z;
    x[2 * q + 1][1] = a.w;
    x[2 * q + 1][2] = b.z;
    x[2 * q + 1][3] = b.w;
  }
}

template <int D, int SPLIT, bool HAS_BIAS, bool TRAIN, class SC = float,
          class VT = float>
__device__ __forceinline__ void run(const Args& a) {
  using S = Shape<SPLIT, D>;
  constexpr int kRowTiles = S::kRowTiles, kStepKeys = S::kStepKeys;
  constexpr int kVS = S::kVS, kNN = S::kNN, kChains = S::kChains;
  constexpr bool kBf16V = std::is_same<VT, __nv_bfloat16>::value;
  static_assert(!(HAS_BIAS || TRAIN) ||
                    (std::is_same<SC, float>::value && !kBf16V),
                "bfloat16: K3's one-tensor eval form alone");
  // a bfloat16 V stage: rows at stride D + 8 bfloat16 values (16-byte
  // aligned), within the float stage's room
  constexpr int kVSb = D + 8;
  static_assert(kStepKeys * kVSb * 2 <= S::kStage * 4, "bf16 V stage fits");
  __shared__ __align__(16) float vs[2][S::kStage];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rt = warp % kRowTiles, ks = warp / kRowTiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Lp = a.Lp, F = a.F;
  const int iw = blockIdx.x * S::kRows + 16 * rt;  // the warp's first row
  const int lim = min(min(a.length, a.lens[b]), Lp);
  const size_t bh = (size_t)b * a.H + h;
  const bool vec = (Lp & 3) == 0;

  // the lane's rows iw + g and iw + g + 8 (loads clamped to row Lp - 1)
  const size_t off_lo = (bh * Lp + min(iw + g, Lp - 1)) * Lp;
  const size_t off_hi = (bh * Lp + min(iw + g + 8, Lp - 1)) * Lp;
  const SC* s_lo = reinterpret_cast<const SC*>(a.scores) + off_lo;
  const SC* s_hi = reinterpret_cast<const SC*>(a.scores) + off_hi;
  const float* b_lo = HAS_BIAS ? a.bias + off_lo : nullptr;
  const float* b_hi = HAS_BIAS ? a.bias + off_hi : nullptr;
  const size_t v_off = (size_t)b * Lp * F + h * D;
  const float* vb = a.v + v_off;

  // V rows j0 .. j0 + kStepKeys - 1 of the head into stage buf (zero at or
  // past lim): thread tid copies 16 bytes (columns c4 .. c4+3) of rows
  // tid/(D/4) + kThreads/(D/4) * it, as one cp.async group.  Row r's
  // columns are stored XOR 8 when bit 3 of r is set, so the B fragments'
  // reads (rows 4t + const, column g + 8nn) fall in 32 distinct banks.
  const int r0 = tid >> S::kRowShift, c4 = (tid & (S::kPerRow - 1)) * 4;
  auto stage = [&](int buf, int j0) {
    if constexpr (kBf16V) {
      // 16-byte pieces of eight bfloat16 values, D / 8 a row
      constexpr int kPer = D / 8, kTotal = kStepKeys * kPer;
      const __nv_bfloat16* vh =
          reinterpret_cast<const __nv_bfloat16*>(a.v) + v_off;
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(vs[buf]);
      for (int e = tid; e < kTotal; e += kThreads) {
        const int r = e / kPer, c8 = (e % kPer) * 8, j = j0 + r;
        const bool ok = j < lim;
        tf32x3::cp_async16(
            reinterpret_cast<float*>(dst + r * kVSb + c8),
            reinterpret_cast<const float*>(vh + (size_t)(ok ? j : 0) * F +
                                           c8),
            ok);
      }
    } else {
#pragma unroll
      for (int it = 0; it < S::kPieces; ++it) {
        const int r = r0 + kThreads / S::kPerRow * it, j = j0 + r;
        const bool ok = j < lim;
        tf32x3::cp_async16(&vs[buf][r * kVS + (c4 ^ (r & 8))],
                           vb + (size_t)(ok ? j : 0) * F + c4, ok);
      }
    }
    tf32x3::cp_async_commit();
  };

  // the hash's row halves, of rows (b*H + h)*Lp + i for i = iw+g, iw+g+8
  const uint32_t row_half[2] = {
      sep_row_half(a.seed_word, (uint32_t)(bh * Lp + iw + g)),
      sep_row_half(a.seed_word, (uint32_t)(bh * Lp + iw + g + 8))};
  const uint32_t threshold8 = a.threshold << 8;
  constexpr float kLog2e = 1.4426950408889634f;
  float o[kNN][4] = {};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // the tile's softmax and P·V, on its scores in cur, V's rows in vt
  // (floats, or bfloat16 values at stride kVSb)
  auto tile = [&](float (&cur)[8][4], const auto* vt, int j0) {
    // the key mask on the tile that crosses lim; the rows' running max
    if (j0 + kKeys > lim) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + key_of(nt, e, t) >= lim) cur[nt][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], cur[nt][e]);
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = ex2((m_run[r] - m_new) * kLog2e);  // 0 at the first tile
      m_run[r] = m_new;
      mb[r] = m_new * kLog2e;
    }
    // e = exp(s - m) = 2^(s log2(e) - m log2(e)); the sum before the drop,
    // the dropped weights into cur as P
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(cur[nt][e], kLog2e, -mb[e >> 1]));
        sum[e >> 1] += p;
        cur[nt][e] = p;
      }
    if (TRAIN && a.threshold) {  // the drop; 1 / (1 - p) comes at the end
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint32_t col = sep_col_half((uint32_t)(j0 + key_of(nt, c, t)));
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (!sep_keep_halves(row_half[r], col, threshold8))
              cur[nt][2 * r + c] = 0.f;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];

    // P V: k-step nt takes the keys key_of(nt, 0, t) (slot t) and
    // key_of(nt, 1, t) (slot t+4); a lane reads V's column g + 8nn of
    // those rows, stored at g + 8 (nn ^ t/2).  kChains chains of fresh
    // accumulators (k-steps nt mod kChains), summed and added to O in
    // float32.
    float pv[kChains][kNN][4] = {};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p4[4] = {cur[nt][0], cur[nt][2], cur[nt][1], cur[nt][3]};
      if constexpr (kBf16V) {
        // P rounded to V's dtype (after its sum), one exact TF32 product
        uint32_t pb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pb[i] = __float_as_uint(bf16s::rounded(p4[i]));
        const __nv_bfloat16* vp = vt + key_of(nt, 0, t) * kVSb + g;
#pragma unroll
        for (int nn = 0; nn < kNN; ++nn) {
          const uint32_t vb2[2] = {
              __float_as_uint(__bfloat162float(vp[8 * nn])),
              __float_as_uint(__bfloat162float(vp[kVSb + 8 * nn]))};
          tf32x3::mma(pv[nt % kChains][nn], pb, vb2);
        }
      } else {
        uint32_t pb[4], ps[4];
        tf32x3::split(p4, pb, ps);
        const float* vp = vt + key_of(nt, 0, t) * kVS + g;
#pragma unroll
        for (int nn = 0; nn < kNN; ++nn) {
          const int c = 8 * (nn ^ (t >> 1));
          tf32x3::mma3(pv[nt % kChains][nn], pb, ps, vp[c], vp[kVS + c]);
        }
      }
    }
#pragma unroll
    for (int nn = 0; nn < kNN; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = pv[0][nn][e];
#pragma unroll
        for (int ch = 1; ch < kChains; ++ch) sum += pv[ch][nn][e];
        o[nn][e] = o[nn][e] * alpha[e >> 1] + sum;
      }
  };

  // step k of the walk: the block's key tiles 2k and 2k + 1, the warp's
  // n = SPLIT k + ks with its scores in cur (and cb); the warp's next
  // tile's go into nxt (and nb) before this one's math
  const int tiles = (lim + kKeys - 1) / kKeys;
  const int steps = (tiles + SPLIT - 1) / SPLIT;
  // warp ks's keys of V's stage buf
  auto v_tile = [&](int buf) {
    if constexpr (kBf16V)
      return reinterpret_cast<const __nv_bfloat16*>(vs[buf]) +
             ks * kKeys * kVSb;
    else
      return (const float*)vs[buf] + ks * kKeys * kVS;
  };
  auto step = [&](float (&cur)[8][4], float (&cb)[8][4], float (&nxt)[8][4],
                  float (&nb)[8][4], int k) {
    const int n = SPLIT * k + ks;
    if (k + 1 < steps) {
      stage((k + 1) & 1, (k + 1) * kStepKeys);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();  // V's stage k is in place for every warp
    if (n < tiles) {
      if constexpr (HAS_BIAS) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) cur[nt][e] += cb[nt][e];
      }
      if (n + SPLIT < tiles) {
        load_tile(nxt, s_lo, s_hi, (n + SPLIT) * kKeys, lim, vec);
        if constexpr (HAS_BIAS)
          load_tile(nb, b_lo, b_hi, (n + SPLIT) * kKeys, lim, vec);
      }
      tile(cur, v_tile(k & 1), n * kKeys);
    }
    __syncthreads();  // every warp is done with V's stage k
  };

  float sa[8][4], sb[8][4];
  float ba[8][4], bb[8][4];  // the bias's (dead without one)
  stage(0, 0);
  if (ks < tiles) {
    load_tile(sa, s_lo, s_hi, ks * kKeys, lim, vec);
    if constexpr (HAS_BIAS) load_tile(ba, b_lo, b_hi, ks * kKeys, lim, vec);
  }
  for (int k = 0; k < steps; k += 2) {
    step(sa, ba, sb, bb, k);
    if (k + 1 < steps) step(sb, bb, sa, ba, k + 1);
  }

  // the split warps' states meet over the V stages: warps ks > 0 leave
  // their max, sums and output fragments, warp 0 of the row tile merges
  // them into its own in the order of ks (m the larger max, each side
  // scaled by exp(m_side - m)) and writes the rows
  float* xch = &vs[0][0] + (rt * 32 + lane) * S::kXch;
  constexpr int kXch = kRowTiles * 32 * S::kXch;  // floats per split warp
  if (ks > 0) {
    float* mine = xch + (ks - 1) * kXch;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mine[r] = m_run[r];
      mine[2 + r] = l_run[r];
    }
#pragma unroll
    for (int nn = 0; nn < kNN; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[4 + 4 * nn + e] = o[nn][e];
  }
  __syncthreads();
  if (ks != 0) return;
#pragma unroll
  for (int w = 0; w < SPLIT - 1; ++w) {
    const float* other = xch + w * kXch;
    float c0[2], c1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = other[r], m = fmaxf(m_run[r], m1);
      c0[r] = ex2((m_run[r] - m) * kLog2e);
      c1[r] = ex2((m1 - m) * kLog2e);  // 0 if that warp had no tile
      m_run[r] = m;
      l_run[r] = l_run[r] * c0[r] + other[2 + r] * c1[r];
    }
#pragma unroll
    for (int nn = 0; nn < kNN; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[nn][e] = o[nn][e] * c0[e >> 1] + other[4 + 4 * nn + e] * c1[e >> 1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = iw + g + 8 * r;
    const float l = quad_sum(l_run[r]);
    const float inv = (TRAIN && a.threshold ? a.keep_scale : 1.f) / l;
    if (i < Lp) {
      VT* dst = reinterpret_cast<VT*>(a.out) + ((size_t)b * Lp + i) * F +
                h * D + 2 * t;
#pragma unroll
      for (int nn = 0; nn < kNN; ++nn)
        bf16s::store2(dst + 8 * nn, o[nn][2 * r] * inv,
                      o[nn][2 * r + 1] * inv);
      if (TRAIN && t == 0) {
        a.row_max[bh * Lp + i] = m_run[r];
        a.row_sum[bh * Lp + i] = l;
      }
    }
  }
}

// A tile kernel's blocks per SM, registers, local (spill) bytes and warps
// per block, into o[0 .. 3].
template <class Kernel>
inline cudaError_t occupancy(Kernel kernel, int* o) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (err != cudaSuccess) return err;
  o[1] = attr.numRegs;
  o[2] = (int)attr.localSizeBytes;
  o[3] = kWarps;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(o, kernel, kThreads,
                                                       0);
}

// The split the launchers take: two warps per row tile (blocks of 64
// rows) where blocks of 128 rows would give no SM a second block and
// blocks of 64 fit in one wave at per_sm blocks per SM (K9's [4, 8, 512,
// 512] on 132 SMs), else one (K3's [8, 8, 512, 512], and K9b's, at one
// block per SM): the split halves each warp's walk and doubles the warps
// in flight, at the cost of a merge.  PERF.md §6 holds the timings of
// both splits at both shapes.
inline int split_for(int B, int H, int Lp, int per_sm) {
  static int sms = 0;  // the card's SMs, read at the first launch (a
                       // failed query shows in the launch's error)
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  // (a block's rows do not depend on the head width)
  using One = Shape<1, kBaseD>;
  using Two = Shape<2, kBaseD>;
  const long long bh = (long long)H * B;
  const long long one = (Lp + One::kRows - 1) / One::kRows * bh;
  const long long two = (Lp + Two::kRows - 1) / Two::kRows * bh;
  return one <= sms && two <= (long long)per_sm * sms ? 2 : 1;
}

// The C entries' checks: the instance's head width D, and a grid that
// fits.
template <int D>
inline int check(int B, int H, int Lp, int F, int length) {
  if (H <= 0 || F % H != 0 || length < 1 || length > Lp || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  if (F / H != D) return (int)cudaErrorInvalidValue;
  return 0;
}

// The C entries' launch: one or two (a kernel's SPLIT 1 and 2 instances
// at head width D) as split_for picks, on its grid of (row blocks, H, B),
// with the arguments of Args; row_max and row_sum null in eval.
template <int D, class Kernel>
inline int launch(Kernel one, Kernel two, const void* scores,
                  const void* bias, const void* v, const void* lens,
                  void* out, void* row_max, void* row_sum, int B, int H,
                  int Lp, int F, int length, uint32_t seed_word,
                  uint32_t threshold, float keep_scale, void* stream) {
  if (B <= 0 || Lp <= 0) return 0;
  if (int err = check<D>(B, H, Lp, F, length)) return err;
  const Args a{static_cast<const float*>(scores),
               static_cast<const float*>(bias), static_cast<const float*>(v),
               static_cast<const int*>(lens), static_cast<float*>(out),
               static_cast<float*>(row_max), static_cast<float*>(row_sum),
               H, Lp, F, length, seed_word, threshold, keep_scale};
  const int split =
      split_for(B, H, Lp, bias ? kMinBlocksBias : kMinBlocks);
  const int rows = split == 2 ? Shape<2, D>::kRows : Shape<1, D>::kRows;
  dim3 grid((Lp + rows - 1) / rows, H, B);
  const Kernel kernel = split == 2 ? two : one;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace softmax_pv_tile
