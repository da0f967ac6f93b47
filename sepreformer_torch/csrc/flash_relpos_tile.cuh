// The flash rel-pos attention tile of K12 (csrc/flash_relpos.cu, eval)
// and K13 (csrc/attention_train.cu, the train forward).  For each
// (b, h, query row i), with lim = min(L, lens[b]) valid keys,
//   s_j = (q_i·k_j + q_i·table[clip(i - j, -maxlen, maxlen - 1) + maxlen])
//         / sqrt(D),  j < lim;
//   m = max_j s_j,  e_j = exp(s_j - m),  l = sum_j e_j;
//   out_i = sum_j e_j w_j v_j / l   (float32 throughout),
// where w_j = 1 (K12) or, with the hash dropout (K13), keep(seed, row
// bh * block + i, col j) / (1 - p); l is taken before the drop.  K13 also
// writes m and l per row, which its backward (K14) reads as row_max ·
// log2(e) and 1 / row_sum.  Nothing of size [L, L] is ever stored.
//
// Layouts (template kHeadMajor): K12's q, k, v and out are channels-last
// [B, L, H*D] (a head's rows at stride H*D), K13's [B*H, L, D] (stride D);
// table is the raw [2*maxlen, D] embedding, lens [B].
//
// What bounds it on the H100: per head, 4*D operations per (i, valid j)
// pair for QKᵀ and P·V, 2*D per query row for each distinct clamped table
// row its keys reach, and one exponential per pair, against q, k, v and
// out read or written once: the products, taken on the tensor cores at
// float32 accuracy (3xTF32, mma_tf32x3.cuh: 165 TFLOP/s), and the
// exponentials on the SFUs set the least time (chip_smoke.py counts both
// from its inputs).
//
// Design: a block of 4 * SPLIT warps per (64 query rows, b*h).  Each of
// the 4 row tiles of 16 rows is walked by SPLIT warps, warp ks taking the
// key tiles n = SPLIT k + ks of 64 keys below lim; each warp keeps its
// rows' Q fragments (scaled by log2(e) / sqrt(D) and split once) in
// registers and an online softmax whose running max and sum live in
// registers (quad shuffles, no block barrier).  A step stages the SPLIT
// key tiles' K and V and the band of 64 + 64 SPLIT clamped table rows
// (rel = i - j from i0 - j0 - 64 SPLIT + 1 on) in shared memory with
// cp.async, double-buffered, so the next step's loads overlap this
// step's products (one buffer where two would not fit a block: D = 32
// at SPLIT 4).  Per (warp, tile):
//  - S = Q Kᵀ by 3xTF32 m16n8k8 products (16 x 64 in C fragments);
//  - the bias by the tile's class: where every pair has i - j >= maxlen - 1
//    (or every pair <= -maxlen) it is the per-row constant q_i·table[2m-1]
//    (or q_i·table[0]), taken once per row and applied as a shift of the
//    row's max; otherwise Q·bandᵀ over the warp's 79 band rows on the
//    tensor cores into the warp's shared buffer, and each (i, j) adds its
//    diagonal entry i - j + 63;
//  - 2^x on the SFU (the scale and log2(e) are in Q), and the key mask
//    only on the tile that crosses lim;
//  - with the dropout, the hash in its row and column halves
//    (hash_dropout.cuh) zeroes the dropped numerators after the sum;
//  - P·V with P kept in registers: the C fragment's columns 2t and 2t+1
//    serve as the A fragment's k slots t and t+4, and V's rows are read
//    in that order; each tile's P·V starts from zeroed fragments and is
//    added to the running output in float32 registers.
// The head width D is a template parameter: Base's 16 and Large's 32
// (K12 and K13 at both).  A lane holds D / 4 columns of each row of Q, K and
// the band, (D / 4) t .. (D / 4) t + D / 4 - 1, as D / 16 16-byte loads;
// k-step kk takes its columns 2 kk and 2 kk + 1.  K and the band are
// staged at stride 16 for D = 16 and 36 for D = 32 (a quarter-warp's
// 16-byte loads cover two rows: at stride 32 both would fall on the same
// banks); V at D + 4.  At D = 32 a block takes 92 KB of shared memory
// at SPLIT 1, so two blocks share an SM (Shape::kMinBlocks), 166 KB at
// SPLIT 2 and 197 KB (one stage) at SPLIT 4, one, and P·V runs one chain
// of fresh accumulators over its four output n-fragments.
//
// The T, S and M presets' head widths D = 8, 12 and 20 (K12's float32
// instances alone) are not whole m16n8k8 steps: QKᵀ and Q·bandᵀ run at
// k = Dp = 8 ceil(D / 8) (8, 16, 24) and P·V at Dp / 8 output
// n-fragments.  Their k-step kk puts column 8 kk + 2t in slot t and
// 8 kk + 2t + 1 in slot t + 4, so a lane's Q, K and band columns of a
// k-step are one 8-byte load (Q's columns past D zero in registers); K
// and the band are staged at stride 8 (D 8) or 24 (D 12, 20), where a
// half-warp's 8-byte loads of four rows fall in 32 distinct banks, V at
// Dp + 4 (12, 20, 28), where the scalar B reads do.  A row's D floats
// are D / 4 16-byte pieces (every head's slice starts 16-byte aligned),
// staged by a loop over the stage's pieces; the columns D .. Dp - 1 of
// every staged K, V and band row are zeroed once, before the walk (the
// products' k runs over them), and the output's columns past D are not
// stored.  q, k, v and the table are not padded in memory: that would
// copy them on every call.
//
// With SPLIT > 1 the row tile's warps meet at the end over the stage
// buffers: warp 0 merges the others' (max, sums, output) in the order of
// ks (the larger max, each side scaled by 2^(m_side - m)) and writes the
// rows; the launchers take SPLIT where the grid is short of the card's
// warp slots (K13's split_for).  K13's row max is stored in natural units
// (the running max, in log2 units, times ln 2).  Query rows past L are
// computed on zeros and never written; keys at or past lim are zero in
// shared memory and score -inf; each warp's first tile holds a valid key
// (warp 0's always), so the running max is finite after it.  Every sum has
// a fixed order and there are no atomics: two runs give the same bits.
//
// What holds it above its bound: on K12's long rows the instruction
// issue (per tile a warp splits 136 floats (K, V, P and, on band tiles,
// the band), three instructions each, beside its 96 (156 on band tiles)
// mma and the softmax's float32 work); on K13's short grids the latency
// of each warp's walk, which 16 warps per SM (at most 128 registers per
// thread) hide only in part.
//
// With T = __nv_bfloat16 (K12's bfloat16 instances) q, k, v, the table and
// out are bfloat16, with the JAX kernel's rounding steps
// (attention.py:90-137): Q stays unscaled (a bfloat16 value, exact in
// TF32) and QKᵀ and Q·bandᵀ are one TF32 mma.sync each on exact values
// (mma_tf32x3.cuh), so their sums are float32; the scale (log2(e) /
// sqrt(D)) multiplies the summed scores, the clamped rows' constants too;
// the mask and the online softmax stay float32; p is rounded to bfloat16
// after its sum and before ·V, one exact product; acc / l is stored
// rounded.  K, V and the band are staged as bfloat16 rows at stride
// D + 8 (16-byte aligned), within the float stages' room, so the shared
// memory and blocks per SM are the float32 instance's.
//
// K13's bfloat16 instances (kHeadMajor, kDrop, kStats, every SPLIT) take
// the JAX train kernel's steps (attention_train.py:84-118), which round
// the normalised, dropped probability P · keep / (1 - p), not p against
// a running max.  So the tile walks the keys twice (kTwoPass): the first
// pass takes each row's max and sum alone (the online softmax, no P·V),
// and the row tile's split warps merge them over the stages; the second
// recomputes the scores bit for bit, p = 2^(s - m) / l in float32, drops,
// rounds p to bfloat16 and takes P·V as one exact mma.sync, added in
// float32 with no rescaling; out is stored rounded, with no division.
// The same pass sums out32, the float32 P·V of the unrounded p (its TF32
// split, two mma.sync on the exact V), which K14 dots with dOut for the
// row sum of dP·P (the rounded out is off by bfloat16's rounding there).
// The statistics pass costs a second QKᵀ and bias per tile (one TF32
// product each, a third of the float32 instance's); holding a row
// tile's 16 x 512 scores instead would take 128 KB of shared memory a
// block at SPLIT 1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hash_dropout.cuh"
#include "mma_tf32x3.cuh"

namespace relpos_flash {

using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int kBaseD = 16;              // Base's head width (128 / 8
                                        // heads): K12's and K13's D
constexpr int kRowTiles = 4;            // warp tiles of 16 rows per block
constexpr int kRows = 16 * kRowTiles;   // query rows per block
constexpr int kKeys = 64;               // keys per tile
constexpr int kWarpBand = 80;           // a warp's band columns (79 used)
constexpr int kBS = kWarpBand;          // a warp's bias rows
constexpr float kLn2 = 0.6931471805599453f;

// A block's shape for SPLIT warps per row tile, at head width D.
template <int SPLIT, int D>
struct Shape {
  static_assert(D == 8 || D == 12 || D == 16 || D == 20 || D == 32,
                "head widths 8, 12, 16, 20 and 32");
  // Base's and Large's widths: whole k-steps of 16-byte lane loads (the
  // T/S/M widths take the padded plan)
  static constexpr bool kExact = D == 16 || D == 32;
  static constexpr int kDp = (D + 7) / 8 * 8;  // the products' k and n
  static constexpr int kPerLane = kDp / 4;  // a lane's columns of a row
  static constexpr int kLaneShift = D == 16 ? 2 : 3;  // log2, kExact
  static constexpr int kNN = kDp / 8;      // k-steps, output n-fragments
  // P·V chains a tile: about four independent fragments (D 16: two
  // chains of two; D 32: one of four)
  static constexpr int kChains = kNN >= 3 ? 1 : 4 / kNN;
  // Row strides in floats.  K and the band are read as D / 16 16-byte
  // fragment loads per row and lane, conflict-free at stride 16 (D 16)
  // and 36 (D 32: columns 8t .. 8t+3 of two rows 4 banks apart), or (the
  // T/S/M widths) as one 8-byte load per k-step, conflict-free at a
  // stride of 8 or 24 mod 32; V as scalars (rows 2t, 2t+1),
  // conflict-free at Dp + 4.
  static constexpr int kKS = kExact ? (D == 16 ? D : D + 4)
                                    : (kDp % 16 == 8 ? kDp : kDp + 8);
  static constexpr int kVS = kDp + 4;
  static constexpr int kWarps = kRowTiles * SPLIT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStepKeys = kKeys * SPLIT;   // keys staged a step
  // band rows staged: the 63 + 64 SPLIT a step's pairs reach, plus one so
  // that every warp reads 80
  static constexpr int kBand = kRows + kStepKeys;
  static constexpr int kStage = kStepKeys * (kKS + kVS) + kBand * kKS;
  static constexpr size_t kBiasBytes = sizeof(float) * kWarps * 16 * kBS;
  // two stages (the next step's loads overlap this step's products) where
  // they fit a block's 227 KB, else one: D 32 at SPLIT 4 (314 KB with
  // two, 197 KB with one)
  static constexpr int kStages =
      sizeof(float) * 2 * (size_t)kStage + kBiasBytes <= 227 * 1024 ? 2 : 1;
  static constexpr size_t kSmemBytes =
      sizeof(float) * kStages * (size_t)kStage + kBiasBytes;
  // 16 warps per SM where the shared memory allows (54 KB a block at
  // SPLIT 1, 100 KB at 2, 196 KB at 4 for D 16), else as many blocks as
  // fit the SM's 228 KB, 1 KB reserved per block (D 32: 92 KB at SPLIT 1,
  // two; 166 KB at 2 and 197 KB at 4, one)
  static constexpr int kFit = (int)(228 * 1024 / (kSmemBytes + 1024));
  static constexpr int kMinBlocks = 4 / SPLIT < kFit ? 4 / SPLIT : kFit;
  static_assert(kMinBlocks >= 1 && kSmemBytes <= 227 * 1024,
                "a block fits an SM");
  static constexpr int kRowStep = kThreads / kPerLane;  // rows a copy pass
  static_assert(!kExact || kStepKeys % kRowStep == 0,
                "each thread stages 16 bytes of every kRowStep-th key");
  // a split warp's state per lane: two maxes, two sums, its output
  static constexpr int kXch = 4 + 4 * kNN;
  static_assert((SPLIT - 1) * kRowTiles * 32 * kXch <= kStages * kStage,
                "the split warps' states fit over the stages");
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* table;   // [2*maxlen, D]
  const int* lens;      // [B], each >= 1
  float* out;
  float* row_max;       // [B*H, L] (kStats)
  float* row_sum;
  float* out32;         // [B*H, L, D]: K13's bfloat16 instances' float32
                        // P·V of the unrounded weights
  int L, H, maxlen;
  float scale_log2;     // log2(e) / sqrt(D)
  uint32_t seed_word;   // the hash's seed word of site 0
  uint32_t threshold8;  // int(p * 2^24) << 8; 0: no dropout
  float keep_scale;     // 1 / (1 - p)
  int block;            // the hash's row stride
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

// The tile's body: a kernel of Shape<SPLIT, D>::kThreads threads on the
// grid (ceil(L / kRows), B*H) with Shape<SPLIT, D>::kSmemBytes of dynamic
// shared memory.  kHeadMajor: [B*H, L, D] rows, else channels-last;
// kDrop: the hash dropout on the numerator; kStats: the rows' max and sum
// written.
// Four consecutive bfloat16 values (8 bytes) as floats.
__device__ __forceinline__ float4 load4_bf16(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <int D, int SPLIT, bool kHeadMajor, bool kDrop, bool kStats,
          class T = float>
__device__ __forceinline__ void run(const Args& a) {
  using S = Shape<SPLIT, D>;
  constexpr int kKS = S::kKS, kVS = S::kVS, kPerLane = S::kPerLane,
                kNN = S::kNN, kChains = S::kChains;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(!kBf16 || (kHeadMajor && kDrop && kStats) ||
                    (!kHeadMajor && !kDrop && !kStats && SPLIT == 1),
                "bfloat16: K12's one-pass tile, or K13's two-pass tile");
  static_assert(S::kExact ||
                    (!kBf16 && !kHeadMajor && !kDrop && !kStats &&
                     SPLIT == 1),
                "the T/S/M head widths: K12's float32 tile alone");
  // K13 in bfloat16: a statistics pass, then P·V on the normalised p
  constexpr bool kTwoPass = kBf16 && kHeadMajor;
  static_assert(!kTwoPass ||
                    (SPLIT - 1) * kRowTiles * 32 * 8 * kNN <=
                        S::kStages * S::kStage,
                "K13 bf16: the split warps' outputs fit over the stages");
  // bfloat16 rows of K, V and the band: stride D + 8 values (16-byte
  // aligned), within the float rows' room
  constexpr int kRS = D + 8;
  static_assert(kRS <= 2 * kKS && kRS <= 2 * kVS, "bf16 rows fit");
  using bf = __nv_bfloat16;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the warp's row tile and its share of the key tiles (SPLIT 1: every
  // warp its own row tile, folded at compile time)
  const int rt = SPLIT == 1 ? warp : warp % kRowTiles;
  const int ks = SPLIT == 1 ? 0 : warp / kRowTiles;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int L = a.L, maxlen = a.maxlen;
  const int F = kHeadMajor ? D : a.H * D;   // a head's row stride
  const int i0 = blockIdx.x * kRows;
  const int iw = i0 + 16 * rt;             // this warp's first row
  const int lim = min(L, a.lens[b]);
  const size_t head = kHeadMajor ? (size_t)bh * L * D
                                 : (size_t)b * L * F + (size_t)h * D;
  float* wbias = smem + S::kStages * S::kStage + warp * 16 * kBS;

  // Q fragments of rows iw+g and iw+g+8 (zero past L), scaled by
  // log2(e) / sqrt(D) and split once; the rows' clamped-bias constants
  // q·table[2m-1] and q·table[0] of the scaled rows.
  // The head width is the products' k: k-step kk puts the lane's column
  // 2kk (of (D/4) t .. (D/4) t + D/4 - 1) in slot t and 2kk + 1 in slot
  // t + 4, so a lane's columns of a row of Q, K or the band are D / 16
  // 16-byte loads.
  const int c0 = kPerLane * t;  // the lane's first column
  uint32_t qb[kNN][4], qs[kNN][4];
  float hi[2], lo[2];
  if constexpr (kBf16) {
    // unscaled bfloat16 Q (exact in TF32); the constants scaled after
    const bf* qh = reinterpret_cast<const bf*>(a.q);
    const bf* tab = reinterpret_cast<const bf*>(a.table);
    float qv[2][kPerLane];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + g + 8 * r;
#pragma unroll
      for (int q4 = 0; q4 < kPerLane / 4; ++q4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < L) x = load4_bf16(qh + head + (size_t)i * F + c0 + 4 * q4);
        qv[r][4 * q4] = x.x;
        qv[r][4 * q4 + 1] = x.y;
        qv[r][4 * q4 + 2] = x.z;
        qv[r][4 * q4 + 3] = x.w;
      }
    }
    const bf* top = tab + (size_t)(2 * maxlen - 1) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sh = 0.f, sl = 0.f;
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {
        sh = fmaf(qv[r][c], __bfloat162float(top[c0 + c]), sh);
        sl = fmaf(qv[r][c], __bfloat162float(tab[c0 + c]), sl);
      }
      hi[r] = quad_sum(sh) * a.scale_log2;
      lo[r] = quad_sum(sl) * a.scale_log2;
    }
#pragma unroll
    for (int kk = 0; kk < kNN; ++kk) {
      qb[kk][0] = __float_as_uint(qv[0][2 * kk]);
      qb[kk][1] = __float_as_uint(qv[1][2 * kk]);
      qb[kk][2] = __float_as_uint(qv[0][2 * kk + 1]);
      qb[kk][3] = __float_as_uint(qv[1][2 * kk + 1]);
    }
  } else if constexpr (!S::kExact) {
    // the T/S/M widths: k-step kk's columns 8 kk + 2t, 8 kk + 2t + 1 of
    // rows g and g+8, zero past D (and past L)
    float qv[2][kNN][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + g + 8 * r;
#pragma unroll
      for (int kk = 0; kk < kNN; ++kk) {
        const int c = 8 * kk + 2 * t;
        float2 x = make_float2(0.f, 0.f);
        if (i < L && c < D)
          x = *reinterpret_cast<const float2*>(a.q + head + (size_t)i * F +
                                               c);
        qv[r][kk][0] = x.x * a.scale_log2;
        qv[r][kk][1] = x.y * a.scale_log2;
      }
    }
    const float* top = a.table + (size_t)(2 * maxlen - 1) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sh = 0.f, sl = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNN; ++kk) {
        const int c = 8 * kk + 2 * t;
        if (c < D) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            sh = fmaf(qv[r][kk][q], top[c + q], sh);
            sl = fmaf(qv[r][kk][q], a.table[c + q], sl);
          }
        }
      }
      hi[r] = quad_sum(sh);
      lo[r] = quad_sum(sl);
    }
#pragma unroll
    for (int kk = 0; kk < kNN; ++kk) {
      const float x[4] = {qv[0][kk][0], qv[1][kk][0], qv[0][kk][1],
                          qv[1][kk][1]};
      tf32x3::split(x, qb[kk], qs[kk]);
    }
  } else {
    float qv[2][kPerLane];  // [row g, g+8][column c0 ..]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + g + 8 * r;
#pragma unroll
      for (int q4 = 0; q4 < kPerLane / 4; ++q4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < L)
          x = *reinterpret_cast<const float4*>(a.q + head + (size_t)i * F +
                                               c0 + 4 * q4);
        qv[r][4 * q4] = x.x * a.scale_log2;
        qv[r][4 * q4 + 1] = x.y * a.scale_log2;
        qv[r][4 * q4 + 2] = x.z * a.scale_log2;
        qv[r][4 * q4 + 3] = x.w * a.scale_log2;
      }
    }
    const float* top = a.table + (size_t)(2 * maxlen - 1) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sh = 0.f, sl = 0.f;
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {
        sh = fmaf(qv[r][c], top[c0 + c], sh);
        sl = fmaf(qv[r][c], a.table[c0 + c], sl);
      }
      hi[r] = quad_sum(sh);
      lo[r] = quad_sum(sl);
    }
#pragma unroll
    for (int kk = 0; kk < kNN; ++kk) {
      const float x[4] = {qv[0][2 * kk], qv[1][2 * kk], qv[0][2 * kk + 1],
                          qv[1][2 * kk + 1]};
      tf32x3::split(x, qb[kk], qs[kk]);
    }
  }

  // stage a step: K and V rows j0 .. j0 + kStepKeys - 1 (zero at or past
  // lim) and, unless every pair of the block clamps, the band rows.
  // Thread tid copies 16 bytes (columns c4 .. c4+3) of rows
  // tid/(D/4) + kRowStep it.
  const int r0 = tid >> S::kLaneShift, c4 = (tid & (kPerLane - 1)) * 4;
  constexpr int kRowStep = S::kRowStep;
  auto stage = [&](int buf, int j0) {
    float* ks_ = smem + buf * S::kStage;
    float* vs_ = ks_ + S::kStepKeys * kKS;
    float* band = vs_ + S::kStepKeys * kVS;
    const int rel0 = i0 - j0 - (S::kStepKeys - 1);
    const bool band_rows =
        rel0 < maxlen - 1 && rel0 + kRows + S::kStepKeys - 2 > -maxlen;
    if constexpr (kBf16) {
      // 16-byte pieces of eight values, D / 8 a row
      constexpr int kPer = D / 8;
      const bf* kb = reinterpret_cast<const bf*>(a.k);
      const bf* vb = reinterpret_cast<const bf*>(a.v);
      const bf* tb = reinterpret_cast<const bf*>(a.table);
      auto copy = [](bf* dst, const bf* src, bool ok) {
        cp_async16(reinterpret_cast<float*>(dst),
                   reinterpret_cast<const float*>(src), ok);
      };
      for (int e = tid; e < S::kStepKeys * kPer; e += S::kThreads) {
        const int r = e / kPer, c8 = (e % kPer) * 8, j = j0 + r;
        const bool ok = j < lim;
        const size_t off = head + (size_t)(ok ? j : 0) * F + c8;
        copy(reinterpret_cast<bf*>(ks_) + r * kRS + c8, kb + off, ok);
        copy(reinterpret_cast<bf*>(vs_) + r * kRS + c8, vb + off, ok);
      }
      if (band_rows) {
        for (int e = tid; e < S::kBand * kPer; e += S::kThreads) {
          const int r = e / kPer, c8 = (e % kPer) * 8;
          const int row = min(max(rel0 + r, -maxlen), maxlen - 1) + maxlen;
          copy(reinterpret_cast<bf*>(band) + r * kRS + c8,
               tb + (size_t)row * D + c8, true);
        }
      }
    } else if constexpr (!S::kExact) {
      // the T/S/M widths: the stage's D / 4 pieces a row, in turn
      constexpr int kPer = D / 4;
      for (int e = tid; e < S::kStepKeys * kPer; e += S::kThreads) {
        const int r = e / kPer, c = 4 * (e - r * kPer), j = j0 + r;
        const bool ok = j < lim;
        const size_t off = head + (size_t)(ok ? j : 0) * F + c;
        cp_async16(ks_ + r * kKS + c, a.k + off, ok);
        cp_async16(vs_ + r * kVS + c, a.v + off, ok);
      }
      if (band_rows) {
        for (int e = tid; e < S::kBand * kPer; e += S::kThreads) {
          const int r = e / kPer, c = 4 * (e - r * kPer);
          const int row = min(max(rel0 + r, -maxlen), maxlen - 1) + maxlen;
          cp_async16(band + r * kKS + c, a.table + (size_t)row * D + c,
                     true);
        }
      }
    } else {
#pragma unroll
      for (int it = 0; it < S::kStepKeys / kRowStep; ++it) {
        const int r = r0 + kRowStep * it, j = j0 + r;
        const bool ok = j < lim;
        const size_t off = head + (size_t)(ok ? j : 0) * F + c4;
        cp_async16(ks_ + r * kKS + c4, a.k + off, ok);
        cp_async16(vs_ + r * kVS + c4, a.v + off, ok);
      }
      if (band_rows) {
#pragma unroll
        for (int it = 0; it < (S::kBand + kRowStep - 1) / kRowStep; ++it) {
          const int r = r0 + kRowStep * it;
          const int row = min(max(rel0 + r, -maxlen), maxlen - 1) + maxlen;
          if (r < S::kBand)
            cp_async16(band + r * kKS + c4, a.table + (size_t)row * D + c4,
                       true);
        }
      }
    }
    cp_async_commit();
  };
  if constexpr (!S::kExact && D < S::kDp) {
    // the staged K, V and band rows' columns D .. Dp - 1 (one 16-byte
    // piece at D 12 and 20) are zero for the whole walk: no stage copy
    // writes them
    constexpr int kRowsA = 2 * S::kStepKeys + S::kBand;  // rows a stage
    for (int e = tid; e < S::kStages * kRowsA; e += S::kThreads) {
      const int st = e / kRowsA, r = e - st * kRowsA;
      float* base = smem + st * S::kStage;
      float* row = r < S::kStepKeys ? base + r * kKS
                   : r < 2 * S::kStepKeys
                       ? base + S::kStepKeys * kKS + (r - S::kStepKeys) * kVS
                       : base + S::kStepKeys * (kKS + kVS) +
                             (r - 2 * S::kStepKeys) * kKS;
      *reinterpret_cast<float4*>(row + D) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // the hash's row halves, of rows bh * block + i for i = iw+g, iw+g+8
  uint32_t row_half[2] = {0u, 0u};
  if (kDrop) {
    row_half[0] = sep_row_half(a.seed_word, (uint32_t)(bh * a.block + iw + g));
    row_half[1] =
        sep_row_half(a.seed_word, (uint32_t)(bh * a.block + iw + g + 8));
  }

  float o[kNN][4];
#pragma unroll
  for (int n = 0; n < kNN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  // kTwoPass: out32's accumulator, and each row's factor 1 / l of the
  // second pass
  float o32[kTwoPass ? kNN : 1][4] = {};
  float inv_l[2] = {1.f, 1.f};

  const int tiles = (lim + kKeys - 1) / kKeys;
  const int steps = (tiles + SPLIT - 1) / SPLIT;
  for (int pass = kTwoPass ? 0 : 1; pass < 2; ++pass) {
  const bool stats_pass = kTwoPass && pass == 0;
  stage(0, 0);
  for (int step = 0; step < steps; ++step) {
    if (S::kStages == 2 && step + 1 < steps) {
      stage((step + 1) & 1, (step + 1) * S::kStepKeys);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int n = SPLIT * step + ks;       // this warp's key tile
    if (SPLIT == 1 || n < tiles) {  // SPLIT 1: every step is a tile
      const int j0 = n * kKeys;
      const float* stage_ =
          smem + (S::kStages == 2 ? step & 1 : 0) * S::kStage;
      // (bfloat16: the same regions, rows at stride kRS values)
      const int ksr = kBf16 ? kRS / 2 : kKS, vsr = kBf16 ? kRS / 2 : kVS;
      const float* ks_ = stage_ + ks * kKeys * ksr;
      const float* vs_ = stage_ + S::kStepKeys * kKS + ks * kKeys * vsr;
      // the warp's band rows: its column 0 is rel iw - j0 - 63
      const float* band = stage_ + S::kStepKeys * (kKS + kVS) +
                          (16 * rt + kKeys * (SPLIT - 1 - ks)) * ksr;

      // S = Q Kᵀ: n-tile nt holds keys 8nt .. 8nt+7
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        if constexpr (!S::kExact) {  // the T/S/M widths
#pragma unroll
          for (int kk = 0; kk < kNN; ++kk) {
            const float2 kv = *reinterpret_cast<const float2*>(
                ks_ + (8 * nt + g) * kKS + 8 * kk + 2 * t);
            tf32x3::mma3(s[nt], qb[kk], qs[kk], kv.x, kv.y);
          }
        } else {
#pragma unroll
          for (int q4 = 0; q4 < kPerLane / 4; ++q4) {
            if constexpr (kBf16) {
              const float4 kk =
                  load4_bf16(reinterpret_cast<const bf*>(ks_) +
                             (8 * nt + g) * kRS + c0 + 4 * q4);
              const uint32_t b0[2] = {__float_as_uint(kk.x),
                                      __float_as_uint(kk.y)};
              const uint32_t b1[2] = {__float_as_uint(kk.z),
                                      __float_as_uint(kk.w)};
              tf32x3::mma(s[nt], qb[2 * q4], b0);
              tf32x3::mma(s[nt], qb[2 * q4 + 1], b1);
            } else {
              const float4 kk = *reinterpret_cast<const float4*>(
                  ks_ + (8 * nt + g) * kKS + c0 + 4 * q4);
              tf32x3::mma3(s[nt], qb[2 * q4], qs[2 * q4], kk.x, kk.y);
              tf32x3::mma3(s[nt], qb[2 * q4 + 1], qs[2 * q4 + 1], kk.z,
                           kk.w);
            }
          }
        }
      }

      // the bias, by the warp tile's class: a clamped tile's per-row
      // constant joins the softmax as a shift of the row (the max and the
      // exponent's argument), a band tile's bias is added to each score
      const int rel_min = iw - j0 - (kKeys - 1);   // warp band column 0
      float shift[2] = {0.f, 0.f};
      if (rel_min >= maxlen - 1) {
        shift[0] = hi[0];
        shift[1] = hi[1];
      } else if (rel_min + kKeys + 14 <= -maxlen) {
        shift[0] = lo[0];
        shift[1] = lo[1];
      } else {
#pragma unroll
        for (int m = 0; m < kWarpBand / 8; ++m) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (!S::kExact) {  // the T/S/M widths
#pragma unroll
            for (int kk = 0; kk < kNN; ++kk) {
              const float2 bb = *reinterpret_cast<const float2*>(
                  band + (8 * m + g) * kKS + 8 * kk + 2 * t);
              tf32x3::mma3(c, qb[kk], qs[kk], bb.x, bb.y);
            }
          } else {
#pragma unroll
            for (int q4 = 0; q4 < kPerLane / 4; ++q4) {
              if constexpr (kBf16) {
                const float4 bb =
                    load4_bf16(reinterpret_cast<const bf*>(band) +
                               (8 * m + g) * kRS + c0 + 4 * q4);
                const uint32_t b0[2] = {__float_as_uint(bb.x),
                                        __float_as_uint(bb.y)};
                const uint32_t b1[2] = {__float_as_uint(bb.z),
                                        __float_as_uint(bb.w)};
                tf32x3::mma(c, qb[2 * q4], b0);
                tf32x3::mma(c, qb[2 * q4 + 1], b1);
              } else {
                const float4 bb = *reinterpret_cast<const float4*>(
                    band + (8 * m + g) * kKS + c0 + 4 * q4);
                tf32x3::mma3(c, qb[2 * q4], qs[2 * q4], bb.x, bb.y);
                tf32x3::mma3(c, qb[2 * q4 + 1], qs[2 * q4 + 1], bb.z,
                             bb.w);
              }
            }
          }
          *reinterpret_cast<float2*>(wbias + g * kBS + 8 * m + 2 * t) =
              make_float2(c[0], c[1]);
          *reinterpret_cast<float2*>(wbias + (g + 8) * kBS + 8 * m + 2 * t) =
              make_float2(c[2], c[3]);
        }
        __syncwarp();
        // (row r, key jl) reads band column r - jl + 63
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = g - 8 * nt - 2 * t + kKeys - 1;
          s[nt][0] += wbias[g * kBS + col];
          s[nt][1] += wbias[g * kBS + col - 1];
          s[nt][2] += wbias[(g + 8) * kBS + col + 8];
          s[nt][3] += wbias[(g + 8) * kBS + col + 7];
        }
        __syncwarp();
      }

      // bfloat16: the summed scores to log2 units (float32 Q was scaled)
      if constexpr (kBf16) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] *= a.scale_log2;
      }
      // the key mask on the tile that crosses lim, and the online softmax
      // of rows g and g+8 (the scores are in log2 units)
      if (j0 + kKeys > lim) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + 8 * nt + 2 * t + (e & 1) >= lim) s[nt][e] = -INFINITY;
      }
      float alpha[2] = {1.f, 1.f}, m_sub[2];
      if (!kTwoPass || stats_pass) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m_run[r], quad_max(mx[r]) + shift[r]);
          alpha[r] = ex2(m_run[r] - m_new);     // 0 at the first tile
          m_run[r] = m_new;
          m_sub[r] = m_new - shift[r];
        }
      } else {  // the second pass: the rows' final max
#pragma unroll
        for (int r = 0; r < 2; ++r) m_sub[r] = m_run[r] - shift[r];
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = ex2(s[nt][e] - m_sub[e >> 1]);
          sum[e >> 1] += s[nt][e];
        }
      if (!kTwoPass || stats_pass) {
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
      }
      if (!stats_pass) {
      // the second pass normalises p (the first has the row sums)
      if (kTwoPass) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] *= inv_l[e >> 1];
      }
      // the drop, after the sum (1 / (1 - p) comes with 1 / l at the end,
      // or, in the second pass, here): s[nt][e] is row g + 8 (e / 2), key
      // j0 + 8 nt + 2t + e % 2
      if (kDrop && a.threshold8) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint32_t col =
                sep_col_half((uint32_t)(j0 + 8 * nt + 2 * t + c));
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (!sep_keep_halves(row_half[r], col, a.threshold8))
                s[nt][2 * r + c] = 0.f;
              else if (kTwoPass)
                s[nt][2 * r + c] *= a.keep_scale;
          }
      }

      // P V: slot t of k-step nt is key 8nt + 2t, slot t+4 key 8nt+2t+1.
      // kChains chains of fresh accumulators (k-steps nt mod kChains),
      // summed and added to O in float32 (mma_tf32x3.cuh: the tensor
      // cores' own accumulation drifts over many tiles).
      float pv[kChains][kNN][4] = {};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p4[4] = {s[nt][0], s[nt][2], s[nt][1], s[nt][3]};
        if constexpr (kBf16) {
          // p rounded to bfloat16 after its sum (K13: normalised and
          // dropped), one exact product; K13's out32 takes the unrounded
          // p's TF32 split, two exact products accumulated on the tensor
          // cores across the tiles (its fresh chains would spill at D 32,
          // SPLIT 4; out32 only feeds K14's row sums)
          uint32_t pb[4], pbig[4], psmall[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pb[i] = __float_as_uint(bf16s::rounded(p4[i]));
          if constexpr (kTwoPass) tf32x3::split(p4, pbig, psmall);
          const bf* vp =
              reinterpret_cast<const bf*>(vs_) + (8 * nt + 2 * t) * kRS + g;
#pragma unroll
          for (int nn = 0; nn < kNN; ++nn) {
            const uint32_t vb2[2] = {
                __float_as_uint(__bfloat162float(vp[8 * nn])),
                __float_as_uint(__bfloat162float(vp[kRS + 8 * nn]))};
            tf32x3::mma(pv[nt % kChains][nn], pb, vb2);
            if constexpr (kTwoPass) {
              tf32x3::mma(o32[nn], psmall, vb2);
              tf32x3::mma(o32[nn], pbig, vb2);
            }
          }
        } else {
          uint32_t pb[4], ps[4];
          tf32x3::split(p4, pb, ps);
          const float* vp = vs_ + (8 * nt + 2 * t) * kVS + g;
#pragma unroll
          for (int nn = 0; nn < kNN; ++nn)
            tf32x3::mma3(pv[nt % kChains][nn], pb, ps, vp[8 * nn],
                         vp[kVS + 8 * nn]);
        }
      }
#pragma unroll
      for (int nn = 0; nn < kNN; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = pv[0][nn][e];
#pragma unroll
          for (int ch = 1; ch < kChains; ++ch) sum += pv[ch][nn][e];
          if constexpr (kTwoPass) {
            o[nn][e] += sum;
          } else {
            o[nn][e] = o[nn][e] * alpha[e >> 1] + sum;
          }
        }
      }  // !stats_pass
    }
    __syncthreads();  // this stage's buffers are consumed
    // one stage: the next step's loads wait for this step's products
    if (S::kStages == 1 && step + 1 < steps)
      stage(0, (step + 1) * S::kStepKeys);
  }
  if (stats_pass) {
    // the row tile's split warps merge their maxes and sums over the
    // stages, each the same way, in the order of ks
    if constexpr (SPLIT > 1) {
      float* mine = smem + ((ks * kRowTiles + rt) * 32 + lane) * 4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mine[r] = m_run[r];
        mine[2 + r] = l_run[r];
      }
      __syncthreads();
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int w = 0; w < SPLIT; ++w) {
        const float* other = smem + ((w * kRowTiles + rt) * 32 + lane) * 4;
#pragma unroll
        for (int r = 0; r < 2; ++r) m[r] = fmaxf(m[r], other[r]);
      }
#pragma unroll
      for (int w = 0; w < SPLIT; ++w) {
        const float* other = smem + ((w * kRowTiles + rt) * 32 + lane) * 4;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l[r] += other[2 + r] * ex2(other[r] - m[r]);  // 0: no tile
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_run[r] = m[r];
        l_run[r] = l[r];
      }
      __syncthreads();  // read before the second pass stages over them
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      inv_l[r] = 1.f / fmaxf(quad_sum(l_run[r]), 1e-30f);
  }
  }  // pass

  if constexpr (SPLIT > 1 && kTwoPass) {
    // the row tile's warps meet over the stages: warps ks > 0 leave their
    // out and out32 fragments (of one max and sum), warp 0 adds them in
    // the order of ks
    float* xch = smem + (rt * 32 + lane) * 8 * kNN;
    constexpr int kXch = kRowTiles * 32 * 8 * kNN;  // floats per warp
    if (ks > 0) {
      float* mine = xch + (ks - 1) * kXch;
#pragma unroll
      for (int nn = 0; nn < kNN; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mine[4 * nn + e] = o[nn][e];
          mine[4 * kNN + 4 * nn + e] = o32[nn][e];
        }
    }
    __syncthreads();
    if (ks != 0) return;
#pragma unroll
    for (int w = 0; w < SPLIT - 1; ++w) {
      const float* other = xch + w * kXch;
#pragma unroll
      for (int nn = 0; nn < kNN; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[nn][e] += other[4 * nn + e];
          o32[nn][e] += other[4 * kNN + 4 * nn + e];
        }
    }
  } else if constexpr (SPLIT > 1) {
    // the row tile's warps meet over the stages: warps ks > 0 leave their
    // max, sums and output fragments, warp 0 merges them in the order of
    // ks (m the larger max, each side scaled by 2^(m_side - m))
    float* xch = smem + (rt * 32 + lane) * S::kXch;
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
      float w0[2], w1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = other[r], m = fmaxf(m_run[r], m1);
        w0[r] = ex2(m_run[r] - m);
        w1[r] = ex2(m1 - m);  // 0 if that warp had no tile
        m_run[r] = m;
        l_run[r] = l_run[r] * w0[r] + other[2 + r] * w1[r];
      }
#pragma unroll
      for (int nn = 0; nn < kNN; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nn][e] =
              o[nn][e] * w0[e >> 1] + other[4 + 4 * nn + e] * w1[e >> 1];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = iw + g + 8 * r;
    const float l = quad_sum(l_run[r]);
    // (the second pass's p is normalised and scaled already)
    const float inv =
        kTwoPass ? 1.f
                 : (kDrop && a.threshold8 ? a.keep_scale : 1.f) /
                       fmaxf(l, 1e-30f);
    if (i < L) {
#pragma unroll
      for (int nn = 0; nn < kNN; ++nn) {
        if (!S::kExact && 8 * nn + 2 * t >= D) continue;  // padding
        const size_t off = head + (size_t)i * F + 8 * nn + 2 * t;
        bf16s::store2(reinterpret_cast<T*>(a.out) + off,
                      o[nn][2 * r] * inv, o[nn][2 * r + 1] * inv);
        if constexpr (kTwoPass)
          *reinterpret_cast<float2*>(a.out32 + off) =
              make_float2(o32[nn][2 * r], o32[nn][2 * r + 1]);
      }
      if (kStats && t == 0) {
        a.row_max[(size_t)bh * L + i] = m_run[r] * kLn2;
        a.row_sum[(size_t)bh * L + i] = l;
      }
    }
  }
}

}  // namespace relpos_flash
