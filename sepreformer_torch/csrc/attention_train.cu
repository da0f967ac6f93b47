// Single-block train attention with the rel-pos bias and hash dropout in
// the kernel: K13 (forward) and K14 (backward).  For each (bh, i), with
// b = bh / H, lim = min(L, lens[b]) and c = 1 / sqrt(D):
//   s_ij = (q_i·k_j + q_i·table[clip(i - j, -maxlen, maxlen - 1) + maxlen])
//          * c  for j < lim;
//   P_ij = exp(s_ij - m_i) / l_i   (m_i the row max, l_i the row sum);
//   z_ij = keep(seed, site 0, row bh * block + i, col j) / (1 - p);
//   out_i = sum_j P_ij z_ij v_j            (float32 throughout).
// q, k, v, out and their gradients are [B*H, L, D]; table is the raw
// [2*maxlen, D] embedding.  Nothing of size [L, L] is ever stored.
//
// Replaces: sepreformer_tpu/ops/pallas/attention_train.py::
//           flash_relpos_attention_train, forward _fwd_impl (_fwd_kernel)
//           and backward _bwd_impl (_bwd_kernel), which the JAX package
//           runs for attention_train_impl="pallas" in training and for
//           attention_impl="single" (p = 0, key lengths) in eval, at
//           L <= 512.  The hash row is bh * block + i with block the JAX
//           kernel's padded length pick_block(L) (128, 256 or 512): the
//           mask is the JAX kernel's, bit for bit.
//
// What bounds it on the H100: per head, the forward needs 4*D operations
// per (query, valid key) pair (QKᵀ, P·V) plus 2*D per query row and
// distinct clamped table row its keys reach (Q·tableᵀ); the backward 10*D
// per pair (QKᵀ, dO·Vᵀ, dV, dQ, dK) plus 6*D per row and table row
// (Q·tableᵀ, its adjoints to dQ and to the table), and both one
// exponential per pair.  q, k, v and out are a few MB, so both are bound
// by their products, taken on the tensor cores at float32 accuracy
// (3xTF32, mma_tf32x3.cuh: 495/3 TFLOP/s): 0.0047 ms for K13 and 0.012 ms
// for K14 at [4, 8, 500, 16], twice that at Large's head width 32
// (chip_smoke.py counts each from its inputs).
//
// Design.  The TPU kernel holds a whole [block, block] score tile per bh
// in VMEM (1 MB at 512); a Hopper block has 227 KB of shared memory.  So
// K13 is the flash rel-pos tile that K12 runs (flash_relpos_tile.cuh):
// key tiles of 64 with an online softmax, every product on the tensor
// cores, here on [B*H, L, D] rows, with the hash dropout on the numerator
// (after the row sum) and each row's max and sum saved for K14.  Its
// grids are short (256 blocks of 64 rows at [4, 8, 500, 16], 16 to 128 at
// the shorter stages), so split_for gives each row tile 2 or 4 warps that
// walk alternate key tiles and merge at the end, where the grid would
// leave the card's warp slots empty and the rows have the key tiles.
// The head width D is a template parameter of both kernels: Base's 16 and
// Large's 32 (the tile's D = 32 instance; its SPLIT 4 block stages one
// step at a time, since two stages would take 314 KB).
//
// K14 recomputes P tile by tile from those row statistics, every product
// on the tensor cores as 3xTF32 (mma_tf32x3.cuh, each from zeroed
// fragments added to float32 sums): blocks of 4 warps, a warp per 16
// query rows (or keys) whose Q and dO (or K and V) fragments are split
// once and kept in registers (D / 8 k-steps of them; every accumulator
// D / 8 n-tiles), the other side's tile of 64 rows and the band of 128
// clamped table rows staged by cp.async at stride D + 4.  Its scores are
// q·k + q·pe, scaled after the sum, where K13's Q carries the scale:
// the two round otherwise in the last bits, so its P sums to 1 only
// within float32 rounding.  Three launches:
//  1. dq (grid: query tile x bh, two blocks per SM at D 16, 191
//     registers; one at D 32, its 116 KB of shared memory, 252 registers;
//     no spill): delta_i = dO_i·out_i (which equals sum_j P_ij dP_ij with
//     dropout too); per key tile the bias Q·bandᵀ over the warp's 80 band
//     rows into its rows of a [64][128] buffer, then by halves of 32 keys
//     S = Q Kᵀ plus the bias read at i - j + 63, dP = dO Vᵀ and
//     G = c P (z dP - delta) in the C fragments, written skewed over the
//     bias (G_skew[i][i - j + 63], zero elsewhere), and dq += G K with the
//     C fragments as A fragments; then, as the JAX kernel writes both
//     rel-pos adjoints as products on the skewed G, dq += G_skew·band and
//     the table's band sums G_skewᵀ·Q (two band m-tiles per warp, ten
//     k-steps each) into a frame of relative offsets per block: a frame
//     m-tile is complete after two key tiles, so a warp carries one in
//     registers and stores it once;
//  2. dk, dv (grid: key tile x bh x half of the query tiles, split by grid
//     z so that four blocks of 128 registers share an SM at D 16, at a
//     24-byte spill; two at D 32, Dims::kKvBlocks): the bias table of the
//     query tile (a [64][128] buffer, each warp its 16 query rows), then
//     by halves of 32 queries Sᵀ = K Qᵀ
//     plus the bias, dPᵀ = V dOᵀ, P z and G, dv += (P z)ᵀ dO and
//     dk += Gᵀ Q; the first half writes dk and dv, the second half its
//     own scratch copies;
//  3. dtable: a block per table row sums the frames of its relative
//     offsets (one, or a run of them at a clamped end row) over bh and
//     query tiles, in parts of bh added in a fixed order; the same blocks
//     first add dk's and dv's second halves to their first (a grid-stride
//     pass, so this launch's time is not the table sum's alone).
// The TPU kernel's barrel shifter and row-reversed table are Mosaic
// workarounds (no gather, no reverse); here the <= 127 clamped table rows
// of a (query tile, key tile) band are staged in shared memory.  No float
// atomics: two runs give the same bits.  Query rows past L are computed
// on zeros and never written; keys at or past lim score -inf (forward) or
// carry no gradient (backward).  64-bit offsets throughout.
//
// bfloat16 streams (sep_attn_train_fwd_bf16, sep_attn_train_bwd_bf16):
// q, k, v, the table, dout and the four gradients bfloat16, with the JAX
// kernels' rounding steps (attention_train.py:84-172).  K13 is the
// tile's two-pass instance (flash_relpos_tile.cuh says why), which also
// writes out32, the float32 P·V of the unrounded weights.  K14's three
// launches keep their plan and shared memory: the bfloat16 rows are
// upcast as they are staged (plain loads in place of cp.async, the stage
// layouts unchanged), every operand of a product is then bfloat16-exact
// (q, k, v, dO and the band as read; P·z, G and G_skew rounded where JAX
// rounds Pd, dS and its barrel scatter), so each product is one TF32
// mma.sync (mma_tf32x3.cuh) in place of three, and the A fragments need
// no small parts; delta_i = dO_i·out32_i is the row sum of dP·P as JAX
// sums it; dq is stored rounded; the dk/dv launch writes both halves to
// float32 scratch and the third launch stores their sum rounded, and the
// table's float32 sum rounded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_relpos_tile.cuh"
#include "hash_dropout.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int kTile = 64;              // query rows / keys per tile
constexpr int kBand = 2 * kTile;       // band rows staged (127 used)

struct Drop {
  uint32_t seed_word, threshold;
  float scale;                         // 1 / (1 - p)
  int block;                           // hash row stride, pick_block(L)
  bool on;                             // p > 0
  __device__ __forceinline__ float z(int bh, int i, int j) const {
    if (!on) return 1.f;
    return sep_keep(seed_word, (uint32_t)(bh * block + i), (uint32_t)j,
                    threshold) ? scale : 0.f;
  }
};

// ---------------------------------------------------------------- K13

// The flash rel-pos tile on [B*H, L, D] rows, with the hash dropout and
// the row statistics, at SPLIT warps per row tile of 16 rows.
template <int D, int SPLIT>
__global__ void __launch_bounds__(relpos_flash::Shape<SPLIT, D>::kThreads,
                                  relpos_flash::Shape<SPLIT, D>::kMinBlocks)
attn_train_fwd_kernel(relpos_flash::Args a) {
  relpos_flash::run<D, SPLIT, true, true, true>(a);
}

// The same on bfloat16 rows: the tile's two-pass instance, with out32.
template <int D, int SPLIT>
__global__ void __launch_bounds__(relpos_flash::Shape<SPLIT, D>::kThreads,
                                  relpos_flash::Shape<SPLIT, D>::kMinBlocks)
attn_train_fwd_bf16_kernel(relpos_flash::Args a) {
  relpos_flash::run<D, SPLIT, true, true, true, __nv_bfloat16>(a);
}

// ---------------------------------------------------------------- K14

// K14's launches take their products on the tensor cores as 3xTF32
// (mma_tf32x3.cuh): blocks of 4 warps, each warp 16 query rows (dq) or 16
// keys (dk, dv) against tiles of 64.
namespace bwd {

using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGS = kBand + 8;         // G_skew's row stride (8 mod 32:
                                       // 8-byte fragment loads)
constexpr int kQB = kBand + 3;         // the dk/dv bias table's: (row ii,
                                       // column ii - jj + 63) misses no
                                       // bank
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile == 16 * kWarps, "a warp per 16 rows of a tile");

// The launches' shape at head width D (16 or 32).  Row strides in
// floats: kS of the staged K, V, Q, dO and band rows (a lane's loads of
// rows g (or 2t) and columns t (or g) miss no bank at D + 4), kQ of the
// dq launch's query tile (its band sums' loads of rows t and t + 4 at
// column g miss no bank at D + 8).
template <int D>
struct Dims {
  static_assert(D == 16 || D == 32, "head widths 16 and 32");
  static constexpr int kK = D / 8;       // k-steps over d, n-tiles of d
  static constexpr int kS = D + 4;
  static constexpr int kQ = D + 8;
  static constexpr int kPerRow = D / 4;  // 16-byte pieces of a row
  static constexpr int kRowStep = kThreads / kPerRow;  // rows a copy pass
  // floats of the dq launch's dynamic shared memory: two stages of K, V
  // and the band, G_skew, the query tile
  static constexpr int kStageDq = 2 * kTile * kS + kBand * kS;
  static constexpr int kDqFloats = 2 * kStageDq + kTile * kGS + kTile * kQ;
  // the dk/dv launch's: Q, dO, the band and the query rows' statistics
  // (max in log2 units, 1 / l, delta) of a query tile, then the bias
  // table
  static constexpr int kStageKv = 2 * kTile * kS + kBand * kS + 3 * kTile;
  static constexpr int kKvFloats = kStageKv + kTile * kQB;
  // blocks an SM holds: dq as many as the shared memory allows (228 KB,
  // 1 KB reserved a block): two at D 16 (80 KB), one at D 32 (116 KB);
  // dk/dv four at D 16 (53.5 KB), and two at D 32 (69.5 KB): three would
  // fit, but at their 168 registers the D = 32 accumulators spill 552
  // bytes, and the launch ran 18 % slower than at two blocks of up to 255
  // registers, which spill none (PERF.md §6)
  static constexpr int kDqBlocks =
      (int)(228 * 1024 / (sizeof(float) * kDqFloats + 1024));
  static constexpr int kKvBlocks = D == 16 ? 4 : 2;
  static_assert(kDqBlocks >= 1 && kKvBlocks * (sizeof(float) * kKvFloats +
                                               1024) <= 228 * 1024,
                "the blocks fit an SM");
};

// 2^x on the SFU (relative error about 2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The bfloat16 instance's rows are upcast as they are staged: each
// thread loads its 8 bytes (four values) and stores them as a float4.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 16 bytes of floats (4 values) at src into dst, zero where !ok: by
// cp.async for float rows, by a load and a store for bfloat16 ones
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src,
                                       bool ok) {
  *reinterpret_cast<float4*>(dst) =
      ok ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// rows r0 .. r0 + n - 1 of a [*, D] array into s[rr * LD + c] by
// cp.async, zero at or past lim: thread tid copies 16 bytes of every
// kRowStep-th row (bfloat16: 4 values, upcast)
template <int D, int LD = Dims<D>::kS, class In>
__device__ __forceinline__ void stage_rows(float* s, const In* a, int r0,
                                           int lim, int n) {
  using M = Dims<D>;
  const int c4 = (threadIdx.x % M::kPerRow) * 4;
  for (int rr = threadIdx.x / M::kPerRow; rr < n; rr += M::kRowStep) {
    const bool ok = r0 + rr < lim;
    stage4(s + rr * LD + c4, a + (size_t)(ok ? r0 + rr : 0) * D + c4, ok);
  }
}

// the kBand clamped table rows of offsets rel0 .. rel0 + kBand - 1
template <int D, class In>
__device__ __forceinline__ void stage_band(float* s, const In* table,
                                           int rel0, int maxlen) {
  using M = Dims<D>;
  const int c4 = (threadIdx.x % M::kPerRow) * 4;
  for (int rr = threadIdx.x / M::kPerRow; rr < kBand; rr += M::kRowStep) {
    const int row = min(max(rel0 + rr, -maxlen), maxlen - 1) + maxlen;
    stage4(s + rr * M::kS + c4, table + (size_t)row * D + c4, true);
  }
}

// A fragments (standard k order: slots t, t+4 = columns 8 ks + t, + 4) of
// rows r and r + 8 of a [*, D] array (zero past n), split once; a
// bfloat16 array's values are exact in TF32 (small stays zero)
template <int D, class In>
__device__ __forceinline__ void rows_split(const In* a, int r, int n,
                                           uint32_t (&big)[D / 8][4],
                                           uint32_t (&small)[D / 8][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e & 1), col = 8 * ks + t + 4 * (e >> 1);
      v[e] = row < n ? bf16s::to_f(a[(size_t)row * D + col]) : 0.f;
    }
    if constexpr (std::is_same<In, float>::value) {
      tf32x3::split(v, big[ks], small[ks]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        big[ks][e] = __float_as_uint(v[e]);
        small[ks][e] = 0u;
      }
    }
  }
}

// c[nt] = A B(., nt) over D (KK = D / 8 k-steps) from zeroed fragments:
// A the warp's register fragments, split once; bfrag(ks, nt) gives
// B[8 ks + t] and B[8 ks + t + 4] of the lane's column g of n-tile nt.
// Each term is issued over all NT fragments before the next, so that
// independent products sit between dependent ones.  kExact: A and B are
// exact in TF32 (bfloat16 values), one product a term.
template <int NT, int KK, bool kExact = false, class BFrag>
__device__ __forceinline__ void regs_product(float (&c)[NT][4],
                                             const uint32_t (&ab)[KK][4],
                                             const uint32_t (&as)[KK][4],
                                             BFrag bfrag) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KK; ++ks) {
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b = bfrag(ks, nt);
      const float v[2] = {b.x, b.y};
      if constexpr (kExact) {
        bb[nt][0] = __float_as_uint(v[0]);
        bb[nt][1] = __float_as_uint(v[1]);
      } else {
        tf32x3::split(v, bb[nt], bs[nt]);
      }
    }
    if constexpr (!kExact) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) tf32x3::mma(c[nt], as[ks], bb[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) tf32x3::mma(c[nt], ab[ks], bs[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) tf32x3::mma(c[nt], ab[ks], bb[nt]);
  }
}

// acc[nn] += A B over KS k-steps and NN n-tiles (NN = D / 8: the head
// width's columns): afrag(ks, a) fills A's fragment of k-step ks (slots t
// and t + 4 hold k = 8 ks + 2t and + 1), bfrag(ks, nn) gives B[8 ks + 2t]
// and B[8 ks + 2t + 1] of the lane's column g of n-tile nn.  The k-steps
// of either parity sum into their own zeroed fragments (2 NN independent
// products per term), added to acc in float32 at the end.  kExact: A and
// B are exact in TF32 (bfloat16 values), one product a term.
template <int KS, int NN, bool kExact = false, class AFrag, class BFrag>
__device__ __forceinline__ void pair_product(float (&acc)[NN][4], AFrag afrag,
                                             BFrag bfrag) {
  static_assert(KS % 2 == 0, "k-steps in pairs");
  float sum[2][NN][4] = {};
#pragma unroll
  for (int k2 = 0; k2 < KS; k2 += 2) {
    uint32_t ab[2][4], as[2][4], bb[2][NN][2], bs[2][NN][2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float a[4];
      afrag(k2 + x, a);
      if constexpr (kExact) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ab[x][e] = __float_as_uint(a[e]);
      } else {
        tf32x3::split(a, ab[x], as[x]);
      }
#pragma unroll
      for (int nn = 0; nn < NN; ++nn) {
        const float2 b = bfrag(k2 + x, nn);
        const float v[2] = {b.x, b.y};
        if constexpr (kExact) {
          bb[x][nn][0] = __float_as_uint(v[0]);
          bb[x][nn][1] = __float_as_uint(v[1]);
        } else {
          tf32x3::split(v, bb[x][nn], bs[x][nn]);
        }
      }
    }
    if constexpr (!kExact) {
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int nn = 0; nn < NN; ++nn)
          tf32x3::mma(sum[x][nn], as[x], bb[x][nn]);
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int nn = 0; nn < NN; ++nn)
          tf32x3::mma(sum[x][nn], ab[x], bs[x][nn]);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
        tf32x3::mma(sum[x][nn], ab[x], bb[x][nn]);
  }
#pragma unroll
  for (int nn = 0; nn < NN; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] += sum[0][nn][e] + sum[1][nn][e];
}

// bias[r][cc] = sum_c A[r][c] band[cc][c] for the warp's 16 rows and 80
// band rows (stride KS), written to out[r * LD + cc] (in pairs where LD
// is even)
template <int LD, int KS, int KK, bool kExact = false>
__device__ __forceinline__ void band_bias(const uint32_t (&ab)[KK][4],
                                          const uint32_t (&as)[KK][4],
                                          const float* band, float* out) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float c[5][4];
    regs_product<5, KK, kExact>(c, ab, as, [&](int ks, int nt) {
      const float* br = band + (8 * (5 * half + nt) + g) * KS + 8 * ks + t;
      return make_float2(br[0], br[4]);
    });
#pragma unroll
    for (int nt = 0; nt < 5; ++nt) {
      float* o = out + g * LD + 8 * (5 * half + nt) + 2 * t;
      if (LD % 2 == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(c[nt][0], c[nt][1]);
        *reinterpret_cast<float2*>(o + 8 * LD) =
            make_float2(c[nt][2], c[nt][3]);
      } else {
        o[0] = c[nt][0];
        o[1] = c[nt][1];
        o[8 * LD] = c[nt][2];
        o[8 * LD + 1] = c[nt][3];
      }
    }
  }
}

// The scratch of the three launches, in floats: delta [BH, L]; the second
// halves' dk and dv [BH, L, D] each (the first halves write the outputs,
// and the table launch adds the second in a fixed order; the bfloat16
// instance writes its first halves to dk0 and dv0 too, and the table
// launch stores the rounded sums); the dq blocks' frames of band sums
// [BH][query tiles][frame_rows(L)][D].
struct Scratch {
  float *delta, *dk1, *dv1, *frames, *dk0, *dv0;
};

// rows of a query tile's frame of relative offsets: offset i0 - Lk + 1 +
// fr for fr in [0, Lk + 64), Lk = L rounded up to the tile
__host__ __device__ inline int frame_rows(int L) {
  return ((L + kTile - 1) / kTile) * kTile + kTile;
}

// Launch 1, dq: a block per (query tile, bh).  In: float, or bfloat16
// (q, k, v, the table, dout and dq; out is then K13's float32 out32).
template <int D, class In = float>
__global__ void __launch_bounds__(kThreads, Dims<D>::kDqBlocks)
attn_train_bwd_dq_kernel(const In* __restrict__ q,
                         const In* __restrict__ k,
                         const In* __restrict__ v,
                         const In* __restrict__ table,
                         const int* __restrict__ lens,
                         const float* __restrict__ out,
                         const In* __restrict__ dout,
                         const float* __restrict__ row_max,
                         const float* __restrict__ row_sum,
                         In* __restrict__ dq, Scratch scratch, int L,
                         int H, int maxlen, float scale, Drop drop) {
  using M = Dims<D>;
  constexpr int kS = M::kS, kQ = M::kQ, kK = M::kK;
  constexpr bool kBf16 = !std::is_same<In, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* gsk = smem + 2 * M::kStageDq;   // [kTile][kGS] G_skew
  float* qsm = gsk + kTile * kGS;        // [kTile][kQ] the query tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, qt = blockIdx.x, nqt = gridDim.x;
  const int i0 = qt * kTile, iw = i0 + 16 * warp;
  const int lim = min(L, lens[bh / H]);
  const size_t head = (size_t)bh * L * D;
  const int lk = nqt * kTile, nframe = frame_rows(L);
  const float cl2 = scale * kLog2e;
  float* frame = scratch.frames + ((size_t)bh * nqt + qt) * nframe * D;
  // this warp's rows of G_skew: row r (query iw + r), band column cc
  // (block column 16 warp + cc): the pair (iw + r, j0 + jj) at cc = r - jj
  // + 63; first the bias of the same pairs
  float* wg = gsk + 16 * warp * kGS + 16 * warp;

  for (int e = tid; e < kTile * kGS; e += kThreads) gsk[e] = 0.f;
  stage_rows<D, kQ>(qsm, q + head, i0, L, kTile);
  auto stage = [&](int buf, int j0) {
    float* st = smem + buf * M::kStageDq;
    stage_rows<D>(st, k + head, j0, lim, kTile);
    stage_rows<D>(st + kTile * kS, v + head, j0, lim, kTile);
    stage_band<D>(st + 2 * kTile * kS, table, i0 - j0 - (kTile - 1),
                  maxlen);
    cp_async_commit();
  };
  const int nkt = (lim + kTile - 1) / kTile;
  stage(0, 0);  // with the query tile

  // rows iw + g and iw + g + 8: Q and dO as A fragments, split once; the
  // row statistics (rows past L: 1 / l = 0, so P and G are 0 there) and
  // delta_i = dO_i·out_i (= sum_j P_ij dP_ij, with dropout too)
  uint32_t qb[kK][4], qs[kK][4], ob[kK][4], os[kK][4];
  rows_split<D>(q + head, iw + g, L, qb, qs);
  rows_split<D>(dout + head, iw + g, L, ob, os);
  float ml2[2], linv[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = iw + g + 8 * h;
    const bool in = i < L;
    float sum = 0.f;
#pragma unroll
    for (int c = t; c < D; c += 4)
      if (in) sum = fmaf(bf16s::to_f(dout[head + (size_t)i * D + c]),
                         out[head + (size_t)i * D + c], sum);
    dl[h] = quad_sum(sum);
    ml2[h] = in ? row_max[(size_t)bh * L + i] * kLog2e : 0.f;
    linv[h] = in ? 1.f / fmaxf(row_sum[(size_t)bh * L + i], 1e-30f) : 0.f;
    if (in && t == 0) scratch.delta[(size_t)bh * L + i] = dl[h];
  }

  float dqa[kK][4] = {};
  // the frame rows of band m-tile `warp` of the last key tile, which this
  // tile's band m-tile warp + 4 completes (see below)
  float carry[kK][4] = {};
  for (int n = 0; n < nkt; ++n) {
    const int j0 = n * kTile;
    cp_async_wait<0>();
    // this tile's stage landed; every warp is done with the last tile's
    // stage and G_skew
    __syncthreads();
    if (n + 1 < nkt) stage((n + 1) & 1, j0 + kTile);
    const float* ks_ = smem + (n & 1) * M::kStageDq;
    const float* vs_ = ks_ + kTile * kS;
    const float* band = vs_ + kTile * kS;

    // the bias Q·bandᵀ over the warp's 80 band rows, written to its rows
    // of G_skew: pair (row r, key jj) reads column r - jj + 63
    band_bias<kGS, kS, kK, kBf16>(qb, qs, band + 16 * warp * kS, wg);
    __syncwarp();
    // by halves of 32 keys: S = Q Kᵀ plus the bias, dP = dO Vᵀ, then
    // G = c P (z dP - delta) (keys past lim: 0), written skewed over the
    // bias (each pair's column is its lane's), and dq += G K
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const float* kh_ = ks_ + 32 * kh * kS;
      float s[4][4], dp[4][4];
      regs_product<4, kK, kBf16>(s, qb, qs, [&](int ks, int nt) {
        const float* br = kh_ + (8 * nt + g) * kS + 8 * ks + t;
        return make_float2(br[0], br[4]);
      });
      regs_product<4, kK, kBf16>(dp, ob, os, [&](int ks, int nt) {
        const float* br = vs_ + (32 * kh + 8 * nt + g) * kS + 8 * ks + t;
        return make_float2(br[0], br[4]);
      });
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, r = g + 8 * h;
          const int jj = 32 * kh + 8 * nt + 2 * t + (e & 1);
          const int i = iw + r, j = j0 + jj;
          float* cell = wg + r * kGS + r - jj + kTile - 1;
          float gv = 0.f;
          if (j < lim) {
            const float p =
                ex2(fmaf(s[nt][e] + *cell, cl2, -ml2[h])) * linv[h];
            gv = scale * p * (drop.z(bh, i, j) * dp[nt][e] - dl[h]);
            if (kBf16) gv = bf16s::rounded(gv);  // JAX's dsq and ds2
          }
          s[nt][e] = gv;
          *cell = gv;
        }
      pair_product<4, kK, kBf16>(
          dqa,
          [&](int nt, float(&a)[4]) {
            a[0] = s[nt][0];
            a[1] = s[nt][2];
            a[2] = s[nt][1];
            a[3] = s[nt][3];
          },
          [&](int nt, int nn) {
            const float* br = kh_ + (8 * nt + 2 * t) * kS + 8 * nn + g;
            return make_float2(br[0], br[kS]);
          });
    }
    // the band columns of the warp's rows that no pair reaches
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int r = lane >> 1, c = 8 * (lane & 1) + x;  // 16 per row
      wg[r * kGS + (c < r ? c : c + kTile)] = 0.f;
    }
    __syncwarp();
    // dq += G_skew band: the rel-pos adjoint, pe_{i-j} of every pair,
    // over the warp's 80 band rows
    pair_product<10, kK, kBf16>(
        dqa,
        [&](int ks, float(&a)[4]) {
          const float* a0 = wg + g * kGS + 8 * ks + 2 * t;
          const float2 lo = *reinterpret_cast<const float2*>(a0);
          const float2 hi = *reinterpret_cast<const float2*>(a0 + 8 * kGS);
          a[0] = lo.x;
          a[1] = hi.x;
          a[2] = lo.y;
          a[3] = hi.y;
        },
        [&](int ks, int nn) {
          const float* w =
              band + (16 * warp + 8 * ks + 2 * t) * kS + 8 * nn + g;
          return make_float2(w[0], w[kS]);
        });
    __syncthreads();  // every warp's rows of G_skew are written

    // The table's band sums, sum_ii G_skew[ii][bnd] q_ii for band bnd
    // (offset i0 - j0 - 63 + bnd, frame row lk - 64 - j0 + bnd): band
    // m-tiles warp (query rows 0 .. 16 warp + 15 reach it) and warp + 4
    // (rows 16 warp + 1 .. 63), ten k-steps of rows for every warp, the
    // two m-tiles' products issued together.  Frame m-tile f + warp + 4
    // (f = (lk - 64 - j0) / 16) takes the last key tile's m-tile `warp`
    // and this one's m-tile warp + 4 and is then complete; this tile's
    // m-tile `warp` waits for the next key tile.
    float sums[2][kK][4] = {};
    {
      const int n0 = 2 * warp + 2, lo1 = 2 * warp, n1 = kTile / 8 - lo1;
#pragma unroll
      for (int step = 0; step < kTile / 8; ++step) {
        const bool on[2] = {step < n0, step < n1};
        uint32_t ab[2][4], as[2][4], bb[2][kK][2], bs[2][kK][2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          // A = G_skewᵀ: band rows 16 m + g (+ 8), query rows 8 ks + t
          // (+ 4); B = the query tile's rows
          const int m = warp + 4 * x;
          const int ks = on[x] ? (x ? lo1 + step : step) : 0;
          const float* a0 = gsk + (8 * ks + t) * kGS + 16 * m + g;
          const float a[4] = {a0[0], a0[8], a0[4 * kGS], a0[4 * kGS + 8]};
          const float* br = qsm + (8 * ks + t) * kQ + g;
          if constexpr (kBf16) {  // G_skew and Q are bfloat16-exact
#pragma unroll
            for (int e = 0; e < 4; ++e) ab[x][e] = __float_as_uint(a[e]);
#pragma unroll
            for (int nn = 0; nn < kK; ++nn) {
              bb[x][nn][0] = __float_as_uint(br[8 * nn]);
              bb[x][nn][1] = __float_as_uint(br[4 * kQ + 8 * nn]);
            }
          } else {
            tf32x3::split(a, ab[x], as[x]);
#pragma unroll
            for (int nn = 0; nn < kK; ++nn) {
              const float v2[2] = {br[8 * nn], br[4 * kQ + 8 * nn]};
              tf32x3::split(v2, bb[x][nn], bs[x][nn]);
            }
          }
        }
        if constexpr (!kBf16) {
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int nn = 0; nn < kK; ++nn)
              if (on[x]) tf32x3::mma(sums[x][nn], as[x], bb[x][nn]);
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int nn = 0; nn < kK; ++nn)
              if (on[x]) tf32x3::mma(sums[x][nn], ab[x], bs[x][nn]);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int nn = 0; nn < kK; ++nn)
            if (on[x]) tf32x3::mma(sums[x][nn], ab[x], bb[x][nn]);
      }
    }
    const int f = (lk - kTile - j0) / 16;
#pragma unroll
    for (int nn = 0; nn < kK; ++nn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * (f + warp + 4) + g + 8 * h;
        *reinterpret_cast<float2*>(frame + (size_t)row * D + 8 * nn + 2 * t) =
            make_float2(carry[nn][2 * h] + sums[1][nn][2 * h],
                        carry[nn][2 * h + 1] + sums[1][nn][2 * h + 1]);
        carry[nn][2 * h] = sums[0][nn][2 * h];
        carry[nn][2 * h + 1] = sums[0][nn][2 * h + 1];
      }
  }

  // the last key tile's m-tile `warp`, and zeros in the frame rows below
  // it that no key tile reaches (keys past lim)
  const int f = (lk - nkt * kTile) / 16;
#pragma unroll
  for (int nn = 0; nn < kK; ++nn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * (f + warp) + g + 8 * h;
      *reinterpret_cast<float2*>(frame + (size_t)row * D + 8 * nn + 2 * t) =
          make_float2(carry[nn][2 * h], carry[nn][2 * h + 1]);
    }
  for (int e = tid; e < 16 * f * D / 4; e += kThreads)
    reinterpret_cast<float4*>(frame)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = iw + g + 8 * h;
    if (i < L)
#pragma unroll
      for (int nn = 0; nn < kK; ++nn)
        bf16s::store2(dq + head + (size_t)i * D + 8 * nn + 2 * t,
                      dqa[nn][2 * h], dqa[nn][2 * h + 1]);
  }
}

// Launch 2, dk and dv: block (key tile, bh, z) takes the query tiles of
// half z (four blocks share an SM at D 16, two at D 32).  In: as launch
// 1's; the bfloat16 instance writes both halves to scratch.
template <int D, class In = float>
__global__ void __launch_bounds__(kThreads, Dims<D>::kKvBlocks)
attn_train_bwd_dkv_kernel(const In* __restrict__ q,
                          const In* __restrict__ k,
                          const In* __restrict__ v,
                          const In* __restrict__ table,
                          const int* __restrict__ lens,
                          const In* __restrict__ dout,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Scratch scratch, int L,
                          int H, int maxlen, float scale, Drop drop) {
  using M = Dims<D>;
  constexpr int kS = M::kS, kK = M::kK;
  constexpr bool kBf16 = !std::is_same<In, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* qs_ = smem;                     // [kTile][kS] Q
  float* os_ = qs_ + kTile * kS;         // [kTile][kS] dO
  float* band = os_ + kTile * kS;        // [kBand][kS]
  float* ms = band + kBand * kS;         // [kTile] max * log2(e)
  float* ls = ms + kTile;                // [kTile] 1 / l
  float* ds = ls + kTile;                // [kTile] delta
  float* qbias = smem + M::kStageKv;     // [kTile][kQB]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, z = blockIdx.z;
  const int j0 = blockIdx.x * kTile, jw = j0 + 16 * warp;
  const int lim = min(L, lens[bh / H]);
  const size_t head = (size_t)bh * L * D;
  const float cl2 = scale * kLog2e;

  float dka[kK][4] = {}, dva[kK][4] = {};
  const int nqt = (L + kTile - 1) / kTile, half = (nqt + 1) / 2;
  const int qt0 = z ? half : 0, qt1 = z ? nqt : half;
  if (j0 < lim) {
    // keys jw + g and jw + g + 8 (zero at or past lim): K and V as A
    // fragments, split once
    uint32_t kb[kK][4], ksm[kK][4], vb[kK][4], vsm[kK][4];
    rows_split<D>(k + head, jw + g, lim, kb, ksm);
    rows_split<D>(v + head, jw + g, lim, vb, vsm);
    for (int n = qt0; n < qt1; ++n) {
      const int i0 = n * kTile;
      __syncthreads();  // every warp is done with the last tile
      stage_rows<D>(qs_, q + head, i0, L, kTile);
      stage_rows<D>(os_, dout + head, i0, L, kTile);
      stage_band<D>(band, table, i0 - j0 - (kTile - 1), maxlen);
      cp_async_commit();
      if (tid < kTile) {
        const int i = i0 + tid;
        const bool in = i < L;
        ms[tid] = in ? row_max[(size_t)bh * L + i] * kLog2e : 0.f;
        ls[tid] =
            in ? 1.f / fmaxf(row_sum[(size_t)bh * L + i], 1e-30f) : 0.f;
        ds[tid] = in ? scratch.delta[(size_t)bh * L + i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // the bias table: query rows 16 warp .. (this warp's A fragments
      // from the tile) against their 80 band rows; (key jj, query ii)
      // reads qbias[ii][ii - jj + 63]
      {
        uint32_t ab[kK][4], as[kK][4];
#pragma unroll
        for (int ks = 0; ks < kK; ++ks) {
          const float* a0 = qs_ + (16 * warp + g) * kS + 8 * ks + t;
          const float a[4] = {a0[0], a0[8 * kS], a0[4], a0[8 * kS + 4]};
          if constexpr (kBf16) {
#pragma unroll
            for (int e = 0; e < 4; ++e) ab[ks][e] = __float_as_uint(a[e]);
          } else {
            tf32x3::split(a, ab[ks], as[ks]);
          }
        }
        band_bias<kQB, kS, kK, kBf16>(ab, as, band + 16 * warp * kS,
                                      qbias + 16 * warp * kQB + 16 * warp);
      }
      __syncthreads();  // the bias table is whole
      // by halves of 32 queries: Sᵀ = K Qᵀ plus the bias and dPᵀ = V dOᵀ
      // for this warp's 16 keys, P z and G, then dv += (P z)ᵀ dO and
      // dk += Gᵀ Q with the C fragments as A fragments
#pragma unroll
      for (int qh = 0; qh < 2; ++qh) {
        float st[4][4], dpt[4][4];
        regs_product<4, kK, kBf16>(st, kb, ksm, [&](int ks, int nt) {
          const float* br = qs_ + (32 * qh + 8 * nt + g) * kS + 8 * ks + t;
          return make_float2(br[0], br[4]);
        });
        regs_product<4, kK, kBf16>(dpt, vb, vsm, [&](int ks, int nt) {
          const float* br = os_ + (32 * qh + 8 * nt + g) * kS + 8 * ks + t;
          return make_float2(br[0], br[4]);
        });
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = 16 * warp + g + 8 * (e >> 1);
            const int ii = 32 * qh + 8 * nt + 2 * t + (e & 1);
            const int i = i0 + ii, j = j0 + jj;
            float pz = 0.f, gv = 0.f;
            if (j < lim) {  // rows past L: 1 / l = 0
              const float sv =
                  st[nt][e] + qbias[ii * kQB + ii - jj + kTile - 1];
              const float p = ex2(fmaf(sv, cl2, -ms[ii])) * ls[ii];
              const float zv = drop.z(bh, i, j);
              pz = p * zv;
              gv = scale * p * (zv * dpt[nt][e] - ds[ii]);
              if (kBf16) {  // JAX's rounded Pd and dS
                pz = bf16s::rounded(pz);
                gv = bf16s::rounded(gv);
              }
            }
            st[nt][e] = pz;
            dpt[nt][e] = gv;
          }
        pair_product<4, kK, kBf16>(
            dva,
            [&](int nt, float(&a)[4]) {
              a[0] = st[nt][0];
              a[1] = st[nt][2];
              a[2] = st[nt][1];
              a[3] = st[nt][3];
            },
            [&](int nt, int nn) {
              const float* br =
                  os_ + (32 * qh + 8 * nt + 2 * t) * kS + 8 * nn + g;
              return make_float2(br[0], br[kS]);
            });
        pair_product<4, kK, kBf16>(
            dka,
            [&](int nt, float(&a)[4]) {
              a[0] = dpt[nt][0];
              a[1] = dpt[nt][2];
              a[2] = dpt[nt][1];
              a[3] = dpt[nt][3];
            },
            [&](int nt, int nn) {
              const float* br =
                  qs_ + (32 * qh + 8 * nt + 2 * t) * kS + 8 * nn + g;
              return make_float2(br[0], br[kS]);
            });
      }
    }
  }
  float* dkz = z ? scratch.dk1 : kBf16 ? scratch.dk0 : dk;
  float* dvz = z ? scratch.dv1 : kBf16 ? scratch.dv0 : dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = jw + g + 8 * h;
    if (j < L)
#pragma unroll
      for (int nn = 0; nn < kK; ++nn) {
        const size_t off = head + (size_t)j * D + 8 * nn + 2 * t;
        *reinterpret_cast<float2*>(dkz + off) =
            make_float2(dka[nn][2 * h], dka[nn][2 * h + 1]);
        *reinterpret_cast<float2*>(dvz + off) =
            make_float2(dva[nn][2 * h], dva[nn][2 * h + 1]);
      }
  }
}

// Launch 3.  dtable[r][c]: the frames' partials of the relative offsets
// that row r gathers (rel = r - maxlen; every rel <= -maxlen at r = 0,
// every rel >= maxlen - 1 at the last row), over bh and query tiles.  A block per table row: thread (part, c) sums the partials of
// bh = part, part + kParts, ..., and the parts are added in their order.
// The blocks also complete dk and dv (their two halves, in order).
// The bfloat16 instance (Out = __nv_bfloat16) stores dk, dv (the sums of
// the scratch halves) and dtable rounded.
constexpr int kParts = 16;
template <int D, class Out = float>
__global__ void __launch_bounds__(kParts * D)
attn_train_bwd_table_kernel(Scratch scratch, Out* __restrict__ dtable,
                            Out* __restrict__ dk, Out* __restrict__ dv,
                            int BH, int L, int maxlen) {
  __shared__ float parts[kParts * D];
  const size_t n = (size_t)BH * L * D;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    if constexpr (std::is_same<Out, float>::value) {
      dk[e] += scratch.dk1[e];
      dv[e] += scratch.dv1[e];
    } else {
      dk[e] = __float2bfloat16_rn(scratch.dk0[e] + scratch.dk1[e]);
      dv[e] = __float2bfloat16_rn(scratch.dv0[e] + scratch.dv1[e]);
    }
  }
  const int r = blockIdx.x, c = threadIdx.x % D, part = threadIdx.x / D;
  const int nqt = (L + kTile - 1) / kTile, lk = nqt * kTile;
  const int nframe = frame_rows(L);
  int lo = r - maxlen, hi = r - maxlen;
  if (r == 0) lo = -(L - 1);
  if (r == 2 * maxlen - 1) hi = L - 1;
  lo = max(lo, -(L - 1));
  hi = min(hi, L - 1);
  float sum = 0.f;
  for (int rel = lo; rel <= hi; ++rel)
    for (int bh = part; bh < BH; bh += kParts)
      for (int qt = 0; qt < nqt; ++qt) {
        const int fr = rel - (qt * kTile - lk + 1);
        if (fr >= 0 && fr < nframe)
          sum += scratch.frames[(((size_t)bh * nqt + qt) * nframe + fr) * D +
                                c];
      }
  parts[threadIdx.x] = sum;
  __syncthreads();
  if (part == 0) {
    float total = 0.f;
#pragma unroll
    for (int x = 0; x < kParts; ++x) total += parts[x * D + c];
    dtable[(size_t)r * D + c] = bf16s::from_f<Out>(total);
  }
}

}  // namespace bwd

Drop make_drop(unsigned seed_word, unsigned threshold, float keep_scale,
               int block) {
  Drop d;
  d.seed_word = seed_word;
  d.threshold = threshold;
  d.scale = keep_scale;
  d.block = block;
  d.on = threshold > 0;
  return d;
}

bool bad_args(int BH, int L, int H, int D, int maxlen, int block) {
  return H <= 0 || BH % H || BH > 65535 || L > 512 || maxlen <= 0 ||
         block < L || (D != 16 && D != 32);
}

// a kernel's dynamic shared memory up to `bytes`, with the SM's whole
// carveout as shared memory
template <class Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// K13's launch: SPLIT warps per row tile, on the grid (L / 64, B*H); the
// float32 instance or (kBf16) the bfloat16 one.
template <int D, int SPLIT, bool kBf16 = false>
cudaError_t launch_fwd(const relpos_flash::Args& a, int BH,
                       cudaStream_t stream) {
  using S = relpos_flash::Shape<SPLIT, D>;
  auto kernel = kBf16 ? attn_train_fwd_bf16_kernel<D, SPLIT>
                      : attn_train_fwd_kernel<D, SPLIT>;
  const cudaError_t err = set_smem(kernel, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.L + relpos_flash::kRows - 1) / relpos_flash::kRows, BH);
  kernel<<<grid, S::kThreads, S::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// The warps per row tile K13 takes at head width D: the largest SPLIT
// whose grid fits the card in one wave at the blocks per SM its shared
// memory allows, and no more than the rows' key tiles, so that no warp
// idles (2 at L 125, 1 at L 63).  At D 16 every SPLIT holds 16 warps per
// SM (4 / SPLIT blocks), so this puts the most warps in flight: 4 where
// the grid has at most one block per SM, 2 where it has at most two
// ([4, 8, 500, 16]: 256 blocks), else 1.  At D 32 SPLIT 2 and 4 hold one
// block per SM and SPLIT 1 two: 4 where the grid has at most one block
// per SM ([2, 8, 500, 32]: 128 blocks), else 1.  PERF.md §6 holds the
// timings.
template <int D>
int split_for(int BH, int L) {
  static int sms = 0;  // the card's SMs, read at the first launch (a
                       // failed query shows in the launch's error)
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long blocks =
      (long long)(L + relpos_flash::kRows - 1) / relpos_flash::kRows * BH;
  const int tiles = (L + relpos_flash::kKeys - 1) / relpos_flash::kKeys;
  const long long per4 = relpos_flash::Shape<4, D>::kMinBlocks,
                  per2 = relpos_flash::Shape<2, D>::kMinBlocks;
  const int fit = blocks <= per4 * sms ? 4 : blocks <= per2 * sms ? 2 : 1;
  return min(fit, tiles >= 4 ? 4 : tiles >= 2 ? 2 : 1);
}

// K13 at head width D and `split` warps per row tile (0: split_for's;
// the bfloat16 instances' shared memory is the float32 ones', so the
// rule is the same)
template <int D, bool kBf16 = false>
cudaError_t launch_fwd_at(const relpos_flash::Args& a, int BH, int split,
                          cudaStream_t stream) {
  switch (split ? split : split_for<D>(BH, a.L)) {
    case 4: return launch_fwd<D, 4, kBf16>(a, BH, stream);
    case 2: return launch_fwd<D, 2, kBf16>(a, BH, stream);
    default: return launch_fwd<D, 1, kBf16>(a, BH, stream);
  }
}

template <int D, int SPLIT>
cudaError_t fwd_occupancy(int* o) {
  using S = relpos_flash::Shape<SPLIT, D>;
  cudaFuncAttributes attr;
  cudaError_t err = set_smem(attn_train_fwd_kernel<D, SPLIT>, S::kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, attn_train_fwd_kernel<D, SPLIT>);
  if (err != cudaSuccess) return err;
  o[1] = attr.numRegs;
  o[2] = (int)attr.localSizeBytes;
  o[3] = S::kWarps;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      o, attn_train_fwd_kernel<D, SPLIT>, S::kThreads, S::kSmemBytes);
}

template <int D>
cudaError_t fwd_occupancy_all(int BH, int L, int* o) {
  o[0] = split_for<D>(BH, L);
  cudaError_t err = fwd_occupancy<D, 1>(o + 1);
  if (err == cudaSuccess) err = fwd_occupancy<D, 2>(o + 5);
  if (err == cudaSuccess) err = fwd_occupancy<D, 4>(o + 9);
  return err;
}

// K14's three launches at head width D, for In = float or bfloat16 (q, k,
// v, table, dout and the four gradients; out is then out32)
template <int D, class In>
cudaError_t launch_bwd(const In* q, const In* k, const In* v,
                       const In* table, const int* lens, const float* out,
                       const In* dout, const float* row_max,
                       const float* row_sum, In* dq, In* dk, In* dv,
                       In* dtable, bwd::Scratch sc, int BH, int L, int H,
                       int maxlen, float scale, Drop drop,
                       cudaStream_t st) {
  using M = bwd::Dims<D>;
  constexpr bool kBf16 = !std::is_same<In, float>::value;
  const int nt = (L + kTile - 1) / kTile;
  const size_t dq_smem = sizeof(float) * (size_t)M::kDqFloats;
  cudaError_t err = set_smem(bwd::attn_train_bwd_dq_kernel<D, In>, dq_smem);
  if (err != cudaSuccess) return err;
  bwd::attn_train_bwd_dq_kernel<D, In>
      <<<dim3(nt, BH), bwd::kThreads, dq_smem, st>>>(
          q, k, v, table, lens, out, dout, row_max, row_sum, dq, sc, L, H,
          maxlen, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // (the bfloat16 instance writes both halves of dk and dv to scratch)
  float* dk32 = kBf16 ? sc.dk0 : reinterpret_cast<float*>(dk);
  float* dv32 = kBf16 ? sc.dv0 : reinterpret_cast<float*>(dv);
  const size_t dkv_smem = sizeof(float) * (size_t)M::kKvFloats;
  err = set_smem(bwd::attn_train_bwd_dkv_kernel<D, In>, dkv_smem);
  if (err != cudaSuccess) return err;
  bwd::attn_train_bwd_dkv_kernel<D, In>
      <<<dim3(nt, BH, 2), bwd::kThreads, dkv_smem, st>>>(
          q, k, v, table, lens, dout, row_max, row_sum, dk32, dv32, sc, L,
          H, maxlen, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  bwd::attn_train_bwd_table_kernel<D, In>
      <<<2 * maxlen, bwd::kParts * D, 0, st>>>(sc, dtable, dk, dv, BH, L,
                                               maxlen);
  return cudaGetLastError();
}

// The Args of a K13 launch.
relpos_flash::Args fwd_args(const void* q, const void* k, const void* v,
                            const void* table, const void* lens, void* out,
                            void* row_max, void* row_sum, void* out32, int L,
                            int H, int D, int maxlen, int block,
                            unsigned seed_word, unsigned threshold,
                            float keep_scale) {
  relpos_flash::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.table = static_cast<const float*>(table);
  a.lens = static_cast<const int*>(lens);
  a.out = static_cast<float*>(out);
  a.row_max = static_cast<float*>(row_max);
  a.row_sum = static_cast<float*>(row_sum);
  a.out32 = static_cast<float*>(out32);
  a.L = L;
  a.H = H;
  a.maxlen = maxlen;
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  a.seed_word = seed_word;
  a.threshold8 = threshold << 8;       // threshold < 2^24
  a.keep_scale = keep_scale;
  a.block = block;
  return a;
}

// K14 at head width D for In = float or bfloat16: the scratch carved up
// and the three launches.
template <class In>
int run_bwd(const void* q, const void* k, const void* v, const void* table,
            const void* lens, const void* out, const void* dout,
            const void* row_max, const void* row_sum, void* dq, void* dk,
            void* dv, void* dtable, void* scratch, int BH, int L, int H,
            int D, int maxlen, int block, unsigned seed_word,
            unsigned threshold, float keep_scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const Drop drop = make_drop(seed_word, threshold, keep_scale, block);
  const float scale = 1.0f / sqrtf((float)D);
  const size_t rows = (size_t)BH * L;
  bwd::Scratch sc;
  sc.delta = static_cast<float*>(scratch);
  sc.dk1 = sc.delta + rows;
  sc.dv1 = sc.dk1 + rows * D;
  sc.frames = sc.dv1 + rows * D;
  const long long nqt = (L + kTile - 1) / kTile;
  sc.dk0 = sc.frames + BH * nqt * bwd::frame_rows(L) * D;  // bfloat16 only
  sc.dv0 = sc.dk0 + rows * D;
  auto i = [](const void* p) { return static_cast<const In*>(p); };
  auto o = [](void* p) { return static_cast<In*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int* kl = static_cast<const int*>(lens);
  return (int)(D == 32
                   ? launch_bwd<32>(i(q), i(k), i(v), i(table), kl, f(out),
                                    i(dout), f(row_max), f(row_sum), o(dq),
                                    o(dk), o(dv), o(dtable), sc, BH, L, H,
                                    maxlen, scale, drop, st)
                   : launch_bwd<16>(i(q), i(k), i(v), i(table), kl, f(out),
                                    i(dout), f(row_max), f(row_sum), o(dq),
                                    o(dk), o(dv), o(dtable), sc, BH, L, H,
                                    maxlen, scale, drop, st));
}

}  // namespace

// K13.  q, k, v, out: device float32 [B*H, L, D] (16-byte aligned), D the
// head width, 16 or 32; table [2*maxlen, D]; lens: device int32 [B], each
// in [1, L]; row_max, row_sum: [B*H, L].  block: the hash row stride
// (pick_block(L)); threshold 0 turns the dropout off.  split: the warps
// per row tile (1, 2 or 4), or 0 for split_for's.
extern "C" int sep_attn_train_fwd_f32(const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* lens, void* out,
                                      void* row_max, void* row_sum, int BH,
                                      int L, int H, int D, int maxlen,
                                      int block, unsigned seed_word,
                                      unsigned threshold, float keep_scale,
                                      int split, void* stream) {
  if (BH <= 0 || L <= 0) return 0;
  if (bad_args(BH, L, H, D, maxlen, block) ||
      (split != 0 && split != 1 && split != 2 && split != 4))
    return (int)cudaErrorInvalidValue;
  const relpos_flash::Args a =
      fwd_args(q, k, v, table, lens, out, row_max, row_sum, nullptr, L, H, D,
               maxlen, block, seed_word, threshold, keep_scale);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(D == 32 ? launch_fwd_at<32>(a, BH, split, st)
                       : launch_fwd_at<16>(a, BH, split, st));
}

// K13's bfloat16 instance: q, k, v, table and out bfloat16 (16-byte
// aligned); out32 [B*H, L, D] float32, the P·V of the unrounded weights;
// the rest as sep_attn_train_fwd_f32's.
extern "C" int sep_attn_train_fwd_bf16(const void* q, const void* k,
                                       const void* v, const void* table,
                                       const void* lens, void* out,
                                       void* out32, void* row_max,
                                       void* row_sum, int BH, int L, int H,
                                       int D, int maxlen, int block,
                                       unsigned seed_word,
                                       unsigned threshold, float keep_scale,
                                       int split, void* stream) {
  if (BH <= 0 || L <= 0) return 0;
  if (bad_args(BH, L, H, D, maxlen, block) ||
      (split != 0 && split != 1 && split != 2 && split != 4))
    return (int)cudaErrorInvalidValue;
  const relpos_flash::Args a =
      fwd_args(q, k, v, table, lens, out, row_max, row_sum, out32, L, H, D,
               maxlen, block, seed_word, threshold, keep_scale);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(D == 32 ? launch_fwd_at<32, true>(a, BH, split, st)
                       : launch_fwd_at<16, true>(a, BH, split, st));
}

// K13's split at (BH, L) and head width D into o[0], then its blocks per
// SM, registers, local (spill) bytes and warps per block at SPLIT 1, 2
// and 4 into o[1 .. 12].
extern "C" int sep_attn_train_fwd_occupancy(int BH, int L, int D, int* o) {
  if (D != 16 && D != 32) return (int)cudaErrorInvalidValue;
  return (int)(D == 32 ? fwd_occupancy_all<32>(BH, L, o)
                       : fwd_occupancy_all<16>(BH, L, o));
}

// floats of K14's scratch (bwd::Scratch) at head width D: delta [B*H, L],
// the dk/dv launch's second halves of dk and dv, the dq launch's frames of
// band sums
extern "C" long long sep_attn_train_bwd_scratch_floats(int BH, int L,
                                                       int D) {
  const long long nqt = (L + kTile - 1) / kTile, rows = (long long)BH * L;
  return rows + 2 * rows * D + BH * nqt * bwd::frame_rows(L) * D;
}

// ... and of its bfloat16 instance's: the first halves of dk and dv too
extern "C" long long sep_attn_train_bwd_bf16_scratch_floats(int BH, int L,
                                                            int D) {
  return sep_attn_train_bwd_scratch_floats(BH, L, D) +
         2 * (long long)BH * L * D;
}

// K14.  As K13, plus out and dout [B*H, L, D]; dq, dk, dv [B*H, L, D];
// dtable [2*maxlen, D]; scratch of sep_attn_train_bwd_scratch_floats.
extern "C" int sep_attn_train_bwd_f32(
    const void* q, const void* k, const void* v, const void* table,
    const void* lens, const void* out, const void* dout, const void* row_max,
    const void* row_sum, void* dq, void* dk, void* dv, void* dtable,
    void* scratch, long long scratch_floats, int BH, int L, int H, int D,
    int maxlen, int block, unsigned seed_word, unsigned threshold,
    float keep_scale, void* stream) {
  if (bad_args(BH, L, H, D, maxlen, block) || BH <= 0 || L <= 0 ||
      scratch_floats < sep_attn_train_bwd_scratch_floats(BH, L, D))
    return (int)cudaErrorInvalidValue;
  return run_bwd<float>(q, k, v, table, lens, out, dout, row_max, row_sum,
                        dq, dk, dv, dtable, scratch, BH, L, H, D, maxlen,
                        block, seed_word, threshold, keep_scale, stream);
}

// K14's bfloat16 instance: q, k, v, table, dout, dq, dk, dv and dtable
// bfloat16 (16-byte aligned); out is K13's float32 out32; scratch of
// sep_attn_train_bwd_bf16_scratch_floats.
extern "C" int sep_attn_train_bwd_bf16(
    const void* q, const void* k, const void* v, const void* table,
    const void* lens, const void* out32, const void* dout,
    const void* row_max, const void* row_sum, void* dq, void* dk, void* dv,
    void* dtable, void* scratch, long long scratch_floats, int BH, int L,
    int H, int D, int maxlen, int block, unsigned seed_word,
    unsigned threshold, float keep_scale, void* stream) {
  if (bad_args(BH, L, H, D, maxlen, block) || BH <= 0 || L <= 0 ||
      scratch_floats < sep_attn_train_bwd_bf16_scratch_floats(BH, L, D))
    return (int)cudaErrorInvalidValue;
  return run_bwd<__nv_bfloat16>(q, k, v, table, lens, out32, dout, row_max,
                                row_sum, dq, dk, dv, dtable, scratch, BH, L,
                                H, D, maxlen, block, seed_word, threshold,
                                keep_scale, stream);
}
