// GCFN with hash dropout for training: forward (K7) and backward (K8).
//
//   out = x + ls * drop1(g @ wout + bout),
//   g   = drop0(GLU(dw3(LN(x) @ win + bin))),
// drop_s(v) = v * keep(seed, s, b*T + t, col) / (1 - p), the hash of
// hash_dropout.cuh; the k3 conv zero-pads u at each batch row's edges.
//
// Replaces: sepreformer_tpu/ops/pallas/gcfn_train.py::fused_gcfn_train,
//           forward _fwd_train_impl (body _fwd_train_kernel) and backward
//           _bwd_train_impl (body _bwd_train_kernel).
//
// What bounds them on the H100: per row, K7 does the two products of K1
// (2*F*6F + 2*3F*F = 295 kflop at F=128) and K8 recomputes them and adds
// four of the same sizes (dg = do0 wout^T, dWout = g^T do0, dWin = xn^T du,
// dxn = du win^T): 885 kflop.  Both run their products on the tensor cores
// at float32 accuracy (3xTF32, mma_tf32x3.cuh): K7 9.4e9 operations at
// 165 TFLOP/s, 0.057 ms at [4, 8000, 128]; K8 2.8e10, 0.17 ms, against
// 66 MB of traffic and the scratch round trip below.  At Large's F=256
// the products per row grow fourfold (0.229 and 0.686 ms at
// [4, 8000, 256]) and the bytes twofold.
//
// K7 is K1's tile (gcfn_tile_mma.cuh: 62-row tiles, the hidden width in
// chunks of staged weights) with no length mask and the two dropout
// sites; two instances, F=128 at two blocks per SM and F=256 at one, as
// K1's.
//
// K8 keeps what JAX's backward keeps (x, the parameters, the seed) and
// recomputes the rest, in three hand-written kernels:
//  1. rows: one block of F/16 warps (8 at F=128, 16 at F=256; each warp
//     owns 16 columns of F and 8 of a chunk's GLU pairs, so a thread's
//     accumulators and its 128 registers are the same at both widths)
//     walks a fixed run of tiles of TT = 28 rows.  Per
//     tile it recomputes LN for the rows t0-2 .. t0+TT+1 (the transpose
//     conv needs dy one row past each side, and dy there needs y, which
//     needs u one row further: 32 rows, two m16 fragments) and do0 for
//     t0-1 .. t0+TT, then walks the 6F hidden columns in six chunks of
//     F/2 GLU pairs (columns c and c + 3F together, since the k3 conv and
//     the GLU are per column): u, y and the dropout masks, g, dg, dy, du
//     and the chunk's small gradients, with the chunk's four products on
//     the tensor cores (u = xn win_c, o0 += g_c wout_c, dg_c = do0 wout_c^T,
//     dxn += du_c win_c^T; each warp owns fixed fragments, B read from L2
//     as the fragments need it).  o0 (for dls) and dxn stay in registers
//     across the chunks; then the LayerNorm backward (x-hat recomputed
//     from x) writes dx.  The sums over rows of the small gradients (LN
//     scale and bias, b_in, the k3 weight and bias, b_out, ls) stay in
//     shared memory across the block's tiles, each column owned by one
//     thread; it writes them once per block.  It also writes xn, du, g
//     and do0 for the two weight products.
//  2. atb: dWin = xn^T du and dWout = g^T do0 as 64x64 output tiles on the
//     tensor cores over a fixed split of the rows, 32 rows at a time
//     double-buffered with cp.async, each split's partial written apart.
//  3. reduce: the partials of each split (or block) added in a fixed order.
// No atomics: two runs give the same bits.
//
// The bfloat16 instances (x, out, dout and dx bfloat16, the parameters
// and their nine gradients float32) take the JAX kernels' rounding steps
// (gcfn_train.py:557-559, :606-608): K7 is K1's bfloat16 tile with the
// drops (g rounded after its drop); K8's row pass (In = __nv_bfloat16)
// rounds xn, g, do0 and du as the JAX kernel casts them for its
// products, and takes each product as one TF32 mma.sync on those exact
// values (bf16s::warp_product; do0 rounded as the dg product reads it,
// since its float32 rows also give db_out), with float32 statistics,
// conv, GLU, masks and LayerNorm backward; it writes xn, du, g and do0
// rounded, so the weight products take one TF32 product too
// (gcfn_train_bwd_atb_kernel<true>).  Same tiles, shared memory and
// blocks per SM as the float32 instances.  The launcher picks the
// partition from B and T (BwdPartition): at most one wave of blocks of
// pass 1 (two per SM at F=128, 105 KB each; one at F=256, whose 16 warps
// take 205 KB) and kMaxSplits row splits, so the partial buffers,
// [blocks, 34F] and [splits, 9F^2] floats, stay at 5 MB and 19 MB at
// [4, 8000, 128] (4 and 75 MB at F=256).  The caller sizes its one
// scratch buffer with sep_gcfn_train_bwd_scratch_floats.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <stdint.h>
#include <type_traits>

#include "gcfn_tile_mma.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int kReduceThreads = 256;  // K8's reduce blocks
constexpr int kBwdTT = 28;       // K8 rows per tile: TT + 4 = 32 u rows
constexpr int kSMs = 132;        // H100 SXM: K8's row pass fills one wave
constexpr int kMaxSplits = 32;   // K8: at most this many row splits of the
                                 // weight products

template <int F>
__global__ void __launch_bounds__(gcfn_mma::kThreads,
                                  gcfn_mma::Shape<F>::blocks_per_sm)
gcfn_train_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ lns,
                      const float* __restrict__ lnb,
                      const float* __restrict__ win,
                      const float* __restrict__ bin,
                      const float* __restrict__ wdw,
                      const float* __restrict__ bdw,
                      const float* __restrict__ wout,
                      const float* __restrict__ bout,
                      const float* __restrict__ ls, float* __restrict__ out,
                      int T, float eps, GcfnDrop drop) {
  extern __shared__ __align__(16) float smem[];
  gcfn_mma::tile<F, true>(smem, x, nullptr, lns, lnb, win, bin, wdw, bdw,
                          wout, bout, ls, out, T, eps, drop);
}

// K7's bfloat16 instance: x and out bfloat16, the parameters float32.
template <int F>
__global__ void __launch_bounds__(gcfn_mma::kThreads,
                                  gcfn_mma::Shape<F>::blocks_per_sm)
gcfn_train_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ lns,
                           const float* __restrict__ lnb,
                           const float* __restrict__ win,
                           const float* __restrict__ bin,
                           const float* __restrict__ wdw,
                           const float* __restrict__ bdw,
                           const float* __restrict__ wout,
                           const float* __restrict__ bout,
                           const float* __restrict__ ls,
                           __nv_bfloat16* __restrict__ out, int T, float eps,
                           GcfnDrop drop) {
  extern __shared__ __align__(16) float smem[];
  gcfn_mma::tile<F, true, false, __nv_bfloat16>(
      smem, x, nullptr, lns, lnb, win, bin, wdw, bdw, wout, bout, ls, out, T,
      eps, drop);
}

using tf32x3::frag_col;
using tf32x3::frag_row;

// A product of K8's row pass: 3xTF32 for float32 streams, one TF32
// product on bfloat16-exact operands for bfloat16 ones (A already
// rounded, or rounded as it is read with kRoundA; B rounded as it is
// read).
template <bool kBf16, bool kRoundA = false, int MT, int NT, int KS,
          class BFrag>
__device__ __forceinline__ void warp_product(float (&acc)[MT][NT][4],
                                             const float* A, int lda,
                                             BFrag bfrag) {
  if constexpr (kBf16)
    bf16s::warp_product<MT, NT, KS, kRoundA>(acc, A, lda, bfrag);
  else
    tf32x3::warp_product<MT, NT, KS>(acc, A, lda, bfrag);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// Offsets of the small gradients in a block's partial sums.
template <int F>
struct Small {
  static constexpr int H6 = 6 * F;
  static constexpr int lns = 0, lnb = F, bin = 2 * F, wdw = 2 * F + H6,
                       bdw = 2 * F + 4 * H6, bout = 2 * F + 5 * H6,
                       ls = 3 * F + 5 * H6, size = 4 * F + 5 * H6;
};

// K8's row tile: TT rows, a block of F/16 warps, a hidden chunk of
// NC = 2 CH = F columns (CH GLU pairs), and the shared-memory layout in
// floats.
template <int F>
struct BwdShape {
  static constexpr int kWarps = F / 16, kThreads = 32 * kWarps;
  static constexpr int TT = kBwdTT, R4 = TT + 4, R2 = TT + 2;
  static constexpr int H6 = 6 * F, H3 = 3 * F, CH = 8 * kWarps, NC = 2 * CH;
  static constexpr int chunks = H3 / CH;
  // row strides = 8 mod 32 floats (conflict-free A fragment loads)
  static constexpr int LX = F + 8, LU = NC + 8, LG = CH + 8;
  static constexpr int xn = 0, d0 = xn + R4 * LX, u = d0 + 32 * LX,
                       y = u + (R4 + 2) * LU, gc = y + R2 * LU,
                       dgc = gc + 32 * LG, small = dgc + 32 * LG,
                       floats = small + Small<F>::size;
  static constexpr size_t smem_bytes = sizeof(float) * (size_t)floats;
  // Blocks per SM, of an SM's 228 KB with 1 KB reserved per block: two at
  // F = 128 (105 KB), one at F = 256 (205 KB); at most one wave of them.
  static constexpr int blocks_per_sm = smem_bytes <= 113 * 1024 ? 2 : 1;
  static constexpr int row_groups = kSMs * blocks_per_sm;
  static_assert(R4 == 32 && H3 % CH == 0 && NC == F && kThreads == 2 * F,
                "two m16 fragments of rows; a warp owns 16 columns of F "
                "and 8 of a chunk's GLU pairs; a thread per column of the "
                "two small sums of steps 4 and 5");
  static_assert(smem_bytes <= 227 * 1024, "at least one block per SM");
  static_assert(TT <= R2, "o0 and dxn of the tile rows fit u and y");
};

// Hidden column of a chunk's local column j: the first CH are GLU values
// c*CH + j, the next CH their gates 3F + c*CH + j - CH.
template <int F>
__device__ __forceinline__ int hidden_col(int c, int j) {
  constexpr int CH = BwdShape<F>::CH;
  return c * CH + j + (j < CH ? 0 : 3 * F - CH);
}

template <int F, class In>
__global__ void __launch_bounds__(BwdShape<F>::kThreads,
                                  BwdShape<F>::blocks_per_sm)
gcfn_train_bwd_rows_kernel(
    const In* __restrict__ x, const In* __restrict__ dout,
    const float* __restrict__ lns, const float* __restrict__ lnb,
    const float* __restrict__ win, const float* __restrict__ bin,
    const float* __restrict__ wdw, const float* __restrict__ bdw,
    const float* __restrict__ wout, const float* __restrict__ bout,
    const float* __restrict__ ls, In* __restrict__ dx,
    float* __restrict__ xn_g, float* __restrict__ du_g,
    float* __restrict__ g_g, float* __restrict__ do0_g,
    float* __restrict__ partial, int B, int T, float eps, GcfnDrop drop) {
  using S = BwdShape<F>;
  using P = Small<F>;
  constexpr int TT = S::TT, R4 = S::R4, R2 = S::R2, H6 = S::H6, H3 = S::H3,
                CH = S::CH, NC = S::NC, LX = S::LX, LU = S::LU, LG = S::LG;
  constexpr int kThreads = S::kThreads, kWarps = S::kWarps;
  // bfloat16: every product operand rounded where the JAX kernel rounds
  // it (gcfn_train.py:453-517), the rest float32
  constexpr bool kBf16 = !std::is_same<In, float>::value;
  auto rnd = [](float v) { return kBf16 ? bf16s::rounded(v) : v; };
  using bf16s::to_f;
  extern __shared__ __align__(16) float smem[];
  float* xn = smem + S::xn;    // [R4][LX] LN rows t0-2 .. t0+TT+1
  float* d0 = smem + S::d0;    // [32][LX] do0 rows t0-1 .. t0+TT, rows R2..
                               // zero; at the end x-hat of the tile rows
  float* u = smem + S::u;      // [R4+2][LU] the chunk's u rows t0-2 ..
                               // (rows R4.. zero); then du of row t0+i at
                               // row i+2; at the end o0 of the tile rows
  float* y = smem + S::y;      // [R2][LU] the chunk's y rows t0-1 ..; then
                               // dy; at the end dxn of the tile rows
  float* gc = smem + S::gc;    // [32][LG] the chunk's g, tile rows (rows
                               // TT.. zero)
  float* dgc = smem + S::dgc;  // [32][LG] the chunk's dg rows t0-1 ..
  float* acc = smem + S::small;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tiles_per_row = (T + TT - 1) / TT;
  const int tiles = B * tiles_per_row;
  const int tile_begin = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int tile_end = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
  for (int e = tid; e < P::size; e += kThreads) acc[e] = 0.f;
  // the fragments' padding rows, which no step writes
  for (int e = tid; e < (32 - R2) * LX; e += kThreads) d0[R2 * LX + e] = 0.f;
  for (int e = tid; e < 2 * LU; e += kThreads) u[R4 * LU + e] = 0.f;
  for (int e = tid; e < (32 - TT) * LG; e += kThreads) gc[TT * LG + e] = 0.f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int b = tile / tiles_per_row;
    const int t0 = (tile - b * tiles_per_row) * TT;
    const size_t base = (size_t)b * T;  // global row of t = 0
    __syncthreads();  // the previous tile's last reads are done

    // 1. LayerNorm of rows t0-2 .. t0+TT+1, one warp per row; the tile
    //    rows write xn.
    for (int r = warp; r < R4; r += kWarps) {
      const int t = t0 - 2 + r;
      const bool main = r >= 2 && r < TT + 2;
      float* dst = xn + r * LX;
      if (t < 0 || t >= T) {
        for (int k = lane; k < F; k += 32) dst[k] = 0.f;
        continue;
      }
      const In* src = x + (base + t) * F;
      float v[F / 32];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        v[q] = to_f(src[lane + 32 * q]);
        s += v[q];
      }
      const float mean = gcfn_mma::warp_sum(s) * (1.f / F);
      float s2 = 0.f;
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        v[q] -= mean;
        s2 += v[q] * v[q];
      }
      const float iv = rsqrtf(gcfn_mma::warp_sum(s2) * (1.f / F) + eps);
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        const int k = lane + 32 * q;
        const float n = rnd(v[q] * iv * lns[k] + lnb[k]);
        dst[k] = n;
        if (main) xn_g[(base + t) * F + k] = n;
      }
    }
    // 2. do0 = dout * ls * m1 / (1-p) for rows t0-1 .. t0+TT (zero outside
    //    [0, T)).
    for (int e = tid; e < R2 * F; e += kThreads) {
      const int i = e / F, f = e - i * F, t = t0 - 1 + i;
      float v = 0.f;
      if (t >= 0 && t < T) {
        const size_t gr = base + t;
        v = sep_keep(drop.seed1, (uint32_t)gr, (uint32_t)f, drop.threshold)
                ? to_f(dout[gr * F + f]) * ls[f] * drop.scale
                : 0.f;
        // d0 keeps the float32 do0 (its sum is db_out); the products
        // read it rounded
        if (i >= 1 && i <= TT) do0_g[gr * F + f] = rnd(v);
      }
      d0[i * LX + f] = v;
    }
    // this warp's fragments of o0 = g wout and dxn = du win^T: rows 0..31,
    // columns 16 warp .. 16 warp + 15
    float o0[2][2][4], dxn[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o0[mt][nt][e] = dxn[mt][nt][e] = 0.f;
    __syncthreads();

    for (int c = 0; c < S::chunks; ++c) {
      // a. u = xn win_c + bin; rows outside [0, T) are the conv's zero pad.
      //    This warp: local columns 16 warp .. 16 warp + 15.
      {
        float a[2][2][4] = {};
        warp_product<kBf16, false, 2, 2, F / 8>(a, xn, LX, [&](int ks,
                                                               int nt) {
          const float* w = win + (size_t)(8 * ks + 2 * t4) * H6 +
                           hidden_col<F>(c, 16 * warp + 8 * nt + g8);
          return make_float2(w[0], w[H6]);
        });
        __syncthreads();  // the previous chunk's dxn product has read u
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 16 * mt + frag_row(e), t = t0 - 2 + r;
              const int j = 16 * warp + 8 * nt + frag_col(e);
              u[r * LU + j] = (t >= 0 && t < T)
                                  ? a[mt][nt][e] + bin[hidden_col<F>(c, j)]
                                  : 0.f;
            }
      }
      __syncthreads();

      // b. y = dw3(u) for rows t0-1 .. t0+TT.
      for (int e = tid; e < R2 * NC; e += kThreads) {
        const int i = e / NC, j = e - i * NC, hj = hidden_col<F>(c, j);
        const float* w = wdw + 3 * hj;
        y[i * LU + j] = u[i * LU + j] * w[0] + u[(i + 1) * LU + j] * w[1] +
                        u[(i + 2) * LU + j] * w[2] + bdw[hj];
      }
      __syncthreads();

      // c. g = drop0(GLU(y)) for the tile rows (zero past T); written out.
      for (int e = tid; e < TT * CH; e += kThreads) {
        const int i = e / CH, cl = e - i * CH, t = t0 + i, col = c * CH + cl;
        float v = 0.f;
        if (t < T) {
          const size_t gr = base + t;
          const float* yr = y + (i + 1) * LU;
          v = sep_keep(drop.seed0, (uint32_t)gr, (uint32_t)col,
                       drop.threshold)
                  ? yr[cl] * sigmoid(yr[CH + cl]) * drop.scale
                  : 0.f;
          v = rnd(v);
          g_g[gr * H3 + col] = v;
        }
        gc[i * LG + cl] = v;
      }
      __syncthreads();

      // d. o0 += g_c wout_c (wout rows c*CH ..); dg_c = do0 wout_c^T, this
      //    warp's 8 GLU pairs.
      warp_product<kBf16, false, 2, 2, CH / 8>(o0, gc, LG, [&](int ks,
                                                                int nt) {
        const float* w = wout + (size_t)(c * CH + 8 * ks + 2 * t4) * F +
                         16 * warp + 8 * nt + g8;
        return make_float2(w[0], w[F]);
      });
      {
        float a[2][1][4] = {};
        warp_product<kBf16, true, 2, 1, F / 8>(a, d0, LX, [&](int ks, int) {
          return *reinterpret_cast<const float2*>(
              wout + (size_t)(c * CH + 8 * warp + g8) * F + 8 * ks + 2 * t4);
        });
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dgc[(16 * mt + frag_row(e)) * LG + 8 * warp + frag_col(e)] =
                a[mt][0][e];
      }
      __syncthreads();

      // e. dy through the GLU with m0, in place of y; zero outside [0, T).
      for (int e = tid; e < R2 * CH; e += kThreads) {
        const int i = e / CH, cl = e - i * CH, t = t0 - 1 + i;
        float* yr = y + i * LU;
        float da = 0.f, db = 0.f;
        if (t >= 0 && t < T) {
          const size_t gr = base + t;
          if (sep_keep(drop.seed0, (uint32_t)gr, (uint32_t)(c * CH + cl),
                       drop.threshold)) {
            const float dg0 = dgc[i * LG + cl] * drop.scale;
            const float a = yr[cl], sg = sigmoid(yr[CH + cl]);
            da = dg0 * sg;
            db = dg0 * a * sg * (1.f - sg);
          }
        }
        yr[cl] = da;
        yr[CH + cl] = db;
      }
      __syncthreads();

      // f. Per column j: dbdw, dwdw, then du = dy[t+1] w0 + dy[t] w1 +
      //    dy[t-1] w2 in place of u (the column's u is read first), dbin.
      for (int j = tid; j < NC; j += kThreads) {
        const int hj = hidden_col<F>(c, j);
        const float* w = wdw + 3 * hj;
        float sb = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sbin = 0.f;
        for (int i = 0; i < TT && t0 + i < T; ++i) {
          const float d = y[(i + 1) * LU + j];
          sb += d;
          s0 += d * u[(i + 1) * LU + j];
          s1 += d * u[(i + 2) * LU + j];
          s2 += d * u[(i + 3) * LU + j];
        }
        for (int i = 0; i < TT; ++i) {
          float v = 0.f;
          if (t0 + i < T) {
            v = y[(i + 2) * LU + j] * w[0] + y[(i + 1) * LU + j] * w[1] +
                y[i * LU + j] * w[2];
            sbin += v;
            v = rnd(v);
            du_g[(base + t0 + i) * H6 + hj] = v;
          }
          u[(i + 2) * LU + j] = v;
        }
        acc[P::bdw + hj] += sb;
        acc[P::wdw + 3 * hj] += s0;
        acc[P::wdw + 3 * hj + 1] += s1;
        acc[P::wdw + 3 * hj + 2] += s2;
        acc[P::bin + hj] += sbin;
      }
      __syncthreads();

      // g. dxn += du_c win_c^T (du rows from u row 2; the fragments' rows
      //    past TT are discarded).
      warp_product<kBf16, false, 2, 2, NC / 8>(dxn, u + 2 * LU, LU, [&](int ks,
                                                                    int nt) {
        return *reinterpret_cast<const float2*>(
            win + (size_t)(16 * warp + 8 * nt + g8) * H6 +
            hidden_col<F>(c, 8 * ks + 2 * t4));
      });
    }
    __syncthreads();  // the last dxn product has read u

    // 3. o0 and dxn of the tile rows into u and y.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * mt + frag_row(e);
          const int f = 16 * warp + 8 * nt + frag_col(e);
          if (r < TT) {
            u[r * LU + f] = o0[mt][nt][e];
            y[r * LU + f] = dxn[mt][nt][e];
          }
        }
    __syncthreads();

    // 4. dls = sum dout * o, o = (o0 + bout) m1 / (1-p); dbout = sum do0.
    if (tid < F) {
      const int f = tid;
      float s = 0.f;
      for (int i = 0; i < TT && t0 + i < T; ++i) {
        const size_t gr = base + t0 + i;
        if (sep_keep(drop.seed1, (uint32_t)gr, (uint32_t)f, drop.threshold))
          s += to_f(dout[gr * F + f]) * (u[i * LU + f] + bout[f]) *
               drop.scale;
      }
      acc[P::ls + f] += s;
    } else if (tid < 2 * F) {
      const int f = tid - F;
      float s = 0.f;
      for (int i = 0; i < TT; ++i) s += d0[(i + 1) * LX + f];
      acc[P::bout + f] += s;
    }
    __syncthreads();

    // 5. LayerNorm backward, one warp per row, x-hat recomputed from x as
    //    step 1 computed it (into d0); dx = dout + dx_ln.
    for (int i = warp; i < TT; i += kWarps) {
      const int t = t0 + i;
      if (t >= T) {
        for (int k = lane; k < F; k += 32) d0[i * LX + k] = 0.f;
        continue;
      }
      const size_t gr = base + t;
      const In* src = x + gr * F;
      float hv[F / 32], dh[F / 32];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        hv[q] = to_f(src[lane + 32 * q]);
        s += hv[q];
      }
      const float mean = gcfn_mma::warp_sum(s) * (1.f / F);
      float s2 = 0.f;
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        hv[q] -= mean;
        s2 += hv[q] * hv[q];
      }
      const float iv = rsqrtf(gcfn_mma::warp_sum(s2) * (1.f / F) + eps);
      float s1 = 0.f;
      s2 = 0.f;
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        const int k = lane + 32 * q;
        hv[q] *= iv;
        dh[q] = y[i * LU + k] * lns[k];
        s1 += dh[q];
        s2 += dh[q] * hv[q];
        d0[i * LX + k] = hv[q];
      }
      const float m1 = gcfn_mma::warp_sum(s1) * (1.f / F);
      const float m2 = gcfn_mma::warp_sum(s2) * (1.f / F);
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        const int k = lane + 32 * q;
        dx[gr * F + k] = bf16s::from_f<In>(
            to_f(dout[gr * F + k]) + (dh[q] - m1 - hv[q] * m2) * iv);
      }
    }
    __syncthreads();
    if (tid < F) {
      const int f = tid;
      float s = 0.f;
      for (int i = 0; i < TT; ++i) s += y[i * LU + f] * d0[i * LX + f];
      acc[P::lns + f] += s;
    } else if (tid < 2 * F) {
      const int f = tid - F;
      float s = 0.f;
      for (int i = 0; i < TT && t0 + i < T; ++i) s += y[i * LU + f];
      acc[P::lnb + f] += s;
    }
  }
  __syncthreads();
  for (int e = tid; e < P::size; e += kThreads)
    partial[(size_t)blockIdx.x * P::size + e] = acc[e];
}

constexpr int kAtbThreads = 128;            // 4 warps, 32 x 32 outputs each
constexpr int kTM = 64, kTN = 64, kTR = 32;  // output tile, rows per stage
constexpr int kAL = kTM + 8;                // staged row stride (8 mod 32)

// partial[split][m][n] = sum over the split's rows r of A[r][m] * B[r][n];
// A [rows][M], B [rows][N], M and N multiples of 64.  The row index is
// the products' k: a k-step's A fragment is As[r][m] and its B fragment
// Bs[r][n], 32 rows staged at a time, two stages in flight.  kExact: A
// and B hold bfloat16-exact values (the bfloat16 row pass wrote them
// rounded), so one TF32 product takes each exactly, in place of three.
template <bool kExact>
__global__ void __launch_bounds__(kAtbThreads)
gcfn_train_bwd_atb_kernel(const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          float* __restrict__ partial, int rows, int M, int N,
                          int rows_per_split, long long split_stride) {
  __shared__ __align__(16) float As[2][kTR][kAL];
  __shared__ __align__(16) float Bs[2][kTR][kAL];
  const int n0 = blockIdx.x * kTN, m0 = blockIdx.y * kTM, s = blockIdx.z;
  const int r_begin = s * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp & 1), wn = 32 * (warp >> 1);
  float c[2][4][4] = {};

  auto stage = [&](int buf, int r0) {
    for (int e = tid; e < kTR * kTM / 4; e += kAtbThreads) {
      const int rr = e / (kTM / 4), c4 = 4 * (e - rr * (kTM / 4));
      const int r = r0 + rr;
      const bool ok = r < r_end;
      const size_t row = (size_t)(ok ? r : r_begin);
      tf32x3::cp_async16(&As[buf][rr][c4], A + row * M + m0 + c4, ok);
      tf32x3::cp_async16(&Bs[buf][rr][c4], Bm + row * N + n0 + c4, ok);
    }
    tf32x3::cp_async_commit();
  };

  const int stages = (r_end - r_begin + kTR - 1) / kTR;
  if (stages > 0) stage(0, r_begin);
  for (int n = 0; n < stages; ++n) {
    if (n + 1 < stages) {
      stage((n + 1) & 1, r_begin + (n + 1) * kTR);
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = n & 1;
    float cs[2][4][4] = {};  // this stage's rows, added to c in float32
#pragma unroll
    for (int kk = 0; kk < kTR / 8; ++kk) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m = wm + 16 * mt + g;
        const float a[4] = {As[buf][8 * kk + t][m], As[buf][8 * kk + t][m + 8],
                            As[buf][8 * kk + t + 4][m],
                            As[buf][8 * kk + t + 4][m + 8]};
        if constexpr (kExact) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ab[mt][i] = __float_as_uint(a[i]);
        } else {
          tf32x3::split(a, ab[mt], as[mt]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int nn = wn + 8 * nt + g;
        uint32_t bb[2], bs[2];
        if constexpr (kExact) {
          bb[0] = __float_as_uint(Bs[buf][8 * kk + t][nn]);
          bb[1] = __float_as_uint(Bs[buf][8 * kk + t + 4][nn]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) tf32x3::mma(cs[mt][nt], ab[mt], bb);
        } else {
          tf32x3::split(Bs[buf][8 * kk + t][nn], bb[0], bs[0]);
          tf32x3::split(Bs[buf][8 * kk + t + 4][nn], bb[1], bs[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            tf32x3::mma3(cs[mt][nt], ab[mt], as[mt], bb, bs);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] += cs[mt][nt][e];
    __syncthreads();  // this stage's buffers are consumed
  }
  float* out = partial + (size_t)s * split_stride;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            out + (size_t)(m0 + wm + 16 * mt + g + 8 * h) * N + n0 + wn +
            8 * nt + 2 * t) = make_float2(c[mt][nt][2 * h],
                                          c[mt][nt][2 * h + 1]);
}

// out[l] = sum over s = 0, 1, ... of partial[s][l], in that order.
__global__ void __launch_bounds__(kReduceThreads)
gcfn_train_bwd_reduce_kernel(const float* __restrict__ partial,
                             float* __restrict__ out, int splits,
                             long long len) {
  const long long l = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (l >= len) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += partial[(size_t)i * len + l];
  out[l] = s;
}

int reduce(const float* partial, float* out, int splits, long long len,
           cudaStream_t stream) {
  const int blocks = (int)((len + kReduceThreads - 1) / kReduceThreads);
  gcfn_train_bwd_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(
      partial, out, splits, len);
  return (int)cudaGetLastError();
}

// K8's partition of B x T rows at width F, and the floats of scratch it
// needs: xn, du, g and do0 of every row, then the partials of the row
// pass's blocks and of the weight products' splits.
template <int F>
struct BwdPartition {
  long long rows;
  int groups, splits;
  BwdPartition(int B, int T)
      : rows((long long)B * T),
        groups((int)std::min<long long>(
            (long long)B * ((T + kBwdTT - 1) / kBwdTT),
            BwdShape<F>::row_groups)),
        splits((int)std::max<long long>(
            1, std::min<long long>(kMaxSplits, rows / 1024))) {}
  long long xn() const { return 0; }
  long long du() const { return xn() + rows * F; }
  long long g() const { return du() + rows * 6 * F; }
  long long do0() const { return g() + rows * 3 * F; }
  long long small_partial() const { return do0() + rows * F; }
  long long big_partial() const {
    return small_partial() + (long long)groups * Small<F>::size;
  }
  long long floats() const {
    return big_partial() + (long long)splits * 9 * F * F;
  }
};

// K7's float32 or bfloat16 instance at width F.
template <int F, class In>
constexpr auto fwd_kernel() {
  if constexpr (std::is_same<In, float>::value)
    return gcfn_train_fwd_kernel<F>;
  else
    return gcfn_train_fwd_bf16_kernel<F>;
}

template <int F, class In>
cudaError_t set_fwd_attributes() {
  constexpr size_t smem = gcfn_mma::Shape<F>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<F, In>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)  // room for Shape<F>::blocks_per_sm blocks
    err = cudaFuncSetAttribute(fwd_kernel<F, In>(),
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int F, class In>
int launch_fwd(const In* x, const float* lns, const float* lnb,
               const float* win, const float* bin, const float* wdw,
               const float* bdw, const float* wout, const float* bout,
               const float* ls, In* out, int B, int T, float eps,
               GcfnDrop drop, cudaStream_t s) {
  constexpr int TT = gcfn_mma::kTT;
  const cudaError_t err = set_fwd_attributes<F, In>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  const auto kernel = fwd_kernel<F, In>();
  kernel<<<grid, gcfn_mma::kThreads, gcfn_mma::Shape<F>::smem_bytes, s>>>(
      x, lns, lnb, win, bin, wdw, bdw, wout, bout, ls, out, T, eps, drop);
  return (int)cudaGetLastError();
}

template <int F, class In>
cudaError_t set_rows_attributes() {
  return cudaFuncSetAttribute(gcfn_train_bwd_rows_kernel<F, In>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)BwdShape<F>::smem_bytes);
}

template <int F, class In>
int launch_bwd(const In* x, const In* dout, const float* lns,
               const float* lnb, const float* win, const float* bin,
               const float* wdw, const float* bdw, const float* wout,
               const float* bout, const float* ls, In* dx,
               float* grads_small, float* grads_big, float* scratch,
               long long scratch_floats, int B, int T, float eps,
               GcfnDrop drop, cudaStream_t s) {
  constexpr bool kExact = !std::is_same<In, float>::value;
  constexpr int H6 = 6 * F, H3 = 3 * F;
  const BwdPartition<F> part(B, T);
  if (scratch_floats < part.floats()) return (int)cudaErrorInvalidValue;
  float *xn = scratch + part.xn(), *du = scratch + part.du(),
        *g = scratch + part.g(), *do0 = scratch + part.do0(),
        *small_partial = scratch + part.small_partial(),
        *big_partial = scratch + part.big_partial();
  cudaError_t err = set_rows_attributes<F, In>();
  if (err != cudaSuccess) return (int)err;
  gcfn_train_bwd_rows_kernel<F, In>
      <<<part.groups, BwdShape<F>::kThreads, BwdShape<F>::smem_bytes, s>>>(
          x, dout, lns, lnb, win, bin, wdw, bdw, wout, bout, ls, dx, xn, du,
          g, do0, small_partial, B, T, eps, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int rows = B * T;
  const int per_split = (rows + part.splits - 1) / part.splits;
  const long long big = (long long)F * H6 + (long long)H3 * F;
  gcfn_train_bwd_atb_kernel<kExact>
      <<<dim3(H6 / kTN, F / kTM, part.splits), kAtbThreads, 0, s>>>(
      xn, du, big_partial, rows, F, H6, per_split, big);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gcfn_train_bwd_atb_kernel<kExact>
      <<<dim3(F / kTN, H3 / kTM, part.splits), kAtbThreads, 0, s>>>(
      g, do0, big_partial + (size_t)F * H6, rows, H3, F, per_split, big);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int e = reduce(big_partial, grads_big, part.splits, big, s);
  if (e) return e;
  return reduce(small_partial, grads_small, part.groups, Small<F>::size, s);
}

// K7's and K8's row pass's blocks per SM, registers, local (spill) bytes
// and warps per block at width F, for stream type In, into o[0 .. 3] and
// o[4 .. 7].
template <int F, class In>
cudaError_t occupancy(int* o) {
  constexpr int kSmem[2] = {(int)gcfn_mma::Shape<F>::smem_bytes,
                            (int)BwdShape<F>::smem_bytes};
  constexpr int kBlock[2] = {gcfn_mma::kThreads, BwdShape<F>::kThreads};
  const void* kernels[2] = {(const void*)fwd_kernel<F, In>(),
                            (const void*)gcfn_train_bwd_rows_kernel<F, In>};
  cudaError_t err = set_fwd_attributes<F, In>();
  if (err == cudaSuccess) err = set_rows_attributes<F, In>();
  for (int k = 0; k < 2 && err == cudaSuccess; ++k) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernels[k]);
    if (err != cudaSuccess) break;
    o[4 * k + 1] = attr.numRegs;
    o[4 * k + 2] = (int)attr.localSizeBytes;
    o[4 * k + 3] = kBlock[k] / 32;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        o + 4 * k, kernels[k], kBlock[k], kSmem[k]);
  }
  return err;
}

}  // namespace

// K7.  Pointers are device pointers to contiguous float32; win [F, 6F] and
// wout [3F, F] are [in, out], wdw [6F, 3].  seed0 and seed1 are the seed
// words of sites 0 and 1, threshold int(p * 2^24), scale 1 / (1 - p).
// Built for Base's F = 128 and Large's F = 256.
extern "C" int sep_gcfn_train_fwd_f32(
    const void* x, const void* lns, const void* lnb, const void* win,
    const void* bin, const void* wdw, const void* bdw, const void* wout,
    const void* bout, const void* ls, void* out, int B, int T, int F,
    float eps, unsigned seed0, unsigned seed1, unsigned threshold,
    float scale, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GcfnDrop drop{seed0, seed1, threshold, scale};
  float* o = static_cast<float*>(out);
  if (B <= 0 || T <= 0) return 0;
  if (F == 128)
    return launch_fwd<128>(f(x), f(lns), f(lnb), f(win), f(bin), f(wdw),
                           f(bdw), f(wout), f(bout), f(ls), o, B, T, eps,
                           drop, s);
  if (F == 256)
    return launch_fwd<256>(f(x), f(lns), f(lnb), f(win), f(bin), f(wdw),
                           f(bdw), f(wout), f(bout), f(ls), o, B, T, eps,
                           drop, s);
  return (int)cudaErrorInvalidValue;
}

// K7's bfloat16 instance: x and out bfloat16 [B, T, F], the rest as
// sep_gcfn_train_fwd_f32's.
extern "C" int sep_gcfn_train_fwd_bf16(
    const void* x, const void* lns, const void* lnb, const void* win,
    const void* bin, const void* wdw, const void* bdw, const void* wout,
    const void* bout, const void* ls, void* out, int B, int T, int F,
    float eps, unsigned seed0, unsigned seed1, unsigned threshold,
    float scale, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GcfnDrop drop{seed0, seed1, threshold, scale};
  if (B <= 0 || T <= 0) return 0;
  if (F == 128)
    return launch_fwd<128>(xb, f(lns), f(lnb), f(win), f(bin), f(wdw),
                           f(bdw), f(wout), f(bout), f(ls), o, B, T, eps,
                           drop, s);
  if (F == 256)
    return launch_fwd<256>(xb, f(lns), f(lnb), f(win), f(bin), f(wdw),
                           f(bdw), f(wout), f(bout), f(ls), o, B, T, eps,
                           drop, s);
  return (int)cudaErrorInvalidValue;
}

// The floats of scratch that sep_gcfn_train_bwd_f32 (and _bf16) needs at
// B x T
// (F = 128 or 256; 0 for other widths).
extern "C" long long sep_gcfn_train_bwd_scratch_floats(int B, int T, int F) {
  if (B <= 0 || T <= 0) return 0;
  if (F == 128) return BwdPartition<128>(B, T).floats();
  if (F == 256) return BwdPartition<256>(B, T).floats();
  return 0;
}

// K8.  Inputs as K7's plus dout [B, T, F].  Outputs: dx [B, T, F];
// grads_small [34F] = dlns [F], dlnb [F], dbin [6F], dwdw [6F][3],
// dbdw [6F], dbout [F], dls [F]; grads_big [F*6F + 3F*F] = dWin [F][6F],
// dWout [3F][F].  scratch: scratch_floats >=
// sep_gcfn_train_bwd_scratch_floats(B, T, F) floats.  Built for F = 128
// and 256.
extern "C" int sep_gcfn_train_bwd_f32(
    const void* x, const void* dout, const void* lns, const void* lnb,
    const void* win, const void* bin, const void* wdw, const void* bdw,
    const void* wout, const void* bout, const void* ls, void* dx,
    void* grads_small, void* grads_big, void* scratch,
    long long scratch_floats, int B, int T, int F, float eps,
    unsigned seed0, unsigned seed1, unsigned threshold, float scale,
    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GcfnDrop drop{seed0, seed1, threshold, scale};
  if (B <= 0 || T <= 0) return 0;
  if (F == 128)
    return launch_bwd<128>(f(x), f(dout), f(lns), f(lnb), f(win), f(bin),
                           f(wdw), f(bdw), f(wout), f(bout), f(ls), w(dx),
                           w(grads_small), w(grads_big), w(scratch),
                           scratch_floats, B, T, eps, drop, s);
  if (F == 256)
    return launch_bwd<256>(f(x), f(dout), f(lns), f(lnb), f(win), f(bin),
                           f(wdw), f(bdw), f(wout), f(bout), f(ls), w(dx),
                           w(grads_small), w(grads_big), w(scratch),
                           scratch_floats, B, T, eps, drop, s);
  return (int)cudaErrorInvalidValue;
}

// K8's bfloat16 instance: x, dout and dx bfloat16 [B, T, F], the nine
// parameter gradients float32 sums, the rest as sep_gcfn_train_bwd_f32's.
extern "C" int sep_gcfn_train_bwd_bf16(
    const void* x, const void* dout, const void* lns, const void* lnb,
    const void* win, const void* bin, const void* wdw, const void* bdw,
    const void* wout, const void* bout, const void* ls, void* dx,
    void* grads_small, void* grads_big, void* scratch,
    long long scratch_floats, int B, int T, int F, float eps,
    unsigned seed0, unsigned seed1, unsigned threshold, float scale,
    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto b = [](const void* p) {
    return static_cast<const __nv_bfloat16*>(p);
  };
  auto dxb = static_cast<__nv_bfloat16*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GcfnDrop drop{seed0, seed1, threshold, scale};
  if (B <= 0 || T <= 0) return 0;
  if (F == 128)
    return launch_bwd<128>(b(x), b(dout), f(lns), f(lnb), f(win), f(bin),
                           f(wdw), f(bdw), f(wout), f(bout), f(ls), dxb,
                           w(grads_small), w(grads_big), w(scratch),
                           scratch_floats, B, T, eps, drop, s);
  if (F == 256)
    return launch_bwd<256>(b(x), b(dout), f(lns), f(lnb), f(win), f(bin),
                           f(wdw), f(bdw), f(wout), f(bout), f(ls), dxb,
                           w(grads_small), w(grads_big), w(scratch),
                           scratch_floats, B, T, eps, drop, s);
  return (int)cudaErrorInvalidValue;
}

// K7's then K8's row pass's blocks per SM, registers, local (spill) bytes
// and warps per block at width F (128 or 256), with the launches'
// attributes set, into out[0 .. 7].
extern "C" int sep_gcfn_train_occupancy(int F, void* out) {
  int* o = static_cast<int*>(out);
  if (F == 128) return (int)occupancy<128, float>(o);
  if (F == 256) return (int)occupancy<256, float>(o);
  return (int)cudaErrorInvalidValue;
}

// The same of the bfloat16 instances.
extern "C" int sep_gcfn_train_bf16_occupancy(int F, void* out) {
  int* o = static_cast<int*>(out);
  if (F == 128) return (int)occupancy<128, __nv_bfloat16>(o);
  if (F == 256) return (int)occupancy<256, __nv_bfloat16>(o);
  return (int)cudaErrorInvalidValue;
}
