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
// What bounds it on the H100: per head, the forward needs 4*D float32
// operations per (query, valid key) pair (QKᵀ, P·V) plus 2*D per query
// row and distinct clamped table row its keys reach (Q·tableᵀ); the
// backward 10*D per pair (QKᵀ, dO·Vᵀ, dV, dQ, dK) plus 6*D per row and
// table row (Q·tableᵀ, its adjoints to dQ and to the table).  q, k, v and
// out are a few MB, so both are bound by the 67 TFLOP/s of the CUDA cores
// (chip_smoke.py counts each from its inputs).
//
// Design.  The TPU kernel holds a whole [block, block] score tile per bh
// in VMEM (1 MB at 512); a Hopper block has 227 KB of shared memory.  So
// K13 streams key tiles of 64 with an online softmax, as K12
// (flash_relpos.cu) does, and saves each row's max and sum; the dropout
// scales the probabilities that P·V accumulates, never the sum.  K14
// recomputes P tile by tile from those row statistics, in three launches:
//  1. dq (grid: query tile x bh): delta_i = dO_i·out_i (which equals
//     sum_j P_ij dP_ij with dropout too), then for each key tile
//     G_ij = c P_ij (z_ij dO_i·v_j - delta_i) into shared memory, dq_i +=
//     sum_j G_ij (k_j + pe_{i-j}), and the table's band sums
//     sum_{i - j = r} G_ij q_i into a per-block frame of relative
//     offsets in shared memory, written out as the block's partial;
//  2. dk, dv (grid: key tile x bh): the same P and G transposed, dv_j +=
//     sum_i P_ij z_ij dO_i, dk_j += sum_i G_ij q_i;
//  3. dtable: each (table row, column) sums the partials of its relative
//     offsets (one, or a run of them at a clamped end row) over bh and
//     query tiles in a fixed order.
// The TPU kernel's barrel shifter and row-reversed table are Mosaic
// workarounds (no gather, no reverse); here the <= 127 clamped table rows
// of a (query tile, key tile) band are staged in shared memory and read
// at band index i - j + 63.  No float atomics: two runs give the same
// bits.  Query rows past L are computed on zeros and never written; keys
// at or past lim score -inf (forward) or carry no gradient (backward).
// 64-bit offsets throughout.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_dropout.cuh"

namespace {

constexpr int D = 16;                  // head width (Base: 128 / 8 heads)
constexpr int kTile = 64;              // query rows / keys per tile
constexpr int kThreads = 256;          // 16 x 16: 4 rows x 4 keys each
constexpr int kBand = 2 * kTile;       // band rows staged (127 used)
constexpr int kTS = kTile + 4;         // padded strides, in floats; keep
constexpr int kBS = kBand + 4;         // every row 16-byte aligned

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

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows r0 .. r0 + 3 of a [*, D] array into registers (zeros past L)
__device__ __forceinline__ void load_rows(const float* __restrict__ a,
                                          int r0, int L, float (&out)[4][D]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = r0 + x;
#pragma unroll
    for (int c4 = 0; c4 < D / 4; ++c4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < L) v = reinterpret_cast<const float4*>(a + (size_t)r * D)[c4];
      out[x][4 * c4 + 0] = v.x;
      out[x][4 * c4 + 1] = v.y;
      out[x][4 * c4 + 2] = v.z;
      out[x][4 * c4 + 3] = v.w;
    }
  }
}

// the 128 clamped table rows of band rel0 .. rel0 + 127, transposed:
// pt[c * kBS + rr]; and, if pr is given, row-major: pr[rr * D + c]
__device__ __forceinline__ void stage_band(const float* __restrict__ table,
                                           int rel0, int maxlen, float* pt,
                                           float* pr) {
  for (int e = threadIdx.x; e < kBand * D; e += kThreads) {
    const int rr = e / D, c = e - rr * D;
    const int row = min(max(rel0 + rr, -maxlen), maxlen - 1) + maxlen;
    const float x = table[(size_t)row * D + c];
    pt[c * kBS + rr] = x;
    if (pr != nullptr) pr[e] = x;
  }
}

// a [64, D] tile (rows r0 .., zeros at or past lim) transposed into
// t[c * kTS + rr], and row-major into r (if given)
__device__ __forceinline__ void stage_tile(const float* __restrict__ a,
                                           int r0, int lim, float* t,
                                           float* r) {
  const int rr = threadIdx.x >> 2, c4 = (threadIdx.x & 3) * 4;
  const int row = r0 + rr;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < lim) v = *reinterpret_cast<const float4*>(a + (size_t)row * D + c4);
  t[(c4 + 0) * kTS + rr] = v.x;
  t[(c4 + 1) * kTS + rr] = v.y;
  t[(c4 + 2) * kTS + rr] = v.z;
  t[(c4 + 3) * kTS + rr] = v.w;
  if (r != nullptr) *reinterpret_cast<float4*>(r + rr * D + c4) = v;
}

// s[a][bb] = sum_c q·(k + pe) over the D columns: the unscaled score of
// register row a against shared column 4tx + bb (cols_t[c][...], a
// transposed tile) with the rel-pos bias of the pair read from the band
// pt[c][...].  kQueryRows: the rows are queries and the columns keys, and
// the pair's band index is band0 + 3 + a - bb; else the rows are keys and
// the columns queries, and it is band0 + 3 + bb - a.  Both orders round
// the same products in the same order, so forward and backward agree.
template <bool kQueryRows>
__device__ __forceinline__ void scores(const float (&rows)[4][D],
                                       const float* cols_t, const float* pt,
                                       int tx, int band0, float (&s)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float* pc = pt + c * kBS + band0;
    const float4 kk = *reinterpret_cast<const float4*>(cols_t + c * kTS + 4 * tx);
    const float4 p0 = *reinterpret_cast<const float4*>(pc);
    const float4 p1 = *reinterpret_cast<const float4*>(pc + 4);
    const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
    const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        if (kQueryRows)
          s[a][bb] = fmaf(rows[a][c], kv[bb] + pv[3 + a - bb], s[a][bb]);
        else
          s[a][bb] = fmaf(kv[bb], rows[a][c] + pv[3 + bb - a], s[a][bb]);
      }
  }
}

// d[a][bb] = sum_c rows[a][c] * cols_t[c][4 * tx + bb]
__device__ __forceinline__ void dots(const float (&rows)[4][D],
                                     const float* cols_t, int tx,
                                     float (&d)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) d[a][bb] = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float4 kk = *reinterpret_cast<const float4*>(cols_t + c * kTS + 4 * tx);
    const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) d[a][bb] = fmaf(rows[a][c], kv[bb], d[a][bb]);
  }
}

// ---------------------------------------------------------------- K13

__global__ void __launch_bounds__(kThreads)
attn_train_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ table,
                      const int* __restrict__ lens, float* __restrict__ out,
                      float* __restrict__ row_max, float* __restrict__ row_sum,
                      int L, int H, int maxlen, float scale, Drop drop) {
  __shared__ __align__(16) float kt[D * kTS];     // kt[c][jj]: K transposed
  __shared__ __align__(16) float vs[kTile * D];   // vs[jj][c]
  __shared__ __align__(16) float pt[D * kBS];     // pt[c][rr]: band rows
  __shared__ __align__(16) float ps[kTile * kTS]; // ps[ii][jj]: P * z
  __shared__ float row_alpha[kTile];              // exp(m_old - m_new)
  __shared__ float row_l[kTile];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // keys 4tx..4tx+3 of a tile
  const int ty = tid >> 4;   // rows 4ty..4ty+3; a warp holds two ty, and
                             // the 16 lanes of one ty reduce by shuffles
  const int bh = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const int lim = min(L, lens[bh / H]);
  const size_t head = (size_t)bh * L * D;

  float qr[4][D];
  load_rows(q + head, i0 + 4 * ty, L, qr);
  float m_run[4], l_run[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = -INFINITY;
    l_run[a] = 0.f;
  }
  // P·V: this thread's row and 4 output columns
  const int orow = tid >> 2, oc = (tid & 3) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // band index of (row 4ty + a, key 4tx + bb) is band0 + 3 + a - bb
  const int band0 = 4 * (ty - tx) + kTile - 4;

  for (int j0 = 0; j0 < lim; j0 += kTile) {
    __syncthreads();  // the previous tile's shared arrays are consumed
    stage_tile(k + head, j0, lim, kt, nullptr);
    {
      const int jj = tid >> 2, c4 = (tid & 3) * 4, j = j0 + jj;
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < lim) vv = *reinterpret_cast<const float4*>(v + head + (size_t)j * D + c4);
      *reinterpret_cast<float4*>(vs + jj * D + c4) = vv;
    }
    stage_band(table, i0 - j0 - (kTile - 1), maxlen, pt, nullptr);
    __syncthreads();

    float s[4][4];
    scores<true>(qr, kt, pt, tx, band0, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = j0 + 4 * tx + bb;
        s[a][bb] = j < lim ? s[a][bb] * scale : -INFINITY;
        mx = fmaxf(mx, s[a][bb]);
      }
      const float m_new = fmaxf(m_run[a], half_warp_max(mx));
      const float alpha = expf(m_run[a] - m_new);  // 0 at the first tile
      float sum = 0.f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        s[a][bb] = expf(s[a][bb] - m_new);
        sum += s[a][bb];
        s[a][bb] *= drop.z(bh, i0 + 4 * ty + a, j0 + 4 * tx + bb);
      }
      l_run[a] = l_run[a] * alpha + half_warp_sum(sum);
      m_run[a] = m_new;
      if (tx == 0) row_alpha[4 * ty + a] = alpha;
      *reinterpret_cast<float4*>(ps + (4 * ty + a) * kTS + 4 * tx) =
          make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
    }
    __syncthreads();

    const float alpha = row_alpha[orow];
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[x] *= alpha;
    const float* prow = ps + orow * kTS;
#pragma unroll 8
    for (int jj = 0; jj < kTile; ++jj) {
      const float p = prow[jj];
      const float4 vv = *reinterpret_cast<const float4*>(vs + jj * D + oc);
      acc[0] = fmaf(p, vv.x, acc[0]);
      acc[1] = fmaf(p, vv.y, acc[1]);
      acc[2] = fmaf(p, vv.z, acc[2]);
      acc[3] = fmaf(p, vv.w, acc[3]);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      row_l[4 * ty + a] = l_run[a];
      const int i = i0 + 4 * ty + a;
      if (i < L) {
        row_max[(size_t)bh * L + i] = m_run[a];
        row_sum[(size_t)bh * L + i] = l_run[a];
      }
    }
  }
  __syncthreads();
  const int i = i0 + orow;
  if (i < L) {
    const float l = fmaxf(row_l[orow], 1e-30f);
    *reinterpret_cast<float4*>(out + head + (size_t)i * D + oc) =
        make_float4(acc[0] / l, acc[1] / l, acc[2] / l, acc[3] / l);
  }
}

// ---------------------------------------------------------------- K14

// floats of the dq kernel's dynamic shared memory: kt, vt (transposed
// K and V tiles), ks (K row-major), pt, pr (band, both layouts), gs (G),
// qs (Q tile row-major), then the table frame of frame_rows(L) rows
__host__ __device__ constexpr int dq_fixed_floats() {
  return 2 * D * kTS + kTile * D + D * kBS + kBand * D + kTile * kTS +
         kTile * D;
}

// rows of a query tile's frame of relative offsets: offset i0 - Lk + 1 +
// fr for fr in [0, Lk + 63), Lk = L rounded up to the tile; one spare
__host__ __device__ inline int frame_rows(int L) {
  return ((L + kTile - 1) / kTile) * kTile + kTile;
}

__global__ void __launch_bounds__(kThreads)
attn_train_bwd_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ table,
                         const int* __restrict__ lens,
                         const float* __restrict__ out,
                         const float* __restrict__ dout,
                         const float* __restrict__ row_max,
                         const float* __restrict__ row_sum,
                         float* __restrict__ delta, float* __restrict__ dq,
                         float* __restrict__ partial, int L, int H,
                         int maxlen, float scale, Drop drop) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                      // [D][kTS]
  float* vt = kt + D * kTS;              // [D][kTS]
  float* ks = vt + D * kTS;              // [kTile][D]
  float* pt = ks + kTile * D;            // [D][kBS]
  float* pr = pt + D * kBS;              // [kBand][D]
  float* gs = pr + kBand * D;            // [kTile][kTS]
  float* qs = gs + kTile * kTS;          // [kTile][D]
  float* frame = qs + kTile * D;         // [frame_rows(L)][D]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, nqt = gridDim.x;
  const int i0 = blockIdx.x * kTile;
  const int lim = min(L, lens[bh / H]);
  const size_t head = (size_t)bh * L * D;
  const int lk = ((L + kTile - 1) / kTile) * kTile;
  const int nframe = frame_rows(L);

  float qr[4][D], gr[4][D];
  load_rows(q + head, i0 + 4 * ty, L, qr);
  load_rows(dout + head, i0 + 4 * ty, L, gr);
  float m[4], linv[4], dl[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
    m[a] = 0.f;
    linv[a] = 0.f;
    dl[a] = 0.f;
    if (i < L) {
      m[a] = row_max[(size_t)bh * L + i];
      linv[a] = 1.f / fmaxf(row_sum[(size_t)bh * L + i], 1e-30f);
      float dsum = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 x =
            reinterpret_cast<const float4*>(out + head + (size_t)i * D)[c4];
        dsum = fmaf(gr[a][4 * c4 + 0], x.x, dsum);
        dsum = fmaf(gr[a][4 * c4 + 1], x.y, dsum);
        dsum = fmaf(gr[a][4 * c4 + 2], x.z, dsum);
        dsum = fmaf(gr[a][4 * c4 + 3], x.w, dsum);
      }
      dl[a] = dsum;
      if (tx == 0) delta[(size_t)bh * L + i] = dsum;
    }
  }
  {
    const int rr = tid >> 2, c4 = (tid & 3) * 4, i = i0 + rr;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < L) x = *reinterpret_cast<const float4*>(q + head + (size_t)i * D + c4);
    *reinterpret_cast<float4*>(qs + rr * D + c4) = x;
  }
  for (int e = tid; e < nframe * D; e += kThreads) frame[e] = 0.f;

  const int orow = tid >> 2, oc = (tid & 3) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int band0 = 4 * (ty - tx) + kTile - 4;
  // the table band: band index bnd of this thread, 8 columns from cb
  const int bnd = tid >> 1, cb = (tid & 1) * 8;

  for (int j0 = 0; j0 < lim; j0 += kTile) {
    __syncthreads();
    stage_tile(k + head, j0, lim, kt, ks);
    stage_tile(v + head, j0, lim, vt, nullptr);
    stage_band(table, i0 - j0 - (kTile - 1), maxlen, pt, pr);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<true>(qr, kt, pt, tx, band0, s);
    dots(gr, vt, tx, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + 4 * ty + a;
      float g[4];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = j0 + 4 * tx + bb;
        g[bb] = 0.f;
        if (i < L && j < lim) {
          const float p = expf(s[a][bb] * scale - m[a]) * linv[a];
          g[bb] = scale * p * (drop.z(bh, i, j) * dp[a][bb] - dl[a]);
        }
      }
      *reinterpret_cast<float4*>(gs + (4 * ty + a) * kTS + 4 * tx) =
          make_float4(g[0], g[1], g[2], g[3]);
    }
    __syncthreads();

    // dq_i += sum_j G_ij (k_j + pe_{i-j})
    const float* grow = gs + orow * kTS;
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      const float g = grow[jj];
      const float4 kk = *reinterpret_cast<const float4*>(ks + jj * D + oc);
      const float4 pp = *reinterpret_cast<const float4*>(
          pr + (orow - jj + kTile - 1) * D + oc);
      acc[0] = fmaf(g, kk.x + pp.x, acc[0]);
      acc[1] = fmaf(g, kk.y + pp.y, acc[1]);
      acc[2] = fmaf(g, kk.z + pp.z, acc[2]);
      acc[3] = fmaf(g, kk.w + pp.w, acc[3]);
    }
    // band bnd (i - j = i0 - j0 - 63 + bnd): sum_{ii - jj = bnd - 63}
    // G[ii][jj] q[ii], added to frame row lk - 64 - j0 + bnd
    if (bnd < kBand - 1) {
      float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const int lo = max(0, bnd - (kTile - 1)), hi = min(kTile - 1, bnd);
      for (int ii = lo; ii <= hi; ++ii) {
        const float g = gs[ii * kTS + ii - bnd + kTile - 1];
        const float4 x0 = *reinterpret_cast<const float4*>(qs + ii * D + cb);
        const float4 x1 = *reinterpret_cast<const float4*>(qs + ii * D + cb + 4);
        sum[0] = fmaf(g, x0.x, sum[0]);
        sum[1] = fmaf(g, x0.y, sum[1]);
        sum[2] = fmaf(g, x0.z, sum[2]);
        sum[3] = fmaf(g, x0.w, sum[3]);
        sum[4] = fmaf(g, x1.x, sum[4]);
        sum[5] = fmaf(g, x1.y, sum[5]);
        sum[6] = fmaf(g, x1.z, sum[6]);
        sum[7] = fmaf(g, x1.w, sum[7]);
      }
      float* fr = frame + (size_t)(lk - kTile - j0 + bnd) * D + cb;
#pragma unroll
      for (int x = 0; x < 8; ++x) fr[x] += sum[x];
    }
  }

  const int i = i0 + orow;
  if (i < L)
    *reinterpret_cast<float4*>(dq + head + (size_t)i * D + oc) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  float* dst = partial + ((size_t)bh * nqt + blockIdx.x) * nframe * D;
  for (int e = tid; e < nframe * D / 4; e += kThreads)
    reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(frame)[e];
}

// floats of the dk/dv kernel's dynamic shared memory: qt, gt (Q and dO
// transposed), qs, gs2 (row-major), pt (band), pz, gg (P z and G,
// key-major), and the row statistics m, 1 / l, delta
__host__ __device__ constexpr int dkv_floats() {
  return 2 * D * kTS + 2 * kTile * D + D * kBS + 2 * kTile * kTS + 3 * kTile;
}

__global__ void __launch_bounds__(kThreads)
attn_train_bwd_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ table,
                          const int* __restrict__ lens,
                          const float* __restrict__ dout,
                          const float* __restrict__ row_max,
                          const float* __restrict__ row_sum,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int L, int H, int maxlen, float scale, Drop drop) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [D][kTS]
  float* gt = qt + D * kTS;              // [D][kTS]
  float* qs = gt + D * kTS;              // [kTile][D]
  float* gs = qs + kTile * D;            // [kTile][D]
  float* pt = gs + kTile * D;            // [D][kBS]
  float* pz = pt + D * kBS;              // [kTile keys][kTS queries]
  float* gg = pz + kTile * kTS;          // [kTile keys][kTS queries]
  float* ms = gg + kTile * kTS;          // [kTile]
  float* ls = ms + kTile;
  float* ds = ls + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // queries 4tx..4tx+3 of a tile
  const int ty = tid >> 4;   // keys 4ty..4ty+3
  const int bh = blockIdx.y;
  const int j0 = blockIdx.x * kTile;
  const int lim = min(L, lens[bh / H]);
  const size_t head = (size_t)bh * L * D;
  const int orow = tid >> 2, oc = (tid & 3) * 4;   // key, 4 columns
  float adk[4] = {0.f, 0.f, 0.f, 0.f}, adv[4] = {0.f, 0.f, 0.f, 0.f};

  if (j0 < lim) {
    float kr[4][D], vr[4][D];
    load_rows(k + head, j0 + 4 * ty, lim, kr);
    load_rows(v + head, j0 + 4 * ty, lim, vr);
    // band index of (key 4ty + a, query 4tx + bb) is band0 + 3 + bb - a
    const int band0 = 4 * (tx - ty) + kTile - 4;
    for (int i0 = 0; i0 < L; i0 += kTile) {
      __syncthreads();
      stage_tile(q + head, i0, L, qt, qs);
      stage_tile(dout + head, i0, L, gt, gs);
      stage_band(table, i0 - j0 - (kTile - 1), maxlen, pt, nullptr);
      if (tid < kTile) {
        const int i = i0 + tid;
        ms[tid] = i < L ? row_max[(size_t)bh * L + i] : 0.f;
        ls[tid] = i < L ? 1.f / fmaxf(row_sum[(size_t)bh * L + i], 1e-30f)
                        : 0.f;
        ds[tid] = i < L ? delta[(size_t)bh * L + i] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      scores<false>(kr, qt, pt, tx, band0, s);
      dots(vr, gt, tx, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = j0 + 4 * ty + a;
        float pzv[4], g[4];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int ii = 4 * tx + bb, i = i0 + ii;
          pzv[bb] = g[bb] = 0.f;
          if (i < L && j < lim) {
            const float p = expf(s[a][bb] * scale - ms[ii]) * ls[ii];
            const float z = drop.z(bh, i, j);
            pzv[bb] = p * z;
            g[bb] = scale * p * (z * dp[a][bb] - ds[ii]);
          }
        }
        *reinterpret_cast<float4*>(pz + (4 * ty + a) * kTS + 4 * tx) =
            make_float4(pzv[0], pzv[1], pzv[2], pzv[3]);
        *reinterpret_cast<float4*>(gg + (4 * ty + a) * kTS + 4 * tx) =
            make_float4(g[0], g[1], g[2], g[3]);
      }
      __syncthreads();

      const float* prow = pz + orow * kTS;
      const float* grow = gg + orow * kTS;
#pragma unroll 4
      for (int ii = 0; ii < kTile; ++ii) {
        const float p = prow[ii], g = grow[ii];
        const float4 go = *reinterpret_cast<const float4*>(gs + ii * D + oc);
        const float4 qq = *reinterpret_cast<const float4*>(qs + ii * D + oc);
        adv[0] = fmaf(p, go.x, adv[0]);
        adv[1] = fmaf(p, go.y, adv[1]);
        adv[2] = fmaf(p, go.z, adv[2]);
        adv[3] = fmaf(p, go.w, adv[3]);
        adk[0] = fmaf(g, qq.x, adk[0]);
        adk[1] = fmaf(g, qq.y, adk[1]);
        adk[2] = fmaf(g, qq.z, adk[2]);
        adk[3] = fmaf(g, qq.w, adk[3]);
      }
    }
  }
  const int j = j0 + orow;
  if (j < L) {
    *reinterpret_cast<float4*>(dk + head + (size_t)j * D + oc) =
        make_float4(adk[0], adk[1], adk[2], adk[3]);
    *reinterpret_cast<float4*>(dv + head + (size_t)j * D + oc) =
        make_float4(adv[0], adv[1], adv[2], adv[3]);
  }
}

// dtable[r][c]: the partials of the relative offsets that row r gathers
// (rel = r - maxlen; every rel <= -maxlen at r = 0, every rel >= maxlen - 1
// at the last row), over bh and query tiles, in that order.
__global__ void attn_train_bwd_table_kernel(const float* __restrict__ partial,
                                            float* __restrict__ dtable,
                                            int BH, int L, int maxlen) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * maxlen * D) return;
  const int r = idx / D, c = idx - r * D;
  const int nqt = (L + kTile - 1) / kTile, lk = nqt * kTile;
  const int nframe = frame_rows(L);
  int lo = r - maxlen, hi = r - maxlen;
  if (r == 0) lo = -(L - 1);
  if (r == 2 * maxlen - 1) hi = L - 1;
  lo = max(lo, -(L - 1));
  hi = min(hi, L - 1);
  float sum = 0.f;
  for (int rel = lo; rel <= hi; ++rel)
    for (int bh = 0; bh < BH; ++bh)
      for (int qt = 0; qt < nqt; ++qt) {
        const int fr = rel - (qt * kTile - lk + 1);
        if (fr >= 0 && fr < nframe)
          sum += partial[(((size_t)bh * nqt + qt) * nframe + fr) * D + c];
      }
  dtable[idx] = sum;
}

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

bool bad_args(int BH, int L, int H, int maxlen, int block) {
  return H <= 0 || BH % H || BH > 65535 || L > 512 || maxlen <= 0 ||
         block < L;
}

}  // namespace

// K13.  q, k, v, out: device float32 [B*H, L, 16] (16-byte aligned);
// table [2*maxlen, 16]; lens: device int32 [B], each in [1, L]; row_max,
// row_sum: [B*H, L].  block: the hash row stride (pick_block(L));
// threshold 0 turns the dropout off.
extern "C" int sep_attn_train_fwd_f32(const void* q, const void* k,
                                      const void* v, const void* table,
                                      const void* lens, void* out,
                                      void* row_max, void* row_sum, int BH,
                                      int L, int H, int maxlen, int block,
                                      unsigned seed_word, unsigned threshold,
                                      float keep_scale, void* stream) {
  if (BH <= 0 || L <= 0) return 0;
  if (bad_args(BH, L, H, maxlen, block)) return (int)cudaErrorInvalidValue;
  dim3 grid((L + kTile - 1) / kTile, BH);
  attn_train_fwd_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(table),
      static_cast<const int*>(lens), static_cast<float*>(out),
      static_cast<float*>(row_max), static_cast<float*>(row_sum), L, H,
      maxlen, 1.0f / sqrtf((float)D),
      make_drop(seed_word, threshold, keep_scale, block));
  return (int)cudaGetLastError();
}

// floats of K14's scratch: delta [B*H, L], then the dq kernel's partial
// table frames
extern "C" long long sep_attn_train_bwd_scratch_floats(int BH, int L) {
  const int nqt = (L + kTile - 1) / kTile;
  return (long long)BH * L + (long long)BH * nqt * frame_rows(L) * D;
}

// K14.  As K13, plus out and dout [B*H, L, 16]; dq, dk, dv [B*H, L, 16];
// dtable [2*maxlen, 16]; scratch of sep_attn_train_bwd_scratch_floats.
extern "C" int sep_attn_train_bwd_f32(
    const void* q, const void* k, const void* v, const void* table,
    const void* lens, const void* out, const void* dout, const void* row_max,
    const void* row_sum, void* dq, void* dk, void* dv, void* dtable,
    void* scratch, long long scratch_floats, int BH, int L, int H,
    int maxlen, int block, unsigned seed_word, unsigned threshold,
    float keep_scale, void* stream) {
  if (bad_args(BH, L, H, maxlen, block) || BH <= 0 || L <= 0 ||
      scratch_floats < sep_attn_train_bwd_scratch_floats(BH, L))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const Drop drop = make_drop(seed_word, threshold, keep_scale, block);
  const float scale = 1.0f / sqrtf((float)D);
  const int nt = (L + kTile - 1) / kTile;
  float* delta = static_cast<float*>(scratch);
  float* partial = delta + (size_t)BH * L;

  const size_t dq_smem = sizeof(float) * ((size_t)dq_fixed_floats() +
                                          (size_t)frame_rows(L) * D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_train_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  attn_train_bwd_dq_kernel<<<dim3(nt, BH), kThreads, dq_smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(table),
      static_cast<const int*>(lens), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<const float*>(row_max),
      static_cast<const float*>(row_sum), delta, static_cast<float*>(dq),
      partial, L, H, maxlen, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t dkv_smem = sizeof(float) * (size_t)dkv_floats();
  err = cudaFuncSetAttribute(attn_train_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;
  attn_train_bwd_dkv_kernel<<<dim3(nt, BH), kThreads, dkv_smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(table),
      static_cast<const int*>(lens), static_cast<const float*>(dout),
      static_cast<const float*>(row_max), static_cast<const float*>(row_sum),
      delta, static_cast<float*>(dk), static_cast<float*>(dv), L, H, maxlen,
      scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n = 2 * maxlen * D;
  attn_train_bwd_table_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      partial, static_cast<float*>(dtable), BH, L, maxlen);
  return (int)cudaGetLastError();
}
