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
// dxn = du win^T): 885 kflop.  In float32 on the CUDA cores both are bound
// by operations (0.14 and 0.42 ms at [4, 8000, 128]), not by their
// 33 and 66 MB of traffic.
//
// K7 is K1's tile (gcfn_tile.cuh) with no length mask and the two dropout
// sites.
//
// K8 keeps what JAX's backward keeps (x, the parameters, the seed) and
// recomputes the rest, in three hand-written kernels:
//  1. rows: one block walks a fixed run of tiles of TT rows.  Per tile it
//     recomputes LN and u for the rows t0-2 .. t0+TT+1 (the transpose conv
//     needs dy one row past each side, and dy there needs y, which needs u
//     one row further), y and the dropout masks for t0-1 .. t0+TT (masks
//     regenerate from the same global rows), then do0, dg, dy, du, dxn and
//     the LayerNorm backward, and writes dx.  The sums over rows of the
//     small gradients (LN scale and bias, b_in, the k3 weight and bias,
//     b_out, ls) stay in shared memory across the block's tiles, each
//     column owned by one thread; it writes them once per block.  It also
//     writes xn, du, g and do0 for the two weight products.
//  2. atb: dWin = xn^T du and dWout = g^T do0 as 64x64 output tiles over a
//     fixed split of the rows, each split's partial written apart.
//  3. reduce: the partials of each split (or block) added in a fixed order.
// No atomics: two runs give the same bits.  The launcher picks the
// partition from B and T (bwd_partition): at most kRowGroups blocks of
// pass 1 and kMaxSplits row splits, so the partial buffers, [blocks,
// 34F] and [splits, 9F^2] floats, stay at 9 MB and 19 MB at
// [4, 8000, 128].  The caller sizes its one scratch buffer with
// sep_gcfn_train_bwd_scratch_floats.
#include <cuda_runtime.h>

#include <algorithm>
#include <stdint.h>

#include "gcfn_tile.cuh"

namespace {

using gcfn::kThreads;

constexpr int kTT = 16;  // K7 and K8 rows per tile
constexpr int kRowGroups = 528;  // K8: at most this many blocks walk tiles
constexpr int kMaxSplits = 32;   // K8: at most this many row splits of the
                                 // weight products

template <int F, int TT>
__global__ void __launch_bounds__(kThreads)
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
                      int T, float eps, gcfn::Drop drop) {
  extern __shared__ __align__(16) float smem[];
  gcfn::tile<F, TT, true>(smem, x, nullptr, lns, lnb, win, bin, wdw, bdw,
                          wout, bout, ls, out, T, eps, drop);
}

// C[r][n] = sum_k A[r][k] * B(k, n) for r < R, n < N, by all kThreads
// threads: A and C in shared memory (rows 16-byte aligned), B in global
// memory, B(k, n) = B[k * N + n] ([K][N]) or, with kBT, B[n * K + k]
// ([N][K], read 4 k at a time as one float4).  Each thread owns columns
// and keeps a column of up to RPG rows in registers.  Two variants ran
// slower on an H100 80GB HBM3 at 700 W (K8 at [4, 8000, 128]: 2.91 ms
// with this one): coalesced reads of transposed copies of win and wout
// for the kBT products (3.81 ms), and K1's register tile of 2-3 columns
// per thread (3.29 ms; the row pass then spills at 128 registers).
template <int R, int K, int N, bool kBT>
__device__ __forceinline__ void smem_product(const float* A, int lda,
                                             const float* __restrict__ B,
                                             float* C, int ldc) {
  constexpr int CT = N < kThreads ? N : kThreads;  // threads along columns
  constexpr int RG = kThreads / CT;                 // row groups
  constexpr int RPG = (R + RG - 1) / RG;            // rows per group
  static_assert(K % 4 == 0 && CT * RG == kThreads, "shape");
  const int col = threadIdx.x % CT, rg = threadIdx.x / CT;
  for (int n = col; n < N; n += CT) {
    float acc[RPG];
#pragma unroll
    for (int q = 0; q < RPG; ++q) acc[q] = 0.f;
    for (int k = 0; k < K; k += 4) {
      float4 w;
      if (kBT) {
        w = *reinterpret_cast<const float4*>(B + (size_t)n * K + k);
      } else {
        w.x = B[(size_t)k * N + n];
        w.y = B[(size_t)(k + 1) * N + n];
        w.z = B[(size_t)(k + 2) * N + n];
        w.w = B[(size_t)(k + 3) * N + n];
      }
#pragma unroll
      for (int q = 0; q < RPG; ++q) {
        const int r = rg * RPG + q;
        if (r < R) {
          const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
          acc[q] += a.x * w.x + a.y * w.y + a.z * w.z + a.w * w.w;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < RPG; ++q) {
      const int r = rg * RPG + q;
      if (r < R) C[r * ldc + n] = acc[q];
    }
  }
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

template <int F, int TT>
struct BwdShape {
  static constexpr int H6 = 6 * F, H3 = 3 * F;
  static constexpr int R4 = TT + 4, R2 = TT + 2;
  static constexpr int xn = 0, xh = xn + R4 * F, inv = xh + TT * F,
                       u = inv + TT, y = u + R4 * H6, g = y + R2 * H6,
                       d0 = g + TT * H3, dg = d0 + R2 * F,
                       small = dg + R2 * H3,
                       floats = small + Small<F>::size;
  static constexpr size_t smem_bytes = sizeof(float) * (size_t)floats;
  static_assert(TT % 4 == 0, "16-byte aligned rows");
};

template <int F, int TT>
__global__ void __launch_bounds__(kThreads)
gcfn_train_bwd_rows_kernel(
    const float* __restrict__ x, const float* __restrict__ dout,
    const float* __restrict__ lns, const float* __restrict__ lnb,
    const float* __restrict__ win, const float* __restrict__ bin,
    const float* __restrict__ wdw, const float* __restrict__ bdw,
    const float* __restrict__ wout, const float* __restrict__ bout,
    const float* __restrict__ ls, float* __restrict__ dx,
    float* __restrict__ xn_g, float* __restrict__ du_g,
    float* __restrict__ g_g, float* __restrict__ do0_g,
    float* __restrict__ partial, int B, int T, float eps, gcfn::Drop drop) {
  using S = BwdShape<F, TT>;
  using P = Small<F>;
  constexpr int H6 = S::H6, H3 = S::H3, R4 = S::R4, R2 = S::R2;
  extern __shared__ __align__(16) float smem[];
  float* xn = smem + S::xn;    // [R4][F] LN rows t0-2 .. t0+TT+1
  float* xh = smem + S::xh;    // [TT][F] normalized rows before the affine
  float* inv = smem + S::inv;  // [TT]   1 / std of the tile rows
  float* u = smem + S::u;      // [R4][H6] u rows t0-2 ..; later du
  float* y = smem + S::y;      // [R2][H6] y rows t0-1 .. t0+TT; later dy
  float* g = smem + S::g;      // [TT][H3] dropped GLU output
  float* d0 = smem + S::d0;    // [R2][F] do0 rows t0-1 ..; later dxn [TT]
  float* dg = smem + S::dg;    // [TT][F] o0, then [R2][H3] dg
  float* acc = smem + S::small;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_per_row = (T + TT - 1) / TT;
  const int tiles = B * tiles_per_row;
  const int tile_begin = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int tile_end = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
  for (int e = tid; e < P::size; e += kThreads) acc[e] = 0.f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int b = tile / tiles_per_row;
    const int t0 = (tile - b * tiles_per_row) * TT;
    const size_t base = (size_t)b * T;  // global row of t = 0
    __syncthreads();  // the previous tile's last reads are done

    // 1. LayerNorm of rows t0-2 .. t0+TT+1, one warp per row; the tile
    //    rows keep x-hat and 1/std for the LN backward and write xn.
    for (int r = warp; r < R4; r += kThreads / 32) {
      const int t = t0 - 2 + r, i = r - 2;
      const bool main = i >= 0 && i < TT;
      float* dst = xn + r * F;
      if (t < 0 || t >= T) {
        for (int k = lane; k < F; k += 32) {
          dst[k] = 0.f;
          if (main) xh[i * F + k] = 0.f;
        }
        if (main && lane == 0) inv[i] = 0.f;
        continue;
      }
      const float* src = x + (base + t) * F;
      float v[F / 32];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        v[q] = src[lane + 32 * q];
        s += v[q];
      }
      const float mean = gcfn::warp_sum(s) * (1.f / F);
      float s2 = 0.f;
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        v[q] -= mean;
        s2 += v[q] * v[q];
      }
      const float iv = rsqrtf(gcfn::warp_sum(s2) * (1.f / F) + eps);
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        const int k = lane + 32 * q;
        const float h = v[q] * iv, n = h * lns[k] + lnb[k];
        dst[k] = n;
        if (main) {
          xh[i * F + k] = h;
          xn_g[(base + t) * F + k] = n;
        }
      }
      if (main && lane == 0) inv[i] = iv;
    }
    __syncthreads();

    // 2. u = xn @ win + bin; rows outside [0, T) are the conv's zero pad.
    smem_product<R4, F, H6, false>(xn, F, win, u, H6);
    __syncthreads();
    for (int e = tid; e < R4 * H6; e += kThreads) {
      const int r = e / H6, j = e - r * H6, t = t0 - 2 + r;
      u[e] = (t >= 0 && t < T) ? u[e] + bin[j] : 0.f;
    }
    __syncthreads();

    // 3. y = dw3(u) for rows t0-1 .. t0+TT, and do0 = dout * ls * m1 / (1-p)
    //    there (zero outside [0, T)).
    for (int e = tid; e < R2 * H6; e += kThreads) {
      const int i = e / H6, j = e - i * H6;
      const float* w = wdw + 3 * j;
      y[e] = u[i * H6 + j] * w[0] + u[(i + 1) * H6 + j] * w[1] +
             u[(i + 2) * H6 + j] * w[2] + bdw[j];
    }
    for (int e = tid; e < R2 * F; e += kThreads) {
      const int i = e / F, f = e - i * F, t = t0 - 1 + i;
      float v = 0.f;
      if (t >= 0 && t < T) {
        const size_t gr = base + t;
        v = sep_keep(drop.seed1, (uint32_t)gr, (uint32_t)f, drop.threshold)
                ? dout[gr * F + f] * ls[f] * drop.scale
                : 0.f;
        if (i >= 1 && i <= TT) do0_g[gr * F + f] = v;
      }
      d0[e] = v;
    }
    __syncthreads();

    // 4. g = drop0(GLU(y)) for the tile rows (zero past T); written out.
    for (int e = tid; e < TT * H3; e += kThreads) {
      const int i = e / H3, c = e - i * H3, t = t0 + i;
      float v = 0.f;
      if (t < T) {
        const size_t gr = base + t;
        const float* yr = y + (i + 1) * H6;
        v = sep_keep(drop.seed0, (uint32_t)gr, (uint32_t)c, drop.threshold)
                ? yr[c] * sigmoid(yr[c + H3]) * drop.scale
                : 0.f;
        g_g[gr * H3 + c] = v;
      }
      g[e] = v;
    }
    __syncthreads();

    // 5. o0 = g @ wout for dls = sum dout * o, o = (o0 + bout) m1 / (1-p);
    //    dbout = sum do0.
    smem_product<TT, H3, F, false>(g, H3, wout, dg, F);
    __syncthreads();
    if (tid < F) {
      const int f = tid;
      float s = 0.f;
      for (int i = 0; i < TT && t0 + i < T; ++i) {
        const size_t gr = base + t0 + i;
        if (sep_keep(drop.seed1, (uint32_t)gr, (uint32_t)f, drop.threshold))
          s += dout[gr * F + f] * (dg[i * F + f] + bout[f]) * drop.scale;
      }
      acc[P::ls + f] += s;
    } else if (tid < 2 * F) {
      const int f = tid - F;
      float s = 0.f;
      for (int i = 0; i < TT; ++i) s += d0[(i + 1) * F + f];
      acc[P::bout + f] += s;
    }
    __syncthreads();

    // 6. dg = do0 @ wout^T for rows t0-1 .. t0+TT.
    smem_product<R2, F, H3, true>(d0, F, wout, dg, H3);
    __syncthreads();

    // 7. dy through the GLU with m0, in place of y; zero outside [0, T).
    for (int e = tid; e < R2 * H3; e += kThreads) {
      const int i = e / H3, c = e - i * H3, t = t0 - 1 + i;
      float* yr = y + i * H6;
      float da = 0.f, db = 0.f;
      if (t >= 0 && t < T) {
        const size_t gr = base + t;
        if (sep_keep(drop.seed0, (uint32_t)gr, (uint32_t)c, drop.threshold)) {
          const float dg0 = dg[e] * drop.scale;
          const float a = yr[c], sg = sigmoid(yr[c + H3]);
          da = dg0 * sg;
          db = dg0 * a * sg * (1.f - sg);
        }
      }
      yr[c] = da;
      yr[c + H3] = db;
    }
    __syncthreads();

    // 8. Per column j: dbdw, dwdw, then du = dy[t+1] w0 + dy[t] w1 +
    //    dy[t-1] w2 in place of u (the column's u is read first), dbin.
    for (int j = tid; j < H6; j += kThreads) {
      const float* w = wdw + 3 * j;
      float sb = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sbin = 0.f;
      for (int i = 0; i < TT && t0 + i < T; ++i) {
        const float d = y[(i + 1) * H6 + j];
        sb += d;
        s0 += d * u[(i + 1) * H6 + j];
        s1 += d * u[(i + 2) * H6 + j];
        s2 += d * u[(i + 3) * H6 + j];
      }
      for (int i = 0; i < TT; ++i) {
        float v = 0.f;
        if (t0 + i < T) {
          v = y[(i + 2) * H6 + j] * w[0] + y[(i + 1) * H6 + j] * w[1] +
              y[i * H6 + j] * w[2];
          du_g[(base + t0 + i) * H6 + j] = v;
          sbin += v;
        }
        u[(i + 2) * H6 + j] = v;
      }
      acc[P::bdw + j] += sb;
      acc[P::wdw + 3 * j] += s0;
      acc[P::wdw + 3 * j + 1] += s1;
      acc[P::wdw + 3 * j + 2] += s2;
      acc[P::bin + j] += sbin;
    }
    __syncthreads();

    // 9. dxn = du @ win^T into d0.
    smem_product<TT, H6, F, true>(u + 2 * H6, H6, win, d0, F);
    __syncthreads();

    // 10. LayerNorm backward, one warp per row; dx = dout + dx_ln.
    for (int i = warp; i < TT; i += kThreads / 32) {
      const int t = t0 + i;
      if (t >= T) continue;
      const size_t gr = base + t;
      float dh[F / 32], hv[F / 32];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        const int k = lane + 32 * q;
        dh[q] = d0[i * F + k] * lns[k];
        hv[q] = xh[i * F + k];
        s1 += dh[q];
        s2 += dh[q] * hv[q];
      }
      const float m1 = gcfn::warp_sum(s1) * (1.f / F);
      const float m2 = gcfn::warp_sum(s2) * (1.f / F);
#pragma unroll
      for (int q = 0; q < F / 32; ++q) {
        const int k = lane + 32 * q;
        dx[gr * F + k] =
            dout[gr * F + k] + (dh[q] - m1 - hv[q] * m2) * inv[i];
      }
    }
    if (tid < F) {
      const int f = tid;
      float s = 0.f;
      for (int i = 0; i < TT; ++i) s += d0[i * F + f] * xh[i * F + f];
      acc[P::lns + f] += s;
    } else if (tid < 2 * F) {
      const int f = tid - F;
      float s = 0.f;
      for (int i = 0; i < TT && t0 + i < T; ++i) s += d0[i * F + f];
      acc[P::lnb + f] += s;
    }
  }
  __syncthreads();
  for (int e = tid; e < P::size; e += kThreads)
    partial[(size_t)blockIdx.x * P::size + e] = acc[e];
}

constexpr int kTM = 64, kTN = 64, kTR = 32;

// partial[split][m][n] = sum over the split's rows r of A[r][m] * B[r][n];
// A [rows][M], B [rows][N], M and N multiples of 64.  16x16 threads, each
// a 4x4 output tile; 32 rows at a time staged in shared memory.
__global__ void __launch_bounds__(kThreads)
gcfn_train_bwd_atb_kernel(const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          float* __restrict__ partial, int rows, int M, int N,
                          int rows_per_split, long long split_stride) {
  __shared__ __align__(16) float As[kTR][kTM];
  __shared__ __align__(16) float Bs[kTR][kTN];
  const int n0 = blockIdx.x * kTN, m0 = blockIdx.y * kTM, s = blockIdx.z;
  const int r_begin = s * rows_per_split;
  const int r_end = min(rows, r_begin + rows_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float c[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  for (int r0 = r_begin; r0 < r_end; r0 += kTR) {
    for (int e = threadIdx.x; e < kTR * kTM / 4; e += kThreads) {
      const int rr = e / (kTM / 4), c4 = e - rr * (kTM / 4), r = r0 + rr;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), bv = a;
      if (r < r_end) {
        a = *reinterpret_cast<const float4*>(A + (size_t)r * M + m0 + 4 * c4);
        bv = *reinterpret_cast<const float4*>(Bm + (size_t)r * N + n0 +
                                              4 * c4);
      }
      *reinterpret_cast<float4*>(&As[rr][4 * c4]) = a;
      *reinterpret_cast<float4*>(&Bs[rr][4 * c4]) = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kTR; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&As[rr][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[rr][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] += av[i] * bw[j];
    }
    __syncthreads();
  }
  float* out = partial + (size_t)s * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (size_t)(m0 + 4 * ty + i) * N + n0 +
                               4 * tx) =
        make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
}

// out[l] = sum over s = 0, 1, ... of partial[s][l], in that order.
__global__ void __launch_bounds__(kThreads)
gcfn_train_bwd_reduce_kernel(const float* __restrict__ partial,
                             float* __restrict__ out, int splits,
                             long long len) {
  const long long l = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (l >= len) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += partial[(size_t)i * len + l];
  out[l] = s;
}

int reduce(const float* partial, float* out, int splits, long long len,
           cudaStream_t stream) {
  const int blocks = (int)((len + kThreads - 1) / kThreads);
  gcfn_train_bwd_reduce_kernel<<<blocks, kThreads, 0, stream>>>(
      partial, out, splits, len);
  return (int)cudaGetLastError();
}

// K8's partition of B x T rows at F = 128, and the floats of scratch it
// needs: xn, du, g and do0 of every row, then the partials of the row
// pass's blocks and of the weight products' splits.
struct BwdPartition {
  static constexpr int kF = 128;
  long long rows;
  int groups, splits;
  BwdPartition(int B, int T)
      : rows((long long)B * T),
        groups((int)std::min<long long>(
            (long long)B * ((T + kTT - 1) / kTT), kRowGroups)),
        splits((int)std::max<long long>(
            1, std::min<long long>(kMaxSplits, rows / 1024))) {}
  long long xn() const { return 0; }
  long long du() const { return xn() + rows * kF; }
  long long g() const { return du() + rows * 6 * kF; }
  long long do0() const { return g() + rows * 3 * kF; }
  long long small_partial() const { return do0() + rows * kF; }
  long long big_partial() const {
    return small_partial() + (long long)groups * Small<kF>::size;
  }
  long long floats() const {
    return big_partial() + (long long)splits * 9 * kF * kF;
  }
};

}  // namespace

// K7.  Pointers are device pointers to contiguous float32; win [F, 6F] and
// wout [3F, F] are [in, out], wdw [6F, 3].  seed0 and seed1 are the seed
// words of sites 0 and 1, threshold int(p * 2^24), scale 1 / (1 - p).
// Built for Base's F = 128.
extern "C" int sep_gcfn_train_fwd_f32(
    const void* x, const void* lns, const void* lnb, const void* win,
    const void* bin, const void* wdw, const void* bdw, const void* wout,
    const void* bout, const void* ls, void* out, int B, int T, int F,
    float eps, unsigned seed0, unsigned seed1, unsigned threshold,
    float scale, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0) return 0;
  if (F != 128) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = gcfn::Shape<128, kTT>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      gcfn_train_fwd_kernel<128, kTT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kTT - 1) / kTT, B);
  gcfn_train_fwd_kernel<128, kTT><<<grid, kThreads, smem, s>>>(
      f(x), f(lns), f(lnb), f(win), f(bin), f(wdw), f(bdw), f(wout),
      f(bout), f(ls), static_cast<float*>(out), T, eps,
      gcfn::Drop{seed0, seed1, threshold, scale});
  return (int)cudaGetLastError();
}

// The floats of scratch that sep_gcfn_train_bwd_f32 needs at B x T
// (F = 128; 0 for other widths).
extern "C" long long sep_gcfn_train_bwd_scratch_floats(int B, int T, int F) {
  if (B <= 0 || T <= 0 || F != 128) return 0;
  return BwdPartition(B, T).floats();
}

// K8.  Inputs as K7's plus dout [B, T, F].  Outputs: dx [B, T, F];
// grads_small [34F] = dlns [F], dlnb [F], dbin [6F], dwdw [6F][3],
// dbdw [6F], dbout [F], dls [F]; grads_big [F*6F + 3F*F] = dWin [F][6F],
// dWout [3F][F].  scratch: scratch_floats >=
// sep_gcfn_train_bwd_scratch_floats(B, T, F) floats.
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
  if (B <= 0 || T <= 0) return 0;
  const BwdPartition part(B, T);
  if (F != 128 || scratch_floats < part.floats())
    return (int)cudaErrorInvalidValue;
  constexpr int kF = 128, H6 = 6 * kF, H3 = 3 * kF;
  float* base = w(scratch);
  float *xn = base + part.xn(), *du = base + part.du(), *g = base + part.g(),
        *do0 = base + part.do0(), *small_partial = base + part.small_partial(),
        *big_partial = base + part.big_partial();
  constexpr size_t smem = BwdShape<kF, kTT>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      gcfn_train_bwd_rows_kernel<kF, kTT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gcfn_train_bwd_rows_kernel<kF, kTT><<<part.groups, kThreads, smem, s>>>(
      f(x), f(dout), f(lns), f(lnb), f(win), f(bin), f(wdw), f(bdw),
      f(wout), f(bout), f(ls), w(dx), xn, du, g, do0, small_partial, B, T,
      eps, gcfn::Drop{seed0, seed1, threshold, scale});
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int rows = B * T;
  const int per_split = (rows + part.splits - 1) / part.splits;
  const long long big = (long long)kF * H6 + (long long)H3 * kF;
  gcfn_train_bwd_atb_kernel<<<dim3(H6 / kTN, kF / kTM, part.splits),
                              kThreads, 0, s>>>(xn, du, big_partial, rows, kF,
                                                H6, per_split, big);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gcfn_train_bwd_atb_kernel<<<dim3(kF / kTN, H3 / kTM, part.splits),
                              kThreads, 0, s>>>(
      g, do0, big_partial + (size_t)kF * H6, rows, H3, kF, per_split, big);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int e = reduce(big_partial, w(grads_big), part.splits, big, s);
  if (e) return e;
  return reduce(small_partial, w(grads_small), part.groups, Small<kF>::size,
                s);
}
