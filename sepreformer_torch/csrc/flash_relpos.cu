// Flash attention with the relative-position bias in the kernel (eval),
// K12: for each (b, h, i),
//   lim = min(L, lens[b]);
//   s_j = (q_i·k_j + q_i·table[clip(i - j, -maxlen, maxlen - 1) + maxlen])
//         / sqrt(D),  j < lim;
//   out[b, i, h*D:(h+1)*D] = softmax(s)·V   (float32 throughout).
// q, k, v and out are channels-last [B, L, H*D]; table is the raw
// [2*maxlen, D] embedding.  Nothing of size [L, L] is ever stored.
//
// Replaces: sepreformer_tpu/ops/pallas/attention.py::flash_relpos_attention
//           (_flash_kernel), which the JAX package's "auto" rule runs in
//           eval at bottleneck lengths L > 8192.
//
// What bounds it on the H100: per head, the function needs 4*D operations
// per (i, valid j) pair for QKᵀ and P·V, 2*D per query row for each
// distinct clamped table row its keys reach, and one exponential per
// pair, against q, k, v and out read or written once (bytes grow as L,
// operations as L²).  Taken on the tensor cores at float32 accuracy
// (3xTF32, mma_tf32x3.cuh: 165 TFLOP/s) the products need about 0.5 ms at
// B = 2, H = 8, L = 8750, lens (8750, 7000), maxlen 2000, and the 1.1e9
// exponentials about 0.26 ms of the SFUs; the bytes 0.01 ms.
//
// Design: one block of 4 warps per (64 query rows, b*h); each warp owns 16
// rows, keeps their Q fragments (split once) in registers, and walks the
// key tiles of 64 keys below lim with an online softmax whose running max
// and sum live in registers (quad shuffles, no block barrier).  K, V and
// the block's band of 128 clamped table rows, rel = i - j from
// i0 - j0 - 63 on, are double-buffered in shared memory with cp.async, so
// the next tile's loads overlap this tile's products.  Per (warp, tile):
//  - S = Q Kᵀ by 3xTF32 m16n8k8 products (16 x 64 in C fragments);
//  - the bias by the tile's class: where every pair has i - j >= maxlen - 1
//    (or every pair <= -maxlen) it is the per-row constant q_i·table[2m-1]
//    (or q_i·table[0]), taken once per row and applied as a shift of the
//    row's max; otherwise Q·bandᵀ over the warp's 79 band rows on the
//    tensor cores into the warp's shared buffer, and each (i, j) adds its
//    diagonal entry i - j + 63;
//  - the scale folded with log2(e) into Q, 2^x on the SFU, and the key
//    mask only on the tile that crosses lim;
//  - P·V with P kept in registers: the C fragment's columns 2t and 2t+1
//    serve as the A fragment's k slots t and t+4, and V's rows are read
//    in that order; each tile's P·V starts from zeroed fragments and is
//    added to the running output in float32 registers.
// Query rows past L are computed on zeros and never written; keys at or
// past lim are zero in shared memory and score -inf; every tile holds at
// least one valid key, so the running max is finite after the first tile.
// Every sum has a fixed order: two runs give the same bits.
//
// What holds it above that bound is the instruction issue: per tile a
// warp splits 136 floats (K, V, P and, on band tiles, the band), three
// instructions each, beside its 96 (156 on band tiles) mma and the
// softmax's float32 work; 16 warps per SM (54 KB of shared memory and at
// most 128 registers per thread) hide the products' latency.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int D = 16;                   // head width (Base: 128 / 8 heads)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;      // query rows per block
constexpr int kKeys = 64;               // keys per tile
constexpr int kBand = 128;              // band rows staged (127 used; 128
                                        // lets every warp read 80)
constexpr int kWarpBand = 80;           // a warp's band columns (79 used)
// Row strides in floats.  K and the band are read as one 16-byte
// fragment load per row and lane (columns 4t .. 4t+3), conflict-free at
// stride D; V as scalars (rows 2t, 2t+1), conflict-free at D + 4.
constexpr int kKS = D, kVS = D + 4;
constexpr int kBS = kWarpBand;          // a warp's bias rows
constexpr int kStage = kKeys * (kKS + kVS) + kBand * kKS;  // floats
// 54 KB: four blocks (16 warps) per SM
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * (size_t)kStage + (size_t)kWarps * 16 * kBS);
static_assert(kThreads == 128 && D == 16 && kKeys % 32 == 0 &&
                  kBand % 32 == 0,
              "each thread stages 16 bytes of every 32nd row");

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

__global__ void __launch_bounds__(kThreads, 4)
flash_relpos_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ table,
                    const int* __restrict__ lens, float* __restrict__ out,
                    int L, int H, int maxlen, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int F = H * D;
  const int i0 = blockIdx.x * kRows;
  const int iw = i0 + 16 * warp;          // this warp's first row
  const int lim = min(L, lens[b]);
  const size_t head = (size_t)b * L * F + (size_t)h * D;
  float* wbias = smem + 2 * kStage + warp * 16 * kBS;

  // Q fragments of rows iw+g and iw+g+8 (zero past L), scaled by
  // log2(e) / sqrt(D) and split once; the rows' clamped-bias constants
  // q·table[2m-1] and q·table[0] of the scaled rows.
  // The head width is the products' k: k-step ks puts column 4t + 2ks in
  // slot t and 4t + 2ks + 1 in slot t + 4, so a lane's four columns of a
  // row of Q, K or the band are one 16-byte load.
  uint32_t qb[2][4], qs[2][4];
  float hi[2], lo[2];
  {
    float qv[2][4];  // [row g, g+8][column 4t .. 4t+3]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + g + 8 * r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < L)
        x = *reinterpret_cast<const float4*>(q + head + (size_t)i * F + 4 * t);
      qv[r][0] = x.x * scale_log2;
      qv[r][1] = x.y * scale_log2;
      qv[r][2] = x.z * scale_log2;
      qv[r][3] = x.w * scale_log2;
    }
    const float* top = table + (size_t)(2 * maxlen - 1) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sh = 0.f, sl = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sh = fmaf(qv[r][c], top[4 * t + c], sh);
        sl = fmaf(qv[r][c], table[4 * t + c], sl);
      }
      hi[r] = quad_sum(sh);
      lo[r] = quad_sum(sl);
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float a[4] = {qv[0][2 * ks], qv[1][2 * ks], qv[0][2 * ks + 1],
                          qv[1][2 * ks + 1]};
      tf32x3::split(a, qb[ks], qs[ks]);
    }
  }

  // stage a key tile: K and V rows j0 .. j0+63 (zero at or past lim) and,
  // unless every pair of the block clamps, the band rows.  Thread tid
  // copies 16 bytes (columns c4 .. c4+3) of rows tid/4 + 32 it.
  const int r0 = tid >> 2, c4 = (tid & 3) * 4;
  auto stage = [&](int buf, int j0) {
    float* ks_ = smem + buf * kStage;
    float* vs_ = ks_ + kKeys * kKS;
    float* band = vs_ + kKeys * kVS;
#pragma unroll
    for (int it = 0; it < kKeys / 32; ++it) {
      const int r = r0 + 32 * it, j = j0 + r;
      const bool ok = j < lim;
      const size_t off = head + (size_t)(ok ? j : 0) * F + c4;
      cp_async16(ks_ + r * kKS + c4, k + off, ok);
      cp_async16(vs_ + r * kVS + c4, v + off, ok);
    }
    const int rel0 = i0 - j0 - (kKeys - 1);
    if (rel0 < maxlen - 1 && rel0 + kRows + kKeys - 2 > -maxlen) {
#pragma unroll
      for (int it = 0; it < kBand / 32; ++it) {
        const int r = r0 + 32 * it;
        const int row = min(max(rel0 + r, -maxlen), maxlen - 1) + maxlen;
        cp_async16(band + r * kKS + c4, table + (size_t)row * D + c4, true);
      }
    }
    cp_async_commit();
  };

  float o[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  const int tiles = (lim + kKeys - 1) / kKeys;
  stage(0, 0);
  for (int n = 0; n < tiles; ++n) {
    const int j0 = n * kKeys;
    if (n + 1 < tiles) {
      stage((n + 1) & 1, j0 + kKeys);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks_ = smem + (n & 1) * kStage;
    const float* vs_ = ks_ + kKeys * kKS;
    const float* band = vs_ + kKeys * kVS + 16 * warp * kKS;

    // S = Q Kᵀ: n-tile nt holds keys 8nt .. 8nt+7
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const float4 kk =
          *reinterpret_cast<const float4*>(ks_ + (8 * nt + g) * kKS + 4 * t);
      tf32x3::mma3(s[nt], qb[0], qs[0], kk.x, kk.y);
      tf32x3::mma3(s[nt], qb[1], qs[1], kk.z, kk.w);
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
        const float4 bb =
            *reinterpret_cast<const float4*>(band + (8 * m + g) * kKS + 4 * t);
        tf32x3::mma3(c, qb[0], qs[0], bb.x, bb.y);
        tf32x3::mma3(c, qb[1], qs[1], bb.z, bb.w);
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

    // the key mask on the tile that crosses lim, and the online softmax
    // of rows g and g+8 (the scores are in log2 units)
    if (j0 + kKeys > lim) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + 8 * nt + 2 * t + (e & 1) >= lim) s[nt][e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    float alpha[2], m_sub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]) + shift[r]);
      alpha[r] = ex2(m_run[r] - m_new);     // 0 at the first tile
      m_run[r] = m_new;
      m_sub[r] = m_new - shift[r];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ex2(s[nt][e] - m_sub[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];

    // P V: slot t of k-step nt is key 8nt + 2t, slot t+4 key 8nt+2t+1.
    // Two chains of fresh accumulators (k-steps nt mod 2), summed and
    // added to O in float32 (mma_tf32x3.cuh: the tensor cores' own
    // accumulation drifts over many tiles).
    float pv[2][2][4] = {};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float a[4] = {s[nt][0], s[nt][2], s[nt][1], s[nt][3]};
      uint32_t pb[4], ps[4];
      tf32x3::split(a, pb, ps);
      const float* vp = vs_ + (8 * nt + 2 * t) * kVS + g;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
        tf32x3::mma3(pv[nt & 1][nn], pb, ps, vp[8 * nn], vp[kVS + 8 * nn]);
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[nn][e] = o[nn][e] * alpha[e >> 1] + (pv[0][nn][e] + pv[1][nn][e]);
    __syncthreads();  // this stage's buffers are consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = iw + g + 8 * r;
    const float inv = 1.f / fmaxf(quad_sum(l_run[r]), 1e-30f);
    if (i < L) {
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
        *reinterpret_cast<float2*>(out + head + (size_t)i * F + 8 * nn +
                                   2 * t) =
            make_float2(o[nn][2 * r] * inv, o[nn][2 * r + 1] * inv);
    }
  }
}

}  // namespace

// q, k, v, out: device float32 [B, L, H*16] (16-byte aligned); table:
// device float32 [2*maxlen, 16]; lens: device int32 [B], each >= 1 (the
// wrapper clamps them to L).  Built for Base's head width 16.
extern "C" int sep_flash_relpos_f32(const void* q, const void* k,
                                    const void* v, const void* table,
                                    const void* lens, void* out, int B, int L,
                                    int H, int maxlen, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H <= 0 || maxlen <= 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_relpos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kRows - 1) / kRows, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 1 / sqrt(D) and log2(e): exp(x / 4) = exp2(x * log2(e) / 4)
  flash_relpos_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(table),
      static_cast<const int*>(lens), static_cast<float*>(out), L, H, maxlen,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}
