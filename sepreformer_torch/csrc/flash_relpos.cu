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
// What bounds it on the H100: per head, the function needs 4*D float32
// operations per (i, valid j) pair for QKᵀ and P·V, and 2*D per query row
// for each of the at most 2*maxlen distinct clamped table rows its keys
// reach (Q·peᵀ), against q, k, v and out read or written once (bytes
// grow as L, operations as L²), so it is bound by the 67 TFLOP/s of the
// CUDA cores: 8.5e10 operations, 1.27 ms, at B = 2, H = 8, L = 8750,
// lens (8750, 7000), maxlen 2000.  This first kernel computes the bias
// per pair (6*D operations per pair in all), on the CUDA cores with
// FMAs from shared memory; tensor cores (3xTF32 to keep float32
// accuracy) are later work.
//
// Design: one block of 256 threads per (64 query rows, b*h) walks the
// key tiles of 64 keys below lim with an online softmax (running max and
// sum per row, expf).  A key tile stages K (transposed), V, and the
// 2*64 - 1 clamped table rows of the tile pair's band, rel = i - j in
// [i0 - j0 - 63, i0 - j0 + 63], in shared memory.  The TPU kernel
// needed a reversed pre-gathered table and a barrel shifter because
// Mosaic has no gather and no reverse; here the clamp is applied when
// the band is staged, and each (i, j) reads its row at band index
// i - j + 63.  Each thread keeps its 4 query rows in registers and
// computes a 4 x 4 block of scores (q·k and q·pe as two FMAs per
// element); the probabilities go to shared memory, and each thread then
// owns 4 output columns of one row for P·V.  Query rows past L are
// computed on zeros and never written; keys at or past lim score -inf
// (exp gives 0), and every staged tile holds at least one valid key, so
// the running max is finite after the first tile.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 16;                  // head width (Base: 128 / 8 heads)
constexpr int kTile = 64;              // query rows per block, keys per tile
constexpr int kThreads = 256;          // 16 x 16: 4 rows x 4 keys each
constexpr int kBand = 2 * kTile;       // band rows staged (127 used)
constexpr int kKS = kTile + 4;         // padded strides, in floats; keep
constexpr int kBS = kBand + 4;         // every row 16-byte aligned
constexpr int kPS = kTile + 4;

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

__global__ void __launch_bounds__(kThreads)
flash_relpos_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ table,
                    const int* __restrict__ lens, float* __restrict__ out,
                    int L, int H, int maxlen, float scale) {
  __shared__ __align__(16) float kt[D * kKS];     // kt[c][jj]: K transposed
  __shared__ __align__(16) float vs[kTile * D];   // vs[jj][c]
  __shared__ __align__(16) float pe[D * kBS];     // pe[c][rr]: band rows
  __shared__ __align__(16) float ps[kTile * kPS]; // ps[ii][jj]: probabilities
  __shared__ float row_alpha[kTile];              // exp(m_old - m_new)
  __shared__ float row_l[kTile];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // keys 4tx..4tx+3 of a tile
  const int ty = tid >> 4;   // rows 4ty..4ty+3; a warp holds two ty, and
                             // the 16 lanes of one ty reduce by shuffles
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int F = H * D;
  const int i0 = blockIdx.x * kTile;
  const int lim = min(L, lens[b]);
  const size_t head = (size_t)b * L * F + (size_t)h * D;

  float qr[4][D];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
#pragma unroll
    for (int c4 = 0; c4 < D / 4; ++c4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < L)
        x = reinterpret_cast<const float4*>(q + head + (size_t)i * F)[c4];
      qr[a][4 * c4 + 0] = x.x;
      qr[a][4 * c4 + 1] = x.y;
      qr[a][4 * c4 + 2] = x.z;
      qr[a][4 * c4 + 3] = x.w;
    }
  }
  float m_run[4], l_run[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = -INFINITY;
    l_run[a] = 0.f;
  }
  // P·V: this thread's row and 4 output columns
  const int orow = tid >> 2, oc = (tid & 3) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // band index of (row 4ty + a, key 4tx + b) is band0 + 3 + a - b
  const int band0 = 4 * (ty - tx) + kTile - 4;

  for (int j0 = 0; j0 < lim; j0 += kTile) {
    __syncthreads();  // the previous tile's shared arrays are consumed
    {
      const int jj = tid >> 2, c4 = (tid & 3) * 4;
      const int j = j0 + jj;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < lim) {
        kv = *reinterpret_cast<const float4*>(k + head + (size_t)j * F + c4);
        vv = *reinterpret_cast<const float4*>(v + head + (size_t)j * F + c4);
      }
      kt[(c4 + 0) * kKS + jj] = kv.x;
      kt[(c4 + 1) * kKS + jj] = kv.y;
      kt[(c4 + 2) * kKS + jj] = kv.z;
      kt[(c4 + 3) * kKS + jj] = kv.w;
      *reinterpret_cast<float4*>(vs + jj * D + c4) = vv;
    }
    const int rel0 = i0 - j0 - (kTile - 1);
    for (int e = tid; e < kBand * D; e += kThreads) {
      const int rr = e / D, c = e - rr * D;
      const int row = min(max(rel0 + rr, -maxlen), maxlen - 1) + maxlen;
      pe[c * kBS + rr] = table[(size_t)row * D + c];
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) s[a][bb] = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float* pc = pe + c * kBS + band0;
      const float4 kk =
          *reinterpret_cast<const float4*>(kt + c * kKS + 4 * tx);
      const float4 p0 = *reinterpret_cast<const float4*>(pc);
      const float4 p1 = *reinterpret_cast<const float4*>(pc + 4);
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          s[a][bb] = fmaf(qr[a][c], kv[bb], s[a][bb]);
          s[a][bb] = fmaf(qr[a][c], pv[3 + a - bb], s[a][bb]);
        }
    }

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
      }
      l_run[a] = l_run[a] * alpha + half_warp_sum(sum);
      m_run[a] = m_new;
      if (tx == 0) row_alpha[4 * ty + a] = alpha;
      *reinterpret_cast<float4*>(ps + (4 * ty + a) * kPS + 4 * tx) =
          make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
    }
    __syncthreads();

    const float alpha = row_alpha[orow];
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[x] *= alpha;
    const float* prow = ps + orow * kPS;
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
    for (int a = 0; a < 4; ++a) row_l[4 * ty + a] = l_run[a];
  }
  __syncthreads();
  const int i = i0 + orow;
  if (i < L) {
    const float l = fmaxf(row_l[orow], 1e-30f);
    *reinterpret_cast<float4*>(out + head + (size_t)i * F + oc) =
        make_float4(acc[0] / l, acc[1] / l, acc[2] / l, acc[3] / l);
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
  dim3 grid((L + kTile - 1) / kTile, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_relpos_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(table),
      static_cast<const int*>(lens), static_cast<float*>(out), L, H, maxlen,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}
