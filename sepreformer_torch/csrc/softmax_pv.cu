// Masked softmax·V (eval): for each (b, h, i),
//   lim = min(length, lens[b]);  p = softmax(scores[b, h, i, :lim]) in f32;
//   out[b, i, h*D:(h+1)*D] = sum_j p[j] * v[b, j, h*D:(h+1)*D].
// Keys j >= lim are the -1e30 keys of the reference: their weight is
// exactly 0 in float32, so they are skipped and never read.  V and the
// output are channels-last [B, Lp, H*D].
//
// Replaces: sepreformer_tpu/ops/pallas/softmax_pv.py::softmax_pv
//           (_kernel, full row, and _kernel_kb, query- and key-blocked).
// The TPU needed two bodies because a full [Lp, Lp] row block did not
// fit VMEM at long lengths.  This one kernel streams the keys in chunks
// with an online softmax, so it serves every length the path uses.
//
// What bounds it on the H100: each score is read once and used for one
// exp and D multiply-adds, so it is bound by the bytes of the scores
// tensor (B*H*Lp*lim*4: 67 MB at B=8, H=8, Lp=512) at 3.35 TB/s.
//
// Design: one block of 8 warps per (query tile of 64 rows, head, batch).
// The block stages a chunk of V's head slice in shared memory (rows
// padded by one float4, so the lanes' 16-byte reads hit distinct banks),
// then each warp takes one query row at a time.  Each lane loads its
// keys of the chunk (j = lane + 32q) into registers with all loads in
// flight, the warp takes the chunk's max with shuffles, each lane sums
// exp(s - max) and its D products with V, and the warp merges those with
// shuffles into the row's running max, sum and accumulators in shared
// memory (the online softmax across chunks).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;          // query rows per block
constexpr int kSmemBytes = 48 * 1024;  // the default dynamic smem limit

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D>
struct PvShape {
  static constexpr int RS = D / 4 + 1;  // staged V row stride in float4
  static constexpr int kStateBytes = sizeof(float) * kRows * (D + 2);
  // keys per chunk: a multiple of 32 that fits beside the row state
  static constexpr int KC = ((kSmemBytes - kStateBytes) / (RS * 16)) / 32 * 32;
  static constexpr size_t smem_bytes =
      sizeof(float4) * (size_t)KC * RS + kStateBytes;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
softmax_pv_kernel(const float* __restrict__ scores,
                  const float* __restrict__ v, const int* __restrict__ lens,
                  float* __restrict__ out, int H, int Lp, int F, int length) {
  using S = PvShape<D>;
  constexpr int RS = S::RS, KC = S::KC, NPL = KC / 32;
  extern __shared__ __align__(16) float4 smem4[];
  float4* vs = smem4;                                   // [KC][RS]
  float* row_m = reinterpret_cast<float*>(smem4 + KC * RS);  // [kRows]
  float* row_l = row_m + kRows;                         // [kRows]
  float* row_acc = row_l + kRows;                       // [kRows][D]

  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int rows = min(kRows, Lp - i0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lim = min(min(length, lens[b]), Lp);

  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.f;
  }
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) row_acc[e] = 0.f;

  const float* vb = v + (size_t)b * Lp * F + h * D;
  const float* sb = scores + ((size_t)b * H + h) * Lp * Lp;

  for (int k0 = 0; k0 < lim; k0 += KC) {
    const int kc = min(KC, lim - k0);
    __syncthreads();  // previous chunk fully consumed (and state zeroed)
    for (int e = threadIdx.x; e < kc * (D / 4); e += kThreads) {
      const int j = e / (D / 4), q = e - j * (D / 4);
      vs[j * RS + q] =
          reinterpret_cast<const float4*>(vb + (size_t)(k0 + j) * F)[q];
    }
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      const float* srow = sb + (size_t)(i0 + r) * Lp + k0;
      // all of the lane's scores of this chunk in flight at once
      float sv[NPL];
#pragma unroll
      for (int q = 0; q < NPL; ++q) {
        const int j = lane + 32 * q;
        sv[q] = j < kc ? srow[j] : -INFINITY;
      }
      float m = -INFINITY;
#pragma unroll
      for (int q = 0; q < NPL; ++q) m = fmaxf(m, sv[q]);
      const float m_chunk = warp_max(m);
      float l = 0.f;
      float acc[D];
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = 0.f;
#pragma unroll
      for (int q = 0; q < NPL; ++q) {
        const int j = lane + 32 * q;
        if (j < kc) {
          const float p = expf(sv[q] - m_chunk);
          l += p;
#pragma unroll
          for (int c4 = 0; c4 < D / 4; ++c4) {
            const float4 vv = vs[j * RS + c4];
            acc[4 * c4 + 0] += p * vv.x;
            acc[4 * c4 + 1] += p * vv.y;
            acc[4 * c4 + 2] += p * vv.z;
            acc[4 * c4 + 3] += p * vv.w;
          }
        }
      }
      // merge the chunk into the row's running state
      const float l_chunk = warp_sum(l);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, m_chunk);
      const float c_old = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
      const float c_chunk = expf(m_chunk - m_new);
      float mine = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float a = warp_sum(acc[c]);
        if (lane == c) mine = a;
      }
      if (lane < D)
        row_acc[r * D + lane] = row_acc[r * D + lane] * c_old + mine * c_chunk;
      __syncwarp();
      if (lane == 0) {
        row_l[r] = row_l[r] * c_old + l_chunk * c_chunk;
        row_m[r] = m_new;
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    out[((size_t)b * Lp + i0 + r) * F + h * D + c] = row_acc[e] / row_l[r];
  }
}

template <int D>
int launch(const float* scores, const float* v, const int* lens, float* out,
           int B, int H, int Lp, int F, int length, cudaStream_t stream) {
  constexpr size_t smem = PvShape<D>::smem_bytes;
  static_assert(smem <= kSmemBytes, "fits the default smem limit");
  dim3 grid((Lp + kRows - 1) / kRows, H, B);
  softmax_pv_kernel<D><<<grid, kThreads, smem, stream>>>(scores, v, lens, out,
                                                         H, Lp, F, length);
  return (int)cudaGetLastError();
}

}  // namespace

// scores: device float32 [B, H, Lp, Lp]; v, out: [B, Lp, F] with F = H*D;
// lens: device int32 [B], each >= 1; length: true length <= Lp.
// Built for Base's head width D = 16.
extern "C" int sep_softmax_pv_f32(const void* scores, const void* v,
                                  const void* lens, void* out, int B, int H,
                                  int Lp, int F, int length, void* stream) {
  auto s = static_cast<const float*>(scores);
  auto vv = static_cast<const float*>(v);
  auto l = static_cast<const int*>(lens);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Lp <= 0) return 0;
  if (H <= 0 || F % H != 0 || length < 1 || length > Lp)
    return (int)cudaErrorInvalidValue;
  if (F / H != 16) return (int)cudaErrorInvalidValue;
  return launch<16>(s, vv, l, o, B, H, Lp, F, length, st);
}
