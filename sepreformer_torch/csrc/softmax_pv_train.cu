// Masked softmax · hash dropout · V for training, forward (K9) and
// backward (K10).  For each (b, h, query row i), with lim = min(length,
// lens[b]) valid keys:
//   m = max_j s[j],  e[j] = exp(s[j] - m),  l = sum_j e[j]  (j < lim)
//   keep[j] = hash(seed, 0, (b*H + h)*Lp + i, j) >= p  (csrc comment below)
//   out[b, i, h*D:(h+1)*D] = sum_j e[j] * keep[j] / (1 - p) * v[b, j, h*D:]
//                            / l
// l is taken before the drop: the kept weights are not renormalised.  The
// backward, with P = e / l and Pd = P * keep / (1 - p):
//   dV[j]  = sum_i Pd[i, j] * dOut[i]
//   dP     = (dOut[i] . V[j]) * keep / (1 - p)
//   dS     = P * (dP - rowsum(dP * P)),  rowsum(dP * P) = dOut[i] . out[i]
// Keys j >= lim have P = 0: the forward skips them and the backward writes
// dS = 0 there.  V, out, dOut and dV are channels-last [B, Lp, H*D].  The
// two-tensor forms (K9b, K10b) read s = scores + bias, both [B, H, Lp, Lp],
// summed in f32 as they are loaded, in the forward and again where the
// backward recomputes P; dS is then also the bias's cotangent.
//
// Replaces: sepreformer_tpu/ops/pallas/softmax_pv_train.py::
//           softmax_pv_dropout, forward _fwd_impl (body _fwd_kernel) and
//           backward _bwd_impl (body _bwd_kernel), each with has_bias
//           False and True.
//
// The dropout hash is ops/pallas/gcfn_train.py::keep_mask, bit for bit
// (hash_dropout.cuh, shared with K7 and K8), at site 0.
//
// What bounds them on the H100: the forward reads each valid score once
// (B*H*Lp*lim floats, 33 MB at B=4, H=8, Lp=512, lim=500) and the backward
// reads every score and writes every dS (2 * B*H*Lp*Lp floats, 67 MB); both
// do a few tens of operations per score, so both are bound by bytes.  The
// two-tensor forms read the bias's bytes too.
//
// Design.  K9 is K3's kernel (csrc/softmax_pv.cu) with the mask applied to
// the numerator only: one block per (64 query rows, head, batch) streams
// the keys in chunks of V staged in shared memory, one warp per row, with
// an online softmax across chunks; it also writes each row's max and sum,
// which the backward reuses.  K10's sum over query rows for dV is the part
// the TPU did in one grid step per (b, h): here one block takes 32 keys of
// one (b, h) and walks every query row, so it owns its dV rows outright and
// needs no second pass and no atomics.  Lanes run along keys (coalesced
// score loads and dS stores), each lane keeps its key's V row and dV
// partial in registers, the 8 warps split the rows, and their dV partials
// are added in a fixed order at the end.  Each row's dOut slice, max, 1/sum
// and dOut . out are staged in shared memory for the warps to broadcast.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_dropout.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;               // K9: query rows per block
constexpr int kSmemBytes = 48 * 1024;   // the default dynamic smem limit
constexpr int kKeys = 32;               // K10: keys per block
constexpr int kRowChunk = 64;           // K10: rows staged at a time

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
struct FwdShape {
  static constexpr int RS = D / 4 + 1;  // staged V row stride in float4
  static constexpr int kStateBytes = sizeof(float) * kRows * (D + 2);
  static constexpr int KC = ((kSmemBytes - kStateBytes) / (RS * 16)) / 32 * 32;
  static constexpr size_t smem_bytes =
      sizeof(float4) * (size_t)KC * RS + kStateBytes;
};

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
softmax_pv_train_fwd_kernel(const float* __restrict__ scores,
                            const float* __restrict__ bias,
                            const float* __restrict__ v,
                            const int* __restrict__ lens,
                            float* __restrict__ out,
                            float* __restrict__ row_max_out,
                            float* __restrict__ row_sum_out, int H, int Lp,
                            int F, int length, uint32_t seed_word,
                            uint32_t threshold, float keep_scale) {
  using S = FwdShape<D>;
  constexpr int RS = S::RS, KC = S::KC, NPL = KC / 32;
  extern __shared__ __align__(16) float4 smem4[];
  float4* vs = smem4;                                       // [KC][RS]
  float* row_m = reinterpret_cast<float*>(smem4 + KC * RS);  // [kRows]
  float* row_l = row_m + kRows;                             // [kRows]
  float* row_acc = row_l + kRows;                           // [kRows][D]

  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = blockIdx.x * kRows;
  const int rows = min(kRows, Lp - i0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lim = min(min(length, lens[b]), Lp);
  const uint32_t row_base = (uint32_t)((b * H + h) * Lp + i0);

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
      const size_t row_off = (size_t)(i0 + r) * Lp + k0;
      const float* srow = sb + row_off;
      float sv[NPL];
#pragma unroll
      for (int q = 0; q < NPL; ++q) {
        const int j = lane + 32 * q;
        sv[q] = j < kc ? srow[j] : -INFINITY;
      }
      if constexpr (HAS_BIAS) {
        const float* brow = bias + ((size_t)b * H + h) * Lp * Lp + row_off;
#pragma unroll
        for (int q = 0; q < NPL; ++q) {
          const int j = lane + 32 * q;
          if (j < kc) sv[q] += brow[j];
        }
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
          float pd = p;
          if (threshold)
            pd = sep_keep(seed_word, row_base + r, (uint32_t)(k0 + j),
                          threshold)
                     ? p * keep_scale
                     : 0.f;
#pragma unroll
          for (int c4 = 0; c4 < D / 4; ++c4) {
            const float4 vv = vs[j * RS + c4];
            acc[4 * c4 + 0] += pd * vv.x;
            acc[4 * c4 + 1] += pd * vv.y;
            acc[4 * c4 + 2] += pd * vv.z;
            acc[4 * c4 + 3] += pd * vv.w;
          }
        }
      }
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
  const size_t stat = ((size_t)b * H + h) * Lp + i0;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    row_max_out[stat + r] = row_m[r];
    row_sum_out[stat + r] = row_l[r];
  }
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
softmax_pv_train_bwd_kernel(const float* __restrict__ scores,
                            const float* __restrict__ bias,
                            const float* __restrict__ v,
                            const float* __restrict__ out,
                            const float* __restrict__ dout,
                            const float* __restrict__ row_max,
                            const float* __restrict__ row_sum,
                            const int* __restrict__ lens,
                            float* __restrict__ dscores,
                            float* __restrict__ dv, int H, int Lp, int F,
                            int length, uint32_t seed_word,
                            uint32_t threshold, float keep_scale) {
  __shared__ float dout_s[kRowChunk][D];
  __shared__ float m_s[kRowChunk], linv_s[kRowChunk], rowdot_s[kRowChunk];
  __shared__ float red[kWarps][kKeys][D + 1];

  const int h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kKeys + lane;
  const int lim = min(min(length, lens[b]), Lp);
  const bool valid = j < lim;
  const size_t bh = (size_t)b * H + h;
  const float* sb = scores + bh * Lp * Lp;
  float* dsb = dscores + bh * Lp * Lp;

  float vj[D], dvj[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    vj[c] = valid ? v[((size_t)b * Lp + j) * F + h * D + c] : 0.f;
    dvj[c] = 0.f;
  }

  for (int r0 = 0; r0 < Lp; r0 += kRowChunk) {
    const int rows = min(kRowChunk, Lp - r0);
    __syncthreads();  // the previous chunk's staging is consumed
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      const int r = e / D, c = e - r * D;
      dout_s[r][c] = dout[((size_t)b * Lp + r0 + r) * F + h * D + c];
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const size_t row = ((size_t)b * Lp + r0 + r) * F + h * D;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot += dout[row + c] * out[row + c];
      rowdot_s[r] = dot;
      m_s[r] = row_max[bh * Lp + r0 + r];
      linv_s[r] = 1.f / row_sum[bh * Lp + r0 + r];
    }
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      const int i = r0 + r;
      float ds = 0.f;
      if (valid) {
        float s = sb[(size_t)i * Lp + j];
        if constexpr (HAS_BIAS) s += bias[bh * Lp * Lp + (size_t)i * Lp + j];
        const float p = expf(s - m_s[r]) * linv_s[r];
        float scale = 1.f;
        if (threshold)
          scale = sep_keep(seed_word, (uint32_t)(bh * Lp + i), (uint32_t)j,
                           threshold)
                      ? keep_scale
                      : 0.f;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) dot += dout_s[r][c] * vj[c];
        ds = p * (dot * scale - rowdot_s[r]);
        const float pd = p * scale;
#pragma unroll
        for (int c = 0; c < D; ++c) dvj[c] += pd * dout_s[r][c];
      }
      if (j < Lp) dsb[(size_t)i * Lp + j] = ds;
    }
  }

#pragma unroll
  for (int c = 0; c < D; ++c) red[warp][lane][c] = dvj[c];
  __syncthreads();
  for (int e = threadIdx.x; e < kKeys * D; e += kThreads) {
    const int k = e / D, c = e - k * D;
    const int jj = blockIdx.x * kKeys + k;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][k][c];
    if (jj < Lp) dv[((size_t)b * Lp + jj) * F + h * D + c] = s;
  }
}

template <int D, bool HAS_BIAS>
int launch_fwd(const float* scores, const float* bias, const float* v,
               const int* lens, float* out, float* row_max, float* row_sum,
               int B, int H, int Lp, int F, int length, uint32_t seed_word,
               uint32_t threshold, float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = FwdShape<D>::smem_bytes;
  static_assert(smem <= kSmemBytes, "fits the default smem limit");
  dim3 grid((Lp + kRows - 1) / kRows, H, B);
  softmax_pv_train_fwd_kernel<D, HAS_BIAS><<<grid, kThreads, smem, stream>>>(
      scores, bias, v, lens, out, row_max, row_sum, H, Lp, F, length,
      seed_word, threshold, keep_scale);
  return (int)cudaGetLastError();
}

template <int D, bool HAS_BIAS>
int launch_bwd(const float* scores, const float* bias, const float* v,
               const float* out, const float* dout, const float* row_max,
               const float* row_sum, const int* lens, float* dscores,
               float* dv, int B, int H, int Lp, int F, int length,
               uint32_t seed_word, uint32_t threshold, float keep_scale,
               cudaStream_t stream) {
  dim3 grid((Lp + kKeys - 1) / kKeys, H, B);
  softmax_pv_train_bwd_kernel<D, HAS_BIAS><<<grid, kThreads, 0, stream>>>(
      scores, bias, v, out, dout, row_max, row_sum, lens, dscores, dv, H, Lp,
      F, length, seed_word, threshold, keep_scale);
  return (int)cudaGetLastError();
}

int check(int B, int H, int Lp, int F, int length) {
  if (H <= 0 || F % H != 0 || length < 1 || length > Lp || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  if (F / H != 16) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// scores: device float32 [B, H, Lp, Lp]; v, out: [B, Lp, F] with F = H*D
// (D = 16, Base's head width); lens: device int32 [B], each >= 1;
// row_max, row_sum: [B, H, Lp] outputs for the backward.  seed_word is
// seed + 0 * 0x27D4EB2F (site 0), threshold int(p * 2^24), keep_scale
// 1 / (1 - p); threshold 0 runs without dropout.
extern "C" int sep_softmax_pv_train_fwd_f32(
    const void* scores, const void* v, const void* lens, void* out,
    void* row_max, void* row_sum, int B, int H, int Lp, int F, int length,
    unsigned int seed_word, unsigned int threshold, float keep_scale,
    void* stream) {
  if (B <= 0 || Lp <= 0) return 0;
  if (int err = check(B, H, Lp, F, length)) return err;
  return launch_fwd<16, false>(
      static_cast<const float*>(scores), nullptr,
      static_cast<const float*>(v), static_cast<const int*>(lens),
      static_cast<float*>(out), static_cast<float*>(row_max),
      static_cast<float*>(row_sum), B, H, Lp, F, length, seed_word,
      threshold, keep_scale, static_cast<cudaStream_t>(stream));
}

// K9b: the same on scores + bias, bias a second [B, H, Lp, Lp] tensor.
extern "C" int sep_softmax_pv_train_fwd_bias_f32(
    const void* scores, const void* bias, const void* v, const void* lens,
    void* out, void* row_max, void* row_sum, int B, int H, int Lp, int F,
    int length, unsigned int seed_word, unsigned int threshold,
    float keep_scale, void* stream) {
  if (B <= 0 || Lp <= 0) return 0;
  if (int err = check(B, H, Lp, F, length)) return err;
  return launch_fwd<16, true>(
      static_cast<const float*>(scores), static_cast<const float*>(bias),
      static_cast<const float*>(v), static_cast<const int*>(lens),
      static_cast<float*>(out), static_cast<float*>(row_max),
      static_cast<float*>(row_sum), B, H, Lp, F, length, seed_word,
      threshold, keep_scale, static_cast<cudaStream_t>(stream));
}

// The forward's inputs, its out, row_max and row_sum, and dout [B, Lp, F];
// writes dscores [B, H, Lp, Lp] and dv [B, Lp, F].
extern "C" int sep_softmax_pv_train_bwd_f32(
    const void* scores, const void* v, const void* out, const void* dout,
    const void* row_max, const void* row_sum, const void* lens,
    void* dscores, void* dv, int B, int H, int Lp, int F, int length,
    unsigned int seed_word, unsigned int threshold, float keep_scale,
    void* stream) {
  if (B <= 0 || Lp <= 0) return 0;
  if (int err = check(B, H, Lp, F, length)) return err;
  return launch_bwd<16, false>(
      static_cast<const float*>(scores), nullptr,
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<const float*>(row_max),
      static_cast<const float*>(row_sum), static_cast<const int*>(lens),
      static_cast<float*>(dscores), static_cast<float*>(dv), B, H, Lp, F,
      length, seed_word, threshold, keep_scale,
      static_cast<cudaStream_t>(stream));
}

// K10b: the same with K9b's bias; dscores is also the bias's cotangent.
extern "C" int sep_softmax_pv_train_bwd_bias_f32(
    const void* scores, const void* bias, const void* v, const void* out,
    const void* dout, const void* row_max, const void* row_sum,
    const void* lens, void* dscores, void* dv, int B, int H, int Lp, int F,
    int length, unsigned int seed_word, unsigned int threshold,
    float keep_scale, void* stream) {
  if (B <= 0 || Lp <= 0) return 0;
  if (int err = check(B, H, Lp, F, length)) return err;
  return launch_bwd<16, true>(
      static_cast<const float*>(scores), static_cast<const float*>(bias),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<const float*>(row_max),
      static_cast<const float*>(row_sum), static_cast<const int*>(lens),
      static_cast<float*>(dscores), static_cast<float*>(dv), B, H, Lp, F,
      length, seed_word, threshold, keep_scale,
      static_cast<cudaStream_t>(stream));
}
