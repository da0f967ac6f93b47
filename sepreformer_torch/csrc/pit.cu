// The uPIT table: negative SI-SNR of every (estimate i, source j) pair,
//   e = est[i, b] - mean,  s = src[j, b] - mean        (rows of T samples)
//   dots = <e, s>,  ss = |s|^2,  scale = dots / (ss + eps)   (1 without
//   scale invariance),  num2 = scale^2 * ss,
//   den2 = sum_t (e - scale * s)^2,
//   out[b, i, j] = max(-20 log10(e) * log(eps + sqrt(num2) /
//                                       (sqrt(den2) + eps)), clamp).
// den2 is summed explicitly, not expanded as |e|^2 - 2 scale dots +
// scale^2 ss, which cancels catastrophically at high SI-SNR.
//
// Replaces: sepreformer_tpu/ops/pallas/pit.py::sisnr_pairwise_neg_fused
//           (_pit_kernel).  Its gradient is the plain version's autograd,
//           as the JAX package's custom_vjp recomputes through XLA.
//
// What bounds it on the H100: it reads est and src once (2 * S * B * T
// floats, 1 MB at S=2, B=2, T=32000) and does ~10 operations per sample
// and pair, so the bound is the bytes, a fraction of a microsecond.  A
// launch costs more than that.
//
// Design: one block per (j, i, b).  The TPU kernel held both [S, T] rows
// in VMEM for one pass; a block cannot hold 2 x 128 KB of rows, and den2
// needs the scale first, so the block makes three passes over its two
// rows (means; dots and ss; den2), which stay in L2 after the first.
// Each pass is a strided loop per thread and a fixed-order block
// reduction (warp shuffles, then the warps' partials in shared memory),
// so the result does not depend on scheduling.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of a and b over the block, returned to every thread.
__device__ float2 block_sum2(float a, float b, float2* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // red is free (previous reduction fully read)
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  for (int w = 0; w < kWarps; ++w) {
    r.x += red[w].x;
    r.y += red[w].y;
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
pit_sisnr_kernel(const float* __restrict__ est, const float* __restrict__ src,
                 float* __restrict__ out, int S, int B, int T, int scale_inv,
                 float eps, float clamp_db, int has_clamp) {
  __shared__ float2 red[kWarps];
  const int j = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const float* e = est + ((size_t)i * B + b) * T;
  const float* s = src + ((size_t)j * B + b) * T;

  float se = 0.f, ss0 = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    se += e[t];
    ss0 += s[t];
  }
  const float2 sums = block_sum2(se, ss0, red);
  const float me = sums.x / T, ms = sums.y / T;

  float dots = 0.f, ss = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float ev = e[t] - me, sv = s[t] - ms;
    dots += ev * sv;
    ss += sv * sv;
  }
  const float2 ds = block_sum2(dots, ss, red);
  const float scale = scale_inv ? ds.x / (ds.y + eps) : 1.f;
  const float num2 = scale * scale * ds.y;

  float den = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float r = (e[t] - me) - scale * (s[t] - ms);
    den += r * r;
  }
  const float den2 = block_sum2(den, 0.f, red).x;
  if (threadIdx.x == 0) {
    const float log10e = 0.43429448190325176f;
    float loss = -20.f * log10e * logf(eps + sqrtf(num2) / (sqrtf(den2) + eps));
    if (has_clamp) loss = fmaxf(loss, clamp_db);
    out[((size_t)b * S + i) * S + j] = loss;
  }
}

}  // namespace

// est, src: device float32 [S, B, T]; out: device float32 [B, S, S].
extern "C" int sep_pit_sisnr_f32(const void* est, const void* src, void* out,
                                 int S, int B, int T, int scale_inv,
                                 float eps, float clamp_db, int has_clamp,
                                 void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (T <= 0 || S > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(S, S, B);
  pit_sisnr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(est), static_cast<const float*>(src),
      static_cast<float*>(out), S, B, T, scale_inv, eps, clamp_db, has_clamp);
  return (int)cudaGetLastError();
}
