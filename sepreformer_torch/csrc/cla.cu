// Fused CLA local block (eval), K15: LayerNorm -> Linear F->2F -> GLU ->
// depthwise k65 "same" (zero padding of the GLU output v) -> Linear F->2F
// -> folded BatchNorm y*s + t -> exact GELU -> Linear 2F->F -> x + ls*out,
// in float32.
//
// Replaces: sepreformer_tpu/ops/pallas/cla.py::fused_cla (_fused_cla_impl,
//           body _cla_kernel).
//
// What bounds it on the H100: three products of 2*F*2F flops per row
// (65.5 kflop each at F = 128), the conv's 2*65*F and the elementwise
// work, ~216 kflop per row against 2*F*4 bytes of row traffic: bound by
// the float32 operations on the CUDA cores (67 TFLOP/s), 0.103 ms at
// [4, 8000, 128], not by the 3.35 TB/s of memory (0.010 ms).
//
// Design: two launches.  The k65 conv reads 32 v rows past each edge of a
// tile, and v = GLU(LN(x) W_in + b_in) must be zero outside [0, T) (the
// conv pads its input, v, not x: GLU of a zero x row is not zero).  One
// launch that recomputed LN and the first product on the halo would do
// 2x that product at a tile of 64 rows (+30 % of the work) and need
// ~224 KB of shared memory at 128 rows; here the first launch
// (cla_glu_kernel) writes v [B, T, F] to device memory, 16.4 MB at
// [4, 8000, 128] (~10 us at the memory rate, against the ~0.1 ms bound),
// and the second (cla_tail_kernel) reads each tile's window of v rows
// from L2 with zeros outside [0, T): the halo is right by construction.
// The second launch stages the window, the conv weight and the conv
// output in 97 KB of shared memory (two blocks per SM), runs the tap loop
// of depthwise_tap.cuh (shared with K4), then the two products with the
// 2F-wide intermediate in shared memory over the dead window.  Each
// product keeps a register tile of rows for one output column per
// thread and streams its weight [in, out] in coalesced rows from L2: read
// as [out, in] rows, where a warp's 32 rows lie 512 or 1536 bytes apart,
// the CUDA-core GCFN tile of K1 and K16 ran 1.6x slower on an H100; the
// CLA module stores its Linear weights so.  GELU is exact (erff): the TPU
// kernel approximated erf only because Mosaic had no erf lowering.
#include <cuda_runtime.h>

#include "depthwise_tap.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK = 65;              // the CLA's depthwise kernel
constexpr int kHalo = (kK - 1) / 2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// acc[r] += sum_k a[r * lda + k] * w[k * ldw + col] over k < KD, a in
// shared memory (rows broadcast to the warp, read as float4), w in global
// memory (a warp reads 32 neighbouring columns of one row).
template <int R, int KD>
__device__ __forceinline__ void rows_times_column(const float* a, int lda,
                                                  const float* __restrict__ w,
                                                  int ldw, int col,
                                                  float (&acc)[R]) {
  for (int k = 0; k < KD; k += 4) {
    float wk[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wk[kk] = w[(size_t)(k + kk) * ldw + col];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(a + r * lda + k);
      acc[r] += v.x * wk[0] + v.y * wk[1] + v.z * wk[2] + v.w * wk[3];
    }
  }
}

// Launch 1: v[b, t] = GLU(LN(x[b, t]) W_in + b_in) for TT rows a block.
template <int F, int TT>
__global__ void __launch_bounds__(kThreads)
cla_glu_kernel(const float* __restrict__ x, const float* __restrict__ lns,
               const float* __restrict__ lnb, const float* __restrict__ w_in,
               const float* __restrict__ b_in, float* __restrict__ v, int T,
               float eps) {
  __shared__ __align__(16) float xn[TT * F];
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xb = x + (size_t)b * T * F;

  for (int r = warp; r < TT; r += kThreads / 32) {
    const int t = t0 + r;
    float* dst = xn + r * F;
    if (t >= T) {
      for (int k = lane; k < F; k += 32) dst[k] = 0.f;
      continue;
    }
    float e[F / 32];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < F / 32; ++q) {
      e[q] = xb[(size_t)t * F + lane + 32 * q];
      s += e[q];
    }
    const float mean = warp_sum(s) * (1.f / F);
    float s2 = 0.f;
#pragma unroll
    for (int q = 0; q < F / 32; ++q) {
      e[q] -= mean;
      s2 += e[q] * e[q];
    }
    const float inv = rsqrtf(warp_sum(s2) * (1.f / F) + eps);
#pragma unroll
    for (int q = 0; q < F / 32; ++q) {
      const int k = lane + 32 * q;
      dst[k] = e[q] * inv * lns[k] + lnb[k];
    }
  }
  __syncthreads();

  // thread: column c of the value half and of the gate half, RPT rows
  constexpr int RPT = TT * F / kThreads;
  const int c = tid % F, r0 = (tid / F) * RPT;
  float acc_a[RPT], acc_g[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc_a[r] = acc_g[r] = 0.f;
  for (int k = 0; k < F; k += 4) {
    float wa[4], wg[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wa[kk] = w_in[(size_t)(k + kk) * 2 * F + c];
      wg[kk] = w_in[(size_t)(k + kk) * 2 * F + F + c];
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(xn + (r0 + r) * F + k);
      acc_a[r] += a.x * wa[0] + a.y * wa[1] + a.z * wa[2] + a.w * wa[3];
      acc_g[r] += a.x * wg[0] + a.y * wg[1] + a.z * wg[2] + a.w * wg[3];
    }
  }
  const float ba = b_in[c], bg = b_in[F + c];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = t0 + r0 + r;
    if (t < T)
      v[((size_t)b * T + t) * F + c] =
          (acc_a[r] + ba) * sigmoid(acc_g[r] + bg);
  }
}

template <int F, int TT>
struct TailShape {
  static constexpr int W = TT + kK - 1;  // window rows of v
  static constexpr int WS = F + 1;       // staged conv weight's tap stride
  // the staged weight's floats, rounded up so that y stays 16-byte aligned
  static constexpr int WSZ = (kK * WS + 3) / 4 * 4;
  static constexpr size_t smem_bytes =
      sizeof(float) * (size_t)(W * F + WSZ + TT * F);
  static_assert(TT * 2 * F <= W * F, "z must fit over the dead window");
};

// Launch 2: out = x + ls * (GELU((conv(v) W_mid + b_mid) * s + t) W_out +
// b_out) for TT rows a block.
template <int F, int TT>
__global__ void __launch_bounds__(kThreads)
cla_tail_kernel(const float* __restrict__ x, const float* __restrict__ v,
                const float* __restrict__ wdw, const float* __restrict__ bdw,
                const float* __restrict__ w_mid,
                const float* __restrict__ b_mid,
                const float* __restrict__ bn_s, const float* __restrict__ bn_t,
                const float* __restrict__ w_out,
                const float* __restrict__ b_out, const float* __restrict__ ls,
                float* __restrict__ out, int T) {
  using S = TailShape<F, TT>;
  extern __shared__ __align__(16) float smem[];
  float* vw = smem;              // [W][F] v rows t0-32 .. t0+TT+31
  float* ws = vw + S::W * F;     // [kK][WS] the conv weight, tap-major
  float* y = ws + S::WSZ;        // [TT][F] the conv's output
  float* z = vw;                 // [TT][2F] over the window once it is read
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;
  const float* vb = v + (size_t)b * T * F;

  for (int e = tid; e < S::W * F / 4; e += kThreads) {
    const int r = e / (F / 4), q = e % (F / 4), t = t0 - kHalo + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T)
      val = *reinterpret_cast<const float4*>(vb + (size_t)t * F + 4 * q);
    *reinterpret_cast<float4*>(vw + r * F + 4 * q) = val;
  }
  // wdw is the Conv1d weight [F, 1, kK]: read along taps, stored tap-major
  // with a stride of F + 1, so neither side has bank conflicts
  for (int e = tid; e < F * kK; e += kThreads) {
    const int c = e / kK, tap = e % kK;
    ws[tap * S::WS + c] = wdw[e];
  }
  __syncthreads();

  // conv: thread takes channel c over RPT consecutive rows
  constexpr int RPT = TT * F / kThreads;
  const int c = tid % F, r0 = (tid / F) * RPT;
  {
    float acc[RPT];
    const float bias = bdw[c];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = bias;
    dwtap::taps<RPT>(vw + r0 * F + c, F, ws + c, S::WS, kK, acc);
#pragma unroll
    for (int r = 0; r < RPT; ++r) y[(r0 + r) * F + c] = acc[r];
  }
  __syncthreads();

  // z = GELU((y W_mid + b_mid) * s + t): thread takes column j, all rows;
  // the window is dead past the barrier above, so z overwrites it
  static_assert(2 * F == kThreads, "one thread per column of z");
  {
    const int j = tid;
    float acc[TT];
#pragma unroll
    for (int r = 0; r < TT; ++r) acc[r] = 0.f;
    rows_times_column<TT, F>(y, F, w_mid, 2 * F, j, acc);
    const float bm = b_mid[j], s = bn_s[j], sh = bn_t[j];
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const float h = (acc[r] + bm) * s + sh;
      z[r * 2 * F + j] = 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
    }
  }
  __syncthreads();

  // out = x + ls * (z W_out + b_out): thread takes column c, RPT rows
  {
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.f;
    rows_times_column<RPT, 2 * F>(z + r0 * 2 * F, 2 * F, w_out, F, c, acc);
    const float scale = ls[c], bias = b_out[c];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int t = t0 + r0 + r;
      if (t < T) {
        const size_t off = ((size_t)b * T + t) * F + c;
        out[off] = x[off] + scale * (acc[r] + bias);
      }
    }
  }
}

template <int F, int TT>
int launch(const float* x, const float* lns, const float* lnb,
           const float* w_in, const float* b_in, const float* wdw,
           const float* bdw, const float* w_mid, const float* b_mid,
           const float* bn_s, const float* bn_t, const float* w_out,
           const float* b_out, const float* ls, float* v, float* out, int B,
           int T, float eps, cudaStream_t stream) {
  dim3 grid((T + TT - 1) / TT, B);
  cla_glu_kernel<F, TT><<<grid, kThreads, 0, stream>>>(x, lns, lnb, w_in,
                                                        b_in, v, T, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = TailShape<F, TT>::smem_bytes;
  err = cudaFuncSetAttribute(cla_tail_kernel<F, TT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cla_tail_kernel<F, TT><<<grid, kThreads, smem, stream>>>(
      x, v, wdw, bdw, w_mid, b_mid, bn_s, bn_t, w_out, b_out, ls, out, T);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers are device pointers to float32.  w_in, w_mid [F, 2F] and w_out
// [2F, F] are [in, out]; wdw is the Conv1d weight [F, 1, 65]; bn_s, bn_t
// [2F] the folded BatchNorm; v [B, T, F] is scratch.  Built for Base's
// F = 128.
extern "C" int sep_cla_f32(const void* x, const void* lns, const void* lnb,
                           const void* w_in, const void* b_in,
                           const void* wdw, const void* bdw,
                           const void* w_mid, const void* b_mid,
                           const void* bn_s, const void* bn_t,
                           const void* w_out, const void* b_out,
                           const void* ls, void* v, void* out, int B, int T,
                           int F, float eps, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (B <= 0 || T <= 0) return 0;
  if (F != 128 || B > 65535) return (int)cudaErrorInvalidValue;
  return launch<128, 32>(f(x), f(lns), f(lnb), f(w_in), f(b_in), f(wdw),
                         f(bdw), f(w_mid), f(b_mid), f(bn_s), f(bn_t),
                         f(w_out), f(b_out), f(ls), static_cast<float*>(v),
                         static_cast<float*>(out), B, T, eps,
                         static_cast<cudaStream_t>(stream));
}
