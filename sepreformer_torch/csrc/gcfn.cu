// Fused GCFN forward (eval), K1: LayerNorm -> Linear F->6F -> optional
// u-row length mask -> depthwise k3 (zero pad in u-space) -> GLU ->
// Linear 3F->F -> LayerScale residual, at float32 accuracy.
//
// Replaces: sepreformer_tpu/ops/pallas/gcfn.py::fused_gcfn
//           (_gcfn_pipe_kernel[_masked], _gcfn_kernel[_masked]).
//
// What bounds it on the H100: the two products are 2*F*6F + 2*3F*F
// flops per row (295 kflop at F=128, 1180 at F=256) against 2*F*4 bytes
// of row traffic, ~290 (580) flop per byte: bound by the products.  On
// the tensor cores at float32 accuracy (3xTF32, 495/3 TFLOP/s) that is
// 0.057 ms at [4, 8000, 128] and 0.229 ms at [4, 8000, 256]; the
// LayerNorm, conv and GLU on the CUDA cores and the sigmoids on the SFUs
// take under a tenth of that.
//
// Design: gcfn_tile_mma.cuh (shared with K7, the train forward): tiles of
// 62 rows, the hidden width in chunks whose weights are staged in shared
// memory, both products as 3xTF32 mma.sync.  Float32 instances at Base's
// F = 128 at two blocks per SM, and Large's F = 256 at one (its tile
// takes 199 KB of shared memory, so the SM's eight warps are the block's
// own and the GLU no longer overlaps another block's products); and at
// the T, S and M presets' F = 64, 96 and 160, the same tile, which needs
// only F % 32 == 0 (F / 32 output n-fragments a warp, 3F / 32 chunks):
// 71.5 and 92 KB, two blocks per SM, and 133 KB, one.
//
// The bfloat16 instances (x and out bfloat16, the parameters float32;
// gcfn_bf16_kernel) take the JAX kernel's rounding steps for a bfloat16
// stream (gcfn_tile_mma.cuh, In): LayerNorm in float32, xn and g rounded
// to bfloat16, the weights rounded as they are read, each product one
// TF32 mma.sync on those exact values (mma_tf32x3.cuh) in place of the
// 3xTF32 split's three, so their product bound is a third of the float32
// instances' (exact products at 495 TFLOP/s).  This is the simpler of
// two right designs: the bf16 m16n8k16 form (989 TFLOP/s dense, bf16 A
// and B fragments with loaders of their own) is not written, and its
// time is not measured.  Same tile, shared memory and blocks per SM as
// the float32 instances; x's and out's bytes halve.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gcfn_tile_mma.cuh"

namespace {

using gcfn_mma::kThreads;

template <int F>
__global__ void __launch_bounds__(kThreads,
                                  gcfn_mma::Shape<F>::blocks_per_sm)
gcfn_kernel(const float* __restrict__ x, const int* __restrict__ lens,
            const float* __restrict__ lns, const float* __restrict__ lnb,
            const float* __restrict__ win, const float* __restrict__ bin,
            const float* __restrict__ wdw, const float* __restrict__ bdw,
            const float* __restrict__ wout, const float* __restrict__ bout,
            const float* __restrict__ ls, float* __restrict__ out, int T,
            float eps) {
  extern __shared__ __align__(16) float smem[];
  gcfn_mma::tile<F, false>(smem, x, lens, lns, lnb, win, bin, wdw, bdw,
                           wout, bout, ls, out, T, eps, GcfnDrop{});
}

template <int F>
__global__ void __launch_bounds__(kThreads,
                                  gcfn_mma::Shape<F>::blocks_per_sm)
gcfn_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const int* __restrict__ lens, const float* __restrict__ lns,
                 const float* __restrict__ lnb,
                 const float* __restrict__ win, const float* __restrict__ bin,
                 const float* __restrict__ wdw, const float* __restrict__ bdw,
                 const float* __restrict__ wout,
                 const float* __restrict__ bout, const float* __restrict__ ls,
                 __nv_bfloat16* __restrict__ out, int T, float eps) {
  extern __shared__ __align__(16) float smem[];
  gcfn_mma::tile<F, false, false, __nv_bfloat16>(
      smem, x, lens, lns, lnb, win, bin, wdw, bdw, wout, bout, ls, out, T,
      eps, GcfnDrop{});
}

// sep_gcfn_f32's launch of the float32 instance at width F.
#define SEP_GCFN_F32(F)                                                      \
  launch<F>(gcfn_kernel<F>, f(x), l, f(lns), f(lnb), f(win), f(bin), f(wdw), \
            f(bdw), f(wout), f(bout), f(ls), o, B, T, eps, s)

template <int F, class In, class Kernel>
int launch(Kernel kernel, const In* x, const int* lens, const float* lns,
           const float* lnb, const float* win, const float* bin,
           const float* wdw, const float* bdw, const float* wout,
           const float* bout, const float* ls, In* out, int B, int T,
           float eps, cudaStream_t stream) {
  constexpr size_t smem = gcfn_mma::Shape<F>::smem_bytes;
  constexpr int TT = gcfn_mma::kTT;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // room for Shape<F>::blocks_per_sm blocks
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, lens, lns, lnb, win, bin, wdw,
                                           bdw, wout, bout, ls, out, T, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers are device pointers to contiguous float32 (lens: int32 [B] or
// null).  win [F, 6F] and wout [3F, F] are [in, out]; wdw [6F, 3] is the
// Conv1d weight [6F, 1, 3].  Built for Base's F = 128, Large's F = 256
// and the T, S and M presets' F = 64, 96 and 160.
extern "C" int sep_gcfn_f32(const void* x, const void* lens, const void* lns,
                            const void* lnb, const void* win, const void* bin,
                            const void* wdw, const void* bdw, const void* wout,
                            const void* bout, const void* ls, void* out, int B,
                            int T, int F, float eps, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int* l = static_cast<const int*>(lens);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0) return 0;
  if (F == 128)
    return launch<128>(gcfn_kernel<128>, f(x), l, f(lns), f(lnb), f(win),
                       f(bin), f(wdw), f(bdw), f(wout), f(bout), f(ls), o, B,
                       T, eps, s);
  if (F == 256)
    return launch<256>(gcfn_kernel<256>, f(x), l, f(lns), f(lnb), f(win),
                       f(bin), f(wdw), f(bdw), f(wout), f(bout), f(ls), o, B,
                       T, eps, s);
  switch (F) {  // the T, S and M presets' widths
    case 64: return SEP_GCFN_F32(64);
    case 96: return SEP_GCFN_F32(96);
    case 160: return SEP_GCFN_F32(160);
  }
  return (int)cudaErrorInvalidValue;
}

// The same with x and out bfloat16 [B, T, F] (the parameters float32).
extern "C" int sep_gcfn_bf16(const void* x, const void* lens,
                             const void* lns, const void* lnb,
                             const void* win, const void* bin,
                             const void* wdw, const void* bdw,
                             const void* wout, const void* bout,
                             const void* ls, void* out, int B, int T, int F,
                             float eps, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto xb = static_cast<const __nv_bfloat16*>(x);
  const int* l = static_cast<const int*>(lens);
  auto o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0) return 0;
  if (F == 128)
    return launch<128>(gcfn_bf16_kernel<128>, xb, l, f(lns), f(lnb), f(win),
                       f(bin), f(wdw), f(bdw), f(wout), f(bout), f(ls), o, B,
                       T, eps, s);
  if (F == 256)
    return launch<256>(gcfn_bf16_kernel<256>, xb, l, f(lns), f(lnb), f(win),
                       f(bin), f(wdw), f(bdw), f(wout), f(bout), f(ls), o, B,
                       T, eps, s);
  return (int)cudaErrorInvalidValue;
}

namespace {

// The float32 instance at width F: blocks per SM (at its shared memory),
// registers, local (spill) bytes and warps per block, into o[0 .. 3].
template <int F>
int occupancy(int* o) {
  const auto kernel = gcfn_kernel<F>;
  constexpr size_t smem = gcfn_mma::Shape<F>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  o[1] = attr.numRegs;
  o[2] = (int)attr.localSizeBytes;
  o[3] = kThreads / 32;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(o, kernel,
                                                            kThreads, smem);
}

}  // namespace

// K1's float32 instance at a T, S or M preset's width F: its blocks per
// SM, registers, local bytes and warps, into out[0 .. 3].
extern "C" int sep_gcfn_occupancy(int F, void* out) {
  int* o = static_cast<int*>(out);
  switch (F) {
    case 64: return occupancy<64>(o);
    case 96: return occupancy<96>(o);
    case 160: return occupancy<160>(o);
  }
  return (int)cudaErrorInvalidValue;
}
