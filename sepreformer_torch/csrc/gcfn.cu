// Fused GCFN forward (eval), K1: LayerNorm -> Linear F->6F -> optional
// u-row length mask -> depthwise k3 (zero pad in u-space) -> GLU ->
// Linear 3F->F -> LayerScale residual, in float32.
//
// Replaces: sepreformer_tpu/ops/pallas/gcfn.py::fused_gcfn
//           (_gcfn_pipe_kernel[_masked], _gcfn_kernel[_masked]).
//
// What bounds it on the H100: the two products are 2*F*6F + 2*3F*F
// flops per row (295 kflop at F=128) against 2*F*4 bytes of row traffic,
// ~290 flop per byte.  In float32 on the CUDA cores (67 TFLOP/s) the
// kernel is bound by operations, not by the 3.35 TB/s of memory.
//
// Design: gcfn_tile.cuh (shared with K7, the train forward).
#include <cuda_runtime.h>

#include "gcfn_tile.cuh"

namespace {

template <int F, int TT>
__global__ void __launch_bounds__(gcfn::kThreads)
gcfn_kernel(const float* __restrict__ x, const int* __restrict__ lens,
            const float* __restrict__ lns, const float* __restrict__ lnb,
            const float* __restrict__ win, const float* __restrict__ bin,
            const float* __restrict__ wdw, const float* __restrict__ bdw,
            const float* __restrict__ wout, const float* __restrict__ bout,
            const float* __restrict__ ls, float* __restrict__ out, int T,
            float eps) {
  extern __shared__ __align__(16) float smem[];
  gcfn::tile<F, TT, false>(smem, x, lens, lns, lnb, win, bin, wdw, bdw, wout,
                           bout, ls, out, T, eps, gcfn::Drop{});
}

template <int F, int TT>
int launch(const float* x, const int* lens, const float* lns,
           const float* lnb, const float* win, const float* bin,
           const float* wdw, const float* bdw, const float* wout,
           const float* bout, const float* ls, float* out, int B, int T,
           float eps, cudaStream_t stream) {
  constexpr size_t smem = gcfn::Shape<F, TT>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      gcfn_kernel<F, TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  gcfn_kernel<F, TT><<<grid, gcfn::kThreads, smem, stream>>>(
      x, lens, lns, lnb, win, bin, wdw, bdw, wout, bout, ls, out, T, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers are device pointers to contiguous float32 (lens: int32 [B] or
// null).  win [F, 6F] and wout [3F, F] are [in, out]; wdw [6F, 3] is the
// Conv1d weight [6F, 1, 3].  Built for Base's F = 128.
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
  if (F != 128) return (int)cudaErrorInvalidValue;
  return launch<128, 16>(f(x), l, f(lns), f(lnb), f(win), f(bin), f(wdw),
                         f(bdw), f(wout), f(bout), f(ls), o, B, T, eps, s);
}
