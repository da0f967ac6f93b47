// The EGA tail fused with the GCFN of a GlobalBlock (eval, and train at
// dropout 0), K16:
//   y   = x + sigmoid(LN_g(x) Wg + bg) * nearest_up(x_down),
//   out = y + ls * GCFN(y)   (K1's chain on y),
// in float32.
//
// Replaces: sepreformer_tpu/ops/pallas/ega_gcfn.py::fused_ega_tail_gcfn
//           (_impl, body _kernel).
//
// What bounds it on the H100: K1's 295 kflop per row at F = 128 plus the
// gate's F x F product and its LayerNorm, ~337 kflop per row against
// 2*F*4 bytes of row traffic (x_down is 1/r of that): bound by the
// float32 operations on the CUDA cores, 0.161 ms at [4, 8000, 128].
//
// Design: the CUDA-core GCFN tile that K1 ran until it moved to the tensor
// cores (gcfn_tile.cuh), with the tail as a prologue over its R = TT + 2
// rows, halo rows included, so the GCFN's k3 conv sees the tail's output
// on both sides of the tile.  The TPU kernel took the
// upsampled attention output as a second [B, T, F] input, because a row
// gather cost it a one-hot product; here each row reads x_down[t / r]
// directly (r = T / L is exact in every GlobalBlock: the stage length is
// the bottleneck length times a power of two), which saves writing and
// reading a [B, T, F] tensor.  The tail's output y stays in 9 KB of
// shared memory beside the GCFN's 87 KB, so two blocks still fit an SM.
#include <cuda_runtime.h>

#include "gcfn_tile.cuh"

namespace {

template <int F, int TT>
__global__ void __launch_bounds__(gcfn::kThreads)
ega_gcfn_kernel(const float* __restrict__ x, gcfn::Pair pair,
                const float* __restrict__ lns, const float* __restrict__ lnb,
                const float* __restrict__ win, const float* __restrict__ bin,
                const float* __restrict__ wdw, const float* __restrict__ bdw,
                const float* __restrict__ wout,
                const float* __restrict__ bout, const float* __restrict__ ls,
                float* __restrict__ out, int T, float eps) {
  extern __shared__ __align__(16) float smem[];
  gcfn::tile<F, TT>(smem, x, pair, lns, lnb, win, bin, wdw, bdw, wout,
                    bout, ls, out, T, eps);
}

template <int F, int TT>
int launch(const float* x, gcfn::Pair pair, const float* lns,
           const float* lnb, const float* win, const float* bin,
           const float* wdw, const float* bdw, const float* wout,
           const float* bout, const float* ls, float* out, int B, int T,
           float eps, cudaStream_t stream) {
  constexpr size_t smem = gcfn::Shape<F, TT>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ega_gcfn_kernel<F, TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  ega_gcfn_kernel<F, TT><<<grid, gcfn::kThreads, smem, stream>>>(
      x, pair, lns, lnb, win, bin, wdw, bdw, wout, bout, ls, out, T, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers are device pointers to contiguous float32.  x, out [B, T, F];
// x_down [B, L, F] with T % L == 0; gns, gnb, bg [F]; wg [F, F] is
// [in, out]; the GCFN's parameters as sep_gcfn_f32's.  Built for Base's
// F = 128.
extern "C" int sep_ega_gcfn_f32(const void* x, const void* x_down,
                                const void* gns, const void* gnb,
                                const void* wg, const void* bg,
                                const void* lns, const void* lnb,
                                const void* win, const void* bin,
                                const void* wdw, const void* bdw,
                                const void* wout, const void* bout,
                                const void* ls, void* out, int B, int T,
                                int L, int F, float eps, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (B <= 0 || T <= 0) return 0;
  if (F != 128 || L <= 0 || T % L != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const gcfn::Pair pair{f(x_down), L, f(gns), f(gnb), f(wg), f(bg)};
  return launch<128, 16>(f(x), pair, f(lns), f(lnb), f(win), f(bin), f(wdw),
                         f(bdw), f(wout), f(bout), f(ls),
                         static_cast<float*>(out), B, T, eps,
                         static_cast<cudaStream_t>(stream));
}
