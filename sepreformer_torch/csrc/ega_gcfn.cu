// The EGA tail fused with the GCFN of a GlobalBlock (eval, and train at
// dropout 0), K16:
//   y   = x + sigmoid(LN_g(x) Wg + bg) * nearest_up(x_down),
//   out = y + ls * GCFN(y)   (K1's chain on y),
// at float32 accuracy.
//
// Replaces: sepreformer_tpu/ops/pallas/ega_gcfn.py::fused_ega_tail_gcfn
//           (_impl, body _kernel).
//
// What bounds it on the H100: K1's two products (295 kflop per row at
// F = 128, 1180 at F = 256) plus the gate's F x F product (33 kflop, 131),
// 20 F^2 flops per row against 2*F*4 bytes of row traffic (x_down is 1/r
// of that): bound by the products.  On the tensor cores at float32
// accuracy (3xTF32, 495/3 TFLOP/s) that is 0.064 ms at [4, 8000, 128]
// and 0.254 ms at [4, 8000, 256]; the two LayerNorms, the conv, the GLU
// and the gate on the CUDA cores and the sigmoids on the SFUs take well
// under that.
//
// Design: K1's tile (gcfn_tile_mma.cuh, kPair) with the tail as a
// prologue over its R = 64 rows, halo rows included, so the GCFN's k3
// conv sees the tail's output on both sides of the tile: LN_g(x) into
// xn, the gate product as F / 64 3xTF32 warp products of 64 columns each
// (wg staged through the tile's win buffer by cp.async), the gated
// residual in the fragments, y into shared memory over buffers that the
// chunk loop fills later.  Two instances, as K1's: Base's F = 128 keeps
// K1's 113 KB and two blocks per SM (y over wo and u); Large's F = 256
// takes K1's 199 KB and one block per SM, y over wi, held in registers
// until the gate's last part is read (the header says why).  The TPU
// kernel took the upsampled attention output
// as a second [B, T, F] input, because a row gather cost it a one-hot
// product; here each row reads x_down[t / r] directly (r = T / L is exact
// in every GlobalBlock: the stage length is the bottleneck length times a
// power of two), which saves writing and reading a [B, T, F] tensor.
//
// The launch sets the carveout to the most shared memory, as K1's does:
// two blocks of 113 KB need 226 KB of the SM's 256 KB, whatever the
// driver's default.  The carveout did not explain the spread of K16's
// earlier CUDA-core times: that kernel (96 KB per block) ran two blocks
// per SM with or without it, within 1 % (PERF.md section 6).
//
// bfloat16 streams (sep_ega_gcfn_bf16): x, x_down and out bfloat16, the
// tile's In = __nv_bfloat16 form with the JAX kernel's rounding steps
// (ega_gcfn.py:57-90; gcfn_tile_mma.cuh lists them): y = x + gate * up
// stays float32 and waits in a float32 scratch [B, T, F] for the
// epilogue, since the bfloat16 out would round it.  Forward only: the
// JAX package's bfloat16 gradient of this kernel raises, and the port's
// wrapper raises under autograd too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gcfn_tile_mma.cuh"

namespace {

using gcfn_mma::kThreads;

// In: the stream's type, float or __nv_bfloat16 (x, x_down and out)
template <int F, class In>
__global__ void __launch_bounds__(kThreads,
                                  gcfn_mma::Shape<F>::blocks_per_sm)
ega_gcfn_kernel(const In* __restrict__ x, gcfn_mma::Pair<In> pair,
                const float* __restrict__ lns, const float* __restrict__ lnb,
                const float* __restrict__ win, const float* __restrict__ bin,
                const float* __restrict__ wdw, const float* __restrict__ bdw,
                const float* __restrict__ wout,
                const float* __restrict__ bout, const float* __restrict__ ls,
                In* __restrict__ out, int T, float eps) {
  extern __shared__ __align__(16) float smem[];
  gcfn_mma::tile<F, false, true, In>(smem, x, nullptr, lns, lnb, win, bin,
                                     wdw, bdw, wout, bout, ls, out, T, eps,
                                     GcfnDrop{}, pair);
}

// the launch's attributes: its dynamic shared memory, and room for
// Shape<F>::blocks_per_sm blocks per SM
template <int F, class In>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      ega_gcfn_kernel<F, In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gcfn_mma::Shape<F>::smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ega_gcfn_kernel<F, In>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int F, class In>
int launch(const In* x, gcfn_mma::Pair<In> pair, const float* lns,
           const float* lnb, const float* win, const float* bin,
           const float* wdw, const float* bdw, const float* wout,
           const float* bout, const float* ls, In* out, int B, int T,
           float eps, cudaStream_t stream) {
  constexpr int TT = gcfn_mma::kTT;
  const cudaError_t err = set_attributes<F, In>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  ega_gcfn_kernel<F, In><<<grid, kThreads, gcfn_mma::Shape<F>::smem_bytes,
                           stream>>>(x, pair, lns, lnb, win, bin, wdw, bdw,
                                     wout, bout, ls, out, T, eps);
  return (int)cudaGetLastError();
}

template <int F>
cudaError_t blocks_per_sm(int* blocks) {
  cudaError_t err = set_attributes<F, float>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ega_gcfn_kernel<F, float>, kThreads,
        gcfn_mma::Shape<F>::smem_bytes);
  return err;
}

// Either instance at width F, for the stream's type In.
template <class In>
int run_pair(const void* x, const void* x_down, const void* gns,
             const void* gnb, const void* wg, const void* bg,
             const void* lns, const void* lnb, const void* win,
             const void* bin, const void* wdw, const void* bdw,
             const void* wout, const void* bout, const void* ls, void* out,
             void* yres, int B, int T, int L, int F, float eps,
             void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (B <= 0 || T <= 0) return 0;
  if (L <= 0 || T % L != 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const gcfn_mma::Pair<In> pair{static_cast<const In*>(x_down), L, f(gns),
                                f(gnb), f(wg), f(bg),
                                static_cast<float*>(yres)};
  auto run = [&](auto launcher) {
    return launcher(static_cast<const In*>(x), pair, f(lns), f(lnb), f(win),
                    f(bin), f(wdw), f(bdw), f(wout), f(bout), f(ls),
                    static_cast<In*>(out), B, T, eps,
                    static_cast<cudaStream_t>(stream));
  };
  if (F == 128) return run(launch<128, In>);
  if (F == 256) return run(launch<256, In>);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Pointers are device pointers to contiguous float32.  x, out [B, T, F],
// apart (out is written before x is read for the last time); x_down
// [B, L, F] with T % L == 0; gns, gnb, bg [F]; wg [F, F] is [in, out];
// the GCFN's parameters as sep_gcfn_f32's.  Built for Base's F = 128 and
// Large's F = 256.
extern "C" int sep_ega_gcfn_f32(const void* x, const void* x_down,
                                const void* gns, const void* gnb,
                                const void* wg, const void* bg,
                                const void* lns, const void* lnb,
                                const void* win, const void* bin,
                                const void* wdw, const void* bdw,
                                const void* wout, const void* bout,
                                const void* ls, void* out, int B, int T,
                                int L, int F, float eps, void* stream) {
  return run_pair<float>(x, x_down, gns, gnb, wg, bg, lns, lnb, win, bin,
                         wdw, bdw, wout, bout, ls, out, nullptr, B, T, L, F,
                         eps, stream);
}

// The bfloat16 instance: x, x_down and out bfloat16 (16-byte aligned), the
// parameters float32, yres a float32 scratch [B, T, F] (y's tile rows,
// the residual).
extern "C" int sep_ega_gcfn_bf16(const void* x, const void* x_down,
                                 const void* gns, const void* gnb,
                                 const void* wg, const void* bg,
                                 const void* lns, const void* lnb,
                                 const void* win, const void* bin,
                                 const void* wdw, const void* bdw,
                                 const void* wout, const void* bout,
                                 const void* ls, void* out, void* yres,
                                 int B, int T, int L, int F, float eps,
                                 void* stream) {
  return run_pair<__nv_bfloat16>(x, x_down, gns, gnb, wg, bg, lns, lnb, win,
                                 bin, wdw, bdw, wout, bout, ls, out, yres, B,
                                 T, L, F, eps, stream);
}

// Blocks of K16 at width F that one SM holds at once, with the launch's
// attributes set (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// *blocks.
extern "C" int sep_ega_gcfn_blocks_per_sm(int F, void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (F == 128) return (int)blocks_per_sm<128>(n);
  if (F == 256) return (int)blocks_per_sm<256>(n);
  return (int)cudaErrorInvalidValue;
}
