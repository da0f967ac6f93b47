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
// Design: the flash rel-pos tile (flash_relpos_tile.cuh) at one warp per
// row tile (SPLIT 1: blocks of 4 warps and 64 query rows), on
// channels-last rows, without dropout or row statistics, in two
// instances of the head width: Base's 16 (four blocks per SM) and
// Large's 32 (92 KB of shared memory a block: two per SM; its products
// per pair double, so its bound is about twice Base's).  The header holds
// the tile's design and what holds it above its bound.
//
// bfloat16 streams (flash_relpos_bf16_kernel, q, k, v, the table and out
// bfloat16, at both head widths): the tile's T = __nv_bfloat16 form, the
// JAX kernel's rounding steps with one TF32 product on exact values in
// place of three (flash_relpos_tile.cuh), so its product bound is a third
// of the float32 instance's; the same stages, shared memory and blocks
// per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_relpos_tile.cuh"

namespace {

template <int D>
using Tile = relpos_flash::Shape<1, D>;

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, Tile<D>::kMinBlocks)
flash_relpos_kernel(relpos_flash::Args a) {
  relpos_flash::run<D, 1, false, false, false>(a);
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, Tile<D>::kMinBlocks)
flash_relpos_bf16_kernel(relpos_flash::Args a) {
  relpos_flash::run<D, 1, false, false, false, __nv_bfloat16>(a);
}

template <int D, class Kernel>
int launch(Kernel kernel, relpos_flash::Args a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile<D>::kSmemBytes);
  if (err == cudaSuccess && Tile<D>::kMinBlocks < 4)  // room for them
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // 1 / sqrt(D) and log2(e): exp(x / sqrt(D)) = exp2(x log2(e) / sqrt(D))
  a.scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  dim3 grid((a.L + relpos_flash::kRows - 1) / relpos_flash::kRows, B * a.H);
  kernel<<<grid, Tile<D>::kThreads, Tile<D>::kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The C entries' arguments (pointers of either dtype, passed through Args'
// float pointers) and checks.
int entry(bool bf16, const void* q, const void* k, const void* v,
          const void* table, const void* lens, void* out, int B, int L,
          int H, int D, int maxlen, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H <= 0 || maxlen <= 0 || (long long)B * H > 65535 ||
      (D != 16 && D != 32))
    return (int)cudaErrorInvalidValue;
  relpos_flash::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.table = static_cast<const float*>(table);
  a.lens = static_cast<const int*>(lens);
  a.out = static_cast<float*>(out);
  a.L = L;
  a.H = H;
  a.maxlen = maxlen;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return D == 16 ? launch<16>(flash_relpos_bf16_kernel<16>, a, B, st)
                   : launch<32>(flash_relpos_bf16_kernel<32>, a, B, st);
  return D == 16 ? launch<16>(flash_relpos_kernel<16>, a, B, st)
                 : launch<32>(flash_relpos_kernel<32>, a, B, st);
}

}  // namespace

// q, k, v, out: device float32 [B, L, H*D] (16-byte aligned); table:
// device float32 [2*maxlen, D]; lens: device int32 [B], each >= 1 (the
// wrapper clamps them to L).  Built for Base's head width D = 16 and
// Large's D = 32.
extern "C" int sep_flash_relpos_f32(const void* q, const void* k,
                                    const void* v, const void* table,
                                    const void* lens, void* out, int B, int L,
                                    int H, int D, int maxlen, void* stream) {
  return entry(false, q, k, v, table, lens, out, B, L, H, D, maxlen, stream);
}

// The same on bfloat16 q, k, v, table and out (16-byte aligned).
extern "C" int sep_flash_relpos_bf16(const void* q, const void* k,
                                     const void* v, const void* table,
                                     const void* lens, void* out, int B,
                                     int L, int H, int D, int maxlen,
                                     void* stream) {
  return entry(true, q, k, v, table, lens, out, B, L, H, D, maxlen, stream);
}
