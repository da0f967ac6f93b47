// Masked softmax·V (eval), K3: for each (b, h, i),
//   lim = min(length, lens[b]);  p = softmax(scores[b, h, i, :lim]) in f32;
//   out[b, i, h*D:(h+1)*D] = sum_j p[j] * v[b, j, h*D:(h+1)*D].
// The two-tensor form (K3b) takes the softmax of scores + bias, the two
// [B, H, Lp, Lp] tensors summed in f32 key by key as they are loaded.
// Keys j >= lim are the -1e30 keys of the reference: their weight is
// exactly 0 in float32, so they are skipped and never read, in either
// tensor.  V and the output are channels-last [B, Lp, H*D].
//
// Replaces: sepreformer_tpu/ops/pallas/softmax_pv.py::softmax_pv
//           (_kernel, full row, and _kernel_kb, query- and key-blocked;
//           with bias=, _softmax_pv2_impl's _kernel2).
// The TPU needed two bodies because a full [Lp, Lp] row block did not
// fit VMEM at long lengths.  This one kernel streams the keys in tiles
// with an online softmax, so it serves every length the path uses.
//
// What bounds it on the H100: each valid score is read once and used for
// one exp and D multiply-adds, so it is bound by the bytes of the scores
// tensor (B*H*Lp*lim*4: 53 MB at B=8, H=8, Lp=512 and phase 2's ragged
// lens) at 3.35 TB/s; the two-tensor form reads twice those bytes.
//
// Design: the tile of csrc/softmax_pv_tile.cuh (K9's too): 16 query rows
// a warp tile, scores loaded straight into registers a tile ahead, an
// online softmax per quad of lanes, P·V on the tensor cores (3xTF32).
// K3 and K3b have two instances of the tile's head width each, Base's 16
// and Large's 32 (the scores' bytes are the same at both; V's double).
//
// bfloat16 streams (softmax_pv_bf16_kernel, K3 alone): the scores in
// float32 or bfloat16, V and the output in float32 or bfloat16, one
// instance per pairing but float/float and head width, with the JAX
// kernel's rounding steps (softmax_pv_tile.cuh, SC and VT).  bfloat16
// scores halve the bytes that bound K3; a bfloat16 V takes its P·V as
// one TF32 product on exact values (mma_tf32x3.cuh) in place of three.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "softmax_pv_tile.cuh"

namespace {

using softmax_pv_tile::Args;

using softmax_pv_tile::kBaseD;

template <int D, int SPLIT, bool HAS_BIAS>
__global__ void __launch_bounds__(softmax_pv_tile::kThreads,
                                  HAS_BIAS ? softmax_pv_tile::kMinBlocksBias
                                           : softmax_pv_tile::kMinBlocks)
softmax_pv_kernel(Args a) {
  softmax_pv_tile::run<D, SPLIT, HAS_BIAS, false>(a);
}

template <int D, int SPLIT, class SC, class VT>
__global__ void __launch_bounds__(softmax_pv_tile::kThreads,
                                  softmax_pv_tile::kMinBlocks)
softmax_pv_bf16_kernel(Args a) {
  softmax_pv_tile::run<D, SPLIT, false, false, SC, VT>(a);
}

template <int D, class SC, class VT>
int launch_bf16(const void* scores, const void* v, const void* lens,
                void* out, int B, int H, int Lp, int F, int length,
                void* stream) {
  return softmax_pv_tile::launch<D>(
      softmax_pv_bf16_kernel<D, 1, SC, VT>,
      softmax_pv_bf16_kernel<D, 2, SC, VT>, scores, nullptr, v, lens, out,
      nullptr, nullptr, B, H, Lp, F, length, 0u, 0u, 1.f, stream);
}

template <int D>
int launch_bf16(int scores_bf16, int v_bf16, const void* scores,
                const void* v, const void* lens, void* out, int B, int H,
                int Lp, int F, int length, void* stream) {
  using bf = __nv_bfloat16;
  if (scores_bf16 && v_bf16)
    return launch_bf16<D, bf, bf>(scores, v, lens, out, B, H, Lp, F, length,
                                  stream);
  if (scores_bf16)
    return launch_bf16<D, bf, float>(scores, v, lens, out, B, H, Lp, F,
                                     length, stream);
  if (v_bf16)
    return launch_bf16<D, float, bf>(scores, v, lens, out, B, H, Lp, F,
                                     length, stream);
  return (int)cudaErrorInvalidValue;  // float32 alone: sep_softmax_pv_f32
}

}  // namespace

// scores: device float32 [B, H, Lp, Lp]; v, out: [B, Lp, F] with F = H*D;
// lens: device int32 [B], each >= 1; length: true length <= Lp.
// Built for Base's head width D = 16 and Large's D = 32.
extern "C" int sep_softmax_pv_f32(const void* scores, const void* v,
                                  const void* lens, void* out, int B, int H,
                                  int Lp, int F, int length, void* stream) {
  if (H > 0 && F == 32 * H)
    return softmax_pv_tile::launch<32>(
        softmax_pv_kernel<32, 1, false>, softmax_pv_kernel<32, 2, false>,
        scores, nullptr, v, lens, out, nullptr, nullptr, B, H, Lp, F,
        length, 0u, 0u, 1.f, stream);
  return softmax_pv_tile::launch<kBaseD>(
      softmax_pv_kernel<kBaseD, 1, false>,
      softmax_pv_kernel<kBaseD, 2, false>, scores, nullptr, v, lens, out,
      nullptr, nullptr, B, H, Lp, F, length, 0u, 0u, 1.f, stream);
}

// K3 on a bfloat16 stream: scores bfloat16 if scores_bf16, else float32;
// v and out bfloat16 if v_bf16, else float32 (one of the two at least).
// Built for D = 16 and 32, as the float32 instance.
extern "C" int sep_softmax_pv_bf16(const void* scores, const void* v,
                                   const void* lens, void* out, int B, int H,
                                   int Lp, int F, int length, int scores_bf16,
                                   int v_bf16, void* stream) {
  if (H > 0 && F == 32 * H)
    return launch_bf16<32>(scores_bf16, v_bf16, scores, v, lens, out, B, H,
                           Lp, F, length, stream);
  return launch_bf16<kBaseD>(scores_bf16, v_bf16, scores, v, lens, out, B, H,
                             Lp, F, length, stream);
}

// K3b: the same on scores + bias, bias a second device float32
// [B, H, Lp, Lp] tensor.  Built for D = 16 and 32, as K3.
extern "C" int sep_softmax_pv_bias_f32(const void* scores, const void* bias,
                                       const void* v, const void* lens,
                                       void* out, int B, int H, int Lp,
                                       int F, int length, void* stream) {
  if (H > 0 && F == 32 * H)
    return softmax_pv_tile::launch<32>(
        softmax_pv_kernel<32, 1, true>, softmax_pv_kernel<32, 2, true>,
        scores, bias, v, lens, out, nullptr, nullptr, B, H, Lp, F, length,
        0u, 0u, 1.f, stream);
  return softmax_pv_tile::launch<kBaseD>(
      softmax_pv_kernel<kBaseD, 1, true>, softmax_pv_kernel<kBaseD, 2, true>,
      scores, bias, v, lens, out, nullptr, nullptr, B, H, Lp, F, length, 0u,
      0u, 1.f, stream);
}

// The occupancy (softmax_pv_tile::occupancy) of K3 at SPLIT 1 and 2, then
// of K3b at SPLIT 1 and 2, then of K3 and K3b at D = 32, SPLIT 1 and 2,
// into out[0 .. 31].
extern "C" int sep_softmax_pv_occupancy(void* out) {
  int* o = static_cast<int*>(out);
  cudaError_t err =
      softmax_pv_tile::occupancy(softmax_pv_kernel<kBaseD, 1, false>, o);
  if (err == cudaSuccess)
    err = softmax_pv_tile::occupancy(softmax_pv_kernel<kBaseD, 2, false>,
                                     o + 4);
  if (err == cudaSuccess)
    err = softmax_pv_tile::occupancy(softmax_pv_kernel<kBaseD, 1, true>,
                                     o + 8);
  if (err == cudaSuccess)
    err = softmax_pv_tile::occupancy(softmax_pv_kernel<kBaseD, 2, true>,
                                     o + 12);
  if (err == cudaSuccess)
    err = softmax_pv_tile::occupancy(softmax_pv_kernel<32, 1, false>,
                                     o + 16);
  if (err == cudaSuccess)
    err = softmax_pv_tile::occupancy(softmax_pv_kernel<32, 2, false>,
                                     o + 20);
  if (err == cudaSuccess)
    err = softmax_pv_tile::occupancy(softmax_pv_kernel<32, 1, true>,
                                     o + 24);
  if (err == cudaSuccess)
    err = softmax_pv_tile::occupancy(softmax_pv_kernel<32, 2, true>,
                                     o + 28);
  return (int)err;
}
