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
// Design.  K9 (and K9b) is the tile of csrc/softmax_pv_tile.cuh, K3's
// too, with the mask applied to the numerator only and each row's max
// and sum written out, which the backward reuses.
//
// K10's sum over query rows for dV is the part the TPU did in one grid
// step per (b, h): here one block takes 64 keys of one (b, h) and walks
// every query row, so it owns its dV rows outright and needs no second
// pass and no atomics.  What limits such a walk is the bytes in flight: a
// warp that loads a score, computes and stores before its next load keeps
// ~4 KB in flight per SM, well under 1 TB/s.  So the rows arrive in a ring
// of kStages stages of kStageRows rows by cp.async (each stage: the score
// rows of the block's keys, with the bias's in K10b, the rows' dOut and
// out slices and their max and sum; 12 KB, 20 KB in K10b), issued
// kStages - 1 tiles ahead: ~36 KB in flight per block, two blocks per SM.
// Score chunks with no key below lim are not read (zero-filled).  Each
// lane keeps two neighbouring keys' V rows and dV partials in registers
// and stores their dS as one float2 (a warp writes a 256-byte row
// segment); the 8 warps split a stage's rows, four each, and four lanes
// per row take its max, 1 / sum and dOut . out (a float4 of the dot each)
// once per stage and shuffle them to the warp.  P is recomputed from the
// forward's row stats; keys past lim get P = 0 by a select.  The warps'
// dV partials are added in warp order at the end, a float4 per thread.
// A block whose keys all lie past lim writes zeros and reads nothing.
// The products (dP of depth 16, dV) stay on the CUDA cores: about 8 us of
// FMAs at [4, 8, 512, 512], under the 21 us of bytes.
//
// Two instances of each, by head width D: Base's 16 and Large's 32.  K9
// at D = 32 is the tile's D = 32 instance (K3's).  K10 at D = 32 keeps
// the design: a lane's two keys' V rows and dV partials and a dOut row
// are 160 floats, so its block runs alone on its SM, at up to 255
// registers, where D = 16's 80 floats let two blocks share one at 128.
// To keep the bytes in flight that the second block gave, its ring has
// twice the stages (8, 133 KB; 199 KB in K10b), filled kStages - 1 ahead;
// a stage's dOut and out rows are D floats, the dV partials' rows D + 4,
// their sum two float4s a thread.  Its FMAs double (16 us at [4, 8, 512,
// 512]), still under the bytes' 21 us.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_dropout.cuh"
#include "mma_tf32x3.cuh"  // cp_async16, cp_async4 and their group helpers
#include "softmax_pv_tile.cuh"

using softmax_pv_tile::kBaseD;  // Base's head width (K9, K10 also take 32)

namespace {

constexpr int kThreads = 256;            // K10
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 64;            // K10: keys per block
constexpr int kStageRows = 32;          // K10: query rows per stage

template <int D, int SPLIT, bool HAS_BIAS>
__global__ void __launch_bounds__(softmax_pv_tile::kThreads,
                                  HAS_BIAS ? softmax_pv_tile::kMinBlocksBias
                                           : softmax_pv_tile::kMinBlocks)
softmax_pv_train_fwd_kernel(softmax_pv_tile::Args a) {
  softmax_pv_tile::run<D, SPLIT, HAS_BIAS, true>(a);
}

// K10's ring at head width D: kStages stages, each kStageRows query rows
// of one (b, h) against the block's kKeyTile keys and what those rows
// need besides; the blocks an SM holds (two at D = 16, one at D = 32,
// whose lanes hold twice the floats).
template <int D, bool HAS_BIAS>
struct BwdStage {
  static constexpr int kStages = D == 16 ? 4 : 8;
  static constexpr int kBlocks = D == 16 ? 2 : 1;
  static constexpr int s = 0;                             // [rows][keys]
  static constexpr int bias = s + kStageRows * kKeyTile;  // the same, bias
  static constexpr int dout = bias + (HAS_BIAS ? kStageRows * kKeyTile : 0);
  static constexpr int out = dout + kStageRows * D;       // [rows][D]
  static constexpr int m = out + kStageRows * D;          // [rows] row max
  static constexpr int l = m + kStageRows;                // [rows] row sum
  static constexpr int floats = l + kStageRows;
  static constexpr int red_stride = D + 4;  // dV partial rows, 16-B aligned
  static constexpr size_t smem_bytes =
      sizeof(float) * (size_t)kStages * floats;
  static_assert(kWarps * kKeyTile * red_stride <= kStages * floats,
                "the dV partials fit over the ring");
  static_assert(floats % 4 == 0, "stages stay 16-byte aligned");
  static_assert(smem_bytes <= 227 * 1024, "the ring fits one block");
};

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads, (BwdStage<D, HAS_BIAS>::kBlocks))
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
  static_assert(D == 16 || D == 32, "head widths 16 and 32");
  using S = BwdStage<D, HAS_BIAS>;
  constexpr int kStages = S::kStages;
  constexpr int RW = kStageRows / kWarps;  // rows of a stage per warp
  constexpr int PR = D / 4;                // float4s of a dOut or out row
  static_assert(RW * PR <= 32, "a row's stats in a group of D/4 lanes");
  extern __shared__ __align__(16) float smem[];

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kKeyTile, jl = j0 + 2 * lane;  // lane's keys
  const int lim = min(min(length, lens[b]), Lp);
  const size_t bh = (size_t)b * H + h;
  const float* sb = scores + bh * Lp * Lp;
  const float* bb = HAS_BIAS ? bias + bh * Lp * Lp : nullptr;
  float* dsb = dscores + bh * Lp * Lp;
  const bool vec = Lp % 4 == 0;  // score rows in 16-byte copies
  const int tiles = (Lp + kStageRows - 1) / kStageRows;

  // dS row i at the lane's two keys (nothing at keys >= Lp)
  auto store_ds = [&](int i, float d0, float d1) {
    float* dst = dsb + (size_t)i * Lp + jl;
    if (Lp % 2 == 0 && jl + 1 < Lp) {
      *reinterpret_cast<float2*>(dst) = make_float2(d0, d1);
    } else {
      if (jl < Lp) dst[0] = d0;
      if (jl + 1 < Lp) dst[1] = d1;
    }
  };
  if (j0 >= lim) {  // no valid key: dS and dV are zero
    for (int i = warp; i < Lp; i += kWarps) store_ds(i, 0.f, 0.f);
    for (int e = tid; e < kKeyTile * D; e += kThreads) {
      const int k = e / D, c = e - k * D;
      if (j0 + k < Lp) dv[((size_t)b * Lp + j0 + k) * F + h * D + c] = 0.f;
    }
    return;
  }

  // row tile k into stage k % kStages as one cp.async group (an empty one
  // past the last tile): the score (and bias) chunks that hold a valid key,
  // zeros elsewhere; the dOut and out rows; the row stats
  auto stage = [&](int k) {
    if (k < tiles) {
      float* st = smem + (k % kStages) * S::floats;
      const int i0 = k * kStageRows;
      if (vec) {
#pragma unroll
        for (int q = 0; q < kStageRows * kKeyTile / 4 / kThreads; ++q) {
          const int e = tid + q * kThreads;
          const int r = e / (kKeyTile / 4), j = 4 * (e - r * (kKeyTile / 4));
          const bool in = i0 + r < Lp && j0 + j < lim;
          const size_t off = in ? (size_t)(i0 + r) * Lp + j0 + j : 0;
          tf32x3::cp_async16(st + S::s + r * kKeyTile + j, sb + off, in);
          if (HAS_BIAS)
            tf32x3::cp_async16(st + S::bias + r * kKeyTile + j, bb + off, in);
        }
      } else {
#pragma unroll 4
        for (int q = 0; q < kStageRows * kKeyTile / kThreads; ++q) {
          const int e = tid + q * kThreads;
          const int r = e / kKeyTile, j = e - r * kKeyTile;
          const bool in = i0 + r < Lp && j0 + j < lim;
          const size_t off = in ? (size_t)(i0 + r) * Lp + j0 + j : 0;
          tf32x3::cp_async4(st + S::s + r * kKeyTile + j, sb + off, in);
          if (HAS_BIAS)
            tf32x3::cp_async4(st + S::bias + r * kKeyTile + j, bb + off, in);
        }
      }
      // dOut rows (the first kStageRows * D / 4 copies), then out rows
      static_assert(2 * kStageRows * PR % kThreads == 0,
                    "16-byte copies of dOut and out, the same count a "
                    "thread");
#pragma unroll
      for (int q = 0; q < 2 * kStageRows * PR / kThreads; ++q) {
        const int e0 = tid + q * kThreads;
        const bool second = e0 >= kStageRows * PR;
        const int e = e0 - (second ? kStageRows * PR : 0);
        const int r = e / PR, c = 4 * (e % PR);
        const bool in = i0 + r < Lp;
        const float* src = (second ? out : dout) +
                           ((size_t)b * Lp + (in ? i0 + r : 0)) * F + h * D +
                           c;
        tf32x3::cp_async16(st + (second ? S::out : S::dout) + r * D + c, src,
                           in);
      }
      if (tid < 2 * kStageRows) {  // row max (threads 0..31), then sum
        const bool second = tid >= kStageRows;
        const int r = tid - (second ? kStageRows : 0);
        const bool in = i0 + r < Lp;
        tf32x3::cp_async4(
            st + (second ? S::l : S::m) + r,
            (second ? row_sum : row_max) + bh * Lp + (in ? i0 + r : 0), in);
      }
    }
    tf32x3::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k + 1 < kStages; ++k) stage(k);

  // the lane's two keys: V rows and dV partials (V zero past lim)
  const bool valid0 = jl < lim, valid1 = jl + 1 < lim;
  float vj[2][D], dvj[2][D];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const bool in = q ? valid1 : valid0;
    const float4* src = reinterpret_cast<const float4*>(
        v + ((size_t)b * Lp + (in ? jl + q : 0)) * F + h * D);
#pragma unroll
    for (int c4 = 0; c4 < D / 4; ++c4) {
      const float4 t = in ? src[c4] : make_float4(0.f, 0.f, 0.f, 0.f);
      vj[q][4 * c4] = t.x;
      vj[q][4 * c4 + 1] = t.y;
      vj[q][4 * c4 + 2] = t.z;
      vj[q][4 * c4 + 3] = t.w;
    }
#pragma unroll
    for (int c = 0; c < D; ++c) dvj[q][c] = 0.f;
  }

  for (int k = 0; k < tiles; ++k) {
    tf32x3::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k is in place; tile k-1's stage is consumed
    stage(k + kStages - 1);
    const float* st = smem + (k % kStages) * S::floats;
    const int i0 = k * kStageRows;

    // the warp's rows warp + kWarps * rr: lanes PR rr .. PR rr + PR - 1
    // (and at D = 16 again 16 later) take row rr's max, 1 / sum and
    // dOut . out, a float4 of the dot each, and shuffle them to the warp
    // per row
    float m_r, linv_r, dot_r;
    {
      const int rr = (lane % (RW * PR)) / PR, c4 = lane % PR;
      const int r = warp + kWarps * rr;
      const float4 g =
          reinterpret_cast<const float4*>(st + S::dout + r * D)[c4];
      const float4 o = reinterpret_cast<const float4*>(st + S::out + r * D)[c4];
      float d = g.x * o.x + g.y * o.y + g.z * o.z + g.w * o.w;
#pragma unroll
      for (int x = 1; x < PR; x <<= 1) d += __shfl_xor_sync(0xffffffffu, d, x);
      dot_r = d;
      m_r = st[S::m + r];
      linv_r = 1.f / st[S::l + r];
    }
#pragma unroll 2
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp + kWarps * rr, i = i0 + r;
      if (i >= Lp) break;
      const float m = __shfl_sync(0xffffffffu, m_r, PR * rr);
      const float linv = __shfl_sync(0xffffffffu, linv_r, PR * rr);
      const float rowdot = __shfl_sync(0xffffffffu, dot_r, PR * rr);
      float g[D];
#pragma unroll
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 t =
            reinterpret_cast<const float4*>(st + S::dout + r * D)[c4];
        g[4 * c4] = t.x;
        g[4 * c4 + 1] = t.y;
        g[4 * c4 + 2] = t.z;
        g[4 * c4 + 3] = t.w;
      }
      float2 s2 = *reinterpret_cast<const float2*>(st + S::s + r * kKeyTile +
                                                   2 * lane);
      if constexpr (HAS_BIAS) {
        const float2 b2 = *reinterpret_cast<const float2*>(
            st + S::bias + r * kKeyTile + 2 * lane);
        s2.x += b2.x;
        s2.y += b2.y;
      }
      float ds[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        // keys past lim: P = 0 by a select (their staged score may be any
        // value), so dS and the dV term are 0
        const float e = expf((q ? s2.y : s2.x) - m) * linv;
        const float p = (q ? valid1 : valid0) ? e : 0.f;
        float scale = 1.f;
        if (threshold)
          scale = sep_keep(seed_word, (uint32_t)(bh * Lp + i),
                           (uint32_t)(jl + q), threshold)
                      ? keep_scale
                      : 0.f;
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += 2) {
          d0 = fmaf(g[c], vj[q][c], d0);
          d1 = fmaf(g[c + 1], vj[q][c + 1], d1);
        }
        ds[q] = p * ((d0 + d1) * scale - rowdot);
        const float pd = p * scale;
#pragma unroll
        for (int c = 0; c < D; ++c) dvj[q][c] = fmaf(pd, g[c], dvj[q][c]);
      }
      store_ds(i, ds[0], ds[1]);
    }
  }

  // the warps' dV partials, summed in warp order
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* red = smem;  // [kWarps][kKeyTile][red_stride]
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c4 = 0; c4 < D / 4; ++c4)
      *reinterpret_cast<float4*>(
          red + (warp * kKeyTile + 2 * lane + q) * S::red_stride + 4 * c4) =
          make_float4(dvj[q][4 * c4], dvj[q][4 * c4 + 1], dvj[q][4 * c4 + 2],
                      dvj[q][4 * c4 + 3]);
  __syncthreads();
  static_assert(kKeyTile * PR % kThreads == 0,
                "float4s of dV, the same count a thread");
#pragma unroll
  for (int q = 0; q < kKeyTile * PR / kThreads; ++q) {
    const int e = tid + q * kThreads;
    const int k = e / PR, c4 = e % PR;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 t = *reinterpret_cast<const float4*>(
          red + (w * kKeyTile + k) * S::red_stride + 4 * c4);
      acc.x += t.x;
      acc.y += t.y;
      acc.z += t.z;
      acc.w += t.w;
    }
    if (j0 + k < Lp)
      *reinterpret_cast<float4*>(dv + ((size_t)b * Lp + j0 + k) * F + h * D +
                                 4 * c4) = acc;
  }
}

template <int D, bool HAS_BIAS>
cudaError_t set_bwd_attributes() {
  return cudaFuncSetAttribute(softmax_pv_train_bwd_kernel<D, HAS_BIAS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)BwdStage<D, HAS_BIAS>::smem_bytes);
}

template <int D, bool HAS_BIAS>
int launch_bwd(const void* scores, const void* bias, const void* v,
               const void* out, const void* dout, const void* row_max,
               const void* row_sum, const void* lens, void* dscores,
               void* dv, int B, int H, int Lp, int F, int length,
               uint32_t seed_word, uint32_t threshold, float keep_scale,
               void* stream) {
  if (int err = softmax_pv_tile::check<D>(B, H, Lp, F, length)) return err;
  const cudaError_t err = set_bwd_attributes<D, HAS_BIAS>();
  if (err != cudaSuccess) return (int)err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  dim3 grid((Lp + kKeyTile - 1) / kKeyTile, H, B);
  softmax_pv_train_bwd_kernel<D, HAS_BIAS>
      <<<grid, kThreads, BwdStage<D, HAS_BIAS>::smem_bytes,
         static_cast<cudaStream_t>(stream)>>>(
          f(scores), f(bias), f(v), f(out), f(dout), f(row_max), f(row_sum),
          static_cast<const int*>(lens), static_cast<float*>(dscores),
          static_cast<float*>(dv), H, Lp, F, length, seed_word, threshold,
          keep_scale);
  return (int)cudaGetLastError();
}

// K9 (or K9b with a bias) at the head width D = F / H: Base's 16 or
// Large's 32.
template <bool HAS_BIAS>
int launch_fwd(const void* scores, const void* bias, const void* v,
               const void* lens, void* out, void* row_max, void* row_sum,
               int B, int H, int Lp, int F, int length, uint32_t seed_word,
               uint32_t threshold, float keep_scale, void* stream) {
  if (H > 0 && F == 32 * H)
    return softmax_pv_tile::launch<32>(
        softmax_pv_train_fwd_kernel<32, 1, HAS_BIAS>,
        softmax_pv_train_fwd_kernel<32, 2, HAS_BIAS>, scores, bias, v, lens,
        out, row_max, row_sum, B, H, Lp, F, length, seed_word, threshold,
        keep_scale, stream);
  return softmax_pv_tile::launch<kBaseD>(
      softmax_pv_train_fwd_kernel<kBaseD, 1, HAS_BIAS>,
      softmax_pv_train_fwd_kernel<kBaseD, 2, HAS_BIAS>, scores, bias, v,
      lens, out, row_max, row_sum, B, H, Lp, F, length, seed_word, threshold,
      keep_scale, stream);
}

// K10 (or K10b) at the head width D = F / H.
template <bool HAS_BIAS>
int launch_bwd_any(const void* scores, const void* bias, const void* v,
                   const void* out, const void* dout, const void* row_max,
                   const void* row_sum, const void* lens, void* dscores,
                   void* dv, int B, int H, int Lp, int F, int length,
                   uint32_t seed_word, uint32_t threshold, float keep_scale,
                   void* stream) {
  if (B <= 0 || Lp <= 0) return 0;
  const bool wide = H > 0 && F == 32 * H;
  return (wide ? &launch_bwd<32, HAS_BIAS>
               : &launch_bwd<kBaseD, HAS_BIAS>)(
      scores, bias, v, out, dout, row_max, row_sum, lens, dscores, dv, B, H,
      Lp, F, length, seed_word, threshold, keep_scale, stream);
}

template <int D, bool HAS_BIAS>
cudaError_t bwd_blocks(int* n) {
  cudaError_t err = set_bwd_attributes<D, HAS_BIAS>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, softmax_pv_train_bwd_kernel<D, HAS_BIAS>, kThreads,
        BwdStage<D, HAS_BIAS>::smem_bytes);
  return err;
}

}  // namespace

// scores: device float32 [B, H, Lp, Lp]; v, out: [B, Lp, F] with F = H*D
// (D = 16, Base's head width, or 32, Large's); lens: device int32 [B],
// each >= 1; row_max, row_sum: [B, H, Lp] outputs for the backward.
// seed_word is seed + 0 * 0x27D4EB2F (site 0), threshold int(p * 2^24),
// keep_scale 1 / (1 - p); threshold 0 runs without dropout.
extern "C" int sep_softmax_pv_train_fwd_f32(
    const void* scores, const void* v, const void* lens, void* out,
    void* row_max, void* row_sum, int B, int H, int Lp, int F, int length,
    unsigned int seed_word, unsigned int threshold, float keep_scale,
    void* stream) {
  return launch_fwd<false>(scores, nullptr, v, lens, out, row_max, row_sum,
                           B, H, Lp, F, length, seed_word, threshold,
                           keep_scale, stream);
}

// K9b: the same on scores + bias, bias a second [B, H, Lp, Lp] tensor.
extern "C" int sep_softmax_pv_train_fwd_bias_f32(
    const void* scores, const void* bias, const void* v, const void* lens,
    void* out, void* row_max, void* row_sum, int B, int H, int Lp, int F,
    int length, unsigned int seed_word, unsigned int threshold,
    float keep_scale, void* stream) {
  return launch_fwd<true>(scores, bias, v, lens, out, row_max, row_sum, B,
                          H, Lp, F, length, seed_word, threshold, keep_scale,
                          stream);
}

// The forward's inputs, its out, row_max and row_sum, and dout [B, Lp, F];
// writes dscores [B, H, Lp, Lp] and dv [B, Lp, F].
extern "C" int sep_softmax_pv_train_bwd_f32(
    const void* scores, const void* v, const void* out, const void* dout,
    const void* row_max, const void* row_sum, const void* lens,
    void* dscores, void* dv, int B, int H, int Lp, int F, int length,
    unsigned int seed_word, unsigned int threshold, float keep_scale,
    void* stream) {
  return launch_bwd_any<false>(scores, nullptr, v, out, dout, row_max,
                               row_sum, lens, dscores, dv, B, H, Lp, F,
                               length, seed_word, threshold, keep_scale,
                               stream);
}

// K10b: the same with K9b's bias; dscores is also the bias's cotangent.
extern "C" int sep_softmax_pv_train_bwd_bias_f32(
    const void* scores, const void* bias, const void* v, const void* out,
    const void* dout, const void* row_max, const void* row_sum,
    const void* lens, void* dscores, void* dv, int B, int H, int Lp, int F,
    int length, unsigned int seed_word, unsigned int threshold,
    float keep_scale, void* stream) {
  return launch_bwd_any<true>(scores, bias, v, out, dout, row_max, row_sum,
                              lens, dscores, dv, B, H, Lp, F, length,
                              seed_word, threshold, keep_scale, stream);
}

// Blocks that one SM holds at once, with the launch's attributes set, of
// K10, K10b, K10 at D = 32 and K10b at D = 32, into blocks[0 .. 3].
extern "C" int sep_softmax_pv_train_bwd_blocks_per_sm(void* blocks) {
  int* n = static_cast<int*>(blocks);
  cudaError_t err = bwd_blocks<kBaseD, false>(n);
  if (err == cudaSuccess) err = bwd_blocks<kBaseD, true>(n + 1);
  if (err == cudaSuccess) err = bwd_blocks<32, false>(n + 2);
  if (err == cudaSuccess) err = bwd_blocks<32, true>(n + 3);
  return (int)err;
}

// The occupancy (softmax_pv_tile::occupancy) of K9 at SPLIT 1 and 2, then
// of K9b at SPLIT 1 and 2, then the same four at D = 32, into
// out[0 .. 31].
extern "C" int sep_softmax_pv_train_fwd_occupancy(void* out) {
  int* o = static_cast<int*>(out);
  using softmax_pv_tile::occupancy;
  cudaError_t err = occupancy(softmax_pv_train_fwd_kernel<kBaseD, 1, false>,
                              o);
  if (err == cudaSuccess)
    err = occupancy(softmax_pv_train_fwd_kernel<kBaseD, 2, false>, o + 4);
  if (err == cudaSuccess)
    err = occupancy(softmax_pv_train_fwd_kernel<kBaseD, 1, true>, o + 8);
  if (err == cudaSuccess)
    err = occupancy(softmax_pv_train_fwd_kernel<kBaseD, 2, true>, o + 12);
  if (err == cudaSuccess)
    err = occupancy(softmax_pv_train_fwd_kernel<32, 1, false>, o + 16);
  if (err == cudaSuccess)
    err = occupancy(softmax_pv_train_fwd_kernel<32, 2, false>, o + 20);
  if (err == cudaSuccess)
    err = occupancy(softmax_pv_train_fwd_kernel<32, 1, true>, o + 24);
  if (err == cudaSuccess)
    err = occupancy(softmax_pv_train_fwd_kernel<32, 2, true>, o + 28);
  return (int)err;
}
