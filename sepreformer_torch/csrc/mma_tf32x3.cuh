// Float32-accurate products on the tensor cores: "3xTF32".
//
// A float x is split as x = big + small, where big is x rounded to TF32
// (10 mantissa bits, round to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds) and small is the remainder x - big, exact in
// float32, whose low 13 bits the tensor core drops (TF32 toward zero, as
// CUTLASS's 3xTF32 takes it).  A product a·b is then taken as
//   a_small·b_big + a_big·b_small + a_big·b_big
// in float32 accumulators; the dropped a_small·b_small term and the
// truncated small parts leave about 2^-21 of |a||b|, against 2^-11 for one
// TF32 product (tests/test_torch_tf32x3.py emulates both).  The three
// products run at 495 / 3 TFLOP/s on an H100 SXM, against 67 for float32
// FMAs on the CUDA cores.  The split costs three instructions (an integer
// add, a mask, a float subtract): cvt.rna.tf32.f32 compiles to a longer
// sequence with special-value checks, and both kernels ran slower with
// it on an H100.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: D[16x8] += A[16x8]
// B[8x8] per warp.  With g = lane / 4 and t = lane % 4, a lane holds
//   A: a0 = A[g][t],  a1 = A[g+8][t],  a2 = A[g][t+4],  a3 = A[g+8][t+4]
//   B: b0 = B[t][g],  b1 = B[t+4][g]
//   C: c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]
// The product sums over k, so any one permutation of k applied to both
// A's columns and B's rows gives the same D: a caller may put k = 2t and
// 2t+1 in the slots t and t+4 (one 8-byte load for a row-major A, or a C
// fragment reused as an A fragment, as flash_relpos.cu does with P).
//
// Each call's products should start from zeroed fragments and be added
// to a running sum in float32 registers: with the tensor cores'
// accumulation run over thousands of steps into one fragment, K12 missed
// its card test's rtol of 1e-4 at L 8750.
//
// mma.sync and not wgmma: the callers' products are short (head width 16
// in K12, row tiles of 32 in K8 and of 64 in K1 and K7), and their float32
// softmax, LayerNorm and GLU work sets their pace; a warp owns its rows'
// fragments.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace tf32x3 {

// x rounded to TF32 (as cvt.rna.tf32.f32 rounds a finite x): half a TF32
// unit added to the magnitude bits, then the 13 low bits dropped.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big rounded to TF32, small the exact remainder, whose
// low bits the tensor core ignores.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
}

// c += a·b, one TF32 product.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b at float32 accuracy: the two small cross terms first, then the
// big one.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[2],
                                     const uint32_t (&b_small)[2]) {
  mma(c, a_small, b_big);
  mma(c, a_big, b_small);
  mma(c, a_big, b_big);
}

// The same with B given as floats, split here.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], float b0,
                                     float b1) {
  uint32_t bb[2], bs[2];
  split(b0, bb[0], bs[0]);
  split(b1, bb[1], bs[1]);
  mma3(c, a_big, a_small, bb, bs);
}

// acc[mt][nt] += A[16 mt .. 16 mt + 15][0 .. 8 KS) B(., n-tile nt) by one
// warp, 3xTF32.  A is row-major in shared memory (lda = 8 mod 32: the
// 8-byte fragment loads are free of bank conflicts); k slots t and t+4 of
// each k-step take k = 2t and 2t+1, so bfrag(ks, nt) returns
// (B(8 ks + 2t, n), B(8 ks + 2t + 1, n)) for the lane's column n = the
// n-tile's column g.  Each fragment takes the three terms in mma3's
// order, but each term is issued over all MT x NT fragments before the
// next, so independent products sit between dependent ones (and K1's and
// K7's tile fits 128 registers without spilling, which issuing mma3 per
// fragment did not).  The product sums into zeroed fragments, added to
// acc in float32 at the end.  K1's and K7's tile (gcfn_tile_mma.cuh) and
// K8's row pass (gcfn_train.cu) take their products so.
template <int MT, int NT, int KS, class BFrag>
__device__ __forceinline__ void warp_product(float (&acc)[MT][NT][4],
                                             const float* A, int lda,
                                             BFrag bfrag) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float c[MT][NT][4] = {};
#pragma unroll 2
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* a = A + (16 * mt + g) * lda + 8 * ks + 2 * t;
      const float2 lo = *reinterpret_cast<const float2*>(a);
      const float2 hi = *reinterpret_cast<const float2*>(a + 8 * lda);
      const float v[4] = {lo.x, hi.x, lo.y, hi.y};
      split(v, ab[mt], as[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b = bfrag(ks, nt);
      const float v[2] = {b.x, b.y};
      split(v, bb[nt], bs[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(c[mt][nt], as[mt], bb[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(c[mt][nt], ab[mt], bs[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(c[mt][nt], ab[mt], bb[nt]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += c[mt][nt][e];
}

// Row and column of element e of a lane's C fragment (m16n8).
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int e) {
  return 2 * (threadIdx.x & 3) + (e & 1);
}

// The 16-byte asynchronous copies that stage K1's, K7's, K8's, K10's,
// K12's and the depthwise backward's tiles in shared memory: zero-filled
// where !valid (src must still be a valid address), committed as one
// group, waited on with at most N groups still in flight.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// The 4-byte form, for rows whose length is not a multiple of 4 floats
// (K10's score rows when Lp % 4 != 0, its row stats, the depthwise
// backward's rows when C % 4 != 0).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32x3

// bfloat16 streams on the tensor cores (namespace bf16s): the helpers of
// the bfloat16 instances of K1 and K7 (gcfn_tile_mma.cuh), K3 and K9
// (softmax_pv_tile.cuh), K8 and K10 (gcfn_train.cu, softmax_pv_train.cu)
// and K12 (flash_relpos_tile.cuh).
//
// The JAX kernels take a bfloat16 stream as bfloat16 operands with float32
// sums (preferred_element_type=float32) and keep their statistics, softmax
// and LayerNorm in float32.  Here the operands are rounded to bfloat16
// (round to nearest even, as a cast rounds) and kept as floats: a bfloat16
// value has 8 mantissa bits, TF32 keeps 10, so one TF32 mma.sync
// (m16n8k8, the fragments above) takes it exactly, its products are
// exact in float32 and its sums are float32, which is what the bf16
// m16n8k16 form computes too, at a third of the 3xTF32 products' work and
// with the fragment layouts, tiles and staging of the float32 instances.
namespace bf16s {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to bfloat16, as a float (round to nearest even).
__device__ __forceinline__ float rounded(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two consecutive values of a row, as floats.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A float as a value of type T (rounded to nearest even into bfloat16).
template <class T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value)
    return v;
  else
    return __float2bfloat16_rn(v);
}

// Two floats stored as two consecutive values (rounded to nearest even
// into bfloat16).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc[mt][nt] += A B by one warp, as tf32x3::warp_product lays out its
// fragments, but with one TF32 product per fragment: A (row-major in
// shared memory) holds values already rounded to bfloat16 (or, with
// kRoundA, float32 values that are rounded as they are read: K8's do0,
// whose float32 rows also give its bias gradient), and bfrag's two B
// values are rounded here, so every product is exact.  The product sums
// into zeroed fragments, added to acc in float32 at the end.
template <int MT, int NT, int KS, bool kRoundA = false, class BFrag>
__device__ __forceinline__ void warp_product(float (&acc)[MT][NT][4],
                                             const float* A, int lda,
                                             BFrag bfrag) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float c[MT][NT][4] = {};
#pragma unroll 2
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p = A + (16 * mt + g) * lda + 8 * ks + 2 * t;
      const float2 lo = *reinterpret_cast<const float2*>(p);
      const float2 hi = *reinterpret_cast<const float2*>(p + 8 * lda);
      if (kRoundA) {
        a[mt][0] = __float_as_uint(rounded(lo.x));
        a[mt][1] = __float_as_uint(rounded(hi.x));
        a[mt][2] = __float_as_uint(rounded(lo.y));
        a[mt][3] = __float_as_uint(rounded(hi.y));
      } else {
        a[mt][0] = __float_as_uint(lo.x);
        a[mt][1] = __float_as_uint(hi.x);
        a[mt][2] = __float_as_uint(lo.y);
        a[mt][3] = __float_as_uint(hi.y);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 w = bfrag(ks, nt);
      b[nt][0] = __float_as_uint(rounded(w.x));
      b[nt][1] = __float_as_uint(rounded(w.y));
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) tf32x3::mma(c[mt][nt], a[mt], b[nt]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += c[mt][nt][e];
}

}  // namespace bf16s
