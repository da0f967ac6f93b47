// The tap loop of the "same" depthwise conv, shared by K4 (the k65 forward,
// csrc/depthwise.cu) and the conv stage of K15 (the fused CLA, csrc/cla.cu):
//   acc[r] += sum_tap w[tap] * v[r + tap],  r < R,
// for one channel of R consecutive output rows, where v is a window in
// shared memory whose row 0 lies K / 2 rows before the first output row
// (zero rows stand for the padding outside [0, T)).  The caller sets acc
// to the bias first.  Strides are in floats: the window's rows and the
// staged weight's taps; lanes of a warp take neighbouring channels, so
// every shared access is free of bank conflicts.
#pragma once

namespace dwtap {

template <int R>
__device__ __forceinline__ void taps(const float* v, int v_stride,
                                     const float* w, int w_stride, int K,
                                     float (&acc)[R]) {
  for (int tap = 0; tap < K; ++tap) {
    const float wv = w[tap * w_stride];
    const float* row = v + tap * v_stride;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += wv * row[r * v_stride];
  }
}

}  // namespace dwtap
