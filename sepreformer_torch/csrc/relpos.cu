// Rel-pos table materializer: out[i, d, j] = table[clip(i - j, -maxlen,
// maxlen - 1) + maxlen, d], float32, layout [t, D, t] with j innermost.
//
// Replaces: sepreformer_tpu/ops/pallas/relpos.py::materialize_pos_kt
//           (_kernel).
//
// What bounds it on the H100: it is a pure copy.  It writes t*D*t floats
// (16.8 MB at t=512, D=16) and reads a table of 2*maxlen*D floats that
// stays in L2, so it is bound by the write bytes at 3.35 TB/s.
//
// Design: one thread per output element, j fastest, so each warp stores
// 128 contiguous bytes.  The TPU kernel rolled a transposed table through
// its lanes to avoid a gather; here the table reads are cached gathers,
// and only the coalesced stores cost device-memory bandwidth.
#include <cuda_runtime.h>

namespace {

__global__ void relpos_kernel(const float* __restrict__ table,
                              float* __restrict__ out, int t, int d,
                              int maxlen) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int dd = blockIdx.y;
  const int i = blockIdx.z;
  if (j >= t) return;
  const int r = min(max(i - j, -maxlen), maxlen - 1) + maxlen;
  out[((size_t)i * d + dd) * t + j] = table[(size_t)r * d + dd];
}

}  // namespace

// table: device float32 [2*maxlen, d]; out: device float32 [t, d, t].
extern "C" int sep_relpos_f32(const void* table, void* out, int t, int d,
                              int maxlen, void* stream) {
  if (t <= 0 || d <= 0) return 0;
  if (t > 65535 || d > 65535) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  dim3 grid((t + kThreads - 1) / kThreads, d, t);
  relpos_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<float*>(out), t, d,
      maxlen);
  return (int)cudaGetLastError();
}
