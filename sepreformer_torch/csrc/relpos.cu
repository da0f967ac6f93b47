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
// Design.  A grid of one thread per output float (16,384 blocks at
// t=512) takes longer to launch than the copy takes (PERF.md), so a
// block of 256 threads covers a tile of kR output rows i, kJ
// columns j and up to kD table columns, and the grid holds at most one
// wave of blocks (the card's block slots), each walking tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...  A tile reads only the table
// rows of its kR + kJ - 1 offsets i - j.  They are staged, as the TPU
// kernel's reversed and transposed table (_pe_revT), into a window
// win[dd][c] holding table[clip(o) + maxlen, dd] for o = i0 - j0 + kR -
// 1 - c, so each output row out[i, dd, j0 : j0 + kJ] is the contiguous
// slice win[dd][kR - 1 - (i - i0) ...], one float earlier for each i.
// The table loads are coalesced (dd fastest).  Where t % 4 == 0 a lane
// writes 4 consecutive j with one 16-byte store from 4 shared reads:
// lane (a, b) = (lane % 8, lane / 8) takes row i0 + 4 rs + b and columns
// j0 + 32 js + 4 a, so a warp stores four 128-byte row segments and its
// 32 lanes read the window at 4 a - b + const, 32 consecutive floats: no
// bank conflict.  Otherwise (rows not 16-byte aligned) a lane writes one
// float, 32 consecutive j a warp.  The next tile's window is loaded into
// registers before this tile's stores are issued and written to the
// second buffer after them: one barrier a tile.  The output is an exact
// copy.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 32;            // output rows i per tile
constexpr int kJ = 32;            // output columns j per tile (32 k)
constexpr int kD = 16;            // table columns per tile
constexpr int kW = kR + kJ - 1;   // a window row: the tile's offsets i - j
// window floats each thread stages
constexpr int kStage = (kD * kW + kThreads - 1) / kThreads;

struct Tiles {
  int ni, nj, nd;  // tiles along i, j and the table's columns
  __host__ __device__ int count() const { return ni * nj * nd; }
};

// Tile `tile`'s first row i0, column j0, table column d0 and width dn.
struct Tile {
  int i0, j0, d0, dn;
  __device__ Tile(int tile, const Tiles& n, int d) {
    const int db = tile % n.nd, rest = tile / n.nd;
    i0 = (rest / n.nj) * kR;
    j0 = (rest % n.nj) * kJ;
    d0 = db * kD;
    dn = min(kD, d - d0);
  }
};

// The tile's window into registers: element e = threadIdx.x + s *
// kThreads < dn * kW is window column c = e / dn, table column dd = e % dn.
__device__ __forceinline__ void load_window(const float* __restrict__ table,
                                            const Tile& tl, int d, int maxlen,
                                            float (&v)[kStage]) {
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const int e = threadIdx.x + s * kThreads;
    if (e < tl.dn * kW) {
      const int c = e / tl.dn, dd = e % tl.dn;
      const int o = tl.i0 - tl.j0 + kR - 1 - c;
      const int r = min(max(o, -maxlen), maxlen - 1) + maxlen;
      v[s] = table[(size_t)r * d + tl.d0 + dd];
    }
  }
}

__device__ __forceinline__ void put_window(float* win, const Tile& tl,
                                           const float (&v)[kStage]) {
#pragma unroll
  for (int s = 0; s < kStage; ++s) {
    const int e = threadIdx.x + s * kThreads;
    if (e < tl.dn * kW) win[(e % tl.dn) * kW + e / tl.dn] = v[s];
  }
}

// The tile's output from its window.  kVec: units (row quad rs, column dd,
// 32-column segment js), one 16-byte store a lane; else units (row, dd,
// js), one float a lane.
template <bool kVec>
__device__ __forceinline__ void write_tile(const float* win, const Tile& tl,
                                           float* __restrict__ out, int t,
                                           int d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kSeg = kJ / 32, kRowSets = kVec ? kR / 4 : kR;
  const int units = kRowSets * tl.dn * kSeg;
  const int a = kVec ? lane & 7 : lane, b = kVec ? lane >> 3 : 0;
  for (int u = warp; u < units; u += kThreads / 32) {
    const int js = u % kSeg, rest = u / kSeg;
    const int dd = rest % tl.dn, rs = rest / tl.dn;
    const int di = kVec ? 4 * rs + b : rs;        // i - i0
    const int dj = 32 * js + (kVec ? 4 * a : a);  // j - j0
    const int i = tl.i0 + di, j = tl.j0 + dj;
    if (i >= t || j >= t) continue;
    const float* src = win + dd * kW + dj - di + kR - 1;
    float* dst = out + ((size_t)i * d + tl.d0 + dd) * t + j;
    if (kVec) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(src[0], src[1], src[2], src[3]);
    } else {
      *dst = src[0];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
relpos_kernel(const float* __restrict__ table, float* __restrict__ out,
              int t, int d, int maxlen, Tiles n) {
  __shared__ float win[2][kD * kW];
  const int tiles = n.count();
  int tile = blockIdx.x;
  if (tile >= tiles) return;  // the same for every thread of the block
  float v[kStage];
  Tile tl(tile, n, d);
  load_window(table, tl, d, maxlen, v);
  put_window(win[0], tl, v);
  __syncthreads();
  for (int k = 0; tile < tiles; ++k, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const Tile nt(next < tiles ? next : tile, n, d);
    if (next < tiles) load_window(table, nt, d, maxlen, v);
    write_tile<kVec>(win[k & 1], tl, out, t, d);
    if (next < tiles) put_window(win[(k + 1) & 1], nt, v);
    __syncthreads();  // the next window in place, this one read
    tl = nt;
  }
}

// The launch: the tiles and a grid of at most one wave of blocks.
struct Plan {
  Tiles n;
  int blocks, vec, blocks_per_sm;
  const void* kernel;
};

// The SMs and each kernel's blocks per SM on device `dev`, asked of the
// runtime at its first launch there and kept (0: not asked yet), so a
// launch makes one runtime query, cudaGetDevice.
constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices], g_per_sm[kMaxDevices][2];

cudaError_t block_slots(int dev, int vec, const void* kernel, int* sms,
                        int* per_sm) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = g_sms[dev].load(std::memory_order_relaxed);
  *per_sm = g_per_sm[dev][vec].load(std::memory_order_relaxed);
  if (*sms > 0 && *per_sm > 0) return cudaSuccess;
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  g_sms[dev].store(*sms, std::memory_order_relaxed);
  g_per_sm[dev][vec].store(*per_sm, std::memory_order_relaxed);
  return cudaSuccess;
}

cudaError_t make_plan(int t, int d, const void* out, Plan* p) {
  p->n = Tiles{(t + kR - 1) / kR, (t + kJ - 1) / kJ, (d + kD - 1) / kD};
  p->vec = t % 4 == 0 && (uintptr_t)out % 16 == 0;
  p->kernel = p->vec ? (const void*)&relpos_kernel<true>
                     : (const void*)&relpos_kernel<false>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = block_slots(dev, p->vec, p->kernel, &sms, &p->blocks_per_sm);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)p->n.ni * p->n.nj * p->n.nd;
  const long long slots = (long long)p->blocks_per_sm * sms;
  if (tiles > 0x7fffffffLL - slots) return cudaErrorInvalidValue;
  p->blocks = (int)(tiles < slots ? tiles : slots);
  return cudaSuccess;
}

}  // namespace

// table: device float32 [2*maxlen, d]; out: device float32 [t, d, t].
extern "C" int sep_relpos_f32(const void* table, void* out, int t, int d,
                              int maxlen, void* stream) {
  if (t <= 0 || d <= 0) return 0;
  if (maxlen <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(t, d, out, &p);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  auto tab = static_cast<const float*>(table);
  auto o = static_cast<float*>(out);
  if (p.vec)
    relpos_kernel<true><<<p.blocks, kThreads, 0, st>>>(tab, o, t, d, maxlen,
                                                       p.n);
  else
    relpos_kernel<false><<<p.blocks, kThreads, 0, st>>>(tab, o, t, d, maxlen,
                                                        p.n);
  return (int)cudaGetLastError();
}

// out: int[5] = the launch's blocks (grid), tiles, blocks per SM,
// registers and local (spill) bytes at (t, d).
extern "C" int sep_relpos_occupancy(int t, int d, void* out) {
  if (t <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(t, d, nullptr, &p);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, p.kernel);
  if (err != cudaSuccess) return (int)err;
  int* o = static_cast<int*>(out);
  o[0] = p.blocks;
  o[1] = p.n.count();
  o[2] = p.blocks_per_sm;
  o[3] = a.numRegs;
  o[4] = (int)a.localSizeBytes;
  return 0;
}
