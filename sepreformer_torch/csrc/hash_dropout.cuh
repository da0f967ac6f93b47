// The stateless dropout hash of the train kernels (K7, K8, K9, K10).
//
// The keep mask is a pure function of (seed, site, row, col), so a
// forward kernel, its backward and the plain PyTorch version
// (ops/kernels/hash_dropout.py) regenerate the same mask anywhere, with no
// storage.  It is the JAX package's ops/pallas/gcfn_train.py::keep_mask
// bit for bit: uint32 multiplies and xor-shifts of (seed + site *
// 0x27D4EB2F, row, col), kept iff the top 24 bits reach int(p * 2^24).
// C's uint32_t arithmetic wraps as JAX's uint32 does.  The caller passes
// seed_word = seed + site * 0x27D4EB2F (mod 2^32), computed on the host.
#pragma once

#include <stdint.h>

static __device__ __forceinline__ bool sep_keep(uint32_t seed_word,
                                                uint32_t row, uint32_t col,
                                                uint32_t threshold) {
  uint32_t h = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u) ^ seed_word;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return (h >> 8) >= threshold;
}

// sep_keep split in halves, for a kernel that tests many (row, col) pairs
// of a few rows and columns (K9's tile): the hash's first step xors the
// row's and the column's words, and its first xor-shift distributes over
// that xor, so h ^ (h >> 15) = sep_row_half(seed_word, row) ^
// sep_col_half(col).  sep_keep_halves(row half, col half, threshold << 8)
// is sep_keep(seed_word, row, col, threshold) bit for bit, for threshold
// < 2^24 ((h >> 8) >= threshold is h >= threshold << 8 there).
static __device__ __forceinline__ uint32_t sep_row_half(uint32_t seed_word,
                                                        uint32_t row) {
  const uint32_t h = (row * 0x9E3779B1u) ^ seed_word;
  return h ^ (h >> 15);
}

static __device__ __forceinline__ uint32_t sep_col_half(uint32_t col) {
  const uint32_t h = col * 0x85EBCA77u;
  return h ^ (h >> 15);
}

static __device__ __forceinline__ bool sep_keep_halves(uint32_t row_half,
                                                       uint32_t col_half,
                                                       uint32_t threshold8) {
  uint32_t h = row_half ^ col_half;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return h >= threshold8;
}

// The two sites of the GCFN's train kernels (K7, K8): g after the GLU at
// site 0, the down-projection at site 1.
struct GcfnDrop {
  uint32_t seed0, seed1;  // seed words of sites 0 and 1
  uint32_t threshold;     // int(p * 2^24)
  float scale;            // 1 / (1 - p)
};
