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
