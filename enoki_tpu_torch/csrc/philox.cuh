// Philox4x32-10 (Salmon, Moraes, Dror, Shaw: "Parallel random numbers: as
// easy as 1, 2, 3", SC 2011), a counter-based generator: four 32-bit words
// from a 128-bit counter and a 64-bit key by ten rounds of two 32x32 -> 64
// products and a few xors. It stands in for the random bits that the
// reference's kernels draw from their device's own generator, which this
// card does not have. Integer arithmetic only, so
// ops.rounding.philox4x32 computes the same words in PyTorch.
//
// _build.py hashes this header with every source.

#pragma once

#include <cstdint>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

struct Philox4 {
  uint32_t w[4];
};

// The block of the counter (counter, 0) under the key `key`, low word
// first in both.
__host__ __device__ __forceinline__ Philox4 philox4x32_10(uint64_t counter,
                                                          uint64_t key) {
  uint32_t c0 = static_cast<uint32_t>(counter);
  uint32_t c1 = static_cast<uint32_t>(counter >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = static_cast<uint32_t>(key);
  uint32_t k1 = static_cast<uint32_t>(key >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint64_t p0 = static_cast<uint64_t>(kPhiloxM0) * c0;
    const uint64_t p1 = static_cast<uint64_t>(kPhiloxM1) * c2;
    const uint32_t n0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ k0;
    const uint32_t n2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ k1;
    c1 = static_cast<uint32_t>(p1);
    c3 = static_cast<uint32_t>(p0);
    c0 = n0;
    c2 = n2;
  }
  return Philox4{{c0, c1, c2, c3}};
}

}  // namespace
