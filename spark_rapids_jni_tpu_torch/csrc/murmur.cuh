// Murmur3_32 mixing for the kernels: the same arithmetic as
// spark_rapids_jni_tpu_torch/ops/murmur.py, in native uint32 (unsigned
// overflow wraps, as the hash needs). Shared by partition.cu (B1) and
// join.cu (B4's bucket function).
#pragma once

#include <cstdint>

namespace murmur {

constexpr uint32_t kSeed = 42u;  // Spark's Murmur3Hash default seed

// r is 13 or 15 only: a 32-bit shift by 32 is undefined in C++
__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k(uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl(k, 15);
  return k * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h(uint32_t h, uint32_t k) {
  h ^= mix_k(k);
  h = rotl(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

}  // namespace murmur
