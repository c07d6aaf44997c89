// Byte windows of a uint8 buffer read as aligned 32-bit words, for kernels
// whose byte addresses have any alignment (a string's start in a chars
// pool, a row's start in a row blob). Shared by planes.cu (rows_to_planes)
// and strings.cu (B5, extract_strings_many).
//
// The buffer's first byte lies mis = address % 4 bytes into its first
// aligned word pal[0], so buffer byte p is byte mis + p of the aligned words
// ("aligned coordinates"), and lim = mis + length ends it. A word is loaded
// only where it holds a byte of the buffer, and that word lies in the
// buffer's allocation: no load leaves it, whatever the alignment.
#pragma once

#include <cstdint>

namespace bytes {

// a loaded aligned word q with its bytes outside [mis, lim) cleared
__device__ __forceinline__ uint32_t clear(uint32_t v, int64_t mis, int64_t lim, int64_t q) {
  const int64_t b = 4 * q;
  const int64_t head = mis - b, tail = b + 4 - lim;  // bytes of the word before / past the buffer
  if (head > 0) v &= head >= 4 ? 0u : 0xFFFFFFFFu << (8 * (int)head);
  if (tail > 0) v &= tail >= 4 ? 0u : 0xFFFFFFFFu >> (8 * (int)tail);
  return v;
}

// the little-endian word at byte sh (0-3) of the pair lo, hi
__device__ __forceinline__ uint32_t funnel(uint32_t lo, uint32_t hi, int sh) {
  return sh == 0 ? lo : (lo >> (8 * sh)) | (hi << (32 - 8 * sh));  // no shift by 32
}

// the first n bytes of v (all of it for n >= 4, none for n <= 0)
__device__ __forceinline__ uint32_t keep(uint32_t v, int64_t n) {
  return n >= 4 ? v : (n <= 0 ? 0u : v & ((1u << (8 * (int)n)) - 1u));
}

// A buffer in aligned words, with the few compares a load needs set up
// once: the words 0 .. nwords - 1 hold its bytes (none when it is empty),
// and only the first and the last of them can hold bytes outside it.
struct Buffer {
  const uint32_t* pal;
  int64_t mis, lim, nwords;

  __device__ __forceinline__ Buffer(const void* data, int64_t len) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
    mis = (int64_t)(addr & 3);
    pal = reinterpret_cast<const uint32_t*>(addr - (uintptr_t)mis);
    lim = mis + len;
    nwords = len > 0 ? ((lim - 1) >> 2) + 1 : 0;
  }

  // aligned word q, bytes outside the buffer 0
  __device__ __forceinline__ uint32_t word(int64_t q) const {
    if ((uint64_t)q >= (uint64_t)nwords) return 0u;  // q < 0 or past the last word
    const uint32_t v = __ldg(pal + q);
    return q == 0 || q == nwords - 1 ? clear(v, mis, lim, q) : v;
  }

  // whether words q0 .. q1 hold only bytes of the buffer
  __device__ __forceinline__ bool inside(int64_t q0, int64_t q1) const {
    return 4 * q0 >= mis && 4 * q1 + 4 <= lim;
  }

  // the first `need` bytes of bytes [a, a + 4) (aligned coordinates) as a
  // little-endian word, the rest 0; the second aligned word is loaded only
  // when a byte of it is needed
  __device__ __forceinline__ uint32_t window(int64_t a, int64_t need) const {
    if (need <= 0) return 0u;
    const int64_t q = a >> 2;  // floor division: a may be negative
    const int sh = (int)(a & 3);
    const uint32_t lo = word(q);
    const uint32_t hi = sh != 0 && need > 4 - sh ? word(q + 1) : 0u;
    return keep(funnel(lo, hi, sh), need);
  }
};

}  // namespace bytes
