// Paged hash-join probe (B4).
//
// For each probe row i with order word u (the key's bits, sign bit
// flipped for a signed key, so an unsigned compare gives the key order):
//   b   = bucket of u (fmix(u), or fmix(lo ^ fmix(hi)) for a 64-bit word,
//         masked to B - 1),
//   lo  = slot_start[b] + #(bucket b's slots < u),
//   eq  = #(bucket b's slots == u).
// A null row visits no slots: lo = slot_start[b] of its data's bucket,
// eq = 0. The table comes from ops/paged_join.build_paged_table: bucket
// b's slots are slots[page_first[b] * 128 .. + counts[b]), sorted by
// (key, build row), and meta[b] packs page_first << 44 | chain_len << 24
// | slot_start.
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py pallas_probe_paged
// (_probe_impl, Pallas body _probe_kernel). That kernel gathers each
// chain page with one-hot bf16 matrix products of u8 limbs and compares
// limb by limb, because the TPU has no gather; none of that is carried
// over.
//
// Design: one thread a probe row, in a grid-stride loop. Its bucket's
// occupied slots are sorted, so a lower-bound and an upper-bound binary
// search give lt and eq: at ~64 slots a bucket, ~7 dependent loads each,
// whatever the chain length (the skewed case, 2,000 equal keys in one
// bucket over 16 pages, takes 11). A warp a row scanning 128-slot pages
// with __ballot_sync / __popc computes the same function, but spends 32
// threads on a row where the search needs one, and its cost grows with
// the chain. The whole table (at most 2,048 pages x 128 x 8 B = 2 MiB)
// and meta stay in the 50 MB L2, so the searches' loads hit L2.
//
// Bound on an H100: device-memory bytes, the probe key (4 or 8 B) and
// validity (1 B) in and 8 B of (lo, eq) out a row; the table is read
// once from memory and then from L2.

#include <cuda_runtime.h>

#include <cstdint>

#include "murmur.cuh"

namespace {

__device__ __forceinline__ uint32_t bucket_of(uint32_t u, uint32_t mask) {
  return murmur::fmix(u) & mask;
}

__device__ __forceinline__ uint32_t bucket_of(uint64_t u, uint32_t mask) {
  return murmur::fmix((uint32_t)u ^ murmur::fmix((uint32_t)(u >> 32))) & mask;
}

template <typename W>
__global__ void probe_paged_kernel(const W* __restrict__ words, W flip,
                                   const uint8_t* __restrict__ valid,
                                   const W* __restrict__ slots,
                                   const int32_t* __restrict__ counts,
                                   const int64_t* __restrict__ meta, uint32_t mask, int64_t n,
                                   int32_t* __restrict__ lo, int32_t* __restrict__ eq) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const W u = words[i] ^ flip;
    const uint32_t b = bucket_of(u, mask);
    const int64_t m = meta[b];
    int32_t below = 0, equal = 0;
    if (valid == nullptr || valid[i] != 0) {
      const W* s = slots + (m >> 44) * 128;
      const int32_t c = counts[b];
      int32_t a = 0, z = c;  // lower bound: first slot >= u
      while (a < z) {
        const int32_t mid = (a + z) >> 1;
        if (s[mid] < u) a = mid + 1; else z = mid;
      }
      below = a;
      z = c;  // upper bound: first slot > u
      while (a < z) {
        const int32_t mid = (a + z) >> 1;
        if (s[mid] <= u) a = mid + 1; else z = mid;
      }
      equal = a - below;
    }
    lo[i] = (int32_t)(m & 0xFFFFFF) + below;
    eq[i] = equal;
  }
}

constexpr int kThreads = 256;

}  // namespace

// words [n] raw key bits of word_bytes (4 or 8); flip != 0 flips the sign
// bit into the order word (signed keys); valid [n] bytes or null; slots
// [n_pages * 128] order words of the same width; counts [B] int32; meta
// [B] int64; B a power of two; lo, eq [n] int32; grid blocks of 256.
extern "C" int probe_paged_launch(const void* words, int64_t word_bytes, int64_t flip,
                                  const void* valid, const void* slots, const void* counts,
                                  const void* meta, int64_t num_buckets, int64_t n, void* lo,
                                  void* eq, int64_t grid, void* stream) {
  if (word_bytes != 4 && word_bytes != 8) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const auto* v = static_cast<const uint8_t*>(valid);
    const auto* c = static_cast<const int32_t*>(counts);
    const auto* m = static_cast<const int64_t*>(meta);
    auto* l = static_cast<int32_t*>(lo);
    auto* e = static_cast<int32_t*>(eq);
    const uint32_t mask = (uint32_t)(num_buckets - 1);
    const cudaStream_t st = (cudaStream_t)stream;
    if (word_bytes == 8) {
      const uint64_t f = flip ? (1ull << 63) : 0ull;
      probe_paged_kernel<uint64_t><<<(unsigned)grid, kThreads, 0, st>>>(
          static_cast<const uint64_t*>(words), f, v, static_cast<const uint64_t*>(slots), c, m,
          mask, n, l, e);
    } else {
      const uint32_t f = flip ? (1u << 31) : 0u;
      probe_paged_kernel<uint32_t><<<(unsigned)grid, kThreads, 0, st>>>(
          static_cast<const uint32_t*>(words), f, v, static_cast<const uint32_t*>(slots), c, m,
          mask, n, l, e);
    }
  }
  return (int)cudaGetLastError();
}
