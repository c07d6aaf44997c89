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
// | slot_start. Its fences: bucket b's slot j S is fences[fence_first[b]
// + j]; the build gives every S-th slot, slots[::S], and fence_first[b] =
// page_first[b] * 128 / S, with S = 8 for int32 words and 4, 8 or 16 for
// int64 words (paged_join.fence_stride).
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py pallas_probe_paged
// (_probe_impl, Pallas body _probe_kernel). That kernel gathers each
// chain page with one-hot bf16 matrix products of u8 limbs and compares
// limb by limb, because the TPU has no gather; none of that is carried
// over.
//
// Bound on an H100: device-memory bytes, the probe key (4 or 8 B) and
// validity (1 B) in and 8 B of (lo, eq) out a row; the table is read
// once from memory and then from L2.
//
// Design, probe_fenced_kernel: a persistent grid (as many blocks of
// kProbeThreads as the shared table lets stay resident, at most
// kProbeBlocksPerSM a SM). Each block first copies the fences into shared
// memory with asynchronous 16-byte copies (cp.async) and packs each
// bucket's count, first page and first rank into one 8-byte word there,
// beside its first fence (12 B a bucket and 1/S of the slots: 76 KB for
// the join path's 1,024 buckets and pages of int32 words at S = 8, so two
// blocks stay resident a SM; at most 152 KB, 2,048 buckets and pages of
// int64 words at S = 16); while the copies fly, each thread loads its
// first probe row. Then it strides over the probe rows, loading the next
// row's key while it works on this one. A row finds its bucket's word and
// fences in shared memory, binary-searches the fences for the first one
// >= u, loads the S slots of the segment before it, which holds the lower
// bound (32 B, one sector, for int32 words at S = 8), and counts the
// slots < and <= u in registers. Only when that fence equals u can the
// run of equal keys go on past the segment (in the skewed case, 2,000
// equal keys over 16 pages, 250 fences on); then a second search finds
// the first fence > u and the upper bound's segment is loaded too. Where
// the first port's binary searches made 13-14 dependent loads through
// L1/L2 a row, this makes one (two when a fence equals u) after the key.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "murmur.cuh"

namespace {

constexpr int kProbeThreads = 1024;
constexpr int kProbeBlocksPerSM = 2;
constexpr int kPageSlots = 128;
constexpr int64_t kMaxPages = 4096;  // counts and ranks (<= 128 a page) fit 20 bits
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t bucket_of(uint32_t u, uint32_t mask) {
  return murmur::fmix(u) & mask;
}

__device__ __forceinline__ uint32_t bucket_of(uint64_t u, uint32_t mask) {
  return murmur::fmix((uint32_t)u ^ murmur::fmix((uint32_t)(u >> 32))) & mask;
}

// S order words of one segment, held as the 16-byte vectors they were
// loaded as
template <typename W, int S>
struct Segment {
  static constexpr int kPer = 16 / (int)sizeof(W);  // words a vector
  uint4 v[S / kPer];
};

template <typename W, int S>
__device__ __forceinline__ void load_segment(Segment<W, S>& seg, const W* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < S / Segment<W, S>::kPer; ++i) seg.v[i] = __ldg(q + i);
}

// word q of a vector (q a constant once the callers' loops unroll)
__device__ __forceinline__ uint32_t word_of(const uint4& v, int q, uint32_t) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint64_t word_of(const uint4& v, int q, uint64_t) {
  return q == 0 ? ((uint64_t)v.y << 32 | v.x) : ((uint64_t)v.w << 32 | v.z);
}

// #(words [0, c) of the segment < u) with kLess, #(<= u) without (the
// words from c on may hold another bucket's slots or zeros)
template <typename W, int S, bool kLess>
__device__ __forceinline__ int32_t count_below(const Segment<W, S>& seg, int32_t c, W u) {
  constexpr int kPer = Segment<W, S>::kPer;
  int32_t r = 0;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const W w = word_of(seg.v[q / kPer], q % kPer, W{});
    r += (q < c) & (kLess ? w < u : w <= u);
  }
  return r;
}

// first index in f[a, z) whose fence is >= u (kLess) or > u (!kLess)
template <typename W, bool kLess>
__device__ __forceinline__ int32_t fence_search(const W* f, int32_t a, int32_t z, W u) {
  while (a < z) {
    const int32_t mid = (a + z) >> 1;
    if (kLess ? f[mid] < u : f[mid] <= u) a = mid + 1; else z = mid;
  }
  return a;
}

// a bucket's count, first page and first rank in one word:
// count << 44 | page_first << 24 | slot_start (count and page_first <
// 2^20 within kMaxPages; slot_start meta's 24 bits)
__device__ __forceinline__ uint64_t bucket_word(int64_t meta, int32_t count) {
  return (uint64_t)count << 44 | (uint64_t)(meta >> 44) << 24 | (uint64_t)(meta & 0xFFFFFF);
}

template <typename W, int S>
__global__ void __launch_bounds__(kProbeThreads)
    probe_fenced_kernel(const W* __restrict__ words, W flip, const uint8_t* __restrict__ valid,
                        const W* __restrict__ slots, const W* __restrict__ fences,
                        const int32_t* __restrict__ fence_first,
                        const int32_t* __restrict__ counts, const int64_t* __restrict__ meta,
                        int32_t nb, int32_t nf, int64_t n, int32_t* __restrict__ lo,
                        int32_t* __restrict__ eq) {
  extern __shared__ uint4 smem[];
  uint64_t* s_bucket = reinterpret_cast<uint64_t*>(smem);
  int32_t* s_first = reinterpret_cast<int32_t*>(s_bucket + nb);
  W* s_fence = reinterpret_cast<W*>(s_first + nb);
  {  // the fences, 16 B a copy (the wrapper pads them to whole vectors;
     // nb >= 16 keeps s_fence on a 16-byte boundary)
    const int32_t f16 = nf * (int32_t)sizeof(W) / 16;
    const uint4* gf = reinterpret_cast<const uint4*>(fences);
    uint4* sf = reinterpret_cast<uint4*>(s_fence);
    for (int32_t i = threadIdx.x; i < f16; i += blockDim.x) __pipeline_memcpy_async(sf + i, gf + i, 16);
    __pipeline_commit();
    for (int32_t b = threadIdx.x; b < nb; b += blockDim.x) {
      s_bucket[b] = bucket_word(__ldg(meta + b), __ldg(counts + b));
      s_first[b] = __ldg(fence_first + b);
    }
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  W next = 0;
  bool next_live = false;
  if (i < n) {
    next = words[i] ^ flip;
    next_live = valid == nullptr || valid[i] != 0;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  const uint32_t mask = (uint32_t)(nb - 1);
  for (; i < n; i += stride) {
    const W u = next;
    const bool live = next_live;
    if (i + stride < n) {
      next = words[i + stride] ^ flip;
      next_live = valid == nullptr || valid[i + stride] != 0;
    }
    const uint32_t b = bucket_of(u, mask);
    const uint64_t bw = s_bucket[b];
    const int32_t start = (int32_t)(bw & 0xFFFFFF);
    const int32_t c = live ? (int32_t)(bw >> 44) : 0;  // a null row visits no slots
    const W* f = s_fence + s_first[b];
    const W* seg0 = slots + ((int64_t)(bw >> 24) & 0xFFFFF) * kPageSlots;  // the bucket's slot 0
    const int32_t nfb = (c + S - 1) / S;
    // segment j holds slots [j S, j S + S): the lower bound lies in the
    // segment before the first fence >= u, the upper in the one before
    // the first fence > u, further on only where fence j equals u
    const int32_t j = fence_search<W, true>(f, 0, nfb, u);
    const int32_t k = j < nfb && f[j] == u ? fence_search<W, false>(f, j + 1, nfb, u) : j;
    int32_t below = 0, upto = 0;
    if (j > 0) {
      Segment<W, S> seg;
      load_segment(seg, seg0 + (j - 1) * S);
      const int32_t rest = c - (j - 1) * S;
      below = (j - 1) * S + count_below<W, S, true>(seg, rest, u);
      if (k == j) upto = (j - 1) * S + count_below<W, S, false>(seg, rest, u);
    }
    if (k > j) {
      Segment<W, S> seg;
      load_segment(seg, seg0 + (k - 1) * S);
      upto = (k - 1) * S + count_below<W, S, false>(seg, c - (k - 1) * S, u);
    }
    lo[i] = start + below;
    eq[i] = upto - below;
  }
}

// blocks a SM of probe_fenced_kernel<W, S> at smem bytes, and the SM
// count, asked once a process and a device and kept until another table
// size comes (one entry a kernel: smem << 32 | blocks)
std::atomic<unsigned long long> g_probe_occ[4][kMaxDevices];
std::atomic<int> g_sms[kMaxDevices];

template <typename W, int S>
cudaError_t probe_grid(int64_t n, size_t smem, int slot, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms <= 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  std::atomic<unsigned long long>& occ = g_probe_occ[slot][dev];
  unsigned long long got = occ.load(std::memory_order_relaxed);
  int per_sm = (int)(got & 0xFFFFFFFFull);
  if ((got >> 32) != smem || per_sm <= 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)optin) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(probe_fenced_kernel<W, S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_fenced_kernel<W, S>,
                                                        kProbeThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    per_sm = std::min(per_sm, kProbeBlocksPerSM);
    occ.store((unsigned long long)smem << 32 | (unsigned)per_sm, std::memory_order_relaxed);
  }
  *grid = (int)std::min<int64_t>((n + kProbeThreads - 1) / kProbeThreads, (int64_t)sms * per_sm);
  return cudaSuccess;
}

template <typename W, int S>
cudaError_t launch_probe(const void* words, W flip, const uint8_t* valid, const void* slots,
                         const void* fences, const void* fence_first, const void* counts,
                         const void* meta, int32_t nb, int32_t nf, int64_t n, void* lo, void* eq,
                         int slot, cudaStream_t st) {
  const size_t smem = (size_t)nb * 12 + (size_t)nf * sizeof(W);
  int grid = 0;
  const cudaError_t err = probe_grid<W, S>(n, smem, slot, &grid);
  if (err != cudaSuccess) return err;
  probe_fenced_kernel<W, S><<<(unsigned)grid, kProbeThreads, smem, st>>>(
      static_cast<const W*>(words), flip, valid, static_cast<const W*>(slots),
      static_cast<const W*>(fences), static_cast<const int32_t*>(fence_first),
      static_cast<const int32_t*>(counts), static_cast<const int64_t*>(meta), nb, nf, n,
      static_cast<int32_t*>(lo), static_cast<int32_t*>(eq));
  return cudaSuccess;
}

// the strides paged_join.fence_stride gives: 8 for int32 words (a
// sector), 4, 8 or 16 for int64 words; one occupancy-cache slot each
cudaError_t launch_width(const void* words, int64_t word_bytes, int64_t flip, const uint8_t* valid,
                         const void* slots, const void* fences, int64_t stride,
                         const void* fence_first, const void* counts, const void* meta, int32_t nb,
                         int32_t nf, int64_t n, void* lo, void* eq, cudaStream_t st) {
  if (word_bytes == 4)
    return launch_probe<uint32_t, 8>(words, flip ? 1u << 31 : 0u, valid, slots, fences,
                                     fence_first, counts, meta, nb, nf, n, lo, eq, 0, st);
  const uint64_t f = flip ? 1ull << 63 : 0ull;
  if (stride == 4)
    return launch_probe<uint64_t, 4>(words, f, valid, slots, fences, fence_first, counts, meta, nb,
                                     nf, n, lo, eq, 1, st);
  if (stride == 8)
    return launch_probe<uint64_t, 8>(words, f, valid, slots, fences, fence_first, counts, meta, nb,
                                     nf, n, lo, eq, 2, st);
  return launch_probe<uint64_t, 16>(words, f, valid, slots, fences, fence_first, counts, meta, nb,
                                    nf, n, lo, eq, 3, st);
}

}  // namespace

// words [n] raw key bits of word_bytes (4 or 8); flip != 0 flips the sign
// bit into the order word (signed keys); valid [n] bytes or null; slots
// [n_pages * 128] order words of the same width, 16-byte aligned; fences
// [nf] order words, bucket b's slot j * stride at fences[fence_first[b]
// + j] (stride 8 for 4-byte words, 4, 8 or 16 for 8-byte words), 16-byte
// aligned, nf * word_bytes a multiple of 16; fence_first, counts [B]
// int32 and meta [B] int64, B a power of two >= 16; n_pages <= 4096; lo,
// eq [n] int32. Anything else, and a table whose metadata and fences do
// not fit a block's shared memory, is refused (cudaErrorInvalidValue).
extern "C" int probe_paged_launch(const void* words, int64_t word_bytes, int64_t flip,
                                  const void* valid, const void* slots, const void* fences,
                                  int64_t nf, int64_t stride, const void* fence_first,
                                  const void* counts, const void* meta, int64_t num_buckets,
                                  int64_t n_pages, int64_t n, void* lo, void* eq, void* stream) {
  const bool stride_ok =
      word_bytes == 4 ? stride == 8 : stride == 4 || stride == 8 || stride == 16;
  if ((word_bytes != 4 && word_bytes != 8) || !stride_ok || num_buckets < 16 ||
      (num_buckets & (num_buckets - 1)) != 0 || num_buckets > (1 << 20) || n_pages < 1 ||
      n_pages > kMaxPages || nf < 1 || nf * word_bytes % 16 != 0 || nf > (1 << 24) ||
      ((uintptr_t)slots | (uintptr_t)fences) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const cudaError_t err = launch_width(
        words, word_bytes, flip, static_cast<const uint8_t*>(valid), slots, fences, stride,
        fence_first, counts, meta, (int32_t)num_buckets, (int32_t)nf, n, lo, eq,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
