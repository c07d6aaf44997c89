// String kernels of the JCUDF row transcode.
//
// rotl_take (B8): u32 [N, L] rows, each rotated left by sh[r] bytes
//   (0 <= sh < 4L), first Lo words kept -> u32 [N, Lo].
//   Replaces spark_rapids_jni_tpu/ops/ragged_bytes.py rotl_take / rotl_take32
//   (Pallas body _rotl_take_kernel: a log2(W) ladder of conditional lane
//   rolls). Here output word j of row r is the funnel of input words
//   (j + sh/4) % L and the next one, shifted by 8 * (sh % 4).
// var_accumulate (B9): u32 [N, Lo] = OR over k of the zero-filled byte
//   shift-right of matrix k (u32 [N, L_k]) by s_k[r] bytes.
//   Replaces ragged_bytes.py var_accumulate (Pallas body _vacc_kernel).
//   The K matrices come as a device table of pointers, so nothing is
//   packed or copied; each output word reads at most two words of each.
// asm_epilogue (B10): per destination tile t (G bytes, g4 = G/4 words),
//   byte i < alen[t] is byte i of (a0 || a1) rotated left by pmod[t], the
//   rest byte i of c0 shifted right by delta[t] (zero fill).
//   Replaces ragged_bytes.py _asm_epilogue (Pallas body _asm_kernel).
// ragged_compact (B5): out[offs[r] + j] = pool[base[r] + j] for
//   j < offs[r+1] - offs[r], dense offs.
//   Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py pallas_ragged_compact
//   (Pallas body _pd_kernel, which resolves each output word's owner row by
//   a dense masked max over a VMEM row window).
//
// Bound on an H100: device-memory bytes for all four; none does arithmetic
// worth counting.
//
// Design. B8, B9 and B10 give one thread each output word. A block owns a
// run of whole rows (rows_per_block * words_per_row <= about 2048 words),
// so the row and word of a thread come from a 32-bit division by the row
// width, and neighbouring threads write neighbouring words. Shifts are read
// once per word from the per-row arrays (they stay in L1). A sub-word shift
// of 0 takes the word as it is: a 32-bit shift by 32 is undefined in C++.
//
// B5 gives one thread each output word too, and finds the owner of the
// word's first byte by binary search over offs; the next (at most three)
// bytes advance the owner linearly, skipping zero-length rows. This was
// chosen over a warp per row (the reference's copy_strings_from_rows,
// row_conversion.cu:1141) because the main path's strings are 1-32 bytes:
// a warp per row would leave most lanes idle, while a thread per word
// keeps every store a coalesced whole word and handles several short rows
// sharing one word with no cross-thread merge. The pool is read byte by
// byte from the u8 blob itself, and a read past the blob's end yields 0,
// so no padded word view of the blob is built. All index math is 64-bit:
// addresses are < 2^31, products with row widths are not.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kWordsPerBlock = 2048;

// bytes [s, s+4) of a row of L words as one word, zero outside the row;
// s may be negative
__device__ __forceinline__ uint32_t window_word(const uint32_t* row, int64_t L, int64_t s) {
  const int64_t q = s >> 2;  // floor division
  const int b = (int)(s & 3) * 8;
  const uint32_t lo = (q >= 0 && q < L) ? row[q] : 0u;
  if (b == 0) return lo;
  const uint32_t hi = (q + 1 >= 0 && q + 1 < L) ? row[q + 1] : 0u;
  return (lo >> b) | (hi << (32 - b));
}

// word j of row r, for every word of a block's run of rows
template <typename F>
__device__ __forceinline__ void for_each_word(int64_t n, int64_t width, int64_t rows_per_block,
                                              F f) {
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t rows = n - r0 < rows_per_block ? n - r0 : rows_per_block;
  const uint32_t w = (uint32_t)width;
  const uint32_t count = (uint32_t)(rows * width);
  for (uint32_t e = threadIdx.x; e < count; e += blockDim.x) {
    const uint32_t rl = e / w;
    f(r0 + rl, (int64_t)(e - rl * w));
  }
}

__global__ void rotl_take_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ sh,
                                 uint32_t* __restrict__ out, int64_t n, int64_t L, int64_t Lo,
                                 int64_t rows_per_block) {
  for_each_word(n, Lo, rows_per_block, [&](int64_t r, int64_t j) {
    const int64_t s = sh[r];
    const int64_t q = (s >> 2) % L;
    const int b = (int)(s & 3) * 8;
    const uint32_t* row = x + r * L;
    int64_t m0 = j + q;
    if (m0 >= L) m0 -= L;
    int64_t m1 = m0 + 1;
    if (m1 >= L) m1 -= L;
    const uint32_t w0 = row[m0];
    out[r * Lo + j] = b == 0 ? w0 : (w0 >> b) | (row[m1] << (32 - b));
  });
}

// table: K matrix pointers, then K shift pointers, then K row widths (words)
__global__ void var_accumulate_kernel(const int64_t* __restrict__ table, int64_t K,
                                      uint32_t* __restrict__ out, int64_t n, int64_t Lo,
                                      int64_t rows_per_block) {
  for_each_word(n, Lo, rows_per_block, [&](int64_t r, int64_t w) {
    uint32_t acc = 0;
    for (int64_t k = 0; k < K; ++k) {
      const uint32_t* mat = reinterpret_cast<const uint32_t*>(table[k]);
      const int32_t* shifts = reinterpret_cast<const int32_t*>(table[K + k]);
      const int64_t L = table[2 * K + k];
      // output byte 4w + i is byte 4w + i - s of the row (zero outside it);
      // shifts of the row's width or more leave nothing
      const int64_t t = 4 * w - (int64_t)shifts[r];
      if (t + 4 <= 0 || t >= 4 * L) continue;
      acc |= window_word(mat + r * L, L, t);
    }
    out[r * Lo + w] = acc;
  });
}

__global__ void asm_epilogue_kernel(const uint32_t* __restrict__ a0, const uint32_t* __restrict__ a1,
                                    const uint32_t* __restrict__ c0, const int32_t* __restrict__ pmod,
                                    const int32_t* __restrict__ delta,
                                    const int32_t* __restrict__ alen, uint32_t* __restrict__ out,
                                    int64_t T, int64_t g4, int64_t rows_per_block) {
  for_each_word(T, g4, rows_per_block, [&](int64_t t, int64_t j) {
    const int64_t L2 = 2 * g4;
    const int64_t pm = pmod[t];
    const int64_t q = (pm >> 2) % L2;
    const int b = (int)(pm & 3) * 8;
    int64_t m0 = j + q;
    if (m0 >= L2) m0 -= L2;
    int64_t m1 = m0 + 1;
    if (m1 >= L2) m1 -= L2;
    const uint32_t w0 = m0 < g4 ? a0[t * g4 + m0] : a1[t * g4 + m0 - g4];
    uint32_t ra = w0;
    if (b != 0) {
      const uint32_t w1 = m1 < g4 ? a0[t * g4 + m1] : a1[t * g4 + m1 - g4];
      ra = (w0 >> b) | (w1 << (32 - b));
    }
    const uint32_t rc = window_word(c0 + t * g4, g4, 4 * j - (int64_t)delta[t]);
    // bytes of this word below alen come from the in-row window
    int64_t na = (int64_t)alen[t] - 4 * j;
    na = na < 0 ? 0 : (na > 4 ? 4 : na);
    const uint32_t mask = na >= 4 ? 0xFFFFFFFFu : ((1u << (8 * na)) - 1u);
    out[t * g4 + j] = (ra & mask) | (rc & ~mask);
  });
}

__global__ void ragged_compact_kernel(const uint8_t* __restrict__ pool, int64_t plen,
                                      const int64_t* __restrict__ base,
                                      const int64_t* __restrict__ offs, int64_t n, int64_t total,
                                      uint32_t* __restrict__ out, int64_t nwords) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; w < nwords; w += stride) {
    const int64_t b0 = 4 * w;
    // owner of byte b0: the last row r with offs[r] <= b0 (offs[0] == 0)
    int64_t lo = 0, hi = n - 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi + 1) >> 1;
      if (offs[mid] <= b0) lo = mid; else hi = mid - 1;
    }
    int64_t r = lo;
    uint32_t word = 0;
    for (int i = 0; i < 4; ++i) {
      const int64_t b = b0 + i;
      if (b >= total) break;
      while (offs[r + 1] <= b) ++r;  // skips zero-length rows; offs[n] == total > b
      const int64_t addr = base[r] + (b - offs[r]);
      const uint32_t byte = (addr >= 0 && addr < plen) ? pool[addr] : 0u;
      word |= byte << (8 * i);
    }
    out[w] = word;
  }
}

int64_t rows_per_block(int64_t width) { return std::max<int64_t>(1, kWordsPerBlock / width); }

unsigned row_blocks(int64_t n, int64_t rpb) { return (unsigned)((n + rpb - 1) / rpb); }

}  // namespace

extern "C" int rotl_take_launch(const void* x, const void* sh, void* out, int64_t n, int64_t L,
                                int64_t Lo, void* stream) {
  if (n > 0 && Lo > 0) {
    const int64_t rpb = rows_per_block(Lo);
    rotl_take_kernel<<<row_blocks(n, rpb), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(x), static_cast<const int32_t*>(sh),
        static_cast<uint32_t*>(out), n, L, Lo, rpb);
  }
  return (int)cudaGetLastError();
}

extern "C" int var_accumulate_launch(const void* table, int64_t K, void* out, int64_t n,
                                     int64_t Lo, void* stream) {
  if (n > 0 && Lo > 0) {
    const int64_t rpb = rows_per_block(Lo);
    var_accumulate_kernel<<<row_blocks(n, rpb), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const int64_t*>(table), K, static_cast<uint32_t*>(out), n, Lo, rpb);
  }
  return (int)cudaGetLastError();
}

extern "C" int asm_epilogue_launch(const void* a0, const void* a1, const void* c0,
                                   const void* pmod, const void* delta, const void* alen,
                                   void* out, int64_t T, int64_t g4, void* stream) {
  if (T > 0 && g4 > 0) {
    const int64_t rpb = rows_per_block(g4);
    asm_epilogue_kernel<<<row_blocks(T, rpb), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(a0), static_cast<const uint32_t*>(a1),
        static_cast<const uint32_t*>(c0), static_cast<const int32_t*>(pmod),
        static_cast<const int32_t*>(delta), static_cast<const int32_t*>(alen),
        static_cast<uint32_t*>(out), T, g4, rpb);
  }
  return (int)cudaGetLastError();
}

extern "C" int ragged_compact_launch(const void* pool, int64_t plen, const void* base,
                                     const void* offs, int64_t n, int64_t total, void* out,
                                     int64_t nwords, int64_t max_blocks, void* stream) {
  if (n > 0 && nwords > 0) {
    const int64_t blocks = std::min<int64_t>((nwords + kThreads - 1) / kThreads, max_blocks);
    ragged_compact_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(pool), plen, static_cast<const int64_t*>(base),
        static_cast<const int64_t*>(offs), n, total, static_cast<uint32_t*>(out), nwords);
  }
  return (int)cudaGetLastError();
}
