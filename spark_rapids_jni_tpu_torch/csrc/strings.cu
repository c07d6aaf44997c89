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
//   Replaces ragged_bytes.py var_accumulate (Pallas body _vacc_kernel:
//   the K matrices packed into one lane-padded operand, then per column a
//   log2(W) ladder of conditional lane shifts OR-ed into the output
//   block). The design is below the general one.
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
// Design. B8 and B10 give one thread each output word. A block owns a
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
//
// B9 is a scatter, not a gather. A thread an output word that walks all
// K matrices (the first design) runs about 1,800 loop iterations a row
// at the string path's shape (K = 16, Lo = 112) for about 140 words that
// land, and reached a tenth of the byte bound on an NVIDIA H100 80GB HBM3
// at 700.00 W. Here a block owns a
// tile of the output in shared memory: tile_rows whole rows, or, where
// one row is wider than the tile budget, one row's range of tile_words
// words (the wrapper's vacc_tile_plan picks both). The block zeroes the
// tile and cuts each matrix's slab (the tile's rows, contiguous in device
// memory; for a word range, only the source words that can land in it)
// into items of kVaccGroup words of one row. A thread issues the loads of
// kVaccItems items (16-byte loads where the address allows, 4-byte loads
// otherwise) and the items' shifts before it uses any, to keep bytes in
// flight; then it funnels each item: output word q0 + t of the row, where
// q0 = (4 j + s_k[r]) / 4 for the item's first word j, takes word t
// shifted up by the sub-word bits and what word t - 1 spills, one
// shared-memory atomicOr each (zero words and words outside the tile
// drop, so shifts >= maxvar leave nothing). After a barrier the tile goes
// out with coalesced stores. Device traffic is then what the bound
// counts: each source word and shift read once, each output word written
// once. OR is order-free, so any shifts are right: overlapping windows,
// shifts that fall across k. Up to kVaccByValue matrices travel in the
// kernel's arguments (a __grid_constant__ table, no per-call copy);
// above that the wrapper passes a device table of the same layout, and
// the block takes kVaccPass matrices a pass.

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

// one matrix of B9: [n, L] words and its [n] byte shifts
struct VaccMat {
  const uint32_t* mat;
  const int32_t* shifts;
  int64_t L;
};
constexpr int kVaccByValue = 32;  // matrices passed in the kernel's arguments
struct VaccTable {
  VaccMat m[kVaccByValue];
};
constexpr int kVaccThreads = 128;
constexpr int64_t kVaccMaxSmem = 48 * 1024;  // no opt-in attribute below this
constexpr int kVaccGroup = 8;  // source words an item funnels (two 16-byte loads)
constexpr int kVaccItems = 4;  // items a thread loads before it funnels them
constexpr int kVaccPass = 32;  // matrices whose items one pass spreads over the block

// one matrix's source window in a block's tile: words [j0, j0 + words) of
// each of the tile's rows, as rows x groups items of kVaccGroup words
struct VaccWin {
  const uint32_t* src;  // word j0 of row r0
  const int32_t* sh;    // the shift of row r0
  int64_t L;            // words a source row
  int64_t j0, words;
  uint32_t groups;
  uint32_t first;  // the pass's items before this matrix's
};

// grid: one block a tile, either tile_rows rows x all Lo words or, with
// tile_rows == 1, one row's words [c0, c0 + tile_words); the tile is
// tile_rows x tile_words words of shared memory, rounded up to whole
// 16-byte chunks
__global__ void __launch_bounds__(kVaccThreads)
    var_accumulate_tile_kernel(const __grid_constant__ VaccTable by_value,
                               const VaccMat* __restrict__ table, int64_t K,
                               uint32_t* __restrict__ out, int64_t n, int64_t Lo,
                               int64_t tile_rows, int64_t tile_words) {
  extern __shared__ __align__(16) uint32_t tile[];
  __shared__ VaccWin win[kVaccPass + 1];
  const VaccMat* mats = table != nullptr ? table : by_value.m;
  const int64_t col_tiles = (Lo + tile_words - 1) / tile_words;
  const int64_t r0 = (int64_t)(blockIdx.x / col_tiles) * tile_rows;
  const int64_t c0 = (int64_t)(blockIdx.x % col_tiles) * tile_words;
  const int64_t rows = tile_rows < n - r0 ? tile_rows : n - r0;
  const int64_t cw = tile_words < Lo - c0 ? tile_words : Lo - c0;
  const int64_t chunks = (rows * tile_words + 3) / 4;
  for (int64_t i = threadIdx.x; i < chunks; i += blockDim.x)
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0u, 0u, 0u, 0u);

  for (int64_t k0 = 0; k0 < K; k0 += kVaccPass) {
    const int np = K - k0 < kVaccPass ? (int)(K - k0) : kVaccPass;
    __syncthreads();  // the tile is zero; the last pass is done with win
    if (threadIdx.x < np) {
      const VaccMat m = mats[k0 + threadIdx.x];
      VaccWin v;
      v.L = m.L;
      v.sh = m.shifts + r0;
      v.j0 = 0;
      v.words = m.L;
      if (col_tiles > 1 && m.L > 0) {  // one row: the words that land in [4 c0, 4 (c0 + cw))
        const int64_t s = m.shifts[r0];
        const int64_t lo = 4 * c0 - s, hi = 4 * (c0 + cw) - s;
        v.j0 = lo <= 0 ? 0 : lo >> 2;
        const int64_t j1 = hi <= 0 ? 0 : ((hi + 3) >> 2 < m.L ? (hi + 3) >> 2 : m.L);
        v.words = j1 > v.j0 ? j1 - v.j0 : 0;
      }
      v.src = m.mat + r0 * m.L + v.j0;
      v.groups = (uint32_t)((v.words + kVaccGroup - 1) / kVaccGroup);
      win[threadIdx.x] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t first = 0;
      for (int b = 0; b < np; ++b) {
        win[b].first = first;
        first += (uint32_t)rows * win[b].groups;
      }
      win[np].first = first;
    }
    __syncthreads();

    const uint32_t total = win[np].first;
    int m = 0;  // the matrix of a thread's item; its items only rise
    for (uint32_t base = threadIdx.x; base < total; base += kVaccItems * blockDim.x) {
      uint32_t w[kVaccItems][kVaccGroup];
      int64_t d0[kVaccItems];  // the byte of the output row where the item's word 0 lands
      uint32_t* trow[kVaccItems];
      bool live[kVaccItems];
#pragma unroll
      for (int it = 0; it < kVaccItems; ++it) {
        const uint32_t i = base + it * blockDim.x;
        live[it] = i < total;
        if (!live[it]) continue;
        while (win[m + 1].first <= i) ++m;
        const VaccWin& v = win[m];
        const uint32_t local = i - v.first, rl = local / v.groups, g = local - rl * v.groups;
        const int64_t jj = (int64_t)g * kVaccGroup;
        const int64_t cnt = v.words - jj;  // > 0; the item's words are min(cnt, kVaccGroup)
        const uint32_t* p = v.src + rl * v.L + jj;
        d0[it] = 4 * (v.j0 + jj) + (int64_t)v.sh[rl];
        trow[it] = tile + rl * tile_words;
        if (cnt >= kVaccGroup && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
          const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
          const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
          w[it][0] = a.x, w[it][1] = a.y, w[it][2] = a.z, w[it][3] = a.w;
          w[it][4] = b.x, w[it][5] = b.y, w[it][6] = b.z, w[it][7] = b.w;
        } else {
#pragma unroll
          for (int t = 0; t < kVaccGroup; ++t) w[it][t] = t < cnt ? __ldg(p + t) : 0u;
        }
      }
#pragma unroll
      for (int it = 0; it < kVaccItems; ++it) {
        if (!live[it]) continue;
        // output word q0 + t takes word t shifted up by b bits and what
        // word t - 1 spills; words outside the tile's range drop
        const int64_t q0 = (d0[it] >> 2) - c0;
        const int b = (int)(d0[it] & 3) * 8;
        uint32_t prev = 0u;
#pragma unroll
        for (int t = 0; t <= kVaccGroup; ++t) {
          const uint32_t cur = t < kVaccGroup ? w[it][t] : 0u;
          const uint32_t val = b == 0 ? cur : (cur << b) | (prev >> (32 - b));
          const int64_t q = q0 + t;
          if (val != 0u && q >= 0 && q < cw) atomicOr(trow[it] + q, val);
          prev = cur;
        }
      }
    }
  }
  __syncthreads();

  // the tile's rows are contiguous in the output when it holds whole rows
  uint32_t* dst = out + r0 * Lo + c0;
  const int64_t span = col_tiles == 1 ? rows * Lo : cw;
  if ((span & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int64_t i = threadIdx.x; i < span / 4; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(tile)[i];
  } else {
    for (int64_t i = threadIdx.x; i < span; i += blockDim.x) dst[i] = tile[i];
  }
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

// B9: host_table holds K VaccMat entries (matrix, shifts, L in words).
// With dev_table null they travel in the kernel's arguments (K <=
// kVaccByValue); otherwise dev_table is the same table on the device. out
// [n, Lo] needs no initial value. tile_rows and tile_words as the
// wrapper's vacc_tile_plan gives them (tile_rows == 1 where tile_words <
// Lo).
extern "C" int var_accumulate_launch(const void* host_table, const void* dev_table, int64_t K,
                                     void* out, int64_t n, int64_t Lo, int64_t tile_rows,
                                     int64_t tile_words, void* stream) {
  if (n > 0 && Lo > 0) {
    if (K < 1 || tile_rows < 1 || tile_words < 1 || (tile_words < Lo && tile_rows != 1) ||
        (K > kVaccByValue && dev_table == nullptr))
      return (int)cudaErrorInvalidValue;
    VaccTable by_value = {};
    if (dev_table == nullptr) {
      const VaccMat* host = static_cast<const VaccMat*>(host_table);
      std::copy(host, host + K, by_value.m);
    }
    const int64_t blocks = (n + tile_rows - 1) / tile_rows * ((Lo + tile_words - 1) / tile_words);
    const size_t smem = (size_t)((tile_rows * tile_words + 3) / 4) * 16;
    if (blocks > 0x7fffffff || (int64_t)smem > kVaccMaxSmem) return (int)cudaErrorInvalidConfiguration;
    var_accumulate_tile_kernel<<<(unsigned)blocks, kVaccThreads, smem, (cudaStream_t)stream>>>(
        by_value, static_cast<const VaccMat*>(dev_table), K, static_cast<uint32_t*>(out), n, Lo,
        tile_rows, tile_words);
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
