// String kernels of the JCUDF row transcode.
//
// rotl_take (B8, function level): u32 [N, L] rows, each rotated left by
//   sh[r] bytes (0 <= sh < 4L), first Lo words kept -> u32 [N, Lo].
//   Replaces spark_rapids_jni_tpu/ops/ragged_bytes.py rotl_take / rotl_take32
//   (Pallas body _rotl_take_kernel: a log2(W) ladder of conditional lane
//   rolls) as a function. Here output word j of row r is the funnel of
//   input words (j + sh/4) % L and the next one, shifted by 8 * (sh % 4).
//   The transcode no longer launches it: B8 only ever rotated the tiles of
//   padded_extract (an overlapping-tile row gather), and each of its two
//   callers now reads what it needs straight from the bytes --
//   extract_strings_many below (the encode) and planes.cu rows_to_planes
//   (the decode).
// extract_strings_many (B8 on the encode's path): for each string column k
//   of a launch, u8 [N, lc_k] where bytes j < min(lens[r], lc_k) of row r are
//   pool_k[starts[r] + j] (0 past the pool's end) and the others 0: what
//   the encode built from padded_extract (tile gather + B8) masked by the
//   lengths with an arange and a where, one launch for every column.
// var_accumulate (B9): u32 [N, Lo] = OR over k of the zero-filled byte
//   shift-right of matrix k (u32 [N, L_k]) by s_k[r] bytes.
//   Replaces ragged_bytes.py var_accumulate (Pallas body _vacc_kernel:
//   the K matrices packed into one lane-padded operand, then per column a
//   log2(W) ladder of conditional lane shifts OR-ed into the output
//   block). The design is below the general one.
// asm_epilogue (B10, function level): per destination tile t (G bytes,
//   g4 = G/4 words), byte i < alen[t] is byte i of (a0 || a1) rotated
//   left by pmod[t], the rest byte i of c0 shifted right by delta[t] (zero
//   fill). Replaces ragged_bytes.py _asm_epilogue (Pallas body _asm_kernel)
//   as a function; the encode no longer launches it (assemble_rows below).
// assemble_rows (B10 on the path): out[offsets[r] + j] = byte j of padded
//   row r for j < offsets[r+1] - offsets[r], the rows given as up to four
//   int32 parts side by side, each row-major or a transposed view. It is
//   the whole of ragged_bytes.py assemble_rows, whose last step is
//   _asm_epilogue: the owner fill, the three tile gathers, the epilogue
//   and the word-to-byte relayout in one kernel.
// ragged_compact (B5): out[offs[r] + j] = pool[base[r] + j] for
//   j < offs[r+1] - offs[r], dense offs, for one or many string columns
//   over one pool in one launch; base[r] may be a row start plus a u32
//   slot offset, added in the kernel.
//   Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py pallas_ragged_compact
//   (Pallas body _pd_kernel, which resolves each output word's owner row by
//   a dense masked max over a VMEM row window).
//
// Bound on an H100: device-memory bytes for every one of them; none does
// arithmetic worth counting.
//
// Design. B8 and asm_epilogue give one thread each output word. A block owns a
// run of whole rows (rows_per_block * words_per_row <= about 2048 words),
// so the row and word of a thread come from a 32-bit division by the row
// width, and neighbouring threads write neighbouring words. Shifts are read
// once per word from the per-row arrays (they stay in L1). A sub-word shift
// of 0 takes the word as it is: a 32-bit shift by 32 is undefined in C++.
//
// B5 and assemble_rows are ragged gathers: every output byte belongs to
// one row, and a block owns a fixed range of the output. The block finds
// its first and last row over the row offsets in device memory, half of
// its threads for each, by a search that cuts the range by the half's
// thread count a round (block_find_rows: three rounds of one load for a
// million rows, where one thread's binary search waits on twenty), and
// stages those rows' offsets (and B5's row bases) in shared memory. A
// thread issues all its loads before it uses any, where its work allows.
// All index math is 64-bit.
//
// B5 (ragged_compact_rows_kernel): a block owns kCompactWords output words
// of one column, two 16-byte chunks a thread; blocks are split across the
// columns of a launch by a prefix of per-column block counts
// (first_block), which the host computes from the totals it already
// holds. A thread finds its chunk's owner row among the staged rows, and
// the chunk goes out as one 16-byte store. Its bytes come in segments, one
// a row (strings of 1-32 bytes put several rows in a chunk); a segment is
// read as aligned 32-bit pool words funnel-shifted into the chunk's words,
// so neighbouring threads read neighbouring words of a row. The main
// path's strings lie at arbitrary byte offsets, 1.3 KB apart, so a 16-byte
// load would rarely be aligned to what a chunk needs; the 32-bit loads of
// a warp fall in the same sectors. Bytes outside the pool read as 0. Up to
// kCompactRowCap rows are staged; a block over more rows (a long run of
// zero-length rows: nulls) searches device memory, bounded to its rows.
// Zero-length rows own no byte and are skipped by a search, not a walk.
// The bound: the column's bytes read and written once, its offsets and
// slot offsets read once, the row starts once for the launch. What holds
// it from the bound: a column's strings are 1-32 bytes, one a row, so its
// pass fetches whole sectors around each and the blob's variable sections
// are fetched once a column.
//
// assemble_rows_kernel: a block owns kAsmBytes of the blob. Row sizes and
// offsets are multiples of 8 and at least 8, so output byte offsets[r] +
// j is byte j of padded row r with no shift: 32-bit word j/4 of the row
// goes to blob word offsets[r]/4 + j/4. A block takes its rows one part
// at a time, each row's words of the part that land in its range found
// once (asm_row_words), not a search a word. A part stored row-major is
// copied a warp a row, lanes on consecutive words on both sides. A part
// that is a transposed view ([w, N] planes read as [N, w], as the encode
// builds its fixed sections) would give each lane a word N words from its
// neighbour's, so the block stages it through a kAsmTileRows x
// kAsmTileCols shared-memory tile: read with consecutive threads on
// consecutive rows of one plane, written with consecutive threads on
// consecutive words of one row. A block thus reads each byte of the
// output once and writes it once, coalesced: the bound is the output's
// bytes read and written plus the offsets. 64-bit index math costs
// instructions a word, and a byte moved must cost few: the per-word work
// is a compare and an add.
//
// extract_strings_kernel: a block owns whole rows of one column's output
// (rows_per_block of them, about 2048 words: the wrapper's
// extract_block_plan, which also splits the blocks across the columns as
// B5's plan does, first_block a prefix of per-column block counts), a
// thread a unit of up to 4 words (16 bytes) of a row, neighbouring threads
// on neighbouring units, a unit's row and place stepped by the block's
// size with no division. A thread reads its row's start and length, loads
// the (at most 5) aligned pool words that hold the unit's string bytes,
// all before it uses any, funnels them into the unit's words, masks them
// to the length and stores the unit as one 16-byte store (where the row
// is a whole number of units). Words past the row's length take no load,
// so only the string's own bytes (and the rest of the aligned words
// holding them) are read: no padded copy of the pool, no tile. A string at
// any byte offset is funnelled from aligned 4-byte pool words
// (bytes::Buffer), the loads of a warp falling on consecutive words of
// consecutive strings, which lie side by side in the pool. A first design
// with a thread a word reached 25% of the bound's rate (NVIDIA H100 80GB
// HBM3): a 32-bit division and the 64-bit bounds and masks of every word
// cost more than its bytes; the 16-byte units reach about 50%. The
// bound: each string's bytes up to lc_k read, its start and length read,
// N * lc_k bytes written. Up to kExtractByValue columns travel in the
// kernel's arguments, more in a device table.
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

#include "bytes.cuh"

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

// the last index r in [lo, hi] with off(r) <= b, given off(lo) <= b
template <typename F>
__device__ __forceinline__ int64_t last_at_or_below(F off, int64_t lo, int64_t hi, int64_t b) {
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (off(mid) <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The two row searches of a block at once: on return r0 and r1 are the
// last r in [0, n - 1] with off(r) <= t0, resp. t1 (off(0) <= t0 <= t1),
// the same in every thread. Each half of the block narrows its range by
// the half's thread count a round, one probe a thread, so a million rows
// take three rounds of one load each where one thread's binary search
// takes twenty dependent loads, and the block waits on the search.
// blockDim.x is a multiple of 64.
template <typename F>
__device__ __forceinline__ void block_find_rows(F off, int64_t n, int64_t t0, int64_t t1,
                                                int64_t& r0, int64_t& r1) {
  __shared__ int64_t s_lo[2], s_hi[2];
  __shared__ int s_cnt[2];
  const int half = (int)blockDim.x / 2;
  const int h = (int)threadIdx.x / half, j = (int)threadIdx.x % half;
  const int64_t t = h ? t1 : t0;
  if (threadIdx.x < 2) {
    s_lo[threadIdx.x] = 0;
    s_hi[threadIdx.x] = n - 1;
    s_cnt[threadIdx.x] = 0;
  }
  __syncthreads();
  while (s_lo[0] < s_hi[0] || s_lo[1] < s_hi[1]) {  // read after a barrier: uniform
    const int64_t lo = s_lo[h], hi = s_hi[h];
    const int64_t step = (hi - lo + half - 1) / half;
    const int64_t p = lo + (int64_t)(j + 1) * step;
    const bool le = lo < hi && p <= hi && off(p) <= t;  // true for a prefix of the probes
    const unsigned votes = __ballot_sync(0xFFFFFFFFu, le);
    if ((threadIdx.x & 31) == 0 && votes != 0u) atomicAdd(&s_cnt[h], __popc(votes));
    __syncthreads();
    if (j == 0 && lo < hi) {  // the last probe at or below t, and the first above it
      const int64_t c = s_cnt[h];
      const int64_t top = lo + (c + 1) * step - 1;
      s_lo[h] = lo + c * step;
      s_hi[h] = top < hi ? top : hi;
      s_cnt[h] = 0;
    }
    __syncthreads();
  }
  r0 = s_lo[0];
  r1 = s_lo[1];
}

// one string column of B5: row r's characters start at base64[r] (0 when
// null) plus off32[r] read as u32 (0 when null); offs [n + 1] is dense
// from 0, of the launch's OffT
struct CompactCol {
  const int64_t* base64;
  const uint32_t* off32;
  const void* offs;
  uint32_t* out;  // ceil(total / 4) words, 16-byte aligned
  int64_t n;
  int64_t total;  // > 0
  int64_t first_block;  // the column's first block in the grid
};
constexpr int kCompactByValue = 32;  // columns passed in the kernel's arguments
struct CompactTable {
  CompactCol c[kCompactByValue];
};
constexpr int kCompactThreads = 256;
constexpr int kCompactMinBlocks = 6;     // resident blocks a SM the registers must allow
constexpr int64_t kCompactWords = 2048;  // output words a block owns: two 16-byte chunks a thread
constexpr int kCompactRowCap = 1536;     // rows a block stages in shared memory (24 KB)

__device__ __forceinline__ int64_t compact_row_base(const CompactCol& c, int64_t r) {
  int64_t b = c.base64 != nullptr ? c.base64[r] : 0;
  if (c.off32 != nullptr) b += (int64_t)c.off32[r];
  return b;
}

// chunk bytes [lo, hi) (0 <= lo < hi <= 16) take the pool bytes a0 + lo,
// ..., a0 + hi - 1 (a0 in aligned coordinates): word t of the chunk is the
// funnel of aligned words q0 + t and q0 + t + 1, masked to the range
__device__ __forceinline__ void funnel_into(uint32_t (&o)[4], const bytes::Buffer& pool,
                                            int64_t a0, int lo, int hi) {
  const int sh = (int)(a0 & 3) * 8;
  const int64_t q0 = a0 >> 2;  // floor division
  const int t0 = lo >> 2, t1 = (hi - 1) >> 2;
  uint32_t cur = pool.word(q0 + t0);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t < t0 || t > t1) continue;
    const uint32_t nxt = (sh != 0 || t < t1) ? pool.word(q0 + t + 1) : 0u;
    const uint32_t v = sh == 0 ? cur : (cur >> sh) | (nxt << (32 - sh));
    const int blo = lo > 4 * t ? lo - 4 * t : 0;
    const int bhi = hi < 4 * t + 4 ? hi - 4 * t : 4;
    const uint32_t keep = (bhi >= 4 ? 0xFFFFFFFFu : (1u << (8 * bhi)) - 1u) & (0xFFFFFFFFu << (8 * blo));
    o[t] |= v & keep;
    cur = nxt;
  }
}

// the block's output words [w0, w1) of column c, bytes [.., b_hi); its
// rows are indices 0 .. rows - 1 of off / base (off has rows + 1 entries)
template <typename Off, typename Base>
__device__ __forceinline__ void compact_range(Off off, Base base, int64_t rows, uint32_t* out,
                                              int64_t w0, int64_t w1, int64_t b_hi,
                                              const bytes::Buffer& pool) {
  for (int64_t q = w0 + 4 * (int64_t)threadIdx.x; q < w1; q += 4 * (int64_t)blockDim.x) {
    uint32_t o[4] = {0u, 0u, 0u, 0u};
    const int64_t c0 = 4 * q;
    const int64_t cend = c0 + 16 < b_hi ? c0 + 16 : b_hi;
    int64_t i = last_at_or_below(off, 0, rows - 1, c0);
    int64_t b = c0;
    while (true) {
      // row i owns byte b (off(i) <= b < off(i + 1)); its bytes up to the
      // chunk's end or its own
      const int64_t oe = off(i + 1);
      const int64_t se = oe < cend ? oe : cend;
      funnel_into(o, pool, pool.mis + base(i) + (c0 - off(i)), (int)(b - c0), (int)(se - c0));
      if (se >= cend) break;
      b = se;  // == off(i + 1): the next row with a byte here, past zero-length ones
      i = off(i + 2) > b ? i + 1 : last_at_or_below(off, i + 1, rows - 1, b);
    }
    uint32_t* dst = out + q;
    if (q + 4 <= w1) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      dst[0] = o[0];
      if (q + 1 < w1) dst[1] = o[1];
      if (q + 2 < w1) dst[2] = o[2];
    }
  }
}

template <typename OffT>
__global__ void __launch_bounds__(kCompactThreads, kCompactMinBlocks)
    ragged_compact_rows_kernel(const __grid_constant__ CompactTable by_value,
                               const CompactCol* __restrict__ table, int64_t K,
                               const uint8_t* __restrict__ pool, int64_t plen) {
  __shared__ int64_t s_offs[kCompactRowCap + 1];
  __shared__ int64_t s_base[kCompactRowCap];
  __shared__ int64_t s_col;
  const CompactCol* cols = table != nullptr ? table : by_value.c;
  const int64_t blk = blockIdx.x;
  if (threadIdx.x == 0)
    s_col = last_at_or_below([&](int64_t k) { return cols[k].first_block; }, 0, K - 1, blk);
  __syncthreads();
  const CompactCol c = cols[s_col];
  const OffT* __restrict__ offs = static_cast<const OffT*>(c.offs);
  const int64_t nwords = (c.total + 3) >> 2;
  const int64_t w0 = (blk - c.first_block) * kCompactWords;
  const int64_t w1 = w0 + kCompactWords < nwords ? w0 + kCompactWords : nwords;
  const int64_t b_lo = 4 * w0, b_hi = 4 * w1 < c.total ? 4 * w1 : c.total;
  // the block's first row and last row: the owners of its first and last
  // byte (the last word's bytes past the block's range included)
  int64_t r0, r1;
  block_find_rows([&](int64_t r) { return (int64_t)offs[r]; }, c.n, b_lo, b_hi - 1, r0, r1);
  const int64_t rows = r1 - r0 + 1;
  const bytes::Buffer buf(pool, plen);
  if (rows <= kCompactRowCap) {  // uniform over the block
    for (int64_t i = threadIdx.x; i <= rows; i += blockDim.x) s_offs[i] = (int64_t)offs[r0 + i];
    for (int64_t i = threadIdx.x; i < rows; i += blockDim.x) s_base[i] = compact_row_base(c, r0 + i);
    __syncthreads();
    compact_range([&](int64_t i) { return s_offs[i]; }, [&](int64_t i) { return s_base[i]; }, rows,
                  c.out, w0, w1, b_hi, buf);
  } else {
    compact_range([&](int64_t i) { return (int64_t)offs[r0 + i]; },
                  [&](int64_t i) { return compact_row_base(c, r0 + i); }, rows, c.out, w0, w1,
                  b_hi, buf);
  }
}

// one string column of extract_strings_many: out [n, L4] words; row r's
// bytes j < min(lens[r], 4 L4) are pool[starts[r] + j] (0 at or past plen),
// the others 0; starts and lens [n] of the launch's IdxT
struct ExtractCol {
  const uint8_t* pool;
  int64_t plen;
  const void* starts;
  const void* lens;
  uint32_t* out;
  int64_t L4;              // words a row, >= 1
  int64_t rows_per_block;  // >= 1
  int64_t first_block;     // the column's first block in the grid
};
constexpr int kExtractByValue = 32;  // columns passed in the kernel's arguments
struct ExtractTable {
  ExtractCol c[kExtractByValue];
};
constexpr int kExtractThreads = 256;

template <typename IdxT>
__global__ void __launch_bounds__(kExtractThreads)
    extract_strings_kernel(const __grid_constant__ ExtractTable by_value,
                           const ExtractCol* __restrict__ table, int64_t K, int64_t n) {
  __shared__ int64_t s_col;
  const ExtractCol* cols = table != nullptr ? table : by_value.c;
  const int64_t blk = blockIdx.x;
  if (threadIdx.x == 0)
    s_col = last_at_or_below([&](int64_t k) { return cols[k].first_block; }, 0, K - 1, blk);
  __syncthreads();
  const ExtractCol c = cols[s_col];
  const IdxT* __restrict__ starts = static_cast<const IdxT*>(c.starts);
  const IdxT* __restrict__ lens = static_cast<const IdxT*>(c.lens);
  const int64_t r0 = (blk - c.first_block) * c.rows_per_block;
  const int64_t rows = n - r0 < c.rows_per_block ? n - r0 : c.rows_per_block;
  const bytes::Buffer pool(c.pool, c.plen);
  const int64_t L4 = c.L4;
  const bool vec = (L4 & 3) == 0;  // every whole unit lies on 16 bytes of the output
  // a thread a unit of up to 4 words of a row; its row and unit advance by
  // the block's size each round, with no division in the loop
  const int64_t units = (L4 + 3) >> 2;
  const int64_t count = rows * units;
  const int64_t drl = blockDim.x / units, dt = blockDim.x % units;
  int64_t rl = threadIdx.x / units, t = threadIdx.x % units;
  for (int64_t e = threadIdx.x; e < count; e += blockDim.x) {
    const int64_t r = r0 + rl;
    const int nw = L4 - 4 * t < 4 ? (int)(L4 - 4 * t) : 4;  // the unit's words
    const int64_t need = (int64_t)lens[r] - 16 * t;        // the string's bytes from the unit on
    const int64_t a = pool.mis + (int64_t)starts[r] + 16 * t;
    const int64_t q = a >> 2;
    const int sh = (int)(a & 3);
    const int64_t used = need < 4 * nw ? need : 4 * nw;  // the unit's bytes taken from the pool
    // aligned word k covers the unit's bytes [4k - sh, 4k - sh + 4): loaded
    // when one of them is used, all loads before any use
    uint32_t wd[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) wd[k] = 4 * k - sh < used ? pool.word(q + k) : 0u;
    uint32_t o[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      o[m] = bytes::keep(bytes::funnel(wd[m], wd[m + 1], sh), need - 4 * m);
    uint32_t* dst = c.out + r * L4 + 4 * t;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (m < nw) dst[m] = o[m];
    }
    rl += drl;
    t += dt;
    if (t >= units) {
      t -= units;
      rl += 1;
    }
  }
}

// one part of assemble_rows' padded rows: int32 words, row r's word c at
// ptr[r * ld + c], or at ptr[c * ld + r] when transposed
struct AsmPart {
  const uint32_t* ptr;
  int64_t words;
  int64_t ld;
  int64_t transposed;
};
constexpr int kAsmParts = 4;
struct AsmParts {
  AsmPart p[kAsmParts];
};
constexpr int kAsmThreads = 256;
constexpr int kAsmMinBlocks = 6;      // resident blocks a SM the registers must allow
constexpr int64_t kAsmBytes = 16384;  // output bytes a block owns
// rows of 8 bytes or more, on 8-byte boundaries: at most this many meet a
// block's range
constexpr int kAsmRows = (int)(kAsmBytes / 8);
constexpr int kAsmTileRows = 16;
constexpr int kAsmTileCols = 128;
constexpr int kAsmTileLoads = kAsmTileRows * kAsmTileCols / kAsmThreads;  // tile words a thread
constexpr int kAsmRowLoads = 4;  // words a lane loads before it stores, a warp copying a row

// the words [c0, c1) of a part (its first word pc0 in the row, pw words)
// that block row i puts into the block's bytes [lo, hi)
__device__ __forceinline__ void asm_row_words(const int64_t* s_offs, int i, int64_t lo, int64_t hi,
                                              int64_t pc0, int64_t pw, int64_t& c0, int64_t& c1) {
  const int64_t ro = s_offs[i], re = s_offs[i + 1];
  c0 = (((lo > ro ? lo : ro) - ro) >> 2) - pc0;
  c1 = (((hi < re ? hi : re) - ro) >> 2) - pc0;
  if (c0 < 0) c0 = 0;
  if (c1 > pw) c1 = pw;
}

__global__ void __launch_bounds__(kAsmThreads, kAsmMinBlocks)
    assemble_rows_kernel(const __grid_constant__ AsmParts parts, int nparts,
                         const int64_t* __restrict__ offsets, int64_t n,
                         uint8_t* __restrict__ out, int64_t total) {
  __shared__ int64_t s_offs[kAsmRows + 1];
  __shared__ uint32_t tile[kAsmTileRows][kAsmTileCols + 1];
  const int64_t lo = (int64_t)blockIdx.x * kAsmBytes;
  const int64_t hi = lo + kAsmBytes < total ? lo + kAsmBytes : total;
  int64_t r0, r1;
  block_find_rows([&](int64_t r) { return offsets[r]; }, n, lo, hi - 1, r0, r1);
  const int rows = (int)(r1 - r0 + 1);  // <= kAsmRows
  for (int i = threadIdx.x; i <= rows; i += blockDim.x) s_offs[i] = offsets[r0 + i];
  __syncthreads();
  uint32_t* out32 = reinterpret_cast<uint32_t*>(out);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;

  int64_t pc0 = 0;  // the part's first word in the row
  for (int k = 0; k <= nparts; ++k) {
    // parts[nparts]: the words past the parts, zero (rows the caller padded short)
    const bool zero = k == nparts;
    const AsmPart p = zero ? AsmPart{nullptr, INT64_MAX / 8, 0, 0} : parts.p[k];
    if (!p.transposed) {
      // a warp a row: its words of the part in the block's range, lanes on
      // consecutive words of the row on both sides
      for (int i = warp; i < rows; i += warps) {
        int64_t c0, c1;
        asm_row_words(s_offs, i, lo, hi, pc0, p.words, c0, c1);
        const uint32_t* src = zero ? nullptr : p.ptr + (r0 + i) * p.ld;
        uint32_t* dst = out32 + (s_offs[i] >> 2) + pc0;
        for (int64_t c = c0 + lane; c < c1; c += 32 * kAsmRowLoads) {
          uint32_t v[kAsmRowLoads];
#pragma unroll
          for (int u = 0; u < kAsmRowLoads; ++u)
            v[u] = !zero && c + 32 * u < c1 ? __ldg(src + c + 32 * u) : 0u;
#pragma unroll
          for (int u = 0; u < kAsmRowLoads; ++u)
            if (c + 32 * u < c1) dst[c + 32 * u] = v[u];
        }
      }
    } else {
      // through the tile: a thread reads one row's words down the planes
      // (consecutive threads, consecutive rows of a plane), then writes a
      // row's consecutive words
      for (int rr = 0; rr < rows; rr += kAsmTileRows) {
        const int rl = threadIdx.x % kAsmTileRows;  // this thread's row when reading
        int64_t c0 = 0, c1 = 0;
        if (rr + rl < rows) asm_row_words(s_offs, rr + rl, lo, hi, pc0, p.words, c0, c1);
        const uint32_t* src = p.ptr + r0 + rr + rl;
        for (int64_t cc = 0; cc < p.words; cc += kAsmTileCols) {
          uint32_t v[kAsmTileLoads];
#pragma unroll
          for (int u = 0; u < kAsmTileLoads; ++u) {
            const int64_t c = cc + threadIdx.x / kAsmTileRows + u * (kAsmThreads / kAsmTileRows);
            v[u] = c >= c0 && c < c1 ? __ldg(src + c * p.ld) : 0u;
          }
#pragma unroll
          for (int u = 0; u < kAsmTileLoads; ++u)
            tile[rl][threadIdx.x / kAsmTileRows + u * (kAsmThreads / kAsmTileRows)] = v[u];
          __syncthreads();
#pragma unroll
          for (int u = 0; u < kAsmTileLoads; ++u) {
            const int wr = threadIdx.x / kAsmTileCols + u * (kAsmThreads / kAsmTileCols);
            const int wc = threadIdx.x % kAsmTileCols;
            if (rr + wr < rows) {
              int64_t w0, w1;
              asm_row_words(s_offs, rr + wr, lo, hi, pc0, p.words, w0, w1);
              if (cc + wc >= w0 && cc + wc < w1)
                out32[(s_offs[rr + wr] >> 2) + pc0 + cc + wc] = tile[wr][wc];
            }
          }
          __syncthreads();
        }
      }
    }
    if (!zero) pc0 += p.words;
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

// B5: host_table holds K CompactCol entries (K >= 1, every total > 0,
// first_block the prefix of ceil(ceil(total / 4) / kCompactWords) over the
// columns, blocks their sum). With dev_table null they travel in the
// kernel's arguments (K <= kCompactByValue); otherwise dev_table is the
// same table on the device. offs_bytes is 4 (int32 offsets) or 8 (int64).
extern "C" int ragged_compact_launch(const void* host_table, const void* dev_table, int64_t K,
                                     int64_t offs_bytes, const void* pool, int64_t plen,
                                     int64_t blocks, void* stream) {
  if (K > 0 && blocks > 0) {
    if ((K > kCompactByValue && dev_table == nullptr) || (offs_bytes != 4 && offs_bytes != 8))
      return (int)cudaErrorInvalidValue;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    CompactTable by_value = {};
    if (dev_table == nullptr) {
      const CompactCol* host = static_cast<const CompactCol*>(host_table);
      std::copy(host, host + K, by_value.c);
    }
    const CompactCol* table = static_cast<const CompactCol*>(dev_table);
    const uint8_t* p = static_cast<const uint8_t*>(pool);
    if (offs_bytes == 4)
      ragged_compact_rows_kernel<int32_t><<<(unsigned)blocks, kCompactThreads, 0,
                                            (cudaStream_t)stream>>>(by_value, table, K, p, plen);
    else
      ragged_compact_rows_kernel<int64_t><<<(unsigned)blocks, kCompactThreads, 0,
                                            (cudaStream_t)stream>>>(by_value, table, K, p, plen);
  }
  return (int)cudaGetLastError();
}

// assemble_rows: host_parts holds nparts AsmPart entries (1..kAsmParts);
// offsets int64 [n + 1], every row 8 bytes or more and a multiple of 8;
// out uint8 [total], 16-byte aligned.
extern "C" int assemble_rows_launch(const void* host_parts, int64_t nparts, const void* offsets,
                                    int64_t n, void* out, int64_t total, void* stream) {
  if (n > 0 && total > 0) {
    if (nparts < 1 || nparts > kAsmParts || (total & 7) != 0 ||
        (reinterpret_cast<uintptr_t>(out) & 15) != 0)
      return (int)cudaErrorInvalidValue;
    const int64_t blocks = (total + kAsmBytes - 1) / kAsmBytes;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    AsmParts parts = {};
    const AsmPart* host = static_cast<const AsmPart*>(host_parts);
    std::copy(host, host + nparts, parts.p);
    assemble_rows_kernel<<<(unsigned)blocks, kAsmThreads, 0, (cudaStream_t)stream>>>(
        parts, (int)nparts, static_cast<const int64_t*>(offsets), n, static_cast<uint8_t*>(out),
        total);
  }
  return (int)cudaGetLastError();
}

// extract_strings_many: host_table holds K ExtractCol entries (K >= 1,
// first_block the prefix of ceil(n / rows_per_block) over the columns,
// blocks their sum). With dev_table null they travel in the kernel's
// arguments (K <= kExtractByValue); otherwise dev_table is the same table
// on the device. idx_bytes is 4 (int32 starts and lengths) or 8 (int64).
extern "C" int extract_strings_launch(const void* host_table, const void* dev_table, int64_t K,
                                      int64_t idx_bytes, int64_t n, int64_t blocks,
                                      void* stream) {
  if (K > 0 && n > 0 && blocks > 0) {
    if ((K > kExtractByValue && dev_table == nullptr) || (idx_bytes != 4 && idx_bytes != 8))
      return (int)cudaErrorInvalidValue;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    const ExtractCol* host = static_cast<const ExtractCol*>(host_table);
    for (int64_t k = 0; k < K; ++k) {
      // a block's words must fit its 32-bit loop
      if (host[k].L4 < 1 || host[k].rows_per_block < 1 ||
          host[k].L4 * host[k].rows_per_block > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    }
    ExtractTable by_value = {};
    if (dev_table == nullptr) std::copy(host, host + K, by_value.c);
    const ExtractCol* table = static_cast<const ExtractCol*>(dev_table);
    if (idx_bytes == 4)
      extract_strings_kernel<int32_t><<<(unsigned)blocks, kExtractThreads, 0,
                                        (cudaStream_t)stream>>>(by_value, table, K, n);
    else
      extract_strings_kernel<int64_t><<<(unsigned)blocks, kExtractThreads, 0,
                                        (cudaStream_t)stream>>>(by_value, table, K, n);
  }
  return (int)cudaGetLastError();
}
