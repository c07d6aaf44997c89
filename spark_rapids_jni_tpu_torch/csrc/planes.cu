// Byte-plane relayouts between u32 word planes and u8 byte planes.
//
// expand_u32_planes (B6): u32 [P, N] -> u8 [4P, N], byte k (little endian)
//   of word (p, n) lands at (4p + k, n).
//   Replaces spark_rapids_jni_tpu/ops/ragged_bytes.py expand_u32_planes
//   (Pallas body _expand_kernel, a Mosaic sublane bitcast).
// pack_u8_planes (B7): the inverse, u8 [4P, N] -> u32 [P, N].
//   Replaces ragged_bytes.py pack_u8_planes (Pallas body _pack_kernel); the
//   decode no longer launches it (rows_to_planes below), and it stays as
//   the function-level counterpart.
// rows_to_planes (B7 on the decode's path, with B8's fixed-section gather
//   absorbed): the row blob -> u32 word planes [P, N], P = ceil(W / 4),
//   plane j of row r the little-endian word at blob bytes starts[r] + 4j ..
//   + 3; bytes at or past W within a row, and past the blob's end, are 0.
//   starts is [N] int64, or null for a uniform stride (row r at r * stride).
//   It is bit for bit the composition the decode ran before:
//   ragged_bytes.py padded_extract (an overlapping-tile row gather + B8
//   rotl_take32) cut to W bytes, padded to 4P, transposed to byte planes
//   and packed by B7.
//
// Bound on an H100: device-memory bytes. Each kernel reads 4*P*N bytes
// and writes 4*P*N bytes and does no arithmetic worth counting.
//
// Design: one thread owns one plane p and a run of 4 neighbouring
// columns n..n+3. For B6 it reads the run as one 16-byte load (4 words),
// transposes the 4x4 bytes in registers and writes one 4-byte word into
// each of the 4 output rows 4p..4p+3; B7 does the mirror image (four
// 4-byte loads, one 16-byte store). Neighbouring threads touch
// neighbouring addresses on both sides, so every load and store is
// coalesced. When N is not a multiple of 4 (or a pointer is not aligned
// for the vector access) the same threads fall back to byte accesses.
// All index arithmetic is 64-bit: at 4M rows x 198 planes the byte
// planes pass 2^31 bytes.
//
// rows_to_planes reads N * W bytes and writes 4 * P * N (plus the starts):
// a tiled transpose through shared memory. A block owns kR2PRows rows x a
// band of kR2PWords words and stages its rows' starts once. A warp reads
// one row's band at a time, lanes on consecutive words of the row's
// contiguous fixed section. A band that starts on a 4-byte boundary (every
// row convert_to_rows makes is 8-aligned) and whose whole words before W
// lie inside the blob -- the common case, decided once a row for the
// whole warp -- takes one plain aligned 4-byte load a word and no other
// work. The row's tail word (W not a multiple of 4) and every word of any
// other band (an odd start, a blob at a storage offset that is not a
// multiple of 4, the blob's end) are funnelled from the aligned words
// around them (bytes.cuh), bytes past W or past the blob 0. No load is
// wider than 4 bytes or unaligned, and no load leaves the blob.
// Instructions a word, not bytes, held the first designs (NVIDIA H100
// 80GB HBM3): the general funnel (64-bit bounds and masks) on every word
// reached 42-46% of the bound's rate, and issuing every load before any
// mask, for more bytes in flight, was slower still; the plain loads reach
// 64-75%. A thread issues its kR2PRowsAWarp x kR2PLoads loads before it
// stores any into the tile, which has one column of padding so that both
// the row-wise stores and the plane-wise reads are free of bank conflicts.
// Each plane's slice then goes out as kR2PRows consecutive words (256
// bytes). Byte addresses are 64-bit: a fixed blob passes 2^31 bytes at a
// few million rows.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bytes.cuh"

namespace {

constexpr int kThreads = 256;

// byte k of each of w0..w3, packed little endian into one word
__device__ __forceinline__ uint32_t byte_column(uint32_t w0, uint32_t w1, uint32_t w2,
                                                uint32_t w3, int k) {
  const int s = 8 * k;
  return ((w0 >> s) & 0xFFu) | (((w1 >> s) & 0xFFu) << 8) | (((w2 >> s) & 0xFFu) << 16) |
         (((w3 >> s) & 0xFFu) << 24);
}

__global__ void expand_kernel(const uint32_t* __restrict__ in, uint8_t* __restrict__ out,
                              int64_t P, int64_t N, bool vec) {
  const int64_t chunks = (N + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = blockIdx.y; p < P; p += gridDim.y) {
    const uint32_t* row = in + p * N;
    uint8_t* orow = out + 4 * p * N;
    for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
      if (vec) {
        const uint4 w = reinterpret_cast<const uint4*>(row)[c];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          reinterpret_cast<uint32_t*>(orow + k * N)[c] = byte_column(w.x, w.y, w.z, w.w, k);
        }
      } else {
        const int64_t n0 = 4 * c;
        const int64_t m = min((int64_t)4, N - n0);
        for (int64_t j = 0; j < m; ++j) {
          const uint32_t v = row[n0 + j];
#pragma unroll
          for (int k = 0; k < 4; ++k) orow[k * N + n0 + j] = (uint8_t)(v >> (8 * k));
        }
      }
    }
  }
}

__global__ void pack_kernel(const uint8_t* __restrict__ in, uint32_t* __restrict__ out,
                            int64_t P, int64_t N, bool vec) {
  const int64_t chunks = (N + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = blockIdx.y; p < P; p += gridDim.y) {
    const uint8_t* irow = in + 4 * p * N;
    uint32_t* row = out + p * N;
    for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < chunks; c += stride) {
      if (vec) {
        const uint32_t b0 = reinterpret_cast<const uint32_t*>(irow)[c];
        const uint32_t b1 = reinterpret_cast<const uint32_t*>(irow + N)[c];
        const uint32_t b2 = reinterpret_cast<const uint32_t*>(irow + 2 * N)[c];
        const uint32_t b3 = reinterpret_cast<const uint32_t*>(irow + 3 * N)[c];
        uint4 w;
        w.x = byte_column(b0, b1, b2, b3, 0);
        w.y = byte_column(b0, b1, b2, b3, 1);
        w.z = byte_column(b0, b1, b2, b3, 2);
        w.w = byte_column(b0, b1, b2, b3, 3);
        reinterpret_cast<uint4*>(row)[c] = w;
      } else {
        const int64_t n0 = 4 * c;
        const int64_t m = min((int64_t)4, N - n0);
        for (int64_t j = 0; j < m; ++j) {
          uint32_t v = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) v |= (uint32_t)irow[k * N + n0 + j] << (8 * k);
          row[n0 + j] = v;
        }
      }
    }
  }
}

constexpr int kR2PThreads = 256;
constexpr int kR2PRows = 64;   // rows a block: a plane's slice is 256 bytes
constexpr int kR2PWords = 64;  // words a band
constexpr int kR2PWarps = kR2PThreads / 32;
constexpr int kR2PRowsAWarp = kR2PRows / kR2PWarps;  // rows a warp reads
constexpr int kR2PLoads = kR2PWords / 32;            // words a lane reads in a row

__global__ void __launch_bounds__(kR2PThreads)
    rows_to_planes_kernel(const uint8_t* __restrict__ blob, int64_t blen,
                          const int64_t* __restrict__ starts, int64_t stride, int64_t W,
                          int64_t P, int64_t N, uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[kR2PRows][kR2PWords + 1];
  __shared__ int64_t s_start[kR2PRows];
  const int64_t r0 = (int64_t)blockIdx.x * kR2PRows;
  const int64_t c0 = (int64_t)blockIdx.y * kR2PWords;
  const bytes::Buffer buf(blob, blen);
  if (threadIdx.x < kR2PRows) {
    const int64_t r = r0 + threadIdx.x;
    s_start[threadIdx.x] = r < N ? (starts != nullptr ? starts[r] : r * stride) : 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the band's words that lie wholly before W (the row's tail word, where
  // W is not a multiple of 4, and the words past it do not)
  const int64_t nfull = W / 4 - c0 < kR2PWords ? W / 4 - c0 : kR2PWords;
  uint32_t v[kR2PRowsAWarp][kR2PLoads];
#pragma unroll
  for (int i = 0; i < kR2PRowsAWarp; ++i) {
    const int rl = warp + kR2PWarps * i;
    const int64_t a = buf.mis + s_start[rl] + 4 * c0;  // the band's first byte, aligned coordinates
    const int64_t q0 = a >> 2;
    if (r0 + rl >= N) {
#pragma unroll
      for (int u = 0; u < kR2PLoads; ++u) v[i][u] = 0u;
    } else if ((a & 3) == 0 && buf.inside(q0, q0 + nfull - 1)) {
      // the common case, uniform over the warp: whole aligned words of the blob
      const uint32_t* src = buf.pal + q0 + lane;
#pragma unroll
      for (int u = 0; u < kR2PLoads; ++u) {
        const int jj = lane + 32 * u;
        v[i][u] = jj < nfull ? __ldg(src + 32 * u) : buf.window(a + 4 * jj, W - 4 * (c0 + jj));
      }
    } else {
#pragma unroll
      for (int u = 0; u < kR2PLoads; ++u) {
        const int jj = lane + 32 * u;
        v[i][u] = buf.window(a + 4 * jj, W - 4 * (c0 + jj));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kR2PRowsAWarp; ++i) {
#pragma unroll
    for (int u = 0; u < kR2PLoads; ++u) tile[warp + kR2PWarps * i][lane + 32 * u] = v[i][u];
  }
  __syncthreads();
  // plane c0 + jj, rows r0 .. r0 + kR2PRows - 1: consecutive threads on
  // consecutive rows (tile rows 65 words apart: distinct banks); a thread
  // keeps its row and steps its plane by kR2PThreads / kR2PRows
  constexpr int kStep = kR2PThreads / kR2PRows;
  const int rr = threadIdx.x % kR2PRows;
  if (r0 + rr < N) {
    const int jj0 = threadIdx.x / kR2PRows;
    uint32_t* dst = out + (c0 + jj0) * N + r0 + rr;
#pragma unroll 4
    for (int jj = jj0; jj < kR2PWords; jj += kStep, dst += kStep * N) {
      if (c0 + jj < P) *dst = tile[rr][jj];
    }
  }
}

dim3 plane_grid(int64_t P, int64_t N) {
  const int64_t chunks = (N + 3) / 4;
  const int64_t bx = std::min<int64_t>((chunks + kThreads - 1) / kThreads, 1 << 20);
  const int64_t by = std::min<int64_t>(P, 65535);
  return dim3((unsigned)bx, (unsigned)by);
}

bool aligned(const void* ptr, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(ptr) % bytes == 0; }

}  // namespace

extern "C" int expand_u32_planes_launch(const void* in, void* out, int64_t P, int64_t N,
                                        void* stream) {
  if (P > 0 && N > 0) {
    const bool vec = N % 4 == 0 && aligned(in, 16) && aligned(out, 4);
    expand_kernel<<<plane_grid(P, N), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(in), static_cast<uint8_t*>(out), P, N, vec);
  }
  return (int)cudaGetLastError();
}

extern "C" int pack_u8_planes_launch(const void* in, void* out, int64_t P, int64_t N,
                                     void* stream) {
  if (P > 0 && N > 0) {
    const bool vec = N % 4 == 0 && aligned(in, 4) && aligned(out, 16);
    pack_kernel<<<plane_grid(P, N), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(in), static_cast<uint32_t*>(out), P, N, vec);
  }
  return (int)cudaGetLastError();
}

// rows_to_planes: blob uint8 [blen] at any address, starts int64 [N] or
// null with a uniform stride, W >= 1 bytes a row; out int32 [ceil(W/4), N].
extern "C" int rows_to_planes_launch(const void* blob, int64_t blen, const void* starts,
                                     int64_t stride, int64_t W, int64_t N, void* out,
                                     void* stream) {
  if (N > 0 && W > 0) {
    const int64_t P = (W + 3) / 4;
    const int64_t bx = (N + kR2PRows - 1) / kR2PRows, by = (P + kR2PWords - 1) / kR2PWords;
    if (bx > 0x7fffffff || by > 65535) return (int)cudaErrorInvalidConfiguration;
    rows_to_planes_kernel<<<dim3((unsigned)bx, (unsigned)by), kR2PThreads, 0,
                            (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(blob), blen, static_cast<const int64_t*>(starts), stride, W,
        P, N, static_cast<uint32_t*>(out));
  }
  return (int)cudaGetLastError();
}
