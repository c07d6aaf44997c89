// Byte-plane relayouts between u32 word planes and u8 byte planes.
//
// expand_u32_planes (B6): u32 [P, N] -> u8 [4P, N], byte k (little endian)
//   of word (p, n) lands at (4p + k, n).
//   Replaces spark_rapids_jni_tpu/ops/ragged_bytes.py expand_u32_planes
//   (Pallas body _expand_kernel, a Mosaic sublane bitcast).
// pack_u8_planes (B7): the inverse, u8 [4P, N] -> u32 [P, N].
//   Replaces ragged_bytes.py pack_u8_planes (Pallas body _pack_kernel).
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

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

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
