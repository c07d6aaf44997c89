// Murmur3 hash partitioner (B1).
//
// out[i] = pmod(murmur3_32(key[i], seed 42), P) over one integer key
// column: a 4-byte key is one block (h ^ 4 before the finalizer), an
// 8-byte key two blocks, low word then high word (h ^ 8). A null row
// (valid[i] == 0) keeps the seed, as the row hash leaves a null's running
// hash unchanged. The hash is read as int32 and reduced to [0, P).
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py
// pallas_partition_map (_run, bodies _partition_kernel_1word /
// _partition_kernel_2word). That kernel tiles the key planes into
// [rows, 128] u32 blocks for the TPU's vector unit; none of that is
// carried over.
//
// Bound on an H100: device-memory bytes, 4 or 8 bytes of key (plus one of
// validity) in and 4 bytes out a row. A row costs ~20 integer operations,
// far below the card's integer rate, so one thread a row in a grid-stride
// loop, with loads and stores coalesced across the warp, reaches it.
//
// Two C++ pitfalls the Pallas code does not have: `%` truncates toward
// zero, so a negative remainder gets P added (as _partition_kernel_1word
// does), and the rotations are by 13 and 15 only (a shift by 32 is
// undefined).

#include <cuda_runtime.h>

#include <cstdint>

#include "murmur.cuh"

namespace {

template <bool kWide>
__global__ void partition_map_kernel(const void* __restrict__ keys,
                                     const uint8_t* __restrict__ valid,
                                     int32_t* __restrict__ out, int64_t n, int32_t P) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t h = murmur::kSeed;
    if (valid == nullptr || valid[i] != 0) {
      if (kWide) {
        const uint64_t k = static_cast<const uint64_t*>(keys)[i];
        h = murmur::mix_h(h, (uint32_t)k);
        h = murmur::mix_h(h, (uint32_t)(k >> 32));
        h = murmur::fmix(h ^ 8u);
      } else {
        h = murmur::mix_h(h, static_cast<const uint32_t*>(keys)[i]);
        h = murmur::fmix(h ^ 4u);
      }
    }
    const int32_t m = (int32_t)h % P;
    out[i] = m < 0 ? m + P : m;
  }
}

constexpr int kThreads = 256;

}  // namespace

// keys [n] of key_bytes (4 or 8) each; valid [n] bytes or null; out [n]
// int32; P >= 1; grid blocks of 256 threads.
extern "C" int partition_map_launch(const void* keys, int64_t key_bytes, const void* valid,
                                    void* out, int64_t n, int64_t P, int64_t grid,
                                    void* stream) {
  if (key_bytes != 4 && key_bytes != 8) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const auto* v = static_cast<const uint8_t*>(valid);
    auto* o = static_cast<int32_t*>(out);
    const cudaStream_t st = (cudaStream_t)stream;
    if (key_bytes == 8) {
      partition_map_kernel<true><<<(unsigned)grid, kThreads, 0, st>>>(keys, v, o, n, (int32_t)P);
    } else {
      partition_map_kernel<false><<<(unsigned)grid, kThreads, 0, st>>>(keys, v, o, n, (int32_t)P);
    }
  }
  return (int)cudaGetLastError();
}
