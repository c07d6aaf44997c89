// Bounded-domain GROUP BY SUM + COUNT (B3).
//
// sums[k] = sum of vals[i] over rows with keys[i] == k, counts[k] = number
// of such rows, for k in [0, K), K <= 65536. Rows whose key is outside
// [0, K) are dropped; keys are compared as int64, so a key >= 2^32 drops
// instead of wrapping into the domain.
//
// Replaces spark_rapids_jni_tpu/ops/pallas_kernels.py
// pallas_groupby_sum_outer (_outer_impl, Pallas body _outer_kernel). That
// kernel exists because the TPU has no scatter: it builds one-hot
// matrices and splits each value into three bf16 limbs so the MXU can
// contract them. None of that is carried over; Hopper has atomics.
//
// Bound on an H100: device-memory bytes, 12 bytes a row (int64 key, f32
// value) plus 12 bytes a key of output. The arithmetic is one add a row.
//
// Design: for K <= kSharedKeys each block keeps a private histogram in
// shared memory (a double sum and a u32 count per key, 12 bytes a key:
// 48 KB at K = 4096, 96 KB at 8192), strides over rows adding with
// shared-memory atomics, then flushes its non-empty bins into the global
// result with one atomicAdd each. The wrapper launches a few blocks per
// SM, so the flush stays small beside the row pass. Above kSharedKeys the
// keys are spread so thin that contention is low, and rows add straight
// into the global result with global atomics.
//
// Sums accumulate in double and the wrapper rounds them once to float32:
// atomics make the order of the adds vary from run to run, and the double
// accumulator keeps that variation far below the float32 rounding of the
// result (the reference's tolerance, rtol 2e-6 / atol 1e-3, covers it).
// Counts are exact integers: u32 per block (a block sees far fewer than
// 2^32 rows), unsigned 64-bit in the result.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int64_t kSharedKeys = 8192;
constexpr size_t kBytesPerKey = sizeof(double) + sizeof(unsigned int);

__global__ void groupby_shared_kernel(const int64_t* __restrict__ keys,
                                      const float* __restrict__ vals, double* __restrict__ sums,
                                      unsigned long long* __restrict__ counts, int64_t n,
                                      int64_t K) {
  extern __shared__ __align__(8) unsigned char smem[];
  double* s_sum = reinterpret_cast<double*>(smem);
  unsigned int* s_cnt = reinterpret_cast<unsigned int*>(s_sum + K);
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) {
    s_sum[k] = 0.0;
    s_cnt[k] = 0u;
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t k = keys[i];
    if (k >= 0 && k < K) {
      atomicAdd(&s_sum[k], (double)vals[i]);
      atomicAdd(&s_cnt[k], 1u);
    }
  }
  __syncthreads();
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) {
    const unsigned int c = s_cnt[k];
    if (c != 0u) {
      atomicAdd(&sums[k], s_sum[k]);
      atomicAdd(&counts[k], (unsigned long long)c);
    }
  }
}

__global__ void groupby_global_kernel(const int64_t* __restrict__ keys,
                                      const float* __restrict__ vals, double* __restrict__ sums,
                                      unsigned long long* __restrict__ counts, int64_t n,
                                      int64_t K) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t k = keys[i];
    if (k >= 0 && k < K) {
      atomicAdd(&sums[k], (double)vals[i]);
      atomicAdd(&counts[k], 1ull);
    }
  }
}

constexpr int kThreads = 512;

}  // namespace

// keys [n] int64, vals [n] float32; sums [K] double and counts [K] uint64
// must be zero on entry. grid is the number of blocks (>= 1).
extern "C" int groupby_sum_outer_launch(const void* keys, const void* vals, void* sums,
                                        void* counts, int64_t n, int64_t K, int64_t grid,
                                        void* stream) {
  if (n > 0 && K > 0) {
    const auto* k = static_cast<const int64_t*>(keys);
    const auto* v = static_cast<const float*>(vals);
    auto* s = static_cast<double*>(sums);
    auto* c = static_cast<unsigned long long*>(counts);
    const cudaStream_t st = (cudaStream_t)stream;
    if (K <= kSharedKeys) {
      const size_t smem = (size_t)K * kBytesPerKey;
      cudaError_t err = cudaFuncSetAttribute(
          groupby_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      groupby_shared_kernel<<<(unsigned)grid, kThreads, smem, st>>>(k, v, s, c, n, K);
    } else {
      groupby_global_kernel<<<(unsigned)grid, kThreads, 0, st>>>(k, v, s, c, n, K);
    }
  }
  return (int)cudaGetLastError();
}
