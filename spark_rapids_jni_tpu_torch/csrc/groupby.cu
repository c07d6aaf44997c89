// Bounded-domain GROUP BY SUM + COUNT (B3) and GROUP BY SUM (B2).
//
// B3: sums[k] = sum of vals[i] over rows with keys[i] == k, counts[k] =
// number of such rows, for k in [0, K), K <= 65536.
// B2: the same sums without the counts, K <= 4096, keys int32 or int64.
// Rows whose key is outside [0, K) are dropped; keys are compared at
// their own width, so an int64 key >= 2^32 drops instead of wrapping into
// the domain.
//
// B3 replaces spark_rapids_jni_tpu/ops/pallas_kernels.py
// pallas_groupby_sum_outer (_outer_impl, Pallas body _outer_kernel). B2
// replaces pallas_groupby_sum_bounded (_groupby_impl, Pallas body
// _groupby_kernel): a [256, K] one-hot tile built in VMEM per row chunk
// and contracted with the values on the MXU at HIGHEST precision. Both
// exist because the TPU has no scatter: they build one-hot matrices (B3
// also splits each value into three bf16 limbs) so the MXU can contract
// them. None of that is carried over; Hopper has atomics, and one block
// body serves both, templated on keeping the counts.
//
// Bound on an H100: device-memory bytes, 12 bytes a row (int64 key, f32
// value; 8 with int32 keys) plus the [K] output. The arithmetic is one
// add a row.
//
// Design: for K <= kSharedKeys each block keeps a private histogram in
// shared memory (a double sum, and for B3 a u32 count, per key: 32 KB
// at K = 4096 for B2, 48 KB for B3, 96 KB at 8192), strides over rows
// adding with shared-memory atomics, then flushes its non-empty bins into
// the global result with one atomicAdd each. The wrapper launches a few
// blocks per SM, so the flush stays small beside the row pass. Above
// kSharedKeys (B3 only) the keys are spread so thin that contention is
// low, and rows add straight into the global result with global atomics.
//
// Sums accumulate in double and the wrapper rounds them once to float32:
// atomics make the order of the adds vary from run to run, and the double
// accumulator keeps that variation far below the float32 rounding of the
// result (the references' tolerances, rtol 2e-6 / atol 1e-3 for B3 and
// 1e-4 for B2, cover it). Counts are exact integers: u32 per block (a
// block sees far fewer than 2^32 rows), unsigned 64-bit in the result.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int64_t kSharedKeys = 8192;
constexpr size_t kBytesPerKey = sizeof(double) + sizeof(unsigned int);

// kCounts: B3 (sums and counts); without it B2 (sums only, counts unused)
template <typename KeyT, bool kCounts>
__global__ void groupby_shared_kernel(const KeyT* __restrict__ keys,
                                      const float* __restrict__ vals, double* __restrict__ sums,
                                      unsigned long long* __restrict__ counts, int64_t n,
                                      int64_t K) {
  extern __shared__ __align__(8) unsigned char smem[];
  double* s_sum = reinterpret_cast<double*>(smem);
  unsigned int* s_cnt = reinterpret_cast<unsigned int*>(s_sum + K);
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) {
    s_sum[k] = 0.0;
    if (kCounts) s_cnt[k] = 0u;
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t k = (int64_t)keys[i];
    if (k >= 0 && k < K) {
      atomicAdd(&s_sum[k], (double)vals[i]);
      if (kCounts) atomicAdd(&s_cnt[k], 1u);
    }
  }
  __syncthreads();
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) {
    if (kCounts) {
      const unsigned int c = s_cnt[k];
      if (c != 0u) {
        atomicAdd(&sums[k], s_sum[k]);
        atomicAdd(&counts[k], (unsigned long long)c);
      }
    } else if (s_sum[k] != 0.0) {  // NaN != 0: a NaN bin flushes too
      atomicAdd(&sums[k], s_sum[k]);
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

template <typename KeyT, bool kCounts>
cudaError_t launch_shared(const void* keys, const void* vals, void* sums, void* counts, int64_t n,
                          int64_t K, int64_t grid, cudaStream_t st) {
  const size_t smem = (size_t)K * (kCounts ? kBytesPerKey : sizeof(double));
  auto kernel = groupby_shared_kernel<KeyT, kCounts>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)grid, kThreads, smem, st>>>(
      static_cast<const KeyT*>(keys), static_cast<const float*>(vals), static_cast<double*>(sums),
      static_cast<unsigned long long*>(counts), n, K);
  return cudaSuccess;
}

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
      const cudaError_t err = launch_shared<int64_t, true>(keys, vals, sums, counts, n, K, grid, st);
      if (err != cudaSuccess) return (int)err;
    } else {
      groupby_global_kernel<<<(unsigned)grid, kThreads, 0, st>>>(k, v, s, c, n, K);
    }
  }
  return (int)cudaGetLastError();
}

// B2: keys [n] int32 (key_bytes 4) or int64 (8), vals [n] float32; sums
// [K] double must be zero on entry; K <= 4096. grid is the number of
// blocks (>= 1).
extern "C" int groupby_sum_bounded_launch(const void* keys, int64_t key_bytes, const void* vals,
                                          void* sums, int64_t n, int64_t K, int64_t grid,
                                          void* stream) {
  if (n > 0 && K > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t err =
        key_bytes == 8 ? launch_shared<int64_t, false>(keys, vals, sums, nullptr, n, K, grid, st)
                       : launch_shared<int32_t, false>(keys, vals, sums, nullptr, n, K, grid, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
