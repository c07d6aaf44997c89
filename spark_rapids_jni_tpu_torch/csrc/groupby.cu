// Bounded-domain GROUP BY SUM + COUNT (B3) and GROUP BY SUM (B2).
//
// B3: sums[k] = sum of vals[i] over rows with keys[i] == k, counts[k] =
// number of such rows, for k in [0, K), K <= 65536.
// B2: the same sums without the counts, K <= 4096, keys int32 or int64,
// rounded to float32 [K].
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
// them. None of that is carried over; Hopper has atomics.
//
// Bound on an H100: device-memory bytes, 12 bytes a row (int64 key, f32
// value; 8 with int32 keys) plus the [K] output. The arithmetic is one
// add a row.
//
// B3's design: for K <= kSharedKeys each block keeps a private histogram
// in shared memory (a double sum and a u32 count per key: 48 KB at K =
// 4096, 96 KB at 8192), strides over rows adding with shared-memory
// atomics, then flushes its non-empty bins into the global result with
// one atomicAdd each. The wrapper launches a few blocks per SM, so the
// flush stays small beside the row pass. Above kSharedKeys the keys are
// spread so thin that contention is low, and rows add straight into the
// global result with global atomics. The wrapper zeroes the result first
// and rounds the sums to float32 after.
//
// B2's design: one cooperative launch and nothing else on the stream. At
// 1M rows the first port's kernel took about 0.011 ms (NVIDIA H100 80GB
// HBM3, 700.00 W), so the zero-fill launch before it, the rounding launch
// after it and a function-attribute call on every launch cost more than
// the kernel; the library's index_add_ needs only a fill and its kernel. groupby_bounded_kernel runs on a grid of at
// most the co-resident blocks (2 a SM): (1) each block sums its rows into
// a shared float64 histogram (32 KB at K = 4096), a thread loading four
// rows before it adds any so that enough bytes are in flight, and stores
// all of it as its row of a [grid, K] float64 partial; (2) one grid sync; (3) block b
// sums its K / grid columns down the partial's rows in a fixed order and
// rounds them once into the float32 output. The wrapper takes partial and
// output from torch.empty (no launch). The partial (8.6 MB at 264 blocks)
// stays in the 50 MB L2 between its write and its read, and it replaces
// a zeroed accumulator, a second grid sync and about 0.66M contended
// global atomics. The occupancy query and the SM count run once a
// process and a device for each key width, cached here; nothing else
// persists between calls, so two calls on two streams share no state. What bounds it beside the input bytes: the shared-memory
// atomics of the row pass, the partial's 2 x 8.6 MB through L2 and the
// grid sync. Since CUDA 11 the grid sync needs no relocatable device code
// (-rdc).
//
// Sums accumulate in double and are rounded once to float32: atomics make
// the order of the adds vary from run to run, and the double accumulator
// keeps that variation far below the float32 rounding of the result (the
// references' tolerances, rtol 2e-6 / atol 1e-3 for B3 and 1e-4 for B2,
// cover it). Counts are exact integers: u32 per block (a block sees far
// fewer than 2^32 rows), unsigned 64-bit in the result.

#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

namespace {

constexpr int64_t kSharedKeys = 8192;
constexpr size_t kBytesPerKey = sizeof(double) + sizeof(unsigned int);

// B3's block body, kept as it was measured (only the instance <int64_t,
// true> is built; kCounts false was B2's before it got its own kernel
// below)
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

// B2's domain cap (hopper_kernels.MAX_ONEHOT_KEYS) and blocks a SM
constexpr int64_t kOnehotKeys = 4096;
constexpr int kOnehotBlocksPerSM = 2;
constexpr int kOnehotUnroll = 4;  // rows a thread loads before it adds them
constexpr int kMaxDevices = 64;

// B2 in one cooperative launch: each block sums its rows into a shared
// float64 histogram and stores all of it as its row of partial [grid, K];
// one grid sync; then block b owns columns [b * cpb, (b + 1) * cpb), sums
// them down the grid's rows in a fixed order and rounds them into out.
// partial is read with __ldcg (L2), never from a line an SM's L1 may hold.
template <typename KeyT>
__global__ void __launch_bounds__(kThreads)
    groupby_bounded_kernel(const KeyT* __restrict__ keys, const float* __restrict__ vals,
                           double* partial, float* __restrict__ out, int64_t n, int64_t K) {
  extern __shared__ __align__(8) unsigned char smem[];
  double* s_sum = reinterpret_cast<double*>(smem);  // max(K, kThreads) doubles
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) s_sum[k] = 0.0;
  __syncthreads();
  // kOnehotUnroll rows a thread loaded before any is added, so a block
  // keeps that many loads in flight a thread
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
       i0 += stride * kOnehotUnroll) {
    int64_t k[kOnehotUnroll];
    float v[kOnehotUnroll];
#pragma unroll
    for (int u = 0; u < kOnehotUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      k[u] = i < n ? (int64_t)keys[i] : -1;
      v[u] = i < n ? vals[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kOnehotUnroll; ++u)
      if (k[u] >= 0 && k[u] < K) atomicAdd(&s_sum[k[u]], (double)v[u]);
  }
  __syncthreads();
  double* mine = partial + (int64_t)blockIdx.x * K;
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) mine[k] = s_sum[k];
  cooperative_groups::this_grid().sync();

  const int64_t grid = gridDim.x;
  const int64_t cpb = (K + grid - 1) / grid;  // columns a block
  const int64_t c0 = (int64_t)blockIdx.x * cpb;
  if (cpb >= blockDim.x) {  // few blocks: a thread a column, down all rows
    for (int64_t c = c0 + threadIdx.x; c < c0 + cpb && c < K; c += blockDim.x) {
      double t = 0.0;
      for (int64_t b = 0; b < grid; ++b) t += __ldcg(&partial[b * K + c]);
      out[c] = (float)t;
    }
    return;
  }
  // lanes threads a column, lane l summing rows l, l + lanes, ...; then
  // lane 0 adds the lanes' sums in lane order
  const int64_t lanes = blockDim.x / cpb, col = threadIdx.x % cpb, lane = threadIdx.x / cpb;
  const int64_t c = c0 + col;
  double t = 0.0;
  if (lane < lanes && c < K)
    for (int64_t b = lane; b < grid; b += lanes) t += __ldcg(&partial[b * K + c]);
  s_sum[threadIdx.x] = t;
  __syncthreads();
  if (lane == 0 && c < K) {
    double sum = 0.0;
    for (int64_t l = 0; l < lanes; ++l) sum += s_sum[l * cpb + col];
    out[c] = (float)sum;
  }
}

size_t onehot_smem(int64_t K) { return (size_t)std::max<int64_t>(K, kThreads) * sizeof(double); }

// the most blocks of groupby_bounded_kernel<KeyT> that are co-resident on
// the current device at B2's largest histogram, capped at
// kOnehotBlocksPerSM a SM; asked once a process and a device
std::atomic<int> g_onehot_grid[2][kMaxDevices];

template <typename KeyT>
cudaError_t onehot_grid(int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = g_onehot_grid[sizeof(KeyT) == 8][dev];
  *grid = slot.load(std::memory_order_relaxed);
  if (*grid > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, groupby_bounded_kernel<KeyT>,
                                                      kThreads, onehot_smem(kOnehotKeys));
  if (err != cudaSuccess) return err;
  *grid = sms * std::min(per_sm, kOnehotBlocksPerSM);
  if (*grid <= 0) return cudaErrorCooperativeLaunchTooLarge;
  slot.store(*grid, std::memory_order_relaxed);
  return cudaSuccess;
}

// grid: at most the co-resident grid, max_blocks (the partial's rows) and
// a block for each kThreads rows
template <typename KeyT>
cudaError_t launch_bounded(const void* keys, const void* vals, void* partial, void* out, int64_t n,
                           int64_t K, int64_t max_blocks, cudaStream_t st) {
  int grid = 0;
  const cudaError_t err = onehot_grid<KeyT>(&grid);
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      std::min<int64_t>(std::min<int64_t>(grid, max_blocks), (n + kThreads - 1) / kThreads);
  const KeyT* k = static_cast<const KeyT*>(keys);
  const float* v = static_cast<const float*>(vals);
  double* p = static_cast<double*>(partial);
  float* o = static_cast<float*>(out);
  void* args[] = {&k, &v, &p, &o, &n, &K};
  return cudaLaunchCooperativeKernel((const void*)groupby_bounded_kernel<KeyT>,
                                     dim3((unsigned)blocks), dim3(kThreads), args, onehot_smem(K),
                                     st);
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

// B2: keys [n] int32 (key_bytes 4) or int64 (8), vals [n] float32, n >= 1;
// out [K] float32 and partial [max_blocks, K] float64 need no initial
// value; 1 <= K <= 4096. One cooperative launch on the stream, nothing
// else.
extern "C" int groupby_sum_bounded_launch(const void* keys, int64_t key_bytes, const void* vals,
                                          void* partial, void* out, int64_t n, int64_t K,
                                          int64_t max_blocks, void* stream) {
  if (n < 1 || K < 1 || K > kOnehotKeys || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      key_bytes == 8 ? launch_bounded<int64_t>(keys, vals, partial, out, n, K, max_blocks, st)
                     : launch_bounded<int32_t>(keys, vals, partial, out, n, K, max_blocks, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
