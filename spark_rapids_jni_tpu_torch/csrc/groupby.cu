// Bounded-domain GROUP BY SUM + COUNT (B3) and GROUP BY SUM (B2).
//
// B3: sums[k] = sum of vals[i] over rows with keys[i] == k, counts[k] =
// number of such rows, for k in [0, K), K <= 65536, rounded to float32
// [K] and int64 [K].
// B2: the same sums without the counts, K <= 4096, rounded to float32 [K].
// Keys are int32 or int64. Rows whose key is outside [0, K) are dropped;
// keys are compared at their own width, so an int64 key >= 2^32 drops
// instead of wrapping into the domain.
//
// B3 replaces spark_rapids_jni_tpu/ops/pallas_kernels.py
// pallas_groupby_sum_outer (_outer_impl, Pallas body _outer_kernel): the
// keys as a one-hot matrix, each value split into three bf16 limbs, the
// two contracted on the MXU. B2 replaces pallas_groupby_sum_bounded
// (_groupby_impl, Pallas body _groupby_kernel): a [256, K] one-hot tile
// built in VMEM per row chunk and contracted with the values on the MXU
// at HIGHEST precision. Both exist because the TPU has no scatter. None
// of that is carried over; Hopper has shared-memory atomics.
//
// Bound on an H100: device-memory bytes, 12 bytes a row (int64 key, f32
// value; 8 with int32 keys) plus the outputs (B3: 12 bytes a key, B2: 4).
// The arithmetic is one add a row.
//
// Both are one cooperative launch and nothing else on the stream: the
// wrapper takes outputs and scratch from torch.empty (no fill), and the
// kernel rounds the sums itself (no cast after). The co-resident grid
// (B3: one block of 1,024 threads a SM; B2: at most two of 512) and the
// shared-memory opt-in are asked once a process, a device and a key
// width, and cached here; nothing else persists between calls, so two
// calls on two streams share no state. Since CUDA 11 the grid sync needs
// no relocatable device code (-rdc).
//
// B3's design, groupby_outer_kernel:
// - K <= kSharedKeys: (1) each block sums its rows into a shared
//   histogram, a double sum and a u32 count a key (48 KB at K = 4096, 96
//   KB at 8192), a thread loading kUnroll rows before it adds any; (2) it
//   stores the histogram as its row of a [G, K] float64 and a [G, K] u32
//   partial; (3) one grid sync; (4) block b sums its K / G columns down
//   the partials in a fixed order and (5) writes the float32 sums and the
//   int64 counts. G is capped so the partials (G x K x 12 B) stay within
//   kPartialBytes, well inside the 50 MB L2 between their write and their
//   read (6.5 MB at G = 132 and K = 4096); one block a SM halves them
//   against two blocks of 512 threads, which measured slower, as did
//   thread-block clusters merging their histograms through distributed
//   shared memory before the write (PERF.md). This replaces the first
//   port's flush, in which each block added its non-empty bins into a
//   zeroed global result with two atomics each (about 1.3M contended
//   atomics at 1M rows over 4,096 keys), the two fills and the cast.
// - K > kSharedKeys (no path uses it): the histogram does not fit, and
//   keys spread thin enough that global atomics contend little: zero a
//   [K] double and a [K] u64 scratch, grid sync, add with global
//   atomics, grid sync, round into the outputs.
// What bounds it beside the input bytes: the shared-memory atomics of
// the row pass (two a row), the partials' traffic through L2 and the
// grid sync.
//
// B2's design, groupby_bounded_kernel, is B3's first branch without the
// counts (32 KB of histogram at K = 4096).
//
// Sums accumulate in double and are rounded once to float32: atomics make
// the order of the adds vary from run to run, and the double accumulator
// keeps that variation far below the float32 rounding of the result (the
// references' tolerances, rtol 2e-6 / atol 1e-3 for B3 and 1e-4 for B2,
// cover it). Counts are exact integers: u32 per block (a block sees far
// fewer than 2^32 rows), 64-bit in the result.

#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 512;  // B2's block
constexpr int kMaxDevices = 64;

// B3's domain cap (hopper_kernels.MAX_KEYS), the largest domain that
// takes the shared histogram, its block (one a SM), the cap on its
// partials and rows a thread loads before it adds them
constexpr int64_t kOuterKeys = 65536;
constexpr int64_t kSharedKeys = 8192;
constexpr int kOuterThreads = 1024;
constexpr int kOuterBlocksPerSM = 1;
constexpr int64_t kPartialBytes = 16 << 20;
constexpr int kUnroll = 4;
constexpr size_t kBytesPerKey = sizeof(double) + sizeof(unsigned int);

// B3 in one cooperative launch (see the note at the top). psum and pcnt
// are [grid, K] partials (K <= kSharedKeys) or a [K] double and a [K]
// u64 scratch (K > kSharedKeys); partials written by other blocks are
// read with __ldcg (L2), never from a line an SM's L1 may hold.
template <typename KeyT>
__global__ void __launch_bounds__(kOuterThreads, kOuterBlocksPerSM)
    groupby_outer_kernel(const KeyT* __restrict__ keys, const float* __restrict__ vals,
                         double* psum, unsigned int* pcnt, float* __restrict__ sums,
                         long long* __restrict__ counts, int64_t n, int64_t K) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (K > kSharedKeys) {
    unsigned long long* gcnt = reinterpret_cast<unsigned long long*>(pcnt);
    for (int64_t k = tid; k < K; k += stride) {
      psum[k] = 0.0;
      gcnt[k] = 0ull;
    }
    grid.sync();
    for (int64_t i0 = tid; i0 < n; i0 += stride * kUnroll) {
      int64_t k[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = i0 + u * stride;
        k[u] = i < n ? (int64_t)keys[i] : -1;
        v[u] = i < n ? vals[i] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (k[u] >= 0 && k[u] < K) {
          atomicAdd(&psum[k[u]], (double)v[u]);
          atomicAdd(&gcnt[k[u]], 1ull);
        }
    }
    grid.sync();
    for (int64_t k = tid; k < K; k += stride) {
      sums[k] = (float)__ldcg(&psum[k]);
      counts[k] = (long long)__ldcg(&gcnt[k]);
    }
    return;
  }

  extern __shared__ __align__(8) unsigned char smem[];
  double* s_sum = reinterpret_cast<double*>(smem);
  unsigned int* s_cnt = reinterpret_cast<unsigned int*>(s_sum + K);
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) {
    s_sum[k] = 0.0;
    s_cnt[k] = 0u;
  }
  __syncthreads();
  for (int64_t i0 = tid; i0 < n; i0 += stride * kUnroll) {
    int64_t k[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      k[u] = i < n ? (int64_t)keys[i] : -1;
      v[u] = i < n ? vals[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k[u] >= 0 && k[u] < K) {
        atomicAdd(&s_sum[k[u]], (double)v[u]);
        atomicAdd(&s_cnt[k[u]], 1u);
      }
  }
  __syncthreads();
  double* my_sum = psum + (int64_t)blockIdx.x * K;
  unsigned int* my_cnt = pcnt + (int64_t)blockIdx.x * K;
  for (int64_t k = threadIdx.x; k < K; k += blockDim.x) {
    my_sum[k] = s_sum[k];
    my_cnt[k] = s_cnt[k];
  }
  grid.sync();

  const int64_t G = gridDim.x;
  const int64_t cpb = (K + G - 1) / G;  // columns a block
  const int64_t c0 = (int64_t)blockIdx.x * cpb;
  if (cpb >= blockDim.x) {  // few blocks: a thread a column, down all rows
    for (int64_t c = c0 + threadIdx.x; c < c0 + cpb && c < K; c += blockDim.x) {
      double t = 0.0;
      unsigned long long m = 0ull;
      for (int64_t b = 0; b < G; ++b) {
        t += __ldcg(&psum[b * K + c]);
        m += __ldcg(&pcnt[b * K + c]);
      }
      sums[c] = (float)t;
      counts[c] = (long long)m;
    }
    return;
  }
  // lanes threads a column, lane l summing rows l, l + lanes, ...; then
  // lane 0 adds the lanes' sums in lane order (the shared histogram is
  // done with since the grid sync: its first kOuterThreads x 16 bytes
  // hold the lanes' sums)
  double* l_sum = s_sum;
  unsigned long long* l_cnt = reinterpret_cast<unsigned long long*>(s_sum + blockDim.x);
  const int64_t lanes = blockDim.x / cpb, col = threadIdx.x % cpb, lane = threadIdx.x / cpb;
  const int64_t c = c0 + col;
  double t = 0.0;
  unsigned long long m = 0ull;
  if (lane < lanes && c < K)
    for (int64_t b = lane; b < G; b += lanes) {
      t += __ldcg(&psum[b * K + c]);
      m += __ldcg(&pcnt[b * K + c]);
    }
  l_sum[threadIdx.x] = t;
  l_cnt[threadIdx.x] = m;
  __syncthreads();
  if (lane == 0 && c < K) {
    double sum = 0.0;
    unsigned long long cnt = 0ull;
    for (int64_t l = 0; l < lanes; ++l) {
      sum += l_sum[l * cpb + col];
      cnt += l_cnt[l * cpb + col];
    }
    sums[c] = (float)sum;
    counts[c] = (long long)cnt;
  }
}

size_t outer_smem(int64_t K) {
  if (K > kSharedKeys) return 0;
  return std::max<size_t>((size_t)K * kBytesPerKey, (size_t)kOuterThreads * 16);
}

// the most blocks of groupby_outer_kernel<KeyT> that are co-resident on
// the current device at its largest histogram, capped at
// kOuterBlocksPerSM a SM; asked, with the shared-memory opt-in, once a
// process and a device
std::atomic<int> g_outer_grid[2][kMaxDevices];

template <typename KeyT>
cudaError_t outer_grid(int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = g_outer_grid[sizeof(KeyT) == 8][dev];
  *grid = slot.load(std::memory_order_relaxed);
  if (*grid > 0) return cudaSuccess;
  const size_t smem = outer_smem(kSharedKeys);
  err = cudaFuncSetAttribute(groupby_outer_kernel<KeyT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, groupby_outer_kernel<KeyT>,
                                                      kOuterThreads, smem);
  if (err != cudaSuccess) return err;
  *grid = sms * std::min(per_sm, kOuterBlocksPerSM);
  if (*grid <= 0) return cudaErrorCooperativeLaunchTooLarge;
  slot.store(*grid, std::memory_order_relaxed);
  return cudaSuccess;
}

// grid: at most the co-resident grid and max_blocks (the partials' rows,
// which the wrapper sized by the same caps: a block for each
// kOuterThreads rows, kPartialBytes)
template <typename KeyT>
cudaError_t launch_outer(const void* keys, const void* vals, void* scratch, void* sums,
                         void* counts, int64_t n, int64_t K, int64_t max_blocks, cudaStream_t st) {
  int grid = 0;
  const cudaError_t err = outer_grid<KeyT>(&grid);
  if (err != cudaSuccess) return err;
  const int64_t blocks = std::min<int64_t>(grid, max_blocks);
  const KeyT* k = static_cast<const KeyT*>(keys);
  const float* v = static_cast<const float*>(vals);
  double* ps = static_cast<double*>(scratch);
  unsigned int* pc = reinterpret_cast<unsigned int*>(ps + (K > kSharedKeys ? K : max_blocks * K));
  float* s = static_cast<float*>(sums);
  long long* c = static_cast<long long*>(counts);
  void* args[] = {&k, &v, &ps, &pc, &s, &c, &n, &K};
  return cudaLaunchCooperativeKernel((const void*)groupby_outer_kernel<KeyT>, dim3((unsigned)blocks),
                                     dim3(kOuterThreads), args, outer_smem(K), st);
}

// B2's domain cap (hopper_kernels.MAX_ONEHOT_KEYS) and blocks a SM
constexpr int64_t kOnehotKeys = 4096;
constexpr int kOnehotBlocksPerSM = 2;
constexpr int kOnehotUnroll = 4;  // rows a thread loads before it adds them

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

// B3: keys [n] int32 (key_bytes 4) or int64 (8), vals [n] float32, n >= 1,
// 1 <= K <= 65536; sums [K] float32 and counts [K] int64 need no initial
// value. scratch needs none either: for K <= 8192 it holds the
// [max_blocks, K] float64 partial followed by the [max_blocks, K] u32
// one, above that a [K] float64 and a [K] u64 scratch. One cooperative
// launch on the stream, nothing else.
extern "C" int groupby_sum_outer_launch(const void* keys, int64_t key_bytes, const void* vals,
                                        void* scratch, void* sums, void* counts, int64_t n,
                                        int64_t K, int64_t max_blocks, void* stream) {
  if (n < 1 || K < 1 || K > kOuterKeys || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      key_bytes == 8
          ? launch_outer<int64_t>(keys, vals, scratch, sums, counts, n, K, max_blocks, st)
          : launch_outer<int32_t>(keys, vals, scratch, sums, counts, n, K, max_blocks, st);
  if (err != cudaSuccess) return (int)err;
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
