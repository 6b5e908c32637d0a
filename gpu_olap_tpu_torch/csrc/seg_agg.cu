// Post-sort segmented aggregation (the GROUP BY pass after the sort) over
// co-sorted int32 (key, value) lanes, for Hopper (sm_90a).
//
// Replaces: gpu_olap_tpu/ops/pallas/seg_agg.py, _seg_agg_kernel (reached
// through seg_agg_sorted_i32).
//
// Contract (the same as the TPU kernel's): keys ascend; values ascend within
// each run of equal keys, so a group's MIN is its first value and its MAX its
// last.  Per group, in key order: key, count (int32), sum (int64), min, max,
// plus the exact number of groups.  Groups at or past max_groups are not
// written, but they are still counted.
//
// Bound on the card: device-memory bytes.  Every pass reads 8 bytes per row
// (key and value); the outputs are 24 bytes per group.
//
// Design: blocks run in no order, so the TPU kernel's sequential carry is
// replaced by three launches.
//   1. seg_count_kernel: per tile of kTile rows, the number of run starts.
//   2. seg_scan_kernel: one block scans the tile counts into each tile's
//      first group id and writes the exact group count.
//   3. seg_agg_kernel: each thread owns kItems consecutive rows.  It writes
//      key and MIN at each run start and MAX at each run end, and adds the
//      run's positions into its count (-start at the start, end + 1 at the
//      end).  Sums are a block-level segmented reduction: a segmented scan
//      over the threads carries the open run's partial sum from thread to
//      thread, and each (block, group) piece is added to the group with one
//      64-bit atomic.  Integer atomics are exact and commutative, so the
//      result does not depend on block order.
// The 16-bit split, the emulated (hi, lo) sums and the butterfly routing of
// the TPU kernel are gone; no padding to a block multiple is needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool run_start(const int32_t* keys, long long i) {
  return i == 0 || __ldg(keys + i) != __ldg(keys + i - 1);
}

// Block-wide exclusive sum of one int per thread; also returns the total.
template <int kN>
__device__ __forceinline__ int block_exclusive_sum(int x, int* total,
                                                   int* s_buf) {
  const int t = threadIdx.x;
  s_buf[t] = x;
  __syncthreads();
  for (int off = 1; off < kN; off <<= 1) {
    int y = t >= off ? s_buf[t - off] : 0;
    __syncthreads();
    s_buf[t] += y;
    __syncthreads();
  }
  int incl = s_buf[t];
  *total = s_buf[kN - 1];
  __syncthreads();
  return incl - x;
}

__global__ void __launch_bounds__(kThreads)
seg_count_kernel(const int32_t* keys, long long n, int* tile_counts) {
  __shared__ int s_buf[kThreads];
  const long long r0 = (long long)blockIdx.x * kTile + threadIdx.x * kItems;
  int c = 0;
  for (int j = 0; j < kItems; ++j) {
    long long i = r0 + j;
    if (i >= n) break;
    c += run_start(keys, i);
  }
  int total;
  block_exclusive_sum<kThreads>(c, &total, s_buf);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
seg_scan_kernel(const int* tile_counts, int n_tiles, int* tile_base,
                int* n_groups) {
  __shared__ int s_buf[kScanThreads];
  int carry = 0;
  for (int b0 = 0; b0 < n_tiles; b0 += kScanThreads) {
    int b = b0 + threadIdx.x;
    int x = b < n_tiles ? tile_counts[b] : 0;
    int total;
    int excl = block_exclusive_sum<kScanThreads>(x, &total, s_buf);
    if (b < n_tiles) tile_base[b] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) *n_groups = carry;
}

struct SegOut {
  int32_t* key;
  int32_t* cnt;
  unsigned long long* sum;  // int64 bit patterns
  int32_t* mn;
  int32_t* mx;
};

__device__ __forceinline__ void add_sum(const SegOut& o, int g, int max_groups,
                                        long long s) {
  if (g >= 0 && g < max_groups && s != 0)
    atomicAdd(o.sum + g, static_cast<unsigned long long>(s));
}

__global__ void __launch_bounds__(kThreads)
seg_agg_kernel(const int32_t* keys, const int32_t* vals, long long n,
               int max_groups, const int* tile_base, SegOut o) {
  __shared__ int s_buf[kThreads];
  __shared__ int s_reset[kThreads];
  __shared__ long long s_x[kThreads];
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kTile + t * kItems;

  // pass 1: this thread's run starts and the sum of its trailing open piece
  int starts = 0;
  long long run = 0;
  for (int j = 0; j < kItems; ++j) {
    long long i = r0 + j;
    if (i >= n) break;
    if (run_start(keys, i)) {
      ++starts;
      run = 0;
    }
    run += __ldg(vals + i);
  }

  int block_starts;
  const int excl_starts = block_exclusive_sum<kThreads>(starts, &block_starts,
                                                         s_buf);

  // inclusive segmented scan over threads of (reset, x): a thread holding a
  // run start resets the carried sum to its own trailing piece
  s_reset[t] = starts > 0;
  s_x[t] = run;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    int r_prev = 0;
    long long x_prev = 0;
    if (t >= off) {
      r_prev = s_reset[t - off];
      x_prev = s_x[t - off];
    }
    __syncthreads();
    if (t >= off) {
      if (!s_reset[t]) s_x[t] += x_prev;
      s_reset[t] |= r_prev;
    }
    __syncthreads();
  }
  // partial sum of the run still open where this thread begins, counted from
  // the start of this block (earlier blocks add their own pieces)
  long long carry = t > 0 ? s_x[t - 1] : 0;

  // pass 2: write the outputs
  int g = tile_base[blockIdx.x] + excl_starts - 1;  // group open at r0
  run = carry;
  for (int j = 0; j < kItems; ++j) {
    long long i = r0 + j;
    if (i >= n) break;
    const int32_t k = __ldg(keys + i);
    const int32_t v = __ldg(vals + i);
    if (i == 0 || k != __ldg(keys + i - 1)) {
      add_sum(o, g, max_groups, run);  // close the previous group's piece
      run = 0;
      ++g;
      if (g < max_groups) {
        o.key[g] = k;
        o.mn[g] = v;
        atomicAdd(o.cnt + g, static_cast<int>(-i));
      }
    }
    run += v;
    if (i == n - 1 || __ldg(keys + i + 1) != k) {
      if (g < max_groups) {
        o.mx[g] = v;
        atomicAdd(o.cnt + g, static_cast<int>(i + 1));
      }
    }
  }
  // the last thread closes the piece still open at the block's end
  if (t == kThreads - 1) add_sum(o, g, max_groups, run);
}

}  // namespace

extern "C" int olap_seg_agg_tile_rows() { return kTile; }

// tile_counts and tile_base hold ceil(n / kTile) ints of scratch; cnt and sum
// must be zeroed by the caller.  Returns cudaGetLastError() after the last
// launch.
extern "C" int olap_seg_agg_i32(const void* keys, const void* vals,
                                long long n, int max_groups, void* tile_counts,
                                void* tile_base, void* okey, void* ocnt,
                                void* osum, void* omin, void* omax,
                                void* n_groups, void* stream) {
  if (n <= 0 || n >= (1LL << 31) - 1 || max_groups < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (n + kTile - 1) / kTile;
  const int32_t* k = static_cast<const int32_t*>(keys);
  const int32_t* v = static_cast<const int32_t*>(vals);
  seg_count_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      k, n, static_cast<int*>(tile_counts));
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  seg_scan_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int*>(tile_counts), static_cast<int>(n_tiles),
      static_cast<int*>(tile_base), static_cast<int*>(n_groups));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  SegOut o{static_cast<int32_t*>(okey), static_cast<int32_t*>(ocnt),
           static_cast<unsigned long long*>(osum),
           static_cast<int32_t*>(omin), static_cast<int32_t*>(omax)};
  seg_agg_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      k, v, n, max_groups, static_cast<const int*>(tile_base), o);
  return static_cast<int>(cudaGetLastError());
}
