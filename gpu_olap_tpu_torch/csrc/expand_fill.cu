// Run-length decode of join match records into per-slot int32 streams, for
// Hopper (sm_90a).
//
// Replaces: gpu_olap_tpu/ops/pallas/join_stream.py, _expand_kernel (reached
// through expand_fill_i32).
//
// Contract (the same as the TPU kernel's): record r owns the output slots
// from starts[r] up to the next record's start.  Live starts increase
// strictly; pad records hold INT32_MAX and are never chosen.  Per slot s the
// owner is the last record with starts[r] <= s; the kernel writes
// off[s] = s - starts[r] and out_k[s] = in_k[r] for every stream k.  Slots
// past the last live record's run therefore replicate the last record.  A
// slot before every start (only when no record starts at 0) gets off = s and
// zeros.
//
// Bound on the card: device-memory bytes written, (1 + streams) * 4 per slot;
// the record reads are nearly sequential and mostly hit L2.
//
// Design: the TPU kernel routes records to their run starts through a
// butterfly and carries the open record across sequential grid steps.  Here
// every output slot finds its record by binary search, in two launches:
//   1. expand_bounds_kernel: for every block of kTile slots, the record that
//      owns its first slot (one global binary search per block, all blocks in
//      parallel), plus the owner of the last slot.
//   2. expand_fill_kernel: a block loads the starts of the records that can
//      own its slots (at most kTile + 1, between its bound and the next
//      block's) into shared memory; each thread then binary-searches its
//      slots there and writes them.  Slots are laid out so that neighbouring
//      threads write neighbouring slots.
// Up to kMaxStreams streams travel in one launch as a by-value struct; more
// streams take more fill launches.  The 2048-slot granularity and the
// 2304-record read-window headroom of the TPU kernel are gone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxStreams = 8;

struct Fill {
  const int32_t* in[kMaxStreams];
  int32_t* out[kMaxStreams];
};

// The last record r in [0, m) with starts[r] <= s, or -1.
__device__ __forceinline__ int owner(const int32_t* starts, int m,
                                     long long s) {
  int lo = 0, hi = m;  // upper bound: first r with starts[r] > s
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(starts + mid) <= s)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo - 1;
}

__global__ void expand_bounds_kernel(const int32_t* starts, int m,
                                     long long cap, int n_blocks, int* bound) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b > n_blocks) return;
  const long long s = b < n_blocks ? static_cast<long long>(b) * kTile
                                   : cap - 1;
  bound[b] = owner(starts, m, s);
}

__global__ void __launch_bounds__(kThreads)
expand_fill_kernel(const int32_t* starts, const int* bound, long long cap,
                   int32_t* off, Fill f, int nstr) {
  __shared__ int32_t s_start[kTile + 1];
  const long long s0 = static_cast<long long>(blockIdx.x) * kTile;
  const int r0 = bound[blockIdx.x];
  const int wb = r0 < 0 ? 0 : r0;
  // records that may own this block's slots; the clamp only bites on starts
  // that do not increase (outside the contract) and keeps s_start in bounds
  int wn = bound[blockIdx.x + 1] - wb + 1;
  if (wn > kTile + 1) wn = kTile + 1;
  for (int k = threadIdx.x; k < wn; k += kThreads)
    s_start[k] = __ldg(starts + wb + k);
  __syncthreads();
  for (int j = 0; j < kItems; ++j) {
    const long long s = s0 + j * kThreads + threadIdx.x;
    if (s >= cap) break;
    int lo = 0, hi = wn;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_start[mid] <= s)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int k = lo - 1;
    if (k >= 0) {
      const int r = wb + k;
      if (off != nullptr) off[s] = static_cast<int32_t>(s - s_start[k]);
#pragma unroll
      for (int q = 0; q < kMaxStreams; ++q)
        if (q < nstr) f.out[q][s] = __ldg(f.in[q] + r);
    } else {
      if (off != nullptr) off[s] = static_cast<int32_t>(s);
#pragma unroll
      for (int q = 0; q < kMaxStreams; ++q)
        if (q < nstr) f.out[q][s] = 0;
    }
  }
}

}  // namespace

extern "C" int olap_expand_fill_tile() { return kTile; }

// starts and the nstr input streams hold m int32; off and the nstr output
// streams hold cap int32 (ins/outs are host arrays of device pointers).
// bound holds ceil(cap / kTile) + 1 ints of scratch.  Returns
// cudaGetLastError() after the last launch.
extern "C" int olap_expand_fill_i32(const void* starts, long long m,
                                    long long cap, const void* const* ins,
                                    void* const* outs, int nstr, void* off,
                                    void* bound, void* stream) {
  if (m < 0 || m >= (1LL << 31) - 1 || cap <= 0 || cap >= (1LL << 31) - 1 ||
      nstr < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = static_cast<int>((cap + kTile - 1) / kTile);
  const int32_t* sp = static_cast<const int32_t*>(starts);
  int* bd = static_cast<int*>(bound);
  expand_bounds_kernel<<<(n_blocks + 1 + kThreads - 1) / kThreads, kThreads,
                         0, st>>>(sp, static_cast<int>(m), cap, n_blocks, bd);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  int32_t* o = static_cast<int32_t*>(off);
  int g = 0;
  do {  // the first launch also writes off; nstr == 0 still writes it
    Fill f{};
    const int k = nstr - g < kMaxStreams ? nstr - g : kMaxStreams;
    for (int j = 0; j < k; ++j) {
      f.in[j] = static_cast<const int32_t*>(ins[g + j]);
      f.out[j] = static_cast<int32_t*>(outs[g + j]);
    }
    expand_fill_kernel<<<n_blocks, kThreads, 0, st>>>(sp, bd, cap, o, f, k);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    o = nullptr;
    g += kMaxStreams;
  } while (g < nstr);
  return 0;
}
