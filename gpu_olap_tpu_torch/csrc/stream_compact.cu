// Stable stream compaction of int32 streams where a mask is set, for Hopper
// (sm_90a).
//
// Replaces: gpu_olap_tpu/ops/pallas/join_stream.py, _compact_kernel (reached
// through stream_compact_i32).
//
// Contract (the same as the TPU kernel's, for a bool mask): for every
// position i where mask[i] is set, in ascending i, each stream's element i
// goes to the next free output slot.  The count of set positions is exact
// even when it exceeds cap; writes at or past cap are dropped.
//
// Bound on the card: device-memory bytes.  The mask is read twice (count,
// then scatter), every stream once, and each kept element is written once.
//
// Design: blocks run in no order, so the TPU kernel's sequential carry (a
// staging ring flushed from one grid step to the next) is replaced by three
// launches.
//   1. compact_count_kernel: per tile of kTile elements, the number of set
//      mask elements.
//   2. compact_scan_kernel: one block scans the tile counts into each tile's
//      first output slot and writes the exact total.
//   3. compact_scatter_kernel: the block walks its tile in chunks of
//      kThreads consecutive elements.  Per chunk each warp ballots its mask
//      bits; a thread's rank is the popcount of the lanes below it plus the
//      counts of the warps before it (shared memory).  Neighbouring kept
//      elements land in neighbouring slots, so the stores coalesce.
// Up to kMaxStreams streams travel in one launch as a by-value struct of
// pointers; more streams take more scatter launches over the same scan.
// The butterfly routing, the 2048-element granularity and the cap + 2*FLUSH
// output padding of the TPU kernel are gone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 16;
constexpr int kTile = kThreads * kIters;
constexpr int kScanThreads = 1024;
constexpr int kMaxStreams = 8;

struct Streams {
  const int32_t* in[kMaxStreams];
  int32_t* out[kMaxStreams];
};

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
compact_count_kernel(const bool* mask, long long n, int* tile_counts) {
  __shared__ int s_warp[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int c = 0;
  for (int it = 0; it < kIters; ++it) {
    const long long i = base + it * kThreads + threadIdx.x;
    if (i < n && mask[i]) ++c;
  }
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += s_warp[w];
    tile_counts[blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kScanThreads)
compact_scan_kernel(const int* tile_counts, int n_tiles, int* tile_base,
                    int* count) {
  __shared__ int s_buf[kScanThreads];
  int carry = 0;
  for (int b0 = 0; b0 < n_tiles; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const int x = b < n_tiles ? tile_counts[b] : 0;
    int total;
    const int excl = block_exclusive_sum<kScanThreads>(x, &total, s_buf);
    if (b < n_tiles) tile_base[b] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) *count = carry;
}

__global__ void __launch_bounds__(kThreads)
compact_scatter_kernel(const bool* mask, long long n, const int* tile_base,
                       long long cap, Streams s, int nstr) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  long long run = tile_base[blockIdx.x];  // slot of the chunk's first kept
  for (int it = 0; it < kIters; ++it) {
    const long long i = base + it * kThreads + threadIdx.x;
    const bool keep = i < n && mask[i];
    const unsigned bits = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(bits);
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      chunk += c;
    }
    __syncthreads();  // s_warp is rewritten by the next chunk
    if (keep) {
      const long long dst = run + before + __popc(bits & below);
      if (dst < cap) {
#pragma unroll
        for (int k = 0; k < kMaxStreams; ++k)
          if (k < nstr) s.out[k][dst] = __ldg(s.in[k] + i);
      }
    }
    run += chunk;
  }
}

}  // namespace

extern "C" int olap_stream_compact_tile() { return kTile; }

// mask holds n bools.  ins/outs are host arrays of nstr device pointers (n
// and cap int32 each).  tile_counts and tile_base hold ceil(n / kTile) ints
// of scratch; count is one int32.  Returns cudaGetLastError() after the last
// launch.
extern "C" int olap_stream_compact_i32(const void* mask_p, long long n,
                                       const void* const* ins,
                                       void* const* outs, int nstr,
                                       long long cap, void* tile_counts_p,
                                       void* tile_base_p, void* count_p,
                                       void* stream) {
  if (n <= 0 || n >= (1LL << 31) - 1 || cap < 0 || cap >= (1LL << 31) ||
      nstr < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool* mask = static_cast<const bool*>(mask_p);
  int* tile_counts = static_cast<int*>(tile_counts_p);
  int* tile_base = static_cast<int*>(tile_base_p);
  int* count = static_cast<int*>(count_p);
  const long long n_tiles = (n + kTile - 1) / kTile;
  compact_count_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, st>>>(
      mask, n, tile_counts);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  compact_scan_kernel<<<1, kScanThreads, 0, st>>>(
      tile_counts, static_cast<int>(n_tiles), tile_base, count);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  for (int g = 0; g < nstr; g += kMaxStreams) {
    Streams s{};
    const int k = nstr - g < kMaxStreams ? nstr - g : kMaxStreams;
    for (int j = 0; j < k; ++j) {
      s.in[j] = static_cast<const int32_t*>(ins[g + j]);
      s.out[j] = static_cast<int32_t*>(outs[g + j]);
    }
    compact_scatter_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                             st>>>(mask, n, tile_base, cap, s, k);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return 0;
}
