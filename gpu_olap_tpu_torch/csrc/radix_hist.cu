// 256-bin histogram of (key >> shift) & 0xFF over int32 keys, for Hopper
// (sm_90a).
//
// Replaces: gpu_olap_tpu/ops/pallas/partition.py:25, _hist_kernel (reached
// through radix_histogram_i32).
//
// Bound on the card: device-memory bytes, 4 per key read once, whatever the
// keys are.  What stands in the way is the count itself: shared-memory
// atomics cost one instruction per distinct bin a warp meets (with a match
// before them to merge equal bins) and conflict on banks when bins spread,
// so a count of that kind runs at 15-74 % of the bound depending on the data.
//
// Design: thread-private packed counters, no atomics and no match.
//   - Each thread owns a column of 64 32-bit words in dynamic shared memory,
//     word [bin >> 2][thread], each word four 8-bit counters.  A key adds one
//     to byte (bin & 3) of its word in its thread's column.  Every access of
//     a warp falls in bank (thread % 32), so one bin or 256 bins cost the
//     same: a load, an add and a store per key, and one OR that marks the
//     key's pair of rows as touched.
//   - A block is three groups of 256 threads (192 KB of counters: one block
//     per SM, 24 warps).  Before any counter can pass 255 (every 15
//     iterations of 16 keys) a group flushes, at its own named barrier and at
//     staggered iterations, so the other groups keep loading meanwhile: each
//     thread sums a quarter row of 64 words in two 16-bit pair lanes
//     (rotated so a warp's reads hit 32 banks) if the group touched that row,
//     four neighbouring lanes combine by shuffles, and the thread adds one
//     bin's count to its 32-bit total and clears the words.  Clustered keys
//     (the shuffle's partition ids) touch one or two row pairs, so their
//     flushes read almost nothing.
//   - Loads: four 16-byte loads a thread for the next iteration are in
//     flight while the current one counts (and flushes), grid-stride over
//     the 16-byte aligned body; a scalar head up to the first 16-byte
//     address and a scalar ragged tail.  The grid is one wave.
//   - Each block writes its 256 totals and a mask of its touched rows to
//     scratch; the last block to finish (ordered by a counter it sets back
//     to zero) folds the marked rows into the 256 int64 outputs.  Nothing is
//     pre-filled by the caller, no global atomics add counts, and the counts
//     do not depend on block order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 768;  // three groups of 256: one block per SM
constexpr int kGroups = kThreads / kBins;  // 256 columns flushed together
constexpr int kRows = kBins / 4;  // four 8-bit counters per 32-bit word
constexpr int kUnroll = 4;        // 16-byte loads in flight per thread
constexpr int kKeysPerIter = 4 * kUnroll;
// a counter takes at most kKeysPerIter keys an iteration, plus one head or
// tail key before the last flush: 15 * 16 + 1 = 241 < 256
constexpr int kItersPerFlush = (255 - 1) / kKeysPerIter;
constexpr int kSmemBytes = kRows * kThreads * 4;
constexpr int kFoldRows = kThreads / 64;  // blocks one fold step reads
constexpr int kMaxDevices = 64;
// the fold keeps one mask per block in the counters' shared memory, past
// its kFoldRows rows of 256 int64
constexpr int kMaxBlocks = kSmemBytes / 4 - kFoldRows * kBins * 2;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads % kBins == 0, "whole groups of 256 threads");
static_assert(kItersPerFlush * kKeysPerIter + 1 <= 255, "8-bit counters");
static_assert(kFoldRows * kBins * 8 < kSmemBytes, "fold fits the counters");

// one key: byte (b & 3) of word [b >> 2][thread] of the thread's column;
// bit k of `touched` marks the pair of rows that holds bins 8k .. 8k + 7
__device__ __forceinline__ void count_key(unsigned char* col, unsigned& touched,
                                          int32_t key, int shift) {
  // arithmetic shift of the signed key, as JAX shifts int32
  const unsigned b = static_cast<unsigned>(key >> shift);
  col[(b & 0xFCu) * kThreads + (b & 3u)] += 1;
  touched |= 1u << ((b >> 3) & 31u);
}

__device__ __forceinline__ void count4(unsigned char* col, unsigned& touched,
                                       const int4& v, int shift) {
  count_key(col, touched, v.x, shift);
  count_key(col, touched, v.y, shift);
  count_key(col, touched, v.z, shift);
  count_key(col, touched, v.w, shift);
}

// the barrier of group t / 256 alone (ids 1..kGroups; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int t) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + t / kBins), "r"(kBins) : "memory");
}

// The row pairs any thread of group t / 256 touched since its last flush,
// then the group's barrier.  Each warp posts its OR in its own slot: a slot
// is read only between this barrier and the flush's closing one, and
// written again only after that.
__device__ __forceinline__ unsigned group_rows(unsigned* s_warp,
                                               unsigned touched, int t) {
  const unsigned w = __reduce_or_sync(kFull, touched);
  if ((t & 31) == 0) s_warp[t >> 5] = w;
  group_sync(t);
  const unsigned* g = s_warp + (t / kBins) * (kBins / 32);
  unsigned rows = 0;
#pragma unroll
  for (int i = 0; i < kBins / 32; ++i) rows |= g[i];
  return rows;
}

// Bin (t % 256)'s count over group (t / 256)'s 256 columns since the last
// flush; clears those counters when CLEAR.  Rows outside `rows` hold zeros
// and are not read.  Call after group_rows, before the group's barrier.
template <bool CLEAR>
__device__ __forceinline__ unsigned flush(unsigned* words, int t,
                                          unsigned rows) {
  const int tl = t & (kBins - 1);
  const int q = tl & 3;
  unsigned lo = 0, hi = 0;  // bytes 0 and 2, bytes 1 and 3: 16-bit lanes
  if ((rows >> (tl >> 3)) & 1u) {
    unsigned* quarter = words + (tl >> 2) * kThreads + (t - tl) + q * 64;
#pragma unroll 16
    for (int j = 0; j < 64; ++j) {
      // rotated by t: a warp's 32 reads hit 32 different banks
      unsigned* w = quarter + ((j + t) & 63);
      const unsigned v = *w;
      if (CLEAR) *w = 0;
      lo += v & 0x00FF00FFu;  // at most 64 * 255 per lane
      hi += (v >> 8) & 0x00FF00FFu;
    }
  }
  // the four quarters of a row are neighbouring lanes: 256 * 255 < 2^16
  lo += __shfl_xor_sync(kFull, lo, 1);
  hi += __shfl_xor_sync(kFull, hi, 1);
  lo += __shfl_xor_sync(kFull, lo, 2);
  hi += __shfl_xor_sync(kFull, hi, 2);
  const unsigned pair = (q & 1) ? hi : lo;
  return (q & 2) ? pair >> 16 : pair & 0xFFFFu;  // bin 4 * row + q == tl
}

__device__ __forceinline__ void load(int4 (&v)[kUnroll], const int4* k4,
                                     long long c0, long long end, int t) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = c0 + u * kThreads + t;
    v[u] = j < end ? __ldg(k4 + j) : make_int4(0, 0, 0, 0);
  }
}

// partials: gridDim.x rows of 256 totals, then gridDim.x row-pair masks
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const int32_t* __restrict__ keys, long long head,
                  long long n4, int tail, int shift,
                  unsigned* __restrict__ partials, unsigned* done,
                  long long* __restrict__ hist) {
  extern __shared__ unsigned s_words[];  // [kRows][kThreads]
  __shared__ unsigned s_warp[kThreads / 32];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int4* k4 = reinterpret_cast<const int4*>(keys + head);
  const long long chunk = static_cast<long long>(kThreads) * kUnroll;
  const long long first = blockIdx.x * chunk, end = n4;
  const long long step = static_cast<long long>(gridDim.x) * chunk;
  // cur is counted while next is in flight
  int4 cur[kUnroll], next[kUnroll];
  load(cur, k4, first, end, t);
  // the first loads are in flight while the column clears
#pragma unroll
  for (int r = 0; r < kRows; ++r) s_words[r * kThreads + t] = 0;
  unsigned char* col = reinterpret_cast<unsigned char*>(s_words + t);
  unsigned total = 0;    // bin t % 256's count in this block's group t / 256
  unsigned touched = 0;  // row pairs this thread counted into since a flush
  unsigned ever = 0;     // row pairs its group counted into

  // until a flush each thread touches only its own column: no barrier.  The
  // groups flush at staggered iterations, so while one flushes the others
  // keep loading; every thread of a group runs the same trip count.
  int iters = (t / kBins) * kItersPerFlush / kGroups;
  for (long long c0 = first; c0 < end; c0 += step) {
    load(next, k4, c0 + step, end, t);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c0 + u * kThreads + t < end) count4(col, touched, cur[u], shift);
    if (++iters == kItersPerFlush) {
      iters = 0;
      const unsigned rows = group_rows(s_warp, touched, t);
      total += flush<true>(s_words, t, rows);
      ever |= rows;
      touched = 0;
      group_sync(t);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = next[u];
  }
  // the scalar head (before the first 16-byte address) and tail
  if (blockIdx.x == 0) {
    if (t < head)
      count_key(col, touched, __ldg(keys + t), shift);
    else if (t >= 4 && t < 4 + tail)
      count_key(col, touched, __ldg(keys + head + n4 * 4 + (t - 4)), shift);
  }
  const unsigned rows = group_rows(s_warp, touched, t);
  total += flush<false>(s_words, t, rows);
  ever |= rows;
  // the groups' totals and row masks meet in thread t % 256 and thread 0
  __syncthreads();
  s_words[t] = total;
  if ((t & 31) == 0) s_warp[t >> 5] = ever;
  __syncthreads();
  unsigned* masks = partials + static_cast<long long>(gridDim.x) * kBins;
  if (t < kBins) {
    for (int g = 1; g < kGroups; ++g) total += s_words[g * kBins + t];
    __stcg(partials + static_cast<long long>(blockIdx.x) * kBins + t, total);
  }
  if (t == 0) {
    unsigned m = 0;
    for (int w = 0; w < kThreads / 32; ++w) m |= s_warp[w];
    __stcg(masks + blockIdx.x, m);
  }
  if (t < kBins) __threadfence();  // the threads that stored
  __syncthreads();
  if (t == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block folds every block's totals: 16-byte loads, thread t
  // takes row (bins 4 * (t % 64) .. + 3) of every kFoldRows-th block from
  // t / 64, where that block's mask marks the row
  __threadfence();
  unsigned* s_mask = s_words + kFoldRows * kBins * 2;  // past the fold rows
  for (int b = t; b < static_cast<int>(gridDim.x); b += kThreads)
    s_mask[b] = __ldcg(masks + b);
  __syncthreads();
  const int c4 = t & 63;
  unsigned long long acc[4] = {0, 0, 0, 0};
  const uint4* p4 = reinterpret_cast<const uint4*>(partials);
#pragma unroll 8
  for (int b = t >> 6; b < static_cast<int>(gridDim.x); b += kFoldRows) {
    if ((s_mask[b] >> (c4 >> 1)) & 1u) {
      const uint4 x =
          __ldcg(p4 + static_cast<long long>(b) * (kBins / 4) + c4);
      acc[0] += x.x;
      acc[1] += x.y;
      acc[2] += x.z;
      acc[3] += x.w;
    }
  }
  unsigned long long* s_fold = reinterpret_cast<unsigned long long*>(s_words);
#pragma unroll
  for (int e = 0; e < 4; ++e) s_fold[(t >> 6) * kBins + 4 * c4 + e] = acc[e];
  __syncthreads();
  if (t < kBins) {
    unsigned long long sum = 0;
#pragma unroll
    for (int r = 0; r < kFoldRows; ++r) sum += s_fold[r * kBins + t];
    hist[t] = static_cast<long long>(sum);
  }
  if (t == 0) *done = 0;  // ready for the next launch on this stream
}

// blocks of one wave on the current device (the kernel's shared-memory
// limit raised on first use there)
int wave_blocks() {
  static int wave[kMaxDevices];  // 0 = not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (wave[dev] == 0) {
    if (cudaFuncSetAttribute(radix_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes) != cudaSuccess)
      return 0;
    int sms = 0, occ = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, radix_hist_kernel,
                                                  kThreads, kSmemBytes);
    const int blocks = (sms > 0 ? sms : 1) * (occ > 0 ? occ : 1);
    wave[dev] = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  }
  return wave[dev];
}

}  // namespace

// bytes of the per-block totals and row masks one launch may use on the
// current device
extern "C" long long olap_radix_hist_scratch_bytes() {
  return static_cast<long long>(wave_blocks()) * (kBins + 1) *
         static_cast<long long>(sizeof(unsigned));
}

// keys one full wave counts between two flushes of its counters: a longer
// input makes every thread flush in the middle of the run
extern "C" long long olap_radix_hist_wave_flush_keys() {
  return static_cast<long long>(wave_blocks()) * kThreads * kItersPerFlush *
         kKeysPerIter;
}

// keys: int32, 4-byte aligned, n > 0.  scratch: olap_radix_hist_scratch_bytes()
// bytes, any content.  done: one unsigned int that is zero, owned by this
// stream (the kernel leaves it zero).  hist: 256 int64, all written.
// Returns cudaGetLastError() after the launch.
extern "C" int olap_radix_hist_i32(const void* keys, long long n, int shift,
                                   void* scratch, void* done, void* hist,
                                   void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(keys);
  if (n <= 0 || shift < 0 || shift > 31 || (addr & 3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wave = wave_blocks();
  if (wave == 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  }
  long long head = static_cast<long long>((16 - (addr & 15)) & 15) / 4;
  if (head > n) head = n;
  const long long n4 = (n - head) / 4;
  const int tail = static_cast<int>((n - head) % 4);
  const long long keys_per_block_iter =
      static_cast<long long>(kThreads) * kKeysPerIter;
  const long long want = (n + keys_per_block_iter - 1) / keys_per_block_iter;
  const int blocks = static_cast<int>(want < wave ? want : wave);
  // a block's totals are 32-bit: it must see fewer than 2^31 keys
  if (n / blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  radix_hist_kernel<<<blocks, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), head, n4, tail, shift,
      static_cast<unsigned*>(scratch), static_cast<unsigned*>(done),
      static_cast<long long*>(hist));
  return static_cast<int>(cudaGetLastError());
}
