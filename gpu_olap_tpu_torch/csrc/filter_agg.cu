// Fused WHERE <filt> <op> <thr> + global COUNT / SUM / MIN / MAX over int32
// lanes, for Hopper (sm_90a).
//
// Replaces: gpu_olap_tpu/ops/pallas/filter_agg.py, _filter_agg_kernel
// (reached through filter_agg_i32).
//
// Bound on the card: device-memory bytes.  The kernel reads 4 bytes per row
// per distinct input stream (the filter column plus each value column that
// is not a stream already read) and does a handful of integer operations per
// row, far below the card's compute rate.
//
// Design:
//   - One kernel per (operator, number of distinct streams): a template and
//     a dispatch table.  The row loop tests no runtime operator or column
//     count, and holds one accumulator set (SUM, MIN, MAX) per distinct
//     stream only.  Value columns that share a pointer with the filter or
//     with each other are read once and map to the same accumulators.
//   - Each thread keeps kUnroll independent 16-byte loads per stream in
//     flight (scalar loads, 4 x as many, when a stream is not 16-byte
//     aligned), and the grid is one whole wave: every block resident on the
//     132 SMs at once, striding over the rows.
//   - Blocks reduce by warp shuffles and shared memory into one partial
//     record each; the last block to finish (ordered by a counter) folds the
//     partials and writes every output, then sets the counter back to zero.
//     Nothing is pre-filled by the caller and nothing else launches.
// COUNT and SUM are exact 64-bit integers (the TPU kernel's 16-bit split and
// emulated (hi, lo) sums are gone).  Rows at or past n_valid are never read.
// With no matching row, SUM is 0, MIN INT32_MAX and MAX INT32_MIN; a lane not
// wanted keeps those identities.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 8;  // filter_agg.py MAX_COLS matches this
constexpr int kMaxStreams = kMaxCols + 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight per stream per thread
constexpr int kMaxBlocksPerSm = 2048 / kThreads;
constexpr int kRecWords = 1 + 2 * kMaxStreams;  // count, (sum, min|max) each
constexpr int kOps = 6;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const int32_t* streams[kMaxStreams];  // [0] is the filter
  int col_stream[kMaxCols];             // value column -> its stream
  int n_cols;
  int32_t thr;
  long long n;  // rows to scan (n_valid)
  bool vec;     // every stream 16-byte aligned
  unsigned want_sum;  // bit k: column k's SUM is needed
  unsigned want_mm;   // bit k: column k's MIN/MAX are needed
  long long* partials;  // kRecWords per block
  unsigned* done;       // zero at launch; the last block sets it back to zero
  long long* count;
  long long* sums;
  int32_t* mins;
  int32_t* maxs;
};

template <int OP>
__device__ __forceinline__ bool pred(int32_t f, int32_t t) {
  if constexpr (OP == 0) return f > t;
  if constexpr (OP == 1) return f >= t;
  if constexpr (OP == 2) return f < t;
  if constexpr (OP == 3) return f <= t;
  if constexpr (OP == 4) return f == t;
  return f != t;
}

template <int NS>
struct Acc {
  unsigned cnt;  // per thread: at most n / (grid threads) + 16 rows
  long long sum[NS];
  int32_t mn[NS];
  int32_t mx[NS];
};

template <int OP, int NS>
__device__ __forceinline__ void take(Acc<NS>& a, const int32_t (&x)[NS],
                                     int32_t thr, bool ok) {
  const bool m = ok && pred<OP>(x[0], thr);
  a.cnt += m;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    a.sum[s] += m ? x[s] : 0;
    a.mn[s] = min(a.mn[s], m ? x[s] : INT_MAX);
    a.mx[s] = max(a.mx[s], m ? x[s] : INT_MIN);
  }
}

__device__ __forceinline__ int32_t lane_of(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int NS>
__device__ __forceinline__ void warp_reduce(Acc<NS>& a,
                                            unsigned long long& cnt) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(kFull, cnt, off);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      a.sum[s] += __shfl_down_sync(kFull, a.sum[s], off);
      a.mn[s] = min(a.mn[s], __shfl_down_sync(kFull, a.mn[s], off));
      a.mx[s] = max(a.mx[s], __shfl_down_sync(kFull, a.mx[s], off));
    }
  }
}

__device__ __forceinline__ long long pack_mm(int32_t mn, int32_t mx) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(mx)) << 32) |
      static_cast<unsigned>(mn));
}

template <int OP, int NS>
__global__ void __launch_bounds__(kThreads) filter_agg_kernel(Params p) {
  Acc<NS> a;
  a.cnt = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    a.sum[s] = 0;
    a.mn[s] = INT_MAX;
    a.mx[s] = INT_MIN;
  }
  const int t = threadIdx.x;
  if (p.vec) {
    const long long n4 = p.n >> 2;
    const long long chunk = static_cast<long long>(kThreads) * kUnroll;
    for (long long c0 = blockIdx.x * chunk; c0 < n4;
         c0 += static_cast<long long>(gridDim.x) * chunk) {
      int4 x[NS][kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = c0 + u * kThreads + t;
#pragma unroll
        for (int s = 0; s < NS; ++s)
          x[s][u] = j < n4 ? __ldg(reinterpret_cast<const int4*>(p.streams[s]) + j)
                           : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = c0 + u * kThreads + t < n4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int32_t r[NS];
#pragma unroll
          for (int s = 0; s < NS; ++s) r[s] = lane_of(x[s][u], e);
          take<OP, NS>(a, r, p.thr, ok);
        }
      }
    }
    // the last n % 4 rows
    if (blockIdx.x == 0 && t < (p.n & 3)) {
      int32_t r[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) r[s] = __ldg(p.streams[s] + n4 * 4 + t);
      take<OP, NS>(a, r, p.thr, true);
    }
  } else {
    constexpr int kRows = 4 * kUnroll;
    const long long chunk = static_cast<long long>(kThreads) * kRows;
    for (long long c0 = blockIdx.x * chunk; c0 < p.n;
         c0 += static_cast<long long>(gridDim.x) * chunk) {
      int32_t x[NS][kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const long long i = c0 + u * kThreads + t;
#pragma unroll
        for (int s = 0; s < NS; ++s)
          x[s][u] = i < p.n ? __ldg(p.streams[s] + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        int32_t r[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) r[s] = x[s][u];
        take<OP, NS>(a, r, p.thr, c0 + u * kThreads + t < p.n);
      }
    }
  }

  // block partial
  unsigned long long cnt = a.cnt;
  warp_reduce<NS>(a, cnt);
  __shared__ unsigned long long s_cnt[kWarps];
  __shared__ long long s_sum[kWarps][NS];
  __shared__ int32_t s_mn[kWarps][NS];
  __shared__ int32_t s_mx[kWarps][NS];
  __shared__ bool s_last;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (lane == 0) {
    s_cnt[warp] = cnt;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      s_sum[warp][s] = a.sum[s];
      s_mn[warp][s] = a.mn[s];
      s_mx[warp][s] = a.mx[s];
    }
  }
  __syncthreads();
  if (t == 0) {
    long long* rec = p.partials + static_cast<long long>(blockIdx.x) * kRecWords;
    unsigned long long c = 0;
    for (int w = 0; w < kWarps; ++w) c += s_cnt[w];
    __stcg(rec, static_cast<long long>(c));
    for (int s = 0; s < NS; ++s) {
      long long sum = 0;
      int32_t mn = INT_MAX, mx = INT_MIN;
      for (int w = 0; w < kWarps; ++w) {
        sum += s_sum[w][s];
        mn = min(mn, s_mn[w][s]);
        mx = max(mx, s_mx[w][s]);
      }
      __stcg(rec + 1 + 2 * s, sum);
      __stcg(rec + 2 + 2 * s, pack_mm(mn, mx));
    }
    __threadfence();
    s_last = atomicAdd(p.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block folds every block's partial and writes the outputs
  __threadfence();
  a.cnt = 0;
  cnt = 0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    a.sum[s] = 0;
    a.mn[s] = INT_MAX;
    a.mx[s] = INT_MIN;
  }
  for (int b = t; b < static_cast<int>(gridDim.x); b += kThreads) {
    const long long* rec = p.partials + static_cast<long long>(b) * kRecWords;
    cnt += static_cast<unsigned long long>(__ldcg(rec));
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      a.sum[s] += __ldcg(rec + 1 + 2 * s);
      const unsigned long long mm =
          static_cast<unsigned long long>(__ldcg(rec + 2 + 2 * s));
      a.mn[s] = min(a.mn[s], static_cast<int32_t>(static_cast<unsigned>(mm)));
      a.mx[s] = max(a.mx[s], static_cast<int32_t>(static_cast<unsigned>(mm >> 32)));
    }
  }
  warp_reduce<NS>(a, cnt);
  __syncthreads();
  if (lane == 0) {
    s_cnt[warp] = cnt;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      s_sum[warp][s] = a.sum[s];
      s_mn[warp][s] = a.mn[s];
      s_mx[warp][s] = a.mx[s];
    }
  }
  __syncthreads();
  if (t == 0) {
    unsigned long long c = 0;
    for (int w = 0; w < kWarps; ++w) c += s_cnt[w];
    *p.count = static_cast<long long>(c);
    for (int k = 0; k < p.n_cols; ++k) {
      const int s = p.col_stream[k];
      long long sum = 0;
      int32_t mn = INT_MAX, mx = INT_MIN;
      for (int w = 0; w < kWarps; ++w) {
        sum += s_sum[w][s];
        mn = min(mn, s_mn[w][s]);
        mx = max(mx, s_mx[w][s]);
      }
      const bool ws = (p.want_sum >> k) & 1u;
      const bool wm = (p.want_mm >> k) & 1u;
      p.sums[k] = ws ? sum : 0;
      p.mins[k] = wm ? mn : INT_MAX;
      p.maxs[k] = wm ? mx : INT_MIN;
    }
    *p.done = 0;  // ready for the next launch on this stream
  }
}

using Kernel = void (*)(Params);

#define OLAP_FA_ROW(OP)                                                      \
  {filter_agg_kernel<OP, 1>, filter_agg_kernel<OP, 2>,                      \
   filter_agg_kernel<OP, 3>, filter_agg_kernel<OP, 4>,                      \
   filter_agg_kernel<OP, 5>, filter_agg_kernel<OP, 6>,                      \
   filter_agg_kernel<OP, 7>, filter_agg_kernel<OP, 8>,                      \
   filter_agg_kernel<OP, 9>}

const Kernel kKernels[kOps][kMaxStreams] = {
    OLAP_FA_ROW(0), OLAP_FA_ROW(1), OLAP_FA_ROW(2),
    OLAP_FA_ROW(3), OLAP_FA_ROW(4), OLAP_FA_ROW(5)};

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

// bytes of the per-block partial records one launch may use
extern "C" long long olap_filter_agg_partials_bytes() {
  return static_cast<long long>(sm_count()) * kMaxBlocksPerSm * kRecWords *
         static_cast<long long>(sizeof(long long));
}

// partials: olap_filter_agg_partials_bytes() bytes, any content.  done: one
// unsigned int that is zero, owned by this stream (the kernel leaves it
// zero).  Outputs need no initialisation: count (1), sums, mins and maxs
// (n_cols each) are all written.  Returns cudaGetLastError() after the
// launch.
extern "C" int olap_filter_agg_i32(const void* filt, const void* const* cols,
                                   int n_cols, int op, int thr, long long n,
                                   unsigned want_sum, unsigned want_mm,
                                   void* partials, void* done, void* count,
                                   void* sums, void* mins, void* maxs,
                                   void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || op < 0 || op >= kOps || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.streams[0] = static_cast<const int32_t*>(filt);
  int ns = 1;
  for (int k = 0; k < n_cols; ++k) {
    const int32_t* c = static_cast<const int32_t*>(cols[k]);
    int s = 0;
    while (s < ns && p.streams[s] != c) ++s;
    if (s == ns) p.streams[ns++] = c;
    p.col_stream[k] = s;
  }
  p.vec = true;
  for (int s = 0; s < ns; ++s)
    p.vec = p.vec && (reinterpret_cast<uintptr_t>(p.streams[s]) & 15) == 0;
  p.n_cols = n_cols;
  p.thr = thr;
  p.n = n;
  p.want_sum = want_sum;
  p.want_mm = want_mm;
  p.partials = static_cast<long long*>(partials);
  p.done = static_cast<unsigned*>(done);
  p.count = static_cast<long long*>(count);
  p.sums = static_cast<long long*>(sums);
  p.mins = static_cast<int32_t*>(mins);
  p.maxs = static_cast<int32_t*>(maxs);

  const Kernel kernel = kKernels[op][ns - 1];
  static int occupancy[kOps][kMaxStreams];  // blocks per SM, 0 = not asked
  int& occ = occupancy[op][ns - 1];
  if (occ == 0) {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, reinterpret_cast<const void*>(kernel), kThreads, 0);
    occ = b < 1 ? 1 : (b > kMaxBlocksPerSm ? kMaxBlocksPerSm : b);
  }
  const long long rows_per_block = static_cast<long long>(kThreads) * kUnroll * 4;
  const long long want = (n + rows_per_block - 1) / rows_per_block;
  const long long wave = static_cast<long long>(sm_count()) * occ;
  const int blocks = static_cast<int>(want < wave ? want : wave);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
