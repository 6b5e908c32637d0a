// Fused WHERE <filt> <op> <thr> + global COUNT / SUM / MIN / MAX over int32
// lanes, for Hopper (sm_90a).
//
// Replaces: gpu_olap_tpu/ops/pallas/filter_agg.py, _filter_agg_kernel
// (reached through filter_agg_i32).
//
// Bound on the card: device-memory bytes.  The kernel reads 4 bytes per row
// per distinct input stream (the filter column plus each value column that
// is not the filter column itself) and does a handful of integer operations
// per row, far below the card's compute rate.
//
// Design: one pass, grid-stride, 16-byte vector loads when every stream is
// 16-byte aligned (scalar loads otherwise and for the ragged tail).  Each
// thread accumulates in registers: COUNT and SUM in 64-bit integers, MIN and
// MAX in 32-bit.  A block reduces by warp shuffles and shared memory, then
// folds its partials into the outputs with one integer atomic each.  Integer
// atomics are exact and commutative, so the result does not depend on block
// order.  The TPU kernel's 16-bit split and emulated (hi, lo) sums are gone:
// the card has native 64-bit integer adds.  A value column whose pointer
// equals the filter pointer reuses the filter's registers (read once).
// Rows at or past n_valid are never read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 8;  // filter_agg.py MAX_COLS matches this
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct FilterAggParams {
  const int32_t* filt;
  const int32_t* cols[kMaxCols];
  int n_cols;
  int op;  // 0 gt, 1 ge, 2 lt, 3 le, 4 eq, 5 ne
  int32_t thr;
  long long n;  // rows to scan (n_valid)
  unsigned want_sum;  // bit k: column k's SUM is needed
  unsigned want_mm;   // bit k: column k's MIN/MAX are needed
  unsigned long long* count;
  unsigned long long* sums;  // int64 bit patterns
  int32_t* mins;
  int32_t* maxs;
};

__device__ __forceinline__ bool pred(int op, int32_t f, int32_t t) {
  switch (op) {
    case 0: return f > t;
    case 1: return f >= t;
    case 2: return f < t;
    case 3: return f <= t;
    case 4: return f == t;
    default: return f != t;
  }
}

struct Acc {
  unsigned long long cnt;
  long long sum[kMaxCols];
  int32_t mn[kMaxCols];
  int32_t mx[kMaxCols];
};

__device__ __forceinline__ void take(const FilterAggParams& p, Acc& a,
                                     int32_t f, const int32_t* v) {
  if (!pred(p.op, f, p.thr)) return;
  a.cnt += 1;
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    if (k < p.n_cols) {
      a.sum[k] += v[k];
      a.mn[k] = min(a.mn[k], v[k]);
      a.mx[k] = max(a.mx[k], v[k]);
    }
  }
}

__device__ __forceinline__ void row(const FilterAggParams& p, Acc& a,
                                    long long i) {
  int32_t f = __ldg(p.filt + i);
  int32_t v[kMaxCols];
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    v[k] = 0;
    if (k < p.n_cols)
      v[k] = (p.cols[k] == p.filt) ? f : __ldg(p.cols[k] + i);
  }
  take(p, a, f, v);
}

__global__ void __launch_bounds__(kThreads)
filter_agg_kernel(FilterAggParams p, bool vec) {
  Acc a;
  a.cnt = 0;
#pragma unroll
  for (int k = 0; k < kMaxCols; ++k) {
    a.sum[k] = 0;
    a.mn[k] = INT32_MAX;
    a.mx[k] = INT32_MIN;
  }
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long scalar_from = 0;
  if (vec) {
    const long long n4 = p.n / 4;
    const int4* f4 = reinterpret_cast<const int4*>(p.filt);
    for (long long j = tid; j < n4; j += stride) {
      int4 fv = __ldg(f4 + j);
      int4 cv[kMaxCols];
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) {
        cv[k] = make_int4(0, 0, 0, 0);
        if (k < p.n_cols)
          cv[k] = (p.cols[k] == p.filt)
                      ? fv
                      : __ldg(reinterpret_cast<const int4*>(p.cols[k]) + j);
      }
      int32_t v[kMaxCols];
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) v[k] = cv[k].x;
      take(p, a, fv.x, v);
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) v[k] = cv[k].y;
      take(p, a, fv.y, v);
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) v[k] = cv[k].z;
      take(p, a, fv.z, v);
#pragma unroll
      for (int k = 0; k < kMaxCols; ++k) v[k] = cv[k].w;
      take(p, a, fv.w, v);
    }
    scalar_from = n4 * 4;
  }
  for (long long i = scalar_from + tid; i < p.n; i += stride) row(p, a, i);

  // warp reduction
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a.cnt += __shfl_down_sync(0xffffffffu, a.cnt, off);
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      if (k < p.n_cols) {
        a.sum[k] += __shfl_down_sync(0xffffffffu, a.sum[k], off);
        a.mn[k] = min(a.mn[k], __shfl_down_sync(0xffffffffu, a.mn[k], off));
        a.mx[k] = max(a.mx[k], __shfl_down_sync(0xffffffffu, a.mx[k], off));
      }
    }
  }
  __shared__ unsigned long long s_cnt[kWarps];
  __shared__ long long s_sum[kWarps][kMaxCols];
  __shared__ int32_t s_mn[kWarps][kMaxCols];
  __shared__ int32_t s_mx[kWarps][kMaxCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_cnt[warp] = a.cnt;
#pragma unroll
    for (int k = 0; k < kMaxCols; ++k) {
      s_sum[warp][k] = a.sum[k];
      s_mn[warp][k] = a.mn[k];
      s_mx[warp][k] = a.mx[k];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long cnt = 0;
    for (int w = 0; w < kWarps; ++w) cnt += s_cnt[w];
    if (cnt) atomicAdd(p.count, cnt);
    for (int k = 0; k < p.n_cols; ++k) {
      long long s = 0;
      int32_t mn = INT32_MAX, mx = INT32_MIN;
      for (int w = 0; w < kWarps; ++w) {
        s += s_sum[w][k];
        mn = min(mn, s_mn[w][k]);
        mx = max(mx, s_mx[w][k]);
      }
      if (cnt == 0) continue;
      if (p.want_sum & (1u << k))
        atomicAdd(p.sums + k, static_cast<unsigned long long>(s));
      if (p.want_mm & (1u << k)) {
        atomicMin(p.mins + k, mn);
        atomicMax(p.maxs + k, mx);
      }
    }
  }
}

}  // namespace

// Outputs must be initialised by the caller: count and sums to 0, mins to
// INT32_MAX, maxs to INT32_MIN.  Returns cudaGetLastError() after the launch.
extern "C" int olap_filter_agg_i32(const void* filt, const void* const* cols,
                                   int n_cols, int op, int thr, long long n,
                                   unsigned want_sum, unsigned want_mm,
                                   void* count, void* sums, void* mins,
                                   void* maxs, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || op < 0 || op > 5 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FilterAggParams p{};
  p.filt = static_cast<const int32_t*>(filt);
  bool vec = (reinterpret_cast<uintptr_t>(filt) & 15) == 0;
  for (int k = 0; k < n_cols; ++k) {
    p.cols[k] = static_cast<const int32_t*>(cols[k]);
    vec = vec && (reinterpret_cast<uintptr_t>(cols[k]) & 15) == 0;
  }
  p.n_cols = n_cols;
  p.op = op;
  p.thr = thr;
  p.n = n;
  p.want_sum = want_sum;
  p.want_mm = want_mm;
  p.count = static_cast<unsigned long long*>(count);
  p.sums = static_cast<unsigned long long*>(sums);
  p.mins = static_cast<int32_t*>(mins);
  p.maxs = static_cast<int32_t*>(maxs);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want_blocks = (n / 4 + kThreads - 1) / kThreads;
  long long cap = static_cast<long long>(sms > 0 ? sms : 1) * 8;
  int blocks = static_cast<int>(want_blocks < 1 ? 1
                                : (want_blocks < cap ? want_blocks : cap));
  filter_agg_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p, vec);
  return static_cast<int>(cudaGetLastError());
}
