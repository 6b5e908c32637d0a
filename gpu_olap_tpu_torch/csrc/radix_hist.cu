// 256-bin histogram of (key >> shift) & 0xFF over int32 keys, for Hopper
// (sm_90a).
//
// Replaces: gpu_olap_tpu/ops/pallas/partition.py, _hist_kernel (reached
// through radix_histogram_i32).
//
// Bound on the card: device-memory bytes when the keys spread over many
// bins (4 bytes read per key, one pass).  When they pile into a few bins, as
// the shuffle's partition ids do (at most one bin per mesh shard, and every
// key in bin 0 on a one-shard mesh), the limit is shared-memory atomics on
// one address, which serialize.
//
// Design: one pass, grid-stride over 32-key warp chunks, 16-byte vector
// loads when the keys are 16-byte aligned (scalar loads otherwise and for the
// ragged tail).  Each warp owns a 256-bin sub-histogram in shared memory, so
// warps never contend with each other.  Before each shared atomic the lanes
// of a warp that hold the same bin find each other with __match_any_sync and
// the lowest of them adds their count with one atomic: a warp issues one
// atomic per distinct bin and step, 1 when every key lands in one bin and at
// most 32 when bins spread.  The TPU kernel's one-hot (16384 x 256) compare
// and its zero padding are gone.  At the end a block sums its warps'
// sub-histograms and adds each nonzero bin to the 64-bit global histogram
// with one atomic.  Integer atomics are exact and commutative, so the counts
// do not depend on block order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;

__device__ __forceinline__ void count_key(unsigned* warp_hist, int32_t key,
                                          int shift, unsigned active,
                                          int lane) {
  // arithmetic shift of the signed key, as JAX shifts int32
  const unsigned bin = static_cast<unsigned>(key >> shift) & (kBins - 1);
  const unsigned peers = __match_any_sync(active, bin);
  if (__ffs(peers) - 1 == lane)
    atomicAdd(warp_hist + bin, static_cast<unsigned>(__popc(peers)));
}

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const int32_t* __restrict__ keys, long long n, int shift,
                  bool vec, unsigned long long* hist) {
  __shared__ unsigned s_hist[kWarps][kBins];
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&s_hist[0][0])[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned* warp_hist = s_hist[warp];
  const long long warp_id = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long warp_stride = static_cast<long long>(gridDim.x) * kWarps * 32;

  // the loop bounds are uniform across a warp, so every lane reaches the
  // ballot and the lanes of `active` reach the match together
  long long tail_from = 0;
  if (vec) {
    const long long n4 = n / 4;
    const int4* k4 = reinterpret_cast<const int4*>(keys);
    for (long long base = warp_id * 32; base < n4; base += warp_stride) {
      const long long j = base + lane;
      const bool ok = j < n4;
      const unsigned active = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int4 v = __ldg(k4 + j);
        count_key(warp_hist, v.x, shift, active, lane);
        count_key(warp_hist, v.y, shift, active, lane);
        count_key(warp_hist, v.z, shift, active, lane);
        count_key(warp_hist, v.w, shift, active, lane);
      }
    }
    tail_from = n4 * 4;
  }
  for (long long base = tail_from + warp_id * 32; base < n;
       base += warp_stride) {
    const long long i = base + lane;
    const bool ok = i < n;
    const unsigned active = __ballot_sync(0xffffffffu, ok);
    if (ok) count_key(warp_hist, __ldg(keys + i), shift, active, lane);
  }
  __syncthreads();

  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_hist[w][b];
    if (total) atomicAdd(hist + b, total);
  }
}

}  // namespace

// `hist` (256 int64) must be zeroed by the caller.  Returns
// cudaGetLastError() after the launch.
extern "C" int olap_radix_hist_i32(const void* keys, long long n, int shift,
                                   void* hist, void* stream) {
  if (n < 0 || shift < 0 || shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want_blocks = (n / 4 + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) * 8;
  const int blocks = static_cast<int>(
      want_blocks < 1 ? 1 : (want_blocks < cap ? want_blocks : cap));
  radix_hist_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, shift, vec,
      static_cast<unsigned long long*>(hist));
  return static_cast<int>(cudaGetLastError());
}
