// Running max and reversed running min of an int32 array, for Hopper
// (sm_90a): the sorted-space join's run fills.
//
// Replaces: XLA scans, not a pallas_call: jax.lax.cummax in
// gpu_olap_tpu/ops/join.py:192 (and :278, :289, :578) and
// jnp.flip(jax.lax.cummin(jnp.flip(x))) at :295 (reached through
// probe_ranges_merge, probe_counts_sorted and inner_join_stream).
//
// Contract: forward, y[i] = max(x[0..i]); reverse, y[i] = min(x[i..n-1]).
// Exact for any int32 input: max and min lose nothing.
//
// Bound on the card: device-memory bytes, 4 per element read once and 4
// written once.
//
// Design: one pass with decoupled look-back.
//   - A tile is kTile consecutive elements and a block of kThreads threads
//     scans one.  Blocks start in no order, so a block takes the next tile
//     id from an atomic counter, not from blockIdx: every tile it looks back
//     on has started and will publish.  The forward scan takes tiles from
//     the front, the reverse scan from the back (the ragged tile first);
//     both cut memory into the same tiles, so 16-byte loads stay aligned.
//   - Warp w of a tile owns kWarpElems consecutive elements as kRows rows of
//     128; lane l holds four consecutive elements of each row, one 16-byte
//     load (scalar loads for an unaligned view and past the end, which
//     read as the identity).  A thread scans its four, a warp its rows by
//     shuffles, the block its warps through shared memory.
//   - A tile publishes its total (flag 1) as soon as the block has it, and
//     its inclusive prefix (flag 2) after its look-back, in one 64-bit
//     status word (flag << 32 | value): a reader sees flag and value
//     together.  Warp 0 reads the 32 tiles before its own at a time and
//     folds totals up to the nearest inclusive prefix.
//   - max and min are commutative and idempotent, so the folds may take
//     any order and a shuffle past the warp's edge (which returns the
//     lane's own value) changes nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                        // 16-byte loads a thread
constexpr int kRowElems = 32 * 4;               // one row of a warp
constexpr int kWarpElems = kRows * kRowElems;   // 512
constexpr int kTile = kWarps * kWarpElems;      // 4096
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kTotal = 1ull << 32;      // flag 1
constexpr unsigned long long kInclusive = 2ull << 32;  // flag 2

// forward scans take the max, reverse scans the min
template <bool kRev>
__device__ __forceinline__ int32_t op(int32_t a, int32_t b) {
  return kRev ? min(a, b) : max(a, b);
}

template <bool kRev>
__device__ __forceinline__ int32_t identity() {
  return kRev ? INT32_MAX : INT32_MIN;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long flag,
                                             int32_t value) {
  const unsigned long long v = flag | static_cast<uint32_t>(value);
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

template <bool kRev, bool kVec>
__device__ __forceinline__ void load4(int32_t (&v)[4], const int32_t* x,
                                      long long i, long long n) {
  if (kVec && i + 3 < n) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(x + i));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i + j < n ? x[i + j] : identity<kRev>();
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(const int32_t (&v)[4], int32_t* y,
                                       long long i, long long n) {
  if (kVec && i + 3 < n) {
    *reinterpret_cast<int4*>(y + i) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i + j < n) y[i + j] = v[j];
  }
}

// The fold of every tile published before tile d (d > 0), by warp 0.
template <bool kRev>
__device__ int32_t look_back(const unsigned long long* status, int d,
                             int lane) {
  int32_t acc = identity<kRev>();
  for (int j = d - 1 - lane;; j -= 32) {
    // before tile 0 reads as an inclusive identity
    unsigned long long s =
        kInclusive | static_cast<uint32_t>(identity<kRev>());
    if (j >= 0) {
      do {
        s = load_status(status + j);
      } while ((s >> 32) == 0);
    }
    // lane 0 reads the nearest tile: fold the lanes up to the nearest
    // inclusive prefix, or all 32 totals and look further back
    const unsigned inclusive = __ballot_sync(kFull, (s & kInclusive) != 0);
    const int last = inclusive ? __ffs(inclusive) - 1 : 31;
    int32_t val = lane <= last ? static_cast<int32_t>(static_cast<uint32_t>(s))
                               : identity<kRev>();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      val = op<kRev>(val, __shfl_xor_sync(kFull, val, o));
    acc = op<kRev>(acc, val);
    if (inclusive) return acc;
  }
}

// status: n_tiles words, zero; counter: one zero word
template <bool kRev, bool kVec>
__global__ void __launch_bounds__(kThreads)
run_scan_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                long long n, int n_tiles, unsigned long long* status,
                unsigned* counter) {
  __shared__ int s_tile;
  __shared__ int32_t s_warp[kWarps];
  __shared__ int32_t s_prefix;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  const int d = s_tile;  // publication order
  const int tile = kRev ? n_tiles - 1 - d : d;
  const long long base = static_cast<long long>(tile) * kTile +
                         warp * kWarpElems + lane * 4;

  int32_t v[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    load4<kRev, kVec>(v[r], x, base + r * kRowElems, n);

  // each row: the thread's four, then the lanes before it (after it, in
  // reverse); excl[r] is the fold of the lanes before this one
  int32_t excl[kRows], row_total[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kRev) {
      v[r][2] = op<kRev>(v[r][2], v[r][3]);
      v[r][1] = op<kRev>(v[r][1], v[r][2]);
      v[r][0] = op<kRev>(v[r][0], v[r][1]);
    } else {
      v[r][1] = op<kRev>(v[r][1], v[r][0]);
      v[r][2] = op<kRev>(v[r][2], v[r][1]);
      v[r][3] = op<kRev>(v[r][3], v[r][2]);
    }
    int32_t incl = kRev ? v[r][0] : v[r][3];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      incl = op<kRev>(incl, kRev ? __shfl_down_sync(kFull, incl, o)
                                 : __shfl_up_sync(kFull, incl, o));
    const int32_t prev = kRev ? __shfl_down_sync(kFull, incl, 1)
                              : __shfl_up_sync(kFull, incl, 1);
    excl[r] = lane == (kRev ? 31 : 0) ? identity<kRev>() : prev;
    row_total[r] = __shfl_sync(kFull, incl, kRev ? 0 : 31);
  }
  // rows before each row in the warp, and the warp's total
  int32_t row_pre[kRows];
  int32_t warp_total = identity<kRev>();
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = kRev ? kRows - 1 - k : k;
    row_pre[r] = warp_total;
    warp_total = op<kRev>(warp_total, row_total[r]);
  }
  if (lane == 0) s_warp[warp] = warp_total;
  __syncthreads();
  int32_t warp_pre = identity<kRev>(), tile_total = identity<kRev>();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int32_t s = s_warp[w];
    if (kRev ? w > warp : w < warp) warp_pre = op<kRev>(warp_pre, s);
    tile_total = op<kRev>(tile_total, s);
  }

  if (warp == 0) {
    int32_t tile_pre = identity<kRev>();
    if (d == 0) {
      if (lane == 0) store_status(status, kInclusive, tile_total);
    } else {
      if (lane == 0) store_status(status + d, kTotal, tile_total);
      tile_pre = look_back<kRev>(status, d, lane);
      if (lane == 0)
        store_status(status + d, kInclusive, op<kRev>(tile_pre, tile_total));
    }
    if (lane == 0) s_prefix = tile_pre;
  }
  __syncthreads();

  const int32_t pre = op<kRev>(s_prefix, warp_pre);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int32_t p = op<kRev>(pre, op<kRev>(row_pre[r], excl[r]));
#pragma unroll
    for (int j = 0; j < 4; ++j) v[r][j] = op<kRev>(v[r][j], p);
    store4<kVec>(v[r], y, base + r * kRowElems, n);
  }
}

template <bool kRev>
cudaError_t launch(const int32_t* x, int32_t* y, long long n, int n_tiles,
                   unsigned long long* status, unsigned* counter,
                   cudaStream_t st) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (vec)
    run_scan_kernel<kRev, true><<<n_tiles, kThreads, 0, st>>>(
        x, y, n, n_tiles, status, counter);
  else
    run_scan_kernel<kRev, false><<<n_tiles, kThreads, 0, st>>>(
        x, y, n, n_tiles, status, counter);
  return cudaGetLastError();
}

}  // namespace

extern "C" int olap_run_scan_tile() { return kTile; }

// x, y: n int32 each, 4-byte aligned, n > 0 (16-byte aligned pairs take
// vector loads).  reverse: 0 = running max from the front, 1 = running min
// from the back.  scratch: ceil(n / olap_run_scan_tile()) + 1 zeroed 64-bit
// words (tile status words, then the tile counter).  Returns
// cudaGetLastError() after the launch.
extern "C" int olap_run_scan_i32(const void* x, void* y, long long n,
                                 int reverse, void* scratch, void* stream) {
  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n <= 0 || n_tiles >= (1LL << 31) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
       3) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* counter = reinterpret_cast<unsigned*>(status + n_tiles);
  const auto* xi = static_cast<const int32_t*>(x);
  auto* yi = static_cast<int32_t*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>(n_tiles);
  return static_cast<int>(
      reverse ? launch<true>(xi, yi, n, tiles, status, counter, st)
              : launch<false>(xi, yi, n, tiles, status, counter, st));
}
