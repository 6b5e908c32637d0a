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
// written, but they are still counted.  Entries at or past the group count
// are zero.
//
// Bound on the card: device-memory bytes.  8 bytes read per row (key and
// value) and 24 bytes written per output slot (max_groups of them).
//
// Design: one pass that reads every key and value once.
//   - Tiles of kTile = 8192 rows.  A block copies its tile into shared
//     memory with cp.async (each warp 512 contiguous bytes per copy, so
//     device memory sees fully coalesced reads and no register holds data
//     in flight), then each thread owns kItems = 16 consecutive rows.  An
//     XOR swizzle of the 16-byte chunks makes those reads conflict-free.
//   - Tile ids come from a global atomic counter, not from blockIdx, so
//     tiles start in id order and a tile's predecessors are always running
//     or done: the look-back always makes progress.
//   - A group's id is the number of run starts before it, and the open run
//     carries its partial sum and its start row.  All three come from one
//     segmented scan with (c1,s1,p1) + (c2,s2,p2) = (c1+c2, c2 ? s2 : s1+s2,
//     max(p1,p2)): within a thread sequentially, across a warp by shuffles,
//     across the block's warps by one warp's scan, across tiles by a
//     single-pass scan with decoupled look-back over per-tile descriptors:
//     one 16-byte word holding the status and the tile's aggregate, then
//     its inclusive prefix, so a look-back round is one L2 round trip.
//   - The thread that sees a run's start writes the group's key and MIN; the
//     thread that sees its end writes count (end - start + 1), SUM and MAX.
//     All plain stores: no atomics on outputs, no pre-zeroed outputs.  The
//     thread that holds the last row writes the group count, and a second
//     small launch zeroes the output tail [n_groups, max_groups) only.
// What is left between this and the bound: each tile's steps (counter,
// copy, scan, look-back, writes) run one after another, and the outputs
// are 4- and 8-byte stores scattered over five arrays.
// The TPU kernel's 16-bit split, emulated (hi, lo) sums and butterfly
// routing are gone: the card has native 64-bit adds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // consecutive rows per thread: one bit each
constexpr int kChunks = kItems / 4;  // 16-byte chunks per thread
constexpr int kTile = kThreads * kItems;
constexpr int kTileBytes = 2 * kTile * 4;  // keys and values
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTailThreads = 256;
constexpr int kTailMaxBlocks = 1024;
constexpr int kMaxDevices = 64;

// The segmented-scan state: c run starts seen, s the sum since the last
// start, p the row of the last start (-1: none yet).
struct Carry {
  long long s;
  int c;
  int p;
};

__device__ __forceinline__ Carry identity() { return {0, 0, -1}; }

// a, then b
__device__ __forceinline__ Carry combine(const Carry& a, const Carry& b) {
  return {b.c ? b.s : a.s + b.s, a.c + b.c, max(a.p, b.p)};
}

__device__ __forceinline__ Carry shfl_up(const Carry& x, int d) {
  return {__shfl_up_sync(kFull, x.s, d), __shfl_up_sync(kFull, x.c, d),
          __shfl_up_sync(kFull, x.p, d)};
}

__device__ __forceinline__ Carry shfl_down(const Carry& x, int d) {
  return {__shfl_down_sync(kFull, x.s, d), __shfl_down_sync(kFull, x.c, d),
          __shfl_down_sync(kFull, x.p, d)};
}

__device__ __forceinline__ Carry shfl_idx(const Carry& x, int src) {
  return {__shfl_sync(kFull, x.s, src), __shfl_sync(kFull, x.c, src),
          __shfl_sync(kFull, x.p, src)};
}

// A tile's descriptor is one aligned 16-byte word, stored and loaded with
// one vector access each (a single transaction, as in CUB's tile state for
// 8-byte values), so its status and its value never tear apart and no fence
// orders them: .x is the sum s, .y packs c (bits 0-30), p + 1 (bits 32-62)
// and the status: bit 31 set once the tile's own aggregate is there, bit 63
// once its inclusive prefix replaced it.  All zero (invalid) at launch.
// c < 2^31 and p + 1 < 2^31 because n < 2^31 - 1.
constexpr unsigned long long kHasValue = 1ull << 31;
constexpr unsigned long long kIsPrefix = 1ull << 63;

__device__ __forceinline__ longlong2 encode(const Carry& x,
                                            unsigned long long status) {
  const unsigned long long w =
      (static_cast<unsigned long long>(static_cast<unsigned>(x.p + 1)) << 32) |
      static_cast<unsigned>(x.c) | status;
  return make_longlong2(x.s, static_cast<long long>(w));
}

__device__ __forceinline__ Carry decode(const longlong2& d) {
  const unsigned long long w = static_cast<unsigned long long>(d.y);
  return {d.x, static_cast<int>(w & 0x7fffffffu),
          static_cast<int>((w >> 32) & 0x7fffffffu) - 1};
}

// relaxed, GPU-scope 16-byte accesses: coherent in L2, never cached in L1,
// never merged or hoisted by the compiler
__device__ __forceinline__ longlong2 load_desc(const longlong2* d) {
  longlong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];"
               : "=l"(v.x), "=l"(v.y)
               : "l"(d)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_desc(longlong2* d, const longlong2& v) {
  asm volatile("st.relaxed.gpu.global.v2.b64 [%0], {%1, %2};" ::"l"(d),
               "l"(v.x), "l"(v.y)
               : "memory");
}

__device__ __forceinline__ unsigned long long status_of(const longlong2& d) {
  return static_cast<unsigned long long>(d.y) & (kHasValue | kIsPrefix);
}

struct SegArgs {
  const int32_t* keys;
  const int32_t* vals;
  int n;
  int max_groups;
  bool aligned;  // keys and vals 16-byte aligned
  longlong2* desc;  // one per tile, zero at launch
  int* tile_counter;
  int32_t* okey;
  int32_t* ocnt;
  long long* osum;
  int32_t* omin;
  int32_t* omax;
  int32_t* n_groups;
};

// The tile's exclusive prefix by decoupled look-back; run by warp 0.  Each
// round reads the 32 predecessors before `look` at once, one per lane, and
// stops at the nearest inclusive prefix among them.
__device__ Carry look_back(const SegArgs& a, int tile, const Carry& tile_agg,
                           int lane) {
  if (tile == 0) {
    if (lane == 0) store_desc(a.desc, encode(tile_agg, kHasValue | kIsPrefix));
    return identity();
  }
  if (lane == 0) store_desc(a.desc + tile, encode(tile_agg, kHasValue));
  Carry prefix = identity();
  for (int look = tile - 1;; look -= 32) {
    const int idx = look - lane;
    longlong2 d = encode(identity(), kHasValue | kIsPrefix);  // before tile 0
    if (idx >= 0) {
      do {
        d = load_desc(a.desc + idx);
      } while (status_of(d) == 0);
    }
    // lanes hold tiles look, look - 1, ...: keep those up to the nearest
    // inclusive prefix and fold them, earliest first, into lane 0
    const unsigned pm = __ballot_sync(kFull, (status_of(d) & kIsPrefix) != 0);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    Carry x = lane > stop ? identity() : decode(d);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      Carry o = shfl_down(x, off);
      if (lane + off < 32) x = combine(o, x);
    }
    prefix = combine(shfl_idx(x, 0), prefix);
    if (pm) break;
  }
  if (lane == 0)
    store_desc(a.desc + tile,
               encode(combine(prefix, tile_agg), kHasValue | kIsPrefix));
  return prefix;
}

// asynchronous global -> shared copies (cp.async), zero-filling past
// src_bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
}

// Position of 16-byte chunk c of the tile in shared memory.  Thread t reads
// its chunks kChunks * t + j; the swizzle spreads each group of 8 lanes
// over the 8 distinct 16-byte bank groups, so those reads are conflict-free.
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

__global__ void __launch_bounds__(kThreads) seg_agg_kernel(SegArgs a) {
  extern __shared__ int4 s_data[];     // the tile: keys, then values
  __shared__ int s_tile;
  __shared__ Carry s_warp[kWarps];     // each warp's aggregate, then its
                                       // exclusive prefix in the tile
  __shared__ Carry s_prefix;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int4* sk = s_data;
  int4* sv = s_data + kTile / 4;
  if (t == 0) s_tile = atomicAdd(a.tile_counter, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * kTile;

  // the whole tile into shared memory: in round r a warp copies 512
  // contiguous bytes of keys and of values; rows past n read as 0
#pragma unroll
  for (int r = 0; r < kChunks; ++r) {
    const int c = r * kThreads + t;
    const long long row = base + 4 * c;
    const int nv = static_cast<int>(max(0LL, min(4LL, a.n - row)));
    const long long src = nv ? row : 0;  // a valid address even when empty
    if (a.aligned) {
      cp_async16(sk + swz(c), a.keys + src, nv * 4);
      cp_async16(sv + swz(c), a.vals + src, nv * 4);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long se = e < nv ? row + e : 0;
        cp_async4(reinterpret_cast<int32_t*>(sk + swz(c)) + e, a.keys + se,
                  e < nv ? 4 : 0);
        cp_async4(reinterpret_cast<int32_t*>(sv + swz(c)) + e, a.vals + se,
                  e < nv ? 4 : 0);
      }
    }
  }
  const long long r0 = base + static_cast<long long>(t) * kItems;
  const int nv = static_cast<int>(
      max(0LL, min(static_cast<long long>(kItems), a.n - r0)));
  // keys just before and just after this thread's rows
  int32_t prev = 0, next = 0;
  if (t == 0 && base > 0) prev = __ldg(a.keys + base - 1);
  if (t == kThreads - 1 && r0 + kItems < a.n) next = __ldg(a.keys + r0 + kItems);
  cp_async_wait_all();
  __syncthreads();
  if (t > 0) prev = sk[swz(kChunks * t - 1)].w;
  if (t < kThreads - 1) next = sk[swz(kChunks * (t + 1))].x;

  // this thread's kItems consecutive rows: run starts (bit i), and the
  // thread's aggregate
  unsigned starts = 0;
  Carry agg = identity();
  int32_t last = prev;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int4 x = sk[swz(kChunks * t + j)];
    const int4 y = sv[swz(kChunks * t + j)];
    const int32_t k[4] = {x.x, x.y, x.z, x.w};
    const int32_t v[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      if (i < nv) {
        if ((r0 + i == 0) | (k[e] != last)) {
          starts |= 1u << i;
          agg.c += 1;
          agg.s = v[e];
          agg.p = static_cast<int>(r0 + i);
        } else {
          agg.s += v[e];
        }
        last = k[e];
      }
    }
  }
  // a run ends where the next row starts one, and at the last row
  unsigned ends = starts >> 1;
  if (nv == kItems) {
    if (r0 + kItems == a.n || next != last) ends |= 1u << (kItems - 1);
  } else if (nv > 0) {
    ends |= 1u << (nv - 1);  // the last row of the input
  }

  // exclusive prefix of the thread in its warp, of the warp in the tile
  Carry inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Carry o = shfl_up(inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  Carry excl = shfl_up(inc, 1);
  if (lane == 0) excl = identity();
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();

  // warp 0: the warps' aggregates scanned, then the tile's prefix by
  // look-back
  if (warp == 0) {
    Carry w = lane < kWarps ? s_warp[lane] : identity();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      Carry o = shfl_up(w, d);
      if (lane >= d) w = combine(o, w);
    }
    Carry w_excl = shfl_up(w, 1);
    if (lane < kWarps) s_warp[lane] = lane == 0 ? identity() : w_excl;
    const Carry prefix = look_back(a, tile, shfl_idx(w, kWarps - 1), lane);
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();

  // write each group's fields where its run starts and where it ends
  Carry run = combine(combine(s_prefix, s_warp[warp]), excl);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int4 x = sk[swz(kChunks * t + j)];
    const int4 y = sv[swz(kChunks * t + j)];
    const int32_t k[4] = {x.x, x.y, x.z, x.w};
    const int32_t v[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      if (i < nv) {
        const bool st = (starts >> i) & 1u;
        const bool en = (ends >> i) & 1u;
        if (st) {
          run.c += 1;
          run.s = v[e];
          run.p = static_cast<int>(r0 + i);
        } else {
          run.s += v[e];
        }
        const int g = run.c - 1;
        if (g < a.max_groups) {
          if (st) {
            a.okey[g] = k[e];
            a.omin[g] = v[e];
          }
          if (en) {
            a.ocnt[g] = static_cast<int32_t>(r0 + i - run.p + 1);
            a.osum[g] = run.s;
            a.omax[g] = v[e];
          }
        }
      }
    }
  }
  if (nv > 0 && nv < kItems) *a.n_groups = run.c;  // the input's last row
  if (nv == kItems && r0 + kItems == a.n) *a.n_groups = run.c;
}

// zeroes the output slots [n_groups, max_groups)
__global__ void __launch_bounds__(kTailThreads)
seg_tail_kernel(const int32_t* n_groups, int max_groups, int32_t* okey,
                int32_t* ocnt, long long* osum, int32_t* omin, int32_t* omax) {
  const int ng = *n_groups;
  for (long long g = ng + static_cast<long long>(blockIdx.x) * kTailThreads +
                     threadIdx.x;
       g < max_groups; g += static_cast<long long>(gridDim.x) * kTailThreads) {
    okey[g] = 0;
    ocnt[g] = 0;
    osum[g] = 0;
    omin[g] = 0;
    omax[g] = 0;
  }
}

long long n_tiles_of(long long n) { return (n + kTile - 1) / kTile; }

// scratch layout: desc[n_tiles], then the tile counter
long long scratch_bytes(long long n_tiles) {
  return (n_tiles + 1) * static_cast<long long>(sizeof(longlong2));
}

}  // namespace

extern "C" long long olap_seg_agg_scratch_bytes(long long n) {
  return scratch_bytes(n_tiles_of(n));
}

// scratch: olap_seg_agg_scratch_bytes(n) bytes, 16-byte aligned, any
// content.  Outputs need no initialisation.  Returns cudaGetLastError()
// after the last launch.
extern "C" int olap_seg_agg_i32(const void* keys, const void* vals,
                                long long n, int max_groups, void* scratch,
                                void* okey, void* ocnt, void* osum, void* omin,
                                void* omax, void* n_groups, void* stream) {
  if (n <= 0 || n >= (1LL << 31) - 1 || max_groups < 0 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nt = n_tiles_of(n);
  int err = static_cast<int>(cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(scratch_bytes(nt)), s));
  if (err) return err;
  SegArgs a;
  a.keys = static_cast<const int32_t*>(keys);
  a.vals = static_cast<const int32_t*>(vals);
  a.n = static_cast<int>(n);
  a.max_groups = max_groups;
  a.aligned = ((reinterpret_cast<uintptr_t>(keys) |
                reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
  a.desc = static_cast<longlong2*>(scratch);
  a.tile_counter = reinterpret_cast<int*>(a.desc + nt);
  a.okey = static_cast<int32_t*>(okey);
  a.ocnt = static_cast<int32_t*>(ocnt);
  a.osum = static_cast<long long*>(osum);
  a.omin = static_cast<int32_t*>(omin);
  a.omax = static_cast<int32_t*>(omax);
  a.n_groups = static_cast<int32_t*>(n_groups);
  // the tile needs more than 48 KB of shared memory: allowed once per device
  static bool attr_set[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {
    err = static_cast<int>(cudaFuncSetAttribute(
        seg_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTileBytes));
    if (err) return err;
    attr_set[dev] = true;
  }
  seg_agg_kernel<<<static_cast<unsigned>(nt), kThreads, kTileBytes, s>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err || max_groups == 0) return err;
  long long tail_blocks = (max_groups + kTailThreads - 1) / kTailThreads;
  if (tail_blocks > kTailMaxBlocks) tail_blocks = kTailMaxBlocks;
  seg_tail_kernel<<<static_cast<unsigned>(tail_blocks), kTailThreads, 0, s>>>(
      a.n_groups, max_groups, a.okey, a.ocnt, a.osum, a.omin, a.omax);
  return static_cast<int>(cudaGetLastError());
}
