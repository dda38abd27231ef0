// Shared helpers of the port's CUDA kernels: 64-bit integer arithmetic
// with two's-complement wrap (as int64 wraps in PyTorch and XLA), floor
// division, and the launch geometry every kernel uses.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned long long u64;

#define TIDB_THREADS 256

// Launch-time caches (a kernel's shared-memory opt-in, the SM count, an
// occupancy) hold one entry per device: an attribute set on one card is
// not set on another, and a process may launch on any card.
#define TIDB_MAX_DEVICES 64

// The calling thread's current device, the index of those caches.
static inline cudaError_t current_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev < 0 || *dev >= TIDB_MAX_DEVICES) return cudaErrorInvalidDevice;
  return cudaSuccess;
}

// Grid for a grid-stride loop over n items: enough blocks to fill the
// card (132 SMs x 8 resident blocks of 256 threads), never more than n needs.
static inline int grid_for(i64 n, int threads = TIDB_THREADS) {
  i64 blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  return (int)blocks;
}

__device__ __forceinline__ i64 wrap_add(i64 a, i64 b) {
  return (i64)((u64)a + (u64)b);
}
__device__ __forceinline__ i64 wrap_sub(i64 a, i64 b) {
  return (i64)((u64)a - (u64)b);
}
__device__ __forceinline__ i64 wrap_mul(i64 a, i64 b) {
  return (i64)((u64)a * (u64)b);
}
__device__ __forceinline__ i64 wrap_neg(i64 a) { return (i64)(0ULL - (u64)a); }
__device__ __forceinline__ i64 wrap_abs(i64 a) { return a < 0 ? wrap_neg(a) : a; }

// Python/numpy floor division (b != 0).
__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  i64 q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) q -= 1;
  return q;
}

// Index arrays come as int32 (tables under 2^31 rows) or int64.
__device__ __forceinline__ i64 load_index(const void* p, int is64, i64 i) {
  return is64 ? ((const i64*)p)[i] : (i64)((const int*)p)[i];
}

__device__ __forceinline__ i64 warp_sum_i64(i64 v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The sum over the warp, in every lane.
__device__ __forceinline__ i64 warp_sum_all(i64 v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lane 0 of the warp: the least (greatest) value of the warp's.
__device__ __forceinline__ i64 warp_min(i64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const i64 w = __shfl_down_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}
__device__ __forceinline__ i64 warp_max(i64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const i64 w = __shfl_down_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// Join kinds (ops/kernels/join_probe.py KINDS) and the valid rows of a
// probe row space from its validity pv and match flag h: inner and semi
// pv && h, anti pv && !h, left pv.
enum { JK_INNER = 0, JK_LEFT = 1, JK_SEMI = 2, JK_ANTI = 3 };

__device__ __forceinline__ bool kind_valid(int kind, bool pv, bool h) {
  return kind == JK_LEFT ? pv : (kind == JK_ANTI ? (pv && !h) : (pv && h));
}

// -- single-pass scans by decoupled look-back ---------------------------------
//
// A scan of 1024-thread blocks, each over one tile of 1024 * ITEMS rows
// (row base + j * 1024 + tid for item j, so loads and stores coalesce),
// the tiles taken in the order blocks start (a ticket), so every tile a
// block waits on is already running.  Each tile publishes its sum, then
// its inclusive prefix once warp 0 has looked back over the tiles before
// it, 32 at a time, to one that published a prefix.  The status words
// carry the call's epoch, so no launch clears them.

#define LB_THREADS 1024
#define LB_WARPS (LB_THREADS / 32)
#define LB_AGG 1u
#define LB_INCL 2u

// Per tile: a flag (epoch << 2 | state), the aggregate and the inclusive
// prefix.
struct LookBack {
  u64* flag;
  i64* agg;
  i64* incl;
  u64 epoch;
};

__device__ __forceinline__ void lb_publish(const LookBack& s, i64 t,
                                           unsigned state, i64 v) {
  if (state == LB_INCL)
    *(volatile i64*)&s.incl[t] = v;
  else
    *(volatile i64*)&s.agg[t] = v;
  __threadfence();
  *(volatile u64*)&s.flag[t] = (s.epoch << 2) | state;
}

// Warp 0: the exclusive prefix of tile t, whose own sum is `sum`.
__device__ __forceinline__ i64 lb_exclusive(const LookBack& s, i64 t, i64 sum) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) lb_publish(s, t, t == 0 ? LB_INCL : LB_AGG, sum);
  if (t == 0) return 0;
  i64 excl = 0;
  for (i64 top = t - 1;; top -= 32) {
    const i64 p = top - lane;
    unsigned state = LB_INCL;
    i64 v = 0;
    if (p >= 0) {
      u64 f;
      do {
        f = *(volatile u64*)&s.flag[p];
      } while ((f >> 2) != s.epoch);
      __threadfence();
      state = (unsigned)(f & 3);
      v = state == LB_INCL ? *(volatile i64*)&s.incl[p]
                           : *(volatile i64*)&s.agg[p];
    }
    const unsigned m = __ballot_sync(0xffffffffu, state == LB_INCL);
    const int stop = m ? __ffs(m) - 1 : 31;
    excl += warp_sum_all(lane <= stop ? v : 0);
    if (m) break;
  }
  if (lane == 0) lb_publish(s, t, LB_INCL, excl + sum);
  return excl;
}

// The tile a block takes: the next ticket of *ctr; the block that takes
// the last of n_tiles sets the counter back to 0 for the next launch.
// Every thread of the block must call it (it synchronises the block).
__device__ __forceinline__ i64 lb_take_tile(u64* ctr, i64 n_tiles) {
  __shared__ i64 s_tile;
  if (threadIdx.x == 0) {
    const i64 t = (i64)atomicAdd((unsigned long long*)ctr, 1ull);
    if (t == n_tiles - 1) atomicExch((unsigned long long*)ctr, 0ull);
    s_tile = t;
  }
  __syncthreads();
  return s_tile;
}

// The exclusive scan of a tile, in row order: v[j] is the value of row
// base + j * 1024 + tid; ex[j] gets its offset within the tile; returns
// the tile's sum.  Every thread of the 1024-thread block must call it.
template <int ITEMS>
__device__ __forceinline__ i64 lb_tile_scan(const i64 (&v)[ITEMS],
                                            i64 (&ex)[ITEMS]) {
  static_assert(ITEMS <= 32, "a warp scans one item's warp totals");
  __shared__ i64 s_wtot[ITEMS][LB_WARPS];  // then their prefixes
  __shared__ i64 s_ctot[ITEMS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    i64 x = v[j];
    for (int o = 1; o < 32; o <<= 1) {
      const i64 u = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += u;
    }
    ex[j] = x - v[j];  // exclusive, within the warp
    if (lane == 31) s_wtot[j][warp] = x;
  }
  __syncthreads();
  if (warp < ITEMS) {  // warp j: the exclusive prefix of j's warp totals
    const i64 w = s_wtot[warp][lane];
    i64 x = w;
    for (int o = 1; o < 32; o <<= 1) {
      const i64 u = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += u;
    }
    s_wtot[warp][lane] = x - w;
    if (lane == 31) s_ctot[warp] = x;
  }
  __syncthreads();
  i64 run = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    ex[j] += run + s_wtot[j][warp];  // exclusive, within the tile
    run += s_ctot[j];
  }
  return run;
}

// Adds every thread's `v` of the block into *out with one atomic.  Every
// thread of the block must call it (it synchronises the block).
__device__ __forceinline__ void block_add_to(i64 v, i64* out) {
  __shared__ i64 warp_part[32];
  v = warp_sum_i64(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) warp_part[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_part[lane] : 0;
    v = warp_sum_i64(v);
    if (lane == 0 && v != 0) atomicAdd((u64*)out, (u64)v);
  }
}
