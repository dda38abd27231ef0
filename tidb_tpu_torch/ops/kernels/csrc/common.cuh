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
