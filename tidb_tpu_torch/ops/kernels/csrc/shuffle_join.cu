// Kernel B of the MPP shuffle join (K11): the local sort join's sum.
//
// Replaces: tidb_tpu/parallel/mpp.py:325-342 (dist_join_agg_step's
// csum / ccnt prefix sums, the two searchsorted of each probe key and
// sum(pv * match_sum)).  The key order is K4's (sort_topk.valid_first_order)
// and the match ranges are K5a's sorted probe in count mode (pos0, cnt per
// probe row, inside the valid build prefix), so this kernel only sums.
//
// What it computes, for build values bv read in K4's order (bv[order[m]],
// m < n) and probe rows i:
//   csum[0] = 0, csum[m + 1] = csum[m] + bv[order[m]];
//   match_sum[i] = csum[pos0[i] + cnt[i]] - csum[pos0[i]];
//   total = sum over valid probe rows of pv[i] * match_sum[i];
//   pairs = sum over valid probe rows of cnt[i].
// int64 values wrap as int64 does (exact); with a float64 side the
// product and total are float64 (jnp's promotion).  Float results differ
// from the reference's jnp.cumsum + jnp.sum + psum in summation order
// only: within rtol 1e-9 / atol 1e-12.  They repeat bit for bit from run
// to run: no atomics add a value, and every sum has one fixed order.
//
// Bound on the card: memory.  The build values and the order, pos0, cnt,
// the probe values and pvalid are each read once (csum is written and
// read back once more, and each probe row reads two csum entries at
// random: 16 MB at 2^21 slots, served from L2).
//
// Design: ONE launch of sj_run, whose blocks take tickets in the order
// they start.  Tickets below n_tiles scan a tile of SJ_TILE sorted
// positions, SJ_CHUNK at a step: each gathers its bv[order[m]] once,
// scans them in the block into local prefixes staged in shared memory,
// finds its prefix by decoupled look-back over the earlier tiles and
// writes csum.  Two steps a tile halve the tiles, and with them the
// look-back's walk, at 32 KB of shared memory a block.  For floats the look-back stays exact run to run: a tile's
// prefix is the nearest earlier inclusive prefix followed by the
// aggregates after it, added in tile order, so every prefix equals the
// left fold ((agg_0 + agg_1) + agg_2) + ... whichever tiles had published.
// The other tickets are probe blocks: each reads its first rows, waits
// until every tile has written csum (all those tickets were taken before
// its own, by blocks already running), sums its rows in a fixed
// grid-stride order with a
// fixed-shape block reduction into a partial, and the last probe block to
// finish adds the partials in block order with a fixed-shape reduction.
// The status words carry the call's epoch, so no launch clears them; the
// last ticket and the last probe block set the counters back to 0.
#include "common.cuh"

#define SJ_THREADS 256
#define SJ_WARPS (SJ_THREADS / 32)
#define SJ_ITEMS 8
#define SJ_CHUNK (SJ_THREADS * SJ_ITEMS)  // positions a scan step takes
#define SJ_CHUNKS 2                       // scan steps a tile
#define SJ_TILE (SJ_CHUNK * SJ_CHUNKS)
#define SJ_MAX_BLOCKS (132 * 8)
#define SJ_ROWS 4  // probe rows a thread loads before it adds them
#define SJ_AGG 1u
#define SJ_INCL 2u

typedef unsigned int u32;

struct SjArgs {
  i64 n;  // sorted build positions
  const void* bv;
  int bv_f;
  const i64* order;  // may be null: bv already in key order
  i64 np;            // probe rows
  const i64* pos0;
  const i64* cnt;
  const void* pv;
  int pv_f;
  const unsigned char* pvalid;  // may be null: every row
  int out_f;                    // total in float64
  i64 n_tiles, n_probe;
  u64 epoch;
  u64* ctr;   // ticket, tiles done, probe blocks done
  u64* flag;  // per tile: epoch << 2 | state
  i64* agg;   // per tile, int64 or float64 bits
  i64* incl;
  i64* part_total;  // per probe block
  i64* part_pairs;
  i64* csum;  // n + 1 entries, int64 or float64 bits
  i64* res;   // total, pairs
};

union Num {
  i64 i;
  double f;
};

__device__ __forceinline__ Num add(Num x, Num y, int f) {
  Num r;
  if (f) r.f = x.f + y.f;
  else r.i = wrap_add(x.i, y.i);
  return r;
}

__device__ __forceinline__ Num zero() {
  Num z;
  z.i = 0;  // also +0.0
  return z;
}

__device__ __forceinline__ Num num(i64 bits) {
  Num v;
  v.i = bits;
  return v;
}

__device__ __forceinline__ Num shfl(Num v, int src) {
  return num(__shfl_sync(0xffffffffu, v.i, src));
}

__device__ __forceinline__ Num shfl_up(Num v, int o) {
  return num(__shfl_up_sync(0xffffffffu, v.i, o));
}

__device__ __forceinline__ Num shfl_down(Num v, int o) {
  return num(__shfl_down_sync(0xffffffffu, v.i, o));
}

// Fixed-order block sum; the result is valid in thread 0.  Every thread
// calls it.
__device__ __forceinline__ Num sj_block_sum(Num v, int f) {
  __shared__ i64 warp_part[SJ_WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = add(v, shfl_down(v, o), f);
  __syncthreads();
  if (lane == 0) warp_part[w] = v.i;
  __syncthreads();
  Num t = zero();
  if (w == 0) {
    if (lane < SJ_WARPS) t.i = warp_part[lane];
    for (int o = 16; o > 0; o >>= 1) t = add(t, shfl_down(t, o), f);
  }
  return t;
}

// Lane 0: publish tile t's aggregate or inclusive prefix.
__device__ __forceinline__ void sj_publish(const SjArgs& a, i64 t, u32 state,
                                           Num v) {
  if (state == SJ_INCL)
    *(volatile i64*)&a.incl[t] = v.i;
  else
    *(volatile i64*)&a.agg[t] = v.i;
  __threadfence();
  *(volatile u64*)&a.flag[t] = (a.epoch << 2) | state;
}

// Lanes: the flag and value of tile q (before tile 0: an inclusive zero),
// once the tile has published in this call.
__device__ __forceinline__ Num sj_peek(const SjArgs& a, i64 q, u32* state) {
  if (q < 0) {
    *state = SJ_INCL;
    return zero();
  }
  u64 fl;
  do {
    fl = *(volatile u64*)&a.flag[q];
  } while ((fl >> 2) != a.epoch);
  __threadfence();
  *state = (u32)(fl & 3);
  return num(*state == SJ_INCL ? *(volatile i64*)&a.incl[q]
                               : *(volatile i64*)&a.agg[q]);
}

// acc, then the values of lanes from - 1 down to 0 (tiles in ascending
// order), added one by one; every lane gets the result.
__device__ __forceinline__ Num sj_fold(Num acc, Num v, int from, int f) {
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    const Num x = shfl(v, i);
    if (i < from) acc = add(acc, x, f);
  }
  return acc;
}

// Warp 0: the exclusive prefix of tile t, whose own sum is `agg`.  It
// walks back 32 tiles at a time to the nearest tile that has published
// its inclusive prefix, then adds the aggregates after that tile in tile
// order: the left fold ((agg_0 + agg_1) + agg_2) + ..., bit for bit,
// whichever tiles had published.
__device__ Num sj_lookback(const SjArgs& a, i64 t, Num agg, int f) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) sj_publish(a, t, t == 0 ? SJ_INCL : SJ_AGG, agg);
  if (t == 0) return zero();
  i64 top = t - 1;  // the window: tiles top - lane
  u32 state;
  Num v = sj_peek(a, top - lane, &state);
  unsigned m;
  while ((m = __ballot_sync(0xffffffffu, state == SJ_INCL)) == 0) {
    top -= 32;
    v = sj_peek(a, top - lane, &state);
  }
  const int stop = __ffs(m) - 1;  // the nearest inclusive prefix
  Num acc = sj_fold(shfl(v, stop), v, stop, f);
  for (top += 32; top < t; top += 32)  // the windows after it: aggregates
    acc = sj_fold(acc, num(*(volatile i64*)&a.agg[top - lane]), 32, f);
  if (lane == 0) sj_publish(a, t, SJ_INCL, add(acc, agg, f));
  return acc;
}

__device__ void sj_scan_tile(const SjArgs& a, i64 t) {
  extern __shared__ i64 s_loc[];  // [SJ_TILE] the tile's local prefixes
  __shared__ i64 s_wex[SJ_ITEMS][SJ_WARPS];  // warp totals' exclusive prefix
  __shared__ i64 s_ctot[SJ_ITEMS];           // row totals
  __shared__ i64 s_pre;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f = a.bv_f;
  const i64 base = t * SJ_TILE;
  Num run = zero();  // the tile's positions before this step
  for (int ch = 0; ch < SJ_CHUNKS; ++ch) {
    // position cb + j * SJ_THREADS + tid: loads and stores coalesced
    const i64 cb = base + (i64)ch * SJ_CHUNK;
    i64 idx[SJ_ITEMS];
#pragma unroll
    for (int j = 0; j < SJ_ITEMS; ++j) {
      const i64 r = cb + (i64)j * SJ_THREADS + tid;
      idx[j] = r < a.n ? (a.order ? a.order[r] : r) : -1;
    }
    Num x[SJ_ITEMS];
#pragma unroll
    for (int j = 0; j < SJ_ITEMS; ++j)
      x[j] = idx[j] >= 0 ? num(((const i64*)a.bv)[idx[j]]) : zero();
    // each row j: a warp inclusive scan, then the warps' totals
#pragma unroll
    for (int j = 0; j < SJ_ITEMS; ++j) {
      for (int o = 1; o < 32; o <<= 1) {
        const Num u = shfl_up(x[j], o);
        if (lane >= o) x[j] = add(x[j], u, f);
      }
      if (lane == 31) s_wex[j][warp] = x[j].i;
    }
    __syncthreads();
    for (int j = warp; j < SJ_ITEMS; j += SJ_WARPS) {  // row j's totals
      Num w = lane < SJ_WARPS ? num(s_wex[j][lane]) : zero();
      for (int o = 1; o < SJ_WARPS; o <<= 1) {
        const Num u = shfl_up(w, o);
        if (lane >= o) w = add(w, u, f);
      }
      const Num ex = shfl_up(w, 1);  // exclusive, never a subtraction
      if (lane < SJ_WARPS) s_wex[j][lane] = lane == 0 ? 0 : ex.i;
      if (lane == SJ_WARPS - 1) s_ctot[j] = w.i;
    }
    __syncthreads();
    // row j's prefix: the rows before it in row order, then the warps
    // before this one
#pragma unroll
    for (int j = 0; j < SJ_ITEMS; ++j) {
      s_loc[ch * SJ_CHUNK + j * SJ_THREADS + tid] =
          add(add(run, num(s_wex[j][warp]), f), x[j], f).i;
      run = add(run, num(s_ctot[j]), f);
    }
    __syncthreads();  // s_wex and s_ctot are read
  }
  if (warp == 0) {
    const Num pre = sj_lookback(a, t, run, f);
    if (lane == 0) s_pre = pre.i;
  }
  __syncthreads();
  const Num pre = num(s_pre);
  for (int p = tid; p < SJ_TILE; p += SJ_THREADS) {
    const i64 r = base + p;
    if (r < a.n) a.csum[r + 1] = add(pre, num(s_loc[p]), f).i;
  }
  if (t == 0 && tid == 0) a.csum[0] = 0;
  __threadfence();
  __syncthreads();
  if (tid == 0) atomicAdd((unsigned long long*)&a.ctr[1], 1ull);
}

// A thread's next SJ_ROWS probe rows i0, i0 + stride, ...: the match
// count (0 for an invalid row or past np), its start and the probe value.
__device__ __forceinline__ void sj_probe_load(const SjArgs& a, i64 i0,
                                              i64 stride, i64* c, i64* p0,
                                              i64* pv) {
#pragma unroll
  for (int u = 0; u < SJ_ROWS; ++u) {
    const i64 i = i0 + u * stride;
    const bool in = i < a.np && (a.pvalid == nullptr || a.pvalid[i]);
    c[u] = in ? a.cnt[i] : 0;
    p0[u] = c[u] > 0 ? a.pos0[i] : 0;
    pv[u] = c[u] > 0 ? ((const i64*)a.pv)[i] : 0;
  }
}

__device__ void sj_probe_block(const SjArgs& a, i64 q) {
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int f = a.out_f;
  const i64 stride = a.n_probe * SJ_THREADS;
  i64 i0 = q * SJ_THREADS + tid;
  i64 c[SJ_ROWS], p0[SJ_ROWS], pv[SJ_ROWS];
  sj_probe_load(a, i0, stride, c, p0, pv);  // while the scan may still run
  if (tid == 0) {
    while (*(volatile u64*)&a.ctr[1] < (u64)a.n_tiles) __nanosleep(256);
    __threadfence();
  }
  __syncthreads();
  Num tsum = zero();
  i64 pairs = 0;
  for (;;) {
    Num hi[SJ_ROWS], lo[SJ_ROWS];
#pragma unroll
    for (int u = 0; u < SJ_ROWS; ++u) {
      hi[u] = num(c[u] > 0 ? __ldcg(a.csum + p0[u] + c[u]) : 0);
      lo[u] = num(c[u] > 0 ? __ldcg(a.csum + p0[u]) : 0);
    }
#pragma unroll
    for (int u = 0; u < SJ_ROWS; ++u) {  // in row order
      if (c[u] <= 0) continue;
      Num prod;
      if (a.out_f) {
        const double ms = a.bv_f ? hi[u].f - lo[u].f
                                 : (double)wrap_sub(hi[u].i, lo[u].i);
        const double x = a.pv_f ? num(pv[u]).f : (double)pv[u];
        prod.f = x * ms;
      } else {
        prod.i = wrap_mul(pv[u], wrap_sub(hi[u].i, lo[u].i));
      }
      tsum = add(tsum, prod, f);
      pairs += c[u];
    }
    i0 += SJ_ROWS * stride;
    if (i0 >= a.np) break;
    sj_probe_load(a, i0, stride, c, p0, pv);
  }
  const Num bt = sj_block_sum(tsum, f);
  const Num bp = sj_block_sum(num(pairs), 0);
  if (tid == 0) {
    *(volatile i64*)&a.part_total[q] = bt.i;
    *(volatile i64*)&a.part_pairs[q] = bp.i;
    __threadfence();
    const u64 done = atomicAdd((unsigned long long*)&a.ctr[2], 1ull);
    s_last = done == (u64)(a.n_probe - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last probe block: the partials in block order
  Num t = zero();
  i64 p = 0;
  for (i64 k = tid; k < a.n_probe; k += SJ_THREADS) {
    t = add(t, num(__ldcg(a.part_total + k)), f);
    p += __ldcg(a.part_pairs + k);
  }
  const Num tt = sj_block_sum(t, f);
  const Num tp = sj_block_sum(num(p), 0);
  if (tid == 0) {
    a.res[0] = tt.i;
    a.res[1] = tp.i;
    // every tile and probe block is past the counters
    *(volatile u64*)&a.ctr[1] = 0;
    *(volatile u64*)&a.ctr[2] = 0;
  }
}

__global__ void __launch_bounds__(SJ_THREADS) sj_run(SjArgs a) {
  __shared__ i64 s_ticket;
  if (threadIdx.x == 0) {
    const u64 t = atomicAdd((unsigned long long*)&a.ctr[0], 1ull);
    if (t == (u64)(a.n_tiles + a.n_probe - 1))
      atomicExch((unsigned long long*)&a.ctr[0], 0ull);
    s_ticket = (i64)t;
  }
  __syncthreads();
  const i64 t = s_ticket;
  if (t < a.n_tiles)
    sj_scan_tile(a, t);
  else
    sj_probe_block(a, t - a.n_tiles);
}

// hdr (int64): [n, bv, bv_f, order, np, pos0, cnt, pv, pv_f, pvalid, out_f,
//               n_tiles, n_probe, epoch, ctr, flag, agg, incl, part_total,
//               part_pairs, csum, res]
// n_tiles = ceil(n / SJ_TILE), n_probe in [1, SJ_MAX_BLOCKS]; ctr holds 3
// words, flag / agg / incl n_tiles, the partials n_probe, csum n + 1;
// ctr and flag zeroed when allocated, and no call with a later epoch has
// run on them.
extern "C" int shuffle_join_run(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  SjArgs a;
  a.n = hdr[0];
  a.bv = (const void*)hdr[1];
  a.bv_f = (int)hdr[2];
  a.order = (const i64*)hdr[3];
  a.np = hdr[4];
  a.pos0 = (const i64*)hdr[5];
  a.cnt = (const i64*)hdr[6];
  a.pv = (const void*)hdr[7];
  a.pv_f = (int)hdr[8];
  a.pvalid = (const unsigned char*)hdr[9];
  a.out_f = (int)hdr[10];
  a.n_tiles = hdr[11];
  a.n_probe = hdr[12];
  a.epoch = (u64)hdr[13];
  a.ctr = (u64*)hdr[14];
  a.flag = (u64*)hdr[15];
  a.agg = (i64*)hdr[16];
  a.incl = (i64*)hdr[17];
  a.part_total = (i64*)hdr[18];
  a.part_pairs = (i64*)hdr[19];
  a.csum = (i64*)hdr[20];
  a.res = (i64*)hdr[21];
  if (a.n < 0 || a.np < 0 || a.n_tiles != (a.n + SJ_TILE - 1) / SJ_TILE ||
      a.n_probe < 1 || a.n_probe > SJ_MAX_BLOCKS || a.epoch < 1 ||
      a.epoch >= (1ULL << 62) || (a.bv_f && !a.out_f) ||
      (a.pv_f && !a.out_f))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)SJ_TILE * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sj_run, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sj_run<<<(unsigned)(a.n_tiles + a.n_probe), SJ_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}
