// K7: the standalone join match, designed for the card.
//
// Replaces: tidb_tpu/ops/device.py:1473 _join_count_impl, :1487
// _join_expand_impl and :1506 device_join_match (the reference's two-pass
// sort join: an argsort of the build keys, two searchsorted passes, a
// cumsum and a searchsorted of every output slot).
//
// What the match computes: for build keys bk (nb rows, NULL flags bn) and
// probe keys pk (np rows, validity pv), every pair (p, b) with pv[p],
// !bn[b] and pk[p] == bk[b]; probe-major, each probe row's build rows in
// row order.  Any int64 key, I64_MIN and I64_MAX included.
//
// Bound on the card: memory.  Both sides' keys and flags are read once and
// the pairs written once, 16 bytes a pair.  The index's own traffic (the
// dense table, the CSR starts, the sorted layout's order) is the design's,
// not the function's, and is left out of the bound.
//
// Design.  The build side is indexed on the card in the layout
// executor/join_index.py (K6) picks on the host: a dense table when the
// valid keys' span, max - min + 1, is at most `limit` (max(4 nb, 65536)),
// sorted keys otherwise (K4, then K5a's sorted count and K5b's expansion,
// from ops/kernels/join_match.py).  One entry, join_match_run, by stage:
//
//   index - jm_summary: the valid build keys' min, max and count, a
//           grid-stride reduction whose last block (a ticket) folds the
//           blocks' partials and decides the layout.  jm_zero, on a dense
//           layout: the table's first span + 1 words, the span read from
//           the summary on the card (the table is allocated at limit + 1
//           words, the host not knowing the span).  jm_hist, on a dense
//           layout: every valid build row adds (row << 32) + 1 to the table
//           word of its key - min, so the low half counts the key's rows and
//           the high half is the row itself where the count is 1.  A
//           warp's rows of one key add their count in one atomic (the high
//           half is of no use past a count of 1), and a row whose key
//           already counts more than `cap` rows (join_match.RANK_MAX) adds
//           nothing: that build takes the sorted layout, which reads no
//           count, so a hot key's rows stop contending on its word.  The
//           largest count, capped at cap + 1, reaches the summary by one
//           atomicMax a warp.  No sort.  The wrapper reads the summary
//           once.
//   uniq  - jm_uniq, for a dense build whose keys are unique: a
//           single-pass compaction of the probe rows.  Each block takes the
//           next tile of 8192 rows (a ticket), looks every valid row's key
//           up in the table (one 8-byte word), scans the hits, looks back
//           over the earlier tiles for its offset (common.cuh lb_*) and
//           writes the pairs there; the last tile writes the total.  No
//           count pass and no expansion.
//   order - a dense build with a key of several rows: jm_scan, the same
//           look-back scan over the table's counts into the CSR starts
//           (int32, span + 1 entries), clearing each word for a cursor;
//           then jm_place puts the row of a one-row key at its start and
//           every other row at its start plus a cursor's count (in any
//           order within its key: atomics), and jm_rank moves each of
//           those to its start plus the number of its key's rows below
//           it, so every key's rows stay in row order.  That costs c
//           reads a row for a key of c rows, so the wrapper takes this
//           stage only while the largest count is small
//           (join_match.RANK_MAX) and otherwise the sorted layout.
#include <limits.h>

#include "common.cuh"

#define JM_ITEMS 8
#define JM_TILE (LB_THREADS * JM_ITEMS)  // rows a scan tile
#define JM_MAX_BLOCKS (132 * 8)          // grid_for's most blocks

enum { JM_INDEX = 0, JM_UNIQ = 1, JM_ORDER = 2 };
// the summary's words (ops/kernels/join_match.py SUMMARY)
enum { S_MIN = 0, S_MAX, S_NVALID, S_MAXMULT, S_TOTAL, S_DENSE };

struct MatchArgs {
  i64 nb, np;
  const i64* bk;
  const unsigned char* bn;  // build NULL flags
  const i64* pk;
  const unsigned char* pv;  // probe validity
  i64* sum;                 // the summary
  i64 limit;                // dense while max - min < limit
  u64* tab;                 // span + 1 of limit + 1 words: row << 32 | count
  u64* tctr;                // the scan's tile ticket
  u64* sctr;                // the summary's ticket
  i64* part;                // the summary's partials, 3 a block
  LookBack lb;
  i64* pi;                  // uniq: the pairs
  i64* bi;
  int* starts;              // order: span + 1 CSR starts
  int* tmp;                 // nvalid rows, each key's in any order
  int* rows;                // nvalid rows, each key's in row order
  i64 span;
  i64 cap;                  // index: the largest count the paths read
};

// -- index ----------------------------------------------------------------------

__global__ void __launch_bounds__(TIDB_THREADS) jm_summary(MatchArgs a) {
  __shared__ i64 s_lo[TIDB_THREADS / 32], s_hi[TIDB_THREADS / 32],
      s_n[TIDB_THREADS / 32];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  const i64 first = (i64)blockIdx.x * blockDim.x + tid;
  i64 lo = LLONG_MAX, hi = LLONG_MIN, n = 0;
  for (i64 r = first; r < a.nb; r += stride) {
    if (a.bn[r]) continue;
    const i64 v = a.bk[r];
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
    ++n;
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  n = warp_sum_i64(n);
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_n[warp] = n;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < TIDB_THREADS / 32; ++w) {
      lo = s_lo[w] < lo ? s_lo[w] : lo;
      hi = s_hi[w] > hi ? s_hi[w] : hi;
      n += s_n[w];
    }
    i64* p = a.part + 3 * blockIdx.x;
    *(volatile i64*)&p[0] = lo;
    *(volatile i64*)&p[1] = hi;
    *(volatile i64*)&p[2] = n;
    __threadfence();
    const u64 t = atomicAdd((unsigned long long*)a.sctr, 1ull);
    s_last = t == (u64)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: fold the partials, decide the layout, and leave the
  // ticket at 0 for the next call
  __threadfence();
  lo = LLONG_MAX;
  hi = LLONG_MIN;
  n = 0;
  for (int b = tid; b < (int)gridDim.x; b += TIDB_THREADS) {
    const i64* p = a.part + 3 * b;
    const i64 l = *(volatile const i64*)&p[0], h = *(volatile const i64*)&p[1];
    lo = l < lo ? l : lo;
    hi = h > hi ? h : hi;
    n += *(volatile const i64*)&p[2];
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  n = warp_sum_i64(n);
  __syncthreads();
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_n[warp] = n;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < TIDB_THREADS / 32; ++w) {
      lo = s_lo[w] < lo ? s_lo[w] : lo;
      hi = s_hi[w] > hi ? s_hi[w] : hi;
      n += s_n[w];
    }
    a.sum[S_MIN] = lo;
    a.sum[S_MAX] = hi;
    a.sum[S_NVALID] = n;
    a.sum[S_MAXMULT] = 0;
    a.sum[S_TOTAL] = 0;
    // max - min in 64 unsigned bits is exact for any two int64 keys
    a.sum[S_DENSE] = n > 0 && (u64)hi - (u64)lo < (u64)a.limit;
    *(volatile u64*)a.sctr = 0;
  }
}

// The dense table's words 0 .. span (jm_scan reads the word at span as 0).
__global__ void __launch_bounds__(TIDB_THREADS) jm_zero(MatchArgs a) {
  if (!a.sum[S_DENSE]) return;
  const i64 m = (i64)((u64)a.sum[S_MAX] - (u64)a.sum[S_MIN]) + 2;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (i64)gridDim.x * blockDim.x)
    a.tab[i] = 0;
}

__global__ void __launch_bounds__(TIDB_THREADS) jm_hist(MatchArgs a) {
  if (!a.sum[S_DENSE]) return;
  const u64 mn = (u64)a.sum[S_MIN];
  const int lane = threadIdx.x & 31;
  i64 most = 0;
  // the loop's bound is the warp's, so every lane reaches the match
  for (i64 w = (i64)blockIdx.x * blockDim.x + (threadIdx.x & ~31); w < a.nb;
       w += (i64)gridDim.x * blockDim.x) {
    const i64 r = w + lane;
    const bool live = r < a.nb && !a.bn[r];
    // a dead lane's key, ~0, is past any table word
    const u64 k = live ? (u64)a.bk[r] - mn : ~0ull;
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    if (!live || lane != __ffs(peers) - 1) continue;
    // an L2 read (atomics are L2's): no atomic once the key is past cap
    if ((i64)(__ldcg((const unsigned long long*)&a.tab[k]) & 0xffffffffull) >
        a.cap)
      continue;
    const u64 c = (u64)__popc(peers);
    const u64 old = atomicAdd((unsigned long long*)&a.tab[k],
                              c == 1 ? ((u64)r << 32) | 1ull : c);
    const i64 n = (i64)((old & 0xffffffffull) + c);
    most = n > most ? n : most;
  }
  most = warp_max(most);
  most = most > a.cap + 1 ? a.cap + 1 : most;
  if ((threadIdx.x & 31) == 0 && most > 0)
    atomicMax((unsigned long long*)&a.sum[S_MAXMULT], (unsigned long long)most);
}

// -- uniq -------------------------------------------------------------------------

__global__ void __launch_bounds__(LB_THREADS) jm_uniq(MatchArgs a) {
  __shared__ i64 s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const i64 n_tiles = (a.np + JM_TILE - 1) / JM_TILE;
  const i64 t = lb_take_tile(a.tctr, n_tiles);
  const i64 base = t * JM_TILE;
  const u64 mn = (u64)a.sum[S_MIN];
  i64 hit[JM_ITEMS], ex[JM_ITEMS], b[JM_ITEMS];
#pragma unroll
  for (int j = 0; j < JM_ITEMS; ++j) {
    const i64 r = base + (i64)j * LB_THREADS + tid;
    hit[j] = 0;
    b[j] = 0;
    if (r < a.np && a.pv[r]) {
      const u64 k = (u64)a.pk[r] - mn;
      if (k < (u64)a.span) {
        const u64 w = a.tab[k];
        hit[j] = (w & 0xffffffffull) != 0;
        b[j] = (i64)(w >> 32);
      }
    }
  }
  const i64 run = lb_tile_scan(hit, ex);
  if (warp == 0) {
    const i64 pre = lb_exclusive(a.lb, t, run);
    if (lane == 0) s_prefix = pre;
  }
  __syncthreads();
  const i64 pre = s_prefix;
#pragma unroll
  for (int j = 0; j < JM_ITEMS; ++j) {
    if (hit[j]) {
      const i64 o = pre + ex[j];
      a.pi[o] = base + (i64)j * LB_THREADS + tid;
      a.bi[o] = b[j];
    }
  }
  if (tid == 0 && t == n_tiles - 1) a.sum[S_TOTAL] = pre + run;
}

// -- order ------------------------------------------------------------------------

// The CSR starts: the exclusive scan of the counts over keys 0 .. span
// (the word at span is 0), each word cleared for jm_place's cursor.
__global__ void __launch_bounds__(LB_THREADS) jm_scan(MatchArgs a) {
  __shared__ i64 s_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const i64 m = a.span + 1;
  const i64 n_tiles = (m + JM_TILE - 1) / JM_TILE;
  const i64 t = lb_take_tile(a.tctr, n_tiles);
  const i64 base = t * JM_TILE;
  i64 v[JM_ITEMS], ex[JM_ITEMS];
#pragma unroll
  for (int j = 0; j < JM_ITEMS; ++j) {
    const i64 k = base + (i64)j * LB_THREADS + tid;
    v[j] = 0;
    if (k < m) {
      v[j] = (i64)(a.tab[k] & 0xffffffffull);
      a.tab[k] = 0;
    }
  }
  const i64 run = lb_tile_scan(v, ex);
  if (warp == 0) {
    const i64 pre = lb_exclusive(a.lb, t, run);
    if (lane == 0) s_prefix = pre;
  }
  __syncthreads();
  const i64 pre = s_prefix;
#pragma unroll
  for (int j = 0; j < JM_ITEMS; ++j) {
    const i64 k = base + (i64)j * LB_THREADS + tid;
    if (k < m) a.starts[k] = (int)(pre + ex[j]);
  }
}

__global__ void __launch_bounds__(TIDB_THREADS) jm_place(MatchArgs a) {
  const u64 mn = (u64)a.sum[S_MIN];
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < a.nb;
       r += (i64)gridDim.x * blockDim.x) {
    if (a.bn[r]) continue;
    const u64 k = (u64)a.bk[r] - mn;
    const int s = a.starts[k], c = a.starts[k + 1] - s;
    if (c == 1)
      a.rows[s] = (int)r;
    else
      a.tmp[s + (int)atomicAdd((unsigned long long*)&a.tab[k], 1ull)] = (int)r;
  }
}

__global__ void __launch_bounds__(TIDB_THREADS) jm_rank(MatchArgs a) {
  const u64 mn = (u64)a.sum[S_MIN];
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < a.nb;
       r += (i64)gridDim.x * blockDim.x) {
    if (a.bn[r]) continue;
    const u64 k = (u64)a.bk[r] - mn;
    const int s = a.starts[k], c = a.starts[k + 1] - s;
    if (c < 2) continue;
    int below = 0;
    for (int j = 0; j < c; ++j) below += a.tmp[s + j] < (int)r;
    a.rows[s + below] = (int)r;
  }
}

// hdr (int64): [stage, nb, np, bk, bn, pk, pv, sum, limit, tab, status,
//               status_tiles, epoch, pi, bi, starts, tmp, rows, span, cap]
// status (int64) holds 2 + 3 * JM_MAX_BLOCKS + 3 * status_tiles words,
// zeroed once when it is allocated: the tile ticket, the summary's ticket,
// the summary's partials, then per tile the flag, the aggregate and the
// inclusive prefix; epoch (>= 1) is new for every uniq or order call on a
// status block and grows in stream order.  index: sum holds 6 words, tab
// limit + 1, nb >= 1, cap >= 1.  uniq: pi and bi np words each, np >= 1, span the
// summary's max - min + 1.  order: starts span + 1 words, tmp and rows
// the summary's nvalid words each.
extern "C" int join_match_run(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  MatchArgs a;
  const int stage = (int)hdr[0];
  a.nb = hdr[1];
  a.np = hdr[2];
  a.bk = (const i64*)hdr[3];
  a.bn = (const unsigned char*)hdr[4];
  a.pk = (const i64*)hdr[5];
  a.pv = (const unsigned char*)hdr[6];
  a.sum = (i64*)hdr[7];
  a.limit = hdr[8];
  a.tab = (u64*)hdr[9];
  i64* status = (i64*)hdr[10];
  const i64 status_tiles = hdr[11];
  a.lb.epoch = (u64)hdr[12];
  a.pi = (i64*)hdr[13];
  a.bi = (i64*)hdr[14];
  a.starts = (int*)hdr[15];
  a.tmp = (int*)hdr[16];
  a.rows = (int*)hdr[17];
  a.span = hdr[18];
  a.cap = hdr[19];
  a.tctr = (u64*)status;
  a.sctr = (u64*)status + 1;
  a.part = status + 2;
  a.lb.flag = (u64*)(status + 2 + 3 * JM_MAX_BLOCKS);
  a.lb.agg = status + 2 + 3 * JM_MAX_BLOCKS + status_tiles;
  a.lb.incl = status + 2 + 3 * JM_MAX_BLOCKS + 2 * status_tiles;
  if (!status || !a.sum || !a.tab) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  switch (stage) {
    case JM_INDEX: {
      if (a.nb < 1 || a.nb >= (1LL << 31) || a.limit < 1 || a.cap < 1)
        return (int)cudaErrorInvalidValue;
      jm_summary<<<grid_for(a.nb), TIDB_THREADS, 0, st>>>(a);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      jm_zero<<<grid_for(a.limit + 1), TIDB_THREADS, 0, st>>>(a);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      jm_hist<<<grid_for(a.nb), TIDB_THREADS, 0, st>>>(a);
      return (int)cudaGetLastError();
    }
    case JM_UNIQ: {
      const i64 n_tiles = (a.np + JM_TILE - 1) / JM_TILE;
      if (a.np < 1 || a.span < 1 || a.span > a.limit || !a.pi || !a.bi ||
          status_tiles < n_tiles || a.lb.epoch < 1)
        return (int)cudaErrorInvalidValue;
      jm_uniq<<<(unsigned)n_tiles, LB_THREADS, 0, st>>>(a);
      return (int)cudaGetLastError();
    }
    case JM_ORDER: {
      const i64 n_tiles = (a.span + 1 + JM_TILE - 1) / JM_TILE;
      if (a.nb < 1 || a.span < 1 || a.span > a.limit || !a.starts ||
          !a.tmp || !a.rows || status_tiles < n_tiles || a.lb.epoch < 1)
        return (int)cudaErrorInvalidValue;
      jm_scan<<<(unsigned)n_tiles, LB_THREADS, 0, st>>>(a);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      jm_place<<<grid_for(a.nb), TIDB_THREADS, 0, st>>>(a);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      jm_rank<<<grid_for(a.nb), TIDB_THREADS, 0, st>>>(a);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
