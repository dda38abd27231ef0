// K8/K9 merge: the fold of partial aggregate states into one state.
//
// Replaces: tidb_tpu/executor/device_exec.py:1323 merge_partial_states
// (its device branch: jnp.concatenate of every state's slots with an
// arange < n_groups mask, then _agg_impl with the merge ops), shared by
// the streamed scan-aggregate (K8, device_exec.py:1019) and the paged
// probe join (K9, device_join.py:1394).
//
// Bound on the card: memory.  The least work reads every part's live
// slots (keys, key NULL flags, results, result NULL flags) and its group
// count once and writes the `merge_cap` output slots once; least time =
// those bytes / 3.35 TB/s.
//
// Design: a merge of sorted runs.  Every part is a K1 state or a fold of
// them, so its first min(n_groups, capacity) slots hold distinct keys in
// the fold's own output order (ascending packed key with a pack, NULL
// packed to 0; without one, per key by (NULL flag, value), NULL after
// every value).  The fold is then a stable merge of the parts' live runs,
// part 0 first: no hash table, no slot-space workspace, one read of the
// live slots.  A row's order key is W unsigned words compared in turn:
// the packed key (W = 1), or per key its NULL flag and its value
// (W = 2 nk), each value biased by 2^63 so signed order is word order.
//
// * ms_bounds (for folds past 64 tiles; smaller ones search their
//   boundaries in ms_merge's blocks, one launch): one warp a tile
//   boundary, a lane a part.  For rank r = t T it searches the key space
//   word by word, rank(x) = sum over parts of the rows below x (binary
//   searches in brackets that only narrow, the value interpolated between
//   the ranks of the range's ends), and stops at the first key whose rank
//   lies in [r - P + 1, r]: every copy of a key falls in one tile, and a
//   tile holds at most T + P - 1 rows (T = 4096 for one word), whatever
//   the skew.  It writes each part's split.
// * ms_merge: a block a tile, tiles taken in the order blocks start (one
//   ticket each).  Where the tile's rows share every order word but the
//   last and that word spans fewer than MS_SPAN values (the packed key of
//   a dense fold: Q18's orderkeys, Q1's flags), rows are placed by
//   counting: a bit a part for each value (atomicOr in shared memory), a
//   scan of the values' bit counts gives each key's first merged position
//   and its group, and a key's rows follow in part order.  Otherwise the
//   tile stages its order words and places each row by ranking (its index
//   in its run, upper_bound in the parts before it, lower_bound in the
//   parts after it: a stable merge) and scans the first row of each run
//   of equal keys.  The tile's offset comes from a single-pass decoupled
//   look-back over the tiles' group counts (as join_expand.cu and
//   window_scan.cu).  Each group is combined from its rows in part order
//   (at most P of them) and written once, at consecutive slots, below
//   `merge_cap`; n_groups counts every group.  Blocks past the last tile
//   wait for its inclusive count and clear the slots from n_groups to
//   `merge_cap`: no launch clears the output first.
// * The invariant is checked where the rows are read anyway: each row
//   against the one before it in its part (its key's offset, or its
//   staged words; at a tile's edge the row before from device memory).  A
//   part out of order, or a tile past its bound, sets the call's fault
//   word beside n_groups; the wrapper's read of n_groups raises on it.
//
// The part table (per part: a pointer to its n_groups, its capacity and
// a pointer per key, key NULL flag, result and result NULL flag) travels
// by value in the launch's 4 KB of parameters where it fits (448 words:
// Q18's fold takes 54, Q1's 330), else from device memory, where the
// wrapper copies it through a reused pinned buffer; each block copies it
// into shared memory.  At most 32 parts a launch: the wrapper folds more
// in groups of 32, each group a state in the same order.
#include "common.cuh"

#define MS_MAX_KEYS 8
#define MS_MAX_AGGS 32
#define MS_MAX_PARTS 32
#define MS_THREADS 512
#define MS_WARPS (MS_THREADS / 32)
#define MS_TAIL 8192  // output slots a tail block clears
#define MS_SPAN 7680  // key values a tile places by counting (6 bytes each)
// table words a launch's parameters carry: with the header, 4 KB
#define MS_TABLE_WORDS 448
#define MS_AGG 1u
#define MS_INCL 2u

enum { MS_SUM_I = 1, MS_SUM_F = 2, MS_MIN = 3, MS_MAX = 4, MS_FIRST = 5 };

typedef unsigned int u32;

struct MsHead {
  int n_parts, nk, m;
  int W;       // order words a row: 1 with a pack, else 2 nk
  int pack;    // 1: rows ordered by the packed key
  int stride;  // table words a part: 2 + 2 nk + 2 m
  int tile;    // T: merged rows a tile
  int tcap;    // rows a tile's shared memory holds: T + 32
  int bits[MS_MAX_KEYS];
  i64 offs[MS_MAX_KEYS];
  int op[MS_MAX_AGGS];
  int flt[MS_MAX_AGGS];  // 1: the result is float64
  i64 cap;               // merge_cap
  i64 n_tiles;
  i64* bounds;  // (n_tiles + 1) x 32 splits; null: ms_merge searches them
  const i64* table;  // the part table in device memory, or null: by value
  i64* out_i;   // nk keys, m results (cap each), n_groups, fault word
  unsigned char* out_b;  // nk key NULL flags, m result NULL flags, valid
  // scan status on the stream: ticket counter, fault (the epoch of the
  // last faulty call), per tile a flag (epoch << 2 | state), aggregate
  // and inclusive group count
  u64* ctr;
  u64* fault;
  u64* flag;
  i64* agg;
  i64* incl;
  u64 epoch;
  u64 epoch_lo;  // the first epoch of the wrapper's call (a fold of groups)
};

struct MsParams {
  MsHead h;
  i64 t[MS_TABLE_WORDS];
};

// -- order words ------------------------------------------------------------------

// Order word w of row `row` of the part whose table row is `pt`.
__device__ __forceinline__ u64 ms_word(const MsHead& h, const i64* pt, i64 row,
                                       int w) {
  if (h.pack) {
    // as groupby_agg.py _packed: (packed << bits) | (NULL ? 0 : key + off + 1)
    u64 packed = 0;
    for (int i = 0; i < h.nk; ++i) {
      const bool nl = __ldg((const unsigned char*)pt[2 + h.nk + i] + row) != 0;
      const u64 f = nl ? 0ull
                       : (u64)__ldg((const i64*)pt[2 + i] + row) +
                             (u64)(h.offs[i] + 1);
      packed = (h.bits[i] >= 64 ? 0ull : packed << h.bits[i]) | f;
    }
    return packed ^ (1ull << 63);
  }
  const int i = w >> 1;
  const bool nl = __ldg((const unsigned char*)pt[2 + h.nk + i] + row) != 0;
  if (!(w & 1)) return nl ? 1ull : 0ull;
  return nl ? 0ull : (u64)__ldg((const i64*)pt[2 + i] + row) ^ (1ull << 63);
}

// Rows of [lo, hi) whose word w is below x, plus lo (the rows of the
// bracket share every word before w).
__device__ __forceinline__ i64 ms_below(const MsHead& h, const i64* pt, i64 lo,
                                        i64 hi, int w, u64 x) {
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (ms_word(h, pt, mid, w) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Staged rows a and b compared: -1, 0 or 1.
__device__ __forceinline__ int ms_cmp(const u64* skey, int W, int tcap, int a,
                                      int b) {
  for (int w = 0; w < W; ++w) {
    const u64 x = skey[w * tcap + a], y = skey[w * tcap + b];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

__device__ __forceinline__ i64 ms_warp_sum(i64 v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ u64 ms_warp_min(u64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}
__device__ __forceinline__ u64 ms_warp_max(u64 v) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

__device__ __forceinline__ i64 ms_live(const i64* pt) {
  const i64 n = *(const i64*)pt[0], cap = pt[1];
  return n < 0 ? 0 : (n > cap ? cap : n);
}

// -- the boundary search ------------------------------------------------------------

// This lane's split of the boundary at rank r (0 < r < the live rows): the
// rows of its part below the first key whose rank (rows below it, over
// every part) lies in [rmin, r].  [blo, bhi): the lane's bracket to
// start from, sum(blo) <= r < sum(bhi).  Word by word: the rows sharing
// the words fixed so far form a bracket in each part; search the next
// word's value over the brackets' range, and fix it where the rank stays
// at or below r.  The
// search interpolates between the ranks of its ends, aiming at the middle
// of [rmin, r], and bisects after any step that did not halve the range
// (merge_states.py select_split mirrors it).
__device__ __forceinline__ i64 ms_select(const MsHead& h, const i64* pt,
                                         i64 blo, i64 bhi, i64 r, i64 rmin) {
  const i64 aim = r - (r - rmin) / 2;
  for (int w = 0; w < h.W; ++w) {
    i64 rl = ms_warp_sum(blo);
    if (rl >= rmin) return blo;
    u64 lo = ~0ull, hi = 0;
    if (blo < bhi) {
      lo = ms_word(h, pt, blo, w);
      hi = ms_word(h, pt, bhi - 1, w);
    }
    lo = ms_warp_min(lo);
    hi = ms_warp_max(hi);
    // the largest x in [lo, hi] whose rank is at most r: rank(lo) = rl <=
    // r; l and u are each lane's rows below xl and below xh
    u64 xl = lo;
    i64 l = blo, u = bhi;
    // rank(hi + 1) is every bracket row; only at the top of the word's
    // range is hi itself probed
    i64 c = hi == ~0ull ? ms_below(h, pt, blo, bhi, w, hi) : bhi;
    i64 rc = ms_warp_sum(c);
    if (rc <= r) {
      if (rc >= rmin) return c;
      xl = hi;
      l = c;
    } else {
      u64 xh = hi == ~0ull ? hi : hi + 1;
      i64 ru = rc;
      u = c;
      bool bisect = false;
      while (xh - xl > 1) {
        const u64 span = xh - xl;
        u64 mid;
        if (bisect) {
          mid = xl + (span >> 1);
        } else {
          const double d = (double)(aim - rl) / (double)(ru - rl) * (double)span;
          const u64 off = d < (double)span ? (u64)d : span - 1;
          mid = xl + (off < 1 ? 1 : (off > span - 1 ? span - 1 : off));
        }
        c = ms_below(h, pt, l, u, w, mid);
        rc = ms_warp_sum(c);
        if (rc <= r) {
          if (rc >= rmin) return c;
          xl = mid;
          l = c;
          rl = rc;
        } else {
          xh = mid;
          u = c;
          ru = rc;
        }
        bisect = !bisect && xh - xl > (span >> 1);
      }
    }
    // the rows whose word w is xl: the next word decides among them
    blo = l;
    bhi = u;
  }
  // every word fixed: blo is the key's lower rank, in (r - P, r]
  return blo;
}

// This lane's split of the boundary at rank t T (live: the lane's live
// rows; [lo, hi): its bracket to search from).
__device__ __forceinline__ i64 ms_split(const MsHead& h, const i64* pt,
                                        i64 live, i64 n, i64 t, i64 lo,
                                        i64 hi) {
  const i64 r = t * (i64)h.tile;
  if (r <= 0) return 0;
  if (r >= n) return live;
  return ms_select(h, pt, lo, hi, r, r - (h.n_parts - 1));
}

// A warp a boundary, a lane a part.
__global__ void __launch_bounds__(MS_THREADS) ms_bounds(const MsParams prm) {
  extern __shared__ __align__(16) unsigned char ms_smem[];
  const MsHead& h = prm.h;
  i64* s_tab = (i64*)ms_smem;
  const i64* src = h.table ? h.table : prm.t;
  const int nw = h.n_parts * h.stride;
  for (int i = threadIdx.x; i < nw; i += MS_THREADS) s_tab[i] = src[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const i64 t = (i64)blockIdx.x * MS_WARPS + warp;
  if (t > h.n_tiles) return;
  const bool on = lane < h.n_parts;
  const i64* pt = s_tab + (on ? lane : 0) * h.stride;
  const i64 live = on ? ms_live(pt) : 0;
  const i64 split = ms_split(h, pt, live, ms_warp_sum(live), t, 0, live);
  if (on) h.bounds[t * MS_MAX_PARTS + lane] = split;
}

// -- the look-back --------------------------------------------------------------------

__device__ __forceinline__ void ms_publish(const MsHead& h, i64 t, u32 state,
                                           i64 v) {
  if (state == MS_INCL)
    *(volatile i64*)&h.incl[t] = v;
  else
    *(volatile i64*)&h.agg[t] = v;
  __threadfence();
  *(volatile u64*)&h.flag[t] = (h.epoch << 2) | state;
}

// Warp 0: the groups of the tiles before tile t, whose own count is `sum`.
__device__ __forceinline__ i64 ms_lookback(const MsHead& h, i64 t, i64 sum) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) ms_publish(h, t, t == 0 ? MS_INCL : MS_AGG, sum);
  if (t == 0) return 0;
  i64 excl = 0;
  for (i64 top = t - 1;; top -= 32) {
    const i64 p = top - lane;
    u32 state = MS_INCL;
    i64 v = 0;
    if (p >= 0) {
      u64 f;
      do {
        f = *(volatile u64*)&h.flag[p];
      } while ((f >> 2) != h.epoch);
      __threadfence();
      state = (u32)(f & 3);
      v = state == MS_INCL ? *(volatile i64*)&h.incl[p]
                           : *(volatile i64*)&h.agg[p];
    }
    const unsigned mk = __ballot_sync(0xffffffffu, state == MS_INCL);
    const int stop = mk ? __ffs(mk) - 1 : 31;
    excl += ms_warp_sum(lane <= stop ? v : 0);
    if (mk) break;
  }
  if (lane == 0) ms_publish(h, t, MS_INCL, excl + sum);
  return excl;
}

// -- the merge -------------------------------------------------------------------------

// A tail block: clear the output slots [k MS_TAIL, (k + 1) MS_TAIL) at or
// past n_groups, once the last tile has published its inclusive count.
__device__ __forceinline__ void ms_tail(const MsHead& h, i64 k) {
  __shared__ i64 s_n;
  const i64 lo0 = k * MS_TAIL;
  const i64 hi = lo0 + MS_TAIL < h.cap ? lo0 + MS_TAIL : h.cap;
  if (threadIdx.x == 0) {
    const i64 last = h.n_tiles - 1;
    const u64 want = (h.epoch << 2) | MS_INCL;
    while (*(volatile u64*)&h.flag[last] != want) __nanosleep(256);
    __threadfence();
    s_n = *(volatile i64*)&h.incl[last];
  }
  __syncthreads();
  const i64 lo = lo0 > s_n ? lo0 : s_n;
  if (lo >= hi) return;
  for (int c = 0; c < h.nk + h.m; ++c) {
    i64* col = h.out_i + (i64)c * h.cap;
    for (i64 s = lo + threadIdx.x; s < hi; s += MS_THREADS) col[s] = 0;
  }
  for (int c = 0; c <= h.nk + h.m; ++c) {
    unsigned char* col = h.out_b + (i64)c * h.cap;
    for (i64 s = lo + threadIdx.x; s < hi; s += MS_THREADS) col[s] = 0;
  }
}

// One result of a group from its rows at merged positions [pos, end), in
// part order, as groupby_agg.py groupby_plain folds them: sums over the
// non-NULL rows (int64 wraps, float64 in order), min / max from +-inf or
// the int64 limits with NaN winning; NULL only where every row is NULL.
__device__ __forceinline__ void ms_combine(const MsHead& h, const i64* s_tab,
                                           const unsigned short* sord,
                                           const int* srow, const i64* s_start,
                                           const int* s_off, int a, int pos,
                                           int end, i64* v_out, bool* n_out) {
  const int op = h.op[a], flt = h.flt[a];
  const int vcol = 2 + 2 * h.nk + a, ncol = vcol + h.m;
  i64 acc = 0;
  double facc = 0.0;
  if (op == MS_MIN) {
    acc = 0x7fffffffffffffffll;
    facc = __longlong_as_double(0x7ff0000000000000ll);
  } else if (op == MS_MAX) {
    acc = (i64)0x8000000000000000ull;
    facc = __longlong_as_double((i64)0xfff0000000000000ull);
  }
  bool any = false;
  for (int q = pos; q < end; ++q) {
    const int j = sord[q];
    const int p = srow[j] & 31;
    const i64* pt = s_tab + p * h.stride;
    const i64 row = s_start[p] + (j - s_off[p]);
    if (__ldg((const unsigned char*)pt[ncol] + row)) continue;
    const i64 v = __ldg((const i64*)pt[vcol] + row);
    any = true;
    if (op == MS_SUM_I) {
      acc = wrap_add(acc, v);
    } else if (op == MS_SUM_F) {
      facc += __longlong_as_double(v);
    } else if (flt) {
      const double d = __longlong_as_double(v);
      if (facc != facc || d != d)  // NaN wins
        facc = __longlong_as_double(0x7ff8000000000000ll);
      else if (op == MS_MIN ? d < facc : d > facc)
        facc = d;
    } else {
      acc = op == MS_MIN ? (v < acc ? v : acc) : (v > acc ? v : acc);
    }
  }
  *v_out = (op == MS_SUM_F || flt) ? __double_as_longlong(facc) : acc;
  *n_out = !any;
}

// Every thread's v: its exclusive prefix over the block's threads in
// order; *total: the block's sum.  Every thread must call it.
__device__ __forceinline__ int ms_block_scan(int v, int* s_wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // the last scan's readers are done with s_wsum
  if (lane == 31) s_wsum[warp] = x;
  __syncthreads();
  int wbase = 0, tot = 0;
  for (int k = 0; k < MS_WARPS; ++k) {
    if (k < warp) wbase += s_wsum[k];
    tot += s_wsum[k];
  }
  *total = tot;
  return wbase + x - v;
}

// Staged row j's part: the last part whose run starts at or before j.
__device__ __forceinline__ int ms_part_of(const int* s_off, int j) {
  int p = 0;
  while (s_off[p + 1] <= j) ++p;
  return p;
}

// Rows a and b of the part `pt` compared over every order word.
__device__ __forceinline__ int ms_cmp_rows(const MsHead& h, const i64* pt,
                                           i64 a, i64 b) {
  for (int w = 0; w < h.W; ++w) {
    const u64 x = ms_word(h, pt, a, w), y = ms_word(h, pt, b, w);
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

__global__ void __launch_bounds__(MS_THREADS) ms_merge(const MsParams prm) {
  extern __shared__ __align__(16) unsigned char ms_smem[];
  const MsHead& h = prm.h;
  __shared__ i64 s_ticket, s_prefix;
  __shared__ i64 s_start[MS_MAX_PARTS];
  __shared__ i64 s_split[2][MS_MAX_PARTS];
  __shared__ int s_off[MS_MAX_PARTS + 1];
  __shared__ int s_wsum[MS_WARPS];
  __shared__ int s_fault, s_count, s_span;
  __shared__ u64 s_kmin;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    // tiles in the order blocks start, so every tile a block waits on is
    // already running; the last taker leaves the counter at 0
    const i64 tk = (i64)atomicAdd((unsigned long long*)h.ctr, 1ull);
    if (tk == (i64)gridDim.x - 1) atomicExch((unsigned long long*)h.ctr, 0ull);
    s_ticket = tk;
    s_fault = 0;
  }
  __syncthreads();
  const i64 t = s_ticket;
  if (t >= h.n_tiles) {
    ms_tail(h, t - h.n_tiles);
    return;
  }
  const int W = h.W, tcap = h.tcap, P = h.n_parts;
  const int nw = P * h.stride;
  i64* s_tab = (i64*)ms_smem;
  unsigned char* kreg = ms_smem + ((nw * 8 + 15) & ~15);
  const int kbytes = W * tcap * 8 > 6 * MS_SPAN ? W * tcap * 8 : 6 * MS_SPAN;
  // a staged row's part, and its key's offset << 5; the merged order (a
  // staged row a position) and each group's first position, 16 bits each
  int* srow = (int*)(kreg + kbytes);
  unsigned short* sord = (unsigned short*)(srow + tcap);
  unsigned short* shead = sord + tcap;
  const i64* src = h.table ? h.table : prm.t;
  for (int i = tid; i < nw; i += MS_THREADS) s_tab[i] = src[i];
  __syncthreads();

  // this tile's run of each part, [split at rank t T, split at (t + 1) T):
  // from ms_bounds, or searched here (warp 0 the start, warp 1 the end)
  if (warp < 2) {
    const bool on = lane < P;
    const i64* pt = s_tab + (on ? lane : 0) * h.stride;
    i64 x;
    if (h.bounds) {
      x = on ? h.bounds[(t + warp) * MS_MAX_PARTS + lane] : 0;
    } else {
      const i64 live = on ? ms_live(pt) : 0;
      x = ms_split(h, pt, live, ms_warp_sum(live), t + warp, 0, live);
    }
    if (on) s_split[warp][lane] = x;
  }
  __syncthreads();
  if (warp == 0) {
    const i64 s = lane < P ? s_split[0][lane] : 0;
    const i64 e = lane < P ? s_split[1][lane] : 0;
    const bool bad = s < 0 || e < s;
    const i64 len = bad ? 0 : e - s;
    i64 x = len;
    for (int o = 1; o < 32; o <<= 1) {
      const i64 y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    const i64 total = __shfl_sync(0xffffffffu, x, 31);
    const bool fault = __any_sync(0xffffffffu, bad) || total > tcap;
    if (lane < P) {
      s_start[lane] = s;
      s_off[lane] = fault ? 0 : (int)(x - len);
    }
    // the tile's key range from each run's first and last rows: where
    // every row shares all words but the last, and the last spans fewer
    // than MS_SPAN values, the rows are placed by counting (s_span > 0)
    const bool has = !fault && len > 0;
    const i64* pt = s_tab + (lane < P ? lane : 0) * h.stride;
    bool counting = true;
    u64 mn = 0, mx = 0;
    for (int w = 0; w < W; ++w) {
      mn = ms_warp_min(has ? ms_word(h, pt, s, w) : ~0ull);
      mx = ms_warp_max(has ? ms_word(h, pt, e - 1, w) : 0ull);
      if (w < W - 1 && mn != mx && total > 0) counting = false;
    }
    if (lane == 0) {
      s_off[P] = fault ? 0 : (int)total;
      if (fault) s_fault = 1;
      s_kmin = mn;
      s_span = fault || total == 0
                   ? 0
                   : (counting && mx - mn < (u64)MS_SPAN ? (int)(mx - mn + 1)
                                                          : -1);
    }
  }
  __syncthreads();
  int R = s_off[P];
  const int span = s_span;

  if (span >= 0) {
    // counting: a bit a part for each key of the range, scanned into
    // each key's first merged position; a key's rows follow in part
    // order, and the first of them heads its group
    u32* smask = (u32*)kreg;
    unsigned short* sstart = (unsigned short*)(smask + MS_SPAN);
    const u64 kmin = s_kmin;
    for (int k = tid; k < span; k += MS_THREADS) smask[k] = 0;
    __syncthreads();
#pragma unroll 4
    for (int j = tid; j < R; j += MS_THREADS) {
      const int p = ms_part_of(s_off, j);
      const i64* pt = s_tab + p * h.stride;
      const i64 row = s_start[p] + (j - s_off[p]);
      const u64 k = ms_word(h, pt, row, W - 1) - kmin;
      if (k >= (u64)span) {  // outside the range of its run's ends
        s_fault = 1;
        srow[j] = p;
        continue;
      }
      srow[j] = ((int)k << 5) | p;
      atomicOr(&smask[k], 1u << p);
    }
    __syncthreads();
    if (s_fault) R = 0;
    const int cs = (span + MS_THREADS - 1) / MS_THREADS;
    const int k0 = min(tid * cs, R ? span : 0), k1 = min(k0 + cs, R ? span : 0);
    int rows = 0, groups = 0;
    for (int k = k0; k < k1; ++k) {
      const u32 mk = smask[k];
      rows += __popc(mk);
      groups += mk != 0;
    }
    int n_rows, n_groups;
    int rb = ms_block_scan(rows, s_wsum, &n_rows);
    int gb = ms_block_scan(groups, s_wsum, &n_groups);
    for (int k = k0; k < k1; ++k) {
      const u32 mk = smask[k];
      if (!mk) continue;
      sstart[k] = (unsigned short)rb;
      shead[gb++] = (unsigned short)rb;
      rb += __popc(mk);
    }
    if (tid == 0) s_count = n_groups;
    __syncthreads();
    for (int j = tid; j < R; j += MS_THREADS) {
      const int sr = srow[j], p = sr & 31, k = sr >> 5;
      sord[sstart[k] + __popc(smask[k] & ((1u << p) - 1u))] =
          (unsigned short)j;
      // above the row before it in its part: the tile's rows share every
      // word but the last, so within the tile the offsets compare; the
      // first row of a run against the row before the tile, every word
      bool ok;
      if (j > s_off[p]) {
        ok = (srow[j - 1] >> 5) < k;
      } else {
        const i64 row = s_start[p];
        ok = row == 0 ||
             ms_cmp_rows(h, s_tab + p * h.stride, row - 1, row) < 0;
      }
      if (!ok) s_fault = 1;
    }
  } else {
    // ranking: stage the order words, place each row by its index in its
    // run, upper_bound in the parts before it and lower_bound in the parts
    // after it (a stable merge), and check its part's order
    u64* skey = (u64*)kreg;
    for (int j = tid; j < R; j += MS_THREADS) {
      const int p = ms_part_of(s_off, j);
      srow[j] = p;
      const i64* pt = s_tab + p * h.stride;
      const i64 row = s_start[p] + (j - s_off[p]);
      for (int w = 0; w < W; ++w) skey[w * tcap + j] = ms_word(h, pt, row, w);
    }
    __syncthreads();
    for (int j = tid; j < R; j += MS_THREADS) {
      const int p = srow[j];
      const int i = j - s_off[p];
      int pos = i;
      for (int q = 0; q < P; ++q) {
        if (q == p) continue;
        int lo = s_off[q], hi = s_off[q + 1];
        const int lim = q < p ? 1 : 0;  // upper_bound before p, lower after
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ms_cmp(skey, W, tcap, mid, j) < lim) lo = mid + 1; else hi = mid;
        }
        pos += lo - s_off[q];
      }
      sord[pos] = (unsigned short)j;
      bool ok = true;
      if (i > 0) {
        ok = ms_cmp(skey, W, tcap, j - 1, j) < 0;
      } else if (s_start[p] > 0) {
        const i64* pt = s_tab + p * h.stride;
        const i64 row = s_start[p] - 1;
        int c = 0;
        for (int w = 0; w < W && c == 0; ++w) {
          const u64 x = ms_word(h, pt, row, w), y = skey[w * tcap + j];
          c = x < y ? -1 : (x > y ? 1 : 0);
        }
        ok = c < 0;
      }
      if (!ok) s_fault = 1;
    }
    __syncthreads();
    if (s_fault) R = 0;
    // the first row of each run of equal keys heads a group; scan the
    // heads over chunks of consecutive merged positions
    const int C = (R + MS_THREADS - 1) / MS_THREADS;
    const int b0 = min(tid * C, R), b1 = min(b0 + C, R);
    int cnt = 0;
    for (int q = b0; q < b1; ++q)
      cnt += q == 0 || ms_cmp(skey, W, tcap, sord[q - 1], sord[q]) != 0;
    int n_groups;
    int g = ms_block_scan(cnt, s_wsum, &n_groups);
    for (int q = b0; q < b1; ++q)
      if (q == 0 || ms_cmp(skey, W, tcap, sord[q - 1], sord[q]) != 0)
        shead[g++] = (unsigned short)q;
    if (tid == 0) s_count = n_groups;
  }
  __syncthreads();
  const bool fault = s_fault != 0;
  const int count = fault ? 0 : s_count;
  if (fault) R = 0;
  if (tid == 0 && fault) {
    atomicMax((unsigned long long*)h.fault, (unsigned long long)h.epoch);
    __threadfence();
  }
  if (warp == 0) {
    const i64 pre = ms_lookback(h, t, count);
    if (lane == 0) s_prefix = pre;
  }
  __syncthreads();
  const i64 base = s_prefix;

  // each group from its rows (merged positions up to the next head), at
  // consecutive slots: keys and `first` from its first row
  const int n_out = base >= h.cap ? 0 : (int)min((i64)count, h.cap - base);
  for (int gl = tid; gl < n_out; gl += MS_THREADS) {
    const i64 slot = base + gl;
    const int pos = shead[gl];
    const int end = gl + 1 < count ? shead[gl + 1] : R;
    const int j0 = sord[pos];
    const int p0 = srow[j0] & 31;
    const i64* pt0 = s_tab + p0 * h.stride;
    const i64 row0 = s_start[p0] + (j0 - s_off[p0]);
    for (int i = 0; i < h.nk; ++i) {
      h.out_i[(i64)i * h.cap + slot] = __ldg((const i64*)pt0[2 + i] + row0);
      h.out_b[(i64)i * h.cap + slot] =
          __ldg((const unsigned char*)pt0[2 + h.nk + i] + row0);
    }
    for (int a = 0; a < h.m; ++a) {
      i64 v;
      bool nl;
      if (h.op[a] == MS_FIRST) {
        v = __ldg((const i64*)pt0[2 + 2 * h.nk + a] + row0);
        nl = __ldg((const unsigned char*)pt0[2 + 2 * h.nk + h.m + a] + row0);
      } else {
        ms_combine(h, s_tab, sord, srow, s_start, s_off, a, pos, end, &v, &nl);
      }
      h.out_i[(i64)(h.nk + a) * h.cap + slot] = v;
      h.out_b[(i64)(h.nk + a) * h.cap + slot] = nl;
    }
    h.out_b[(i64)(h.nk + h.m) * h.cap + slot] = 1;
  }
  if (tid == 0 && t == h.n_tiles - 1) {
    // every tile before this one published, each after its fault check;
    // a fold of groups reports the groups' faults too (epochs >= epoch_lo)
    __threadfence();
    const bool any = *(volatile u64*)h.fault >= h.epoch_lo;
    h.out_i[(i64)(h.nk + h.m) * h.cap] = base + count;
    h.out_i[(i64)(h.nk + h.m) * h.cap + 1] = any ? 1 : 0;
  }
}

// -- the launcher --------------------------------------------------------------------

static int ms_launch(const MsHead& hd, const i64* table, int n_words,
                     i64 merge_smem, i64 bounds_smem, cudaStream_t st) {
  // the shared-memory opt-in, once a device
  static bool attr_set[TIDB_MAX_DEVICES];
  int dev = 0;
  cudaError_t e = current_device(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(
        ms_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(
        ms_bounds, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  MsParams prm;
  prm.h = hd;
  if (!hd.table)
    for (int i = 0; i < n_words; ++i) prm.t[i] = table[i];
  if (hd.bounds) {
    const i64 warps = hd.n_tiles + 1;
    const i64 blocks = (warps + MS_WARPS - 1) / MS_WARPS;
    ms_bounds<<<(unsigned)blocks, MS_THREADS, bounds_smem, st>>>(prm);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const i64 tails = (hd.cap + MS_TAIL - 1) / MS_TAIL;
  ms_merge<<<(unsigned)(hd.n_tiles + tails), MS_THREADS, merge_smem, st>>>(
      prm);
  return (int)cudaGetLastError();
}

// hdr (int64), mirrored by ops/kernels/merge_states.py pack_header:
//   0 n_parts, 1 nk, 2 m, 3 W, 4 pack, 5 stride, 6 tile, 7 tcap, 8 cap,
//   9 n_tiles, 10 bounds, 11 out_i, 12 out_b, 13 ctr, 14 fault, 15 flag,
//   16 agg, 17 incl, 18 epoch, 19 merge kernel's shared bytes, 20 the
//   bounds kernel's, 21 epoch_lo, 24 + i bits, 32 + i offsets, 40 + a op,
//   72 + a float.
// table: n_words int64 (n_parts rows of `stride` words), by value (at most
// MS_TABLE_WORDS), or table_dev: the same words in device memory (then
// `table` is not read).
extern "C" int ms_fold_run(const i64* hdr, const i64* table, i64 n_words,
                           const i64* table_dev, void* stream) {
  MsHead h;
  h.n_parts = (int)hdr[0];
  h.nk = (int)hdr[1];
  h.m = (int)hdr[2];
  h.W = (int)hdr[3];
  h.pack = (int)hdr[4];
  h.stride = (int)hdr[5];
  h.tile = (int)hdr[6];
  h.tcap = (int)hdr[7];
  h.cap = hdr[8];
  h.n_tiles = hdr[9];
  if (h.n_parts < 1 || h.n_parts > MS_MAX_PARTS || h.nk < 1 ||
      h.nk > MS_MAX_KEYS || h.m < 0 || h.m > MS_MAX_AGGS || h.W < 1 ||
      h.W > 2 * MS_MAX_KEYS || h.stride != 2 + 2 * h.nk + 2 * h.m ||
      n_words != (i64)h.n_parts * h.stride || h.n_tiles < 1 || h.cap < 1 ||
      h.tcap < h.tile + MS_MAX_PARTS - 1)
    return (int)cudaErrorInvalidValue;
  h.bounds = (i64*)hdr[10];
  h.table = table_dev;
  h.out_i = (i64*)hdr[11];
  h.out_b = (unsigned char*)hdr[12];
  h.ctr = (u64*)hdr[13];
  h.fault = (u64*)hdr[14];
  h.flag = (u64*)hdr[15];
  h.agg = (i64*)hdr[16];
  h.incl = (i64*)hdr[17];
  h.epoch = (u64)hdr[18];
  h.epoch_lo = (u64)hdr[21];
  for (int i = 0; i < MS_MAX_KEYS; ++i) {
    h.bits[i] = i < h.nk ? (int)hdr[24 + i] : 0;
    h.offs[i] = i < h.nk ? hdr[32 + i] : 0;
  }
  for (int a = 0; a < MS_MAX_AGGS; ++a) {
    h.op[a] = a < h.m ? (int)hdr[40 + a] : 0;
    h.flt[a] = a < h.m ? (int)hdr[72 + a] : 0;
  }
  if (!table_dev && n_words > MS_TABLE_WORDS) return (int)cudaErrorInvalidValue;
  return ms_launch(h, table, (int)n_words, hdr[19], hdr[20],
                   (cudaStream_t)stream);
}
