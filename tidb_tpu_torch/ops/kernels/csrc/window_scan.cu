// K10: window functions over the default frame, after the window's sort.
//
// Replaces: tidb_tpu/executor/device_exec.py:1529 device_window.run after
// its lexsort (lines 1569-1667): partition and peer change flags, the
// segment bounds (cummax / reversed cummin), the segmented running scans
// (tidb_tpu/ops/device.py:1042 _seg_running) and the scatter back to input
// order through the inverse permutation.
//
// What it computes, over sorted positions j < n (row r = idx[j], or j when
// idx is null):
//   part[j] = j == 0 || j == n_live || a partition key differs from row
//             j-1's (values NULL-masked to 0, NULL flags compared too,
//             floats compared as doubles so -0.0 and 0.0 are equal);
//   peer[j] = part[j] || an order key differs;
//   spos/ppos = start of j's partition / peer group, epos/pe = its end
//   (pe = epos without ORDER BY); per function, written at r:
//   row_number j-spos+1, rank ppos-spos+1, dense_rank the count of peer
//   starts in [spos, j], percent_rank and cume_dist (doubles, with the
//   reference's m > 1 guard), and count / sum / min / max of an argument
//   over [spos, pe], NULL where that count is 0.
//
// Bound on the card: memory.  idx is read once; each key's data and NULL
// flags, each argument's NULL flags and, for SUM/MIN/MAX, its data are
// read once through idx (a random 32-byte sector per row for a data
// array, the array's own size for a one-byte flag array); each output is
// written once, scattered to input order.
//
// Design: two launches a lane group (one group holds every lane of a
// window unless its shared memory would pass WS_SMEM_MAX).
//   ws_scan  - a single pass over tiles of WS_TILE sorted rows by
//              decoupled look-back.  A block takes the next tile with one
//              atomic add (so every tile it waits on is already running),
//              reads its slice of idx once, gathers each key at its rows
//              (and the row before the tile) once to set the partition and
//              peer flags, and gathers each argument once for all the lanes
//              that read it (its count, and its SUM / MIN / MAX).  Every
//              lane is scanned in the same block; the tile's status record
//              carries all of them, and a tile that holds a partition
//              start stops the look-back of the tiles after it (segmented
//              lanes reset there).  Segment starts are running maxima of
//              the positions where a segment starts (two unsegmented
//              lanes); a segment's end is the next start minus one, a
//              backward minimum over the flags within the tile.  Each row
//              whose frame ends inside its tile is finished here and
//              scattered to input order: a lane's inclusive values stay in
//              shared memory (2 bytes a row for a count, 8 for a value).
//              What stays open is the tile's last peer group (and, for
//              percent_rank / cume_dist, its last partition), whose end
//              lies in a later tile.  The tile that holds that end writes
//              it into the records of every tile the segment covers (one
//              write a tile), and each tile keeps its lanes' values at the
//              end of its first peer group and at its last row.
//   ws_tail  - per tile, the rows left open: their frame's values (the
//              same for the whole peer group, read once a tile) and ends,
//              scattered to input order.  Rows of the last partition that
//              end their peer group inside the tile read back that end and
//              their peer start (written by ws_scan, percent_rank /
//              cume_dist only).
// The scatter to input order, a random write a row, sets the pace, so the
// outputs are row-major: a row's values are consecutive int64 columns
// (four to a 32-byte sector, stored as two 16-byte stores; a window of one
// or two functions has only those columns), only SUM /
// MIN / MAX have NULL columns (one word for four), and every function that
// is never NULL reads one all-zero array, which each tile clears over its
// own input rows (coalesced).  The big random gathers and the rows are
// streamed past L2 (evict first), so the NULL flags stay in it.
// Float sums are segmented scans, never differences of prefix sums, so no
// partition's rounding carries another's magnitude.  The status block is
// never cleared: its flags carry the pass's epoch.
#include "common.cuh"

#define WS_MAX_KEYS 16
#define WS_MAX_ARGS 8    // arguments of one lane group
#define WS_MAX_LANES 16  // count and value lanes of one lane group
#define WS_MAX_FUNCS 24  // functions of one lane group
#define WS_THREADS 256
#define WS_WARPS (WS_THREADS / 32)
#define WS_ITEMS 4
#define WS_TILE (WS_THREADS * WS_ITEMS)
static_assert(WS_TILE == 4 * WS_THREADS, "a tile's all-zero NULL flags are "
              "one 4-byte word a thread");
#define WS_SMEM_MAX (96 * 1024)
#define WS_REC 6  // a tile's record: G, P, tail spos, tail ppos, E_pe, E_ep
#define WS_REC_W (2 + WS_MAX_LANES)
#define WS_NONE 0x7fffffffffffffffLL
#define WS_AGG 1ull
#define WS_INCL 2ull

// lane combines
#define WS_ADD_I 0
#define WS_ADD_F 1
#define WS_MIN_I 2
#define WS_MAX_I 3
#define WS_MIN_F 4
#define WS_MAX_F 5
// lane values
#define WS_SRC_VALID 0  // 1 where the argument is not NULL (a count)
#define WS_SRC_PEER 1   // 1 where a peer group starts (dense_rank)
#define WS_SRC_ARG 2    // the argument, NULL as the combine's identity
// function codes (ops/kernels/window_scan.py FUNC_CODES)
#define WS_ROW_NUMBER 0
#define WS_RANK 1
#define WS_DENSE_RANK 2
#define WS_PERCENT_RANK 3
#define WS_CUME_DIST 4
#define WS_COUNT 5
#define WS_VALUE 6  // sum / min / max: the value lane, NULL where count 0

struct WsFunc {
  int code;
  int cnt, val;  // lanes of the group (-1: none)
  int ncol;      // its column of NULL flags (-1: never NULL)
};

// One lane group's pass, passed by value.
struct WsParams {
  i64 n, n_live, n_tiles;
  const i64* idx;  // null: identity
  int n_part, n_keys;
  unsigned float_keys;  // bit k: key k is a double
  const i64* kcol[WS_MAX_KEYS];
  const unsigned char* knul[WS_MAX_KEYS];
  int n_args;
  const i64* acol[WS_MAX_ARGS];  // null: only the NULL flags are read
  const unsigned char* anul[WS_MAX_ARGS];
  // lanes: count-type lanes (2 bytes a row in shared memory) and value
  // lanes (8 bytes); slot: the index among lanes of the same width
  int n_lanes, n_val;
  unsigned char lop[WS_MAX_LANES], lsrc[WS_MAX_LANES], larg[WS_MAX_LANES],
      lslot[WS_MAX_LANES];
  short lgid[WS_MAX_LANES];  // column of head / tail (-1: not kept)
  int n_funcs;
  WsFunc f[WS_MAX_FUNCS];  // function k of the group is column col0 + k
  int need_pe, need_ep, write_tiles;
  // the outputs, row-major in input order: row r's values at
  // odata[r * ostride + col]; the NULL flags of a SUM / MIN / MAX at
  // onull[r * nstride + ncol]; every other function's flags are zero, one
  // array of n bytes that each tile clears over its own rows
  i64* odata;
  unsigned char* onull;
  unsigned char* zero;
  int ostride, nstride, col0;
  int fcols;  // the group's columns: its functions rounded up to 4, or 1-2
  // status: the tile ticket, per tile a flag (epoch << 3 | start << 2 |
  // state) and the aggregate / inclusive records of WS_REC_W words
  u64* ctr;
  u64* flag;
  i64* agg;
  i64* incl;
  u64 epoch;
  // workspace
  i64* rec;   // n_tiles x WS_REC
  i64* head;  // n_tiles x lt: lanes at the end of the tile's first peer group
  i64* tail;  // n_tiles x lt: lanes at the tile's last row
  int lt;
  i64* wpp;  // per sorted row: peer start, peer end (percent_rank /
  i64* wpe;  // cume_dist rows whose partition ends past their tile)
};

__device__ __forceinline__ i64 ws_op(int op, i64 a, i64 b) {
  switch (op) {
    case WS_ADD_I: return wrap_add(a, b);
    case WS_ADD_F:
      return __double_as_longlong(__longlong_as_double(a) +
                                  __longlong_as_double(b));
    case WS_MIN_I: return a < b ? a : b;
    case WS_MAX_I: return a > b ? a : b;
    case WS_MIN_F: {  // NaN propagates, as torch.minimum / jnp.minimum
      const double x = __longlong_as_double(a), y = __longlong_as_double(b);
      return (x < y || x != x) ? a : b;
    }
    default: {  // WS_MAX_F
      const double x = __longlong_as_double(a), y = __longlong_as_double(b);
      return (x > y || x != x) ? a : b;
    }
  }
}

__device__ __forceinline__ i64 ws_ident(int op) {
  switch (op) {
    case WS_ADD_F: return __double_as_longlong(0.0);
    case WS_MIN_I: return 0x7fffffffffffffffLL;
    case WS_MAX_I: return (i64)0x8000000000000000ULL;
    case WS_MIN_F: return 0x7ff0000000000000LL;        // +inf
    case WS_MAX_F: return (i64)0xfff0000000000000ULL;  // -inf
    default: return 0;
  }
}

// A scan element: bit 0 of hf says it holds something, bit 1 that a
// partition starts in it; v is an int64 or the bits of a double.
struct Seg {
  int hf;
  i64 v;
};

// a is the earlier element, b the later one
__device__ __forceinline__ Seg seg_comb(int op, Seg a, Seg b) {
  if (!(a.hf & 1)) return b;
  if (!(b.hf & 1)) return a;
  Seg r;
  r.hf = 1 | ((a.hf | b.hf) & 2);
  r.v = (b.hf & 2) ? b.v : ws_op(op, a.v, b.v);
  return r;
}

// Exclusive segmented scan of one element per thread across the block, in
// thread order; *tot gets the block's total.  Every thread calls it.
__device__ Seg block_scan_seg(int op, Seg x, Seg* tot) {
  __shared__ int s_hf[WS_WARPS];
  __shared__ i64 s_v[WS_WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    Seg u;
    u.hf = __shfl_up_sync(0xffffffffu, x.hf, o);
    u.v = __shfl_up_sync(0xffffffffu, x.v, o);
    if (lane >= o) x = seg_comb(op, u, x);
  }
  Seg ex;
  ex.hf = __shfl_up_sync(0xffffffffu, x.hf, 1);
  ex.v = __shfl_up_sync(0xffffffffu, x.v, 1);
  if (lane == 0) ex.hf = 0;
  if (lane == 31) {
    s_hf[w] = x.hf;
    s_v[w] = x.v;
  }
  __syncthreads();
  Seg p, all;
  p.hf = all.hf = 0;
  p.v = all.v = 0;
  for (int k = 0; k < WS_WARPS; ++k) {
    Seg t;
    t.hf = s_hf[k];
    t.v = s_v[k];
    if (k < w) p = seg_comb(op, p, t);
    all = seg_comb(op, all, t);
  }
  *tot = all;
  __syncthreads();  // the shared totals are reused by the next call
  return seg_comb(op, p, ex);
}

// Exclusive scan of the pair (x, y) across the block's threads with a
// commutative `op` (max or min): in thread order, or with REV over the
// threads after this one.  *tx / *ty get the block's totals.
template <bool REV, typename Op>
__device__ void block_excl2(i64* x, i64* y, i64 id, Op op, i64* tx, i64* ty) {
  __shared__ i64 s_x[WS_WARPS], s_y[WS_WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  i64 ix = *x, iy = *y;
  for (int o = 1; o < 32; o <<= 1) {
    const i64 ux = REV ? __shfl_down_sync(0xffffffffu, ix, o)
                       : __shfl_up_sync(0xffffffffu, ix, o);
    const i64 uy = REV ? __shfl_down_sync(0xffffffffu, iy, o)
                       : __shfl_up_sync(0xffffffffu, iy, o);
    if (REV ? lane + o < 32 : lane >= o) {
      ix = op(ix, ux);
      iy = op(iy, uy);
    }
  }
  i64 ex = REV ? __shfl_down_sync(0xffffffffu, ix, 1)
               : __shfl_up_sync(0xffffffffu, ix, 1);
  i64 ey = REV ? __shfl_down_sync(0xffffffffu, iy, 1)
               : __shfl_up_sync(0xffffffffu, iy, 1);
  if (REV ? lane == 31 : lane == 0) ex = ey = id;
  if (REV ? lane == 0 : lane == 31) {
    s_x[w] = ix;
    s_y[w] = iy;
  }
  __syncthreads();
  i64 px = id, py = id, ax = id, ay = id;
  for (int k = 0; k < WS_WARPS; ++k) {
    if (REV ? k > w : k < w) {
      px = op(px, s_x[k]);
      py = op(py, s_y[k]);
    }
    ax = op(ax, s_x[k]);
    ay = op(ay, s_y[k]);
  }
  *x = op(px, ex);
  *y = op(py, ey);
  *tx = ax;
  *ty = ay;
  __syncthreads();
}

struct MaxOp {
  __device__ i64 operator()(i64 a, i64 b) const { return a > b ? a : b; }
};
struct MinOp {
  __device__ i64 operator()(i64 a, i64 b) const { return a < b ? a : b; }
};

__device__ __forceinline__ bool ws_differs(bool fl, i64 x, bool xn, i64 y,
                                           bool yn) {
  if (xn != yn) return true;
  if (xn) return false;  // both NULL: both values masked to 0
  if (fl) return __longlong_as_double(x) != __longlong_as_double(y);
  return x != y;
}

// The record element k's combine: the two position lanes take the max.
__device__ __forceinline__ int rec_op(const WsParams& p, int k) {
  return k < 2 ? WS_MAX_I : (int)p.lop[k - 2];
}

__device__ __forceinline__ i64 rec_ident(const WsParams& p, int k) {
  return k < 2 ? -1 : ws_ident(p.lop[k - 2]);
}

// Warp 0: publish tile t's record `vals` (WS_REC_W words, 2 + n_lanes
// used) in `state`.
__device__ void ws_publish(const WsParams& p, i64 t, const i64* vals,
                           bool start, u64 state) {
  const int lane = threadIdx.x & 31;
  i64* dst = state == WS_INCL ? p.incl : p.agg;
  if (lane < 2 + p.n_lanes)
    *(volatile i64*)&dst[t * WS_REC_W + lane] = vals[lane];
  __threadfence();
  __syncwarp();
  if (lane == 0) {
    __threadfence();
    *(volatile u64*)&p.flag[t] =
        (p.epoch << 3) | ((u64)(start ? 1 : 0) << 2) | state;
  }
}

// Warp 0: tile t's exclusive prefix record into pre[].  Walks back over
// the tiles before t, 32 at a time, until one has published its
// inclusive record or holds a partition start (every lane resets there,
// and the positions' maxima are there or later).
__device__ void ws_lookback(const WsParams& p, i64 t, i64* pre) {
  const int lane = threadIdx.x & 31, W = 2 + p.n_lanes;
  const int op = lane < W ? rec_op(p, lane) : WS_MAX_I;
  i64 acc = lane < W ? rec_ident(p, lane) : 0;
  bool acc_start = false;
  for (i64 top = t - 1;; top -= 32) {
    const i64 q = top - lane;
    u64 f = (WS_INCL | 4ull);
    if (q >= 0) {
      do {
        f = *(volatile u64*)&p.flag[q];
      } while ((f >> 3) != p.epoch);
    }
    __threadfence();
    const unsigned m_incl = __ballot_sync(0xffffffffu, (f & 3) == WS_INCL);
    const unsigned m_st = __ballot_sync(0xffffffffu, ((f >> 2) & 1) != 0);
    const unsigned m = m_incl | m_st;
    const int stop = m ? __ffs(m) - 1 : 31;
    if (lane < W) {
      i64 v = 0;
      for (int i = stop; i >= 0; --i) {  // oldest first
        const i64 qi = top - i;
        const i64* src = ((m_incl >> i) & 1) ? p.incl : p.agg;
        const i64 x = *(volatile const i64*)&src[qi * WS_REC_W + lane];
        v = (i == stop || ((m_st >> i) & 1)) ? x : ws_op(op, v, x);
      }
      if (!acc_start) acc = ws_op(op, v, acc);
    }
    acc_start = acc_start || m != 0;
    if (m) break;
  }
  if (lane < W) pre[lane] = acc;
}

// Shared-memory index of a tile's local row q (thread q / WS_ITEMS, item
// q % WS_ITEMS): consecutive threads store to consecutive words.
__device__ __forceinline__ int sidx(int q) {
  return (q % WS_ITEMS) * WS_THREADS + q / WS_ITEMS;
}

// A row's chunk of four output columns (orow 16-byte aligned): the
// columns whose bit is set in wm, as two 16-byte stores, a 16-byte store a
// pair, or one store each.  Streaming stores: a row is written once.
__device__ __forceinline__ void ws_store4(i64* orow, const i64 (&v)[4],
                                          unsigned wm) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned m = (wm >> (2 * h)) & 3u;
    if (m == 3u) {
      __stcs((longlong2*)orow + h, make_longlong2(v[2 * h], v[2 * h + 1]));
    } else {
#pragma unroll
      for (int q = 2 * h; q < 2 * h + 2; ++q)
        if ((wm >> q) & 1u) __stcs(orow + q, v[q]);
    }
  }
}

// The padding columns of a row's chunk of four from column c: past the
// group's functions, inside its columns.
__device__ __forceinline__ unsigned ws_pad(const WsParams& p, int c) {
  if (c + 4 <= p.n_funcs) return 0u;
  const int w = p.fcols - c < 4 ? p.fcols - c : 4;
  return ((1u << w) - 1u) & ~((1u << (p.n_funcs - c)) - 1u);
}

// The NULL flags (byte q of nb4) of the chunk's SUM / MIN / MAX whose bit
// is set in nm: one word where all four are and their columns are
// consecutive from a multiple of 4, else a byte each.
__device__ __forceinline__ void ws_store_nulls(const WsParams& p, int c,
                                               unsigned char* nrow,
                                               unsigned nb4, unsigned nm) {
  if (!nm) return;
  const int n0 = p.f[c].ncol;
  if (nm == 0xfu && (n0 & 3) == 0 && p.f[c + 3].ncol == n0 + 3) {
    *(unsigned*)(nrow + n0) = nb4;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if ((nm >> q) & 1u)
      nrow[p.f[c + q].ncol] = (unsigned char)((nb4 >> (8 * q)) & 1u);
}

__device__ __forceinline__ i64 pct_rank(i64 sp, i64 pp, i64 ep) {
  const i64 m = ep - sp + 1, rk = pp - sp;
  const double d = m > 1 ? (double)rk / (double)(m - 1 > 1 ? m - 1 : 1) : 0.0;
  return __double_as_longlong(d);
}

__device__ __forceinline__ i64 cume(i64 sp, i64 pe, i64 ep) {
  return __double_as_longlong((double)(pe - sp + 1) / (double)(ep - sp + 1));
}

__global__ void __launch_bounds__(WS_THREADS, 3) ws_scan(const WsParams p) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  i64* s_val = (i64*)s_dyn;  // value lanes, WS_TILE words each
  unsigned short* s_cnt =
      (unsigned short*)(s_dyn + (size_t)p.n_val * WS_TILE * 8);
  __shared__ i64 s_kd[WS_THREADS];
  __shared__ unsigned char s_kn[WS_THREADS];
  __shared__ i64 s_tile, s_rprev;
  __shared__ i64 s_agg[WS_REC_W], s_pre[WS_REC_W];
  const int tid = threadIdx.x;
  if (tid == 0) {
    const i64 t = (i64)atomicAdd((unsigned long long*)p.ctr, 1ull);
    if (t == p.n_tiles - 1) atomicExch((unsigned long long*)p.ctr, 0ull);
    s_tile = t;
  }
  __syncthreads();
  const i64 t = s_tile, a = t * WS_TILE;
  const i64 b = (a + WS_TILE < p.n ? a + WS_TILE : p.n) - 1;
  const bool last = t == p.n_tiles - 1;
  const i64 j0 = a + (i64)tid * WS_ITEMS;  // this thread's first row
  unsigned valid = 0;
  i64 r[WS_ITEMS];
#pragma unroll
  for (int i = 0; i < WS_ITEMS; ++i) {
    const i64 j = j0 + i;
    r[i] = 0;
    if (j < p.n) {
      valid |= 1u << i;
      r[i] = p.idx ? p.idx[j] : j;
    }
  }
  if (tid == 0) s_rprev = a > 0 ? (p.idx ? p.idx[a - 1] : a - 1) : 0;

  // -- the change flags: each key gathered once a row ---------------------
  unsigned part = 0, peer = 0;
#pragma unroll
  for (int i = 0; i < WS_ITEMS; ++i)
    if (j0 + i == 0 || j0 + i == p.n_live) part |= 1u << i;
  for (int k = 0; k < p.n_keys; ++k) {
    const i64* col = p.kcol[k];
    const unsigned char* nul = p.knul[k];
    const bool fl = (p.float_keys >> k) & 1;
    i64 d[WS_ITEMS];
    unsigned nl = 0;
#pragma unroll
    for (int i = 0; i < WS_ITEMS; ++i) {
      const i64 x = __ldcs(col + r[i]);  // read once: evict first
      const bool xn = nul[r[i]] != 0;
      d[i] = xn ? 0 : x;
      nl |= (xn ? 1u : 0u) << i;
    }
    __syncthreads();  // s_rprev is set; the last key's exchange is read
    s_kd[tid] = d[WS_ITEMS - 1];
    s_kn[tid] = (nl >> (WS_ITEMS - 1)) & 1;
    i64 pd = 0;
    bool pn = false;
    if (tid == 0 && a > 0) {
      const bool xn = nul[s_rprev] != 0;
      pd = xn ? 0 : col[s_rprev];
      pn = xn;
    }
    __syncthreads();
    if (tid > 0) {
      pd = s_kd[tid - 1];
      pn = s_kn[tid - 1] != 0;
    }
    unsigned diff = 0;
#pragma unroll
    for (int i = 0; i < WS_ITEMS; ++i) {
      const bool xn = (nl >> i) & 1;
      if (ws_differs(fl, pd, pn, d[i], xn)) diff |= 1u << i;
      pd = d[i];
      pn = xn;
    }
    if (tid == 0 && a == 0) diff |= 1u;  // row 0 starts anyway
    if (k < p.n_part)
      part |= diff;
    else
      peer |= diff;
  }
  part &= valid;
  peer = (peer | part) & valid;

  // -- positions: segment starts (running maxima), next starts -----------
  i64 sp_x = part ? j0 + 31 - __clz(part) : -1;  // last start in my rows
  i64 pp_x = peer ? j0 + 31 - __clz(peer) : -1;
  i64 agg_sp, agg_pp;
  block_excl2<false>(&sp_x, &pp_x, -1, MaxOp(), &agg_sp, &agg_pp);
  i64 np_x = part ? j0 + __ffs(part) - 1 : WS_NONE;  // first start in mine
  i64 nq_x = peer ? j0 + __ffs(peer) - 1 : WS_NONE;
  i64 first_part, first_peer;
  block_excl2<true>(&np_x, &nq_x, WS_NONE, MinOp(), &first_part,
                    &first_peer);

  // -- the lanes: each argument gathered once for all its lanes -----------
  for (int g = -1; g < p.n_args; ++g) {
    // g = -1: the lanes that read no argument (dense_rank's peer count)
    i64 d[WS_ITEMS];
    unsigned nl = 0;
    bool any = false;
    for (int l = 0; l < p.n_lanes; ++l)
      any |= g < 0 ? p.lsrc[l] == WS_SRC_PEER
                   : (p.lsrc[l] != WS_SRC_PEER && p.larg[l] == g);
    if (!any) continue;
    if (g >= 0) {
      const i64* col = p.acol[g];
      const unsigned char* nul = p.anul[g];
#pragma unroll
      for (int i = 0; i < WS_ITEMS; ++i) {
        d[i] = col ? __ldcs(col + r[i]) : 0;
        nl |= (nul[r[i]] != 0 ? 1u : 0u) << i;
      }
    }
    for (int l = 0; l < p.n_lanes; ++l) {
      const int src = p.lsrc[l];
      if (g < 0 ? src != WS_SRC_PEER : (src == WS_SRC_PEER || p.larg[l] != g))
        continue;
      const int op = p.lop[l];
      const i64 id = ws_ident(op);
      // the lane's element at item i (recomputed: registers are scarce)
      auto elem = [&](int i) {
        const bool xn = (nl >> i) & 1;
        Seg e;
        e.hf = ((valid >> i) & 1) | (((part >> i) & 1) << 1);
        e.v = src == WS_SRC_PEER ? (i64)((peer >> i) & 1)
              : src == WS_SRC_VALID ? (i64)(xn ? 0 : 1)
                                    : (xn ? id : d[i]);
        return e;
      };
      Seg acc;
      acc.hf = 0;
      acc.v = 0;
#pragma unroll
      for (int i = 0; i < WS_ITEMS; ++i) acc = seg_comb(op, acc, elem(i));
      Seg tot;
      Seg run = block_scan_seg(op, acc, &tot);
      const bool wide = src == WS_SRC_ARG;
#pragma unroll
      for (int i = 0; i < WS_ITEMS; ++i) {
        run = seg_comb(op, run, elem(i));
        const int q = tid * WS_ITEMS + i;
        if (wide)
          s_val[p.lslot[l] * WS_TILE + sidx(q)] = run.v;
        else
          s_cnt[p.lslot[l] * WS_TILE + sidx(q)] = (unsigned short)run.v;
      }
      if (tid == 0) s_agg[2 + l] = tot.v;
    }
  }

  // -- the look-back: one status record carries every lane --------------
  const bool start = agg_sp >= a;  // a partition starts in this tile
  if (tid == 0) {
    s_agg[0] = agg_sp;
    s_agg[1] = agg_pp;
  }
  __syncthreads();
  if (tid < 32) {
    ws_publish(p, t, s_agg, start, start ? WS_INCL : WS_AGG);
    if (t > 0) {
      ws_lookback(p, t, s_pre);
    } else if (tid < 2 + p.n_lanes) {
      s_pre[tid] = rec_ident(p, tid);
    }
    __syncwarp();
    if (!start) {  // the inclusive record: the prefix, then this tile
      if (tid < 2 + p.n_lanes)
        s_agg[tid] = ws_op(rec_op(p, tid), s_pre[tid], s_agg[tid]);
      __syncwarp();
      ws_publish(p, t, s_agg, false, WS_INCL);
    }
  }
  __syncthreads();
  // s_agg now holds the tile's inclusive record (the values at row b; a
  // tile with a partition start restarts every lane, so there it is the
  // aggregate)
  const i64 pre_sp = s_pre[0], pre_pp = s_pre[1];

  // -- the finish of every row whose frame ends inside the tile ----------
  i64 sp = sp_x > pre_sp ? sp_x : pre_sp;
  i64 pp = pp_x > pre_pp ? pp_x : pre_pp;
#pragma unroll
  for (int i = 0; i < WS_ITEMS; ++i) {
    if (!((valid >> i) & 1)) break;
    const i64 j = j0 + i;
    if ((part >> i) & 1) sp = j;
    if ((peer >> i) & 1) pp = j;
    const bool head = sp < a;  // the partition began before the tile
    const unsigned after = ~((2u << i) - 1);
    const i64 np = (part & after) ? j0 + __ffs(part & after) - 1 : np_x;
    const i64 nq = (peer & after) ? j0 + __ffs(peer & after) - 1 : nq_x;
    const bool ep_known = np != WS_NONE || last;
    const bool pe_known = nq != WS_NONE || last;
    const i64 ep = np != WS_NONE ? np - 1 : p.n - 1;
    const i64 pe = nq != WS_NONE ? nq - 1 : p.n - 1;
    const int qe = sidx((int)(pe - a));
    if (p.need_ep && pe_known && !ep_known) {
      p.wpp[j] = pp;
      p.wpe[j] = pe;
    }
    // the row's functions four at a time: one 32-byte sector of values
    // (two 16-byte stores) when all four are known here
    i64* orow = p.odata + r[i] * p.ostride + p.col0;
    unsigned char* nrow = p.onull + r[i] * p.nstride;
    for (int c = 0; c < p.n_funcs; c += 4) {
      i64 v[4];
      // padding columns are written with the rest
      const unsigned pad = ws_pad(p, c);
      unsigned nb4 = 0, wm = pad, nm = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = 0;
        if (c + q >= p.n_funcs) continue;
        const WsFunc& f = p.f[c + q];
        bool w = true, isnull = false;
        switch (f.code) {
          case WS_ROW_NUMBER: v[q] = j - sp + 1; break;
          case WS_RANK: v[q] = pp - sp + 1; break;
          case WS_DENSE_RANK:
            v[q] = s_cnt[p.lslot[f.val] * WS_TILE + sidx(i + tid * WS_ITEMS)] +
                   (head ? s_pre[2 + f.val] : 0);
            break;
          case WS_PERCENT_RANK:
            w = ep_known;
            v[q] = pct_rank(sp, pp, ep);
            break;
          case WS_CUME_DIST:
            w = ep_known;
            v[q] = cume(sp, pe, ep);
            break;
          case WS_COUNT:
            w = pe_known;
            if (w)
              v[q] = s_cnt[p.lslot[f.cnt] * WS_TILE + qe] +
                     (head ? s_pre[2 + f.cnt] : 0);
            break;
          default:  // WS_VALUE
            w = pe_known;
            if (w) {
              const i64 n_ok = s_cnt[p.lslot[f.cnt] * WS_TILE + qe] +
                               (head ? s_pre[2 + f.cnt] : 0);
              v[q] = s_val[p.lslot[f.val] * WS_TILE + qe];
              if (head) v[q] = ws_op(p.lop[f.val], s_pre[2 + f.val], v[q]);
              isnull = n_ok == 0;
            }
            break;
        }
        wm |= (w ? 1u : 0u) << q;
        nb4 |= (isnull ? 1u : 0u) << (8 * q);
        nm |= (w && f.ncol >= 0 ? 1u : 0u) << q;
      }
      if (wm & ~pad) ws_store4(orow + c, v, wm);
      ws_store_nulls(p, c, nrow, nb4, nm);
    }
  }

  // the NULL flags of the functions that are never NULL: input rows
  // [a, b], whichever tile finishes them
  if (p.zero && p.write_tiles) {
    if (b - a + 1 == WS_TILE)
      ((unsigned*)(p.zero + a))[tid] = 0u;
    else
      for (i64 u = a + tid; u <= b; u += WS_THREADS) p.zero[u] = 0;
  }

  // -- what the tiles after this one and ws_tail read ---------------------
  const i64 tail_sp = s_agg[0], tail_pp = s_agg[1];
  if (tid < p.n_lanes && p.lgid[tid] >= 0) {
    const int l = tid;
    p.tail[t * p.lt + p.lgid[l]] = s_agg[2 + l];
    // the end of the first peer group, which began before the tile
    const i64 h = (first_peer != WS_NONE ? first_peer : b + 1) - 1;
    if (h >= a) {
      const int qh = sidx((int)(h - a));
      const i64 loc = p.lsrc[l] == WS_SRC_ARG
                          ? s_val[p.lslot[l] * WS_TILE + qh]
                          : (i64)s_cnt[p.lslot[l] * WS_TILE + qh];
      p.head[t * p.lt + p.lgid[l]] = ws_op(p.lop[l], s_pre[2 + l], loc);
    }
  }
  if (!p.write_tiles) return;
  if (tid == 0) {
    i64* rc = p.rec + t * WS_REC;
    rc[0] = tail_pp > a ? tail_pp : a;  // G: the last peer group's start
    rc[1] = tail_sp > a ? tail_sp : a;  // P: the last partition's start
    rc[2] = tail_sp;
    rc[3] = tail_pp;
  }
  // the segments that end here (or at this tile's first start): their
  // end into the record of every earlier tile they cover
  if (t > 0) {
    for (int s = 0; s < 2; ++s) {
      const i64 first = s == 0 ? first_peer : first_part;
      if (first == WS_NONE && !last) continue;
      const i64 e = (first != WS_NONE ? first : p.n) - 1;
      const i64 t0 = (s == 0 ? pre_pp : pre_sp) / WS_TILE;
      for (i64 u = t0 + tid; u < t; u += WS_THREADS)
        p.rec[u * WS_REC + 4 + s] = e;
    }
  }
}

// The rows ws_scan left open: per tile, the last peer group (its frame's
// values and end) and, for percent_rank / cume_dist, the last partition.
__global__ void __launch_bounds__(WS_THREADS) ws_tail(const WsParams p) {
  __shared__ i64 s_rec[WS_REC];
  __shared__ i64 s_lv[WS_MAX_LANES];
  const int tid = threadIdx.x;
  for (i64 t = blockIdx.x; t < p.n_tiles - 1; t += gridDim.x) {
    if (tid < WS_REC) s_rec[tid] = p.rec[t * WS_REC + tid];
    __syncthreads();
    const i64 G = s_rec[0], P = s_rec[1], sp = s_rec[2], tpp = s_rec[3],
              epe = s_rec[4], eep = s_rec[5];
    if (p.need_pe && tid < p.n_lanes && p.lgid[tid] >= 0) {
      const i64 te = epe / WS_TILE;
      const i64 te_end = (te * WS_TILE + WS_TILE < p.n ? te * WS_TILE + WS_TILE
                                                      : p.n) - 1;
      const i64* src = epe == te_end ? p.tail : p.head;
      s_lv[tid] = src[te * p.lt + p.lgid[tid]];
    }
    __syncthreads();
    const i64 b = t * WS_TILE + WS_TILE - 1;
    for (i64 j = (p.need_ep ? P : G) + tid; j <= b; j += WS_THREADS) {
      const i64 r = p.idx ? p.idx[j] : j;
      const bool grp = j >= G;  // in the tile's last peer group
      const i64 pp = grp ? tpp : p.wpp[j];
      const i64 pe = grp ? epe : p.wpe[j];
      i64* orow = p.odata + r * p.ostride + p.col0;
      unsigned char* nrow = p.onull + r * p.nstride;
      for (int c = 0; c < p.n_funcs; c += 4) {
        i64 v[4];
        unsigned nb4 = 0, wm = 0, nm = 0;
        const unsigned pad = ws_pad(p, c);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = 0;
          if (c + q >= p.n_funcs) continue;
          const WsFunc& f = p.f[c + q];
          switch (f.code) {
            case WS_PERCENT_RANK:
              v[q] = pct_rank(sp, pp, eep);
              wm |= 1u << q;
              break;
            case WS_CUME_DIST:
              v[q] = cume(sp, pe, eep);
              wm |= 1u << q;
              break;
            case WS_COUNT:
              if (grp) {
                v[q] = s_lv[f.cnt];
                wm |= 1u << q;
              }
              break;
            case WS_VALUE:
              if (grp) {
                v[q] = s_lv[f.val];
                nb4 |= (s_lv[f.cnt] == 0 ? 1u : 0u) << (8 * q);
                wm |= 1u << q;
                nm |= 1u << q;
              }
              break;
            default: break;  // row_number, rank, dense_rank: ws_scan wrote
          }
        }
        if (wm) ws_store4(orow + c, v, wm | pad);
        ws_store_nulls(p, c, nrow, nb4, nm);
      }
    }
    __syncthreads();  // the next tile overwrites s_rec / s_lv
  }
}

// hdr (int64), see ops/kernels/window_scan.py pack_header:
//   [0] n, n_live, idx, n_part, n_keys, float_keys, n_tiles, n_groups,
//   [8] ctr, flag, agg, incl, epoch0, rec, head, tail, lt, wpp, wpe,
//   [19] odata, onull, ostride, nstride, zero,
//   [24] per key k < WS_MAX_KEYS: col, nul,
//   [56] per group (HDR_GROUP words): n_args, n_lanes, n_val, n_funcs,
//        need_pe, need_ep, smem, col0, then per argument: col, nul; per
//        lane: op, src, arg, slot, gid; per function: code, cnt, val,
//        ncol.
#define HDR_KEYS 24
#define HDR_GROUPS (HDR_KEYS + 2 * WS_MAX_KEYS)
#define HDR_GROUP (8 + 2 * WS_MAX_ARGS + 5 * WS_MAX_LANES + 4 * WS_MAX_FUNCS)

extern "C" int window_scan_run(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // per device: set on every call (the current device may change)
  cudaError_t e = cudaFuncSetAttribute(
      ws_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, WS_SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  WsParams p;
  p.n = hdr[0];
  p.n_live = hdr[1];
  p.idx = (const i64*)hdr[2];
  p.n_part = (int)hdr[3];
  p.n_keys = (int)hdr[4];
  p.float_keys = (unsigned)hdr[5];
  p.n_tiles = hdr[6];
  const int n_groups = (int)hdr[7];
  p.ctr = (u64*)hdr[8];
  p.flag = (u64*)hdr[9];
  p.agg = (i64*)hdr[10];
  p.incl = (i64*)hdr[11];
  const u64 epoch0 = (u64)hdr[12];
  p.rec = (i64*)hdr[13];
  p.head = (i64*)hdr[14];
  p.tail = (i64*)hdr[15];
  p.lt = (int)hdr[16];
  p.wpp = (i64*)hdr[17];
  p.wpe = (i64*)hdr[18];
  p.odata = (i64*)hdr[19];
  p.onull = (unsigned char*)hdr[20];
  p.ostride = (int)hdr[21];
  p.nstride = (int)hdr[22];
  p.zero = (unsigned char*)hdr[23];
  if (p.n < 1 || p.n_keys > WS_MAX_KEYS || p.n_part > p.n_keys ||
      n_groups < 1 || epoch0 < 1 ||
      p.n_tiles != (p.n + WS_TILE - 1) / WS_TILE || p.n_tiles > 0x7fffffffLL ||
      (p.ostride % 4 && p.ostride > 2) || p.nstride < 0)
    return (int)cudaErrorInvalidValue;
  if (((u64)p.odata & 15) || ((u64)p.onull & 3) || ((u64)p.zero & 3))
    return (int)cudaErrorMisalignedAddress;
  for (int k = 0; k < WS_MAX_KEYS; ++k) {
    p.kcol[k] = (const i64*)hdr[HDR_KEYS + 2 * k];
    p.knul[k] = (const unsigned char*)hdr[HDR_KEYS + 2 * k + 1];
  }
  for (int g = 0; g < n_groups; ++g) {
    const i64* h = hdr + HDR_GROUPS + (i64)g * HDR_GROUP;
    p.n_args = (int)h[0];
    p.n_lanes = (int)h[1];
    p.n_val = (int)h[2];
    p.n_funcs = (int)h[3];
    p.need_pe = (int)h[4];
    p.need_ep = (int)h[5];
    const size_t smem = (size_t)h[6];
    p.col0 = (int)h[7];
    p.fcols = (p.n_funcs + 3) / 4 * 4;
    if (p.fcols > p.ostride - p.col0) p.fcols = p.ostride - p.col0;
    if (p.n_args > WS_MAX_ARGS || p.n_lanes > WS_MAX_LANES ||
        p.n_funcs > WS_MAX_FUNCS || smem > WS_SMEM_MAX ||
        smem < (size_t)p.n_val * WS_TILE * 8 +
                   (size_t)(p.n_lanes - p.n_val) * WS_TILE * 2 ||
        p.col0 % 4 || p.fcols < p.n_funcs)
      return (int)cudaErrorInvalidValue;
    const i64* ha = h + 8;
    for (int k = 0; k < WS_MAX_ARGS; ++k) {
      p.acol[k] = (const i64*)ha[2 * k];
      p.anul[k] = (const unsigned char*)ha[2 * k + 1];
    }
    const i64* hl = ha + 2 * WS_MAX_ARGS;
    for (int l = 0; l < WS_MAX_LANES; ++l) {
      p.lop[l] = (unsigned char)hl[5 * l];
      p.lsrc[l] = (unsigned char)hl[5 * l + 1];
      p.larg[l] = (unsigned char)hl[5 * l + 2];
      p.lslot[l] = (unsigned char)hl[5 * l + 3];
      p.lgid[l] = (short)hl[5 * l + 4];
    }
    const i64* hf = hl + 5 * WS_MAX_LANES;
    for (int f = 0; f < WS_MAX_FUNCS; ++f) {
      p.f[f].code = (int)hf[4 * f];
      p.f[f].cnt = (int)hf[4 * f + 1];
      p.f[f].val = (int)hf[4 * f + 2];
      p.f[f].ncol = (int)hf[4 * f + 3];
      if (f < p.n_funcs &&
          (p.f[f].ncol >= p.nstride ||
           (p.f[f].ncol < 0 ? !p.zero : p.f[f].code != WS_VALUE)))
        return (int)cudaErrorInvalidValue;
    }
    p.write_tiles = g == 0;
    p.epoch = epoch0 + (u64)g;
    ws_scan<<<(unsigned)p.n_tiles, WS_THREADS, smem, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (p.n_tiles > 1 && (p.need_pe || p.need_ep)) {
      const i64 blocks = p.n_tiles - 1 < 132 * 8 ? p.n_tiles - 1 : 132 * 8;
      ws_tail<<<(unsigned)blocks, WS_THREADS, 0, st>>>(p);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  return 0;
}
