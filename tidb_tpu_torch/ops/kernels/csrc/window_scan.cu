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
// written once.
//
// Design (simple and correct first): one pass writes the change flags
// (one byte per sorted row).  Every running quantity is a "lane": a
// segmented scan of (reset flag, value) with one combine (int add, double
// add, min, max, or keep-first for positions), forward, or backward for
// the segment ends.  All lanes run together as the y dimension of a
// three-pass tile scan: per tile the lane's values are gathered, stored
// and reduced; one block per lane scans the tile aggregates; each tile
// rescans from its carry.  Float sums are segmented scans, never
// differences of global prefix sums, so one partition's rounding never
// carries another's magnitude.  A last pass reads every function at the
// row's frame end and scatters it to input order.
#include "common.cuh"

#define WS_MAX_KEYS 16
#define WS_ITEMS 8
#define WS_TILE (TIDB_THREADS * WS_ITEMS)
#define WS_CARRY_THREADS 1024

// lane combines
#define WS_ADD_I 0
#define WS_ADD_F 1
#define WS_MIN_I 2
#define WS_MAX_I 3
#define WS_MIN_F 4
#define WS_MAX_F 5
#define WS_FIRST 6
// lane values
#define WS_SRC_POS 0    // the sorted position j
#define WS_SRC_PEER 1   // 1 where a peer group starts
#define WS_SRC_VALID 2  // 1 where the argument is not NULL
#define WS_SRC_ARG 3    // the argument, NULL as the combine's identity
// function codes (ops/kernels/window_scan.py FUNC_CODES)
#define WS_ROW_NUMBER 0
#define WS_RANK 1
#define WS_DENSE_RANK 2
#define WS_PERCENT_RANK 3
#define WS_CUME_DIST 4
#define WS_COUNT 5
#define WS_VALUE 6  // sum / min / max: the value lane, NULL where count 0

// A scan element: bit 0 of hf says it holds something, bit 1 that a
// segment starts in it; v is an int64 or the bits of a double.
struct Seg {
  int hf;
  i64 v;
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
    case WS_MAX_F: {
      const double x = __longlong_as_double(a), y = __longlong_as_double(b);
      return (x > y || x != x) ? a : b;
    }
    default: return a;  // WS_FIRST
  }
}

// a is the earlier element, b the later one
__device__ __forceinline__ Seg seg_comb(int op, Seg a, Seg b) {
  if (!(a.hf & 1)) return b;
  if (!(b.hf & 1)) return a;
  Seg r;
  r.hf = 1 | ((a.hf | b.hf) & 2);
  r.v = (b.hf & 2) ? b.v : ws_op(op, a.v, b.v);
  return r;
}

// Segmented scan of one element per thread across the block, in thread
// order (blockDim a multiple of 32, at most 1024).  Returns the inclusive
// prefix; *excl gets the exclusive one (empty for thread 0), *tot the
// block's total.  Every thread of the block must call it.
__device__ Seg block_scan_seg(int op, Seg x, Seg* excl, Seg* tot) {
  __shared__ int s_hf[32];
  __shared__ i64 s_v[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
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
  if (w == 0) {
    Seg t;
    t.hf = lane < nw ? s_hf[lane] : 0;
    t.v = lane < nw ? s_v[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      Seg u;
      u.hf = __shfl_up_sync(0xffffffffu, t.hf, o);
      u.v = __shfl_up_sync(0xffffffffu, t.v, o);
      if (lane >= o) t = seg_comb(op, u, t);
    }
    if (lane < nw) {
      s_hf[lane] = t.hf;
      s_v[lane] = t.v;
    }
  }
  __syncthreads();
  if (w > 0) {
    Seg p;
    p.hf = s_hf[w - 1];
    p.v = s_v[w - 1];
    x = seg_comb(op, p, x);
    ex = seg_comb(op, p, ex);
  }
  tot->hf = s_hf[nw - 1];
  tot->v = s_v[nw - 1];
  *excl = ex;
  __syncthreads();  // the shared totals are reused by the next call
  return x;
}

// -- pass 1: change flags ------------------------------------------------------

struct FlagArgs {
  i64 n, n_live;
  const i64* idx;  // null: identity
  int n_part, n_keys;  // keys [0, n_part) partition, [n_part, n_keys) order
  const i64* col[WS_MAX_KEYS];
  const unsigned char* nul[WS_MAX_KEYS];
  int is_float[WS_MAX_KEYS];
  unsigned char* flags;  // bit 0 partition start, bit 1 peer-group start
};

__device__ __forceinline__ bool key_differs(const FlagArgs& a, int k, i64 r,
                                            i64 r1) {
  const bool n0 = a.nul[k][r] != 0, n1 = a.nul[k][r1] != 0;
  if (n0 != n1) return true;
  if (n0) return false;  // both NULL: both values masked to 0
  const i64 x = a.col[k][r], y = a.col[k][r1];
  if (a.is_float[k]) return __longlong_as_double(x) != __longlong_as_double(y);
  return x != y;
}

__global__ void ws_flags(FlagArgs a) {
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < a.n;
       j += (i64)gridDim.x * blockDim.x) {
    bool part = j == 0 || j == a.n_live;
    bool peer = part;
    if (!part) {
      const i64 r = a.idx ? a.idx[j] : j, r1 = a.idx ? a.idx[j - 1] : j - 1;
      for (int k = 0; k < a.n_part && !part; ++k) part = key_differs(a, k, r, r1);
      peer = part;
      for (int k = a.n_part; k < a.n_keys && !peer; ++k)
        peer = key_differs(a, k, r, r1);
    }
    a.flags[j] = (unsigned char)((part ? 1 : 0) | (peer ? 2 : 0));
  }
}

// -- passes 2-4: the lanes' segmented scans -----------------------------------

// A lane as the wrapper lays it out: 8 int64 per lane in a device table.
struct Lane {
  int op, src, bit, rev;
  const i64* col;
  const unsigned char* nul;
  i64* out;
};

__device__ __forceinline__ Lane load_lane(const i64* table, int l) {
  const i64* t = table + 8 * l;
  Lane ln;
  ln.op = (int)t[0];
  ln.src = (int)t[1];
  ln.bit = (int)t[2];
  ln.rev = (int)t[3];
  ln.col = (const i64*)t[4];
  ln.nul = (const unsigned char*)t[5];
  ln.out = (i64*)t[6];
  return ln;
}

__device__ __forceinline__ i64 ident(int op) {
  switch (op) {
    case WS_ADD_F: return __double_as_longlong(0.0);
    case WS_MIN_I: return 0x7fffffffffffffffLL;
    case WS_MAX_I: return (i64)0x8000000000000000ULL;
    case WS_MIN_F: return 0x7ff0000000000000LL;          // +inf
    case WS_MAX_F: return (i64)0xfff0000000000000ULL;    // -inf
    default: return 0;
  }
}

struct ScanArgs {
  i64 n;
  const i64* idx;
  const unsigned char* flags;
  const i64* lanes;
  i64 n_tiles;
  int* tile_hf;  // n_lanes x n_tiles
  i64* tile_v;
  int* pre_hf;
  i64* pre_v;
};

// The sorted row of scan position q, and whether a segment starts there
// in scan order (backward lanes: where the row ends its segment).
__device__ __forceinline__ i64 row_of(const ScanArgs& a, const Lane& ln,
                                      i64 q) {
  return ln.rev ? a.n - 1 - q : q;
}

__device__ __forceinline__ int starts(const ScanArgs& a, const Lane& ln,
                                      i64 j) {
  const int m = 1 << ln.bit;
  if (!ln.rev) return (a.flags[j] & m) ? 2 : 0;
  return (j == a.n - 1 || (a.flags[j + 1] & m)) ? 2 : 0;
}

__device__ __forceinline__ i64 value_of(const ScanArgs& a, const Lane& ln,
                                        i64 j) {
  switch (ln.src) {
    case WS_SRC_POS: return j;
    case WS_SRC_PEER: return (a.flags[j] >> 1) & 1;
    default: break;
  }
  const i64 r = a.idx ? a.idx[j] : j;
  const bool isnull = ln.nul[r] != 0;
  if (ln.src == WS_SRC_VALID) return isnull ? 0 : 1;
  return isnull ? ident(ln.op) : ln.col[r];
}

__global__ void ws_tile_reduce(ScanArgs a) {
  const Lane ln = load_lane(a.lanes, blockIdx.y);
  const i64 q0 = (i64)blockIdx.x * WS_TILE + (i64)threadIdx.x * WS_ITEMS;
  Seg acc;
  acc.hf = 0;
  acc.v = 0;
#pragma unroll
  for (int k = 0; k < WS_ITEMS; ++k) {
    const i64 q = q0 + k;
    if (q < a.n) {
      const i64 j = row_of(a, ln, q);
      Seg e;
      e.v = value_of(a, ln, j);
      e.hf = 1 | starts(a, ln, j);
      ln.out[j] = e.v;  // the gathered value, rescanned in place by pass 4
      acc = seg_comb(ln.op, acc, e);
    }
  }
  Seg ex, tot;
  block_scan_seg(ln.op, acc, &ex, &tot);
  if (threadIdx.x == 0) {
    const i64 t = (i64)blockIdx.y * a.n_tiles + blockIdx.x;
    a.tile_hf[t] = tot.hf;
    a.tile_v[t] = tot.v;
  }
}

// One block per lane: exclusive segmented scan of the tile aggregates.
__global__ void ws_carry(ScanArgs a) {
  const Lane ln = load_lane(a.lanes, blockIdx.x);
  const i64 base = (i64)blockIdx.x * a.n_tiles;
  Seg run;
  run.hf = 0;
  run.v = 0;
  for (i64 c = 0; c < a.n_tiles; c += blockDim.x) {
    const i64 t = c + threadIdx.x;
    Seg x;
    x.hf = t < a.n_tiles ? a.tile_hf[base + t] : 0;
    x.v = t < a.n_tiles ? a.tile_v[base + t] : 0;
    Seg ex, tot;
    block_scan_seg(ln.op, x, &ex, &tot);
    if (t < a.n_tiles) {
      const Seg p = seg_comb(ln.op, run, ex);
      a.pre_hf[base + t] = p.hf;
      a.pre_v[base + t] = p.v;
    }
    run = seg_comb(ln.op, run, tot);
  }
}

__global__ void ws_tile_scan(ScanArgs a) {
  const Lane ln = load_lane(a.lanes, blockIdx.y);
  const i64 q0 = (i64)blockIdx.x * WS_TILE + (i64)threadIdx.x * WS_ITEMS;
  Seg e[WS_ITEMS];
  Seg acc;
  acc.hf = 0;
  acc.v = 0;
#pragma unroll
  for (int k = 0; k < WS_ITEMS; ++k) {
    const i64 q = q0 + k;
    e[k].hf = 0;
    e[k].v = 0;
    if (q < a.n) {
      const i64 j = row_of(a, ln, q);
      e[k].v = ln.out[j];
      e[k].hf = 1 | starts(a, ln, j);
    }
    acc = seg_comb(ln.op, acc, e[k]);
  }
  Seg ex, tot;
  block_scan_seg(ln.op, acc, &ex, &tot);
  const i64 t = (i64)blockIdx.y * a.n_tiles + blockIdx.x;
  Seg pre;
  pre.hf = a.pre_hf[t];
  pre.v = a.pre_v[t];
  Seg run = seg_comb(ln.op, pre, ex);
#pragma unroll
  for (int k = 0; k < WS_ITEMS; ++k) {
    const i64 q = q0 + k;
    if (q < a.n) {
      run = seg_comb(ln.op, run, e[k]);
      ln.out[row_of(a, ln, q)] = run.v;
    }
  }
}

// -- pass 5: every function at its frame end, scattered to input order --------

struct FinishArgs {
  i64 n;
  const i64* idx;
  const i64 *spos, *ppos, *epos, *pe;
  int n_funcs;
  const i64* funcs;  // 5 int64 per function: code, value lane, count
                     // lane, output data, output NULL flags
};

__global__ void ws_finish(FinishArgs a) {
  for (i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x; j < a.n;
       j += (i64)gridDim.x * blockDim.x) {
    const i64 r = a.idx ? a.idx[j] : j;
    const i64 sp = a.spos[j], end = a.pe[j];
    for (int f = 0; f < a.n_funcs; ++f) {
      const i64* fd = a.funcs + 5 * f;
      const int code = (int)fd[0];
      const i64* val = (const i64*)fd[1];
      const i64* cnt = (const i64*)fd[2];
      i64* out = (i64*)fd[3];
      unsigned char* onul = (unsigned char*)fd[4];
      i64 v = 0;
      bool isnull = false;
      switch (code) {
        case WS_ROW_NUMBER: v = j - sp + 1; break;
        case WS_RANK: v = a.ppos[j] - sp + 1; break;
        case WS_DENSE_RANK: v = val[j]; break;
        case WS_PERCENT_RANK: {
          const i64 m = a.epos[j] - sp + 1, rk = a.ppos[j] - sp;
          const double d =
              m > 1 ? (double)rk / (double)(m - 1 > 1 ? m - 1 : 1) : 0.0;
          v = __double_as_longlong(d);
          break;
        }
        case WS_CUME_DIST: {
          const i64 m = a.epos[j] - sp + 1;
          v = __double_as_longlong((double)(end - sp + 1) / (double)m);
          break;
        }
        case WS_COUNT: v = cnt[end]; break;
        default:  // WS_VALUE
          v = val[end];
          isnull = cnt[end] == 0;
          break;
      }
      out[r] = v;
      onul[r] = isnull ? 1 : 0;
    }
  }
}

// hdr (int64): [n, n_live, idx, flags, n_part, n_keys, n_lanes, lanes,
//               n_tiles, tile_hf, tile_v, pre_hf, pre_v, spos, ppos, epos,
//               pe, n_funcs, funcs, then per key k: col, null, is_float]
extern "C" int window_scan_run(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  FlagArgs f;
  f.n = hdr[0];
  f.n_live = hdr[1];
  f.idx = (const i64*)hdr[2];
  f.flags = (unsigned char*)hdr[3];
  f.n_part = (int)hdr[4];
  f.n_keys = (int)hdr[5];
  const int n_lanes = (int)hdr[6];
  if (f.n < 1 || f.n_keys > WS_MAX_KEYS || f.n_part > f.n_keys ||
      n_lanes < 1 || n_lanes > 65535)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < f.n_keys; ++k) {
    const i64* h = hdr + 19 + 3 * k;
    f.col[k] = (const i64*)h[0];
    f.nul[k] = (const unsigned char*)h[1];
    f.is_float[k] = (int)h[2];
  }
  ws_flags<<<grid_for(f.n), TIDB_THREADS, 0, st>>>(f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  ScanArgs s;
  s.n = f.n;
  s.idx = f.idx;
  s.flags = f.flags;
  s.lanes = (const i64*)hdr[7];
  s.n_tiles = hdr[8];
  s.tile_hf = (int*)hdr[9];
  s.tile_v = (i64*)hdr[10];
  s.pre_hf = (int*)hdr[11];
  s.pre_v = (i64*)hdr[12];
  if (s.n_tiles != (s.n + WS_TILE - 1) / WS_TILE || s.n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)s.n_tiles, (unsigned)n_lanes);
  ws_tile_reduce<<<grid, TIDB_THREADS, 0, st>>>(s);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ws_carry<<<n_lanes, WS_CARRY_THREADS, 0, st>>>(s);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ws_tile_scan<<<grid, TIDB_THREADS, 0, st>>>(s);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  FinishArgs fa;
  fa.n = f.n;
  fa.idx = f.idx;
  fa.spos = (const i64*)hdr[13];
  fa.ppos = (const i64*)hdr[14];
  fa.epos = (const i64*)hdr[15];
  fa.pe = (const i64*)hdr[16];
  fa.n_funcs = (int)hdr[17];
  fa.funcs = (const i64*)hdr[18];
  if (fa.n_funcs > 0) {
    ws_finish<<<grid_for(f.n), TIDB_THREADS, 0, st>>>(fa);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}
