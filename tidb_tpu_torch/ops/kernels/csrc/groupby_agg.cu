// K1: masked GROUP BY aggregate — count, exact int64 sum, float64 sum,
// min, max, first (earliest kept row) and count distinct per group.
//
// Replaces: tidb_tpu/ops/device.py:1205 _agg_impl (with _agg_scatter_impl
// 1113, _group_spans 1054, _seg_running 1042; jit entry _agg_kernel 1466).
//
// Bound on the card: memory.  The least work reads the mask, every key and
// value column and their null flags once and writes `capacity` slots;
// least time = those bytes / 3.35 TB/s.
//
// Design, keeping the reference's output contract slot for slot:
//  * slot state: one workspace, one kernel (gb_init) to initialise it.
//    Each slot's words sit together — word 0 its representative (least)
//    row, then per aggregate the accumulator and the non-null count it
//    needs (ops/kernels/groupby_agg.py slot_layout) — so a row's updates
//    fall in one or two 32-byte sectors; a byte per slot marks it live.
//  * warp aggregation: the lanes of a warp whose rows fall in one slot
//    find each other (__match_any_sync), fold their values with shuffles
//    over a tree schedule computed once per 32 rows, and one leader lane
//    updates the slot.  The values of AGG_STEP aggregates are loaded
//    together, so several loads are in flight per warp.  Counts come from ballots; the leader's row is the
//    least row (rows rise with the lane).  Each aggregate keeps its
//    semantics: count and int64 sums wrap exactly, min and max let NaN
//    win (as jnp.minimum), first is the least row, float sums are taken in
//    another order (rtol 1e-9).
//  * buckets: on the pack path the packed key is a direct slot index.
//    Where a copy of the slot space per warp fits shared memory
//    (MODE_WARP), each warp's leaders update their warp's copy without
//    atomics (the leaders of one step hold distinct slots); where one copy
//    per block fits (MODE_BLOCK), leaders update it with shared-memory
//    atomics; the copies are folded and flushed to the workspace with
//    global atomics once per block.  Otherwise (MODE_GLOBAL: 2^21 direct
//    slots for the top-N, or the hash path) leaders update the workspace
//    with global atomics.
//  * hash path (no pack, or a pack too wide for buckets): open addressing
//    over next_pow2(2n) slots keyed by the claiming row's index; equality
//    compares every key and its null flag.  The live slots are then
//    ordered by sort_topk.cu — by the packed key, or per key by
//    (null flag, value) with NULL groups AFTER all values, as the
//    reference's multi-key sort orders them.
//  * count distinct: a hash set of (group, agg, value) triples; a first
//    insert counts one for its group (the leader adds the warp's firsts).
//  * live slots are compacted in slot order (one launch when the slot
//    space is one tile), so packed groups come out in ascending packed
//    order with NULL packed to 0 first; emit writes every one of
//    `capacity` output slots (zeros and valid = 0 past n_groups).
//    n_groups is exact even above `capacity`.
// A Q1 call is 4 launches: init, accumulate, compact, emit.
#include "common.cuh"

#define GB_MAX_KEYS 8
#define GB_MAX_AGGS 32
#define GB_MAX_WORDS (1 + 2 * GB_MAX_AGGS + 3)  // padded stride
#define GB_THREADS 256
#define GB_WARPS (GB_THREADS / 32)
#define FULL 0xffffffffu
#define AGG_STEP 4  // aggregates whose loads a warp issues together

enum { OP_COUNT, OP_SUM_I, OP_SUM_F, OP_MIN, OP_MAX, OP_FIRST, OP_CNT_DIST };
enum { MODE_WARP, MODE_BLOCK, MODE_GLOBAL };

struct GbArgs {
  i64 n, S, P, cap;
  int n_keys, m, hashed, packed, mode, stride;
  i64 smem;
  const unsigned char* mask;
  const i64* keys[GB_MAX_KEYS];
  const unsigned char* knull[GB_MAX_KEYS];
  int bits[GB_MAX_KEYS];
  i64 offs[GB_MAX_KEYS];
  const i64* vals[GB_MAX_AGGS];
  const unsigned char* vnull[GB_MAX_AGGS];
  int ops[GB_MAX_AGGS], vflt[GB_MAX_AGGS], acc_w[GB_MAX_AGGS], nn_w[GB_MAX_AGGS];
  i64 winit[GB_MAX_WORDS];  // each slot word's initial value
  i64* slots;               // S * stride words
  unsigned char* live;      // S
  i64* tbl;
  int* pst;
  i64* pg;
  i64* pv;
  int* pj;
  i64* tile_cnt;
  i64* tile_off;
  i64* gslot;
  i64* ng;
  const i64* order;
  i64* out_i;               // (n_keys + m) * cap keys and results, then n_groups
  unsigned char* out_b;     // (n_keys + m + 1) * cap null flags and valid
};

__host__ __device__ __forceinline__ i64 acc_init(int op, int vflt) {
  if (op == OP_MIN) return vflt ? (i64)0x7ff0000000000000LL  // +inf
                                : (i64)0x7fffffffffffffffLL;
  if (op == OP_MAX) return vflt ? (i64)0xfff0000000000000ULL  // -inf
                                : (i64)0x8000000000000000ULL;
  return 0;
}

// hdr layout (int64), mirrored by ops/kernels/groupby_agg.py HDR_*:
//  0 n, 1 S, 2 P, 3 n_keys, 4 m, 5 hashed, 6 packed, 7 mode, 8 stride,
//  9 mask, 10 slots, 11 live, 12 tbl, 13 pst, 14 pg, 15 pv, 16 pj,
//  17 tile_cnt, 18 tile_off, 19 gslot, 20 cap, 21 order, 22 out_i,
//  23 out_b, 24 accumulate's shared bytes,
//  32 + i: keys | 40 + i: knull | 48 + i: bits | 56 + i: offs,
//  64 + j: vals | 96 + j: vnull | 128 + j: ops | 160 + j: vflt |
//  192 + j: acc word | 224 + j: nn word (-1: none)
static int make_args(const i64* h, GbArgs* a) {
  a->n = h[0];
  a->S = h[1];
  a->P = h[2];
  a->n_keys = (int)h[3];
  a->m = (int)h[4];
  a->hashed = (int)h[5];
  a->packed = (int)h[6];
  a->mode = (int)h[7];
  a->stride = (int)h[8];
  if (a->n_keys > GB_MAX_KEYS || a->m > GB_MAX_AGGS || a->stride < 1 ||
      a->stride > GB_MAX_WORDS)
    return (int)cudaErrorInvalidValue;
  a->mask = (const unsigned char*)h[9];
  a->slots = (i64*)h[10];
  a->live = (unsigned char*)h[11];
  a->tbl = (i64*)h[12];
  a->pst = (int*)h[13];
  a->pg = (i64*)h[14];
  a->pv = (i64*)h[15];
  a->pj = (int*)h[16];
  a->tile_cnt = (i64*)h[17];
  a->tile_off = (i64*)h[18];
  a->gslot = (i64*)h[19];
  a->cap = h[20];
  a->order = (const i64*)h[21];
  a->out_i = (i64*)h[22];
  a->out_b = (unsigned char*)h[23];
  a->smem = h[24];
  a->ng = a->out_i + (i64)(a->n_keys + a->m) * a->cap;
  for (int i = 0; i < GB_MAX_KEYS; ++i) {
    const bool on = i < a->n_keys;
    a->keys[i] = on ? (const i64*)h[32 + i] : nullptr;
    a->knull[i] = on ? (const unsigned char*)h[40 + i] : nullptr;
    a->bits[i] = on ? (int)h[48 + i] : 0;
    a->offs[i] = on ? h[56 + i] : 0;
  }
  for (int w = 0; w < GB_MAX_WORDS; ++w) a->winit[w] = 0;
  a->winit[0] = a->n;  // representative row: none yet
  for (int j = 0; j < GB_MAX_AGGS; ++j) {
    const bool on = j < a->m;
    a->vals[j] = on ? (const i64*)h[64 + j] : nullptr;
    a->vnull[j] = on ? (const unsigned char*)h[96 + j] : nullptr;
    a->ops[j] = on ? (int)h[128 + j] : 0;
    a->vflt[j] = on ? (int)h[160 + j] : 0;
    a->acc_w[j] = on ? (int)h[192 + j] : -1;
    a->nn_w[j] = on ? (int)h[224 + j] : -1;
    if (!on) continue;
    if (a->acc_w[j] >= a->stride || a->nn_w[j] >= a->stride)
      return (int)cudaErrorInvalidValue;
    if (a->acc_w[j] > 0) a->winit[a->acc_w[j]] = acc_init(a->ops[j], a->vflt[j]);
  }
  return 0;
}

__device__ __forceinline__ u64 mix64(u64 x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

// The packed key of a row: per key (NULL ? 0 : key + offset + 1), shifted
// in major key first — the reference's int64 arithmetic, bit for bit.
__device__ __forceinline__ i64 packed_key(const GbArgs& a, i64 row) {
  u64 b = 0;
  for (int i = 0; i < a.n_keys; ++i) {
    const i64 k = a.keys[i][row];  // loaded whatever the null flag says
    const i64 v = a.knull[i][row] ? 0 : wrap_add(k, a.offs[i] + 1);
    b = (b << a.bits[i]) | (u64)v;
  }
  return (i64)b;
}

__device__ __forceinline__ bool same_group(const GbArgs& a, i64 r1, i64 r2) {
  for (int i = 0; i < a.n_keys; ++i) {
    const bool n1 = a.knull[i][r1] != 0, n2 = a.knull[i][r2] != 0;
    if (n1 != n2) return false;
    if (!n1 && a.keys[i][r1] != a.keys[i][r2]) return false;
  }
  return true;
}

__device__ i64 hash_slot(const GbArgs& a, i64 row) {
  u64 h = 0x243f6a8885a308d3ULL;
  for (int i = 0; i < a.n_keys; ++i) {
    const u64 v = a.knull[i][row] ? 0x5bd1e9955bd1e995ULL : (u64)a.keys[i][row];
    h = mix64(h ^ v) + (u64)i;
  }
  i64 s = (i64)(h & (u64)(a.S - 1));
  volatile i64* tbl = a.tbl;
  while (true) {
    i64 cur = tbl[s];
    if (cur == -1) {
      cur = (i64)atomicCAS((u64*)&a.tbl[s], (u64)(-1LL), (u64)row);
      if (cur == -1) return s;  // claimed: the slot's key is this row's
    }
    if (same_group(a, row, cur)) return s;
    s = (s + 1) & (a.S - 1);
  }
}

// Insert (group, agg, value) into the distinct set; true on first sight.
__device__ bool pair_insert(const GbArgs& a, i64 g, int j, i64 v) {
  i64 p = (i64)(mix64(mix64((u64)g * 0x9e3779b97f4a7c15ULL + (u64)j) ^ (u64)v)
                & (u64)(a.P - 1));
  volatile int* st = a.pst;
  volatile i64* pg = a.pg;
  volatile i64* pv = a.pv;
  volatile int* pj = a.pj;
  while (true) {
    if (atomicCAS(&a.pst[p], 0, 1) == 0) {
      pg[p] = g;
      pv[p] = v;
      pj[p] = j;
      __threadfence();
      atomicExch(&a.pst[p], 2);
      return true;
    }
    while (st[p] == 1) {
    }  // another thread is publishing this slot
    __threadfence();
    if (pg[p] == g && pv[p] == v && pj[p] == j) return false;
    p = (p + 1) & (a.P - 1);
  }
}

// -- combining values: NaN wins min and max, as jnp.minimum ----------------
__device__ __forceinline__ double min_f(double cur, double v) {
  if (cur != cur) return cur;
  if (v != v || v < cur) return v;
  return cur;
}
__device__ __forceinline__ double max_f(double cur, double v) {
  if (cur != cur) return cur;
  if (v != v || v > cur) return v;
  return cur;
}

__device__ __forceinline__ void atomic_min_f(i64* p, double v) {
  u64* up = (u64*)p;
  u64 old = *((volatile u64*)up);
  while (true) {
    const double cur = __longlong_as_double((i64)old);
    if (cur != cur) return;              // NaN already wins
    if (v == v && !(v < cur)) return;    // not smaller, not NaN
    const u64 prev = atomicCAS(up, old, (u64)__double_as_longlong(v));
    if (prev == old) return;
    old = prev;
  }
}

__device__ __forceinline__ void atomic_max_f(i64* p, double v) {
  u64* up = (u64*)p;
  u64 old = *((volatile u64*)up);
  while (true) {
    const double cur = __longlong_as_double((i64)old);
    if (cur != cur) return;
    if (v == v && !(v > cur)) return;
    const u64 prev = atomicCAS(up, old, (u64)__double_as_longlong(v));
    if (prev == old) return;
    old = prev;
  }
}

// Fold a combined value into word p: with atomics (a slot space other
// threads update too) or without (a warp's own copy).
template <bool ATOMIC>
__device__ __forceinline__ void put_add(i64* p, i64 v) {
  if (ATOMIC) atomicAdd((u64*)p, (u64)v);
  else *p = wrap_add(*p, v);
}
template <bool ATOMIC>
__device__ __forceinline__ void put_min(i64* p, i64 v) {
  if (ATOMIC) atomicMin((long long*)p, (long long)v);
  else *p = v < *p ? v : *p;
}

template <bool ATOMIC>
__device__ __forceinline__ void put(int op, int vflt, i64* p, i64 v) {
  switch (op) {
    case OP_SUM_I: put_add<ATOMIC>(p, v); break;
    case OP_SUM_F:
      if (ATOMIC) atomicAdd((double*)p, __longlong_as_double(v));
      else *(double*)p = __dadd_rn(*(double*)p, __longlong_as_double(v));
      break;
    case OP_MIN:
      if (vflt) {
        if (ATOMIC) atomic_min_f(p, __longlong_as_double(v));
        else *p = __double_as_longlong(min_f(__longlong_as_double(*p),
                                             __longlong_as_double(v)));
      } else {
        put_min<ATOMIC>(p, v);
      }
      break;
    case OP_MAX:
      if (vflt) {
        if (ATOMIC) atomic_max_f(p, __longlong_as_double(v));
        else *p = __double_as_longlong(max_f(__longlong_as_double(*p),
                                             __longlong_as_double(v)));
      } else if (ATOMIC) {
        atomicMax((long long*)p, (long long)v);
      } else {
        *p = v > *p ? v : *p;
      }
      break;
    default: break;
  }
}

// Two values of aggregate `op` combined (the warp's fold).
__device__ __forceinline__ i64 combine(int op, int vflt, i64 x, i64 y) {
  switch (op) {
    case OP_SUM_I: return wrap_add(x, y);
    case OP_SUM_F:
      return __double_as_longlong(__dadd_rn(__longlong_as_double(x),
                                            __longlong_as_double(y)));
    case OP_MIN:
      if (vflt) return __double_as_longlong(min_f(__longlong_as_double(x),
                                                  __longlong_as_double(y)));
      return y < x ? y : x;
    case OP_MAX:
      if (vflt) return __double_as_longlong(max_f(__longlong_as_double(x),
                                                  __longlong_as_double(y)));
      return y > x ? y : x;
    default: return x;
  }
}

// The value a lane without a non-null row adds: the combine's identity.
__device__ __forceinline__ i64 identity(int op, int vflt) {
  if (op == OP_SUM_F) return (i64)0x8000000000000000ULL;  // -0.0
  return acc_init(op, vflt);
}

// The values and non-null flags of aggregates j0 .. j0 + AGG_STEP - 1 at
// `row`: loaded for every row of the table (a row the mask drops shares
// its warp's sectors), counted only for kept rows.
__device__ __forceinline__ void load_values(const GbArgs& a, int j0, i64 row,
                                            bool in, bool on,
                                            i64 (&vs)[AGG_STEP],
                                            bool (&hs)[AGG_STEP]) {
#pragma unroll
  for (int u = 0; u < AGG_STEP; ++u) {
    const int j = j0 + u;
    const bool use = in && j < a.m && a.ops[j] != OP_FIRST;
    vs[u] = use ? a.vals[j][row] : 0;
    hs[u] = use && !a.vnull[j][row] && on;
  }
}

// The fold's tree over a warp's peer groups (lanes whose rows fall in one
// slot): step t adds, into each lane, the value of its next remaining
// higher peer (nxt[t], if has[t]); after the last step each group's
// lowest lane holds its group's total.  5 steps cover 32 lanes; they run
// whatever the groups' sizes, so every shuffle sits in code the whole
// warp runs (a shuffle under a branch the compiler cannot prove uniform
// is issued once per set of converged lanes).
struct PeerTree {
  int nxt[5];
  bool has[5];
};

__device__ __forceinline__ PeerTree peer_tree(unsigned peers, int lane) {
  PeerTree t;
  unsigned rest = peers & ~((2u << lane) - 1u);  // higher peers
  int rank = __popc(peers & ((1u << lane) - 1u));
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    t.nxt[s] = rest ? __ffs(rest) - 1 : lane;
    t.has[s] = rest != 0;
    rest &= ~__ballot_sync(FULL, rank & 1);  // odd ranks are folded in
    rank >>= 1;
  }
  return t;
}

template <int OP, int FLT>
__device__ __forceinline__ i64 fold_as(const PeerTree& t, i64 x) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const i64 y = __shfl_sync(FULL, x, t.nxt[s]);
    x = t.has[s] ? combine(OP, FLT, x, y) : x;
  }
  return x;
}

// One aggregate's step over a warp's 32 rows, its op a constant: the
// non-null count from a ballot, the values folded over the peer tree, and
// the leader's update of its slot.  has: the row is kept and its value
// not NULL.
template <int OP, int FLT, bool ATOMIC>
__device__ __forceinline__ void agg_step(const PeerTree& t, unsigned peers,
                                         bool lead, i64* slot, int acc_w,
                                         int nn_w, bool has, i64 x) {
  const int nn = __popc(__ballot_sync(FULL, has) & peers);
  if (OP != OP_COUNT) {
    const i64 v = fold_as<OP, FLT>(t, has ? x : identity(OP, FLT));
    if (lead && nn) put<ATOMIC>(OP, FLT, slot + acc_w, v);
  }
  if (lead && nn) put_add<ATOMIC>(slot + nn_w, nn);
}

template <bool ATOMIC>
__device__ __forceinline__ void agg_dispatch(int op, int vflt,
                                             const PeerTree& t, unsigned peers,
                                             bool lead, i64* slot, int acc_w,
                                             int nn_w, bool has, i64 x) {
#define STEP(OP, FLT) agg_step<OP, FLT, ATOMIC>(t, peers, lead, slot, acc_w, nn_w, has, x)
  switch (op) {
    case OP_COUNT: STEP(OP_COUNT, 0); break;
    case OP_SUM_I: STEP(OP_SUM_I, 0); break;
    case OP_SUM_F: STEP(OP_SUM_F, 1); break;
    case OP_MIN:
      if (vflt) STEP(OP_MIN, 1); else STEP(OP_MIN, 0);
      break;
    case OP_MAX:
      if (vflt) STEP(OP_MAX, 1); else STEP(OP_MAX, 0);
      break;
    default: break;
  }
#undef STEP
}

// Initialise the workspace: every slot's words, the live flags, the hash
// table and the distinct set.
__global__ void gb_init(const GbArgs a) {
  const i64 words = a.S * a.stride;
  const i64 top = words > a.P ? words : a.P;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < top;
       i += (i64)gridDim.x * blockDim.x) {
    if (i < words) a.slots[i] = a.winit[i % a.stride];
    if (i < a.S) {
      a.live[i] = 0;
      if (a.hashed) a.tbl[i] = -1;
    }
    if (i < a.P) a.pst[i] = 0;
  }
}

// Pass 1.  MODE_WARP / MODE_BLOCK: the slot space's words live in this
// block's shared memory (one copy per warp / one per block), folded and
// flushed to the workspace at the end.
template <int MODE>
__global__ void __launch_bounds__(GB_THREADS) gb_accumulate(const GbArgs a) {
  extern __shared__ __align__(16) i64 sm[];
  constexpr bool SHARED = MODE != MODE_GLOBAL;
  constexpr bool ATOMIC = MODE != MODE_WARP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = a.stride;
  const i64 copy_w = SHARED ? a.S * stride : 0;  // words of one copy
  if (SHARED) {
    const i64 words = (MODE == MODE_WARP ? GB_WARPS : 1) * copy_w;
    for (i64 i = threadIdx.x; i < words; i += blockDim.x)
      sm[i] = a.winit[i % stride];
    __syncthreads();
  }
  i64* base = MODE == MODE_GLOBAL ? a.slots
                                  : sm + (MODE == MODE_WARP ? warp * copy_w : 0);
  const i64 step = (i64)gridDim.x * blockDim.x;
  for (i64 r0 = (i64)blockIdx.x * blockDim.x + (threadIdx.x - lane); r0 < a.n;
       r0 += step) {
    const i64 row = r0 + lane;
    const bool in = row < a.n;
    const bool on = in && a.mask[row];
    if (!__any_sync(FULL, on)) continue;
    // the first AGG_STEP aggregates' values load with the keys: a warp
    // whose rows are kept waits for memory twice (the mask, then keys and
    // values), not once per column
    i64 vs[AGG_STEP];
    bool hs[AGG_STEP];
    load_values(a, 0, row, in, on, vs, hs);
    i64 s = -1;
    if (on) {
      if (a.hashed) {
        s = hash_slot(a, row);
      } else {
        s = packed_key(a, row);
        s = s < 0 ? 0 : (s > a.S - 1 ? a.S - 1 : s);
      }
    }
    const unsigned peers = __match_any_sync(FULL, (unsigned long long)s);
    const bool lead = on && lane == __ffs(peers) - 1;
    const PeerTree tree = peer_tree(peers, lane);
    i64* slot = base + (lead ? s : 0) * stride;
    if (lead) {
      // the leader's row is its group's least (rows rise with the lane)
      put_min<ATOMIC>(slot, row);
      if (!SHARED) a.live[s] = 1;
    }
    // the aggregates AGG_STEP at a time: their loads in flight together
    for (int j0 = 0; j0 < a.m; j0 += AGG_STEP) {
      if (j0) load_values(a, j0, row, in, on, vs, hs);
#pragma unroll
      for (int u = 0; u < AGG_STEP; ++u) {
        const int j = j0 + u;
        if (j >= a.m) break;
        const int op = a.ops[j];
        if (op == OP_FIRST) continue;
        if (op == OP_CNT_DIST) {
          const bool first = hs[u] && pair_insert(a, s, j, vs[u]);
          const int c = __popc(__ballot_sync(FULL, first) & peers);
          if (lead && c) put_add<ATOMIC>(slot + a.acc_w[j], c);
          continue;
        }
        agg_dispatch<ATOMIC>(op, a.vflt[j], tree, peers, lead, slot,
                             a.acc_w[j], a.nn_w[j], hs[u], vs[u]);
      }
    }
    if (MODE == MODE_WARP) __syncwarp();  // the next leaders read this copy
  }
  if (!SHARED) return;
  __syncthreads();
  const int copies = MODE == MODE_WARP ? GB_WARPS : 1;
  for (i64 s = threadIdx.x; s < a.S; s += blockDim.x) {
    i64 rep = a.n;
    for (int c = 0; c < copies; ++c) {
      const i64 r = sm[c * copy_w + s * stride];
      rep = r < rep ? r : rep;
    }
    if (rep >= a.n) continue;  // no row of this block fell here
    i64* g = a.slots + s * stride;
    atomicMin((long long*)g, (long long)rep);
    a.live[s] = 1;
    for (int j = 0; j < a.m; ++j) {
      const int op = a.ops[j], vflt = a.vflt[j];
      if (op == OP_FIRST) continue;
      i64 nn = 0, acc = identity(op, vflt);
      for (int c = 0; c < copies; ++c) {
        const i64* w = sm + c * copy_w + s * stride;
        if (a.nn_w[j] >= 0) nn += w[a.nn_w[j]];
        if (a.acc_w[j] >= 0) acc = op == OP_CNT_DIST ? acc + w[a.acc_w[j]]
                                                    : combine(op, vflt, acc, w[a.acc_w[j]]);
      }
      if (op == OP_CNT_DIST) {
        if (acc) atomicAdd((u64*)(g + a.acc_w[j]), (u64)acc);
        continue;
      }
      if (nn == 0) continue;
      atomicAdd((u64*)(g + a.nn_w[j]), (u64)nn);
      if (op != OP_COUNT) put<true>(op, vflt, g + a.acc_w[j], acc);
    }
  }
}

// -- pass 2/3: scan the live flags and compact live slot ids -----------------
#define SCAN_T 256
#define SCAN_ITEMS 8
#define SCAN_TILE (SCAN_T * SCAN_ITEMS)

// Exclusive scan of one value per thread across the block (Hillis-Steele
// in shared memory); *total gets the block's sum.
__device__ i64 block_exclusive_scan(i64 v, i64* sh, i64* total) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const i64 add = t >= off ? sh[t - off] : 0;
    __syncthreads();
    sh[t] += add;
    __syncthreads();
  }
  const i64 incl = sh[t];
  *total = sh[blockDim.x - 1];
  __syncthreads();
  return incl - v;
}

// Each thread owns SCAN_ITEMS consecutive slots of its tile, so the
// compacted order is the slot order.
__device__ __forceinline__ i64 tile_live(const GbArgs& a, i64 base) {
  i64 c = 0;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const i64 s = base + k;
    if (s < a.S && a.live[s]) ++c;
  }
  return c;
}

__device__ __forceinline__ void tile_write(const GbArgs& a, i64 base, i64 off) {
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const i64 s = base + k;
    if (s < a.S && a.live[s]) a.gslot[off++] = s;
  }
}

__global__ void gb_tile_count(const GbArgs a) {
  __shared__ i64 sh[SCAN_T];
  i64 total;
  block_exclusive_scan(
      tile_live(a, (i64)blockIdx.x * SCAN_TILE + (i64)threadIdx.x * SCAN_ITEMS),
      sh, &total);
  if (threadIdx.x == 0) a.tile_cnt[blockIdx.x] = total;
}

// One block: exclusive scan of the tile totals, chunk by chunk.
__global__ void gb_scan_tiles(const GbArgs a, i64 n_tiles) {
  __shared__ i64 sh[1024];
  i64 carry = 0;
  for (i64 base = 0; base < n_tiles; base += blockDim.x) {
    const i64 i = base + threadIdx.x;
    const i64 v = i < n_tiles ? a.tile_cnt[i] : 0;
    i64 total;
    const i64 ex = block_exclusive_scan(v, sh, &total);
    if (i < n_tiles) a.tile_off[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) a.ng[0] = carry;
}

__global__ void gb_compact(const GbArgs a) {
  __shared__ i64 sh[SCAN_T];
  const i64 base = (i64)blockIdx.x * SCAN_TILE + (i64)threadIdx.x * SCAN_ITEMS;
  i64 total;
  const i64 off = block_exclusive_scan(tile_live(a, base), sh, &total);
  tile_write(a, base, a.tile_off[blockIdx.x] + off);
}

// A slot space of one tile: count, scan and compact in one block.
__global__ void gb_compact_one(const GbArgs a) {
  __shared__ i64 sh[SCAN_T];
  const i64 base = (i64)threadIdx.x * SCAN_ITEMS;
  i64 total;
  const i64 off = block_exclusive_scan(tile_live(a, base), sh, &total);
  tile_write(a, base, off);
  if (threadIdx.x == 0) a.ng[0] = total;
}

// The sort keys of the hash path's groups, from each group's first row.
__global__ void gb_group_keys(const GbArgs a, i64 ng, i64* keys_out,
                              unsigned char* nulls_out) {
  for (i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x; g < ng;
       g += (i64)gridDim.x * blockDim.x) {
    const i64 r = a.slots[a.gslot[g] * a.stride];
    if (a.packed) {
      keys_out[g] = packed_key(a, r);
      nulls_out[g] = 0;
      continue;
    }
    for (int i = 0; i < a.n_keys; ++i) {
      const bool nl = a.knull[i][r] != 0;
      keys_out[i * ng + g] = nl ? 0 : a.keys[i][r];
      nulls_out[i * ng + g] = nl;
    }
  }
}

// Slot r of the output holds group order[r] (or r on the pack path):
// keys from the group's first row, then each aggregate's result; every
// slot at or past min(n_groups, cap) is zero and not valid.
__global__ void gb_emit(const GbArgs a) {
  const i64 ng = a.ng[0];
  const i64 lim = ng < a.cap ? ng : a.cap;
  const i64 cap = a.cap;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < cap;
       r += (i64)gridDim.x * blockDim.x) {
    const bool on = r < lim;
    const i64 s = on ? a.gslot[a.order ? a.order[r] : r] : 0;
    const i64* w = a.slots + s * a.stride;
    const i64 row = on ? w[0] : 0;
    for (int i = 0; i < a.n_keys; ++i) {
      a.out_i[i * cap + r] = on ? a.keys[i][row] : 0;
      a.out_b[i * cap + r] = on ? a.knull[i][row] : 0;
    }
    for (int j = 0; j < a.m; ++j) {
      const int op = a.ops[j];
      i64 v = 0;
      bool nl = false;
      if (on) {
        switch (op) {
          case OP_COUNT: v = w[a.nn_w[j]]; break;
          case OP_FIRST: v = a.vals[j][row]; nl = a.vnull[j][row] != 0; break;
          case OP_CNT_DIST: v = w[a.acc_w[j]]; break;
          default: v = w[a.acc_w[j]]; nl = w[a.nn_w[j]] == 0; break;
        }
      }
      a.out_i[(a.n_keys + j) * cap + r] = v;
      a.out_b[(a.n_keys + j) * cap + r] = nl;
    }
    a.out_b[(a.n_keys + a.m) * cap + r] = on;
  }
}

template <int MODE>
static cudaError_t accumulate(const GbArgs& a, cudaStream_t st) {
  // per device: the SM count and the dynamic shared bytes allowed so far
  // (0: the default 48 KB)
  static int sms[TIDB_MAX_DEVICES];
  static i64 opted[TIDB_MAX_DEVICES];
  auto kernel = gb_accumulate<MODE>;
  int dev = 0;
  cudaError_t e = current_device(&dev);
  if (e != cudaSuccess) return e;
  if (a.smem > 48 * 1024 && a.smem > opted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)a.smem);
    if (e != cudaSuccess) return e;
    opted[dev] = a.smem;
  }
  i64 grid = grid_for(a.n, GB_THREADS);
  if (MODE != MODE_GLOBAL) {
    // one resident wave: every block folds and flushes its copies once
    if (sms[dev] == 0) {
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
    }
    int per_sm = 1;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GB_THREADS,
                                                      (size_t)a.smem);
    if (e != cudaSuccess) return e;
    const i64 wave = (i64)(per_sm > 0 ? per_sm : 1) * sms[dev];
    if (grid > wave) grid = wave;
  }
  kernel<<<(unsigned)grid, GB_THREADS, (size_t)a.smem, st>>>(a);
  return cudaGetLastError();
}

// Init, accumulate and compact: after it, n_groups (out_i past the
// results) and the live slots in slot order (gslot) are on the device.
extern "C" int gb_groups_run(const i64* hdr, void* stream) {
  GbArgs a;
  int rc = make_args(hdr, &a);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  const i64 init_n = a.S * a.stride > a.P ? a.S * a.stride : a.P;
  gb_init<<<grid_for(init_n), TIDB_THREADS, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (a.n > 0) {
    switch (a.mode) {
      case MODE_WARP: e = accumulate<MODE_WARP>(a, st); break;
      case MODE_BLOCK: e = accumulate<MODE_BLOCK>(a, st); break;
      default: e = accumulate<MODE_GLOBAL>(a, st); break;
    }
    if (e != cudaSuccess) return (int)e;
  }
  const i64 n_tiles = (a.S + SCAN_TILE - 1) / SCAN_TILE;
  if (n_tiles == 1) {
    gb_compact_one<<<1, SCAN_T, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  gb_tile_count<<<(unsigned)n_tiles, SCAN_T, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gb_scan_tiles<<<1, 1024, 0, st>>>(a, n_tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gb_compact<<<(unsigned)n_tiles, SCAN_T, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int gb_group_keys_run(const i64* hdr, i64 ng, i64* keys_out,
                                 unsigned char* nulls_out, void* stream) {
  GbArgs a;
  int rc = make_args(hdr, &a);
  if (rc) return rc;
  if (ng <= 0) return 0;
  gb_group_keys<<<grid_for(ng), TIDB_THREADS, 0, (cudaStream_t)stream>>>(
      a, ng, keys_out, nulls_out);
  return (int)cudaGetLastError();
}

// hdr's order entry (21) is read here: the hash path's group order.
extern "C" int gb_emit_run(const i64* hdr, void* stream) {
  GbArgs a;
  int rc = make_args(hdr, &a);
  if (rc) return rc;
  if (a.cap <= 0) return 0;
  // a slot a thread: each slot's reads (its group's slot, then the
  // representative row's keys) depend on each other, so the more slots in
  // flight the better
  const i64 blocks = (a.cap + TIDB_THREADS - 1) / TIDB_THREADS;
  gb_emit<<<(unsigned)(blocks < 132 * 64 ? blocks : 132 * 64), TIDB_THREADS, 0,
            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
