// K5b: the CSR expansion of the join -> aggregate fragment, its post-join
// compaction, and the expand pass of the standalone join match (K7).
//
// Replaces: tidb_tpu/executor/device_join.py:519 _join_expand (cumsum,
// searchsorted of each output slot, within-row offset), the CSR block of
// compile_fragment.run at :810-842 and its compaction at :893-903;
// tidb_tpu/ops/device.py:1487 _join_expand_impl.
//
// What it computes, for probe rows i < n with match counts cnt[i] (or a
// 0/1 mask) and output slots s < cap:
//   cnt_eff[i] = cnt[i], or for a left join pvalid[i] ? max(cnt[i], 1) : 0;
//   total      = sum of cnt_eff, exact even when it exceeds cap;
//   slot s < min(total, cap) belongs to the probe row i with
//   cum[i] <= s < cum[i+1] (cum the exclusive scan of cnt_eff), at
//   within = s - cum[i]: pi = i, bi = a1[clamp(pos0[i] + min(within,
//   max(cnt[i]-1, 0)), 0, nv-1)], hit = within < cnt[i] && bvalid[bi],
//   valid = left ? pvalid[i] : hit && pvalid[i], nohit = !hit; and every
//   index or null map of the probe side gathered at pi, of the build side
//   at bi.  Slots are probe-major with each probe row's build rows in index
//   order, as the reference's searchsorted gives them.
//   Slots past total: pi = 0, bi = 0, valid = 0, nohit = 1, maps at 0.
//
// Bound on the card: memory.  cnt, pos0 and pvalid are read once per probe
// row; each output slot writes pi, bi, valid, nohit and its composed maps
// once and reads one row id, one build validity flag and one entry of each
// map at random (one 32-byte sector each).
//
// Design: two launches an expansion, one a count.
//   je_scan   - a single-pass exclusive scan of cnt_eff by decoupled
//               look-back (common.cuh lb_*): each block of 1024 threads
//               takes the next tile of 8192 rows (one atomic add on a tile
//               counter, so every tile it waits on is already running),
//               scans it, publishes the tile's sum, and warp 0 looks back
//               over the tiles before it, 32 at a time, until one has
//               published its inclusive prefix.  It writes each row's offset and the
//               exact total (the last tile).  A count sums its tiles and
//               the last block to finish adds the sums.  Status words
//               carry the call's epoch, so no launch clears them.
//   je_expand - a grid-stride loop over tiles of 1024 consecutive output
//               slots, 4 a thread: the block finds the rows that cover its
//               tile by two binary searches of the offsets, stages their
//               offsets in shared memory (a tile covered by more rows than
//               that holds, such as a sparse compaction, searches the
//               offsets in device memory instead), and each thread resolves
//               its own slots there.  Consecutive threads write consecutive
//               slots: int64 outputs as 16-byte stores, bytes as 4-byte
//               words.  A hot key is spread over the block's threads by
//               construction.  Slots past the total are written in the
//               same loop.
#include "common.cuh"

#define JE_MAX_MAPS 16
#define JE_SCAN_THREADS LB_THREADS
#define JE_SCAN_WARPS LB_WARPS
#define JE_ITEMS 8                             // rows a thread scans
#define JE_TILE (JE_SCAN_THREADS * JE_ITEMS)   // rows a scan tile
#define JE_THREADS 256                         // the expansion's blocks
#define JE_SLOTS 4                             // slots a thread expands
#define JE_STILE (JE_THREADS * JE_SLOTS)       // slots an expansion tile
#define JE_RMAX 4096                           // rows staged for one tile

typedef unsigned int u32;

struct ExpandArgs {
  i64 n;
  const i64* cnt;             // match counts (or null: cmask)
  const unsigned char* cmask; // 0/1 counts (compaction)
  const unsigned char* pvalid;  // may be null: every row valid
  int left;
  int build;  // 0: no build side (compaction)
  const i64* pos0;
  const void* a1;
  int a1_64;
  i64 nv;
  const unsigned char* bvalid;  // may be null
  i64 cap;
  i64* off;    // each row's exclusive offset (null: a count)
  i64* total;
  // scan status, per tile (common.cuh LookBack); ctr: the tiles taken so
  // far in this call (the block that takes the last one sets it back to 0)
  LookBack lb;
  u64* ctr;
  i64* pi;
  i64* bi;
  unsigned char* valid;
  unsigned char* nohit;
  int n_maps;
  const void* msrc[JE_MAX_MAPS];
  void* mdst[JE_MAX_MAPS];
  int mside[JE_MAX_MAPS];  // 0: probe side (at pi), 1: build side (at bi)
  int mbool[JE_MAX_MAPS];  // 1: bool null map, 0: int64 index map
};

__device__ __forceinline__ i64 cnt_eff(const ExpandArgs& a, i64 i) {
  const i64 c = a.cmask ? (i64)a.cmask[i] : a.cnt[i];
  if (!a.left) return c;
  const bool pv = a.pvalid ? a.pvalid[i] != 0 : true;
  return pv ? (c > 1 ? c : 1) : 0;
}

// -- the scan -------------------------------------------------------------------

__global__ void __launch_bounds__(JE_SCAN_THREADS) je_scan(ExpandArgs a) {
  __shared__ i64 s_wtot[JE_SCAN_WARPS];
  __shared__ i64 s_prefix;
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (a.n <= 0) {
    if (tid == 0) *a.total = 0;
    return;
  }
  const i64 n_tiles = (a.n + JE_TILE - 1) / JE_TILE;
  if (!a.off) {
    // a count: each block sums its tile; the last block to finish adds
    // the tiles' sums and leaves the counter at 0 for the next call
    const i64 base = (i64)blockIdx.x * JE_TILE;
    i64 sum = 0;
#pragma unroll
    for (int j = 0; j < JE_ITEMS; ++j) {
      const i64 r = base + (i64)j * JE_SCAN_THREADS + tid;
      sum += r < a.n ? cnt_eff(a, r) : 0;
    }
    sum = warp_sum_all(sum);
    if (lane == 0) s_wtot[warp] = sum;
    __syncthreads();
    if (tid == 0) {
      i64 t = 0;
      for (int w = 0; w < JE_SCAN_WARPS; ++w) t += s_wtot[w];
      *(volatile i64*)&a.lb.agg[blockIdx.x] = t;
      __threadfence();
      const u64 done = atomicAdd((unsigned long long*)a.ctr, 1ull);
      s_last = done == (u64)(n_tiles - 1);
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    i64 t = 0;
    for (i64 i = tid; i < n_tiles; i += JE_SCAN_THREADS)
      t += *(volatile i64*)&a.lb.agg[i];
    t = warp_sum_all(t);
    __syncthreads();
    if (lane == 0) s_wtot[warp] = t;
    __syncthreads();
    if (tid == 0) {
      i64 total = 0;
      for (int w = 0; w < JE_SCAN_WARPS; ++w) total += s_wtot[w];
      *a.total = total;
      *(volatile u64*)a.ctr = 0;
    }
    return;
  }
  const i64 t = lb_take_tile(a.ctr, n_tiles);
  const i64 base = t * JE_TILE;
  i64 v[JE_ITEMS], ex[JE_ITEMS];
#pragma unroll
  for (int j = 0; j < JE_ITEMS; ++j) {
    const i64 r = base + (i64)j * JE_SCAN_THREADS + tid;
    v[j] = r < a.n ? cnt_eff(a, r) : 0;
  }
  const i64 run = lb_tile_scan(v, ex);
  if (warp == 0) {
    const i64 pre = lb_exclusive(a.lb, t, run);
    if (lane == 0) s_prefix = pre;
  }
  __syncthreads();
  const i64 pre = s_prefix;
#pragma unroll
  for (int j = 0; j < JE_ITEMS; ++j) {
    const i64 r = base + (i64)j * JE_SCAN_THREADS + tid;
    if (r < a.n) a.off[r] = pre + ex[j];
  }
  if (tid == 0 && t == n_tiles - 1) *a.total = pre + run;
}

// -- the expansion ----------------------------------------------------------------

// The row that holds slot s: the last row whose offset is <= s, in [lo, hi].
__device__ __forceinline__ i64 je_row_of(const i64* off, i64 lo, i64 hi, i64 s) {
  hi += 1;
  while (hi - lo > 1) {
    const i64 mid = (lo + hi) >> 1;
    if (off[mid] <= s) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void je_store4_i64(i64* p, const i64 (&v)[JE_SLOTS],
                                              i64 s, i64 cap) {
  if (s + JE_SLOTS <= cap) {
    *(longlong2*)(p + s) = make_longlong2(v[0], v[1]);
    *(longlong2*)(p + s + 2) = make_longlong2(v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < JE_SLOTS; ++q)
      if (s + q < cap) p[s + q] = v[q];
  }
}

__device__ __forceinline__ void je_store4_u8(unsigned char* p,
                                             const unsigned char (&v)[JE_SLOTS],
                                             i64 s, i64 cap) {
  if (s + JE_SLOTS <= cap) {
    *(u32*)(p + s) = (u32)v[0] | ((u32)v[1] << 8) | ((u32)v[2] << 16) |
                     ((u32)v[3] << 24);
  } else {
#pragma unroll
    for (int q = 0; q < JE_SLOTS; ++q)
      if (s + q < cap) p[s + q] = v[q];
  }
}

__global__ void __launch_bounds__(JE_THREADS) je_expand(ExpandArgs a) {
  __shared__ int s_rel[JE_RMAX + 1];  // staged offsets, less the tile's start
  __shared__ i64 s_rf, s_rl, s_off0;
  const int tid = threadIdx.x;
  const i64 total = *a.total;
  const i64 live = total < a.cap ? total : a.cap;
  const i64 safe_hi = a.nv - 1 > 0 ? a.nv - 1 : 0;
  const i64 tiles = (a.cap + JE_STILE - 1) / JE_STILE;
  for (i64 tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const i64 s0 = tile * JE_STILE;
    const i64 l_end = s0 + JE_STILE < live ? s0 + JE_STILE : live;
    i64 rf = 0, rl = 0;
    bool staged = false;
    if (s0 < live) {  // the same for the whole block
      if (tid == 0) s_rf = je_row_of(a.off, 0, a.n - 1, s0);
      if (tid == 32) s_rl = je_row_of(a.off, 0, a.n - 1, l_end - 1);
      __syncthreads();
      rf = s_rf;
      rl = s_rl;
      const i64 R = rl - rf + 1;
      staged = R <= JE_RMAX;
      if (staged) {
        for (i64 k = tid; k < R; k += JE_THREADS) {
          const i64 o = a.off[rf + k];
          s_rel[k] = k == 0 ? 0 : (int)(o - s0);
          if (k == 0) s_off0 = o;
        }
        if (tid == 0) s_rel[R] = JE_STILE;
      }
      __syncthreads();
    }
    const i64 sb = s0 + (i64)tid * JE_SLOTS;
    i64 pi[JE_SLOTS], bi[JE_SLOTS];
    unsigned char vd[JE_SLOTS], nh[JE_SLOTS];
    i64 k = 0, row = rf;  // the staged index and the row of the last slot
#pragma unroll
    for (int q = 0; q < JE_SLOTS; ++q) {
      const i64 s = sb + q;
      pi[q] = 0;
      bi[q] = 0;
      vd[q] = 0;
      nh[q] = 1;
      if (s >= l_end) continue;
      i64 off_row;
      if (staged) {
        const int t = (int)(s - s0);
        if (s_rel[k + 1] <= t) {  // past the last slot's row
          int lo = (int)k + 1, hi = (int)(rl - rf) + 1;
          while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (s_rel[mid] <= t) lo = mid; else hi = mid;
          }
          k = lo;
        }
        row = rf + k;
        off_row = k == 0 ? s_off0 : s0 + s_rel[k];
      } else {
        if (row < rl && a.off[row + 1] <= s) row = je_row_of(a.off, row + 1, rl, s);
        off_row = a.off[row];
      }
      pi[q] = row;
      if (!a.build) {
        vd[q] = 1;
        continue;
      }
      const i64 c = a.cnt[row];
      const i64 w = s - off_row;
      const i64 cm1 = c - 1 > 0 ? c - 1 : 0;
      i64 bpos = a.pos0[row] + (w < cm1 ? w : cm1);
      bpos = bpos < 0 ? 0 : (bpos > safe_hi ? safe_hi : bpos);
      const i64 b = load_index(a.a1, a.a1_64, bpos);
      const bool h = w < c && (a.bvalid ? a.bvalid[b] != 0 : true);
      const bool pv = a.pvalid ? a.pvalid[row] != 0 : true;
      bi[q] = b;
      vd[q] = a.left ? pv : (h && pv);
      nh[q] = !h;
    }
    if (sb < a.cap) {
      je_store4_i64(a.pi, pi, sb, a.cap);
      je_store4_u8(a.valid, vd, sb, a.cap);
      if (a.build) {
        je_store4_i64(a.bi, bi, sb, a.cap);
        if (a.nohit) je_store4_u8(a.nohit, nh, sb, a.cap);
      }
      for (int m = 0; m < a.n_maps; ++m) {
        const bool side = a.mside[m] != 0;
        if (a.mbool[m]) {
          const unsigned char* src = (const unsigned char*)a.msrc[m];
          unsigned char g[JE_SLOTS];
#pragma unroll
          for (int q = 0; q < JE_SLOTS; ++q) g[q] = src[side ? bi[q] : pi[q]];
          je_store4_u8((unsigned char*)a.mdst[m], g, sb, a.cap);
        } else {
          const i64* src = (const i64*)a.msrc[m];
          i64 g[JE_SLOTS];
#pragma unroll
          for (int q = 0; q < JE_SLOTS; ++q) g[q] = src[side ? bi[q] : pi[q]];
          je_store4_i64((i64*)a.mdst[m], g, sb, a.cap);
        }
      }
    }
    __syncthreads();  // the next tile restages s_rel
  }
}

// hdr (int64): [n, cnt, cmask, pvalid, left, build, pos0, a1, a1_64, nv,
//               bvalid, cap, off, total, status, status_tiles, epoch,
//               pi, bi, valid, nohit, count_only, n_maps,
//               then per map m: src, dst, side, is_bool]
// status (int64) holds 1 + 3 * status_tiles words, zeroed once when it is
// allocated: the tile counter, then per tile the flag, the aggregate and
// the inclusive prefix; epoch (>= 1) is new for every call on a status
// block and grows from call to call in stream order.  off holds n int64
// (null for a count); the outputs cap entries, 16-byte aligned.
extern "C" int join_expand_run(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ExpandArgs a;
  a.n = hdr[0];
  a.cnt = (const i64*)hdr[1];
  a.cmask = (const unsigned char*)hdr[2];
  a.pvalid = (const unsigned char*)hdr[3];
  a.left = (int)hdr[4];
  a.build = (int)hdr[5];
  a.pos0 = (const i64*)hdr[6];
  a.a1 = (const void*)hdr[7];
  a.a1_64 = (int)hdr[8];
  a.nv = hdr[9];
  a.bvalid = (const unsigned char*)hdr[10];
  a.cap = hdr[11];
  a.off = (i64*)hdr[12];
  a.total = (i64*)hdr[13];
  i64* status = (i64*)hdr[14];
  const i64 status_tiles = hdr[15];
  a.lb.epoch = (u64)hdr[16];
  a.pi = (i64*)hdr[17];
  a.bi = (i64*)hdr[18];
  a.valid = (unsigned char*)hdr[19];
  a.nohit = (unsigned char*)hdr[20];
  const int count_only = (int)hdr[21];
  a.n_maps = (int)hdr[22];
  a.ctr = (u64*)status;
  a.lb.flag = (u64*)(status + 1);
  a.lb.agg = status + 1 + status_tiles;
  a.lb.incl = status + 1 + 2 * status_tiles;
  const i64 n_tiles = (a.n + JE_TILE - 1) / JE_TILE;
  if (a.n_maps < 0 || a.n_maps > JE_MAX_MAPS) return (int)cudaErrorInvalidValue;
  // no probe rows: every slot is past the total, and no input is read
  if (a.n > 0 && (a.build ? (!a.cnt || !a.pos0 || !a.a1) : !a.cmask))
    return (int)cudaErrorInvalidValue;
  if (status_tiles < n_tiles || a.lb.epoch < 1)
    return (int)cudaErrorInvalidValue;
  for (int m = 0; m < a.n_maps; ++m) {
    const i64* h = hdr + 23 + 4 * m;
    a.msrc[m] = (const void*)h[0];
    a.mdst[m] = (void*)h[1];
    a.mside[m] = (int)h[2];
    a.mbool[m] = (int)h[3];
  }
  const bool expand = !count_only && a.cap > 0;
  if (expand) {
    if (!a.off && a.n > 0) return (int)cudaErrorInvalidValue;
    const void* outs[4] = {a.pi, a.bi, a.valid, a.nohit};
    for (int i = 0; i < 4 + a.n_maps; ++i) {
      const void* p = i < 4 ? outs[i] : a.mdst[i - 4];
      if ((u64)p & 15) return (int)cudaErrorMisalignedAddress;
    }
  } else {
    a.off = nullptr;
  }
  je_scan<<<(unsigned)(n_tiles > 0 ? n_tiles : 1), JE_SCAN_THREADS, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !expand) return (int)e;
  const i64 stiles = (a.cap + JE_STILE - 1) / JE_STILE;
  je_expand<<<(unsigned)(stiles < 132 * 8 ? stiles : 132 * 8), JE_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
