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
// Design (simple and correct first): a hand-written three-pass exclusive
// scan over tiles of 2048 rows (tile sums; one block scans the tile sums
// and writes the exact total; each tile rescans its rows), and in the last
// pass one thread per probe row writes that row's output slots.  A hot key
// (JoinIndex.max_cnt) makes that thread's loop long; balancing it is later
// work.
#include "common.cuh"

#define JE_MAX_MAPS 16
#define JE_ITEMS 8
#define JE_TILE (TIDB_THREADS * JE_ITEMS)
#define JE_SCAN_THREADS 1024

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
  i64* tile_sums;
  i64* tile_offs;
  i64* total;
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

__global__ void je_tile_sums(ExpandArgs a) {
  const i64 base = (i64)blockIdx.x * JE_TILE + (i64)threadIdx.x * JE_ITEMS;
  i64 s = 0;
#pragma unroll
  for (int j = 0; j < JE_ITEMS; ++j)
    if (base + j < a.n) s += cnt_eff(a, base + j);
  __shared__ i64 part[TIDB_THREADS / 32];
  s = warp_sum_i64(s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    i64 t = 0;
    for (int w = 0; w < TIDB_THREADS / 32; ++w) t += part[w];
    a.tile_sums[blockIdx.x] = t;
  }
}

// Inclusive scan of one value per thread across the block (blockDim a
// multiple of 32, at most 1024); returns the thread's inclusive prefix and
// the block total in *sum.
__device__ __forceinline__ i64 block_scan(i64 v, i64* sum) {
  __shared__ i64 warp_tot[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const i64 u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  __syncthreads();
  if (lane == 31) warp_tot[w] = v;
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    i64 t = lane < nw ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const i64 u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  if (w > 0) v += warp_tot[w - 1];
  *sum = warp_tot[(blockDim.x >> 5) - 1];
  return v;
}

// One block: exclusive scan of the tile sums, and the exact total.
__global__ void je_scan_tiles(ExpandArgs a, i64 n_tiles) {
  i64 carry = 0;
  for (i64 base = 0; base < n_tiles; base += blockDim.x) {
    const i64 t = base + threadIdx.x;
    const i64 v = t < n_tiles ? a.tile_sums[t] : 0;
    i64 sum;
    const i64 inc = block_scan(v, &sum);
    if (t < n_tiles) a.tile_offs[t] = carry + inc - v;
    carry += sum;
    __syncthreads();
  }
  if (threadIdx.x == 0) *a.total = carry;
}

__device__ __forceinline__ void write_maps(const ExpandArgs& a, i64 s, i64 pi,
                                           i64 bi) {
  for (int m = 0; m < a.n_maps; ++m) {
    const i64 at = a.mside[m] ? bi : pi;
    if (a.mbool[m])
      ((unsigned char*)a.mdst[m])[s] = ((const unsigned char*)a.msrc[m])[at];
    else
      ((i64*)a.mdst[m])[s] = ((const i64*)a.msrc[m])[at];
  }
}

__global__ void je_expand(ExpandArgs a) {
  const i64 base = (i64)blockIdx.x * JE_TILE + (i64)threadIdx.x * JE_ITEMS;
  i64 e[JE_ITEMS];
  i64 s = 0;
#pragma unroll
  for (int j = 0; j < JE_ITEMS; ++j) {
    e[j] = base + j < a.n ? cnt_eff(a, base + j) : 0;
    s += e[j];
  }
  i64 sum;
  i64 slot = a.tile_offs[blockIdx.x] + block_scan(s, &sum) - s;
  const i64 safe_hi = a.nv - 1 > 0 ? a.nv - 1 : 0;
#pragma unroll
  for (int j = 0; j < JE_ITEMS; ++j) {
    const i64 i = base + j;
    if (i >= a.n) break;
    const i64 c = a.build ? a.cnt[i] : 0;
    const bool pv = a.pvalid ? a.pvalid[i] != 0 : true;
    for (i64 w = 0; w < e[j] && slot < a.cap; ++w, ++slot) {
      a.pi[slot] = i;
      i64 b = 0;
      if (a.build) {
        const i64 cm1 = c - 1 > 0 ? c - 1 : 0;
        i64 bpos = a.pos0[i] + (w < cm1 ? w : cm1);
        bpos = bpos < 0 ? 0 : (bpos > safe_hi ? safe_hi : bpos);
        b = load_index(a.a1, a.a1_64, bpos);
        const bool h = w < c && (a.bvalid ? a.bvalid[b] != 0 : true);
        a.bi[slot] = b;
        a.valid[slot] = a.left ? pv : (h && pv);
        if (a.nohit) a.nohit[slot] = !h;
      } else {
        a.valid[slot] = 1;
      }
      write_maps(a, slot, i, b);
    }
    if (slot >= a.cap) break;
  }
}

__global__ void je_tail(ExpandArgs a) {
  const i64 total = *a.total;
  const i64 from = total < a.cap ? total : a.cap;
  for (i64 s = from + (i64)blockIdx.x * blockDim.x + threadIdx.x; s < a.cap;
       s += (i64)gridDim.x * blockDim.x) {
    a.pi[s] = 0;
    if (a.build) {
      a.bi[s] = 0;
      if (a.nohit) a.nohit[s] = 1;
    }
    a.valid[s] = 0;
    write_maps(a, s, 0, 0);
  }
}

// hdr (int64): [n, cnt, cmask, pvalid, left, build, pos0, a1, a1_64, nv,
//               bvalid, cap, tile_sums, tile_offs, total, pi, bi, valid,
//               nohit, count_only, n_maps,
//               then per map m: src, dst, side, is_bool]
// tile_sums / tile_offs hold ceil(n / 2048) entries.
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
  a.tile_sums = (i64*)hdr[12];
  a.tile_offs = (i64*)hdr[13];
  a.total = (i64*)hdr[14];
  a.pi = (i64*)hdr[15];
  a.bi = (i64*)hdr[16];
  a.valid = (unsigned char*)hdr[17];
  a.nohit = (unsigned char*)hdr[18];
  const int count_only = (int)hdr[19];
  a.n_maps = (int)hdr[20];
  if (a.n_maps < 0 || a.n_maps > JE_MAX_MAPS) return (int)cudaErrorInvalidValue;
  if (!a.cnt && !a.cmask) return (int)cudaErrorInvalidValue;
  if (a.build && (!a.cnt || !a.pos0 || !a.a1)) return (int)cudaErrorInvalidValue;
  for (int m = 0; m < a.n_maps; ++m) {
    const i64* h = hdr + 21 + 4 * m;
    a.msrc[m] = (const void*)h[0];
    a.mdst[m] = (void*)h[1];
    a.mside[m] = (int)h[2];
    a.mbool[m] = (int)h[3];
  }
  const i64 n_tiles = (a.n + JE_TILE - 1) / JE_TILE;
  cudaError_t e;
  if (n_tiles > 0) {
    je_tile_sums<<<(unsigned)n_tiles, TIDB_THREADS, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  je_scan_tiles<<<1, JE_SCAN_THREADS, 0, st>>>(a, n_tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (count_only || a.cap <= 0) return 0;
  if (n_tiles > 0) {
    je_expand<<<(unsigned)n_tiles, TIDB_THREADS, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  je_tail<<<grid_for(a.cap), TIDB_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
