// Kernel A of the MPP exchange (K11/K12): the destination hash and the
// stable two-level radix partition of one shard's rows into the slot grid
// that the mesh's all_to_all splits.
//
// Replaces: tidb_tpu/parallel/mpp.py:223 _mix64, :237 _radix_bucket and
// :250 _bucketize (mix64, argsort(bucket, stable=True), searchsorted of
// the bucket starts, the scatter into [n_dest, n_sub, cap] slots); and
// tidb_tpu/executor/mpp_exec.py:221 _dest_hash and the bucket / argsort /
// searchsorted / gather of :232 _exchange_leaf.
//
// What it computes:
//   rx_hash:  h = mix64(k) (single), or h = 0 then h = mix64(h ^ mix64(d))
//             over the key columns (fold), as uint64 bits in int64 lanes;
//             ok = valid && no key NULL.
//   bucket:   ok ? ((h >> 32) % n_dest) * n_sub + (h & (n_sub - 1)) : nb,
//             nb = n_dest * n_sub (invalid rows park past every bucket).
//   grid:     bucket b's rows, in row order, fill slots b*cap .. b*cap +
//             min(cnt[b], cap) - 1 of an nb*cap grid; each slot gets its
//             source row, slot_valid = 1 and every column's element; the
//             other slots get row 0, slot_valid 0 and zeros.
//   need = max over b of cnt[b] (exact), dropped = sum of max(cnt[b] -
//   cap, 0).
//
// Bound on the card: memory.  The hash reads each key column (and NULL
// flags) once and writes h and ok; the partition reads h, valid and every
// column once and writes the grid once (rows, slot_valid and each column).
//
// Design of the partition: ONE launch of rx_partition, whose blocks take
// tickets in the order they start.  Tickets below n_tiles are tiles of
// RX_TILE rows; the rest are fill blocks.
//   1. A tile block reads its rows' h and valid once (coalesced) and
//      ranks them stably by bucket with a warp multisplit
//      (__match_any_sync; a lane's rank is the popcount of the lower lanes
//      of its group) into per-warp bucket counts in shared memory.
//   2. It publishes its per-bucket counts in status words (tag << 32 |
//      count; the tag carries the call's epoch, so the words are never
//      cleared) and finds its per-bucket prefix over the earlier tiles by
//      decoupled look-back, one thread a bucket.  A bucket's slot is b*cap
//      + prefix + rank: unlike a sort no global bucket start is needed, so
//      this one pass places every row, and the last tile's inclusive
//      counts are cnt, need and dropped exactly.
//   3. It stages the tile's permutation, sorted by bucket, in shared
//      memory and writes rows, slot_valid and each column as contiguous
//      runs a bucket; each column's tile window is first read coalesced
//      into shared memory and gathered from there.  Slots past cap are
//      skipped.
//   4. A fill block waits for the last tile's counts and zeroes only the
//      empty tail [min(cnt[b], cap), cap) of each bucket, in chunks of
//      RX_FILL_CHUNK slots, with 16-byte stores.
// Every block that waits (look-back, fill) waits on tickets taken before
// its own, by blocks already running, so the grid cannot deadlock.  The
// last ticket sets the counter back to 0 for the next call on the stream.
#include "common.cuh"

#define RX_MAX_BUCKETS 1024
#define RX_MAX_COLS 64
#define RX_MAX_KEYS 8
#define RX_THREADS 256
#define RX_WARPS (RX_THREADS / 32)
#define RX_ITEMS 8
#define RX_TILE (RX_THREADS * RX_ITEMS)
#define RX_FILL_CHUNK 4096
#define RX_MAX_DEVICES 64
// workspace (u64 words): the ticket, the ready word (the epoch, once the
// last tile has written the counts), cnt[RX_MAX_BUCKETS], then the status
// words, status[t * nb + b]
#define RX_WS_TICKET 0
#define RX_WS_READY 1
#define RX_WS_CNT 2
#define RX_WS_STATUS (RX_WS_CNT + RX_MAX_BUCKETS)

typedef unsigned int u32;

__device__ __forceinline__ u64 mix64(u64 u) {
  u ^= u >> 33;
  u *= 0xFF51AFD7ED558CCDULL;
  u ^= u >> 33;
  u *= 0xC4CEB9FE1A85EC53ULL;
  u ^= u >> 33;
  return u;
}

struct HashArgs {
  i64 m;
  int fold;
  int n_keys;
  const i64* key[RX_MAX_KEYS];
  const unsigned char* knull[RX_MAX_KEYS];  // may be null: no NULLs
  const unsigned char* valid;               // may be null: every row
  i64* h;
  unsigned char* ok;
};

__global__ void rx_hash(HashArgs a) {
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < a.m;
       i += (i64)gridDim.x * blockDim.x) {
    u64 h;
    if (a.fold) {
      h = 0;
      for (int c = 0; c < a.n_keys; ++c)
        h = mix64(h ^ mix64((u64)a.key[c][i]));
    } else {
      h = mix64((u64)a.key[0][i]);
    }
    bool ok = a.valid ? a.valid[i] != 0 : true;
    for (int c = 0; c < a.n_keys; ++c)
      if (a.knull[c] && a.knull[c][i]) ok = false;
    a.h[i] = (i64)h;
    a.ok[i] = ok;
  }
}

struct PartArgs {
  i64 m;
  int n_dest, n_sub, nb;
  i64 cap;
  const i64* h;
  const unsigned char* valid;  // may be null: every row
  i64 n_tiles;
  i64 n_fill;
  u64 epoch;  // >= 1; tags 2 epoch + 1 (a tile's count), 2 epoch + 2 (prefix)
  u64* ws;
  i64* flags;  // need, dropped
  i64* rows;
  unsigned char* slot_valid;
  int n_cols;
  const void* src[RX_MAX_COLS];
  void* dst[RX_MAX_COLS];
  int es[RX_MAX_COLS];  // element size in bytes: 1, 2, 4 or 8
};

// Dynamic shared memory of a tile block (bytes from its start): per-warp
// bucket counts u32[RX_WARPS][nb], the tile's bucket starts u32[nb] and
// ends of the slots written u32[nb], the buckets' slot bases i64[nb], the
// sorted permutation u16[RX_TILE] and its buckets u16[RX_TILE], and a
// column's tile window (RX_TILE 8-byte elements).  The wrapper mirrors it
// (radix_exchange.py smem_bytes).
__host__ __device__ __forceinline__ size_t rx_off_glob(int nb) {
  return ((size_t)(RX_WARPS + 2) * nb * 4 + 15) & ~(size_t)15;
}
__host__ __device__ __forceinline__ size_t rx_off_perm(int nb) {
  return (rx_off_glob(nb) + (size_t)nb * 8 + 15) & ~(size_t)15;
}
__host__ __device__ __forceinline__ size_t rx_off_stage(int nb) {
  return rx_off_perm(nb) + (size_t)RX_TILE * 4;
}
__host__ __device__ __forceinline__ size_t rx_smem_bytes(int nb) {
  return rx_off_stage(nb) + (size_t)RX_TILE * 8;
}

__device__ __forceinline__ u64 rx_load(const u64* p) {
  return *(const volatile u64*)p;
}

__device__ __forceinline__ void rx_store(u64* p, u64 v) {
  *(volatile u64*)p = v;
}

// Inclusive scan of one u32 a thread across the block; the block total in
// *sum.  Every thread calls it.
__device__ __forceinline__ u32 rx_block_scan(u32 v, u32* sum) {
  __shared__ u32 warp_tot[RX_WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const u32 u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  __syncthreads();
  if (lane == 31) warp_tot[w] = v;
  __syncthreads();
  u32 before = 0, tot = 0;
  for (int i = 0; i < RX_WARPS; ++i) {
    const u32 x = warp_tot[i];
    if (i < w) before += x;
    tot += x;
  }
  *sum = tot;
  return v + before;
}

// Zeroes bytes [0, n) of p with the block's threads: single bytes up to a
// 16-byte boundary and after the last one, 16-byte stores between.
__device__ __forceinline__ void rx_zero(unsigned char* p, i64 n) {
  i64 head = (i64)((16 - ((uintptr_t)p & 15)) & 15);
  if (head > n) head = n;
  const i64 vecs = (n - head) >> 4;
  for (i64 i = threadIdx.x; i < head; i += RX_THREADS) p[i] = 0;
  uint4* q = (uint4*)(p + head);
  for (i64 i = threadIdx.x; i < vecs; i += RX_THREADS)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
  for (i64 i = head + vecs * 16 + threadIdx.x; i < n; i += RX_THREADS)
    p[i] = 0;
}

// A fill block: the empty tails of the buckets, items (bucket, chunk)
// f, f + n_fill, ... once the last tile has written the counts.
__device__ void rx_fill(const PartArgs& a, i64 f) {
  if (threadIdx.x == 0) {
    while (rx_load(a.ws + RX_WS_READY) != a.epoch) __nanosleep(256);
    __threadfence();
  }
  __syncthreads();
  const i64 chunks = (a.cap + RX_FILL_CHUNK - 1) / RX_FILL_CHUNK;
  const i64 items = (i64)a.nb * chunks;
  for (i64 it = f; it < items; it += a.n_fill) {
    const i64 b = it / chunks, ch = it - b * chunks;
    const i64 cnt = (i64)__ldcg(a.ws + RX_WS_CNT + b);
    const i64 filled = cnt < a.cap ? cnt : a.cap;
    const i64 c0 = ch * RX_FILL_CHUNK;
    const i64 lo = c0 > filled ? c0 : filled;
    const i64 hi = c0 + RX_FILL_CHUNK < a.cap ? c0 + RX_FILL_CHUNK : a.cap;
    if (lo >= hi) continue;
    const i64 s0 = b * a.cap + lo, n = hi - lo;
    rx_zero((unsigned char*)(a.rows + s0), n * 8);
    rx_zero(a.slot_valid + s0, n);
    for (int c = 0; c < a.n_cols; ++c)
      rx_zero((unsigned char*)a.dst[c] + s0 * a.es[c], n * a.es[c]);
  }
}

// One column of a tile: its window read coalesced into shared memory, then
// each kept sorted position p written at slot s_glob[b] + p.
template <typename E>
__device__ __forceinline__ void rx_column(const void* src, void* dst,
                                          E* stage, i64 base, int n_rows,
                                          u32 nv, const unsigned short* perm,
                                          const unsigned short* sbkt,
                                          const u32* s_lim,
                                          const i64* s_glob) {
  const E* s = (const E*)src + base;
  E* d = (E*)dst;
  __syncthreads();  // the previous column's gather is done
  for (int r = threadIdx.x; r < n_rows; r += RX_THREADS) stage[r] = s[r];
  __syncthreads();
  for (u32 p = threadIdx.x; p < nv; p += RX_THREADS) {
    const int b = sbkt[p];
    if (p < s_lim[b]) d[s_glob[b] + p] = stage[perm[p]];
  }
}

__global__ void __launch_bounds__(RX_THREADS) rx_partition(PartArgs a) {
  extern __shared__ __align__(16) unsigned char rx_smem[];
  __shared__ u64 s_ticket;
  __shared__ u32 s_nv;
  __shared__ i64 s_red[2][RX_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const u64 t = atomicAdd((unsigned long long*)(a.ws + RX_WS_TICKET), 1ull);
    if (t == (u64)(a.n_tiles + a.n_fill - 1))
      atomicExch((unsigned long long*)(a.ws + RX_WS_TICKET), 0ull);
    s_ticket = t;
  }
  __syncthreads();
  const i64 t = (i64)s_ticket;
  if (t >= a.n_tiles) {
    rx_fill(a, t - a.n_tiles);
    return;
  }
  const int nb = a.nb;
  u32* whist = (u32*)rx_smem;  // [warp][bucket]
  u32* s_off = whist + RX_WARPS * nb;
  u32* s_lim = s_off + nb;
  i64* s_glob = (i64*)(rx_smem + rx_off_glob(nb));
  unsigned short* perm = (unsigned short*)(rx_smem + rx_off_perm(nb));
  unsigned short* sbkt = perm + RX_TILE;
  unsigned char* stage = rx_smem + rx_off_stage(nb);
  for (int i = tid; i < RX_WARPS * nb; i += RX_THREADS) whist[i] = 0;

  // -- 1. read h and valid once; bucket ids (nb: invalid or past m) ------
  const i64 base = t * RX_TILE;
  const int wbase = warp * 32 * RX_ITEMS;
  u64 hv[RX_ITEMS];
  bool ok[RX_ITEMS];
#pragma unroll
  for (int k = 0; k < RX_ITEMS; ++k) {
    const i64 i = base + wbase + k * 32 + lane;
    ok[k] = i < a.m && (a.valid == nullptr || a.valid[i] != 0);
    hv[k] = i < a.m ? (u64)a.h[i] : 0;
  }
  int bk[RX_ITEMS];
#pragma unroll
  for (int k = 0; k < RX_ITEMS; ++k) {
    const u32 d = (u32)(hv[k] >> 32) % (u32)a.n_dest;
    const u32 s = (u32)hv[k] & (u32)(a.n_sub - 1);
    bk[k] = ok[k] ? (int)(d * (u32)a.n_sub + s) : nb;
  }
  __syncthreads();  // whist is zero

  // -- warp multisplit: items in (k, lane) order are the warp's rows in order
  u32* wh = whist + warp * nb;
  const unsigned lower = (1u << lane) - 1u;
  u32 rk[RX_ITEMS];
#pragma unroll
  for (int k = 0; k < RX_ITEMS; ++k) {
    const int b = bk[k];
    const unsigned grp = __match_any_sync(0xffffffffu, b);
    const u32 before = b < nb ? wh[b] : 0;
    __syncwarp();
    if (b < nb && (grp >> lane) == 1u) wh[b] = before + __popc(grp);
    __syncwarp();
    rk[k] = before + __popc(grp & lower);
  }
  __syncthreads();

  // -- 2. the tile's counts (each warp's prefix in place), published ------
  u64* status = a.ws + RX_WS_STATUS;
  const u64 agg_tag = 2 * a.epoch + 1, pre_tag = 2 * a.epoch + 2;
  for (int b = tid; b < nb; b += RX_THREADS) {
    u32 c = 0;
    for (int w = 0; w < RX_WARPS; ++w) {
      const u32 x = whist[w * nb + b];
      whist[w * nb + b] = c;
      c += x;
    }
    s_lim[b] = c;
    rx_store(status + t * nb + b, ((t == 0 ? pre_tag : agg_tag) << 32) | c);
  }
  __syncthreads();
  u32 nv = 0;  // the tile's kept rows
  for (int b0 = 0; b0 < nb; b0 += RX_THREADS) {
    const int b = b0 + tid;
    const u32 c = b < nb ? s_lim[b] : 0;
    u32 tot;
    const u32 inc = rx_block_scan(c, &tot);
    if (b < nb) s_off[b] = nv + inc - c;
    nv += tot;
  }
  // the look-back, one thread a bucket
  const bool last = t == a.n_tiles - 1;
  i64 need = 0, dropped = 0;
  for (int b = tid; b < nb; b += RX_THREADS) {
    const u32 c = s_lim[b];
    u32 excl = 0;
    if (t > 0) {
      for (i64 j = t - 1;;) {
        const u64 s = rx_load(status + j * nb + b);
        const u64 tag = s >> 32;
        if (tag < agg_tag) continue;  // not published yet in this call
        excl += (u32)s;
        if (tag == pre_tag) break;
        --j;
      }
      rx_store(status + t * nb + b, (pre_tag << 32) | (excl + c));
    }
    const i64 room = a.cap - (i64)excl;
    const u32 kept = room <= 0 ? 0u : (room < (i64)c ? (u32)room : c);
    s_glob[b] = (i64)b * a.cap + excl - s_off[b];
    s_lim[b] = s_off[b] + kept;
    if (last) {
      const i64 total = (i64)excl + c;
      a.ws[RX_WS_CNT + b] = (u64)total;
      need = need > total ? need : total;
      dropped += total > a.cap ? total - a.cap : 0;
    }
  }
  if (last) {
    __threadfence();  // the counts before the ready word
    for (int o = 16; o > 0; o >>= 1) {
      const i64 x = __shfl_down_sync(0xffffffffu, need, o);
      need = need > x ? need : x;
      dropped += __shfl_down_sync(0xffffffffu, dropped, o);
    }
    if (lane == 0) {
      s_red[0][warp] = need;
      s_red[1][warp] = dropped;
    }
  }
  // -- 3. the permutation sorted by bucket, staged ------------------------
  __syncthreads();
#pragma unroll
  for (int k = 0; k < RX_ITEMS; ++k) {
    const int b = bk[k];
    if (b < nb) {
      const u32 p = s_off[b] + wh[b] + rk[k];
      perm[p] = (unsigned short)(wbase + k * 32 + lane);
      sbkt[p] = (unsigned short)b;
    }
  }
  if (last && tid == 0) {
    i64 nd = 0, dr = 0;
    for (int w = 0; w < RX_WARPS; ++w) {
      nd = nd > s_red[0][w] ? nd : s_red[0][w];
      dr += s_red[1][w];
    }
    a.flags[0] = nd;
    a.flags[1] = dr;
    __threadfence();
    rx_store(a.ws + RX_WS_READY, a.epoch);
  }
  if (tid == 0) s_nv = nv;
  __syncthreads();
  nv = s_nv;
  if (nv == 0) return;
  for (u32 p = tid; p < nv; p += RX_THREADS) {
    const int b = sbkt[p];
    if (p < s_lim[b]) {
      const i64 s = s_glob[b] + p;
      a.rows[s] = base + perm[p];
      a.slot_valid[s] = 1;
    }
  }
  const i64 left = a.m - base;
  const int n_rows = left < RX_TILE ? (int)left : RX_TILE;
  for (int c = 0; c < a.n_cols; ++c) {
    switch (a.es[c]) {
      case 8:
        rx_column<u64>(a.src[c], a.dst[c], (u64*)stage, base, n_rows, nv,
                       perm, sbkt, s_lim, s_glob);
        break;
      case 4:
        rx_column<u32>(a.src[c], a.dst[c], (u32*)stage, base, n_rows, nv,
                       perm, sbkt, s_lim, s_glob);
        break;
      case 2:
        rx_column<unsigned short>(a.src[c], a.dst[c],
                                  (unsigned short*)stage, base, n_rows, nv,
                                  perm, sbkt, s_lim, s_glob);
        break;
      default:
        rx_column<unsigned char>(a.src[c], a.dst[c], stage, base, n_rows,
                                 nv, perm, sbkt, s_lim, s_glob);
    }
  }
}

// hdr (int64): [m, fold, n_keys, valid, h, ok, then per key: data, nulls]
extern "C" int radix_hash_run(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  HashArgs a;
  a.m = hdr[0];
  a.fold = (int)hdr[1];
  a.n_keys = (int)hdr[2];
  a.valid = (const unsigned char*)hdr[3];
  a.h = (i64*)hdr[4];
  a.ok = (unsigned char*)hdr[5];
  if (a.n_keys < 1 || a.n_keys > RX_MAX_KEYS)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < a.n_keys; ++c) {
    a.key[c] = (const i64*)hdr[6 + 2 * c];
    a.knull[c] = (const unsigned char*)hdr[7 + 2 * c];
  }
  if (a.m <= 0) return 0;
  rx_hash<<<grid_for(a.m), TIDB_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// hdr (int64): [m, n_dest, n_sub, cap, h, valid, n_tiles, n_fill, epoch,
//               ws, flags, rows, slot_valid, n_cols,
//               then per column: src, dst, element size]
// n_tiles = max(1, ceil(m / RX_TILE)) (an empty call still writes the
// counts); ws holds RX_WS_STATUS + n_tiles * nb words, zeroed when
// allocated, and no call with a later epoch has run on it; flags (need,
// dropped) 2 int64.
extern "C" int radix_partition_run(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PartArgs a;
  a.m = hdr[0];
  a.n_dest = (int)hdr[1];
  a.n_sub = (int)hdr[2];
  a.nb = a.n_dest * a.n_sub;
  a.cap = hdr[3];
  a.h = (const i64*)hdr[4];
  a.valid = (const unsigned char*)hdr[5];
  a.n_tiles = hdr[6];
  a.n_fill = hdr[7];
  a.epoch = (u64)hdr[8];
  a.ws = (u64*)hdr[9];
  a.flags = (i64*)hdr[10];
  a.rows = (i64*)hdr[11];
  a.slot_valid = (unsigned char*)hdr[12];
  a.n_cols = (int)hdr[13];
  const i64 want_tiles = a.m > 0 ? (a.m + RX_TILE - 1) / RX_TILE : 1;
  if (a.m < 0 || a.m >= (1LL << 31) || a.n_dest < 1 || a.n_sub < 1 ||
      (a.n_sub & (a.n_sub - 1)) != 0 || a.nb + 1 > RX_MAX_BUCKETS ||
      a.cap < 1 || a.n_cols < 0 || a.n_cols > RX_MAX_COLS ||
      a.n_tiles != want_tiles || a.n_fill < 1 || a.epoch < 1 ||
      a.epoch >= (1ULL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < a.n_cols; ++c) {
    a.src[c] = (const void*)hdr[14 + 3 * c];
    a.dst[c] = (void*)hdr[15 + 3 * c];
    a.es[c] = (int)hdr[16 + 3 * c];
    if (a.es[c] != 1 && a.es[c] != 2 && a.es[c] != 4 && a.es[c] != 8)
      return (int)cudaErrorInvalidValue;
  }
  // the most shared memory any call takes, allowed once a device
  static bool smem_set[RX_MAX_DEVICES];
  int device;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device < 0 || device >= RX_MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    e = cudaFuncSetAttribute(rx_partition,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rx_smem_bytes(RX_MAX_BUCKETS - 1));
    if (e != cudaSuccess) return (int)e;
    smem_set[device] = true;
  }
  rx_partition<<<(unsigned)(a.n_tiles + a.n_fill), RX_THREADS,
                 rx_smem_bytes(a.nb), st>>>(a);
  return (int)cudaGetLastError();
}
