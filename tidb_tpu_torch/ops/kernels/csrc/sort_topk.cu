// K4: multi-key sort of slots, for ORDER BY ... LIMIT over the groups, the
// hash aggregate's group order, a join's build side and a window's rows.
//
// Replaces: tidb_tpu/executor/device_exec.py:711 _topk_indices.run
// (jnp.lexsort over (live flag, per key: null rank, value)).
//
// Bound on the card: memory.  The least work reads each key column and
// null flag once and writes the L int64 indices.  A radix sort moves its
// keys once per digit on top of that, so the design keeps the key narrow
// and the passes few.
//
// Design: a stable LSD radix sort over a bit-packed composite key.
//   1. sk_stats: each key's order-preserving uint64 (ints: NOT when
//      descending, sign bit flipped; floats: negated when descending, -0
//      and NaN made canonical so NaN sorts after +inf, then the IEEE bit
//      trick), reduced to its least and greatest value over the non-NULL
//      slots, and the key's NULL count.  The host reads these 3 S words
//      (the sort's one device-to-host read) and lays the composite key
//      out (sort_topk.py pack_layout): the major rank (live / dead), then
//      per key its null rank and its value's offset from the least value,
//      each field only as wide as its range needs, cut into 64-bit words.
//   2. Per word, least significant first: sk_word packs the word of every
//      slot (the first word in slot order; a later word through the
//      permutation so far, carrying the slot index), as a uint32 where the
//      word uses at most 32 bits (W2's order, the join sorts), and builds the
//      256-bin histogram of each of its 8-bit digits in one read; sk_plan
//      (one block) scans them into each digit's bin bases and marks a
//      digit whose values all fall in one bin as skipped.
//   3. Per digit, sk_onesweep: each block takes a tile of 4096 (key, slot)
//      pairs into registers, ranks them stably with a warp multisplit
//      (__match_any_sync, a lane's rank the popcount of the lower lanes of
//      its group), finds its tile's global digit offsets by decoupled
//      look-back over the tiles' status words, stages the tile sorted by
//      digit in shared memory and writes each digit's run contiguously.
//      The last pass writes the int64 slot indices.
// Ties fall to the slot index because every pass is stable and the first
// starts from slot order.  Skips are decided on the device, so no pass
// waits on the host; the buffers a pass reads are named in the pass
// control words that sk_plan writes.
#include "common.cuh"

#define SK_MAX_KEYS 16
#define SK_MAX_WORDS 17             // 1 + 16 * 65 bits
#define SK_MAX_PASSES (SK_MAX_WORDS * 8)
#define SK_THREADS 256
#define SK_WARPS (SK_THREADS / 32)
#define SK_ITEMS 16
#define SK_TILE (SK_THREADS * SK_ITEMS)
#define SK_BINS 256
// workspace (bytes): hist u32[8][256] at 0, base u32[8][256] at 8192,
// ctrl int[2 + 3 * passes] at 16384 (cur buffer, identity flag, then per
// pass: source buffer, skip, identity), tile counters u32[passes] at
// 18432, status u64[n_tiles][256] from SK_WS_HEAD
#define SK_WS_BASE 8192
#define SK_WS_CTRL 16384
#define SK_WS_TILECTR 18432
#define SK_WS_HEAD 20480
static_assert(SK_WS_CTRL + 4 * (2 + 3 * SK_MAX_PASSES) <= SK_WS_TILECTR,
              "pass control words overrun the tile counters");
static_assert(SK_WS_TILECTR + 4 * SK_MAX_PASSES <= SK_WS_HEAD,
              "tile counters overrun the status words");

typedef unsigned int u32;

struct KeySpec {
  const i64* col;
  const unsigned char* nul;
  int is_float, desc, nulls_first;
  int null_pos, null_bits, val_pos, val_bits;
  u64 min_u;
};

struct Layout {
  i64 L, ng;
  int S, major_pos, major_bits;
  KeySpec key[SK_MAX_KEYS];
};

__device__ __forceinline__ u64 order_key(i64 v, int is_float, int desc) {
  if (!is_float) {
    const i64 w = desc ? ~v : v;
    return (u64)w ^ (1ULL << 63);
  }
  double d = __longlong_as_double(v);
  if (desc) d = -d;
  if (d == 0.0) d = 0.0;  // -0 == +0
  u64 b = (u64)__double_as_longlong(d);
  if (d != d) b = 0x7ff8000000000000ULL;  // one NaN, sorted after +inf
  return (b >> 63) ? ~b : (b | (1ULL << 63));
}

// The part of a field (value v at bits [pos, pos + bits) of the composite
// key) that falls in word w, shifted into place.
__device__ __forceinline__ u64 sk_place(u64 v, int pos, int bits, int w) {
  const int lo = 64 * w;
  if (bits == 0 || pos >= lo + 64 || pos + bits <= lo) return 0;
  return pos >= lo ? v << (pos - lo) : v >> (lo - pos);
}

__device__ __forceinline__ bool sk_overlaps(int pos, int bits, int w) {
  return bits > 0 && pos < 64 * w + 64 && pos + bits > 64 * w;
}

// Word w of slot j's composite key.
__device__ __forceinline__ u64 sk_pack_word(const Layout& a, int w, i64 j) {
  u64 word = 0;
  if (a.major_bits) word |= sk_place(j >= a.ng ? 1 : 0, a.major_pos, 1, w);
  for (int s = 0; s < a.S; ++s) {
    const KeySpec& k = a.key[s];
    const bool in_null = sk_overlaps(k.null_pos, k.null_bits, w);
    const bool in_val = sk_overlaps(k.val_pos, k.val_bits, w);
    if (!in_null && !in_val) continue;
    const bool isnull = k.nul[j] != 0;
    if (in_null)
      word |= sk_place(isnull != (k.nulls_first != 0) ? 1 : 0, k.null_pos, 1,
                       w);
    if (in_val && !isnull)
      word |= sk_place(order_key(k.col[j], k.is_float, k.desc) - k.min_u,
                       k.val_pos, k.val_bits, w);
  }
  return word;
}

// -- 1. key statistics ----------------------------------------------------------

struct StatsArgs {
  i64 L;
  int S;
  const i64* col[SK_MAX_KEYS];
  const unsigned char* nul[SK_MAX_KEYS];
  int is_float[SK_MAX_KEYS], desc[SK_MAX_KEYS];
  u64* out;  // [S] min, [S] max, [S] NULL count
};

__global__ void sk_stats(StatsArgs a) {
  __shared__ u64 part[3][SK_WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int s = 0; s < a.S; ++s) {
    u64 lo = ~0ULL, hi = 0, nn = 0;
    for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < a.L;
         i += (i64)gridDim.x * blockDim.x) {
      if (a.nul[s][i]) {
        ++nn;
      } else {
        const u64 u = order_key(a.col[s][i], a.is_float[s], a.desc[s]);
        lo = u < lo ? u : lo;
        hi = u > hi ? u : hi;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const u64 l2 = __shfl_down_sync(0xffffffffu, lo, o);
      const u64 h2 = __shfl_down_sync(0xffffffffu, hi, o);
      nn += __shfl_down_sync(0xffffffffu, nn, o);
      lo = l2 < lo ? l2 : lo;
      hi = h2 > hi ? h2 : hi;
    }
    __syncthreads();
    if (lane == 0) {
      part[0][w] = lo;
      part[1][w] = hi;
      part[2][w] = nn;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < SK_WARPS; ++k) {
        lo = part[0][k] < lo ? part[0][k] : lo;
        hi = part[1][k] > hi ? part[1][k] : hi;
        nn += part[2][k];
      }
      if (lo != ~0ULL) atomicMin(&a.out[s], lo);
      if (hi != 0) atomicMax(&a.out[a.S + s], hi);
      if (nn) atomicAdd(&a.out[2 * a.S + s], nn);
    }
  }
}

// -- 2. packing, histograms and the pass plan ----------------------------------

struct WordArgs {
  Layout lay;
  int w, nd, first;
  const int* ctrl;
  void* k[2];  // K keys: uint32 where the word uses at most 32 bits
  u32* v[2];
  u32* hist;  // [8][256]
};

__device__ __forceinline__ void sk_flush(u32* sh, int d, u32 dg, u32 n) {
  if (n) atomicAdd(&sh[d * SK_BINS + dg], n);
}

// Packs word w of every slot as a K and counts its digits.  Each thread
// keeps the run of equal digits it has seen in registers and adds a run to
// the shared histogram when it ends, so a digit that rarely changes costs
// few atomics.
template <typename K>
__global__ void __launch_bounds__(SK_THREADS) sk_word(WordArgs a) {
  __shared__ u32 sh[8 * SK_BINS];
  for (int t = threadIdx.x; t < 8 * SK_BINS; t += blockDim.x) sh[t] = 0;
  __syncthreads();
  const int cur = a.first ? 0 : a.ctrl[0];
  const int ident = a.first ? 1 : a.ctrl[1];
  const int dst = a.first ? 0 : cur ^ 1;
  const u32* perm = cur ? a.v[1] : a.v[0];
  K* kd = (K*)(dst ? a.k[1] : a.k[0]);
  u32* vd = dst ? a.v[1] : a.v[0];
  u32 prev[8], run[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) prev[d] = run[d] = 0;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < a.lay.L;
       i += (i64)gridDim.x * blockDim.x) {
    const i64 j = ident ? i : (i64)perm[i];
    const K key = (K)sk_pack_word(a.lay, a.w, j);
    kd[i] = key;
    if (!a.first) vd[i] = (u32)j;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      if (d < a.nd) {
        const u32 dg = (u32)((u64)key >> (8 * d)) & 255u;
        if (dg != prev[d]) {
          sk_flush(sh, d, prev[d], run[d]);
          prev[d] = dg;
          run[d] = 0;
        }
        ++run[d];
      }
    }
  }
#pragma unroll
  for (int d = 0; d < 8; ++d)
    if (d < a.nd) sk_flush(sh, d, prev[d], run[d]);
  __syncthreads();
  for (int t = threadIdx.x; t < a.nd * SK_BINS; t += blockDim.x)
    if (sh[t]) atomicAdd(&a.hist[t], sh[t]);
}

// Inclusive sum of v over the block's 256 threads.
__device__ __forceinline__ u32 sk_block_scan(u32 v, u32* wsum) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const u32 n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  if (w == 0) {
    u32 s = lane < SK_WARPS ? wsum[lane] : 0;
    for (int o = 1; o < SK_WARPS; o <<= 1) {
      const u32 n = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += n;
    }
    if (lane < SK_WARPS) wsum[lane] = s;
  }
  __syncthreads();
  if (w > 0) v += wsum[w - 1];
  __syncthreads();
  return v;
}

// One block of 256 threads, thread b for bin b: each digit's bin bases and
// skip flag, the pass control words of word w's passes (seq0 onwards), and
// the histogram zeroed for the next word.
__global__ void sk_plan(u32* hist, u32* base, int* ctrl, i64 L, int w,
                        int nd, int seq0, int last_word) {
  __shared__ u32 wsum[SK_WARPS];
  __shared__ int skip[8];
  const int b = threadIdx.x;
  for (int d = 0; d < nd; ++d) {
    const u32 c = hist[d * SK_BINS + b];
    const int one_bin = __syncthreads_or((i64)c == L);
    const u32 incl = sk_block_scan(c, wsum);
    base[d * SK_BINS + b] = incl - c;
    hist[d * SK_BINS + b] = 0;
    if (b == 0) skip[d] = one_bin && !(last_word && d == nd - 1);
  }
  __syncthreads();
  if (b == 0) {
    int c = w == 0 ? 0 : ctrl[0] ^ 1;
    int id = w == 0 ? 1 : 0;
    for (int d = 0; d < nd; ++d) {
      int* p = ctrl + 2 + 3 * (seq0 + d);
      p[0] = c;
      p[1] = skip[d];
      p[2] = id;
      if (!skip[d]) {
        c ^= 1;
        id = 0;
      }
    }
    ctrl[0] = c;
    ctrl[1] = id;
  }
}

// -- 3. the onesweep pass -----------------------------------------------------------

struct PassArgs {
  void* k[2];
  u32* v[2];
  i64* out;
  const int* ctrl;  // this pass's [source buffer, skip, identity]
  const u32* base;  // this digit's 256 bin bases
  u64* status;      // [n_tiles][256]: tag << 32 | count
  u32* tile_ctr;
  i64 L;
  int shift, seq, final_pass;
};

__device__ __forceinline__ u64 sk_load_status(const u64* p) {
  return *(const volatile u64*)p;
}

__device__ __forceinline__ void sk_store_status(u64* p, u32 tag, u32 n) {
  *(volatile u64*)p = ((u64)tag << 32) | n;
}

template <typename K>
__global__ void __launch_bounds__(SK_THREADS) sk_onesweep(PassArgs a) {
  if (a.ctrl[1]) return;  // every key has this digit's one value
  const int src = a.ctrl[0], ident = a.ctrl[2];
  extern __shared__ __align__(16) unsigned char sk_smem[];
  K* skey = (K*)sk_smem;
  u32* sval = (u32*)(skey + SK_TILE);
  u32* whist = sval + SK_TILE;  // [warp][digit]
  __shared__ u32 s_off[SK_BINS];
  __shared__ i64 s_glob[SK_BINS];
  __shared__ u32 wsum[SK_WARPS];
  __shared__ u32 s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t = tid; t < SK_WARPS * SK_BINS; t += SK_THREADS) whist[t] = 0;
  // tiles in the order blocks start, so every tile a block waits on is
  // already running
  if (tid == 0) s_tile = atomicAdd(a.tile_ctr, 1u);
  __syncthreads();
  const u32 tile = s_tile;
  const i64 tbase = (i64)tile * SK_TILE;
  const i64 wbase = tbase + (i64)warp * 32 * SK_ITEMS;
  const K* ks = (const K*)(src ? a.k[1] : a.k[0]);
  const u32* vs = src ? a.v[1] : a.v[0];
  K key[SK_ITEMS];
  u32 val[SK_ITEMS], rank[SK_ITEMS];
#pragma unroll
  for (int k = 0; k < SK_ITEMS; ++k) {
    const i64 i = wbase + k * 32 + lane;
    key[k] = i < a.L ? ks[i] : 0;
    val[k] = i < a.L ? (ident ? (u32)i : vs[i]) : 0;
  }
  // warp multisplit: items in (k, lane) order are the warp's slots in order
  u32* wh = whist + warp * SK_BINS;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < SK_ITEMS; ++k) {
    const i64 i = wbase + k * 32 + lane;
    const int dg = i < a.L ? (int)((key[k] >> a.shift) & 255) : SK_BINS;
    const unsigned grp = __match_any_sync(0xffffffffu, dg);
    const u32 before = dg < SK_BINS ? wh[dg] : 0;
    __syncwarp();
    if (dg < SK_BINS && (grp >> lane) == 1u) wh[dg] = before + __popc(grp);
    __syncwarp();
    rank[k] = before + __popc(grp & lower);
  }
  __syncthreads();
  // thread d: digit d's count in the tile; each warp's exclusive prefix
  const int d = tid;
  u32 cnt = 0;
  for (int w = 0; w < SK_WARPS; ++w) {
    const u32 c = whist[w * SK_BINS + d];
    whist[w * SK_BINS + d] = cnt;
    cnt += c;
  }
  const u32 agg_tag = 2u * a.seq + 1u, pre_tag = 2u * a.seq + 2u;
  u64* mine = a.status + (i64)tile * SK_BINS + d;
  sk_store_status(mine, tile == 0 ? pre_tag : agg_tag, cnt);
  const u32 incl = sk_block_scan(cnt, wsum);
  s_off[d] = incl - cnt;
  u32 excl = 0;
  if (tile > 0) {
    i64 j = (i64)tile - 1;
    while (true) {
      const u64 s = sk_load_status(a.status + j * SK_BINS + d);
      const u32 tag = (u32)(s >> 32);
      if (tag < agg_tag) continue;  // not published yet in this pass
      excl += (u32)s;
      if (tag == pre_tag) break;
      --j;
    }
    sk_store_status(mine, pre_tag, excl + cnt);
  }
  s_glob[d] = (i64)a.base[d] + excl - (i64)(incl - cnt);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SK_ITEMS; ++k) {
    const i64 i = wbase + k * 32 + lane;
    if (i < a.L) {
      const int dg = (int)((key[k] >> a.shift) & 255);
      const u32 pos = s_off[dg] + wh[dg] + rank[k];
      skey[pos] = key[k];
      sval[pos] = val[k];
    }
  }
  __syncthreads();
  const i64 left = a.L - tbase;
  const int n = left < SK_TILE ? (int)left : SK_TILE;
  K* kd = (K*)(src ? a.k[0] : a.k[1]);
  u32* vd = src ? a.v[0] : a.v[1];
  for (int t = tid; t < n; t += SK_THREADS) {
    const K kk = skey[t];
    const i64 g = s_glob[(kk >> a.shift) & 255] + t;
    if (a.final_pass) {
      a.out[g] = (i64)sval[t];
    } else {
      kd[g] = kk;
      vd[g] = sval[t];
    }
  }
}

__global__ void sk_iota(i64* out, i64 L) {
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < L;
       i += (i64)gridDim.x * blockDim.x)
    out[i] = i;
}

// -- launchers -----------------------------------------------------------------------

template <typename K>
static cudaError_t sk_launch_pass(const PassArgs& pa, i64 n_tiles,
                                  cudaStream_t st) {
  const size_t smem = (size_t)SK_TILE * (sizeof(K) + sizeof(u32)) +
                      SK_WARPS * SK_BINS * sizeof(u32);
  cudaError_t e = cudaFuncSetAttribute(
      sk_onesweep<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  sk_onesweep<K><<<(unsigned)n_tiles, SK_THREADS, smem, st>>>(pa);
  return cudaGetLastError();
}

// hdr (int64): [S, L, out, then per key s: col, null, is_float, desc]
// out (S x 3 uint64) receives the minima, maxima and NULL counts.
extern "C" int sort_keys_stats(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  StatsArgs a;
  a.S = (int)hdr[0];
  a.L = hdr[1];
  a.out = (u64*)hdr[2];
  if (a.S < 1 || a.S > SK_MAX_KEYS || a.L < 1) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < a.S; ++s) {
    const i64* h = hdr + 3 + 4 * s;
    a.col[s] = (const i64*)h[0];
    a.nul[s] = (const unsigned char*)h[1];
    a.is_float[s] = (int)h[2];
    a.desc[s] = (int)h[3];
  }
  cudaError_t e = cudaMemsetAsync(a.out, 0xff, sizeof(u64) * a.S, st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(a.out + a.S, 0, sizeof(u64) * 2 * a.S, st);
  if (e != cudaSuccess) return (int)e;
  sk_stats<<<grid_for(a.L), SK_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// hdr (int64): [S, L, ng, bits, words, n_tiles, ws, k0, k1, v0, v1, out,
//               major_pos, major_bits, digits of each word,
//               then per key s: col, null, is_float, desc, nulls_first,
//               null_pos, null_bits, val_pos, val_bits, min]
// ws holds SK_WS_HEAD + n_tiles * 256 * 8 bytes; k0/k1 (uint64) and v0/v1
// (uint32) hold L entries each, out L int64.
extern "C" int sort_keys_run(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Layout lay;
  lay.S = (int)hdr[0];
  lay.L = hdr[1];
  lay.ng = hdr[2];
  const int bits = (int)hdr[3], words = (int)hdr[4];
  const i64 n_tiles = hdr[5];
  unsigned char* ws = (unsigned char*)hdr[6];
  u64* kb[2] = {(u64*)hdr[7], (u64*)hdr[8]};
  u32* vb[2] = {(u32*)hdr[9], (u32*)hdr[10]};
  i64* out = (i64*)hdr[11];
  lay.major_pos = (int)hdr[12];
  lay.major_bits = (int)hdr[13];
  if (lay.S < 1 || lay.S > SK_MAX_KEYS || lay.L < 1 ||
      lay.L >= (1LL << 32) || words < 0 || words > SK_MAX_WORDS ||
      n_tiles != (lay.L + SK_TILE - 1) / SK_TILE)
    return (int)cudaErrorInvalidValue;
  const i64* dg = hdr + 14;
  if (words != (bits + 63) / 64) return (int)cudaErrorInvalidValue;
  for (int w = 0; w < words; ++w) {
    const int used = bits - 64 * w < 64 ? bits - 64 * w : 64;
    if (dg[w] != (used + 7) / 8) return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < lay.S; ++s) {
    const i64* h = hdr + 14 + words + 10 * s;
    KeySpec& k = lay.key[s];
    k.col = (const i64*)h[0];
    k.nul = (const unsigned char*)h[1];
    k.is_float = (int)h[2];
    k.desc = (int)h[3];
    k.nulls_first = (int)h[4];
    k.null_pos = (int)h[5];
    k.null_bits = (int)h[6];
    k.val_pos = (int)h[7];
    k.val_bits = (int)h[8];
    k.min_u = (u64)h[9];
  }
  cudaError_t e;
  if (bits == 0) {  // one distinct composite key: slot order
    sk_iota<<<grid_for(lay.L), SK_THREADS, 0, st>>>(out, lay.L);
    return (int)cudaGetLastError();
  }
  u32* hist = (u32*)ws;
  u32* base = (u32*)(ws + SK_WS_BASE);
  int* ctrl = (int*)(ws + SK_WS_CTRL);
  u32* tile_ctr = (u32*)(ws + SK_WS_TILECTR);
  u64* status = (u64*)(ws + SK_WS_HEAD);
  if ((e = cudaMemsetAsync(ws, 0, SK_WS_HEAD + n_tiles * SK_BINS * 8, st)) !=
      cudaSuccess)
    return (int)e;
  const int word_grid = grid_for(lay.L) < 132 * 4 ? grid_for(lay.L) : 132 * 4;
  int seq = 0;
  for (int w = 0; w < words; ++w) {
    const bool narrow = bits - 64 * w <= 32;
    WordArgs wa;
    wa.lay = lay;
    wa.w = w;
    wa.nd = (int)dg[w];
    wa.first = w == 0;
    wa.ctrl = ctrl;
    wa.k[0] = kb[0];
    wa.k[1] = kb[1];
    wa.v[0] = vb[0];
    wa.v[1] = vb[1];
    wa.hist = hist;
    if (narrow)
      sk_word<u32><<<word_grid, SK_THREADS, 0, st>>>(wa);
    else
      sk_word<u64><<<word_grid, SK_THREADS, 0, st>>>(wa);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    sk_plan<<<1, SK_BINS, 0, st>>>(hist, base, ctrl, lay.L, w, wa.nd, seq,
                                   w == words - 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    for (int d = 0; d < wa.nd; ++d, ++seq) {
      PassArgs pa;
      pa.k[0] = kb[0];
      pa.k[1] = kb[1];
      pa.v[0] = vb[0];
      pa.v[1] = vb[1];
      pa.out = out;
      pa.ctrl = ctrl + 2 + 3 * seq;
      pa.base = base + d * SK_BINS;
      pa.status = status;
      pa.tile_ctr = tile_ctr + seq;
      pa.L = lay.L;
      pa.shift = 8 * d;
      pa.seq = seq;
      pa.final_pass = w == words - 1 && d == wa.nd - 1;
      e = narrow ? sk_launch_pass<u32>(pa, n_tiles, st)
                 : sk_launch_pass<u64>(pa, n_tiles, st);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}
