// K5a: the join probe of the join -> aggregate fragment, and the count pass
// of the standalone join match (K7).
//
// Replaces: tidb_tpu/executor/device_join.py:553 _combined_join_keys,
// :598 _pack_probe, the dense and sorted probe at :743-768 and the unique
// gather at :776-808 of compile_fragment.run; the searchsorted count pass
// of tidb_tpu/ops/device.py:1473 _join_count_impl.
//
// Two entries:
//   join_range_run  - the data-dependent key packing of two relations:
//                     per key column min/max over both sides' valid rows,
//                     spans, the float64 span-overflow flag, both sides'
//                     packed int64 keys and validity (and the build
//                     rows' invalid flags), and the count of valid build
//                     rows;
//   join_probe_run  - per probe row: pack its key columns with the index's
//                     static (min, span), clamping before the multiply and
//                     excluding NULL or out-of-range keys; look the key up
//                     in the dense CSR (starts[k], starts[k+1]) or search
//                     the sorted keys within [0, n_valid) (never against
//                     the int64.max padding); then, by mode, the build row
//                     and match flag of a unique build, the (start, count)
//                     of a non-unique one and the total of the counts, or
//                     existence; with the join kind's valid rows, the left
//                     join's no-match map and the valid count.  A row
//                     without a match has pos0 = 0 and bi = 0.
// The same valid rows, no-match map and count from a match flag that an ON
// clause's residuals refined come from the expression VM's epilogue
// (csrc/expr_vm.cu), in the launch that refines the flag.
//
// Bound on the card: memory.  Each probe row reads its key columns, null
// flags and validity once and writes its outputs once; every lookup into
// the index (starts, sorted keys, row ids, the build side's validity) is a
// random read, counted as one 32-byte sector each.
//
// Design.  Rows that are invalid, NULL or out of range skip the lookup.
// The dense probe is one thread a row (two reads of the starts).  The
// sorted probe is a persistent grid (blocks x SMs at the occupancy the
// sample allows): each block stages every stride-th sorted key, at most
// `sample` of them, in shared memory once; a row's lower bound is found in
// the sample and then in the one segment of stride - 1 keys that it leaves
// in device memory (an index that fits the sample is searched in shared
// memory alone), and a count gallops from the lower bound to the upper
// (1, 2, 4, ... keys, then a binary search), so a hot key costs O(log cnt)
// reads.  Keys read through a sort order are gathered once per call
// (jp_gather), so the search reads them contiguously.  Counts reduce
// through warp shuffles into one atomic per block.
#include <limits.h>

#include "common.cuh"

#define JP_MAX_KEYS 8

enum { JP_UNIQ = 0, JP_COUNT = 1, JP_EXISTS = 2 };

// --------------------------------------------------------------------------
// key range: _combined_join_keys
// --------------------------------------------------------------------------

struct RangeArgs {
  int k;
  i64 np, nb;
  const i64* pk[JP_MAX_KEYS];
  const unsigned char* pn[JP_MAX_KEYS];
  const i64* bk[JP_MAX_KEYS];
  const unsigned char* bn[JP_MAX_KEYS];
  const unsigned char* pv;  // probe relation validity
  const unsigned char* bv;  // build relation validity
  i64* mm;                  // 2k: min, max per column
  i64* pko;
  unsigned char* pvo;
  i64* bko;
  unsigned char* bvo;
  unsigned char* bio;  // build rows' invalid flags (the sort's NULL flags)
  unsigned char* ovf;
  i64* nbv;
};

__device__ __forceinline__ bool range_row(const RangeArgs& a, i64 i, bool* probe,
                                          i64* r) {
  *probe = i < a.np;
  *r = *probe ? i : i - a.np;
  bool ok = *probe ? a.pv[*r] != 0 : a.bv[*r] != 0;
  for (int c = 0; c < a.k; ++c)
    ok = ok && ((*probe ? a.pn[c][*r] : a.bn[c][*r]) == 0);
  return ok;
}

__global__ void jr_init(RangeArgs a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int c = 0; c < a.k; ++c) {
      a.mm[2 * c] = LLONG_MAX;
      a.mm[2 * c + 1] = LLONG_MIN;
    }
    *a.nbv = 0;
    *a.ovf = 0;
  }
}

__global__ void jr_minmax(RangeArgs a) {
  i64 lo[JP_MAX_KEYS], hi[JP_MAX_KEYS];
#pragma unroll
  for (int c = 0; c < JP_MAX_KEYS; ++c) {
    lo[c] = LLONG_MAX;
    hi[c] = LLONG_MIN;
  }
  const i64 total = a.np + a.nb;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (i64)gridDim.x * blockDim.x) {
    bool probe;
    i64 r;
    if (!range_row(a, i, &probe, &r)) continue;
#pragma unroll
    for (int c = 0; c < JP_MAX_KEYS; ++c) {
      if (c < a.k) {
        const i64 v = probe ? a.pk[c][r] : a.bk[c][r];
        lo[c] = v < lo[c] ? v : lo[c];
        hi[c] = v > hi[c] ? v : hi[c];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < JP_MAX_KEYS; ++c) {
    if (c < a.k) {
      const i64 l = warp_min(lo[c]), h = warp_max(hi[c]);
      if ((threadIdx.x & 31) == 0) {
        if (l != LLONG_MAX) atomicMin((long long*)&a.mm[2 * c], (long long)l);
        if (h != LLONG_MIN) atomicMax((long long*)&a.mm[2 * c + 1], (long long)h);
      }
    }
  }
}

__global__ void jr_pack(RangeArgs a) {
  i64 mn[JP_MAX_KEYS], span[JP_MAX_KEYS];
  double total_f = 1.0;
  for (int c = 0; c < a.k && a.k > 1; ++c) {
    const i64 mx = a.mm[2 * c + 1];
    i64 m = a.mm[2 * c];
    m = m < mx ? m : mx;  // both sides empty
    mn[c] = m;
    // the span in float64 first: mx - mn + 1 wraps in int64 when a
    // column covers more than half the int64 range
    double sf = (double)mx - (double)m + 1.0;
    total_f *= sf > 1.0 ? sf : 1.0;
    const i64 s = wrap_add(wrap_sub(mx, m), 1);
    span[c] = s > 1 ? s : 1;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *a.ovf = (a.k > 1 && total_f > 4611686018427387904.0) ? 1 : 0;
  i64 nvalid = 0;
  const i64 total = a.np + a.nb;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (i64)gridDim.x * blockDim.x) {
    bool probe;
    i64 r;
    const bool ok = range_row(a, i, &probe, &r);
    i64 key;
    if (a.k == 1) {
      key = probe ? a.pk[0][r] : a.bk[0][r];
    } else {
      key = 0;
      for (int c = 0; c < a.k; ++c) {
        const i64 v = probe ? a.pk[c][r] : a.bk[c][r];
        key = wrap_add(wrap_mul(key, span[c]), ok ? wrap_sub(v, mn[c]) : 0);
      }
    }
    if (probe) {
      a.pko[r] = key;
      a.pvo[r] = ok;
    } else {
      a.bko[r] = key;
      a.bvo[r] = ok;
      a.bio[r] = !ok;
      nvalid += ok;
    }
  }
  block_add_to(nvalid, a.nbv);
}

// hdr (int64): [k, np, nb, pv, bv, mm, pko, pvo, bko, bvo, bio, ovf, nbv,
//               then per key column c: pk, pn, bk, bn]
extern "C" int join_range_run(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  RangeArgs a;
  a.k = (int)hdr[0];
  if (a.k < 1 || a.k > JP_MAX_KEYS) return (int)cudaErrorInvalidValue;
  a.np = hdr[1];
  a.nb = hdr[2];
  a.pv = (const unsigned char*)hdr[3];
  a.bv = (const unsigned char*)hdr[4];
  a.mm = (i64*)hdr[5];
  a.pko = (i64*)hdr[6];
  a.pvo = (unsigned char*)hdr[7];
  a.bko = (i64*)hdr[8];
  a.bvo = (unsigned char*)hdr[9];
  a.bio = (unsigned char*)hdr[10];
  a.ovf = (unsigned char*)hdr[11];
  a.nbv = (i64*)hdr[12];
  for (int c = 0; c < a.k; ++c) {
    const i64* h = hdr + 13 + 4 * c;
    a.pk[c] = (const i64*)h[0];
    a.pn[c] = (const unsigned char*)h[1];
    a.bk[c] = (const i64*)h[2];
    a.bn[c] = (const unsigned char*)h[3];
  }
  const i64 total = a.np + a.nb;
  jr_init<<<1, 32, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (a.k > 1 && total > 0) {
    jr_minmax<<<grid_for(total), TIDB_THREADS, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  jr_pack<<<grid_for(total), TIDB_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// pack and probe
// --------------------------------------------------------------------------

struct ProbeArgs {
  i64 n;
  int k;
  int packed;  // key[0] is already the packed key (no range check)
  const i64* key[JP_MAX_KEYS];
  const unsigned char* knull[JP_MAX_KEYS];  // entries may be null
  i64 mn[JP_MAX_KEYS], span[JP_MAX_KEYS];
  const unsigned char* pvalid;  // null: every row valid
  int layout;                   // 0 dense CSR, 1 sorted keys
  const void* a0;
  int a0_64;
  i64 dense_span;
  const i64* ord;  // sorted layout read through this order (may be null)
  i64* sk_buf;     // the keys gathered in sorted order once (with ord)
  int sample;      // sorted layout: most sample entries a block stages
  const void* a1;
  int a1_64;
  i64 nv;
  const i64* nv_ptr;  // n_valid on the device (overrides nv)
  int mode, kind;
  const unsigned char* bvalid;  // build relation validity (may be null)
  i64* bi;
  unsigned char* hit;
  unsigned char* valid;
  unsigned char* nohit;
  i64* pos0;
  i64* cnt;
  i64* count;
};

// Row r's packed key and whether it can match at all: valid, no NULL key
// column, every column inside its pack range.
__device__ __forceinline__ bool probe_key(const ProbeArgs& a, i64 r, bool* pv,
                                          i64* key) {
  *pv = a.pvalid ? a.pvalid[r] != 0 : true;
  bool ok = *pv;
  if (a.packed) {
    *key = a.key[0][r];
    return ok;
  }
  i64 kk = 0;
  for (int c = 0; c < a.k; ++c) {
    const i64 v = wrap_sub(a.key[c][r], a.mn[c]);
    const bool nl = a.knull[c] ? a.knull[c][r] != 0 : false;
    ok = ok && !nl && v >= 0 && v < a.span[c];
    const i64 vc = v < 0 ? 0 : (v > a.span[c] - 1 ? a.span[c] - 1 : v);
    kk = wrap_add(wrap_mul(kk, a.span[c]), vc);
  }
  *key = kk;
  return ok;
}

// Row r's outputs from its CSR start p0 and match count c; returns what the
// row adds to the call's count.  A row with c = 0 writes pos0 = 0 and, in
// unique mode, bi = 0 without reading the row ids.
__device__ __forceinline__ i64 probe_emit(const ProbeArgs& a, i64 r, bool pv,
                                          i64 p0, i64 c, i64 nv) {
  if (a.mode == JP_COUNT) {
    a.pos0[r] = c > 0 ? p0 : 0;
    a.cnt[r] = c;
    return c;
  }
  bool h = c > 0;
  if (a.mode == JP_UNIQ) {
    i64 b = 0;
    if (h) {
      const i64 safe_hi = nv - 1 > 0 ? nv - 1 : 0;
      b = load_index(a.a1, a.a1_64, p0 < 0 ? 0 : (p0 > safe_hi ? safe_hi : p0));
      h = a.bvalid ? a.bvalid[b] != 0 : true;
    }
    a.bi[r] = b;
    a.hit[r] = h;
  }
  const bool v = kind_valid(a.kind, pv, h);
  a.valid[r] = v;
  if (a.nohit) a.nohit[r] = !h;
  return v;
}

__global__ void jp_dense(ProbeArgs a) {
  const i64 nv = a.nv_ptr ? *a.nv_ptr : a.nv;
  i64 local = 0;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < a.n;
       r += (i64)gridDim.x * blockDim.x) {
    bool pv;
    i64 key, p0 = 0, c = 0;
    if (probe_key(a, r, &pv, &key)) {
      const i64 kc = key < 0 ? 0 : (key > a.dense_span - 1 ? a.dense_span - 1 : key);
      p0 = load_index(a.a0, a.a0_64, kc);
      c = load_index(a.a0, a.a0_64, kc + 1) - p0;
    }
    local += probe_emit(a, r, pv, p0, c, nv);
  }
  if (a.count) block_add_to(local, a.count);
}

// The sample's stride: every stride-th sorted key, at most `sample` of them.
__device__ __forceinline__ i64 sample_stride(i64 nv, int sample) {
  const i64 s = (nv + sample - 1) / sample;
  return s > 1 ? s : 1;
}

// Sorted probe.  Each block stages every stride-th key of [0, n_valid) in
// shared memory once (a persistent grid, so once per block for many rows);
// a row's lower bound is searched in the sample, then inside the one
// segment of stride keys in device memory that the sample leaves; the
// upper bound gallops from the lower (1, 2, 4, ... keys, then a binary
// search), so a count costs O(log cnt) reads, a hot key included.  Rows
// that cannot match skip the search.
__global__ void __launch_bounds__(TIDB_THREADS) jp_sorted(ProbeArgs a) {
  extern __shared__ i64 samp[];
  const i64 nv = a.nv_ptr ? *a.nv_ptr : a.nv;
  const i64* sk = a.ord ? a.sk_buf : (const i64*)a.a0;
  const i64 stride = sample_stride(nv, a.sample);
  const i64 ns = (nv + stride - 1) / stride;  // sample entries
  for (i64 j = threadIdx.x; j < ns; j += blockDim.x) samp[j] = sk[j * stride];
  __syncthreads();
  i64 local = 0;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < a.n;
       r += (i64)gridDim.x * blockDim.x) {
    bool pv;
    i64 key, p = 0, c = 0;
    if (probe_key(a, r, &pv, &key) && nv > 0) {
      i64 lo = 0, hi = ns;  // first sample entry >= key
      while (lo < hi) {
        const i64 mid = (lo + hi) >> 1;
        if (samp[mid] < key) lo = mid + 1; else hi = mid;
      }
      // the lower bound lies in ((lo-1)*stride, min(lo*stride, nv)]
      p = lo * stride < nv ? lo * stride : nv;
      if (lo > 0 && stride > 1) {
        i64 l2 = (lo - 1) * stride + 1, h2 = p;
        while (l2 < h2) {
          const i64 mid = (l2 + h2) >> 1;
          if (sk[mid] < key) l2 = mid + 1; else h2 = mid;
        }
        p = l2;
      }
      const bool found = p < nv && (p == lo * stride && lo < ns ? samp[lo] : sk[p]) == key;
      if (found && a.mode == JP_COUNT) {
        i64 good = p, step = 1, bad = nv;  // sk[good] == key; bad: past it
        while (true) {
          const i64 q = good + step;
          if (q >= nv) break;
          if (sk[q] != key) { bad = q; break; }
          good = q;
          step <<= 1;
        }
        i64 l3 = good + 1, h3 = bad;  // the first key above, in (good, bad]
        while (l3 < h3) {
          const i64 mid = (l3 + h3) >> 1;
          if (sk[mid] == key) l3 = mid + 1; else h3 = mid;
        }
        c = l3 - p;
      } else {
        c = found ? 1 : 0;
      }
    }
    local += probe_emit(a, r, pv, p, c, nv);
  }
  if (a.count) block_add_to(local, a.count);
}

// The sorted keys read through an order, gathered once per call.
__global__ void jp_gather(const i64* keys, const i64* ord, i64 nv,
                          const i64* nv_ptr, i64* out) {
  const i64 m = nv_ptr ? *nv_ptr : nv;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (i64)gridDim.x * blockDim.x)
    out[i] = keys[ord[i]];
}

static int launch_sorted(const ProbeArgs& a, cudaStream_t st) {
  // per device: the dynamic shared bytes allowed so far (0: the default
  // 48 KB), the SM count, and the occupancy at the last sample size
  static size_t opted[TIDB_MAX_DEVICES];
  static int sms[TIDB_MAX_DEVICES], per_sm[TIDB_MAX_DEVICES];
  static size_t per_sm_for[TIDB_MAX_DEVICES];
  const size_t shared = (size_t)a.sample * sizeof(i64);
  int dev = 0;
  cudaError_t e = current_device(&dev);
  if (e != cudaSuccess) return (int)e;
  if (shared > 48 * 1024 && shared > opted[dev]) {
    e = cudaFuncSetAttribute(jp_sorted, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shared);
    if (e != cudaSuccess) return (int)e;
    opted[dev] = shared;
  }
  if (per_sm[dev] < 1 || per_sm_for[dev] != shared) {
    if ((e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, jp_sorted,
                                                      TIDB_THREADS, shared);
    if (e != cudaSuccess) return (int)e;
    per_sm[dev] = n < 1 ? 1 : n;
    per_sm_for[dev] = shared;
  }
  const i64 wave = (i64)per_sm[dev] * sms[dev];
  const i64 blocks = (a.n + TIDB_THREADS - 1) / TIDB_THREADS;
  const i64 grid = blocks < wave ? blocks : wave;
  jp_sorted<<<(unsigned)grid, TIDB_THREADS, shared, st>>>(a);
  return (int)cudaGetLastError();
}

// hdr (int64): [n, k, packed, pvalid, layout, a0, a0_64, dense_span, ord,
//               sk_buf, sample, a1, a1_64, nv, nv_ptr, mode, kind, bvalid,
//               bi, hit, valid, nohit, pos0, cnt, count, n_ord,
//               then per key column c: key, knull, mn, span]
// Where ord (n_ord entries) is given, sk_buf holds n_ord int64; count is
// zeroed by the caller.
#define JP_HDR_KEYS 26
extern "C" int join_probe_run(const i64* hdr, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  ProbeArgs a;
  a.n = hdr[0];
  a.k = (int)hdr[1];
  if (a.k < 1 || a.k > JP_MAX_KEYS) return (int)cudaErrorInvalidValue;
  a.packed = (int)hdr[2];
  a.pvalid = (const unsigned char*)hdr[3];
  a.layout = (int)hdr[4];
  a.a0 = (const void*)hdr[5];
  a.a0_64 = (int)hdr[6];
  a.dense_span = hdr[7];
  a.ord = (const i64*)hdr[8];
  a.sk_buf = (i64*)hdr[9];
  a.sample = (int)hdr[10];
  a.a1 = (const void*)hdr[11];
  a.a1_64 = (int)hdr[12];
  a.nv = hdr[13];
  a.nv_ptr = (const i64*)hdr[14];
  a.mode = (int)hdr[15];
  a.kind = (int)hdr[16];
  a.bvalid = (const unsigned char*)hdr[17];
  a.bi = (i64*)hdr[18];
  a.hit = (unsigned char*)hdr[19];
  a.valid = (unsigned char*)hdr[20];
  a.nohit = (unsigned char*)hdr[21];
  a.pos0 = (i64*)hdr[22];
  a.cnt = (i64*)hdr[23];
  a.count = (i64*)hdr[24];
  const i64 n_ord = hdr[25];
  for (int c = 0; c < a.k; ++c) {
    const i64* h = hdr + JP_HDR_KEYS + 4 * c;
    a.key[c] = (const i64*)h[0];
    a.knull[c] = (const unsigned char*)h[1];
    a.mn[c] = h[2];
    a.span[c] = h[3];
  }
  if (a.layout == 0 && a.dense_span < 1) return (int)cudaErrorInvalidValue;
  if (a.layout == 1 && (a.sample < 1 || (a.ord && !a.sk_buf)))
    return (int)cudaErrorInvalidValue;
  if (a.n <= 0) return 0;
  if (a.layout == 0) {
    jp_dense<<<grid_for(a.n), TIDB_THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.ord) {
    jp_gather<<<grid_for(a.nv_ptr ? n_ord : a.nv), TIDB_THREADS, 0, st>>>(
        (const i64*)a.a0, a.ord, a.nv, a.nv_ptr, a.sk_buf);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return launch_sorted(a, st);
}
