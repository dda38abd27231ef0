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
// Design (the simple, correct first one).  The parts stay where they
// are: the wrapper hands the kernel a device table with one row per part
// (a pointer to its n_groups, its capacity, its base row, and a pointer
// per key, key NULL flag, result and result NULL flag).  `ms_gather`
// reads each part's n_groups on the device and copies that part's live
// slots to rows [base, base + n_groups) of flat arrays, where base is the
// sum of the capacities of the parts before it; it writes the row mask
// (live or not) for every row.  So no host read of a part's n_groups and
// no torch.cat: one launch moves only live slots, and a dead slot costs
// one mask byte.  The flat rows then go through K1's accumulate, compact
// and emit kernels (groupby_agg.cu) with the merge ops, which gives the
// output K1's contract: packed-key order (hash order sorted by key
// without a pack), a NULL key its own group, `first` from the earliest
// part (row order is part order, the running state first), exact int64
// sums, and n_groups exact past `merge_cap`.
//
// grid.y walks the parts and grid.x the slots of one part, so a fold of
// many small states (TPC-H Q1: 15 parts of a few slots) and one of a few
// large ones (Q18: 8 parts of 2^22 slots plus a 2^24-slot running state)
// both fill the card.
#include "common.cuh"

#define MS_MAX_KEYS 8
#define MS_MAX_AGGS 32

struct MsOut {
  i64* k[MS_MAX_KEYS];
  unsigned char* kn[MS_MAX_KEYS];
  i64* v[MS_MAX_AGGS];
  unsigned char* vn[MS_MAX_AGGS];
  unsigned char* mask;
  int nk, m;
};

// table row p (int64, `stride` entries), mirrored by
// ops/kernels/merge_states.py: 0 n_groups pointer, 1 capacity, 2 base
// row, 3 + i key i, 3 + nk + i key NULL flags i, 3 + 2nk + j result j,
// 3 + 2nk + m + j result NULL flags j.
__global__ void ms_gather(const i64* table, i64 n_parts, i64 stride,
                          MsOut o) {
  for (i64 p = blockIdx.y; p < n_parts; p += gridDim.y) {
    const i64* t = table + p * stride;
    const i64 cap = t[1], base = t[2];
    i64 live = *(const i64*)t[0];
    live = live < 0 ? 0 : (live > cap ? cap : live);
    for (i64 s = (i64)blockIdx.x * blockDim.x + threadIdx.x; s < cap;
         s += (i64)gridDim.x * blockDim.x) {
      const i64 r = base + s;
      const bool on = s < live;
      o.mask[r] = on;
      if (!on) continue;
      for (int i = 0; i < o.nk; ++i) {
        o.k[i][r] = ((const i64*)t[3 + i])[s];
        o.kn[i][r] = ((const unsigned char*)t[3 + o.nk + i])[s];
      }
      for (int j = 0; j < o.m; ++j) {
        o.v[j][r] = ((const i64*)t[3 + 2 * o.nk + j])[s];
        o.vn[j][r] = ((const unsigned char*)t[3 + 2 * o.nk + o.m + j])[s];
      }
    }
  }
}

// out_hdr (int64): 0 nk, 1 m, 2 mask, 8 + i: keys | 16 + i: key NULL
// flags | 24 + j: results | 56 + j: result NULL flags.
extern "C" int ms_gather_run(const i64* table, i64 n_parts, i64 stride,
                             i64 max_cap, const i64* out_hdr, void* stream) {
  MsOut o;
  o.nk = (int)out_hdr[0];
  o.m = (int)out_hdr[1];
  if (o.nk > MS_MAX_KEYS || o.m > MS_MAX_AGGS || n_parts <= 0)
    return (int)cudaErrorInvalidValue;
  o.mask = (unsigned char*)out_hdr[2];
  for (int i = 0; i < o.nk; ++i) {
    o.k[i] = (i64*)out_hdr[8 + i];
    o.kn[i] = (unsigned char*)out_hdr[16 + i];
  }
  for (int j = 0; j < o.m; ++j) {
    o.v[j] = (i64*)out_hdr[24 + j];
    o.vn[j] = (unsigned char*)out_hdr[56 + j];
  }
  const i64 gy = n_parts < 65535 ? n_parts : 65535;
  i64 gx = (max_cap + TIDB_THREADS - 1) / TIDB_THREADS;
  const i64 fill = (132 * 8 + gy - 1) / gy;  // blocks per part to fill the card
  if (gx > fill) gx = fill;
  if (gx < 1) gx = 1;
  dim3 grid((unsigned)gx, (unsigned)gy);
  ms_gather<<<grid, TIDB_THREADS, 0, (cudaStream_t)stream>>>(table, n_parts,
                                                             stride, o);
  return (int)cudaGetLastError();
}
