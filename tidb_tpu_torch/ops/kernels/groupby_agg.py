"""K1: the masked GROUP BY aggregate of the scan-aggregate fragment.

Contract (``tidb_tpu/ops/device.py:1205 _agg_impl``), slot for slot:

* ``pack`` given (a bit width and offset per key): groups in ascending
  packed-key order, where a key packs as ``NULL ? 0 : key + offset + 1``,
  major key first — NULL groups come first;
* no ``pack``: groups ordered per key by (null flag, value), major key
  first — NULL groups come after all values;
* a group's representative ("first") row is its earliest kept row;
* ``n_groups`` counts every group, also beyond ``capacity``; slots past
  ``min(n_groups, capacity)`` are zero.

:func:`groupby_agg` launches ``csrc/groupby_agg.cu`` for CUDA tensors and
runs :func:`groupby_plain` for CPU tensors.  On the card the slot state
is one workspace (:func:`workspace_layout`), each slot's words together
(:func:`slot_layout`), its buckets in shared memory where they fit
(:func:`accumulate_mode`); the outputs are views of two buffers, every
slot of which the emit kernel writes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import sort_topk

OP_CODES = {"count": 0, "sum_i": 1, "sum_f": 2, "min": 3, "max": 4,
            "first": 5, "cnt_dist": 6}

#: the reference's bound on the direct-bucket key span
#: (tidb_tpu/ops/device.py:1094 _SCATTER_AGG_BITS)
BUCKET_BITS = 26
#: csrc/groupby_agg.cu GB_MAX_KEYS / GB_MAX_AGGS
MAX_KEYS = 8
MAX_AGGS = 32
#: csrc/groupby_agg.cu: where the buckets live while rows accumulate —
#: a copy per warp in shared memory, one per block, or the workspace
MODE_WARP, MODE_BLOCK, MODE_GLOBAL = 0, 1, 2
GB_WARPS = 8
#: shared memory for the warps' copies, and for a block's one copy
WARP_COPIES_BYTES = 64 * 1024
BLOCK_COPY_BYTES = 96 * 1024
#: csrc/groupby_agg.cu SCAN_TILE: live slots a compaction block scans
SCAN_TILE = 2048
#: csrc/groupby_agg.cu make_args: the header's length (int64 words)
HDR_LEN = 256
_ACC_OPS = ("sum_i", "sum_f", "min", "max", "cnt_dist")
_NN_OPS = ("count", "sum_i", "sum_f", "min", "max")

#: launches of the CUDA kernel (chip_smoke.py reads it to prove the path)
LAUNCHES = [0]


class DeviceState(tuple):
    """A state the card's kernels made (K1's, or the fold's): its arrays
    are views of the kernels' own output buffers, contiguous, of one
    capacity, on one device, so the fold takes it without checking each
    array again."""


def _big(dtype, sign):
    if dtype.is_floating_point:
        return sign * float("inf")
    info = torch.iinfo(dtype)
    return info.max if sign > 0 else info.min


def _packed(key_cols, key_nulls, pack):
    packed = torch.zeros_like(key_cols[0], dtype=torch.int64)
    for i, (bits, offset) in enumerate(pack):
        v = torch.where(key_nulls[i], 0,
                        key_cols[i].to(torch.int64) + (offset + 1))
        packed = (packed << bits) | v
    return packed


def groupby_plain(key_cols, key_nulls, val_cols, val_nulls, mask, n_keys,
                  agg_ops, capacity, pack=None):
    """The aggregate in plain torch ops (``torch.unique`` groups the kept
    rows, ``index_add_`` / ``scatter_reduce_`` aggregate them)."""
    dev = mask.device
    n = mask.shape[0]
    i64 = torch.int64
    kept = torch.nonzero(mask).squeeze(1)
    if pack is not None:
        gkey = _packed(key_cols, key_nulls, pack)[kept]
        _u, g = torch.unique(gkey, sorted=True, return_inverse=True)
        ng = int(_u.shape[0])
    else:
        parts = []
        for i in range(n_keys):
            parts.append(key_nulls[i][kept].to(i64))
            parts.append(torch.where(key_nulls[i], 0,
                                     key_cols[i].to(i64))[kept])
        mat = torch.stack(parts, 1) if parts else torch.zeros(
            (len(kept), 1), dtype=i64, device=dev)
        _u, g = torch.unique(mat, dim=0, sorted=True, return_inverse=True)
        ng = int(_u.shape[0])
    rep = torch.full((ng,), n, dtype=i64, device=dev).scatter_reduce_(
        0, g, kept, "amin")
    keep_n = min(ng, capacity)
    sl = slice(0, keep_n)

    def out(t, dtype=None):
        o = torch.zeros(capacity, dtype=dtype or t.dtype, device=dev)
        o[sl] = t[sl]
        return o

    key_out = tuple(out(k[rep]) for k in key_cols)
    key_null_out = tuple(out(kn[rep]) for kn in key_nulls)
    results, result_nulls = [], []
    for j, opn in enumerate(agg_ops):
        v, vn = val_cols[j], val_nulls[j]
        if opn == "first":
            results.append(out(v[rep]))
            result_nulls.append(out(vn[rep]))
            continue
        keep = ~vn[kept]
        vk = v[kept]
        nn = torch.zeros(ng, dtype=i64, device=dev).index_add_(
            0, g, keep.to(i64))
        if opn == "count":
            results.append(out(nn))
            result_nulls.append(torch.zeros(capacity, dtype=torch.bool,
                                            device=dev))
            continue
        if opn == "cnt_dist":
            pairs = torch.stack([g[keep], vk[keep].to(i64)], 1)
            up = torch.unique(pairs, dim=0)
            cd = torch.zeros(ng, dtype=i64, device=dev).index_add_(
                0, up[:, 0], torch.ones(len(up), dtype=i64, device=dev))
            results.append(out(cd))
            result_nulls.append(torch.zeros(capacity, dtype=torch.bool,
                                            device=dev))
            continue
        if opn == "sum_i":
            acc = torch.zeros(ng, dtype=i64, device=dev).index_add_(
                0, g, torch.where(keep, vk.to(i64), 0))
        elif opn == "sum_f":
            acc = torch.zeros(ng, dtype=torch.float64, device=dev).index_add_(
                0, g, torch.where(keep, vk.to(torch.float64), 0.0))
        elif opn in ("min", "max"):
            sign = 1 if opn == "min" else -1
            big = _big(v.dtype, sign)
            acc = torch.full((ng,), big, dtype=v.dtype, device=dev)
            acc.scatter_reduce_(0, g, torch.where(keep, vk, big),
                                "amin" if opn == "min" else "amax")
        else:
            raise ValueError(opn)
        results.append(out(acc))
        result_nulls.append(out(nn == 0))
    n_groups = torch.tensor(ng, dtype=i64, device=dev)
    valid = torch.arange(capacity, device=dev) < ng
    return (key_out, key_null_out, tuple(results), tuple(result_nulls),
            n_groups, valid)


# -- the CUDA path ------------------------------------------------------------

_FNS = {}


def _fn(name, n_args, int_args=()):
    if name not in _FNS:
        from . import build
        _FNS[name] = build.declare(name, n_args, int_args)
    return _FNS[name]


def _next_pow2(n):
    p = 1
    while p < n:
        p <<= 1
    return p


@functools.lru_cache(maxsize=256)
def slot_layout(agg_ops):
    """The words of one slot: word 0 its representative row, then per
    aggregate an accumulator (sums, min, max, count distinct) and a
    non-null count (count, sums, min, max) where it needs them.  Returns
    (stride, acc word per aggregate, count word per aggregate), -1 where
    none; the stride is 1, 2 or a multiple of 4 words, so a slot of at
    most 4 words lies in one 32-byte sector."""
    w, acc_w, nn_w = 1, [], []
    for op in agg_ops:
        acc_w.append(w if op in _ACC_OPS else -1)
        w += op in _ACC_OPS
        nn_w.append(w if op in _NN_OPS else -1)
        w += op in _NN_OPS
    return (w if w <= 2 else -(-w // 4) * 4), tuple(acc_w), tuple(nn_w)


def accumulate_mode(S, stride, hashed):
    """(mode, shared bytes) of the accumulate over S slots of `stride`
    words: a copy per warp where GB_WARPS copies fit WARP_COPIES_BYTES,
    one per block within BLOCK_COPY_BYTES, else the workspace (always on
    the hash path)."""
    copy = S * stride * 8
    if hashed:
        return MODE_GLOBAL, 0
    if GB_WARPS * copy <= WARP_COPIES_BYTES:
        return MODE_WARP, GB_WARPS * copy
    if copy <= BLOCK_COPY_BYTES:
        return MODE_BLOCK, copy
    return MODE_GLOBAL, 0


@functools.lru_cache(maxsize=256)
def workspace_layout(S, P, stride, hashed, n_gslot):
    """The regions of the one workspace: {name: (byte offset, bytes)}, each
    at a 256-byte boundary, and the total bytes.  slots (S x stride
    words), live (a byte per slot), tbl (the hash table), pst / pg / pv /
    pj (the count-distinct set of P entries), tile_cnt / tile_off (the
    compaction's tiles) and gslot (live slot ids)."""
    n_tiles = -(-S // SCAN_TILE)
    sizes = (("slots", S * stride * 8), ("live", S),
             ("tbl", S * 8 if hashed else 0), ("pst", P * 4), ("pg", P * 8),
             ("pv", P * 8), ("pj", P * 4), ("tile_cnt", n_tiles * 8),
             ("tile_off", n_tiles * 8), ("gslot", n_gslot * 8))
    regions, off = {}, 0
    for name, size in sizes:
        regions[name] = (off, size)
        off += -(-size // 256) * 256
    return regions, off


def _check(key_cols, key_nulls, val_cols, val_nulls, mask, agg_ops):
    dev = mask.device
    n = mask.shape[0]
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise TypeError("groupby_agg: mask must be a contiguous bool tensor")
    for t in list(key_cols) + list(val_cols):
        if t.device != dev or t.shape[0] != n or not t.is_contiguous():
            raise ValueError("groupby_agg: columns must be contiguous, "
                             "on the mask's device, of the mask's length")
    for t in key_cols:
        if t.dtype != torch.int64:
            raise TypeError(f"groupby_agg: key dtype {t.dtype} (int64)")
    for t in val_cols:
        if t.dtype not in (torch.int64, torch.float64):
            raise TypeError(f"groupby_agg: value dtype {t.dtype} "
                            "(int64 or float64)")
    for t in list(key_nulls) + list(val_nulls):
        if (t.dtype != torch.bool or t.device != dev or t.shape[0] != n
                or not t.is_contiguous()):
            raise TypeError("groupby_agg: null flags must be contiguous "
                            "bool tensors of the mask's length")
    if len(key_cols) > MAX_KEYS or len(agg_ops) > MAX_AGGS:
        from ..device import DeviceUnsupported
        raise DeviceUnsupported(f"groupby_agg: at most {MAX_KEYS} keys and "
                                f"{MAX_AGGS} aggregate slots on the device")


def groupby_agg(key_cols, key_nulls, val_cols, val_nulls, mask, n_keys,
                agg_ops, capacity, pack=None):
    """Returns (key_out, key_null_out, results, result_nulls, n_groups,
    valid): tuples of `capacity`-long tensors, n_groups a 0-d int64
    tensor.  CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if mask.device.type == "cpu":
        return groupby_plain(key_cols, key_nulls, val_cols, val_nulls, mask,
                             n_keys, agg_ops, capacity, pack)
    out = groupby_cuda(key_cols, key_nulls, val_cols, val_nulls, mask,
                       n_keys, agg_ops, capacity, pack)
    LAUNCHES[0] += 1
    return out


def groupby_cuda(key_cols, key_nulls, val_cols, val_nulls, mask, n_keys,
                 agg_ops, capacity, pack=None):
    """The CUDA kernels of :func:`groupby_agg` on CUDA tensors, uncounted:
    the entry of K1 and of the partial-state merge (merge_states.py),
    which counts its own launches."""
    _check(key_cols, key_nulls, val_cols, val_nulls, mask, agg_ops)
    dev = mask.device
    i64 = torch.int64
    n = mask.shape[0]
    m = len(agg_ops)
    cap = capacity
    vflt = [int(v.is_floating_point()) for v in val_cols]
    stride, acc_w, nn_w = slot_layout(tuple(agg_ops))
    bits = sum(b for b, _o in pack) if pack is not None else None
    S_hash = max(_next_pow2(2 * n), 1024)
    direct = False
    if pack is not None and bits <= BUCKET_BITS:
        # direct buckets where the table is no larger than the hash path's
        # (slots, live bytes and hash table), else where it takes at most
        # a quarter of the free memory
        table = (1 << bits) * (stride * 8 + 1)
        direct = (table <= S_hash * (stride * 8 + 9)
                  or table <= torch.cuda.mem_get_info(dev)[0] // 4)
    S = (1 << bits) if direct else S_hash
    n_dist = sum(1 for o in agg_ops if o == "cnt_dist")
    P = max(_next_pow2(2 * n * n_dist), 1024) if n_dist else 0
    mode, smem = accumulate_mode(S, stride, not direct)
    regions, total = workspace_layout(S, P, stride, not direct,
                                      max(min(S, n), 1))
    ws = torch.empty(total, dtype=torch.uint8, device=dev)
    out_i = torch.empty((n_keys + m) * cap + 1, dtype=i64, device=dev)
    out_b = torch.empty((n_keys + m + 1) * cap, dtype=torch.bool,
                        device=dev)
    base = ws.data_ptr()
    hdr = np.zeros(HDR_LEN, dtype=np.int64)
    hdr[:25] = ([n, S, P, n_keys, m, int(not direct), int(pack is not None),
                 mode, stride, mask.data_ptr()]
                + [base + regions[r][0] for r in (
                    "slots", "live", "tbl", "pst", "pg", "pv", "pj",
                    "tile_cnt", "tile_off", "gslot")]
                + [cap, 0, out_i.data_ptr(), out_b.data_ptr(), smem])
    hdr[32:32 + n_keys] = [t.data_ptr() for t in key_cols]
    hdr[40:40 + n_keys] = [t.data_ptr() for t in key_nulls]
    if pack is not None:
        hdr[48:48 + n_keys] = [b for b, _o in pack]
        hdr[56:56 + n_keys] = [o for _b, o in pack]
    hdr[64:64 + m] = [t.data_ptr() for t in val_cols]
    hdr[96:96 + m] = [t.data_ptr() for t in val_nulls]
    hdr[128:128 + m] = [OP_CODES[o] for o in agg_ops]
    hdr[160:160 + m] = vflt
    hdr[192:192 + m] = acc_w
    hdr[224:224 + m] = nn_w
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    from . import build
    build.check(build.launch(dev, _fn("gb_groups_run", 2), hdr.ctypes.data,
                             stream), "gb_groups_run")
    ng_t = out_i[(n_keys + m) * cap]
    order = None
    if not direct:
        # hash slots are unordered: sort the groups into the contract order
        ng = int(ng_t.item())
        nk = 1 if pack is not None else n_keys
        gk = torch.empty(max(nk * ng, 1), dtype=i64, device=dev)
        gkn = torch.empty(max(nk * ng, 1), dtype=torch.bool, device=dev)
        build.check(build.launch(
            dev, _fn("gb_group_keys_run", 5, (1,)), hdr.ctypes.data, ng,
            gk.data_ptr(), gkn.data_ptr(), stream), "gb_group_keys_run")
        if ng > 0:
            cols = [gk[i * ng:(i + 1) * ng] for i in range(nk)]
            nls = [gkn[i * ng:(i + 1) * ng] for i in range(nk)]
            order = sort_topk._sort_cuda(cols, nls, [False] * nk,
                                         [False] * nk, ng, ng)
            hdr[21] = order.data_ptr()
    build.check(build.launch(dev, _fn("gb_emit_run", 2), hdr.ctypes.data,
                             stream), "gb_emit_run")
    cols = out_i[:(n_keys + m) * cap].view(n_keys + m, cap).unbind(0)
    flags = out_b.view(n_keys + m + 1, cap).unbind(0)
    results = tuple(
        c.view(torch.float64)
        if op == "sum_f" or (fl and op in ("min", "max", "first")) else c
        for c, op, fl in zip(cols[n_keys:], agg_ops, vflt))
    return DeviceState((cols[:n_keys], flags[:n_keys], results,
                        flags[n_keys:-1], ng_t, flags[-1]))
