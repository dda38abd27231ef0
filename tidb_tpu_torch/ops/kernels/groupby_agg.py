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
runs :func:`groupby_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes

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
#: a block accumulates privately when its bucket table fits this much
#: shared memory
SHARED_BYTES = 48 * 1024

#: launches of the CUDA kernel (chip_smoke.py reads it to prove the path)
LAUNCHES = [0]


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
    ops = [OP_CODES[o] for o in agg_ops]
    vflt = [int(v.is_floating_point()) for v in val_cols]
    stream = torch.cuda.current_stream(dev).cuda_stream

    per_slot = (2 + 2 * m) * 8
    bits = sum(b for b, _o in pack) if pack is not None else None
    direct = False
    if pack is not None and bits <= BUCKET_BITS:
        free, _total = torch.cuda.mem_get_info(dev)
        direct = (1 << bits) * per_slot <= free // 4
    S = (1 << bits) if direct else max(_next_pow2(2 * n), 1024)
    cnt = torch.zeros(S, dtype=i64, device=dev)
    rep = torch.full((S,), n, dtype=i64, device=dev)
    acc, nn = [], []
    for op, fl in zip(agg_ops, vflt):
        if op == "min":
            init = float("inf") if fl else torch.iinfo(i64).max
        elif op == "max":
            init = float("-inf") if fl else torch.iinfo(i64).min
        else:
            init = 0
        dt = torch.float64 if (fl and op in ("sum_f", "min", "max")) else i64
        acc.append(torch.full((S,), init, dtype=dt, device=dev))
        nn.append(torch.zeros(S, dtype=i64, device=dev))
    tbl = None if direct else torch.full((S,), -1, dtype=i64, device=dev)
    n_dist = sum(1 for o in agg_ops if o == "cnt_dist")
    P = max(_next_pow2(2 * n * n_dist), 1024) if n_dist else 0
    pst = pg = pv = pj = None
    if n_dist:
        pst = torch.zeros(P, dtype=torch.int32, device=dev)
        pg = torch.empty(P, dtype=i64, device=dev)
        pv = torch.empty(P, dtype=i64, device=dev)
        pj = torch.empty(P, dtype=torch.int32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    hdr = np.zeros(240, dtype=np.int64)
    hdr[:15] = [n, S, P, n_keys, m, int(not direct),
                int(pack is not None), mask.data_ptr(), cnt.data_ptr(),
                rep.data_ptr(), ptr(tbl), ptr(pst), ptr(pg), ptr(pv),
                ptr(pj)]
    for i in range(n_keys):
        hdr[16 + i] = key_cols[i].data_ptr()
        hdr[24 + i] = key_nulls[i].data_ptr()
        if pack is not None:
            hdr[32 + i], hdr[40 + i] = pack[i]
    for j in range(m):
        hdr[48 + j] = val_cols[j].data_ptr()
        hdr[80 + j] = val_nulls[j].data_ptr()
        hdr[112 + j] = ops[j]
        hdr[144 + j] = vflt[j]
        hdr[176 + j] = acc[j].data_ptr()
        hdr[208 + j] = nn[j].data_ptr()
    from . import build
    shared = S * per_slot if direct and S * per_slot <= SHARED_BYTES else 0
    build.check(_fn("gb_accumulate_run", 3, (1,))(
        hdr.ctypes.data, shared, ctypes.c_void_p(stream)),
        "gb_accumulate_run")

    # live slots, compacted in slot order
    n_tiles = (S + 2047) // 2048
    tile_cnt = torch.empty(n_tiles, dtype=i64, device=dev)
    tile_off = torch.empty(n_tiles, dtype=i64, device=dev)
    gslot = torch.empty(max(min(S, n), 1), dtype=i64, device=dev)
    ng_t = torch.zeros(1, dtype=i64, device=dev)
    build.check(_fn("gb_compact_run", 6)(
        hdr.ctypes.data, tile_cnt.data_ptr(), tile_off.data_ptr(),
        gslot.data_ptr(), ng_t.data_ptr(), ctypes.c_void_p(stream)),
        "gb_compact_run")

    order = None
    if not direct:
        # hash slots are unordered: sort the groups into the contract order
        ng = int(ng_t.item())
        nk = 1 if pack is not None else n_keys
        gk = torch.empty(max(nk * ng, 1), dtype=i64, device=dev)
        gkn = torch.empty(max(nk * ng, 1), dtype=torch.bool, device=dev)
        build.check(_fn("gb_group_keys_run", 6, (2,))(
            hdr.ctypes.data, gslot.data_ptr(), ng, gk.data_ptr(),
            gkn.data_ptr(), ctypes.c_void_p(stream)), "gb_group_keys_run")
        if ng > 0:
            cols = [gk[i * ng:(i + 1) * ng] for i in range(nk)]
            nls = [gkn[i * ng:(i + 1) * ng] for i in range(nk)]
            order = sort_topk._sort_cuda(cols, nls, [False] * nk,
                                         [False] * nk, ng, ng)

    def zeros(dtype):
        return torch.zeros(capacity, dtype=dtype, device=dev)

    key_out = [zeros(i64) for _ in range(n_keys)]
    key_null_out = [zeros(torch.bool) for _ in range(n_keys)]
    res_dt = [torch.float64 if (op == "sum_f" or (fl and op in (
        "min", "max", "first"))) else i64 for op, fl in zip(agg_ops, vflt)]
    results = [zeros(dt) for dt in res_dt]
    result_nulls = [zeros(torch.bool) for _ in range(m)]
    valid = zeros(torch.bool)
    out_hdr = np.zeros(81, dtype=np.int64)
    for i in range(n_keys):
        out_hdr[i] = key_out[i].data_ptr()
        out_hdr[8 + i] = key_null_out[i].data_ptr()
    for j in range(m):
        out_hdr[16 + j] = results[j].data_ptr()
        out_hdr[48 + j] = result_nulls[j].data_ptr()
    out_hdr[80] = valid.data_ptr()
    build.check(_fn("gb_emit_run", 7, (5,))(
        hdr.ctypes.data, out_hdr.ctypes.data, gslot.data_ptr(),
        ptr(order), ng_t.data_ptr(), capacity, ctypes.c_void_p(stream)),
        "gb_emit_run")
    return (tuple(key_out), tuple(key_null_out), tuple(results),
            tuple(result_nulls), ng_t[0], valid)
