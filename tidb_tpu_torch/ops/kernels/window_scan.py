"""K10: window functions over the default frame, after the window's sort.

What it computes (``tidb_tpu/executor/device_exec.py:1529 device_window.run``
after its lexsort): over the rows in sorted order ``idx`` (None: input
order), the partition and peer change flags (row 0, row ``n_live`` — the
first bucket-padding row, which starts a trailing partition of its own —
and every change of a NULL-masked key value or NULL flag), the partition
and peer-group bounds, and per function ``row_number``, ``rank``,
``dense_rank``, ``percent_rank``, ``cume_dist``, or ``count`` / ``sum`` /
``min`` / ``max`` of an argument column over the default frame (through
the row's peer group with ORDER BY, the whole partition without), NULL
where the frame holds no non-NULL value.  Results come back in INPUT
order, ``nb`` rows each (the caller slices off the padding).

:func:`run` launches ``csrc/window_scan.cu`` on CUDA tensors and
:func:`window_plain` on CPU tensors: the reference's formulation in
torch — cummax / reversed cummin for the bounds, prefix-sum differences
for counts and integer sums (exact under int64 wrap), and a log-depth
Hillis-Steele ``(flag, value)`` scan (``tidb_tpu/ops/device.py:1042
_seg_running``) for float sums, MIN and MAX.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .sort_topk import MAX_KEYS  # csrc WS_MAX_KEYS: K4's key limit

#: launches of the CUDA kernel (chip_smoke.py reads it to prove the path)
LAUNCHES = [0]

#: the functions, and their codes in csrc/window_scan.cu
FUNC_CODES = {"row_number": 0, "rank": 1, "dense_rank": 2,
              "percent_rank": 3, "cume_dist": 4, "count": 5, "sum": 6,
              "min": 6, "max": 6}
#: lane combines and value sources (csrc/window_scan.cu)
_ADD_I, _ADD_F, _MIN_I, _MAX_I, _MIN_F, _MAX_F, _FIRST = range(7)
_POS, _PEER, _VALID, _ARG = range(4)
_TILE = 256 * 8


# -- the plain version ---------------------------------------------------------

def _seg_running(comb, is_new, z):
    """Segmented running reduction resetting at every True of `is_new`:
    the (flag, value) scan of the reference's ``_seg_running``, as log2(n)
    Hillis-Steele steps."""
    f, v = is_new.clone(), z.clone()
    n, s = v.shape[0], 1
    while s < n:
        v = torch.cat([v[:s], torch.where(f[s:], v[s:],
                                          comb(v[:-s], v[s:]))])
        f = torch.cat([f[:s], f[:-s] | f[s:]])
        s <<= 1
    return v


def _change(kvs, idx, nb, dev):
    ch = torch.zeros(nb, dtype=torch.bool, device=dev)
    ch[0] = True
    for d, nl in kvs:
        # NULL rows carry arbitrary data: mask before comparing
        dm = torch.where(nl, torch.zeros((), dtype=d.dtype, device=dev), d)
        ds, ns = dm[idx], nl[idx]
        ch[1:] |= (ds[1:] != ds[:-1]) | (ns[1:] != ns[:-1])
    return ch


def window_plain(nb: int, n_live: int, idx, part_keys, order_keys, args,
                 funcs, dev):
    """The plain PyTorch version of :func:`run` (same arguments)."""
    i = torch.arange(nb, device=dev)
    if idx is None:
        idx = i
    part = _change(part_keys, idx, nb, dev) | (i == n_live)
    peer = part | _change(order_keys, idx, nb, dev)
    spos = torch.cummax(torch.where(part, i, -1), 0).values
    ppos = torch.cummax(torch.where(peer, i, -1), 0).values

    def seg_end(chg):
        nxt = torch.cat([torch.where(chg[1:], i[1:], nb),
                         torch.full((1,), nb, device=dev)])
        return torch.cummin(nxt.flip(0), 0).values.flip(0) - 1

    epos = seg_end(part)
    pe = seg_end(peer) if order_keys else epos
    m = epos - spos + 1
    false = torch.zeros(nb, dtype=torch.bool, device=dev)

    def scatter(v, nl):
        out = torch.empty_like(v)
        out[idx] = v
        onl = torch.empty_like(nl)
        onl[idx] = nl
        return out, onl

    outs = []
    for name, a in funcs:
        if name == "row_number":
            outs.append(scatter(i - spos + 1, false))
            continue
        if name == "rank":
            outs.append(scatter(ppos - spos + 1, false))
            continue
        if name == "dense_rank":
            c = torch.cumsum(peer.to(torch.int64), 0)
            outs.append(scatter(c - c[spos] + 1, false))
            continue
        if name == "percent_rank":
            r = (ppos - spos).to(torch.float64)
            v = torch.where(m > 1, r / torch.clamp(m - 1, min=1), 0.0)
            outs.append(scatter(v, false))
            continue
        if name == "cume_dist":
            v = (pe - spos + 1).to(torch.float64) / m
            outs.append(scatter(v, false))
            continue
        d, nl = args[a]
        ds, ns = d[idx], nl[idx]
        cnt_v = (~ns).to(torch.int64)
        ccs = torch.cumsum(cnt_v, 0)
        cnt_run = ccs[pe] - ccs[spos] + cnt_v[spos]
        if name == "count":
            outs.append(scatter(cnt_run, false))
            continue
        fl = d.is_floating_point()
        if name == "sum":
            z = torch.where(ns, torch.zeros((), dtype=d.dtype, device=dev),
                            ds)
            if fl:  # segmented: no other partition's magnitude leaks in
                s = _seg_running(torch.add, part, z)[pe]
            else:   # ints: prefix differences are exact under wrap
                cs = torch.cumsum(z, 0)
                s = cs[pe] - cs[spos] + z[spos]
            outs.append(scatter(s, cnt_run == 0))
            continue
        if fl:
            ident = float("inf") if name == "min" else float("-inf")
        else:
            info = torch.iinfo(d.dtype)
            ident = info.max if name == "min" else info.min
        z = torch.where(ns, torch.full((), ident, dtype=d.dtype, device=dev),
                        ds)
        comb = torch.minimum if name == "min" else torch.maximum
        outs.append(scatter(_seg_running(comb, part, z)[pe], cnt_run == 0))
    return outs


# -- the kernel wrapper --------------------------------------------------------

_FN = [None]


def _kernel():
    if _FN[0] is None:
        from . import build
        _FN[0] = build.declare("window_scan_run", 2)
    return _FN[0]


def _check(idx, cols, nb, dev):
    if idx is not None and (idx.device != dev or idx.dtype != torch.int64
                            or not idx.is_contiguous()
                            or idx.shape[0] < nb):
        raise ValueError("window_scan: idx must be a contiguous int64 "
                         "tensor of at least nb rows on the device")
    for d, nl in cols:
        if d.device != dev or nl.device != dev:
            raise ValueError("window_scan: columns on different devices")
        if d.dtype not in (torch.int64, torch.float64):
            raise TypeError(f"window_scan: column dtype {d.dtype} "
                            "(int64 or float64 expected)")
        if nl.dtype != torch.bool:
            raise TypeError("window_scan: NULL flags must be bool")
        if not (d.is_contiguous() and nl.is_contiguous()):
            raise ValueError("window_scan: columns must be contiguous")
        if d.shape[0] < nb or nl.shape[0] < nb:
            raise ValueError("window_scan: column shorter than nb")


def _run_cuda(nb, n_live, idx, part_keys, order_keys, args, funcs, dev):
    keys = list(part_keys) + list(order_keys)
    if len(keys) > MAX_KEYS:  # device_window declines these first
        raise ValueError(f"window_scan: at most {MAX_KEYS} partition and "
                         "order keys")
    _check(idx, keys + list(args), nb, dev)
    has_order = bool(order_keys)
    i64 = torch.int64

    def lane_buf():
        return torch.empty(nb, dtype=i64, device=dev)

    # lanes: (op, src, flag bit, backward, column, nulls, out)
    lanes = []

    def add_lane(op, src, bit, rev, col=None):
        out = lane_buf()
        d, nl = col if col is not None else (None, None)
        lanes.append((op, src, bit, rev, d, nl, out))
        return out

    spos = add_lane(_FIRST, _POS, 0, 0)
    epos = add_lane(_FIRST, _POS, 0, 1)
    ppos = add_lane(_FIRST, _POS, 1, 0) if has_order else spos
    pe = add_lane(_FIRST, _POS, 1, 1) if has_order else epos
    dense, counts, table, outs = None, {}, [], []
    for name, a in funcs:
        val = cnt = None
        dt = (torch.float64 if name in ("percent_rank", "cume_dist")
              else args[a][0].dtype if name in ("sum", "min", "max")
              else i64)
        if name == "dense_rank":
            if dense is None:
                dense = add_lane(_ADD_I, _PEER, 0, 0)
            val = dense
        elif name in ("count", "sum", "min", "max"):
            if a not in counts:
                counts[a] = add_lane(_ADD_I, _VALID, 0, 0, args[a])
            cnt = counts[a]
            if name != "count":
                fl = dt == torch.float64
                op = {"sum": _ADD_F if fl else _ADD_I,
                      "min": _MIN_F if fl else _MIN_I,
                      "max": _MAX_F if fl else _MAX_I}[name]
                val = add_lane(op, _ARG, 0, 0, args[a])
        out = (torch.empty(nb, dtype=dt, device=dev),
               torch.empty(nb, dtype=torch.bool, device=dev))
        outs.append(out)
        table += [FUNC_CODES[name], 0 if val is None else val.data_ptr(),
                  0 if cnt is None else cnt.data_ptr(), out[0].data_ptr(),
                  out[1].data_ptr()]
    lane_tab = []
    for op, src, bit, rev, d, nl, out in lanes:
        lane_tab += [op, src, bit, rev, 0 if d is None else d.data_ptr(),
                     0 if nl is None else nl.data_ptr(), out.data_ptr(), 0]
    n_tiles = (nb + _TILE - 1) // _TILE
    L = len(lanes)
    flags = torch.empty(nb, dtype=torch.uint8, device=dev)
    tile_hf = torch.empty(L * n_tiles, dtype=torch.int32, device=dev)
    tile_v = torch.empty(L * n_tiles, dtype=i64, device=dev)
    pre_hf = torch.empty(L * n_tiles, dtype=torch.int32, device=dev)
    pre_v = torch.empty(L * n_tiles, dtype=i64, device=dev)
    tabs = torch.from_numpy(np.asarray(lane_tab + (table or [0]),
                                       dtype=np.int64)).to(dev)
    lane_t, func_t = tabs[:len(lane_tab)], tabs[len(lane_tab):]
    hdr = [nb, n_live, 0 if idx is None else idx.data_ptr(),
           flags.data_ptr(), len(part_keys), len(keys), L,
           lane_t.data_ptr(), n_tiles, tile_hf.data_ptr(),
           tile_v.data_ptr(), pre_hf.data_ptr(), pre_v.data_ptr(),
           spos.data_ptr(), ppos.data_ptr(), epos.data_ptr(),
           pe.data_ptr(), len(funcs), func_t.data_ptr()]
    for d, nl in keys:
        hdr += [d.data_ptr(), nl.data_ptr(), int(d.is_floating_point())]
    hdr = np.asarray(hdr, dtype=np.int64)
    stream = torch.cuda.current_stream(dev)
    rc = _kernel()(hdr.ctypes.data, ctypes.c_void_p(stream.cuda_stream))
    from . import build
    build.check(rc, "window_scan_run")
    # the tables must outlive the launches: keep them on the stream
    tabs.record_stream(stream)
    return outs


def run(nb: int, n_live: int, idx, part_keys, order_keys, args, funcs,
        dev: torch.device):
    """Window functions over `nb` rows on `dev`.

    idx: int64 sorted order (partition keys, then order keys, live rows
    first; see sort_topk.sort_indices), or None for input order;
    part_keys / order_keys / args: (data, nulls) per column in INPUT
    order, int64 or float64 data and bool NULL flags; funcs: (name,
    argument index or None) per output, name in :data:`FUNC_CODES`.
    Returns (data, nulls) per function, `nb` rows in input order: int64
    (ranks, counts), float64 (percent_rank, cume_dist) or the argument's
    dtype (sum, min, max)."""
    if dev.type == "cpu":
        return window_plain(nb, n_live, idx, part_keys, order_keys, args,
                            funcs, dev)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    outs = _run_cuda(nb, n_live, idx, part_keys, order_keys, args, funcs,
                     dev)
    LAUNCHES[0] += 1
    return outs
