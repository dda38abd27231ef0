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

The kernel runs the window's lanes (a count per argument, a lane per
SUM / MIN / MAX combine, dense_rank's peer count) in :func:`lane_groups`,
one group unless its shared memory would pass :data:`SMEM_MAX`: per
group, one single-pass look-back scan over tiles of :data:`TILE` sorted
rows that finishes every row whose frame ends in its tile, and one tail
launch for the rows whose frame ends past it (:func:`launch_plan`).  Its
arguments go by value in one header (:func:`pack_header`), its scratch is
one workspace (:func:`workspace_layout`) and a status block per stream
that is never cleared (:func:`status_layout`): no host-to-device copy a
call.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .sort_topk import MAX_KEYS  # csrc WS_MAX_KEYS: K4's key limit

#: launches of the CUDA kernel (chip_smoke.py reads it to prove the path)
LAUNCHES = [0]

#: the functions, and their codes in csrc/window_scan.cu
FUNC_CODES = {"row_number": 0, "rank": 1, "dense_rank": 2,
              "percent_rank": 3, "cume_dist": 4, "count": 5, "sum": 6,
              "min": 6, "max": 6}


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

#: csrc/window_scan.cu: the sorted rows a tile holds, one lane group's
#: limits (arguments, lanes, functions, dynamic shared bytes), a tile's
#: record and status-record words, and the launch header's layout
TILE = 1024
MAX_ARGS, MAX_LANES, MAX_FUNCS = 8, 16, 24
SMEM_MAX = 96 * 1024
REC, REC_W = 6, 2 + MAX_LANES
HDR_KEYS = 24
HDR_GROUPS = HDR_KEYS + 2 * MAX_KEYS
HDR_GROUP = 8 + 2 * MAX_ARGS + 5 * MAX_LANES + 4 * MAX_FUNCS

#: lane combines and value sources (csrc/window_scan.cu)
_ADD_I, _ADD_F, _MIN_I, _MAX_I, _MIN_F, _MAX_F = range(6)
_VALID, _PEER, _ARG = range(3)
_VALUE_OPS = {"sum": (_ADD_I, _ADD_F), "min": (_MIN_I, _MIN_F),
              "max": (_MAX_I, _MAX_F)}
_NEED_PE = ("count", "sum", "min", "max", "cume_dist")
_NEED_EP = ("percent_rank", "cume_dist")


def _column_class(name) -> int:
    """A function's place among its group's output columns: SUM / MIN /
    MAX first (the only ones with NULL flags, so theirs are consecutive),
    then what the scan finishes where the row is, COUNT at the peer
    group's end, and percent_rank / cume_dist at the partition's end
    (the tail kernel writes those for most rows of a big partition)."""
    return (0 if name in _VALUE_OPS else 2 if name == "count"
            else 3 if name in _NEED_EP else 1)


class LaneGroup:
    """One pass of the kernel: the arguments it gathers (indices into the
    call's `args`), its lanes ``(op, src, arg)`` (a count or dense_rank's
    peer count: 2 shared bytes a tile row; a SUM / MIN / MAX: 8), and its
    functions ``(index in funcs, code, count lane, value lane)`` (lane
    indices of the group, -1 for none), in the order of their output
    columns."""

    __slots__ = ("args", "lanes", "funcs", "names")

    def __init__(self):
        self.args, self.lanes, self.funcs, self.names = [], [], [], []

    @staticmethod
    def smem_of(lanes) -> int:
        n_val = sum(1 for _op, src, _a in lanes if src == _ARG)
        return TILE * (8 * n_val + 2 * (len(lanes) - n_val))

    @property
    def smem(self) -> int:
        return self.smem_of(self.lanes)

    @property
    def n_val(self) -> int:
        return sum(1 for _op, src, _a in self.lanes if src == _ARG)

    @property
    def need_pe(self) -> bool:
        return any(n in _NEED_PE for n in self.names)

    @property
    def need_ep(self) -> bool:
        return any(n in _NEED_EP for n in self.names)

    def slot(self, lane: int) -> int:
        """The lane's index among the group's lanes of its width."""
        wide = self.lanes[lane][1] == _ARG
        return sum(1 for _op, src, _a in self.lanes[:lane]
                   if (src == _ARG) == wide)

    def fits(self, need) -> bool:
        if len(self.funcs) >= MAX_FUNCS:
            return False
        lanes = self.lanes + [ln for ln in need if ln not in self.lanes]
        args = set(self.args) | {a for _o, _s, a in need if a is not None}
        return (len(lanes) <= MAX_LANES and len(args) <= MAX_ARGS
                and self.smem_of(lanes) <= SMEM_MAX)

    def add(self, fi, name, need):
        for ln in need:
            if ln not in self.lanes:
                self.lanes.append(ln)
            if ln[2] is not None and ln[2] not in self.args:
                self.args.append(ln[2])
        ix = [self.lanes.index(ln) for ln in need]
        cnt = ix[0] if name in ("count", "sum", "min", "max") else -1
        val = (ix[0] if name == "dense_rank" else
               ix[1] if name in _VALUE_OPS else -1)
        self.funcs.append((fi, FUNC_CODES[name], cnt, val))
        self.names.append(name)


def lane_groups(funcs, arg_float) -> list:
    """The call's lane groups, functions in order: each function joins the
    first group that has room for it and the lanes it reads (a count lane
    per argument, which also gives a SUM / MIN / MAX its NULLs, and one
    lane per distinct combine of an argument), else opens one.  A window
    runs in one group unless its lanes pass :data:`SMEM_MAX` shared bytes
    a block, :data:`MAX_LANES`, :data:`MAX_ARGS` or :data:`MAX_FUNCS`.
    arg_float: per argument, whether it is float64."""
    groups = []
    for fi, (name, a) in enumerate(funcs):
        need = []
        if name == "dense_rank":
            need = [(_ADD_I, _PEER, None)]
        elif name in ("count", "sum", "min", "max"):
            need = [(_ADD_I, _VALID, a)]
            if name != "count":
                need.append((_VALUE_OPS[name][int(bool(arg_float[a]))],
                             _ARG, a))
        for g in groups:
            if g.fits(need):
                break
        else:
            g = LaneGroup()
            groups.append(g)
        g.add(fi, name, need)
    for g in groups:  # the order of their output columns
        order = sorted(range(len(g.funcs)),
                       key=lambda k: _column_class(g.names[k]))
        g.funcs = [g.funcs[k] for k in order]
        g.names = [g.names[k] for k in order]
    return groups


def output_layout(groups) -> dict:
    """Where the outputs live, row-major in input order.  ``col0``: each
    group's first int64 column, a multiple of 4 (a group's functions take
    consecutive columns, so the kernel stores four of a row's values as
    one 32-byte sector); ``n_data``: int64 columns a row, a multiple of 4,
    or 1 or 2 for a window of one group of that many functions (no
    padding where nothing shares a sector).  ``ncol``: per
    group, each function's column of NULL flags, or -1 where it is never
    NULL (every function but SUM / MIN / MAX: those share one all-zero
    array); ``n_null``: flag bytes a row (a power of two up to 32, else a
    multiple of 32, so a row's flags never straddle a sector; 0 without
    a SUM / MIN / MAX); ``zero``: whether any function is never NULL."""
    col0, ncol, c, nc, zero = [], [], 0, 0, False
    for g in groups:
        col0.append(c)
        c += -(-len(g.funcs) // 4) * 4
        cols = []
        for name in g.names:
            if name in _VALUE_OPS:
                cols.append(nc)
                nc += 1
            else:
                cols.append(-1)
                zero = True
        ncol.append(cols)
    n_null = (0 if nc == 0 else 1 << (nc - 1).bit_length() if nc <= 32
              else -(-nc // 32) * 32)
    n_data = max(c, 4)
    if len(groups) == 1 and len(groups[0].funcs) <= 2:
        n_data = len(groups[0].funcs)
    return {"col0": col0, "n_data": n_data, "ncol": ncol,
            "n_null": n_null, "zero": zero}


def lane_columns(groups) -> list:
    """Per group, each lane's column of the head / tail values (-1 for a
    dense_rank lane, which the tail kernel never reads), numbered across
    the groups; the count of columns is the largest plus one."""
    out, gid = [], 0
    for g in groups:
        cols = []
        for _op, src, _a in g.lanes:
            cols.append(-1 if src == _PEER else gid)
            gid += src != _PEER
        out.append(cols)
    return out


def launch_plan(nb: int, groups) -> dict:
    """The launches of one call: per group the scan over its tiles, and the
    tail kernel where a frame can end past its tile (more than one tile,
    and the group reads frame ends)."""
    n_tiles = -(-nb // TILE)
    tails = [n_tiles > 1 and (g.need_pe or g.need_ep) for g in groups]
    return {"n_tiles": n_tiles, "launches": len(groups) + sum(tails)}


def workspace_layout(nb: int, n_cols: int, need_ep: bool) -> tuple:
    """The regions of one call's workspace, in int64 words: {name: (offset,
    words)} and the total.  rec (a tile's record: its last peer group's
    and partition's starts in the tile and as positions, and the ends of
    both, written by the tile that holds them), head / tail (each kept
    lane at the end of the tile's first peer group and at its last row),
    wpp / wpe (a peer start and end a sorted row, for percent_rank and
    cume_dist rows whose partition ends past their tile)."""
    n_tiles = -(-nb // TILE)
    per_row = nb if need_ep and n_tiles > 1 else 0
    sizes = (("rec", n_tiles * REC), ("head", n_tiles * n_cols),
             ("tail", n_tiles * n_cols), ("wpp", per_row), ("wpe", per_row))
    regions, off = {}, 0
    for name, size in sizes:
        regions[name] = (off, size)
        off += -(-size // 32) * 32  # 256-byte boundaries
    return regions, off


def status_layout(tiles: int) -> dict:
    """The status block of `tiles` tiles, in int64 words: the ticket, a flag
    a tile, then the aggregate and inclusive records (:data:`REC_W`
    words a tile each)."""
    return {"ctr": 0, "flag": 1, "agg": 1 + tiles,
            "incl": 1 + tiles + tiles * REC_W,
            "words": 1 + tiles + 2 * tiles * REC_W}


class _Status:
    """The scan's status block on one stream, zeroed once when allocated
    and grown to the largest call.  Every pass takes a new epoch, which
    its flags carry, so no launch clears them (the scan's last ticket
    sets the counter back to 0); the lock keeps epochs in stream order
    across threads."""

    __slots__ = ("words", "tiles", "epoch")

    def __init__(self):
        self.words, self.tiles, self.epoch = None, 0, 0


_STATUS: dict = {}
_STATUS_LOCK = threading.Lock()


def pack_group(g: LaneGroup, args, col0: int, ncols) -> dict:
    """One group's part of :func:`pack_header`: per argument its data
    pointer (0 where only a count reads it: the kernel then reads its NULL
    flags alone) and NULL flags' pointer; per lane (op, src, argument
    index in the group, slot); per function (code, count lane, value
    lane, column of NULL flags or -1), its output column col0 + its place
    in the group."""
    reads = {a for _op, src, a in g.lanes if src == _ARG}
    return {
        "args": [(args[a][0].data_ptr() if a in reads else 0,
                  args[a][1].data_ptr()) for a in g.args],
        "lanes": [(op, src, 0 if a is None else g.args.index(a), g.slot(ln))
                  for ln, (op, src, a) in enumerate(g.lanes)],
        "funcs": [(code, cnt, val, nc)
                  for (_fi, code, cnt, val), nc in zip(g.funcs, ncols)],
        "n_val": g.n_val, "smem": g.smem, "col0": col0,
        "need_pe": int(g.need_pe), "need_ep": int(g.need_ep)}


def pack_header(nb, n_live, idx_ptr, keys, float_keys, n_part, packed,
                cols, status, epoch0, ws, outs) -> np.ndarray:
    """The int64 header csrc/window_scan.cu ``window_scan_run`` turns into
    each pass's by-value arguments.  keys: (data, nulls) pointers per key;
    float_keys: a bit per double key; cols:
    :func:`lane_columns`; status: the status block's (ctr, flag, agg,
    incl) pointers; ws: the workspace's (rec, head, tail, n_cols, wpp,
    wpe); outs: the output buffers' (data, nulls) pointers, their row
    strides and the all-zero array's pointer (:func:`output_layout`);
    packed: :func:`pack_group` per group."""
    hdr = np.zeros(HDR_GROUPS + len(packed) * HDR_GROUP, dtype=np.int64)
    n_tiles = -(-nb // TILE)
    hdr[:HDR_KEYS] = ([nb, n_live, idx_ptr, n_part, len(keys), float_keys,
                       n_tiles, len(packed)] + list(status) + [epoch0]
                      + list(ws) + list(outs))
    for k, (d, nl) in enumerate(keys):
        hdr[HDR_KEYS + 2 * k:HDR_KEYS + 2 * k + 2] = (d, nl)
    for g, (grp, gcols) in enumerate(zip(packed, cols)):
        h = HDR_GROUPS + g * HDR_GROUP
        hdr[h:h + 8] = (len(grp["args"]), len(grp["lanes"]), grp["n_val"],
                        len(grp["funcs"]), grp["need_pe"], grp["need_ep"],
                        grp["smem"], grp["col0"])
        ha = h + 8
        for k, ptrs in enumerate(grp["args"]):
            hdr[ha + 2 * k:ha + 2 * k + 2] = ptrs
        hl = ha + 2 * MAX_ARGS
        for ln, lane in enumerate(grp["lanes"]):
            hdr[hl + 5 * ln:hl + 5 * ln + 5] = lane + (gcols[ln],)
        hf = hl + 5 * MAX_LANES
        for fi, fn in enumerate(grp["funcs"]):
            hdr[hf + 4 * fi:hf + 4 * fi + 4] = fn
    return hdr


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


def _outputs(funcs, args, nb, dev, lay, groups):
    """Every function's (data, nulls) in :func:`output_layout`'s buffers:
    a column of the int64 rows (float64 where the function gives
    doubles); a column of the flag rows for a SUM / MIN / MAX, else the
    one all-zero array (the kernel clears it).  Returns the outputs and
    the three buffers (None where unused)."""
    out_i = torch.empty((nb, lay["n_data"]), dtype=torch.int64, device=dev)
    out_b = (torch.empty((nb, lay["n_null"]), dtype=torch.bool, device=dev)
             if lay["n_null"] else None)
    zero = (torch.empty(nb, dtype=torch.bool, device=dev) if lay["zero"]
            else None)
    outs = [None] * len(funcs)
    for g, c0, ncols in zip(groups, lay["col0"], lay["ncol"]):
        for k, ((fi, *_rest), nc) in enumerate(zip(g.funcs, ncols)):
            name, a = funcs[fi]
            fl = (name in ("percent_rank", "cume_dist")
                  or (name in _VALUE_OPS and args[a][0].is_floating_point()))
            d = out_i[:, c0 + k]
            outs[fi] = (d.view(torch.float64) if fl else d,
                        out_b[:, nc] if nc >= 0 else zero)
    return outs, out_i, out_b, zero


def _run_cuda(nb, n_live, idx, part_keys, order_keys, args, funcs, dev):
    from . import build
    keys = list(part_keys) + list(order_keys)
    if len(keys) > MAX_KEYS:  # device_window declines these first
        raise ValueError(f"window_scan: at most {MAX_KEYS} partition and "
                         "order keys")
    _check(idx, keys + list(args), nb, dev)
    if not funcs:
        return []
    groups = lane_groups(funcs, [d.is_floating_point() for d, _n in args])
    lay = output_layout(groups)
    outs, out_i, out_b, zero = _outputs(funcs, args, nb, dev, lay, groups)
    cols = lane_columns(groups)
    n_cols = sum(c >= 0 for gc in cols for c in gc)
    need_ep = any(g.need_ep for g in groups)
    regions, words = workspace_layout(nb, n_cols, need_ep)
    ws = torch.empty(max(words, 1), dtype=torch.int64, device=dev)
    base = ws.data_ptr()

    def region(name):
        off, size = regions[name]
        return base + 8 * off if size else 0

    packed = [pack_group(g, args, c0, nc)
              for g, c0, nc in zip(groups, lay["col0"], lay["ncol"])]
    float_keys = sum(1 << k for k, (d, _n) in enumerate(keys)
                     if d.is_floating_point())
    n_tiles = -(-nb // TILE)
    stream = torch.cuda.current_stream(dev)
    with _STATUS_LOCK:
        st = _STATUS.setdefault((dev, stream.cuda_stream), _Status())
        if st.tiles < n_tiles:
            st.tiles = max(n_tiles, 2 * st.tiles)
            st.words = torch.zeros(status_layout(st.tiles)["words"],
                                   dtype=torch.int64, device=dev)
        words = st.words.data_ptr()
        status = [words + 8 * off for k, off in
                  status_layout(st.tiles).items() if k != "words"]
        epoch0 = st.epoch + 1
        st.epoch += len(groups)
        hdr = pack_header(
            nb, n_live, 0 if idx is None else idx.data_ptr(),
            [(d.data_ptr(), nl.data_ptr()) for d, nl in keys], float_keys,
            len(part_keys), packed, cols, status, epoch0,
            [region("rec"), region("head"), region("tail"), n_cols,
             region("wpp"), region("wpe")],
            [out_i.data_ptr(), 0 if out_b is None else out_b.data_ptr(),
             lay["n_data"], lay["n_null"],
             0 if zero is None else zero.data_ptr()])
        rc = build.launch(dev, _kernel(), hdr.ctypes.data,
                          ctypes.c_void_p(stream.cuda_stream))
    build.check(rc, "window_scan_run")
    LAUNCHES[0] += 1
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
    return _run_cuda(nb, n_live, idx, part_keys, order_keys, args, funcs,
                     dev)
