"""K7: the standalone join match — every (probe, build) row pair whose
int64 keys are equal, NULL keys on either side matching nothing.

Replaces ``tidb_tpu/ops/device.py:1473 _join_count_impl``, ``:1487
_join_expand_impl`` and ``:1506 device_join_match`` (an argsort of the
build keys, two searchsorted passes and a searchsorted of every output
slot).  The pairs are the reference's, order included: probe-major, each
probe row's build rows in row order (the keys being equal, in (key, row)
order), every int64 key accepted.

:func:`match` indexes the build side on the card in the layout
``executor/join_index.py`` (K6) picks on the host — a dense table while
the valid keys' span is at most :func:`dense_limit`, sorted keys
otherwise — from one device summary of the build side (the valid keys'
min, max and count, and on a dense layout the largest number of rows
under one key, capped at :data:`RANK_MAX` + 1), read once a call:

* a dense build whose keys are unique (``csrc/join_match.cu`` stages
  ``index`` and ``uniq``): one launch probes every row and writes the
  pairs, compacted in probe order; the total is read once after it;
* a dense build with a key of several rows, none of more than
  :data:`RANK_MAX`: the CSR starts by a look-back scan of the table
  (stage ``order``), the rows ranked into row order within each key, then
  K5a's dense count and K5b's expansion;
* a sorted build (a span too wide for a dense table, or a key of more
  than :data:`RANK_MAX` rows): K4's valid-first order, K5a's sorted count
  through it and K5b's expansion, as the reference's two passes.

Every path returns the pairs as two int64 tensors on the card; nothing is
copied back but by the caller.  :func:`match_plain` makes the same
choices in plain torch ops for CPU tensors.  Bound on the card: memory
(see the source note).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

#: calls of the CUDA launcher, and by stage (chip_smoke.py reads them to
#: prove the path)
LAUNCHES = [0]
STAGE_LAUNCHES = {"index": [0], "uniq": [0], "order": [0]}
STAGES = {"index": 0, "uniq": 1, "order": 2}

#: the largest number of rows under one key for which the dense index
#: orders each key's rows by ranking them among their key's (c reads a row
#: for a key of c rows); a hotter key sends the build to the sorted layout
RANK_MAX = 32

#: csrc/join_match.cu: rows a scan tile, the summary's most blocks, and
#: the summary's words
TILE = 8192
MAX_BLOCKS = 132 * 8
SUMMARY = ("min", "max", "nvalid", "maxmult", "total", "dense")
_S_TOTAL = SUMMARY.index("total")

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)

_FN = [None]


def dense_limit(nb: int) -> int:
    """The widest key span K6 indexes densely for a build of `nb` rows
    (``executor/join_index.py _DENSE_SLACK`` and ``_DENSE_FLOOR``)."""
    from ...executor.join_index import _DENSE_FLOOR, _DENSE_SLACK
    return max(_DENSE_SLACK * nb, _DENSE_FLOOR)


def _empty(dev):
    z = torch.zeros(0, dtype=torch.int64, device=dev)
    return z, z


# -- the plain version ------------------------------------------------------------

def summary_plain(bk, bn, limit: int) -> dict:
    """The device summary's fields (``SUMMARY``, but the total), as the
    card's ``index`` stage leaves them: ``maxmult``, the largest count
    under one key, is capped at ``RANK_MAX + 1`` (past it no path reads a
    count)."""
    valid = ~bn
    kv = bk[valid]
    nv = int(kv.shape[0])
    if nv == 0:
        return dict(min=_I64_MAX, max=_I64_MIN, nvalid=0, maxmult=0,
                    dense=0)
    mn, mx = int(kv.min()), int(kv.max())
    dense = int(mx - mn < limit)
    maxmult = 0
    if dense:
        maxmult = min(int(torch.bincount(kv - mn).max()), RANK_MAX + 1)
    return dict(min=mn, max=mx, nvalid=nv, maxmult=maxmult, dense=dense)


def match_plain(bk, bn, pk, pv, info=None):
    """:func:`match`'s layouts and paths in plain torch ops, on tensors of
    any device (no kernel of this repository runs)."""
    from . import join_expand, join_probe, sort_topk
    dev = bk.device
    s = summary_plain(bk, bn, dense_limit(bk.shape[0]))
    path = _path(s)
    if info is not None:
        info.update(s, path=path)
    if path == "empty" or pk.shape[0] == 0:
        return _empty(dev)
    nv, mn = s["nvalid"], s["min"]
    if path == "sorted":
        n = bk.shape[0]
        rows = sort_topk.sort_plain([bk], [bn], [False], [False], n, n)
        pr = join_probe.probe_plain([pk], [None], pv, None, bk, None, nv,
                                    "sorted", "count", order=rows)
    else:
        span = s["max"] - mn + 1
        valid = ~bn
        row_ids = torch.nonzero(valid).flatten()
        k = bk[valid] - mn
        if path == "uniq":
            v = pk - mn
            hit = pv & (v >= 0) & (v < span)
            slot = torch.full((span,), -1, dtype=torch.int64, device=dev)
            slot[k] = row_ids
            bi = slot[v.clamp(0, span - 1)]
            hit &= bi >= 0
            return torch.nonzero(hit).flatten(), bi[hit]
        counts = torch.bincount(k, minlength=span)
        starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(counts, 0)]).to(torch.int32)
        rows = row_ids[torch.argsort(k, stable=True)].to(torch.int32)
        pr = join_probe.probe_plain([pk], [None], pv, [(mn, span)], starts,
                                    rows, nv, "dense", "count",
                                    dense_span=span)
    total = int(pr["count"])
    if total == 0:
        return _empty(dev)
    ex = join_expand.expand_plain(pr["cnt"], pr["pos0"], None, rows, nv,
                                  None, total)
    return ex["pi"], ex["bi"]


def _path(s) -> str:
    """The path a summary sends the match down: "empty", "uniq" (dense,
    unique), "rank" (dense, each key's rows ranked among their key's) or
    "sorted" (a sparse span, or a key of more than RANK_MAX rows)."""
    if not s["nvalid"]:
        return "empty"
    if not s["dense"] or s["maxmult"] > RANK_MAX:
        return "sorted"
    return "uniq" if s["maxmult"] == 1 else "rank"


# -- the kernel -------------------------------------------------------------------

class _Status:
    """The launcher's status block on one stream: the scan's tile ticket,
    the summary's ticket and partials, then per tile the look-back's
    flag, aggregate and inclusive prefix (int64 words), zeroed once when
    allocated and grown to the largest call.  Every scan takes a new
    epoch, which its status words carry, so no launch clears them; the
    lock keeps epochs in stream order across threads."""

    __slots__ = ("words", "tiles", "epoch")

    def __init__(self):
        self.words, self.tiles, self.epoch = None, 0, 0


_STATUS: dict = {}
_STATUS_LOCK = threading.Lock()


def _kernel():
    if _FN[0] is None:
        from . import build
        _FN[0] = build.declare("join_match_run", 2)
    return _FN[0]


def _launch(stage, dev, tiles, args):
    """One call of ``join_match_run``; `args` maps the header's names to
    ints (0 where absent)."""
    from . import build
    stream = torch.cuda.current_stream(dev)
    with _STATUS_LOCK:
        st = _STATUS.setdefault((dev, stream.cuda_stream), _Status())
        if st.words is None or st.tiles < tiles:
            st.tiles = max(tiles, 2 * st.tiles, 1)
            st.words = torch.zeros(2 + 3 * MAX_BLOCKS + 3 * st.tiles,
                                   dtype=torch.int64, device=dev)
        if stage != "index":
            st.epoch += 1
        names = ("nb", "np", "bk", "bn", "pk", "pv", "sum", "limit", "tab")
        hdr = ([STAGES[stage]] + [args.get(k, 0) for k in names]
               + [st.words.data_ptr(), st.tiles, st.epoch]
               + [args.get(k, 0) for k in ("pi", "bi", "starts", "tmp",
                                           "rows", "span", "cap")])
        hdr = np.asarray(hdr, dtype=np.int64)
        rc = build.launch(dev, _kernel(), hdr.ctypes.data,
                          ctypes.c_void_p(stream.cuda_stream))
    build.check(rc, "join_match_run")
    LAUNCHES[0] += 1
    STAGE_LAUNCHES[stage][0] += 1


def _check(bk, bn, pk, pv):
    dev = bk.device
    for t, dt, what in ((bk, torch.int64, "build keys"),
                        (bn, torch.bool, "build NULL flags"),
                        (pk, torch.int64, "probe keys"),
                        (pv, torch.bool, "probe validity")):
        if t.device != dev:
            raise ValueError("join_match: tensors on different devices")
        if t.dtype != dt:
            raise TypeError(f"join_match: {what} must be {dt}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("join_match: inputs must be contiguous 1-d")
    if bn.shape[0] != bk.shape[0] or pv.shape[0] != pk.shape[0]:
        raise ValueError("join_match: keys and flags differ in length")
    if bk.shape[0] >= 1 << 31:
        from ..device import DeviceUnsupported
        raise DeviceUnsupported("join_match: a build side of 2^31 rows or "
                                "more")


def _match_cuda(bk, bn, pk, pv, info):
    from . import join_expand, join_probe, sort_topk
    _check(bk, bn, pk, pv)
    dev = bk.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    nb, np_ = bk.shape[0], pk.shape[0]
    if nb == 0 or np_ == 0:
        if info is not None:
            info.update(path="empty")
        return _empty(dev)
    limit = dense_limit(nb)
    summ = torch.empty(8, dtype=torch.int64, device=dev)
    # 8 bytes a word, 4 words a build row past the floor; the index stage
    # zeroes only the span's words, and the table is let go before K4 or
    # K5a allocates
    tab = torch.empty(limit + 1, dtype=torch.int64, device=dev)
    base = dict(nb=nb, np=np_, bk=bk.data_ptr(), bn=bn.data_ptr(),
                pk=pk.data_ptr(), pv=pv.data_ptr(), sum=summ.data_ptr(),
                limit=limit, tab=tab.data_ptr(), cap=RANK_MAX)
    _launch("index", dev, 0, base)
    s = dict(zip(SUMMARY, summ[:len(SUMMARY)].tolist()))  # the one read
    path = _path(s)
    if info is not None:
        info.update(s, path=path)
    if path == "empty":
        return _empty(dev)
    nv, mn = s["nvalid"], s["min"]
    span = s["max"] - mn + 1 if s["dense"] else 0
    if path == "uniq":
        out = torch.empty((2, np_), dtype=torch.int64, device=dev)
        _launch("uniq", dev, -(-np_ // TILE),
                dict(base, pi=out[0].data_ptr(), bi=out[1].data_ptr(),
                     span=span))
        total = int(summ[_S_TOTAL])
        return out[0, :total], out[1, :total]
    if path == "sorted":
        del tab
        rows = sort_topk.valid_first_order(bk, bn)
        pr = join_probe.probe([pk], [None], pv, None, bk, None, nv,
                              layout="sorted", mode="count", order=rows)
    else:
        starts = torch.empty(span + 1, dtype=torch.int32, device=dev)
        tmp, rows = torch.empty((2, nv), dtype=torch.int32,
                                device=dev).unbind(0)
        _launch("order", dev, -(-(span + 1) // TILE),
                dict(base, starts=starts.data_ptr(), span=span,
                     tmp=tmp.data_ptr(), rows=rows.data_ptr()))
        del tab
        pr = join_probe.probe([pk], [None], pv, [(mn, span)], starts, rows,
                              nv, layout="dense", mode="count",
                              dense_span=span)
    total = int(pr["count"])
    if total == 0:
        return _empty(dev)
    ex = join_expand.expand(pr["cnt"], pr["pos0"], None, rows, nv, None,
                            total)
    return ex["pi"], ex["bi"]


def match(bk, bn, pk, pv, info=None):
    """Every pair of rows with equal keys (see the module note).

    bk / bn: the build side's int64 keys and bool NULL flags; pk / pv:
    the probe side's int64 keys and bool validity (a row that is not
    valid matches nothing).  Returns (pi, bi), int64 tensors of the probe
    and build rows of each pair, probe-major, each probe row's build rows
    in row order.  `info`, a dict, gets the summary (``SUMMARY`` but the
    total) and the path taken (:func:`_path`)."""
    if bk.device.type == "cpu":
        return match_plain(bk, bn, pk, pv, info)
    return _match_cuda(bk, bn, pk, pv, info)
