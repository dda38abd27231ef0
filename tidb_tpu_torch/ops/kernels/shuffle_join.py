"""Kernel B of the MPP shuffle join (K11): the local sort join's sum.

Replaces ``tidb_tpu/parallel/mpp.py:325-342`` (``dist_join_agg_step``'s
``csum`` / ``ccnt`` prefix sums, the two ``searchsorted`` and ``Σ pv *
match_sum``).  K4 gives the build side's valid-first key order and K5a's
sorted probe in count mode each probe row's match range ``[pos0, pos0 +
cnt)`` inside the valid prefix; :func:`join_sum` adds, over the valid
probe rows, ``pv * (csum[pos0 + cnt] - csum[pos0])`` with ``csum`` the
prefix sums of the build values in that order (leading zero), and the
pair count ``Σ cnt``.

int64 values are exact (wrapping as int64 does).  With a float64 side the
total is float64 (jnp's promotion); it differs from the reference's
``jnp.cumsum`` + ``jnp.sum`` + ``psum`` in summation order only, within
rtol 1e-9 / atol 1e-12.

:func:`join_sum` launches ``csrc/shuffle_join.cu`` for CUDA tensors and
runs :func:`join_sum_plain` for CPU tensors: one launch whose first
blocks scan tiles of :data:`TILE` sorted positions by look-back and whose
other blocks sum the probe rows once the scan is done
(:func:`launch_plan`).  Its scratch (counters, status words, partials and
``csum``) is one workspace per device and stream that no call clears
(each call takes a new epoch; :func:`workspace_layout`).  Float totals
repeat bit for bit.  Bound on the card: memory (see the source note).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

#: launches of the CUDA kernel (chip_smoke.py reads it to prove the path)
LAUNCHES = [0]

#: csrc/shuffle_join.cu: SJ_TILE (the sorted positions a scan block
#: takes), SJ_THREADS and SJ_MAX_BLOCKS (the probe blocks of a call at
#: most)
TILE = 4096
THREADS = 256
MAX_BLOCKS = 132 * 8

_FN = [None]


def launch_plan(n: int, np_: int) -> dict:
    """One call's launch: ``n_tiles`` scan blocks over the `n` sorted
    positions, then ``n_probe`` probe blocks over the `np_` probe rows
    (one a :data:`THREADS` rows, at least one, at most
    :data:`MAX_BLOCKS`: the grid-stride order, and so the float total,
    depends on `np_` alone)."""
    n_tiles = -(-n // TILE)
    n_probe = max(1, min(MAX_BLOCKS, -(-np_ // THREADS)))
    return {"n_tiles": n_tiles, "n_probe": n_probe,
            "blocks": n_tiles + n_probe, "launches": 1}


def workspace_layout(n: int) -> dict:
    """The workspace for up to `n` sorted positions, in int64 words: three
    counters (ticket, tiles done, probe blocks done), per tile a flag, an
    aggregate and an inclusive prefix, the probe blocks' partial totals
    and pairs, and ``csum`` (n + 1)."""
    tiles = -(-n // TILE)
    lay = {"ctr": 0, "flag": 4, "agg": 4 + tiles, "incl": 4 + 2 * tiles,
           "part_total": 4 + 3 * tiles,
           "part_pairs": 4 + 3 * tiles + MAX_BLOCKS,
           "csum": 4 + 3 * tiles + 2 * MAX_BLOCKS}
    lay["words"] = lay["csum"] + n + 1
    return lay


class _Workspace:
    """The kernel's workspace on one stream, zeroed once when allocated
    and grown to the largest call.  Every call takes a new epoch, which
    its flags carry, so no launch clears them (the kernel sets its
    counters back to 0); the lock keeps epochs in stream order across
    threads."""

    __slots__ = ("words", "n", "epoch")

    def __init__(self):
        self.words, self.n, self.epoch = None, -1, 0

    def take(self, n: int, dev) -> tuple:
        """(word pointers by :func:`workspace_layout`'s names, epoch) of
        the next call, for `n` sorted positions."""
        if n > self.n:
            self.n = max(n, 2 * self.n)
            self.words = torch.zeros(workspace_layout(self.n)["words"],
                                     dtype=torch.int64, device=dev)
        self.epoch += 1
        base = self.words.data_ptr()
        ptrs = {k: base + 8 * off
                for k, off in workspace_layout(self.n).items()
                if k != "words"}
        return ptrs, self.epoch


_WS: dict = {}
_WS_LOCK = threading.Lock()


def pack_header(n, bv, bv_f, order, np_, pos0, cnt, pv, pv_f, pvalid,
                out_f, plan, epoch, ws, res) -> np.ndarray:
    """``shuffle_join_run``'s header (pointers as ints, 0 for None):
    [n, bv, bv_f, order, np, pos0, cnt, pv, pv_f, pvalid, out_f, n_tiles,
    n_probe, epoch, ctr, flag, agg, incl, part_total, part_pairs, csum,
    res]; `ws` maps :func:`workspace_layout`'s names to pointers."""
    return np.asarray(
        [n, bv, bv_f, order, np_, pos0, cnt, pv, pv_f, pvalid, out_f,
         plan["n_tiles"], plan["n_probe"], epoch, ws["ctr"], ws["flag"],
         ws["agg"], ws["incl"], ws["part_total"], ws["part_pairs"],
         ws["csum"], res], dtype=np.int64)


def _out_dtype(bv, pv):
    return (torch.float64 if bv.is_floating_point() or pv.is_floating_point()
            else torch.int64)


def join_sum_plain(bv, order, pos0, cnt, pv, pvalid=None):
    """The sum in torch ops (cumsum + gathers)."""
    dev = pos0.device
    sv = bv[order] if order is not None else bv
    csum = torch.cat([torch.zeros(1, dtype=bv.dtype, device=dev),
                      torch.cumsum(sv, 0)])
    ms = csum[pos0 + cnt] - csum[pos0]
    ok = cnt > 0
    if pvalid is not None:
        ok &= pvalid
    out = _out_dtype(bv, pv)
    prod = torch.where(ok, pv.to(out) * ms.to(out),
                       torch.zeros((), dtype=out, device=dev))
    pairs = torch.where(ok, cnt, 0).sum()
    return prod.sum(), pairs


def join_sum(bv, order, pos0, cnt, pv, pvalid=None):
    """(total, pairs), 0-d tensors on the probe rows' device.

    bv: build values (int64 or float64) read at ``order[m]`` for sorted
    position m (order None: bv is in key order already); pos0 / cnt: each
    probe row's match range in sorted positions (int64, from K5a); pv: the
    probe values (int64 or float64); pvalid: bool or None (every row)."""
    if pos0.device.type == "cpu":
        return join_sum_plain(bv, order, pos0, cnt, pv, pvalid)
    dev = pos0.device
    np_ = pos0.shape[0]
    n = order.shape[0] if order is not None else bv.shape[0]
    for t in (bv, order, pos0, cnt, pv, pvalid):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError("shuffle_join: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("shuffle_join: tensors must be contiguous")
    for t, what in ((bv, "build values"), (pv, "probe values")):
        if t.dtype not in (torch.int64, torch.float64):
            raise TypeError(f"shuffle_join: {what} must be int64 or "
                            "float64")
    for t, what in ((order, "order"), (pos0, "pos0"), (cnt, "cnt")):
        if t is not None and t.dtype != torch.int64:
            raise TypeError(f"shuffle_join: {what} must be int64")
    if pvalid is not None and pvalid.dtype != torch.bool:
        raise TypeError("shuffle_join: pvalid must be bool")
    for t in (cnt, pv, pvalid):
        if t is not None and t.shape[0] != np_:
            raise ValueError("shuffle_join: probe arrays differ in length")
    if order is not None and bv.shape[0] < n:
        raise ValueError("shuffle_join: order longer than the build values")
    out = _out_dtype(bv, pv)
    res = torch.empty(2, dtype=torch.int64, device=dev)
    plan = launch_plan(n, np_)
    from . import build
    if _FN[0] is None:
        _FN[0] = build.declare("shuffle_join_run", 2)
    stream = build.raw_stream(dev)
    with _WS_LOCK:
        ws = _WS.get((dev, stream))
        if ws is None:
            ws = _WS[(dev, stream)] = _Workspace()
        ptrs, epoch = ws.take(n, dev)
        hdr = pack_header(
            n, bv.data_ptr(), int(bv.is_floating_point()),
            0 if order is None else order.data_ptr(), np_, pos0.data_ptr(),
            cnt.data_ptr(), pv.data_ptr(), int(pv.is_floating_point()),
            0 if pvalid is None else pvalid.data_ptr(),
            int(out == torch.float64), plan, epoch, ptrs, res.data_ptr())
        rc = _FN[0](hdr.ctypes.data, ctypes.c_void_p(stream))
    build.check(rc, "shuffle_join_run")
    LAUNCHES[0] += 1
    total = (res[:1].view(torch.float64)[0] if out == torch.float64
             else res[0])
    return total, res[1]
