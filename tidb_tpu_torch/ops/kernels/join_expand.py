"""K5b: the CSR expansion of the join → aggregate fragment, its post-join
compaction, and the expand pass of the standalone join match (K7).

Replaces ``tidb_tpu/executor/device_join.py:519 _join_expand`` (cumsum,
searchsorted of each output slot, within-row offset), the CSR block of
``compile_fragment.run`` (``:810-842``) and its compaction (``:893-903``),
and ``tidb_tpu/ops/device.py:1487 _join_expand_impl``.

:func:`expand` — for probe rows with match counts ``cnt`` and CSR starts
``pos0`` into the row ids ``a1``: the exact ``total`` of the expansion
(also when it exceeds ``cap``) and, for each of ``cap`` output slots,
the probe row ``pi``, the build row ``bi``, ``valid`` by the inner or
left formula, the left join's no-match map ``nohit``, and the probe
side's index and null maps gathered at ``pi`` and the build side's at
``bi``.  Slots are probe-major, each probe row's build rows in index
order.  Slots past ``total`` hold ``pi = bi = 0``, ``valid = False``,
``nohit = True`` and the maps' entry 0.

:func:`compact` — the same scan over a 0/1 mask: the kept rows' indices
to the front, maps gathered; :func:`count` — only the exact total.

Each launches ``csrc/join_expand.cu`` for CUDA tensors and runs
:func:`expand_plain` for CPU tensors.  Bound on the card: memory (see the
source note).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

#: launches of the CUDA kernel (chip_smoke.py reads it to prove the path)
LAUNCHES = [0]

#: csrc/join_expand.cu: JE_MAX_MAPS, the rows a scan tile takes, the
#: slots an expansion tile writes, and the most blocks of the expansion's
#: grid-stride loop
MAX_MAPS = 16
TILE = 8192
SLOT_TILE = 1024
EXPAND_BLOCKS = 132 * 8

_FN = [None]


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def launch_plan(n: int, cap: int, count_only: bool = False) -> dict:
    """The launches of one call, as ``join_expand_run`` makes them: the
    scan's blocks (one a tile of :data:`TILE` rows, at least one, which
    writes a total of 0 for no rows), and unless the call only counts or
    has no slots, the expansion's blocks over tiles of :data:`SLOT_TILE`
    slots."""
    scan_tiles = -(-n // TILE)
    plan = {"scan_tiles": scan_tiles, "scan_blocks": max(scan_tiles, 1),
            "slot_tiles": 0, "expand_blocks": 0, "launches": 1}
    if not count_only and cap > 0:
        slot_tiles = -(-cap // SLOT_TILE)
        plan.update(slot_tiles=slot_tiles,
                    expand_blocks=min(slot_tiles, EXPAND_BLOCKS),
                    launches=2)
    return plan


class _Status:
    """The scan's status block on one stream: a tile counter, then per
    tile a flag, the aggregate and the inclusive prefix (int64 words),
    zeroed once when allocated and grown to the largest call.  Every call
    takes a new epoch, which its status words carry, so no launch clears
    them (the scan's last tile sets the counter back to 0); the lock keeps
    epochs in stream order across threads."""

    __slots__ = ("words", "tiles", "epoch")

    def __init__(self):
        self.words, self.tiles, self.epoch = None, 0, 0


_STATUS: dict = {}
_STATUS_LOCK = threading.Lock()


def expand_plain(cnt, pos0, pvalid, a1, nv, bvalid, cap, left=False,
                 probe_maps=(), build_maps=(), cmask=None):
    """The kernel's contract in torch ops (cumsum + searchsorted)."""
    build = cmask is None
    c_in = cnt if build else cmask.to(torch.int64)
    dev = c_in.device
    n = c_in.shape[0]
    i64 = torch.int64
    pv = (pvalid if pvalid is not None
          else torch.ones(n, dtype=torch.bool, device=dev))
    if left:
        eff = torch.where(pv, c_in.clamp(min=1), 0)
    else:
        eff = c_in
    cum = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                     torch.cumsum(eff, 0)])
    total = cum[-1]
    slots = torch.arange(cap, dtype=i64, device=dev)
    live = slots < total
    if n:
        pi = (torch.searchsorted(cum, slots, right=True) - 1).clamp(0, n - 1)
    else:
        pi = torch.zeros(cap, dtype=i64, device=dev)
    pi = torch.where(live, pi, 0)
    out = {"total": total, "pi": pi}
    if build:
        nv = int(nv)
        within = slots - cum[pi]
        c = cnt[pi] if n else torch.zeros(cap, dtype=i64, device=dev)
        bpos = (pos0[pi] if n else c) + torch.minimum(within,
                                                      (c - 1).clamp(min=0))
        bi = a1[bpos.clamp(0, max(nv - 1, 0))].to(i64)
        bi = torch.where(live, bi, 0)
        h = within < c
        if bvalid is not None:
            h = h & bvalid[bi]
        h = h & live
        pvi = pv[pi] if n else torch.zeros(cap, dtype=torch.bool,
                                           device=dev)
        out["bi"] = bi
        out["valid"] = live & (pvi if left else (h & pvi))
        out["nohit"] = ~h
    else:
        bi = pi
        out["valid"] = live
    out["maps"] = [m[pi] for m in probe_maps] + [m[bi] for m in build_maps]
    return out


def _kernel():
    if _FN[0] is None:
        from . import build
        _FN[0] = build.declare("join_expand_run", 2)
    return _FN[0]


def _run_cuda(cnt, cmask, pos0, pvalid, a1, nv, bvalid, cap, left,
              probe_maps, build_maps, count_only):
    from . import build
    src = cnt if cnt is not None else cmask
    dev = src.device
    n = src.shape[0]
    for t in (cnt, cmask, pos0, pvalid, a1, bvalid, *probe_maps,
              *build_maps):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError("join_expand: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("join_expand: tensors must be contiguous")
    if cnt is not None and cnt.dtype != torch.int64:
        raise TypeError("join_expand: counts must be int64")
    for t in (cmask, pvalid, bvalid):
        if t is not None and t.dtype != torch.bool:
            raise TypeError("join_expand: masks must be bool")
    if pos0 is not None and pos0.dtype != torch.int64:
        raise TypeError("join_expand: CSR starts must be int64")
    if a1 is not None and a1.dtype not in (torch.int32, torch.int64):
        raise TypeError("join_expand: row ids must be int32 or int64")
    for t in (pos0, pvalid, *probe_maps):
        if t is not None and t.shape[0] != n:
            raise ValueError("join_expand: probe-side arrays differ in "
                             "length")
    if a1 is not None and a1.shape[0] < max(int(nv or 0), 1):
        raise ValueError("join_expand: fewer row ids than n_valid")
    maps = [(m, 0) for m in probe_maps] + [(m, 1) for m in build_maps]
    if len(maps) > MAX_MAPS:
        from ..device import DeviceUnsupported
        raise DeviceUnsupported(f"join_expand: at most {MAX_MAPS} maps")
    for m, _side in maps:
        if m.dtype not in (torch.int64, torch.bool):
            raise TypeError("join_expand: maps must be int64 or bool")
    e = dict(device=dev)
    plan = launch_plan(n, cap, count_only)
    total = torch.empty(1, dtype=torch.int64, **e)
    build_side = cmask is None
    out = {"total": total[0]}
    hdr_out = [0, 0, 0, 0]
    dsts = []
    off = None
    if plan["launches"] == 2:
        off = torch.empty(n, dtype=torch.int64, **e)
        pi = torch.empty(cap, dtype=torch.int64, **e)
        valid = torch.empty(cap, dtype=torch.bool, **e)
        out["pi"], out["valid"] = pi, valid
        bi = nohit = None
        if build_side:
            bi = torch.empty(cap, dtype=torch.int64, **e)
            nohit = torch.empty(cap, dtype=torch.bool, **e)
            out["bi"], out["nohit"] = bi, nohit
        hdr_out = [_ptr(pi), _ptr(bi), _ptr(valid), _ptr(nohit)]
        dsts = [torch.empty(cap, dtype=m.dtype, **e) for m, _s in maps]
        out["maps"] = dsts
    elif not count_only:  # no slots
        out["pi"] = torch.empty(0, dtype=torch.int64, **e)
        out["valid"] = torch.empty(0, dtype=torch.bool, **e)
        if build_side:
            out["bi"] = torch.empty(0, dtype=torch.int64, **e)
            out["nohit"] = torch.empty(0, dtype=torch.bool, **e)
        out["maps"] = [torch.empty(0, dtype=m.dtype, **e) for m, _s in maps]
    stream = torch.cuda.current_stream(dev)
    with _STATUS_LOCK:
        st = _STATUS.setdefault((dev, stream.cuda_stream), _Status())
        need = max(plan["scan_tiles"], 1)
        if st.tiles < need:
            st.tiles = max(need, 2 * st.tiles)
            st.words = torch.zeros(1 + 3 * st.tiles, dtype=torch.int64, **e)
        st.epoch += 1
        hdr = [n, _ptr(cnt), _ptr(cmask), _ptr(pvalid), int(bool(left)),
               int(build_side), _ptr(pos0), _ptr(a1),
               int(a1 is not None and a1.dtype == torch.int64),
               int(nv or 0), _ptr(bvalid), int(cap), _ptr(off),
               total.data_ptr(), st.words.data_ptr(), st.tiles, st.epoch
               ] + hdr_out + [int(plan["launches"] == 1), len(dsts)]
        for (m, side), d in zip(maps, dsts):
            hdr += [m.data_ptr(), d.data_ptr(), side,
                    int(m.dtype == torch.bool)]
        hdr = np.asarray(hdr, dtype=np.int64)
        rc = build.launch(dev, _kernel(), hdr.ctypes.data,
                          ctypes.c_void_p(stream.cuda_stream))
    build.check(rc, "join_expand_run")
    LAUNCHES[0] += 1
    return out


def expand(cnt, pos0, pvalid, a1, nv, bvalid, cap, *, left=False,
           probe_maps=(), build_maps=()):
    """Expand probe rows into `cap` output slots (see the module note).

    cnt / pos0: int64 match counts and CSR starts per probe row; pvalid:
    the probe relation's validity (None: all valid); a1: the build row
    ids (int32 or int64) that ``pos0`` points into, clamped to
    ``[0, nv)``; bvalid: the build relation's validity (None: all valid);
    probe_maps / build_maps: int64 index maps or bool null maps over the
    probe / build relation, gathered into the output slots.  Returns a
    dict with ``total`` (0-d int64), ``pi``, ``bi``, ``valid``, ``nohit``
    and ``maps``."""
    if cnt.device.type == "cpu":
        return expand_plain(cnt, pos0, pvalid, a1, nv, bvalid, cap, left,
                            probe_maps, build_maps)
    return _run_cuda(cnt, None, pos0, pvalid, a1, nv, bvalid, cap, left,
                     probe_maps, build_maps, False)


def compact(mask, cap, maps=()):
    """Kept rows of `mask` to the front of `cap` slots: ``pi`` (the row of
    each slot), ``valid`` (slot < total), ``total`` and `maps` gathered at
    ``pi``."""
    if mask.device.type == "cpu":
        return expand_plain(None, None, None, None, 0, None, cap,
                            probe_maps=maps, cmask=mask)
    return _run_cuda(None, mask, None, None, None, 0, None, cap, False,
                     maps, (), False)


def count(mask):
    """The number of True entries of the bool `mask`, as a 0-d int64 on its
    device (one launch: the scan alone)."""
    if mask.device.type == "cpu":
        return mask.sum()
    return _run_cuda(None, mask, None, None, None, 0, None, 0, False, (), (),
                     True)["total"]
