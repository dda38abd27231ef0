"""K5a: the join probe of the join → aggregate fragment (and the count
pass of the standalone join match, K7).

Replaces ``tidb_tpu/executor/device_join.py:553 _combined_join_keys``,
``:598 _pack_probe``, the dense and sorted probe and the unique gather of
``compile_fragment.run`` (``:743-808``), and the searchsorted count pass
of ``tidb_tpu/ops/device.py:1473 _join_count_impl``.

Two wrappers, each launching one entry of ``csrc/join_probe.cu`` for
CUDA tensors and running its plain PyTorch version (``*_plain``) for CPU
tensors:

* :func:`key_range` — two relations' multi-column keys folded into one
  int64 per row by data-dependent range packing, with the float64
  span-overflow flag and the count of valid build rows;
* :func:`probe` — pack each probe row's key with the index's static
  ``(mn, span)`` and look it up in a dense CSR or a sorted key array;
  mode ``uniq`` gives the build row ``bi`` and the match flag ``hit`` of
  a unique build, ``count`` the CSR start ``pos0`` and match count
  ``cnt``, ``exists`` the semi/anti existence test; ``uniq`` and
  ``exists`` also give the join kind's probe-shaped ``valid`` rows, the
  left join's no-match map ``nohit`` and the count of valid rows.

:func:`finish_plain` gives ``valid`` / ``nohit`` / count from a match
flag that ON-clause residuals refined; on the card the expression VM's
launch that refines the flag writes them (``expr_vm.run``'s ``finish``).

Index arrays (CSR starts, row ids) are taken as int32 or int64, as
``executor/join_index.py`` builds them; keys and counts are int64,
flags bool.  Sorted lookups search ``[0, n_valid)`` only, so the int64.max
padding of the sorted keys is never compared against (a real key may
equal int64.max).  A row without a match (``cnt = 0``) has ``pos0 = 0``
and, in ``uniq`` mode, ``bi = 0``: rows that are invalid, NULL or out of
range are never looked up (the reference leaves both arbitrary).

Bound on the card: memory — each probe row's key columns, null flags and
validity read once, its outputs written once, and every index lookup a
random read of one 32-byte sector.  The sorted probe searches a sample of
:data:`SAMPLE` keys in shared memory first, then one segment in device
memory, and gallops to a count (``csrc/join_probe.cu``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: launches of the CUDA kernels (chip_smoke.py reads it to prove the path)
LAUNCHES = [0]

#: csrc/join_probe.cu JP_MAX_KEYS
MAX_KEYS = 8

#: sorted keys a block of the sorted probe stages in shared memory (8
#: bytes each), read at each call: chip_smoke.py times the candidates at
#: Q9's and the mesh's shapes, where 1024 tied 512 and 2048 and beat 4096
#: and 16384 (PERF.md §6)
SAMPLE = 1024

MODES = {"uniq": 0, "count": 1, "exists": 2}
KINDS = {"inner": 0, "left": 1, "semi": 2, "anti": 3}

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _check_keys(keys, what):
    if not 1 <= len(keys) <= MAX_KEYS:
        from ..device import DeviceUnsupported
        raise DeviceUnsupported(f"{what}: 1..{MAX_KEYS} key columns on the "
                                "device")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch(name, n_args, hdr, dev):
    from . import build
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = build.declare(name, n_args)
    stream = torch.cuda.current_stream(dev).cuda_stream
    hdr = np.asarray(hdr, dtype=np.int64)
    rc = build.launch(dev, fn, hdr.ctypes.data, ctypes.c_void_p(stream))
    build.check(rc, name)
    LAUNCHES[0] += 1


_FNS: dict = {}


def _cuda_checks(dev, tensors):
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError("join_probe: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("join_probe: tensors must be contiguous")


def _as_bool(t, what):
    if t is not None and t.dtype != torch.bool:
        raise TypeError(f"join_probe: {what} must be bool")
    return t


def _as_i64(t, what):
    if t.dtype != torch.int64:
        raise TypeError(f"join_probe: {what} must be int64")
    return t


def _index_dtype(t, what):
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"join_probe: {what} must be int32 or int64")
    return int(t.dtype == torch.int64)


# -- key range ----------------------------------------------------------------

def key_range_plain(lkeys, lnulls, lvalid, rkeys, rnulls, rvalid):
    pvalid, bvalid = lvalid, rvalid
    for nl in lnulls:
        pvalid = pvalid & ~nl
    for nl in rnulls:
        bvalid = bvalid & ~nl
    nbv = bvalid.sum()
    if len(lkeys) == 1:
        return (lkeys[0].to(torch.int64), pvalid, rkeys[0].to(torch.int64),
                bvalid, torch.zeros((), dtype=torch.bool,
                                    device=lvalid.device), nbv, ~bvalid)
    dev = lvalid.device
    pk = torch.zeros(lvalid.shape[0], dtype=torch.int64, device=dev)
    bk = torch.zeros(rvalid.shape[0], dtype=torch.int64, device=dev)
    total = 1.0
    for lk, rk in zip(lkeys, rkeys):
        lk = lk.to(torch.int64)
        rk = rk.to(torch.int64)
        big = torch.tensor(_I64_MAX, device=dev)
        small = torch.tensor(_I64_MIN, device=dev)
        mn = min(int(torch.where(pvalid, lk, big).min()) if len(lk) else
                 _I64_MAX,
                 int(torch.where(bvalid, rk, big).min()) if len(rk) else
                 _I64_MAX)
        mx = max(int(torch.where(pvalid, lk, small).max()) if len(lk) else
                 _I64_MIN,
                 int(torch.where(bvalid, rk, small).max()) if len(rk) else
                 _I64_MIN)
        mn = min(mn, mx)
        total *= max(float(mx) - float(mn) + 1.0, 1.0)
        span = max(_wrap(mx - mn + 1), 1)
        pk = pk * span + torch.where(pvalid, lk - mn, 0)
        bk = bk * span + torch.where(bvalid, rk - mn, 0)
    return (pk, pvalid, bk, bvalid,
            torch.tensor(total > 2.0 ** 62, device=dev), nbv, ~bvalid)


def _wrap(v: int) -> int:
    """A Python int as int64 arithmetic would leave it (two's complement)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def key_range(lkeys, lnulls, lvalid, rkeys, rnulls, rvalid):
    """``_combined_join_keys``: (pk, pvalid, bk, bvalid, span_ovf, nbv,
    binvalid) — each side's packed int64 key and validity (relation
    validity and no NULL key column), a 0-d bool set when the product of
    the key spans exceeds 2^62 (the caller falls back), the 0-d count of
    valid build rows, and ``~bvalid`` (the NULL flags of the build side's
    sort)."""
    _check_keys(lkeys, "key_range")
    if lvalid.device.type == "cpu":
        return key_range_plain(lkeys, lnulls, lvalid, rkeys, rnulls, rvalid)
    dev = lvalid.device
    k = len(lkeys)
    for t in list(lkeys) + list(rkeys):
        _as_i64(t, "join keys")
    for t in list(lnulls) + list(rnulls) + [lvalid, rvalid]:
        _as_bool(t, "null flags and validity")
    _cuda_checks(dev, list(lkeys) + list(rkeys) + list(lnulls)
                 + list(rnulls) + [lvalid, rvalid])
    np_, nb = lvalid.shape[0], rvalid.shape[0]
    for t in list(lkeys) + list(lnulls):
        if t.shape[0] != np_:
            raise ValueError("join_probe: probe columns differ in length")
    for t in list(rkeys) + list(rnulls):
        if t.shape[0] != nb:
            raise ValueError("join_probe: build columns differ in length")
    mm = torch.empty(2 * k, dtype=torch.int64, device=dev)
    pk = torch.empty(np_, dtype=torch.int64, device=dev)
    bk = torch.empty(nb, dtype=torch.int64, device=dev)
    pvo = torch.empty(np_, dtype=torch.bool, device=dev)
    bvo = torch.empty(nb, dtype=torch.bool, device=dev)
    bio = torch.empty(nb, dtype=torch.bool, device=dev)
    ovf = torch.empty(1, dtype=torch.bool, device=dev)
    nbv = torch.empty(1, dtype=torch.int64, device=dev)
    hdr = [k, np_, nb, _ptr(lvalid), _ptr(rvalid), _ptr(mm), _ptr(pk),
           _ptr(pvo), _ptr(bk), _ptr(bvo), _ptr(bio), _ptr(ovf),
           _ptr(nbv)]
    for c in range(k):
        hdr += [_ptr(lkeys[c]), _ptr(lnulls[c]), _ptr(rkeys[c]),
                _ptr(rnulls[c])]
    _launch("join_range_run", 2, hdr, dev)
    return pk, pvo, bk, bvo, ovf[0], nbv[0], bio


# -- pack and probe -----------------------------------------------------------

def _sorted_view(a0, order, nv):
    """The sorted keys the probe searches: a0[:nv], or a0[order[:nv]]."""
    return a0[order[:nv]] if order is not None else a0[:nv]


def probe_plain(keys, knulls, pvalid, packs, a0, a1, nv, layout, mode,
                kind="inner", bvalid=None, order=None, dense_span=None):
    n = keys[0].shape[0]
    dev = keys[0].device
    nv = int(nv)
    ok = (pvalid.clone() if pvalid is not None
          else torch.ones(n, dtype=torch.bool, device=dev))
    pv = ok.clone()
    if packs is None:
        key = keys[0].to(torch.int64)
    else:
        key = torch.zeros(n, dtype=torch.int64, device=dev)
        for d, nl, (mn, span) in zip(keys, knulls, packs):
            v = d.to(torch.int64) - mn
            if nl is not None:
                ok &= ~nl
            ok &= (v >= 0) & (v < span)
            key = key * span + v.clamp(0, span - 1)
    if layout == "dense":
        kc = key.clamp(0, dense_span - 1)
        s0 = a0[kc].to(torch.int64)
        pos0 = s0
        cnt = torch.where(ok, a0[kc + 1].to(torch.int64) - s0, 0)
    else:
        sk = _sorted_view(a0, order, nv).contiguous()
        lo = torch.searchsorted(sk, key)
        pos0 = lo
        if mode == "uniq":
            lo_c = lo.clamp(0, max(nv - 1, 0))
            eq = (sk[lo_c] == key) if nv else torch.zeros_like(ok)
            cnt = (ok & (lo < nv) & eq).to(torch.int64)
        else:
            hi = torch.searchsorted(sk, key, right=True)
            cnt = torch.where(ok, hi - lo, 0)
    matched = cnt > 0
    if mode == "count":
        return {"pos0": torch.where(matched, pos0, 0), "cnt": cnt,
                "count": cnt.sum()}
    out = {}
    if mode == "uniq":
        at = pos0.clamp(0, max(nv - 1, 0))
        bi = torch.where(matched, a1[at].to(torch.int64), 0)
        h = matched
        if bvalid is not None:
            h = h & bvalid[bi]
        out["bi"], out["hit"] = bi, h
    else:
        h = matched
    out.update(zip(("valid", "nohit", "count"), finish_plain(pv, h, kind)))
    return out


def sample_stride(nv: int, sample: int) -> tuple:
    """(stride, entries) of the sorted probe's shared-memory sample over
    `nv` sorted keys: every stride-th key, at most `sample` of them
    (``csrc/join_probe.cu sample_stride``).  A row's lower bound is then
    searched in the sample and in one segment of ``stride - 1`` keys."""
    stride = max(-(-nv // sample), 1)
    return stride, -(-nv // stride)


def probe(keys, knulls, pvalid, packs, a0, a1, nv, *, layout, mode,
          kind="inner", bvalid=None, order=None, dense_span=None):
    """Pack and probe (see the module note).

    keys / knulls: the probe key columns (int64) and their NULL flags
    (bool, or None for no NULLs); packs: the index's ``(mn, span)`` per
    column, or None when ``keys[0]`` is already the packed key (its
    validity in `pvalid`); a0: the dense CSR starts (span+1 entries) or
    the sorted keys; order: read the sorted keys as ``a0[order[m]]``
    (gathered once a call); a1: the row ids (``uniq`` only); nv: n_valid,
    a host int or a 0-d int64 tensor on the device; bvalid: the build
    relation's validity (``uniq``).  Returns a dict: ``uniq`` → bi, hit, valid, nohit,
    count; ``count`` → pos0, cnt and count, the total of cnt; ``exists`` →
    valid, nohit, count (count a 0-d int64: the valid rows, or the total
    of cnt).  A row without a match has ``pos0 = 0`` and ``bi = 0``."""
    _check_keys(keys, "probe")
    knulls = list(knulls) if knulls else [None] * len(keys)
    if keys[0].device.type == "cpu":
        return probe_plain(keys, knulls, pvalid, packs, a0, a1, nv, layout,
                           mode, kind, bvalid, order, dense_span)
    dev = keys[0].device
    n = keys[0].shape[0]
    for t in keys:
        _as_i64(t, "probe keys")
    for t in list(keys) + list(knulls) + [pvalid]:
        if t is not None and t.shape[0] != n:
            raise ValueError("join_probe: probe columns differ in length")
    for t in list(knulls) + [pvalid, bvalid]:
        _as_bool(t, "null flags and validity")
    nv_t = nv if isinstance(nv, torch.Tensor) else None
    _cuda_checks(dev, list(keys) + list(knulls) + [pvalid, bvalid, a0, a1,
                                                   order, nv_t])
    if layout == "dense":
        a0_64 = _index_dtype(a0, "CSR starts")
        if dense_span is None or a0.shape[0] < dense_span + 1:
            raise ValueError("join_probe: dense CSR starts need span+1 "
                             "entries")
    else:
        _as_i64(a0, "sorted keys")
        a0_64 = 1
        if nv_t is None and a0.shape[0] < int(nv):
            raise ValueError("join_probe: fewer sorted keys than n_valid")
        if order is not None and order.shape[0] < a0.shape[0]:
            raise ValueError("join_probe: sort order shorter than keys")
    a1_64 = _index_dtype(a1, "row ids") if a1 is not None else 1
    if order is not None:
        _as_i64(order, "sort order")
    if mode == "uniq" and (a1 is None or a1.shape[0] < 1):
        raise ValueError("join_probe: a unique probe needs the row ids")
    e = dict(device=dev)
    outs = {}
    cnt1 = torch.zeros(1, dtype=torch.int64, **e)
    if mode == "count":
        outs["pos0"] = torch.empty(n, dtype=torch.int64, **e)
        outs["cnt"] = torch.empty(n, dtype=torch.int64, **e)
    else:
        if mode == "uniq":
            outs["bi"] = torch.empty(n, dtype=torch.int64, **e)
            outs["hit"] = torch.empty(n, dtype=torch.bool, **e)
        outs["valid"] = torch.empty(n, dtype=torch.bool, **e)
        outs["nohit"] = torch.empty(n, dtype=torch.bool, **e)
    sk_buf = (torch.empty(order.shape[0], dtype=torch.int64, **e)
              if order is not None and layout != "dense" else None)
    hdr = [n, len(keys), int(packs is None), _ptr(pvalid),
           0 if layout == "dense" else 1, _ptr(a0), a0_64,
           int(dense_span or 0), _ptr(order), _ptr(sk_buf), int(SAMPLE),
           _ptr(a1), a1_64, 0 if nv_t is not None else int(nv), _ptr(nv_t),
           MODES[mode], KINDS[kind], _ptr(bvalid), _ptr(outs.get("bi")),
           _ptr(outs.get("hit")), _ptr(outs.get("valid")),
           _ptr(outs.get("nohit")), _ptr(outs.get("pos0")),
           _ptr(outs.get("cnt")), _ptr(cnt1),
           0 if order is None else order.shape[0]]
    packs = packs if packs is not None else [(0, 1)] * len(keys)
    for c, (d, (mn, span)) in enumerate(zip(keys, packs)):
        hdr += [_ptr(d), _ptr(knulls[c]), int(mn), int(span)]
    _launch("join_probe_run", 2, hdr, dev)
    outs["count"] = cnt1[0]
    return outs


# -- finish -------------------------------------------------------------------

def finish_plain(pvalid, hit, kind):
    """(valid, nohit, count) of a join kind from the match flag `hit`
    (inner and semi: pvalid ∧ hit; anti: pvalid ∧ ¬hit; left: pvalid)."""
    pv = (pvalid if pvalid is not None
          else torch.ones_like(hit, dtype=torch.bool))
    if kind == "left":
        valid = pv.clone()
    elif kind == "anti":
        valid = pv & ~hit
    else:
        valid = pv & hit
    return valid, ~hit, valid.sum()
