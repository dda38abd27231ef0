"""K4: top-k of group slots by a multi-key order, and the key order of the
hash aggregate's groups and of a window's rows.

The order (``tidb_tpu/executor/device_exec.py:711 _topk_indices``): slots
at or past the live count sort behind every live slot; then each key in
turn by its null rank and its value — ints descending by bitwise NOT,
floats descending by negation; ties fall to the slot index.

:func:`sort_indices` runs ``csrc/sort_topk.cu`` on CUDA tensors and
:func:`sort_plain` (successive stable ``torch.argsort`` calls, minor key
first, as ``jnp.lexsort`` does) on CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: launches of the CUDA kernel from the top-k entry (the aggregate's own
#: group ordering calls the kernel without counting here)
LAUNCHES = [0]

MAX_KEYS = 16


def sort_plain(cols, nulls, descs, nulls_first, length: int, ng: int):
    """Slot indices [0, length) in sort order (all of them)."""
    dev = cols[0].device if cols else torch.device("cpu")
    order = torch.arange(length, device=dev)
    for d, nl, desc, nf in reversed(list(zip(cols, nulls, descs,
                                             nulls_first))):
        d, nl = d[:length], nl[:length].to(torch.bool)
        if d.is_floating_point():
            v = -d if desc else d
        else:
            v = d.to(torch.int64)
            v = ~v if desc else v
        v = torch.where(nl, torch.zeros((), dtype=v.dtype, device=dev), v)
        order = order[torch.argsort(v[order], stable=True)]
        rank = (~nl if nf else nl).to(torch.uint8)
        order = order[torch.argsort(rank[order], stable=True)]
    dead = (torch.arange(length, device=dev) >= ng).to(torch.uint8)
    return order[torch.argsort(dead[order], stable=True)]


_FN = [None]


def _kernel():
    if _FN[0] is None:
        from . import build
        _FN[0] = build.declare("sort_keys_run", 2)
    return _FN[0]


def _check(cols, nulls, length):
    dev = cols[0].device
    for d, nl in zip(cols, nulls):
        if d.device != dev or nl.device != dev:
            raise ValueError("sort_topk: keys on different devices")
        if d.dtype not in (torch.int64, torch.float64):
            raise TypeError(f"sort_topk: key dtype {d.dtype} "
                            "(int64 or float64 expected)")
        if nl.dtype != torch.bool:
            raise TypeError("sort_topk: null flags must be bool")
        if not (d.is_contiguous() and nl.is_contiguous()):
            raise ValueError("sort_topk: keys must be contiguous")
        if d.shape[0] < length or nl.shape[0] < length:
            raise ValueError("sort_topk: key shorter than the slot count")
    if len(cols) > MAX_KEYS:
        from ..device import DeviceUnsupported
        raise DeviceUnsupported(f"sort_topk: at most {MAX_KEYS} keys on "
                                "the device")


def _sort_cuda(cols, nulls, descs, nulls_first, length: int, ng: int):
    """Launch the bitonic sort; returns next_pow2(length) indices, the
    first `length` of which are the slots in order."""
    _check(cols, nulls, length)
    dev = cols[0].device
    P = 2
    while P < length:
        P <<= 1
    S = len(cols)
    idx = torch.empty(P, dtype=torch.int64, device=dev)
    K = torch.empty(max(S, 1) * P, dtype=torch.int64, device=dev)
    NR = torch.empty(max(S, 1) * P, dtype=torch.uint8, device=dev)
    major = torch.empty(P, dtype=torch.uint8, device=dev)
    hdr = [S, length, P, ng, idx.data_ptr(), K.data_ptr(), NR.data_ptr(),
           major.data_ptr()]
    for d, nl, desc, nf in zip(cols, nulls, descs, nulls_first):
        hdr += [d.data_ptr(), nl.data_ptr(), int(d.is_floating_point()),
                int(bool(desc)), int(bool(nf))]
    hdr = np.asarray(hdr, dtype=np.int64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(hdr.ctypes.data, ctypes.c_void_p(stream))
    from . import build
    build.check(rc, "sort_keys_run")
    return idx


def sort_indices(cols, nulls, descs, nulls_first, length: int, ng: int,
                 k: int):
    """The first `k` slots of [0, length) in sort order.  cols: int64 or
    float64 per key; nulls: bool per key; descs / nulls_first: per key;
    slots at index >= ng sort after every live slot."""
    if not cols or cols[0].device.type == "cpu":
        return sort_plain(cols, nulls, descs, nulls_first, length, ng)[:k]
    idx = _sort_cuda(cols, nulls, descs, nulls_first, length, ng)
    LAUNCHES[0] += 1
    return idx[:k]


def valid_first_order(key, invalid):
    """All row indices of the int64 `key` in the valid-first, key-sorted,
    stable order: valid rows by (key, index), then the rows flagged in the
    bool `invalid` by index — the order of the reference's
    ``lexsort((key, ~valid))`` on the valid prefix (``device_join.py:531``)
    and of ``argsort(key, stable=True)`` once NULL keys are set aside
    (``ops/device.py:1476``).  Counted in ``LAUNCHES`` on the card."""
    n = key.shape[0]
    return sort_indices([key], [invalid], [False], [False], n, n, n)


def window_order(cols, nulls, descs, nb: int, n_live: int):
    """The window's order over `nb` rows (the reference's lexsort,
    ``tidb_tpu/executor/device_exec.py:1569``): rows below `n_live`
    first, then each key — partition keys ascending, then order keys —
    with NULLs first ascending and last descending, ties by row index.
    Counted in ``LAUNCHES`` on the card."""
    return sort_indices(cols, nulls, descs, [not d for d in descs], nb,
                        n_live, nb)
