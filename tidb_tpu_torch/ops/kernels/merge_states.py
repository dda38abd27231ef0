"""K8/K9 merge: the fold of partial aggregate states into one state.

Replaces the device branch of ``tidb_tpu/executor/device_exec.py:1323
merge_partial_states``, which the streamed scan-aggregate (K8) and the
paged probe join (K9) share.

A *state* is the tuple that K1 (:mod:`groupby_agg`) returns:
``(keys, key_nulls, results, result_nulls, n_groups, valid)``, each
array ``capacity`` slots long, the first ``n_groups`` of them live.
:func:`merge` folds a list of states (the running state first, then the
buffered blocks in order) into one state of ``merge_cap`` slots, with
K1's output contract over the concatenated live slots and the merge ops
(``count`` partials merge as ``sum_i``):

* slots in ascending packed-key order, or without ``pack`` in K1's hash
  path key order; a NULL key is its own group;
* ``first`` is the value of the earliest part that holds the group;
* ``sum_i`` wraps exactly as int64, ``sum_f`` adds in float64;
* a result is NULL only where every input of the group is NULL;
* ``n_groups`` is exact even past ``merge_cap`` (the caller grows
  ``merge_cap`` to ``next_pow2(n_groups)`` and folds again).

CUDA states launch ``csrc/merge_states.cu`` (a gather of each part's
live slots, read in place through a device table of part pointers,
without a host read of any part's ``n_groups``) and then K1's kernels on
the gathered rows; CPU states run :func:`merge_plain`.  Bound on the
card: memory (see the source note).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import groupby_agg

#: launches of the CUDA kernel (chip_smoke.py reads it to prove the path)
LAUNCHES = [0]

#: csrc/merge_states.cu MS_MAX_KEYS / MS_MAX_AGGS
MAX_KEYS = 8
MAX_AGGS = 32

_FN = [None]


def _live_rows(parts):
    """Each part's live slot count, read on the host."""
    return [min(int(p[4]), int(p[0][0].shape[0])) for p in parts]


def merge_plain(parts, n_keys, merge_ops, merge_cap, pack=None):
    """The merge in plain torch ops: ``torch.cat`` of every part's live
    slots, then K1's plain version with the merge ops."""
    live = _live_rows(parts)
    dev = parts[0][4].device
    total = sum(live)
    m = len(merge_ops)

    def cat(get, dtype):
        if total == 0:  # one masked row: the aggregate needs a length
            return torch.zeros(1, dtype=dtype, device=dev)
        return torch.cat([get(p)[:n] for p, n in zip(parts, live)])

    keys = tuple(cat(lambda p, i=i: p[0][i], torch.int64)
                 for i in range(n_keys))
    knulls = tuple(cat(lambda p, i=i: p[1][i], torch.bool)
                   for i in range(n_keys))
    vals = tuple(cat(lambda p, j=j: p[2][j], parts[0][2][j].dtype)
                 for j in range(m))
    vnulls = tuple(cat(lambda p, j=j: p[3][j], torch.bool)
                   for j in range(m))
    mask = torch.full((max(total, 1),), total > 0, dtype=torch.bool,
                      device=dev)
    return groupby_agg.groupby_plain(keys, knulls, vals, vnulls, mask,
                                     n_keys, merge_ops, merge_cap, pack)


def _check(parts, n_keys, merge_ops):
    if not parts:
        raise ValueError("merge_states: no states to merge")
    if n_keys > MAX_KEYS or len(merge_ops) > MAX_AGGS:
        from ..device import DeviceUnsupported
        raise DeviceUnsupported(f"merge_states: at most {MAX_KEYS} keys and "
                                f"{MAX_AGGS} aggregate slots on the device")
    dev = parts[0][4].device
    m = len(merge_ops)
    for p in parts:
        if len(p[0]) != n_keys or len(p[2]) != m:
            raise ValueError("merge_states: states of different shapes")
        cap = p[0][0].shape[0]
        arrays = list(p[0]) + list(p[1]) + list(p[2]) + list(p[3])
        for t in arrays:
            if (t.device != dev or t.shape != (cap,)
                    or not t.is_contiguous()):
                raise ValueError("merge_states: a state's arrays must be "
                                 "contiguous, of its capacity, on one "
                                 "device")
        for t in p[0]:
            if t.dtype != torch.int64:
                raise TypeError(f"merge_states: key dtype {t.dtype}")
        for t in list(p[1]) + list(p[3]):
            if t.dtype != torch.bool:
                raise TypeError("merge_states: NULL flags must be bool")
        for j, t in enumerate(p[2]):
            if t.dtype != parts[0][2][j].dtype or t.element_size() != 8:
                raise TypeError("merge_states: results must be int64 or "
                                "float64, alike in every state")
        if p[4].dtype != torch.int64 or p[4].numel() != 1:
            raise TypeError("merge_states: n_groups must be one int64")


def merge(parts, n_keys, merge_ops, merge_cap, pack=None):
    """Fold `parts` (states, the running state first) into one state of
    `merge_cap` slots.  CUDA states launch the kernel; CPU states run the
    plain version."""
    if parts[0][4].device.type == "cpu":
        return merge_plain(parts, n_keys, merge_ops, merge_cap, pack)
    _check(parts, n_keys, merge_ops)
    dev = parts[0][4].device
    i64 = torch.int64
    m = len(merge_ops)
    caps = [int(p[0][0].shape[0]) for p in parts]
    total = sum(caps)
    stride = 3 + 2 * n_keys + 2 * m
    table = np.zeros((len(parts), stride), dtype=np.int64)
    base = 0
    for r, (p, cap) in enumerate(zip(parts, caps)):
        ptrs = ([p[4].data_ptr(), cap, base]
                + [t.data_ptr() for t in p[0]] + [t.data_ptr() for t in p[1]]
                + [t.data_ptr() for t in p[2]] + [t.data_ptr() for t in p[3]])
        table[r] = ptrs
        base += cap
    # through pinned memory: a pageable copy would wait for the stream
    table_d = torch.from_numpy(table).pin_memory().to(dev,
                                                      non_blocking=True)
    # the gathered rows: keys and results in one int64 buffer, their NULL
    # flags and the row mask in one bool buffer
    flat_i = torch.empty((n_keys + m) * total, dtype=i64, device=dev)
    flat_b = torch.empty((n_keys + m + 1) * total, dtype=torch.bool,
                         device=dev)
    keys = [flat_i[i * total:(i + 1) * total] for i in range(n_keys)]
    knulls = [flat_b[i * total:(i + 1) * total] for i in range(n_keys)]
    vals = [flat_i[(n_keys + j) * total:(n_keys + j + 1) * total].view(
        parts[0][2][j].dtype) for j in range(m)]
    vnulls = [flat_b[(n_keys + j) * total:(n_keys + j + 1) * total]
              for j in range(m)]
    mask = flat_b[(n_keys + m) * total:]
    hdr = np.zeros(88, dtype=np.int64)
    hdr[0], hdr[1], hdr[2] = n_keys, m, mask.data_ptr()
    pi, pb = flat_i.data_ptr(), flat_b.data_ptr()
    hdr[8:8 + n_keys] = [pi + 8 * i * total for i in range(n_keys)]
    hdr[16:16 + n_keys] = [pb + i * total for i in range(n_keys)]
    hdr[24:24 + m] = [pi + 8 * (n_keys + j) * total for j in range(m)]
    hdr[56:56 + m] = [pb + (n_keys + j) * total for j in range(m)]
    from . import build
    if _FN[0] is None:
        _FN[0] = build.declare("ms_gather_run", 6, (1, 2, 3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(_FN[0](table_d.data_ptr(), len(parts), stride, max(caps),
                       hdr.ctypes.data, ctypes.c_void_p(stream)),
                "ms_gather_run")
    out = groupby_agg.groupby_cuda(tuple(keys), tuple(knulls), tuple(vals),
                                   tuple(vnulls), mask, n_keys, merge_ops,
                                   merge_cap, pack)
    LAUNCHES[0] += 1
    return out
