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

CUDA states launch ``csrc/merge_states.cu``: every part's live slots
already hold distinct keys in that order, so the fold is one stable
merge of sorted runs (:func:`tile_bounds` cuts it into tiles at key
boundaries, ``ms_merge`` merges each tile; :func:`launch_plan` counts
the launches).  A part found out of order sets a fault word beside
``n_groups``, and :func:`read_groups`, the callers' read of
``n_groups``, raises :class:`FoldOrderError` on it.  CPU states run
:func:`merge_plain`.  Bound on the card: memory (see the source note).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import groupby_agg

#: launches of the CUDA kernel (chip_smoke.py reads it to prove the path)
LAUNCHES = [0]

#: csrc/merge_states.cu MS_MAX_KEYS / MS_MAX_AGGS / MS_MAX_PARTS (parts a
#: launch: a lane each)
MAX_KEYS = 8
MAX_AGGS = 32
MAX_PARTS = 32
#: csrc/merge_states.cu MS_SPAN: a tile whose keys differ only in their
#: last order word, over fewer values than this, is placed by counting
SPAN = 7680
#: csrc/merge_states.cu MS_TABLE_WORDS: the part table's words a launch's
#: parameters carry; a larger table goes through :func:`_staged_table`
TABLE_WORDS = 448
#: the largest part table: 32 parts of the widest state
MAX_TABLE_WORDS = MAX_PARTS * (2 + 2 * MAX_KEYS + 2 * MAX_AGGS)
#: the merge ops the kernel folds (csrc/merge_states.cu MS_SUM_I ...)
OP_CODES = {"sum_i": 1, "sum_f": 2, "min": 3, "max": 4, "first": 5}
#: order words a tile's shared memory stages (W x (T + 32) words, within
#: the counting path's SPAN bit masks and starts, 6 bytes each)
TILE_WORDS = 6 * SPAN // 8
#: the most rows a tile takes
MAX_TILE = 4096
#: folds of at most this many tiles search their tile boundaries in the
#: merge's own blocks (one launch); larger ones launch ms_bounds first
FUSED_TILES = 64
HDR_LEN = 104

_BIAS = np.uint64(1 << 63)


class FoldOrderError(RuntimeError):
    """A part of a fold was not in the fold's order (its live keys are
    not distinct and ascending): the folded state is not returned."""


class FoldState(groupby_agg.DeviceState):
    """A state the kernel folded; ``status`` is the int64 pair
    (n_groups, fault word) on the card, ``n_groups`` a view of its first
    word."""

    status = None


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


# -- the tile plan (the kernel's, in numpy) -------------------------------------


def n_words(n_keys, pack):
    """Order words a row: the packed key, or a NULL flag and a value per
    key."""
    return 1 if pack is not None else 2 * n_keys


def tile_rows(w):
    """T, the merged rows a tile takes, for rows of `w` order words: a
    power of two, W x (T + 32) words within :data:`TILE_WORDS`."""
    t = MAX_TILE
    while w * (t + 32) > TILE_WORDS:
        t //= 2
    return t


def order_words(keys, knulls, pack=None):
    """The order words of rows (numpy arrays of keys and NULL flags), an
    (n, W) uint64 array compared row by row, word by word: with `pack`
    the packed key of ``groupby_agg._packed`` (NULL packs to 0), without
    per key its NULL flag and its value (0 where NULL); values biased by
    2^63, so signed order is word order (csrc/merge_states.cu ms_word)."""
    n = len(keys[0]) if keys else 0
    with np.errstate(over="ignore"):
        if pack is not None:
            packed = np.zeros(n, dtype=np.uint64)
            for (bits, off), k, kn in zip(pack, keys, knulls):
                f = np.where(kn, np.uint64(0),
                             k.astype(np.int64).view(np.uint64)
                             + np.uint64((off + 1) % (1 << 64)))
                packed = ((packed << np.uint64(bits)) if bits < 64
                          else np.zeros_like(packed)) | f
            return (packed ^ _BIAS).reshape(n, 1)
        cols = []
        for k, kn in zip(keys, knulls):
            cols.append(kn.astype(np.uint64))
            cols.append(np.where(kn, np.uint64(0),
                                 k.astype(np.int64).view(np.uint64) ^ _BIAS))
        return np.stack(cols, 1) if cols else np.zeros((n, 0), np.uint64)


def _below(words, lo, hi, w, x):
    """ms_below: the rows of [lo, hi) whose word w is below x, plus lo."""
    while lo < hi:
        mid = (lo + hi) >> 1
        if int(words[mid, w]) < x:
            lo = mid + 1
        else:
            hi = mid
    return lo


def select_split(words, r, rmin):
    """ms_select over every part at once: each part's rows below the
    first key (in the word order) whose rank — the rows below it over
    every part — lies in [rmin, r].  `words`: each part's (n, W) order
    words, sorted; 0 < r < their total rows.  Each word's value is
    searched by interpolation between the ranks of the range's ends,
    aiming at the middle of [rmin, r], with a bisection after any step
    that did not halve the range."""
    W = words[0].shape[1]
    aim = r - (r - rmin) // 2
    blo = [0] * len(words)
    bhi = [len(wd) for wd in words]
    for w in range(W):
        rl = sum(blo)
        if rl >= rmin:
            return blo
        on = [p for p in range(len(words)) if blo[p] < bhi[p]]
        lo = min(int(words[p][blo[p], w]) for p in on)
        hi = max(int(words[p][bhi[p] - 1, w]) for p in on)
        xl, lw, up = lo, list(blo), list(bhi)
        top = hi == (1 << 64) - 1  # only there is hi itself probed
        c = ([_below(wd, a, b, w, hi) for wd, a, b in zip(words, blo, bhi)]
             if top else list(bhi))
        if sum(c) <= r:
            if sum(c) >= rmin:
                return c
            xl, lw = hi, c
        else:
            xh, up, ru = (hi if top else hi + 1), c, sum(c)
            bisect = False
            while xh - xl > 1:
                span = xh - xl
                if bisect:
                    mid = xl + (span >> 1)
                else:
                    d = (aim - rl) / (ru - rl) * float(span)
                    off = int(d) if d < float(span) else span - 1
                    mid = xl + min(max(off, 1), span - 1)
                c = [_below(wd, a, b, w, mid)
                     for wd, a, b in zip(words, lw, up)]
                if sum(c) <= r:
                    if sum(c) >= rmin:
                        return c
                    xl, lw, rl = mid, c, sum(c)
                else:
                    xh, up, ru = mid, c, sum(c)
                bisect = not bisect and xh - xl > (span >> 1)
        blo, bhi = lw, up
    return blo


def tile_bounds(words, tile):
    """The tile plan of ms_bounds: an (n_tiles + 1, P) array of each
    part's split at every tile boundary, tile t the rows between
    boundaries t and t + 1.  n_tiles covers the parts' capacities; here
    their live rows (``len(words[p])``), the planner's lower bound."""
    P = len(words)
    if tile < P:
        raise ValueError("merge_states: a tile takes at least one row a part")
    live = [len(wd) for wd in words]
    n = sum(live)
    n_tiles = max(1, -(-n // tile))
    out = np.zeros((n_tiles + 1, P), dtype=np.int64)
    for t in range(n_tiles + 1):
        r = t * tile
        if r <= 0:
            continue
        out[t] = live if r >= n else select_split(words, r, r - (P - 1))
    return out


def fold_groups(n_parts):
    """The part groups of one fold round: consecutive runs of at most
    :data:`MAX_PARTS` (a launch's lanes); a fold of more parts folds each
    group into a state in the same order and then folds those."""
    return [list(range(i, min(i + MAX_PARTS, n_parts)))
            for i in range(0, n_parts, MAX_PARTS)]


def launch_plan(caps, merge_cap, n_keys=1, pack=None):
    """Kernel launches of one :func:`merge` of parts of capacities `caps`:
    per kernel fold ``ms_merge``, and ``ms_bounds`` before it where the
    capacities span more than :data:`FUSED_TILES` tiles; a fold of more
    than :data:`MAX_PARTS` parts in rounds of groups
    (:func:`fold_groups`)."""
    tile = tile_rows(n_words(n_keys, pack))
    launches = 0
    caps = list(caps)
    while True:
        groups = fold_groups(len(caps))
        nxt = []
        for g in groups:
            c = sum(caps[i] for i in g)
            if len(groups) > 1 and len(g) == 1:
                nxt.append(c)
                continue
            launches += 1 + int(-(-c // tile) > FUSED_TILES)
            nxt.append(c)
        if len(groups) == 1:
            return launches
        caps = nxt


# -- the CUDA path -------------------------------------------------------------


class _Status:
    """The fold's status block on one stream: a ticket counter, the fault
    word, then per tile a flag, the aggregate and the inclusive group
    count (int64 words), zeroed once when allocated and grown to the
    largest call.  Every launch takes a new epoch, which its flags carry,
    so no launch clears them (the last ticket sets the counter back to
    0); the lock keeps epochs in stream order across threads."""

    __slots__ = ("words", "tiles", "epoch")

    def __init__(self):
        self.words, self.tiles, self.epoch = None, 0, 0


_STATUS: dict = {}
_STATUS_LOCK = threading.Lock()
#: per device: the reused pinned staging buffer of the part table, its
#: device copy, and the event of the last copy out of it
_STAGE: dict = {}
_FN = [None]


def _kernel():
    if _FN[0] is None:
        from . import build
        _FN[0] = build.declare("ms_fold_run", 5, (2,))
    return _FN[0]


def pack_table(parts, n_keys, merge_ops):
    """The part table, one row of 2 + 2 nk + 2 m int64 words a part: a
    pointer to its n_groups, its capacity, then a pointer per key, key
    NULL flag, result and result NULL flag.  Checks each state in the same
    pass and raises on what the kernel does not take; a state the card's
    kernels made (``groupby_agg.DeviceState``) has its arrays' types
    checked, not their layout."""
    if not parts:
        raise ValueError("merge_states: no states to merge")
    m = len(merge_ops)
    bad = [o for o in merge_ops if o not in OP_CODES]
    if n_keys < 1 or n_keys > MAX_KEYS or m > MAX_AGGS or bad:
        from ..device import DeviceUnsupported
        raise DeviceUnsupported(
            f"merge_states: 1 to {MAX_KEYS} keys, at most {MAX_AGGS} "
            f"aggregate slots and the ops {sorted(OP_CODES)} on the device "
            f"(got {n_keys} keys, ops {list(merge_ops)})")
    dev = parts[0][4].get_device()
    kinds = ([torch.int64] * n_keys + [torch.bool] * n_keys
             + [t.dtype for t in parts[0][2]] + [torch.bool] * m)
    sizes = [8] * n_keys + [1] * n_keys + [8] * m + [1] * m
    rows = []
    for p in parts:
        if len(p[0]) != n_keys or len(p[1]) != n_keys or len(p[2]) != m \
                or len(p[3]) != m:
            raise ValueError("merge_states: states of different shapes")
        arrs = (*p[0], *p[1], *p[2], *p[3])
        cap = arrs[0].shape[0]
        if [t.dtype for t in arrs] != kinds:
            raise TypeError("merge_states: keys int64, NULL flags bool, "
                            "results int64 or float64 alike in every state")
        if not isinstance(p, groupby_agg.DeviceState) and (
                [t.nbytes for t in arrs] != [cap * z for z in sizes]
                or not all([t.is_contiguous() for t in arrs])
                or [t.get_device() for t in arrs] != [dev] * len(arrs)):
            raise ValueError("merge_states: a state's arrays must be "
                             "contiguous, of its capacity, on one device")
        ng = p[4]
        if ng.get_device() != dev:
            raise ValueError("merge_states: states on different devices")
        if ng.dtype != torch.int64 or ng.numel() != 1:
            raise TypeError("merge_states: n_groups must be one int64")
        rows.append([ng.data_ptr(), cap] + [t.data_ptr() for t in arrs])
    return np.asarray(rows, dtype=np.int64)


def pack_header(n_parts, n_keys, merge_ops, flt, merge_cap, pack, n_tiles,
                bounds, out_i, out_b, status, epoch, epoch_lo):
    """The int64 header of csrc/merge_states.cu ``ms_fold_run``; status:
    the status block's (ctr, fault, flag, agg, incl) pointers."""
    m = len(merge_ops)
    w = n_words(n_keys, pack)
    tile = tile_rows(w)
    tcap = tile + 32
    stride = 2 + 2 * n_keys + 2 * m
    tab = -(-n_parts * stride * 8 // 16) * 16
    # the table, the keys' region (staged order words, or the counting
    # path's bit masks and 16-bit starts), rows' parts and key offsets,
    # the merged order and the heads (16 bits each)
    smem = tab + max(w * tcap * 8, 6 * SPAN) + tcap * 8
    hdr = np.zeros(HDR_LEN, dtype=np.int64)
    hdr[:22] = ([n_parts, n_keys, m, w, int(pack is not None), stride, tile,
                 tcap, merge_cap, n_tiles, bounds, out_i, out_b]
                + list(status)
                + [epoch, smem, n_parts * stride * 8, epoch_lo])
    if pack is not None:
        hdr[24:24 + n_keys] = [b for b, _o in pack]
        hdr[32:32 + n_keys] = [o for _b, o in pack]
    hdr[40:40 + m] = [OP_CODES[o] for o in merge_ops]
    hdr[72:72 + m] = flt
    return hdr


def _staged_table(table, dev, stream):
    """The part table in device memory through a pinned buffer reused
    from call to call (one host-to-device copy, no allocation a call);
    returns its device pointer.  The kernel reads it there in place of
    its parameters: a table past :data:`TABLE_WORDS` (wide states, many
    parts) always comes this way."""
    n = table.size
    st = _STAGE.get(dev)
    if st is None or st[0].numel() < n:
        host = torch.empty(max(n, MAX_TABLE_WORDS), dtype=torch.int64
                           ).pin_memory()
        st = _STAGE[dev] = [host, torch.empty_like(host, device=dev), None]
    if st[2] is not None:
        st[2].synchronize()  # the last copy out of the buffer is done
    st[0][:n].numpy()[:] = table.ravel()
    st[1][:n].copy_(st[0][:n], non_blocking=True)
    st[2] = torch.cuda.Event()
    st[2].record(stream)
    return st[1].data_ptr()


def _fold_cuda(parts, n_keys, merge_ops, merge_cap, pack, epoch_lo=None):
    """One launch's fold of at most :data:`MAX_PARTS` parts; returns
    (FoldState, the launch's epoch)."""
    from . import build
    dev = parts[0][4].device
    i64 = torch.int64
    m = len(merge_ops)
    cap = max(int(merge_cap), 1)
    caps = [int(p[0][0].shape[0]) for p in parts]
    tile = tile_rows(n_words(n_keys, pack))
    n_tiles = max(1, -(-sum(caps) // tile))
    flt = [int(parts[0][2][j].dtype == torch.float64) for j in range(m)]
    out_i = torch.empty((n_keys + m) * cap + 2, dtype=i64, device=dev)
    out_b = torch.empty((n_keys + m + 1) * cap, dtype=torch.bool,
                        device=dev)
    bounds = (torch.empty((n_tiles + 1) * MAX_PARTS, dtype=i64, device=dev)
              if n_tiles > FUSED_TILES else None)
    table = pack_table(parts, n_keys, merge_ops)
    stream = torch.cuda.current_stream(dev)
    with _STATUS_LOCK:
        st = _STATUS.setdefault((dev, stream.cuda_stream), _Status())
        if st.tiles < n_tiles:
            st.tiles = max(n_tiles, 2 * st.tiles)
            old, st.words = st.words, torch.zeros(2 + 3 * st.tiles,
                                                  dtype=i64, device=dev)
            if old is not None:
                # the ticket counter and the fault word outlive a launch:
                # a fold of groups reads its groups' faults at its end
                st.words[:2].copy_(old[:2])
        st.epoch += 1
        base = st.words.data_ptr()
        status = [base, base + 8, base + 16, base + 16 + 8 * st.tiles,
                  base + 16 + 16 * st.tiles]
        hdr = pack_header(len(parts), n_keys, merge_ops, flt, cap, pack,
                          n_tiles, 0 if bounds is None else
                          bounds.data_ptr(), out_i.data_ptr(),
                          out_b.data_ptr(), status, st.epoch,
                          st.epoch if epoch_lo is None else epoch_lo)
        table_dev = (_staged_table(table, dev, stream)
                     if table.size > TABLE_WORDS else None)
        rc = build.launch(dev, _kernel(), hdr.ctypes.data,
                          table.ctypes.data, table.size, table_dev,
                          ctypes.c_void_p(stream.cuda_stream))
        epoch = st.epoch
    build.check(rc, "ms_fold_run")
    LAUNCHES[0] += 1
    cols = out_i[:(n_keys + m) * cap].view(n_keys + m, cap).unbind(0)
    flags = out_b.view(n_keys + m + 1, cap).unbind(0)
    results = tuple(c.view(torch.float64) if f else c
                    for c, f in zip(cols[n_keys:], flt))
    status_t = out_i[(n_keys + m) * cap:]
    out = FoldState((cols[:n_keys], flags[:n_keys], results,
                     flags[n_keys:-1], status_t[0], flags[-1]))
    out.status = status_t
    return out, epoch


def merge(parts, n_keys, merge_ops, merge_cap, pack=None):
    """Fold `parts` (states, the running state first) into one state of
    `merge_cap` slots.  CUDA states launch the kernel; CPU states run the
    plain version.  Read the result's n_groups with :func:`read_groups`,
    which raises where a part was out of order."""
    if parts[0][4].device.type == "cpu":
        return merge_plain(parts, n_keys, merge_ops, merge_cap, pack)
    parts = list(parts)
    epoch_lo = None
    while len(parts) > MAX_PARTS:
        # a round of groups, each folded into a state of every slot its
        # parts hold (no overflow), in the same order
        nxt = []
        for g in fold_groups(len(parts)):
            if len(g) == 1:
                nxt.append(parts[g[0]])
                continue
            grp = [parts[i] for i in g]
            cap = sum(int(p[0][0].shape[0]) for p in grp)
            out, epoch = _fold_cuda(grp, n_keys, merge_ops, cap, pack,
                                    epoch_lo)
            epoch_lo = epoch if epoch_lo is None else epoch_lo
            nxt.append(out)
        parts = nxt
    return _fold_cuda(parts, n_keys, merge_ops, merge_cap, pack,
                      epoch_lo)[0]


def fault_word(out):
    """The fold's fault word (0: every part in order) as a 0-d int64
    tensor on its device, for a caller that reads it with other scalars;
    a CPU state's is 0."""
    if isinstance(out, FoldState):
        return out.status[1]
    return torch.zeros((), dtype=torch.int64, device=out[4].device)


def check_fault(fault):
    """Raise :class:`FoldOrderError` where a fetched fault word is set."""
    if int(fault):
        raise FoldOrderError(
            "merge_states: a part of the fold was not in the fold's order "
            "(live keys distinct and ascending); the fold is refused")


def read_groups(out):
    """A folded state's n_groups on the host, in one copy with its fault
    word; raises :class:`FoldOrderError` where it is set."""
    if isinstance(out, FoldState):
        ng, fault = out.status.tolist()
        check_fault(fault)
        return ng
    return int(out[4])
