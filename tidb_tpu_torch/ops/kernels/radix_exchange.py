"""Kernel A of the MPP exchange (K11/K12): the destination hash and the
stable two-level radix partition of one shard's rows into the slot grid
that the mesh's ``all_to_all`` splits.

Replaces ``tidb_tpu/parallel/mpp.py:223 _mix64``, ``:237 _radix_bucket``
and ``:250 _bucketize``, and ``tidb_tpu/executor/mpp_exec.py:221
_dest_hash`` with the bucket / argsort / searchsorted / gather of ``:232
_exchange_leaf``.

:func:`dest_hash` — murmur3's fmix64 of one int64 key column
(``mode="single"``), or the fold ``h = mix64(h ^ mix64(d))`` over the key
columns from ``h = 0`` (``mode="fold"``), as uint64 bits in int64 lanes;
with the rows' exchange validity (``valid`` and no NULL key).

:func:`partition` — bucket ``((h >> 32) % n_dest) * n_sub + (h & (n_sub -
1))`` per valid row (invalid rows park at ``nb = n_dest * n_sub``); bucket
``b``'s rows fill slots ``[b*cap, b*cap + min(cnt_b, cap))`` of an
``nb * cap`` grid IN ROW ORDER (the reference's stable argsort), each with
its source row, ``slot_valid`` and every column's element; the other
slots are zero (``_bucketize``'s zero fill).  ``need`` is the exact
largest bucket count, ``dropped`` the rows past ``cap``, both 0-d int64 on
the rows' device.  The grid's destination-major layout ``[n_dest, n_sub,
cap]`` is what a tiled ``all_to_all`` splits.

Each launches ``csrc/radix_exchange.cu`` for CUDA tensors and runs its
plain version for CPU tensors.  :func:`partition` is one launch: tiles of
:data:`TILE` rows ranked by bucket and placed by a look-back over the
earlier tiles' counts, then fill blocks that zero only the buckets' empty
tails (:func:`launch_plan`); its status words live in a workspace per
device and stream that no call clears (each call takes a new epoch).
The plain versions emulate uint64 on int64 (torch has no ``>>`` or ``%``
on uint64): a logical right shift is ``(x >> s) & ((1 << (64 - s)) -
1)``, and int64 multiplication wraps as uint64's does.  Bound on the
card: memory (see the source note).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

#: launches of the CUDA kernels (chip_smoke.py reads it to prove the path)
LAUNCHES = [0]

#: csrc/radix_exchange.cu RX_MAX_BUCKETS (nb + 1, the parked bucket
#: included), RX_MAX_COLS, RX_MAX_KEYS, RX_THREADS, RX_WARPS, RX_TILE
#: (the rows a tile block ranks) and RX_FILL_CHUNK (the slots of one
#: bucket a fill item covers)
MAX_BUCKETS = 1024
MAX_COLS = 64
MAX_KEYS = 8
THREADS = 256
WARPS = THREADS // 32
TILE = 2048
FILL_CHUNK = 4096
#: fill blocks of a call at most (two an SM)
FILL_BLOCKS = 132 * 2
#: the workspace's first status word (csrc RX_WS_STATUS): after the
#: ticket, the ready word and the counts of MAX_BUCKETS buckets
WS_STATUS = 2 + MAX_BUCKETS
#: the kernel's tags are 2 epoch + 1 and 2 epoch + 2 in 32 bits: past this
#: epoch the workspace is cleared and the epochs start again
EPOCH_LIMIT = (1 << 31) - 2

_M1 = 0xFF51AFD7ED558CCD - (1 << 64)
_M2 = 0xC4CEB9FE1A85EC53 - (1 << 64)

_FNS: dict = {}


def _lsr(x, s: int):
    """Logical right shift of int64 lanes read as uint64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64_plain(k):
    """fmix64 of int64 `k` as uint64 bits in int64 lanes."""
    u = k.to(torch.int64)
    u = u ^ _lsr(u, 33)
    u = u * _M1
    u = u ^ _lsr(u, 33)
    u = u * _M2
    return u ^ _lsr(u, 33)


def _ok_plain(keys, nulls, valid):
    ok = (valid.clone() if valid is not None
          else torch.ones(keys[0].shape[0], dtype=torch.bool,
                          device=keys[0].device))
    for nl in nulls:
        if nl is not None:
            ok &= ~nl
    return ok


def dest_hash_plain(keys, mode, nulls=(), valid=None):
    if mode == "single":
        h = mix64_plain(keys[0])
    else:
        h = torch.zeros_like(keys[0], dtype=torch.int64)
        for d in keys:
            h = mix64_plain(h ^ mix64_plain(d))
    return h, _ok_plain(keys, nulls, valid)


def bucket_plain(h, valid, n_dest: int, n_sub: int):
    """Bucket id per row; invalid rows park at n_dest * n_sub."""
    dest = _lsr(h, 32) % n_dest
    sub = h & (n_sub - 1)
    b = dest * n_sub + sub
    if valid is None:
        return b
    return torch.where(valid, b, n_dest * n_sub)


def partition_plain(h, valid, n_dest, n_sub, cap, cols=()):
    """The grid by a stable argsort of the bucket ids (torch ops)."""
    dev = h.device
    i64 = torch.int64
    m = h.shape[0]
    nb = n_dest * n_sub
    bucket = bucket_plain(h, valid, n_dest, n_sub)
    order = torch.argsort(bucket, stable=True)
    sb = bucket[order]
    counts = torch.bincount(bucket, minlength=nb + 1)[:nb + 1]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(m, dtype=i64, device=dev) - starts[sb]
    ok = (sb < nb) & (pos < cap)
    slot = (sb * cap + pos)[ok]
    src = order[ok]
    size = nb * cap
    rows = torch.zeros(size, dtype=i64, device=dev)
    rows[slot] = src
    slot_valid = torch.zeros(size, dtype=torch.bool, device=dev)
    slot_valid[slot] = True
    outs = []
    for c in cols:
        o = torch.zeros(size, dtype=c.dtype, device=dev)
        o[slot] = c[src]
        outs.append(o)
    cnt = counts[:nb]
    need = cnt.max() if nb else torch.zeros((), dtype=i64, device=dev)
    dropped = (cnt - cap).clamp(min=0).sum()
    return {"rows": rows, "valid": slot_valid, "cols": outs, "need": need,
            "dropped": dropped}


def _fn(name):
    from . import build
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = build.declare(name, 2)
    return fn


def _launch(name, hdr, dev):
    from . import build
    hdr = np.asarray(hdr, dtype=np.int64)
    build.check(_fn(name)(hdr.ctypes.data,
                          ctypes.c_void_p(build.raw_stream(dev))), name)
    LAUNCHES[0] += 1


def _check(dev, tensors, m, what):
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"radix_exchange: {what} on another device")
        if not t.is_contiguous():
            raise ValueError(f"radix_exchange: {what} must be contiguous")
        if t.shape != (m,):
            raise ValueError(f"radix_exchange: {what} of another length")


def dest_hash(keys, mode="single", nulls=(), valid=None):
    """(h, ok): the destination hash of the int64 key columns `keys` by
    `mode` ("single": mix64 of ``keys[0]``; "fold": the mix64 fold over
    every column) and ``ok = valid & no NULL key`` (`nulls`: a bool flag
    column or None per key; `valid` None: every row)."""
    if mode not in ("single", "fold"):
        raise ValueError(f"radix_exchange: hash mode {mode!r}")
    if not 1 <= len(keys) <= MAX_KEYS or (mode == "single"
                                          and len(keys) != 1):
        from ..device import DeviceUnsupported
        raise DeviceUnsupported(f"radix_exchange: 1..{MAX_KEYS} key columns "
                                "(one for a single hash)")
    nulls = list(nulls) if nulls else [None] * len(keys)
    if keys[0].device.type == "cpu":
        return dest_hash_plain(keys, mode, nulls, valid)
    dev = keys[0].device
    m = keys[0].shape[0]
    for k in keys:
        if k.dtype != torch.int64:
            raise TypeError(f"radix_exchange: key dtype {k.dtype}")
    for t in list(nulls) + [valid]:
        if t is not None and t.dtype != torch.bool:
            raise TypeError("radix_exchange: NULL flags and validity must "
                            "be bool")
    _check(dev, list(keys) + list(nulls) + [valid], m, "keys")
    h = torch.empty(m, dtype=torch.int64, device=dev)
    ok = torch.empty(m, dtype=torch.bool, device=dev)
    hdr = [m, int(mode == "fold"), len(keys),
           0 if valid is None else valid.data_ptr(), h.data_ptr(),
           ok.data_ptr()]
    for k, nl in zip(keys, nulls):
        hdr += [k.data_ptr(), 0 if nl is None else nl.data_ptr()]
    _launch("radix_hash_run", hdr, dev)
    return h, ok


def smem_bytes(nb: int) -> int:
    """A tile block's dynamic shared memory at `nb` buckets (csrc
    rx_smem_bytes): per-warp bucket counts, the tile's bucket starts and
    ends, the buckets' slot bases, the sorted permutation with its buckets,
    and one column's tile window of 8-byte elements."""
    glob = ((WARPS + 2) * nb * 4 + 15) & ~15
    perm = (glob + nb * 8 + 15) & ~15
    return perm + TILE * 4 + TILE * 8


def launch_plan(m: int, nb: int, cap: int) -> dict:
    """One partition call's launch: ``n_tiles`` tile blocks (at least one,
    which writes the counts of an empty call), ``n_fill`` fill blocks over
    the ``items`` (bucket, chunk of :data:`FILL_CHUNK` slots) and the
    workspace's words, in ``launches`` launch."""
    n_tiles = max(1, -(-m // TILE))
    items = nb * -(-cap // FILL_CHUNK)
    n_fill = min(items, FILL_BLOCKS)
    return {"n_tiles": n_tiles, "n_fill": n_fill, "items": items,
            "blocks": n_tiles + n_fill,
            "ws_words": WS_STATUS + n_tiles * nb, "launches": 1}


class _Workspace:
    """The partition's workspace on one stream (:data:`WS_STATUS` words,
    then the status words), zeroed once when allocated and grown to the
    largest call.  Every call takes a new epoch, which its status and
    ready words carry, so no launch clears them (the last ticket sets the
    counter back to 0); the lock keeps epochs in stream order across
    threads."""

    __slots__ = ("words", "epoch")

    def __init__(self):
        self.words, self.epoch = None, 0

    def take(self, n_words: int, dev) -> tuple:
        """(workspace pointer, epoch) of the next call."""
        if self.words is None or self.words.numel() < n_words:
            size = n_words if self.words is None else max(
                n_words, 2 * self.words.numel())
            self.words = torch.zeros(size, dtype=torch.int64, device=dev)
        if self.epoch >= EPOCH_LIMIT:
            self.words.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.words.data_ptr(), self.epoch


_WS: dict = {}
_WS_LOCK = threading.Lock()


def pack_header(m, n_dest, n_sub, cap, h_ptr, valid_ptr, plan, epoch, ws,
                flags, rows, slot_valid, cols) -> np.ndarray:
    """``radix_partition_run``'s header: [m, n_dest, n_sub, cap, h, valid,
    n_tiles, n_fill, epoch, ws, flags, rows, slot_valid, n_cols, then per
    column: src, dst, element size]; `cols` holds (src pointer, dst
    pointer, element size) per column."""
    hdr = [m, n_dest, n_sub, cap, h_ptr, valid_ptr, plan["n_tiles"],
           plan["n_fill"], epoch, ws, flags, rows, slot_valid, len(cols)]
    for src, dst, es in cols:
        hdr += [src, dst, es]
    return np.asarray(hdr, dtype=np.int64)


def partition(h, valid, n_dest: int, n_sub: int, cap: int, cols=()):
    """The stable radix partition of the rows into the ``n_dest * n_sub *
    cap`` slot grid (see the module note).  h: int64 hash bits; valid:
    bool or None (every row); cols: tensors of 1, 2, 4 or 8-byte
    elements, each as long as h.  Returns a dict: ``rows`` (int64 source
    row per slot), ``valid`` (bool ``slot_valid``), ``cols`` (the columns'
    grids, in order), ``need`` and ``dropped`` (0-d int64)."""
    nb = n_dest * n_sub
    if n_dest < 1 or n_sub < 1 or n_sub & (n_sub - 1):
        raise ValueError("radix_exchange: n_dest >= 1 and n_sub a power "
                         "of two")
    if nb + 1 > MAX_BUCKETS:
        raise ValueError(f"radix_exchange: {nb} buckets (at most "
                         f"{MAX_BUCKETS - 1})")
    if cap < 1:
        raise ValueError("radix_exchange: cap must be positive")
    if h.device.type == "cpu":
        return partition_plain(h, valid, n_dest, n_sub, cap, cols)
    cols = list(cols)
    if len(cols) > MAX_COLS:
        from ..device import DeviceUnsupported
        raise DeviceUnsupported(f"radix_exchange: at most {MAX_COLS} "
                                "columns")
    dev = h.device
    m = h.shape[0]
    if m >= 1 << 31:
        raise ValueError("radix_exchange: at most 2^31 - 1 rows")
    if h.dtype != torch.int64:
        raise TypeError("radix_exchange: hash must be int64")
    if valid is not None and valid.dtype != torch.bool:
        raise TypeError("radix_exchange: validity must be bool")
    _check(dev, [h, valid] + cols, m, "rows")
    for c in cols:
        if c.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"radix_exchange: column dtype {c.dtype}")
    size = nb * cap
    rows = torch.empty(size, dtype=torch.int64, device=dev)
    slot_valid = torch.empty(size, dtype=torch.bool, device=dev)
    outs = [torch.empty(size, dtype=c.dtype, device=dev) for c in cols]
    flags = torch.empty(2, dtype=torch.int64, device=dev)  # need, dropped
    plan = launch_plan(m, nb, cap)
    from . import build
    fn = _fn("radix_partition_run")
    stream = build.raw_stream(dev)
    with _WS_LOCK:
        ws = _WS.get((dev, stream))
        if ws is None:
            ws = _WS[(dev, stream)] = _Workspace()
        ptr, epoch = ws.take(plan["ws_words"], dev)
        hdr = pack_header(
            m, n_dest, n_sub, cap, h.data_ptr(),
            0 if valid is None else valid.data_ptr(), plan, epoch, ptr,
            flags.data_ptr(), rows.data_ptr(), slot_valid.data_ptr(),
            [(c.data_ptr(), o.data_ptr(), c.element_size())
             for c, o in zip(cols, outs)])
        rc = fn(hdr.ctypes.data, ctypes.c_void_p(stream))
    build.check(rc, "radix_partition_run")
    LAUNCHES[0] += 1
    return {"rows": rows, "valid": slot_valid, "cols": outs,
            "need": flags[0], "dropped": flags[1]}
