"""K4: top-k of group slots by a multi-key order, and the key order of the
hash aggregate's groups, of a join's build side and of a window's rows.

The order (``tidb_tpu/executor/device_exec.py:711 _topk_indices``): slots
at or past the live count sort behind every live slot; then each key in
turn by its null rank and its value — ints descending by bitwise NOT,
floats descending by negation, -0 equal to +0 and NaN after +inf in both
directions; ties fall to the slot index.

:func:`sort_indices` runs ``csrc/sort_topk.cu`` on CUDA tensors and
:func:`sort_plain` (successive stable ``torch.argsort`` calls, minor key
first, as ``jnp.lexsort`` does) on CPU tensors.

The CUDA sort is a stable LSD radix sort over a bit-packed composite key.
:func:`pack_layout` decides the packing from each key's range (one small
device-to-host read of the keys' minima, maxima and NULL counts per
sort); :func:`key_stats_plain` and :func:`pack_words_plain` are the
statistics and the packing in plain PyTorch, whose words the CPU tests
sort one at a time and hold to :func:`sort_plain` and to the reference.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

#: launches of the CUDA kernel from the top-k entry (the aggregate's own
#: group ordering calls the kernel without counting here)
LAUNCHES = [0]

MAX_KEYS = 16

#: radix digit width; every 64-bit word of the composite key is sorted in
#: at most 64 / DIGIT_BITS passes
DIGIT_BITS = 8
#: keys one block of the onesweep pass ranks (csrc SK_TILE)
TILE = 256 * 16
#: bytes of the workspace ahead of the look-back status words (csrc
#: SK_WS_HEAD): histograms, bin bases, pass control, tile counters
WS_HEAD = 20480
#: byte offset of the pass control words in the workspace (csrc
#: SK_WS_CTRL): the current buffer, the identity flag, then per pass its
#: source buffer, skip flag and identity flag
WS_CTRL = 16384
#: status words per tile: one per digit value (csrc SK_BINS)
BINS = 256

_U64 = (1 << 64) - 1
_I64_MIN = -(1 << 63)


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


# -- the packed composite key ------------------------------------------------

def _i64(u: int) -> int:
    """The int64 whose bits are the uint64 `u`."""
    return u - (1 << 64) if u >= 1 << 63 else u


def order_key_plain(d, desc: bool):
    """Each value's order-preserving uint64, as int64 bits (csrc
    ``order_key``): ints NOT-ed when descending and their sign bit
    flipped; floats negated when descending, -0 made +0, every NaN one
    NaN above +inf, then the IEEE bit trick."""
    if not d.is_floating_point():
        w = ~d if desc else d
        return w ^ _I64_MIN
    x = -d if desc else d
    x = torch.where(x == 0, torch.zeros((), dtype=x.dtype), x)
    b = x.contiguous().view(torch.int64)
    b = torch.where(torch.isnan(x),
                    torch.full((), 0x7ff8000000000000, dtype=torch.int64),
                    b)
    return torch.where(b < 0, ~b, b | _I64_MIN)


def key_stats_plain(cols, nulls, descs, length: int):
    """Per key, over the slots [0, length): the least and the greatest
    order key of the non-NULL slots (Python ints in [0, 2^64); 2^64 - 1
    and 0 when every slot is NULL) and the count of NULL slots (csrc
    ``sk_stats``)."""
    mins, maxs, n_null = [], [], []
    for d, nl, desc in zip(cols, nulls, descs):
        nl = nl[:length].to(torch.bool)
        s = order_key_plain(d[:length], desc)[~nl] ^ _I64_MIN  # signed order
        if s.numel():
            mins.append(int(s.min()) + (1 << 63))
            maxs.append(int(s.max()) + (1 << 63))
        else:
            mins.append(_U64)
            maxs.append(0)
        n_null.append(int(nl.sum()))
    return mins, maxs, n_null


@dataclass(frozen=True)
class Layout:
    """Where each field of the composite key sits, as bit positions from
    the least significant end: per key (null_pos, null_bits, val_pos,
    val_bits, min_u), the major rank's (pos, bits), the total bits, the
    64-bit words and the digits of each word."""
    keys: tuple
    major: tuple
    bits: int
    words: int
    digits: tuple

    def word_bits(self) -> tuple:
        """Bits used in each word, least significant word first."""
        return tuple(min(64, self.bits - 64 * w) for w in range(self.words))


def pack_layout(mins, maxs, n_null, length: int, ng: int) -> Layout:
    """The composite key of a sort, most significant field first: the
    major rank (1 bit where both live and dead slots exist), then per key
    its null rank (1 bit where the key has both NULL and non-NULL slots)
    and its value's offset from the key's least order key
    (``bit_length(max - min)`` bits; none for one distinct value).  A
    field may straddle two 64-bit words."""
    pos = 0
    keys = []
    for lo, hi, nn in reversed(list(zip(mins, maxs, n_null))):
        val_bits = ((hi - lo) & _U64).bit_length() if nn < length else 0
        null_bits = 1 if 0 < nn < length else 0
        keys.append((pos + val_bits, null_bits, pos, val_bits,
                     lo if nn < length else 0))
        pos += val_bits + null_bits
    major_bits = 1 if 0 < ng < length else 0
    major = (pos, major_bits)
    pos += major_bits
    words = (pos + 63) // 64
    digits = tuple((min(64, pos - 64 * w) + DIGIT_BITS - 1) // DIGIT_BITS
                   for w in range(words))
    return Layout(tuple(reversed(keys)), major, pos, words, digits)


def _lsr(x, s: int):
    """Logical right shift of int64-held uint64 bits."""
    return x if s == 0 else (x >> s) & ((1 << (64 - s)) - 1)


def _place(v, pos: int, bits: int, w: int):
    """The part of a field (values `v` at bits [pos, pos + bits)) that
    falls in word `w`, shifted into place (csrc ``sk_place``)."""
    lo = 64 * w
    if bits == 0 or pos >= lo + 64 or pos + bits <= lo:
        return torch.zeros_like(v)
    return v << (pos - lo) if pos >= lo else _lsr(v, lo - pos)


def pack_words_plain(cols, nulls, descs, nulls_first, length: int, ng: int,
                     layout: Layout):
    """The composite key of every slot [0, length) as `layout.words`
    int64 tensors of uint64 bits, least significant word first (csrc
    ``sk_pack_word``).  A NULL slot's value bits are 0."""
    dev = cols[0].device
    words = [torch.zeros(length, dtype=torch.int64, device=dev)
             for _ in range(layout.words)]
    fields = []
    pos, bits = layout.major
    if bits:
        fields.append((pos, bits, (torch.arange(length, device=dev) >= ng)
                       .to(torch.int64)))
    for d, nl, desc, nf, (npos, nbits, vpos, vbits, lo) in zip(
            cols, nulls, descs, nulls_first, layout.keys):
        nl = nl[:length].to(torch.bool)
        if nbits:
            fields.append((npos, 1, (nl != nf).to(torch.int64)))
        if vbits:
            off = order_key_plain(d[:length], desc) - _i64(lo)
            fields.append((vpos, vbits, torch.where(
                nl, torch.zeros((), dtype=torch.int64, device=dev), off)))
    for w in range(layout.words):
        for pos, bits, v in fields:
            words[w] |= _place(v, pos, bits, w)
    return words


# -- the CUDA sort -------------------------------------------------------------

_FNS = {}


def _fn(name, n_args):
    if name not in _FNS:
        from . import build
        _FNS[name] = build.declare(name, n_args)
    return _FNS[name]


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
    from ..device import DeviceUnsupported
    if len(cols) > MAX_KEYS:
        raise DeviceUnsupported(f"sort_topk: at most {MAX_KEYS} keys on "
                                "the device")
    if length >= 1 << 32:
        raise DeviceUnsupported("sort_topk: at most 2^32 - 1 slots (the "
                                "sort carries uint32 slot indices)")


def _sort_cuda(cols, nulls, descs, nulls_first, length: int, ng: int,
               info=None):
    """Launch the radix sort; returns `length` indices, the slots in
    order.  A dict passed as `info` receives the layout, and after a
    synchronise the passes that ran (``passes``) and were skipped."""
    from . import build
    _check(cols, nulls, length)
    dev = cols[0].device
    out = torch.empty(length, dtype=torch.int64, device=dev)
    if length == 0:
        return out
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    S = len(cols)
    stats = torch.empty(3 * S, dtype=torch.int64, device=dev)
    hdr = [S, length, stats.data_ptr()]
    for d, nl, desc in zip(cols, nulls, descs):
        hdr += [d.data_ptr(), nl.data_ptr(), int(d.is_floating_point()),
                int(bool(desc))]
    hdr = np.asarray(hdr, dtype=np.int64)
    build.check(build.launch(dev, _fn("sort_keys_stats", 2), hdr.ctypes.data,
                             stream), "sort_keys_stats")
    # scratch for every layout, allocated while the statistics run
    n_tiles = (length + TILE - 1) // TILE
    ws = torch.empty(WS_HEAD + n_tiles * BINS * 8, dtype=torch.uint8,
                     device=dev)
    kbuf = torch.empty((2, length), dtype=torch.int64, device=dev)
    vbuf = torch.empty((2, length), dtype=torch.int32, device=dev)
    st = [int(x) for x in stats.cpu().numpy().view(np.uint64)]
    layout = pack_layout(st[:S], st[S:2 * S], st[2 * S:], length, ng)
    mpos, mbits = layout.major
    hdr = [S, length, ng, layout.bits, layout.words, n_tiles, ws.data_ptr(),
           kbuf[0].data_ptr(), kbuf[1].data_ptr(), vbuf[0].data_ptr(),
           vbuf[1].data_ptr(), out.data_ptr(), mpos, mbits]
    hdr += list(layout.digits)
    for d, nl, desc, nf, (npos, nbits, vpos, vbits, lo) in zip(
            cols, nulls, descs, nulls_first, layout.keys):
        hdr += [d.data_ptr(), nl.data_ptr(), int(d.is_floating_point()),
                int(bool(desc)), int(bool(nf)), npos, nbits, vpos, vbits,
                _i64(lo)]
    hdr = np.asarray(hdr, dtype=np.int64)
    build.check(build.launch(dev, _fn("sort_keys_run", 2), hdr.ctypes.data,
                             stream), "sort_keys_run")
    if info is not None:
        n_pass = sum(layout.digits)
        ctrl = ws[WS_CTRL:WS_CTRL + 4 * (2 + 3 * n_pass)].view(torch.int32)
        skipped = ctrl[2:].view(-1, 3)[:, 1].cpu().tolist()
        info.update(layout=layout, word_bits=layout.word_bits(),
                    digit_passes=n_pass, passes=n_pass - sum(skipped),
                    skipped=[i for i, s in enumerate(skipped) if s])
    return out


def sort_indices(cols, nulls, descs, nulls_first, length: int, ng: int,
                 k: int):
    """The first `k` slots of [0, length) in sort order.  cols: int64 or
    float64 per key; nulls: bool per key; descs / nulls_first: per key;
    slots at index >= ng sort after every live slot."""
    if not cols or cols[0].device.type == "cpu":
        return sort_plain(cols, nulls, descs, nulls_first, length, ng)[:k]
    idx = _sort_cuda(cols, nulls, descs, nulls_first, length, ng)
    if length:
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
