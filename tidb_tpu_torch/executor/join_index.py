"""Host-built join indexes for the device join path.

The reference probes a hash table built per query execution
(executor/join.go:192 build workers, hash_table.go). On XLA that design
loses twice: hash tables need data-dependent shapes, and the sort-based
replacement re-sorts the build side on EVERY execution. But a join whose
build side is a BASE TABLE scan has a data-dependent part that only
changes when the table version changes — so the expensive part (ordering
the build rows by key) moves to the host, runs ONCE per table version in
numpy, and is cached on the Column exactly like the HBM upload
(utils/chunk.py Column._device). The device-side lookup degenerates to
gathers and searchsorteds — no sort in the compiled program at all.

Two layouts:
- ``dense`` — CSR over the key span (``starts`` of size span+1, ``rows``
  listing valid row ids in key order). Applies when the packed key span
  is within a small factor of the row count: TPC-H keys are dense
  1..N, so every PK/FK join takes this path. Lookup = 2 gathers.
- ``sorted`` — row ids argsorted by packed key + the sorted key array.
  Applies to sparse/composite keys (e.g. partsupp's (partkey, suppkey)
  whose packed span is ~nb²). Lookup = binary search into the
  host-sorted array.

Either layout knows whether the (non-null) build keys are UNIQUE. A
unique build side makes the join output shape the PROBE side's shape —
the expansion pass, its output capacity, and the overflow/recompile
machinery all disappear (TPC-H joins are fact⋈dim = FK⋈unique-PK, so
this is the common case on every north-star query).

Multi-column keys fold into one int64 by range packing with host-known
(min, span) per column — unlike the device-side data-dependent packing
(device_join._combined_join_keys), these are static at trace time.

Version tolerance (ROADMAP "version-tolerant pack"): the per-column
(min, span) is QUANTIZED to a geometric grid (`_quantize_range`) instead
of being exact.  The packs are baked into compiled-fragment signatures
and dense-CSR array shapes (`device_join._strategy_sig`,
`JoinIndex.starts`), so with exact bounds ANY dimension-table delta that
nudged a key's min/max — one UPDATE widening a range by 1 — changed the
signature and forced a full XLA recompile.  With ~1/16-of-magnitude
slack on each end, a delta that stays inside the widened range rebuilds
only the (cheap, numpy) host index and re-uses the compiled fragment:
the lookup arrays are passed as runtime arguments, so same shapes ⇒ same
program.  Correctness is unaffected — probe keys in the slack region
simply find zero matches, exactly like any other unmatched key.

Bucketed shapes + traced n_valid (ROADMAP item 1, the LAST recompile
trigger): the row-id array (and the sorted-key array) pads to a
geometric bucket (ops/device.py bucket_rows) and the live entry count
``n_valid`` rides to the device as a TRACED scalar in the ``jidx``
runtime arguments — never baked into the compiled program.  A build-side
INSERT that stays inside the bucket (and inside the quantized pack
range) rebuilds only this cheap numpy index: same array shapes, same
fragment signature, same compiled executable, zero new XLA compiles.
Padding is inert by construction: ``rows`` pads with 0 (only reachable
behind a ``cnt`` guard that is 0 there) and ``sorted_keys`` pads with
int64 max (sorts after every real key, so probe searchsorted results
for real keys are unchanged and the ``lo < n_valid`` guard kills the
sentinel region).
"""

from __future__ import annotations

import numpy as np

from ..ops.device import bucket_rows

#: dense CSR is worth it while the span stays within this factor of the
#: row count (beyond that the starts array dwarfs the table)
_DENSE_SLACK = 4
_DENSE_FLOOR = 65536

#: pack quantization: grid = 2^(bit_length(span)-1-SLACK_BITS) ≈ span/16
#: (min floors to the grid, max ceils) — ≤ ~12.5% span overshoot buys
#: signature stability across small dimension-table range drifts
_PACK_SLACK_BITS = 4


def _quantize_range(mn: int, mx: int) -> tuple[int, int]:
    """Widen [mn, mx] to a geometric grid so slightly-shifted bounds from
    a future table version land on the SAME packed range."""
    span = mx - mn + 1
    g = 1 << max((span - 1).bit_length() - _PACK_SLACK_BITS, 0)
    mn_q = (mn // g) * g                # floor toward -inf
    mx_q = ((mx // g) + 1) * g - 1      # ceil to the next grid edge - 1
    return mn_q, mx_q


class JoinIndex:
    """Host index over one ordered key-column tuple of a base chunk."""

    __slots__ = ("kind", "packs", "unique", "n_rows", "n_valid", "span",
                 "starts", "rows", "sorted_keys", "avg_cnt", "max_cnt",
                 "rows_len", "_dev")

    def __init__(self):
        self._dev = None

    def device_arrays(self):
        """Upload (lazily, once per device) and return the (a0, a1,
        n_valid) lookup tuple the fragment takes as runtime arguments: the
        CSR starts / sorted keys and the bucket-padded row ids as tensors
        on ``ops.device.device()`` in their host dtypes (int32 while the
        table has fewer than 2^31 rows; the probe and expand kernels read
        int32 and int64 index arrays), and the live entry count as a host
        int.  The upload is keyed by the device and the residency epoch,
        so a ``set_device`` (which bumps the epoch) or a backend fence
        never hands a kernel a tensor of another device."""
        from ..ops import device as dev
        from ..ops import residency
        d = dev.device()
        key = (str(d), residency.device_epoch())
        if self._dev is None or self._dev[0] != key:
            a0 = self.starts if self.kind == "dense" else self.sorted_keys
            self._dev = (key, (dev.upload(a0, d), dev.upload(self.rows, d),
                               int(self.n_valid)))
        return self._dev[1]

    def upload_bytes(self) -> int:
        """Bytes :meth:`device_arrays` moves to the device."""
        a0 = self.starts if self.kind == "dense" else self.sorted_keys
        return int(a0.nbytes + self.rows.nbytes)


def _pack_host(datas, valid, packs):
    """Fold key columns into one int64 per row (valid rows only are
    meaningful; invalid rows fold to arbitrary in-range values)."""
    packed = np.zeros(len(datas[0]), dtype=np.int64)
    for d, (mn, span) in zip(datas, packs):
        v = d.astype(np.int64) - mn
        np.clip(v, 0, span - 1, out=v)
        packed = packed * span + v
    return packed


def build_join_index(columns, mask_fn=None, cache_tag="", packs=None,
                     force_sorted=False,
                     pad_rows=None) -> "JoinIndex | None":
    """Index over `columns` (utils.chunk.Column tuple, int-kinded numpy
    data), cached on columns[0]. None when the keys can't range-pack into
    int64 (caller falls back to the device-side sort join).

    mask_fn/cache_tag: optional build-side FILTER — the leaf's pushed-down
    predicates evaluated host-side (lazily, only on cache miss). A
    filtered index drops non-qualifying rows from the CSR counts, so an
    expansion join's capacity tracks the SELECTED rows, not the raw table
    (TPC-H Q5's orders⋈customer leg shrinks ~7x: the date filter keeps
    15% of orders but an unfiltered count expands all of them). The tag
    keys the cache per predicate set; one Column can hold one index at a
    time (queries alternating predicate sets rebuild — numpy, cheap).

    packs / force_sorted / pad_rows override the shape-determining
    choices for PARTITIONED builds (executor/hybrid_join.py): every radix
    partition of one hybrid join must carry the SAME per-column (min,
    span) packs, the same layout kind and the same padded array length —
    otherwise each partition would bake its own shapes into the fragment
    signature and the zero-recompile invariant would die P ways.  `packs`
    are the whole-table quantized ranges (probe keys outside a
    partition's narrower true range simply find no match); force_sorted
    skips the dense-CSR layout (a per-partition `starts` array spans the
    WHOLE key range — P copies of it would dwarf the data); `pad_rows`
    floors the bucket so all partitions pad to the largest one's."""
    host = columns[0]
    # the cached tuple PINS the column objects: a live reference can never
    # share its id with a newly allocated Column, which is what makes the
    # id()-keyed composite lookup sound (same convention as the pipeline
    # cache's dict_refs, executor/device_exec.py)
    cache_key = (tuple(id(c) for c in columns), cache_tag, packs,
                 force_sorted, pad_rows)
    cached = getattr(host, "_join_index", None)
    if cached is not None and cached[0] == cache_key:
        return cached[1]

    datas = [c.data for c in columns]
    nulls = columns[0].nulls
    for c in columns[1:]:
        nulls = nulls | c.nulls
    valid = ~nulls
    if mask_fn is not None:
        m = mask_fn()
        if m is not None:
            valid = valid & m
    nb = len(datas[0])
    n_valid = int(valid.sum())

    if packs is not None:
        total_span = 1.0
        for _mn, span in packs:
            total_span *= span
        packs = list(packs)
    else:
        packs = []
        total_span = 1.0
        for d in datas:
            dv = d[valid]
            if dv.size == 0:
                mn, mx = 0, 0
            else:
                mn, mx = int(dv.min()), int(dv.max())
            # slack-quantized range: within-slack deltas keep the pack —
            # and therefore the fragment signature and compiled program —
            # stable
            mn, mx = _quantize_range(mn, mx)
            span = mx - mn + 1
            total_span *= span
            packs.append((mn, span))
    if total_span > 2.0**62:
        # the negative entry must pin the columns too — id() keys are
        # only sound while the referenced objects stay alive
        host._join_index = (cache_key, None, tuple(columns))
        return None

    idx = JoinIndex()
    idx.packs = tuple(packs)
    idx.n_rows = nb
    idx.n_valid = n_valid
    span_total = int(total_span)
    idx.span = span_total
    packed = _pack_host(datas, valid, packs)

    row_dt = np.int32 if nb < (1 << 31) else np.int64
    # geometric BUCKET for the row-id (and sorted-key) array shapes: a
    # within-bucket build delta keeps every traced shape — the default
    # granularity (2 buckets per doubling) is fixed here because the
    # index is cached per table version, not per session
    pad_len = bucket_rows(max(n_valid, pad_rows or 1, 1))
    idx.rows_len = pad_len

    def _pad_rows(arr):
        out = np.zeros(pad_len, dtype=row_dt)
        out[:len(arr)] = arr
        return out

    if not force_sorted and span_total <= max(_DENSE_SLACK * nb,
                                              _DENSE_FLOOR):
        idx.kind = "dense"
        counts = np.bincount(packed[valid], minlength=span_total)
        starts = np.empty(span_total + 1, dtype=row_dt)
        starts[0] = 0
        np.cumsum(counts, out=starts[1:])
        # row ids grouped by key: stable argsort with invalid rows parked
        # past every real key
        sort_key = np.where(valid, packed, np.int64(span_total))
        order = np.argsort(sort_key, kind="stable")
        idx.starts = starts
        idx.rows = _pad_rows(order[:n_valid])
        idx.max_cnt = int(counts.max(initial=0))
        idx.unique = idx.max_cnt <= 1
        idx.sorted_keys = None
        idx.avg_cnt = n_valid / max(int(np.count_nonzero(counts)), 1)
    else:
        idx.kind = "sorted"
        sort_key = np.where(valid, packed, np.iinfo(np.int64).max)
        order = np.argsort(sort_key, kind="stable")
        sk = sort_key[order[:n_valid]] if n_valid else np.zeros(
            0, dtype=np.int64)
        # int64-max sentinels on the pad tail sort after every real key:
        # probe searchsorted positions for real keys are unchanged, and
        # the traced lo < n_valid guard excludes the sentinel region
        idx.sorted_keys = np.concatenate(
            [sk, np.full(pad_len - n_valid, np.iinfo(np.int64).max,
                         dtype=np.int64)])
        idx.rows = _pad_rows(order[:n_valid])
        idx.starts = None
        idx.unique = bool(n_valid <= 1 or not np.any(sk[1:] == sk[:-1]))
        n_distinct = (1 + int(np.count_nonzero(sk[1:] != sk[:-1]))
                      if n_valid else 1)
        idx.avg_cnt = n_valid / max(n_distinct, 1)
        if n_valid:
            # longest equal-key run = the hottest key's row count
            bounds = np.flatnonzero(np.concatenate(
                ([True], sk[1:] != sk[:-1], [True])))
            idx.max_cnt = int(np.diff(bounds).max())
        else:
            idx.max_cnt = 0
    host._join_index = (cache_key, idx, tuple(columns))
    return idx
