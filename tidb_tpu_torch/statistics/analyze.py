"""ANALYZE TABLE (reference: executor/analyze.go + statistics/builder.go).

Builds, per column: null count, NDV, min/max, TopN (most frequent values
with exact counts — reference statistics/cmsketch.go:503 TopN), and an
equal-depth histogram (bucket upper bounds + cumulative counts —
reference statistics/histogram.go:50). The whole pass is vectorized
numpy over the columnar cache (the reference samples per region; here
the column is already materialized host-side)."""

from __future__ import annotations

import numpy as np

from ..meta import Meta

HIST_BUCKETS = 64
TOPN_SIZE = 8
CM_DEPTH = 4
CM_WIDTH = 512

def _cm_indices(key) -> list[int]:
    """One 128-bit hash per value; the depth row indices derive from its
    halves (reference: cmsketch.go hashes once with murmur128 and mixes
    h1 + i*h2). Numeric keys canonicalize so int 2 and float 2.0 collide
    deliberately — query constants may arrive as either type."""
    if isinstance(key, float) and key.is_integer():
        key = int(key)
    if isinstance(key, float):
        key = key.hex()
    import hashlib
    digest = hashlib.blake2b(str(key).encode(), digest_size=16).digest()
    h1 = int.from_bytes(digest[:8], "little")
    h2 = int.from_bytes(digest[8:], "little") | 1
    return [((h1 + d * h2) & 0xFFFFFFFFFFFFFFFF) % CM_WIDTH
            for d in range(CM_DEPTH)]


def build_cmsketch(values, counts) -> list[list[int]]:
    """Count-min sketch over (distinct value, count) pairs (reference:
    statistics/cmsketch.go:46): depth×width counters; lookup takes the
    min across rows — an overestimate, never an underestimate.

    Integer and bytes values (every TPC-H column) hash in one pass
    without the per-value key canonicalization of :func:`_cm_indices`
    and fold their counters in numpy: the same counters, several times
    faster on tables of millions of distinct values."""
    payload = _cm_payload(values)
    if payload is None:
        rows = [[0] * CM_WIDTH for _ in range(CM_DEPTH)]
        for v, c in zip(values, counts):
            for d, idx in enumerate(_cm_indices(_val_key(v))):
                rows[d][idx] += int(c)
        return rows
    import hashlib
    blake = hashlib.blake2b
    digests = b"".join([blake(b, digest_size=16).digest() for b in payload])
    h = np.frombuffer(digests, dtype="<u8").reshape(-1, 2)
    h1, h2 = h[:, 0], h[:, 1] | np.uint64(1)
    cnt = np.asarray(counts, dtype=np.int64)
    rows = np.zeros((CM_DEPTH, CM_WIDTH), dtype=np.int64)
    for d in range(CM_DEPTH):
        idx = (h1 + np.uint64(d) * h2) % np.uint64(CM_WIDTH)
        np.add.at(rows[d], idx.astype(np.int64), cnt)
    return rows.tolist()


def _cm_payload(values):
    """The bytes :func:`_cm_indices` hashes for each value, when every
    value is an integer (its decimal string) or bytes (its UTF-8 text,
    decoded and encoded as :func:`_val_key` and ``str`` do); None for any
    other kind (floats keep the per-value path)."""
    arr = np.asarray(values)
    if arr.dtype.kind in "iu":
        return [str(x).encode() for x in arr.tolist()]
    if arr.dtype == object and all(isinstance(v, (bytes, bytearray))
                                   for v in arr):
        return [bytes(v).decode("utf-8", "surrogateescape").encode()
                for v in arr]
    return None


def cm_query(cm: list[list[int]], key) -> int:
    return min(row[idx] for row, idx in zip(cm, _cm_indices(key)))


def _val_key(v):
    """JSON-able representation of an internal value for TopN matching."""
    if isinstance(v, (bytes, bytearray)):
        return v.decode("utf-8", "surrogateescape")
    if isinstance(v, (np.integer, int)):
        return int(v)
    return float(v)


def _column_stats(col):
    nn = ~col.nulls
    cs = {"null_count": int(col.nulls.sum())}
    enc = getattr(col, "_dict", None)
    if enc is not None:
        # dictionary-encoded strings: the distinct values and counts of
        # the codes (the dictionary is sorted, so code order is value
        # order) — np.unique of the object array would compare Python
        # bytes, and a paged column would materialize
        codes, uniq = enc
        ucodes, counts = np.unique(np.asarray(codes)[nn], return_counts=True)
        if not len(ucodes):
            cs["ndv"] = 0
            return cs
        uniques = np.asarray(uniq, dtype=object)[ucodes]
        data = uniques  # dtype object: no min/max/histogram below
    else:
        data = col.data[nn]
        if not len(data):
            cs["ndv"] = 0
            return cs
        uniques, counts = np.unique(data, return_counts=True)
    cs["ndv"] = int(len(uniques))
    # TopN: exact counts for the most frequent values
    k = min(TOPN_SIZE, len(uniques))
    top = np.argpartition(counts, -k)[-k:]
    top = top[np.argsort(counts[top])[::-1]]
    cs["topn"] = [[_val_key(uniques[i]), int(counts[i])] for i in top]
    # CMSketch over the non-TopN remainder: point estimates for values the
    # TopN missed (reference: cmsketch.go TopN+CMSketch split)
    top_set = set(top.tolist())
    rest = [i for i in range(len(uniques)) if i not in top_set]
    if rest:
        cs["cmsketch"] = build_cmsketch(uniques[rest], counts[rest])
    if data.dtype != object:
        vals = data.astype(np.float64)
        cs["min"] = float(vals.min())
        cs["max"] = float(vals.max())
        # equal-depth histogram over the sorted column: bucket upper
        # bounds at quantile positions + cumulative counts
        nb = min(HIST_BUCKETS, len(uniques))
        if nb >= 2:
            sv = np.sort(vals)
            pos = ((np.arange(1, nb + 1) * len(sv)) // nb) - 1
            bounds = sv[pos]
            cum = np.searchsorted(sv, bounds, side="right")
            cs["hist"] = {"bounds": [float(b) for b in bounds],
                          "cum": [int(c) for c in cum]}
    return cs


def _index_stats(info, cols, chunk):
    """Per-index prefix NDVs (reference: index stats built by ANALYZE in
    statistics/builder.go; consumed by access-path and join cardinality).
    prefix_ndv[k] = NDV of the first k+1 index columns as a tuple, with
    NULL counting as one distinct value. Computed by iterative
    code-densification so intermediate keys never overflow int64."""
    from ..model import SchemaState
    name2pos = {ci.name: i for i, ci in enumerate(cols)}
    out = {}
    n = chunk.num_rows
    for idx in info.indexes:
        if idx.state != SchemaState.PUBLIC:
            continue
        combined = np.zeros(n, dtype=np.int64)
        prefix_ndv = []
        ok = True
        for icol in idx.columns:
            pos = name2pos.get(icol.name)
            if pos is None:
                ok = False
                break
            col = chunk.columns[pos]
            if n:
                u, inv = np.unique(col.data, return_inverse=True)
                inv = inv.astype(np.int64) + 1
                inv[col.nulls] = 0
                combined = combined * (len(u) + 2) + inv
                _, combined = np.unique(combined, return_inverse=True)
                prefix_ndv.append(int(combined.max()) + 1)
            else:
                prefix_ndv.append(0)
        if ok and prefix_ndv:
            out[str(idx.id)] = {"name": idx.name, "prefix_ndv": prefix_ndv}
    return out


#: paged tables larger than this are analyzed from evenly-spaced sample
#: blocks (reference: ANALYZE samples per region rather than full-scanning
#: — statistics/builder.go; a 600M-row memmap must not be np.unique'd)
SAMPLE_CAP = 1 << 22
_SAMPLE_BLOCKS = 16


def _sampled_chunk(chunk, cap):
    """Evenly-spaced contiguous blocks totaling ~cap rows: contiguous
    slices read whole memmap pages (sequential IO), and spacing the blocks
    over the file keeps generation-order skew out of the sample."""
    from ..utils.chunk import concat_chunks
    n = chunk.num_rows
    block = max(cap // _SAMPLE_BLOCKS, 1)
    stride = max(n // _SAMPLE_BLOCKS, block)
    parts = []
    for b in range(_SAMPLE_BLOCKS):
        lo = min(b * stride, n)
        hi = min(lo + block, n)
        if hi > lo:
            parts.append(chunk.slice(lo, hi))
    return concat_chunks(parts)


def _rescale_column_stats(cs, factor, n):
    """Scale sampled per-column stats to the full table. NDV scaling uses
    the key-vs-category heuristic: a sample whose values are mostly
    distinct extrapolates linearly (key-like); a saturated small domain
    stays as observed."""
    if factor <= 1.0:
        return cs
    sample_nonnull = cs.pop("_sample_rows", None)
    cs["null_count"] = int(cs["null_count"] * factor)
    ndv = cs.get("ndv", 0)
    if sample_nonnull and ndv > 0.1 * sample_nonnull:
        cs["ndv"] = min(int(ndv * factor), n)
    if "topn" in cs:
        cs["topn"] = [[v, int(c * factor)] for v, c in cs["topn"]]
    if "hist" in cs:
        cs["hist"]["cum"] = [int(c * factor) for c in cs["hist"]["cum"]]
    return cs


def analyze_table(session, info):
    cache = session.columnar_cache()
    cols = info.public_columns()
    entry = cache.get(info, session.store.begin())
    if entry is not None:
        chunk = cache.project(entry, cols, info)
    else:  # unreachable with a fresh snapshot, but never skip ANALYZE
        from ..table import Table
        chunk = Table(info, session.store.begin()).scan_columnar(
            col_infos=cols)
    n = chunk.num_rows
    from ..storage.paged import chunk_is_paged
    factor = 1.0
    if n > SAMPLE_CAP and chunk_is_paged(chunk):
        chunk = _sampled_chunk(chunk, SAMPLE_CAP)
        factor = n / max(chunk.num_rows, 1)
    stats = {"row_count": int(n), "columns": {}}
    if factor > 1.0:
        stats["sampled_rows"] = int(chunk.num_rows)
    for ci, col in zip(cols, chunk.columns):
        cs = _column_stats(col)
        cs["_sample_rows"] = chunk.num_rows - cs["null_count"]
        stats["columns"][str(ci.id)] = _rescale_column_stats(
            cs, factor, int(n))
        stats["columns"][str(ci.id)].pop("_sample_rows", None)
    stats["indexes"] = _index_stats(info, cols, chunk)
    if factor > 1.0:
        # index prefix NDVs share the column key-vs-category extrapolation
        # (a unique index's sampled NDV ~= sample size must scale to the
        # table, or per-key row estimates inflate by the sample factor)
        sample_n = chunk.num_rows
        for ix in stats["indexes"].values():
            ix["prefix_ndv"] = [
                min(int(v * factor), int(n)) if v > 0.1 * sample_n else v
                for v in ix["prefix_ndv"]]
    txn = session.store.begin()
    try:
        m = Meta(txn)
        m.set_stats(info.id, stats)
        txn.commit()
    except Exception:
        txn.rollback()
        raise
    session.domain.stats[info.id] = stats
    session.domain.stats_version += 1  # invalidate cached plans
    return stats
