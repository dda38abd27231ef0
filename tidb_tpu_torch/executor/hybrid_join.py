"""Memory-adaptive hybrid hash join on the H100 (reference:
``tidb_tpu/executor/hybrid_join.py``): radix spill + host/device
co-processing instead of whole-fragment surrender.

A join whose build side exceeds the device memory budget (several
resource groups sharing one card, or an operator's
``tidb_device_mem_budget``) would otherwise decline the WHOLE fragment to
the host engine.  Per "Design Trade-offs for a Robust Dynamic Hybrid Hash
Join" (PAPERS.md) partition-granular spilling beats that binary degrade;
per "Revisiting Co-Processing for Hash Joins on the Coupled CPU-GPU
Architecture" (PAPERS.md) the host works the spilled partitions
CONCURRENTLY with the device.

Mechanism, end to end:

1. **Radix partition the build side** on the host with the mix64 radix
   split of the MPP exchange (murmur3 fmix64, destination from the
   hash's high 32 bits).  The fanout is the smallest power of two whose
   largest partition — estimated from a first-page histogram — fits the
   residency ledger's LIVE per-tenant free share
   (``ops/residency.free_share_bytes``).
2. **Device-resident vs spilled split**: the partitions that fit are
   uploaded as bucket-padded sorted join indexes
   (``join_index.build_join_index`` with the whole-table packs, forced
   'sorted' layout and a common pad bucket, so one fragment program
   serves every partition).  Overflow partitions spill their used build
   columns to host columnar pages (``storage/paged.SpillSet``), drained
   unconditionally in the exit path.
3. **One device probe pass + concurrent host pass**: the probe side
   partitions by the SAME hash.  Each device partition's probe rows
   stream in pages through the page stager's pinned ring
   (``ops/stream.py``, rows gathered straight into the pinned buffers);
   every page runs the join fragment with its aggregate on the card —
   K2 (leaf filters, LOADG), K5a (the sorted unique probe of the
   partition index, dense probes for the dimensions), K5b's count and K1
   — with the capacity retry of the paged probe join, and the page
   states fold on the card through the partial-state merge
   (``ops/kernels/merge_states.py``).  Meanwhile a supervisor worker
   (``executor/supervisor.submit_coproc``, under the ONE admission ticket
   run_device already holds) joins the spilled partitions in numpy with
   the host expression engine and folds them into numpy partial states
   (``device_exec._merge_states_host``); the worker never touches the
   card.
4. **Final merge**: the host states are uploaded and folded with the
   device state in ONE merge call, device first, then the host states in
   partition order — so ``first`` keeps the reference's representative
   row — before the usual fetch (K4 under a top-N) and assembly.
5. **Cost-based split point**: the device/host assignment consults the
   measured probe-pass throughput of previous runs (the
   ``hj_probe_device_seconds`` / ``hj_probe_host_seconds`` histograms
   and a per-fragment throughput store) and the live breaker state: a
   device that is currently losing sheds partitions host-ward.

Observability: spans ``join.partition`` / ``join.spill`` /
``join.probe_device`` / ``join.probe_host`` with a classified
``join.spill_decision`` event at every split; gauges ``hj_partitions``,
``hj_spilled_partitions``, ``hj_spill_bytes``, ``hj_coproc_host_rows``
in EXPLAIN ANALYZE annotations and /metrics; ``LAST_PAGED_STATS`` of
kind "hybrid" carries the device pass's pages, H2D bytes and copy time,
the partition / device-pass / host-pass / host-wait seconds; failpoint
``device-join-spill`` (storage/paged.SpillSet.write).
"""

from __future__ import annotations

import collections
import threading
import time
import weakref

import numpy as np

from ..expression import phys_kind, K_STR, K_FLOAT
from ..expression.core import Column as ExprColumn
from ..ops import device as dev
from ..ops.device import DeviceUnsupported
from ..session import tracing
from .join_index import JoinIndex, _quantize_range, build_join_index

#: fanout bounds: at least split in half, at most this many partitions
#: (beyond it the per-partition dispatch overhead dwarfs the work)
_MAX_FANOUT = 128

#: first-page histogram sample rows for the fanout estimate
_HIST_SAMPLE = 1 << 16

#: device bytes per index row (int64 sorted keys + int32 row ids)
_IDX_ROW_BYTES = 12

#: guards STATS and the _THROUGHPUT store: hybrid runs complete on
#: concurrent session/supervisor threads, and lock-free += on the
#: lifetime counters would lose increments (the gauge/bench consumers
#: read deltas)
_LOCK = threading.Lock()

STATS = {
    "hj_runs": 0,                 # hybrid executions completed
    "hj_partitions": 0,           # last run's fanout
    "hj_spilled_partitions": 0,   # last run's host-side partition count
    "hj_spill_bytes": 0,          # last run's spilled page bytes
    "hj_coproc_host_rows": 0,     # last run's rows joined host-side
    "hj_aborts": 0,               # hybrid runs abandoned mid-flight
}

#: observe-registry sinks mirroring the gauges (residency.py pattern)
_SINKS: "weakref.WeakSet" = weakref.WeakSet()

#: measured probe throughput per fragment signature (rows/s EWMA for the
#: device and host halves) — the cost-based split point's memory.  Fed
#: from the same wall-clock the hj_probe_*_seconds histograms record.
_THROUGHPUT: "collections.OrderedDict" = collections.OrderedDict()
_THROUGHPUT_MAX = 512


def attach(ctx):
    dom = getattr(ctx, "domain", None)
    obs = getattr(dom, "observe", None)
    if obs is not None and hasattr(obs, "set_gauge"):
        with _LOCK:
            _SINKS.add(obs)


def _publish_gauges():
    with _LOCK:
        sinks = list(_SINKS)
        vals = {"hj_partitions": STATS["hj_partitions"],
                "hj_spilled_partitions": STATS["hj_spilled_partitions"],
                "hj_spill_bytes": STATS["hj_spill_bytes"],
                "hj_coproc_host_rows": STATS["hj_coproc_host_rows"]}
    for obs in sinks:
        try:
            for k, v in vals.items():
                obs.set_gauge(k, v)
        except Exception:
            pass


def snapshot() -> dict:
    from ..storage.paged import spill_outstanding
    with _LOCK:
        out = dict(STATS)
    sp = spill_outstanding()
    out.update({"spill_open_sets": sp["open_sets"],
                "spill_open_bytes": sp["open_bytes"]})
    return out


def report_gauges() -> dict:
    """EXPLAIN ANALYZE / bench surfacing policy: the hybrid gauges appear
    once the path has ever run (spill is the exception, not annotation
    noise on every healthy resident-build plan)."""
    with _LOCK:
        if not STATS["hj_runs"]:
            return {}
        return {"hj_partitions": STATS["hj_partitions"],
                "hj_spilled_partitions": STATS["hj_spilled_partitions"],
                "hj_spill_bytes": STATS["hj_spill_bytes"],
                "hj_coproc_host_rows": STATS["hj_coproc_host_rows"]}


def _observe_hist(name, value, ctx):
    obs = getattr(getattr(ctx, "domain", None), "observe", None)
    if obs is not None and hasattr(obs, "observe_hist"):
        obs.observe_hist(name, value)


# ---------------------------------------------------------------------------
# the mix64 radix split (host numpy)
# ---------------------------------------------------------------------------

def _mix64_np(k: np.ndarray) -> np.ndarray:
    """murmur3 fmix64 over int64 lanes — the MPP exchange's mix, so a
    mesh-side repartition of the same keys lands in the same layout."""
    with np.errstate(over="ignore"):
        u = k.astype(np.uint64)
        u = u ^ (u >> np.uint64(33))
        u = u * np.uint64(0xFF51AFD7ED558CCD)
        u = u ^ (u >> np.uint64(33))
        u = u * np.uint64(0xC4CEB9FE1A85EC53)
        u = u ^ (u >> np.uint64(33))
    return u


def _part_ids(packed: np.ndarray, ok: np.ndarray, n_parts: int):
    """Partition id per row from the mixed hash's HIGH bits (the radix
    bucket destination fold); rows that cannot match (~ok) park at -1
    and are dropped from both passes."""
    h = _mix64_np(packed)
    pid = ((h >> np.uint64(32)) % np.uint64(n_parts)).astype(np.int64)
    return np.where(ok, pid, -1)


def _pack_keys_np(datas, nulls, packs):
    """Probe-side host packing with the device probe's packing semantics:
    rows whose key is NULL or outside the build's packed range cannot
    match — excluded via `ok`, clamped so the arithmetic never wraps."""
    n = len(datas[0])
    ok = np.ones(n, dtype=bool)
    key = np.zeros(n, dtype=np.int64)
    for d, nl, (mn, span) in zip(datas, nulls, packs):
        v = np.asarray(d).astype(np.int64) - mn
        ok &= ~np.asarray(nl) & (v >= 0) & (v < span)
        key = key * span + np.clip(v, 0, span - 1)
    return key, ok


def _split_by_pid(pid: np.ndarray, n_parts: int):
    """pid array -> list of row-index arrays per partition (one stable
    argsort, not P scans); pid -1 rows are dropped."""
    order = np.argsort(pid, kind="stable")
    sp = pid[order]
    bounds = np.searchsorted(sp, np.arange(n_parts + 1))
    return [order[bounds[p]:bounds[p + 1]] for p in range(n_parts)]


# ---------------------------------------------------------------------------
# host-pass expression surface
# ---------------------------------------------------------------------------

class _GChunk:
    """Chunk shim over the fragment's GLOBAL column space for host-side
    expression evaluation: a plain list with gaps (never-touched columns
    stay None — an expression reaching one is a planning bug and fails
    loudly), plus the row count Constant.eval broadcasts against."""

    __slots__ = ("columns", "_n")

    def __init__(self, columns, n):
        self.columns = columns
        self._n = n

    @property
    def num_rows(self):
        return self._n

    @property
    def num_cols(self):
        return len(self.columns)


class _RowSet:
    """The host pass's joined row set: per-leaf row indices into per-leaf
    column PROVIDERS (the probe/dim base chunks, or a spilled partition's
    reconstructed columns), with lazily gathered global columns.  Joins
    append leaves; filters narrow every leaf's rows in lockstep."""

    def __init__(self, providers, leaves, total_ncols):
        self.providers = providers      # leaf_id -> list[Column]
        self.leaves = {lf.leaf_id: lf for lf in leaves}
        self.rows = {}                  # leaf_id -> np.ndarray row idx
        self.n = 0
        self.total_ncols = total_ncols
        self._cache = {}                # global idx -> Column

    def set_rows(self, leaf_id, idx):
        self.rows[leaf_id] = idx
        self.n = len(idx)
        self._cache.clear()

    def filter(self, keep):
        for lid in self.rows:
            self.rows[lid] = self.rows[lid][keep]
        self.n = int(keep.sum()) if keep.dtype == bool else len(keep)
        self._cache.clear()

    def _leaf_of(self, g):
        for lf in self.leaves.values():
            if lf.offset <= g < lf.offset + lf.ncols:
                return lf
        raise KeyError(g)

    def col(self, g):
        c = self._cache.get(g)
        if c is None:
            lf = self._leaf_of(g)
            src = self.providers[lf.leaf_id][g - lf.offset]
            c = src.take(self.rows[lf.leaf_id])
            self._cache[g] = c
        return c

    def gchunk(self, exprs) -> _GChunk:
        used = set()
        for e in exprs:
            e.columns_used(used)
        cols = [None] * self.total_ncols
        for g in used:
            cols[g] = self.col(g)
        return _GChunk(cols, self.n)

    def codes(self, g):
        """(codes, nulls, key_dict) of a STRING column in the SAME code
        space the device's compile_str_expr uses (meta_device_col's
        branch: collation classes for _ci, plain sorted dictionary
        otherwise) — gathered from the ORIGINAL provider column so host
        and device partitions agree code-for-code."""
        from ..utils.collate import is_ci
        lf = self._leaf_of(g)
        src = self.providers[lf.leaf_id][g - lf.offset]
        idx = self.rows[lf.leaf_id]
        if is_ci(src.ftype.collate):
            ci_codes, key_dict, _reps = src.dict_encode_ci(src.ftype.collate)
            return (np.asarray(ci_codes)[idx],
                    np.asarray(src.nulls)[idx], key_dict)
        codes, uniq = src.dict_encode()
        return np.asarray(codes)[idx], np.asarray(src.nulls)[idx], uniq


def _host_lookup_uniq(idx: JoinIndex, key: np.ndarray, ok: np.ndarray):
    """numpy mirror of the fragment's unique-index probe (K5a's 'uniq'
    mode): (hit, build_row)."""
    if idx.kind == "dense":
        k = np.clip(key, 0, idx.span - 1)
        pos0 = idx.starts[k].astype(np.int64)
        cnt = idx.starts[k + 1].astype(np.int64) - pos0
        hit = ok & (cnt > 0)
        safe = np.clip(pos0, 0, max(idx.rows_len - 1, 0))
        return hit, idx.rows[safe].astype(np.int64)
    sk = idx.sorted_keys
    lo = np.searchsorted(sk[:idx.n_valid], key, side="left")
    lo_c = np.clip(lo, 0, max(idx.rows_len - 1, 0))
    hit = ok & (lo < idx.n_valid)
    if idx.n_valid:
        hit = hit & (sk[np.clip(lo, 0, idx.n_valid - 1)] == key)
    else:
        hit = np.zeros_like(ok)
    return hit, idx.rows[lo_c].astype(np.int64)


def _eval_key_cols(rs: _RowSet, exprs):
    """Evaluate join-key expressions over the row set (host engine)."""
    ch = rs.gchunk(exprs)
    out = []
    for e in exprs:
        d, nl = e.eval(ch)
        d = np.asarray(d)
        if d.shape == ():
            d = np.broadcast_to(d, (rs.n,))
        nl = np.broadcast_to(np.asarray(nl), (rs.n,))
        out.append((d, nl))
    return out


def _conds_mask(rs: _RowSet, conds) -> np.ndarray:
    ch = rs.gchunk(conds)
    mask = np.ones(rs.n, dtype=bool)
    for c in conds:
        d, nl = c.eval(ch)
        mask &= (np.asarray(d) != 0) & ~np.asarray(nl)
    return mask


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def hybrid_join_agg(root, leaves, joins, probe, big_id, agg_plan,
                    agg_conds, ctx):
    """Execute the fragment as a hybrid hash join: the `big_id` leaf (a
    build side larger than the residency budget) radix-partitions; the
    fitting partitions probe on the card, the spilled ones on the host,
    concurrently.  Raises DeviceUnsupported when the fragment is outside
    the hybrid language (the caller falls through to the existing
    paths)."""
    from .device_join import (_fragment_used_cols, _leaf_meta,
                              fragment_sig)
    from .device_exec import _MERGE_OPS, _plan_agg
    attach(ctx)
    big = next(lf for lf in leaves if lf.leaf_id == big_id)
    t_all = time.perf_counter()

    with tracing.span("join.partition", big_rows=big.chunk.num_rows,
                      leaves=len(leaves)):
        # -- language gates (capability raises inside the span so the
        #    trace-coverage rule sees every degradation decision) --------
        big_jn = None
        for jn in joins:
            if jn.kind != "inner" or jn.strategy is None \
                    or jn.strategy[0] != "uniq" or jn.strategy[1] != "right":
                raise DeviceUnsupported(
                    "hybrid join requires an all-unique right-build chain")
            if jn.right is big:
                big_jn = jn
        if big_jn is None or big is probe:
            raise DeviceUnsupported("partitioned leaf is not a build side")

        # probe-side keys of the partitioned join must be bare columns of
        # the probe LEAF: the radix split of the probe happens before any
        # join, so the keys must be computable from the base table
        off_l = 0 if big_jn.global_keys else big_jn.left.offset
        off_r = 0 if big_jn.global_keys else big_jn.right.offset
        probe_key_local = []
        for k in big_jn.left_keys:
            g = k.idx + off_l if isinstance(k, ExprColumn) else -1
            if not (isinstance(k, ExprColumn)
                    and probe.offset <= g < probe.offset + probe.ncols):
                raise DeviceUnsupported(
                    "hybrid probe keys must be bare probe-leaf columns")
            probe_key_local.append(g - probe.offset)
        build_key_local = []
        for k in big_jn.right_keys:
            g = k.idx + off_r if isinstance(k, ExprColumn) else -1
            if not (isinstance(k, ExprColumn)
                    and big.offset <= g < big.offset + big.ncols):
                raise DeviceUnsupported(
                    "hybrid build keys must be bare build-leaf columns")
            i = g - big.offset
            c = big.chunk.columns[i]
            if c.is_object() or not np.issubdtype(c.data.dtype, np.integer):
                raise DeviceUnsupported("hybrid build keys must be integer")
            build_key_local.append(i)

        # agg planning against metadata-only device columns (no uploads)
        dcols = {lf.offset + i: dc
                 for lf in leaves for i, dc in _leaf_meta(lf).items()}
        agg_meta_full = _plan_agg(agg_plan, dcols)
        key_fns, key_meta, key_pack, val_plan, agg_ops, slots = agg_meta_full
        if any(op not in _MERGE_OPS for op in agg_ops):
            raise DeviceUnsupported("non-mergeable agg in hybrid fragment")
        if key_pack is None:
            raise DeviceUnsupported("unpackable group keys in hybrid "
                                    "fragment")
        for e in agg_plan.group_exprs:
            if phys_kind(e.ftype) == K_STR and not isinstance(e, ExprColumn):
                raise DeviceUnsupported(
                    "hybrid host pass needs bare string group keys")
        host_vals = _host_val_plan(agg_plan)
        merge_ops = tuple(_MERGE_OPS[op] for op in agg_ops)
        agg_meta = (key_fns, val_plan, agg_ops, slots)
        n_keys = max(len(key_fns), 1)
        nvals = len(val_plan)

        used = _fragment_used_cols(leaves, joins, agg_plan, agg_conds)
        for lf in leaves:
            if not any(lf.offset + i in used for i in range(lf.ncols)):
                used.add(lf.offset)

        from ..ops import residency
        share = residency.group_share() or residency.effective_budget()
        if share <= 0:
            raise DeviceUnsupported("hybrid join needs a finite device "
                                    "memory budget")
        from .device_join import _col_row_bytes, _leaf_used_bytes
        big_used = [i for i in range(big.ncols) if big.offset + i in used]
        for i in build_key_local:
            if i not in big_used:
                big_used.append(i)
        per_row = sum(_col_row_bytes(big.chunk.columns[i])
                      for i in big_used)

        # other build leaves must fit resident — only ONE partitioned
        # build per fragment (the paper's hybrid join partitions the one
        # overflowing relation; two would need nested partitioning)
        for lf in leaves:
            if lf.leaf_id in (big.leaf_id, probe.leaf_id):
                continue
            if _leaf_used_bytes(lf, used) > share:
                raise DeviceUnsupported(
                    "second over-budget build side in hybrid fragment")

        # -- build-side partition plan ----------------------------------
        # pre-filter by the leaf's pushed-down conds (host engine): only
        # qualifying rows partition/spill — the fragment and the host
        # pass both re-verify, so this is pure volume reduction
        from .exec_select import eval_conds_mask
        bmask = None
        if big.conds:
            bmask = eval_conds_mask(big.conds, big.chunk)
        key_cols = [big.chunk.columns[i] for i in build_key_local]
        packs = []
        for c in key_cols:
            d = np.asarray(c.data)
            valid = ~np.asarray(c.nulls)
            if bmask is not None:
                valid = valid & bmask
            dv = d[valid]
            mn, mx = (int(dv.min()), int(dv.max())) if dv.size else (0, 0)
            mn, mx = _quantize_range(mn, mx)
            packs.append((mn, mx - mn + 1))
        total_span = 1.0
        for _mn, span in packs:
            total_span *= span
        if total_span > 2.0**62:
            raise DeviceUnsupported("hybrid build keys exceed int64 "
                                    "packing")
        packs = tuple(packs)

        if bmask is not None:
            brows = np.nonzero(bmask)[0]
        else:
            brows = np.arange(big.chunk.num_rows)
        bkey_datas = [np.asarray(c.data)[brows] for c in key_cols]
        bkey_nulls = [np.asarray(c.nulls)[brows] for c in key_cols]
        bkey, bok = _pack_keys_np(bkey_datas, bkey_nulls, packs)

        free = residency.free_share_bytes()
        probe_used = [i for i in range(probe.ncols)
                      if probe.offset + i in used]
        probe_row_bytes = sum(_col_row_bytes(probe.chunk.columns[i])
                              for i in probe_used)
        per_double = dev.shape_buckets(ctx)
        dims_est = 0
        for lf in leaves:
            if lf.leaf_id in (big.leaf_id, probe.leaf_id):
                continue
            dims_est += dev.bucket_rows(lf.chunk.num_rows, per_double) \
                * sum(_col_row_bytes(lf.chunk.columns[i])
                      for i in range(lf.ncols)
                      if lf.offset + i in used)

        n_parts = _pick_fanout(bkey, bok, len(brows), per_row,
                               max(free - dims_est, 1))
        pid_b = _part_ids(bkey, bok, n_parts)
        # NULL/odd build keys can never match an inner probe: park them
        # in partition 0 (the index build drops them as invalid anyway)
        pid_b = np.where(pid_b < 0, 0, pid_b)
        bparts = _split_by_pid(pid_b, n_parts)
        max_part = max((len(p) for p in bparts), default=1)
        build_bucket = dev.bucket_rows(max(max_part, 1))

        # -- probe-side split (same hash, same packs) -------------------
        pkey_datas = [np.asarray(probe.chunk.columns[i].data)
                      for i in probe_key_local]
        pkey_nulls = [np.asarray(probe.chunk.columns[i].nulls)
                      for i in probe_key_local]
        pkey, pok = _pack_keys_np(pkey_datas, pkey_nulls, packs)
        pid_p = _part_ids(pkey, pok, n_parts)
        pparts = _split_by_pid(pid_p, n_parts)
        max_probe = max((len(p) for p in pparts), default=1)
        # the probe side STREAMS through each device partition in pages
        # (the _paged_join_agg convention): the in-flight probe slice —
        # not a whole fact partition — is what the budget reserves, so a
        # fact 4x the build does not starve the device of partitions
        try:
            page_cap = int(ctx.get_sysvar("tidb_device_stream_rows"))
        except Exception:
            page_cap = 0
        if page_cap <= 0:
            from ..storage.paged import DEFAULT_PAGE_ROWS
            page_cap = DEFAULT_PAGE_ROWS
        # self-size the slice to the budget too: the in-flight probe page
        # should cost at most ~a quarter of the free share, or the slice
        # reservation alone starves the device of build partitions
        page_cap = min(page_cap,
                       max((free // 4) // max(probe_row_bytes, 1), 4096))
        probe_bucket = dev.bucket_rows(max(min(max_probe, page_cap), 1))

        # -- cost-based device/host split: the device set must fit the
        # free share RESIDENT TOGETHER through the whole probe pass
        # (dims + in-flight probe slice reserved first) ------------------
        part_cost = build_bucket * (per_row + _IDX_ROW_BYTES)
        probe_cost = probe_bucket * max(probe_row_bytes, 1)
        device_budget = max(free - probe_cost - dims_est, 0)
        n_dev = min(int(device_budget // max(part_cost, 1)), n_parts)
        reason = "memory"
        from .circuit import get_breaker
        br = get_breaker(ctx, shape="join")
        if br.state != "closed" and n_dev > 1:
            n_dev, reason = 1, "breaker"

        # shared shape identity: a stub index carries the fields the
        # fragment program reads from the strategy (kind/packs/unique/
        # rows_len/dtype); the real per-partition arrays ride as runtime
        # jidx arguments
        stub = _part_index_stub(packs, build_bucket, max_part)
        prev_strategy = big_jn.strategy
        big_jn.strategy = ("uniq", "right", stub)
        sig = (fragment_sig(leaves, joins, agg_conds, agg_plan)
               + f"|hyb{n_parts}/{probe_bucket}/{build_bucket}")

        if n_dev > 0 and _compile_pending(ctx, sig, key_pack, agg_ops,
                                          probe_bucket):
            # shift everything host-ward for THIS run, but still kick the
            # build so the next run takes the device share back
            n_dev, reason = 0, "compile_pending"
            _kick_bg_compile(ctx, sig, key_pack, agg_ops, probe_bucket,
                             root, leaves, joins, agg_plan, agg_conds,
                             agg_meta, dcols)
        with _LOCK:
            tp = _THROUGHPUT.get(sig)
        if tp and n_dev > 0:
            n_dev = _balance_split(n_dev, n_parts, pparts, tp)
            if n_dev < min(int(device_budget // max(part_cost, 1)),
                           n_parts):
                reason = "cost"
        # device takes the probe-heaviest partitions it has budget for
        order = sorted(range(n_parts),
                       key=lambda p: (-len(pparts[p]), p))
        dev_pids = sorted(order[:n_dev])
        host_pids = sorted(order[n_dev:])
        tracing.event("join.spill_decision", partitions=n_parts,
                      spilled=len(host_pids), reason=reason,
                      free_share=free, part_cost=part_cost)
    t_part = time.perf_counter() - t_all

    # -- spill the overflow partitions' build pages -------------------------
    from ..storage.paged import SpillSet
    from .device_exec import StreamStats
    spill = SpillSet(tag=f"p{n_parts}")
    host_join = None
    stats = StreamStats("hybrid")
    stats.s["build_h2d_bytes"] = 0  # the device partitions' uploads
    try:
        spilled_bytes = 0
        with tracing.span("join.spill", parts=len(host_pids)):
            for p in host_pids:
                rows = brows[bparts[p]]
                if len(rows) == 0:
                    continue  # no pages: an empty file cannot memmap,
                    #           and an empty build matches nothing anyway
                arrays = {}
                for i in big_used:
                    c = big.chunk.columns[i]
                    if c.is_object():
                        codes, _u = c.dict_encode()
                        d = np.asarray(codes)[rows]
                    else:
                        d = np.asarray(c.data)[rows]
                    arrays[i] = (d, np.asarray(c.nulls)[rows])
                spill.write(p, arrays)
            spilled_bytes = spill.bytes

        # -- kick off the concurrent host pass --------------------------
        from . import supervisor
        if host_pids:
            host_join = supervisor.submit_coproc(
                _host_pass,
                (spill, host_pids, probe, leaves, joins, big, big_jn,
                 pparts, packs, agg_plan, agg_conds, host_vals,
                 tuple(agg_ops), key_pack, merge_ops, n_keys, nvals),
                label="hybrid-join-host")

        # -- device probe pass ------------------------------------------
        dev_state = None
        t_dev0 = time.perf_counter()
        dev_rows = 0
        if dev_pids:
            with tracing.span("join.probe_device", parts=len(dev_pids),
                              bucket=probe_bucket):
                dev_state, dev_rows = _device_pass(
                    ctx, leaves, joins, probe, big, big_jn, brows, bparts,
                    pparts, dev_pids, big_used, probe_used, used,
                    build_key_local, packs, build_bucket, probe_bucket,
                    max_part, agg_meta, agg_conds, key_pack, merge_ops,
                    n_keys, nvals, sig, dcols, root, agg_plan, stats)
        t_dev = time.perf_counter() - t_dev0

        # -- join the host half, merge, assemble ------------------------
        t_host0 = time.perf_counter()
        host_rows = 0
        host_fed = 0
        host_states = []
        if host_join is not None:
            # one-shot: cleared BEFORE the join so a worker-side error
            # cannot make the finally join the SAME finished job again
            # (supervisor._tls_apply would double-merge its stat deltas)
            hj_wait, host_join = host_join, None
            host_states, host_fed, host_rows, t_host_busy = hj_wait(ctx)
        else:
            t_host_busy = 0.0
        t_host_wait = time.perf_counter() - t_host0

        t_fetch0 = time.perf_counter()
        state, ng_cap = _final_merge(dev_state, host_states, stats, sig,
                                     n_keys, nvals, merge_ops, key_pack)
        from .device_exec import AggFetch, _assemble_agg, resolve_topn
        from .device_join import _cap_store_put
        f = AggFetch(state, topn=resolve_topn(agg_plan, slots))
        ng = f.ng
        _cap_store_put((sig, "groups"), ng)
        if ng == 0 and not agg_plan.group_exprs:
            tracing.event("host_degraded", reason="hybrid_empty",
                          shape="join")
            raise DeviceUnsupported("empty global aggregate")
        body = f.body()
        out = _assemble_agg(agg_plan, key_meta, slots, dcols, body,
                            f.out_rows)
        stats.finish(t_fetch0, ng_cap, ng)

        # -- stats / gauges / throughput memory -------------------------
        with _LOCK:
            STATS["hj_runs"] += 1
            STATS["hj_partitions"] = n_parts
            STATS["hj_spilled_partitions"] = len(host_pids)
            STATS["hj_spill_bytes"] = spilled_bytes
            # last-run like its three siblings: a bench/EXPLAIN line must
            # read THIS run's host share, not a lifetime total
            STATS["hj_coproc_host_rows"] = host_rows
        _publish_gauges()
        # only observe a half that actually RAN: recording 0.0 for the
        # idle half would collapse the histogram's p50/p99 toward the
        # first bucket and mislead the very split these series feed
        if dev_pids:
            _observe_hist("hj_probe_device_seconds", t_dev, ctx)
        if host_pids:
            _observe_hist("hj_probe_host_seconds", t_host_busy, ctx)
        _update_throughput(sig, dev_rows, t_dev, host_fed, t_host_busy)
        from .device_join import LAST_PAGED_STATS
        LAST_PAGED_STATS.update({
            "hj_partitions": n_parts,
            "hj_spilled_partitions": len(host_pids),
            "hj_spill_bytes": spilled_bytes,
            "hj_coproc_host_rows": host_rows,
            "hj_partition_s": round(t_part, 3),
            "hj_probe_device_s": round(t_dev, 3),
            "hj_probe_host_s": round(t_host_busy, 3),
            "hj_host_wait_s": round(t_host_wait, 3),
            "hj_total_s": round(time.perf_counter() - t_all, 3)})
        return out
    except BaseException:
        with _LOCK:
            STATS["hj_aborts"] += 1
        raise
    finally:
        big_jn.strategy = prev_strategy
        if host_join is not None:
            # an abort mid-device-pass: drain the worker before deleting
            # the pages it is reading (its result — and error — are moot)
            try:
                host_join(None)
            except BaseException:
                pass
        spill.close()


def _final_merge(dev_state, host_states, stats, sig, n_keys, nvals,
                 merge_ops, key_pack):
    """ONE fold of the device state and the host half's states on the
    device: the device state first, then the host states in partition
    order (the reference's order, so ``first`` keeps its representative
    row).  A single state is taken as is.  Returns (state, capacity)."""
    from .device_join import _CAP_STORE
    like = dev_state
    states = [dev_state] if dev_state is not None else []
    for st in host_states:
        up = _upload_state(st, like)
        like = like or up
        states.append(up)
    if not states:
        tracing.event("host_degraded", reason="hybrid_empty", shape="join")
        raise DeviceUnsupported("empty hybrid fragment input")
    if len(states) == 1:
        return states[0], int(states[0][0][0].shape[0])
    learned = _CAP_STORE.get((sig, "groups"))
    return stats.merge(None, states, dev.next_pow2(max(learned or 16, 16)),
                       n_keys, nvals, merge_ops, key_pack)


def _upload_state(st, like=None):
    """A host half's numpy partial state as a device state for the final
    fold: keys int64, NULL flags bool, each result in the device state's
    dtype (`like`; int64 or float64 by the values' kind without one —
    the kinds K1 emits), n_groups one int64, through pinned memory."""
    import torch
    keys, knulls, res, rnulls, ng, valid = st
    d = dev.device()

    def up(a, dt):
        return dev.upload(np.ascontiguousarray(a, dtype=dt), d)

    out_res = []
    for j, a in enumerate(res):
        if like is not None:
            is_f = like[2][j].dtype == torch.float64
        else:
            is_f = np.issubdtype(np.asarray(a).dtype, np.floating)
        out_res.append(up(a, np.float64 if is_f else np.int64))
    return (tuple(up(k, np.int64) for k in keys),
            tuple(up(kn, bool) for kn in knulls),
            tuple(out_res),
            tuple(up(rn, bool) for rn in rnulls),
            up(np.asarray(ng), np.int64), up(valid, bool))


def _part_index_stub(packs, build_bucket, max_part) -> JoinIndex:
    """A shape-only JoinIndex carrying exactly the fields the fragment
    program reads from a strategy (kind/packs/span/unique/rows_len/
    rows.dtype) — every real partition index is built with the same
    overrides, so the stub's signature IS the partitions' signature."""
    stub = JoinIndex()
    stub.kind = "sorted"
    stub.packs = packs
    stub.unique = True
    stub.span = 0
    stub.n_rows = max_part
    stub.n_valid = 0
    stub.rows_len = dev.bucket_rows(max(max_part, 1))
    stub.rows = np.zeros(0, dtype=np.int32 if max_part < (1 << 31)
                         else np.int64)
    stub.sorted_keys = None
    stub.starts = None
    stub.avg_cnt = 1.0
    stub.max_cnt = 1
    assert stub.rows_len == build_bucket
    return stub


def _pick_fanout(bkey, bok, n_build, per_row, free) -> int:
    """Smallest power-of-two fanout whose LARGEST partition — estimated
    from a first-page histogram of the actual hash — fits the free share
    (with index overhead).  Capped at _MAX_FANOUT: past that the split
    cannot help and the run is (nearly) all-spill anyway."""
    sample = min(len(bkey), _HIST_SAMPLE)
    if sample == 0:
        return 2
    h = _mix64_np(bkey[:sample]) >> np.uint64(32)
    budget = max(free // 2, 1)
    p = 2
    while p < _MAX_FANOUT:
        counts = np.bincount((h % np.uint64(p)).astype(np.int64),
                             minlength=p)
        frac = counts.max() / max(sample, 1)
        est_rows = frac * n_build
        if dev.bucket_rows(max(int(est_rows), 1)) \
                * (per_row + _IDX_ROW_BYTES) <= budget:
            break
        p *= 2
    return p


def _compile_pending(ctx, sig, key_pack, agg_ops, probe_bucket) -> bool:
    """Would the device half degrade on a pending background compile
    this run?  True when async compile is ON and no hybrid program of
    this fragment and probe bucket is in the cache yet — the split
    shifts everything host-ward and the NEXT run (program ready) takes
    the device share back.  (The port's key also carries the group
    capacity, so any capacity's program counts as built.)"""
    try:
        if str(ctx.get_sysvar("tidb_compile_async")).upper() != "ON":
            return False
    except Exception:
        return False
    from .device_exec import _PIPE_CACHE, _PIPE_LOCK
    tail = (key_pack, tuple(agg_ops), "hybrid")
    with _PIPE_LOCK:
        return not any(len(k) == 6 and k[0] == sig and k[1] == probe_bucket
                       and k[3:] == tail for k in _PIPE_CACHE
                       if isinstance(k, tuple))


def _hybrid_capacity(ctx, sig, agg_plan, probe_bucket) -> int:
    """The group slots of a hybrid program: the planner's estimate over
    one probe page, raised to the learned count of this fragment where a
    page held more groups.  A learned count below the estimate keeps the
    estimate's slots, so a repeat run reuses the program the first run
    built instead of building a smaller one."""
    from .device_exec import _estimate_groups
    from .device_join import _CAP_STORE
    est = _estimate_groups(agg_plan, probe_bucket, ctx)
    cap = dev.next_pow2(min(probe_bucket, max(est, 16)))
    learned = _CAP_STORE.get((sig, "agg"))
    if learned is not None:
        cap = max(cap, dev.next_pow2(max(learned, 16)))
    return cap


def _hybrid_pipeline(ctx, sig, key_pack, agg_ops, probe_bucket, capacity,
                     root, leaves, joins, agg_plan, agg_conds, agg_meta,
                     dcols):
    """THE hybrid program resolution: the join fragment with its
    aggregate at `capacity` group slots, every join probe-shaped at the
    common probe bucket and the strategy snapshot (the partition stub)
    bound into the build closure — a deferred build must see the stub
    even after this run's exit path restores the join node's original
    strategy.  Shared by the device pass and the compile-pending kick so
    key and shape can never diverge between them."""
    from .device_exec import acquire_pipeline
    from .device_join import compile_fragment
    for jn in joins:
        jn.cap = probe_bucket
    key = (sig, probe_bucket, capacity, key_pack, tuple(agg_ops), "hybrid")
    dict_refs = tuple(dc.dictionary for dc in dcols.values()
                      if dc.dictionary is not None)
    strategies = tuple(jn.strategy for jn in joins)

    def build():
        return compile_fragment(root, leaves, joins, agg_plan, agg_conds,
                                [probe_bucket] * len(joins), capacity,
                                key_pack, agg_meta, strategies=strategies)
    return acquire_pipeline(key, build, dict_refs, ctx=ctx, shape="join",
                            sig=sig)


def _kick_bg_compile(ctx, sig, key_pack, agg_ops, probe_bucket, root,
                     leaves, joins, agg_plan, agg_conds, agg_meta, dcols):
    """Resolve the hybrid program through the compile service without
    dispatching it: acquire_pipeline may raise the pending
    DeviceUnsupported by design — here that IS the expected outcome."""
    try:
        _hybrid_pipeline(ctx, sig, key_pack, agg_ops, probe_bucket,
                         _hybrid_capacity(ctx, sig, agg_plan, probe_bucket),
                         root, leaves, joins, agg_plan, agg_conds, agg_meta,
                         dcols)
    except DeviceUnsupported:
        pass


def _balance_split(n_dev, n_parts, pparts, tp) -> int:
    """Shift partitions host-ward while the device half's expected probe
    time exceeds the host half's (measured rows/s from previous runs of
    this fragment) — the co-processing paper's balanced split point.
    Only host-ward: the memory fit is a hard ceiling."""
    dev_r, host_r = tp
    if dev_r <= 0 or host_r <= 0:
        return n_dev
    order = sorted(range(n_parts), key=lambda p: (-len(pparts[p]), p))
    total = sum(len(p) for p in pparts)
    while n_dev > 0:
        drows = sum(len(pparts[p]) for p in order[:n_dev])
        hrows = total - drows
        t_dev = drows / dev_r
        t_host = hrows / host_r
        drop = len(pparts[order[n_dev - 1]])
        # would moving the smallest device partition host-ward reduce
        # the makespan?
        if t_dev <= t_host or (max(t_dev, t_host)
                               <= max((drows - drop) / dev_r,
                                      (hrows + drop) / host_r)):
            break
        n_dev -= 1
    return n_dev


def _update_throughput(sig, dev_rows, t_dev, host_fed, t_host):
    """Both rates are PROBE-ROWS-CONSUMED per second — the same unit on
    both halves, so _balance_split's makespan comparison stays honest
    under selective joins (post-join output rows would understate the
    host rate by the filter factor)."""
    with _LOCK:
        pair = _THROUGHPUT.get(sig, (0.0, 0.0))
        dev_r = (dev_rows / t_dev if (dev_rows and t_dev > 1e-6)
                 else pair[0])
        host_r = (host_fed / t_host if (host_fed and t_host > 1e-6)
                  else pair[1])
        # EWMA so one noisy run doesn't whipsaw the split
        new = (0.5 * pair[0] + 0.5 * dev_r if pair[0] else dev_r,
               0.5 * pair[1] + 0.5 * host_r if pair[1] else host_r)
        _THROUGHPUT[sig] = new
        _THROUGHPUT.move_to_end(sig)
        if len(_THROUGHPUT) > _THROUGHPUT_MAX:
            _THROUGHPUT.popitem(last=False)


# ---------------------------------------------------------------------------
# device half
# ---------------------------------------------------------------------------

def _device_pass(ctx, leaves, joins, probe, big, big_jn, brows, bparts,
                 pparts, dev_pids, big_used, probe_used, used,
                 build_key_local, packs, build_bucket, probe_bucket,
                 max_part, agg_meta, agg_conds, key_pack, merge_ops,
                 n_keys, nvals, sig, dcols, root, agg_plan, stats):
    """The device half: upload the fitting build partitions as resident
    bucket-padded sorted join indexes + columns, then ONE probe pass that
    stages each partition's probe rows page by page (the pinned ring) and
    runs every page through the shared join + aggregate fragment (K2,
    K5a, K5b's count, K1), folding the page states on the card (the
    partial-state merge) with the paged probe join's capacity retry.
    Returns (the merged device state, probed row total)."""
    from ..ops import stream
    from .device_exec import _MERGE_BUDGET_ROWS, _estimate_groups
    from .device_join import _CAP_STORE, _cap_store_put
    key_fns, val_plan, agg_ops, slots = agg_meta
    per_double = dev.shape_buckets(ctx)
    d = dev.device()

    # resident dimensions (shared by every partition), pruned to used
    env_dim = {}
    for lf in leaves:
        if lf.leaf_id in (probe.leaf_id, big.leaf_id):
            continue
        dim_bucket = dev.bucket_rows(lf.chunk.num_rows, per_double)
        for i in range(lf.ncols):
            if lf.offset + i in used:
                dc = dev.to_device_col(lf.chunk.columns[i],
                                       bucket=dim_bucket)
                env_dim[lf.offset + i] = (dc.data, dc.nulls)

    # host source arrays for the probe/big leaves (codes for strings)
    probe_arrays = {
        probe.offset + i: dev.meta_device_col(probe.chunk.columns[i])[1]
        for i in probe_used}
    big_arrays = {
        big.offset + i: dev.meta_device_col(big.chunk.columns[i])[1]
        for i in big_used}

    # per-partition build: sub-columns + a join index with the SHARED
    # shape overrides (whole-table packs, sorted layout, common bucket)
    part_env = {}   # pid -> (env entries, jidx tuple, n_live_big)
    dim_jidx = {jn.pos: jn.strategy[2].device_arrays()
                for jn in joins if jn is not big_jn}
    build_bytes = 0
    for p in dev_pids:
        rows = brows[bparts[p]]
        kcols = [big.chunk.columns[i].take(rows) for i in build_key_local]
        idx = build_join_index(kcols, packs=packs, force_sorted=True,
                               pad_rows=max_part)
        if idx is None or not idx.unique:
            raise DeviceUnsupported(
                "hybrid build partition keys are not unique")
        env_p = {}
        for i in big_used:
            dd, nl = big_arrays[big.offset + i]
            hd = dev.pad_host(np.asarray(dd)[rows], build_bucket)
            hn = dev.pad_host(np.asarray(nl)[rows], build_bucket, True)
            env_p[big.offset + i] = (dev.upload(hd, d), dev.upload(hn, d))
            build_bytes += hd.nbytes + hn.nbytes
        jidx = tuple(idx.device_arrays() if jn is big_jn
                     else dim_jidx[jn.pos] for jn in joins)
        build_bytes += idx.upload_bytes()
        part_env[p] = (env_p, jidx, len(rows))
    stats.s["build_h2d_bytes"] = build_bytes

    def pages():
        for p in dev_pids:
            prow_all = pparts[p]
            for lo in range(0, len(prow_all), probe_bucket):
                yield p, prow_all, lo, min(lo + probe_bucket, len(prow_all))

    capacity = _hybrid_capacity(ctx, sig, agg_plan, probe_bucket)
    learned_total = _CAP_STORE.get((sig, "groups"))
    merge_cap = dev.next_pow2(max(learned_total or capacity, 16))
    base_lives = [int(lf.chunk.num_rows) for lf in leaves]
    check = getattr(ctx, "check_killed", None)
    total_rows = sum(len(pparts[p]) for p in dev_pids)
    stager = stream.PageStager(probe_arrays, probe_bucket, d)
    try:
        for _attempt in range(4):
            fn = _hybrid_pipeline(ctx, sig, key_pack, agg_ops, probe_bucket,
                                  capacity, root, leaves, joins, agg_plan,
                                  agg_conds, agg_meta, dcols)
            k_flush = max(1, _MERGE_BUDGET_ROWS // capacity)
            state = None
            buffered = []
            max_ng = 0
            overflow = False
            for p, prow_all, lo, hi in pages():
                if check is not None:
                    check()
                env_p, jidx, n_big = part_env[p]
                penv, slot = stager.stage(lo, hi, rows=prow_all)
                env = dict(env_dim)
                env.update(env_p)
                env.update(penv)
                lives = list(base_lives)
                lives[probe.leaf_id] = hi - lo
                lives[big.leaf_id] = n_big
                agg_out, _ovf, _sovf, _kept = stats.dispatch(
                    fn, env, jidx, tuple(lives))
                stager.release(slot)
                buffered.append(agg_out)
                if len(buffered) >= k_flush:
                    max_ng = max(max_ng, *stats.read_groups(buffered))
                    if max_ng > capacity:
                        overflow = True
                        break
                    state, merge_cap = stats.merge(
                        state, buffered, merge_cap, n_keys, nvals,
                        merge_ops, key_pack)
                    buffered = []
            if not overflow and buffered:
                max_ng = max(max_ng, *stats.read_groups(buffered))
                if max_ng <= capacity:
                    state, merge_cap = stats.merge(
                        state, buffered, merge_cap, n_keys, nvals,
                        merge_ops, key_pack)
                    buffered = []
            if overflow or max_ng > capacity:
                # a page's group count exceeded the page capacity: restart
                # the pass at the observed size (remembered, so the
                # discovery restart happens once per fragment)
                capacity = dev.next_pow2(max_ng)
                _cap_store_put((sig, "agg"), max_ng)
                continue
            _cap_store_put((sig, "agg"), max(max_ng, 1))
            break
        else:
            raise DeviceUnsupported(
                "hybrid fragment capacity did not converge")
    finally:
        stats.take(stager)
    return state, total_rows


# ---------------------------------------------------------------------------
# host half (runs on a supervisor worker, concurrently with the above;
# numpy only — a CUDA call here would land on the main thread's stream)
# ---------------------------------------------------------------------------

def _host_val_plan(agg_plan):
    """Mirror device_exec._plan_agg's value-slot layout exactly (same
    slots, same conversions, avg = sum+count pair) with host-evaluable
    specs: (expr, conv, is_str).  DeviceUnsupported outside the hybrid
    host language."""
    out = []
    for desc in agg_plan.aggs:
        if desc.distinct:
            # cnt_dist partials don't merge (counts, not sets); the
            # mergeable-op gate upstream already rejects — mirror it
            raise DeviceUnsupported("distinct agg in hybrid fragment")
        if not desc.args:
            raise DeviceUnsupported("no-arg aggregate in hybrid fragment")
        arg = desc.args[0]
        name = desc.name
        if name == "count":
            out.append((arg, "int", False))
            continue
        if name not in ("sum", "avg", "min", "max", "first_row"):
            raise DeviceUnsupported(f"agg {name} in hybrid fragment")
        k = phys_kind(arg.ftype)
        if k == K_STR:
            if name in ("min", "max", "first_row"):
                if not isinstance(arg, ExprColumn):
                    raise DeviceUnsupported(
                        "hybrid host pass needs bare string agg args")
                out.append((arg, "int", True))
                continue
            raise DeviceUnsupported("string sum/avg")
        if name in ("min", "max", "first_row"):
            out.append((arg, "raw", False))
        elif name == "sum":
            out.append((arg, "raw", False))
        else:  # avg: sum slot + count slot
            out.append((arg, "raw", False))
            out.append((arg, "raw" if k == K_FLOAT else "int", False))
    return out


def _host_pass(spill, host_pids, probe, leaves, joins, big, big_jn,
               pparts, packs, agg_plan, agg_conds, host_vals, agg_ops,
               key_pack, merge_ops, n_keys, nvals):
    """Join + aggregate the spilled partitions in numpy with the HOST
    expression engine (value-identical to the host executors by
    construction), producing mergeable numpy partial states.  Returns
    (states, probe rows consumed, joined row total, busy seconds)."""
    t0 = time.perf_counter()
    states = []
    fed = 0      # probe rows consumed (the throughput denominator — the
    #              SAME unit the device half counts, not post-join rows)
    joined = 0   # rows surviving the join (the hj_coproc_host_rows gauge)
    with tracing.span("join.probe_host", parts=len(host_pids)):
        for p in host_pids:
            st, nrows = _host_partition(
                spill, p, probe, leaves, joins, big, big_jn, pparts[p],
                packs, agg_plan, agg_conds, host_vals, agg_ops, key_pack,
                merge_ops, n_keys, nvals)
            if st is not None:
                states.append(st)
            fed += len(pparts[p])
            joined += nrows
    return states, fed, joined, time.perf_counter() - t0


def _host_partition(spill, pid, probe, leaves, joins, big, big_jn, prow,
                    packs, agg_plan, agg_conds, host_vals, agg_ops,
                    key_pack, merge_ops, n_keys, nvals):
    from .device_exec import _merge_states_host, page_singleton_state
    from ..utils.chunk import Column, LazyDictColumn

    # reconstruct the spilled partition's columns (memmap pages; codes
    # re-wrap their ORIGINAL dictionary so code spaces stay aligned)
    pages = spill.read(pid)
    big_cols = [None] * big.ncols
    for i, (d, nl) in pages.items():
        src = big.chunk.columns[i]
        if src.is_object():
            _codes, uniq = src.dict_encode()
            big_cols[i] = LazyDictColumn(src.ftype, np.asarray(d), uniq,
                                         np.asarray(nl))
        else:
            big_cols[i] = Column(src.ftype, np.asarray(d), np.asarray(nl))
    n_big = len(next(iter(pages.values()))[0]) if pages else 0

    providers = {lf.leaf_id: lf.chunk.columns for lf in leaves}
    providers[big.leaf_id] = big_cols
    total_ncols = max(lf.offset + lf.ncols for lf in leaves)
    rs = _RowSet(providers, leaves, total_ncols)
    rs.set_rows(probe.leaf_id, np.asarray(prow))

    # probe leaf conds (the fragment's leaf filter; leaf conds are written
    # against the leaf's LOCAL schema)
    if probe.conds and rs.n:
        rs.filter(_conds_mask_local(probe.chunk.columns,
                                    np.asarray(prow), probe.conds))

    # build the partition's own index over the spilled key columns —
    # same packs, so probe packing is identical to the device half's
    kidx = None
    if rs.n and n_big:
        key_local = [k.idx + (0 if big_jn.global_keys
                              else big_jn.right.offset) - big.offset
                     for k in big_jn.right_keys]
        kcols = [big_cols[i] for i in key_local]
        mask_fn = None
        if big.conds:
            # spilled rows were pre-filtered, but re-verify exactly like
            # the device program's build validity does (idempotent)
            def mask_fn():
                return _conds_mask_local(big_cols, np.arange(n_big),
                                         big.conds)
        kidx = build_join_index(kcols, mask_fn=mask_fn, packs=packs,
                                force_sorted=True)
        if kidx is not None and not kidx.unique:
            raise DeviceUnsupported(
                "hybrid build partition keys are not unique")

    # walk the chain: every join is a unique-build gather
    for jn in joins:
        if rs.n == 0:
            break
        off_l = 0 if jn.global_keys else jn.left.offset
        lk = [_shift(k, off_l) for k in jn.left_keys]
        kcols = _eval_key_cols(rs, lk)
        idx = kidx if jn is big_jn else jn.strategy[2]
        if idx is None:
            rs.filter(np.zeros(rs.n, dtype=bool))
            break
        key, ok = _pack_keys_np([d for d, _ in kcols],
                                [nl for _, nl in kcols], idx.packs)
        hit, bi = _host_lookup_uniq(idx, key, ok)
        rs.filter(hit)
        bleaf = jn.right
        rs.set_rows(bleaf.leaf_id, bi[hit])
        # re-verify build-leaf conds on the matched rows (the device
        # program's build validity includes them even when the index is
        # unmasked)
        if bleaf.conds and rs.n:
            rs.filter(_conds_mask_local(providers[bleaf.leaf_id],
                                        rs.rows[bleaf.leaf_id],
                                        bleaf.conds))
        if jn.other_conds and rs.n:
            off_o = 0 if jn.global_keys else jn.offset
            rs.filter(_conds_mask(
                rs, [_shift(c, off_o) for c in jn.other_conds]))

    if agg_conds and rs.n:
        rs.filter(_conds_mask(rs, list(agg_conds)))
    nrows = rs.n
    if nrows == 0:
        return None, 0

    # aggregate inputs, mirroring the device fragment value-for-value
    key_cols, key_nulls = [], []
    for e in agg_plan.group_exprs:
        if phys_kind(e.ftype) == K_STR:
            codes, nl, _d = rs.codes(e.idx)
            key_cols.append(codes.astype(np.int64))
            key_nulls.append(nl.astype(bool))
        else:
            ch = rs.gchunk([e])
            d, nl = e.eval(ch)
            d = np.broadcast_to(np.asarray(d), (nrows,))
            key_cols.append(d.astype(np.int64))
            key_nulls.append(np.broadcast_to(np.asarray(nl),
                                             (nrows,)).astype(bool))
    if not key_cols:
        key_cols = [np.zeros(nrows, dtype=np.int64)]
        key_nulls = [np.zeros(nrows, dtype=bool)]
    val_cols, val_nulls = [], []
    for e, conv, is_str in host_vals:
        if is_str:
            codes, nl, _d = rs.codes(e.idx)
            d = codes.astype(np.int64)
            nl = np.asarray(nl)
        else:
            ch = rs.gchunk([e])
            d, nl = e.eval(ch)
            d = np.broadcast_to(np.asarray(d), (nrows,))
            nl = np.broadcast_to(np.asarray(nl), (nrows,))
            if conv == "int":
                d = d.astype(np.int64)
        val_cols.append(np.asarray(d))
        val_nulls.append(np.asarray(nl).astype(bool))
    page = page_singleton_state(tuple(key_cols), tuple(key_nulls),
                                tuple(val_cols), tuple(val_nulls),
                                np.ones(nrows, dtype=bool), agg_ops)
    st, _ = _merge_states_host([page], 16, n_keys, nvals, merge_ops,
                               key_pack)
    return st, nrows


def _conds_mask_local(cols, rows, conds) -> np.ndarray:
    """Leaf-local pushed-down conds over a leaf-local row subset: build
    a local-schema chunk shim of just the touched columns and evaluate
    with the host engine."""
    used = set()
    for c in conds:
        c.columns_used(used)
    gcols = [None] * (max(used) + 1 if used else 1)
    for i in used:
        gcols[i] = cols[i].take(rows)
    ch = _GChunk(gcols, len(rows))
    mask = np.ones(len(rows), dtype=bool)
    for c in conds:
        d, nl = c.eval(ch)
        mask &= (np.asarray(d) != 0) & ~np.asarray(nl)
    return mask


def _shift(e, offset):
    from .device_join import _shift_expr
    return _shift_expr(e, offset)
