"""Read-path executors (reference: executor/ — TableReaderExecutor,
HashJoinExec, HashAggExec, SortExec, TopNExec, LimitExec, UnionExec).

Execution model: whole-input blocks per operator (TiFlash-style block
execution) rather than the reference's 1024-row Volcano chunks — device
kernels want large batches; spill/streaming refinements layer on later.
"""

from __future__ import annotations

import numpy as np

from ..errors import TiDBError
from ..expression import Column as ExprColumn
from ..expression import phys_kind, K_DEC, K_FLOAT, K_STR
from ..expression.core import _cast_to  # controlled reuse: type coercion
from ..ops import host
from ..planner.logical import (
    Aggregation, DataSource, Dual, Join, Limit, MemSource, Projection,
    Selection, SetOp, Sort, TopN, Window,
)
from ..sqltypes import POW10, TYPE_LONGLONG, FieldType
from ..table import rows_to_chunk
from ..utils.chunk import Chunk, Column, concat_chunks, np_dtype_for


class QueryExecutor:
    """Base: execute() -> Chunk whose columns parallel plan.schema."""

    stats = None  # RuntimeStatsColl when EXPLAIN ANALYZE collects

    def __init__(self, plan, ctx, children):
        self.plan = plan
        self.ctx = ctx
        self.children = children

    def execute(self) -> Chunk:
        raise NotImplementedError

    def execute_stream(self, batch_rows: int):
        """Chunk-at-a-time execution (the Volcano Next() analog, reference:
        executor/executor.go:259). Default: one whole block. Sources and
        row-local operators override to yield bounded batches so blocking
        consumers (sort/topN) can govern memory and spill."""
        yield self.execute()

    def tracker(self):
        """The statement's memory tracker, or None (reference:
        stmtctx.MemTracker)."""
        return getattr(self.ctx, "mem_tracker", None)

    def check_killed(self):
        """Cooperative interruption point (KILL / max_execution_time
        watchdog, reference: the Next()-loop killed check in
        executor/executor.go). Raises QueryInterrupted when flagged."""
        f = getattr(self.ctx, "check_killed", None)
        if f is not None:
            f()

    def annotate(self, **kv):
        """Record engine/extra info for EXPLAIN ANALYZE (no-op otherwise)."""
        if self.stats is not None:
            self.stats.annotate(self.plan, **kv)

    def _with_pipe_stats(self, fn, /, *args, **kw):
        """Run a device dispatch and annotate the compiled-fragment cache
        delta — hits/misses, XLA compiles triggered, compile seconds — so
        EXPLAIN ANALYZE answers "did this query pay a compile" directly
        (the TPU analog of cop-task build info)."""
        from .device_exec import pipe_cache_stats
        from .device_join import LAST_PAGED_STATS
        # fresh per dispatch: a PREVIOUS statement's paged/hybrid stats on
        # this thread must not leak into this one's annotations (only the
        # join path used to clear, so a later scan-agg could re-annotate
        # a stale hybrid split)
        LAST_PAGED_STATS.clear()
        st0 = pipe_cache_stats(thread_local=True)
        out = fn(*args, **kw)
        if self.stats is not None:
            st1 = pipe_cache_stats(thread_local=True)
            self.annotate(
                pipe_hits=st1["hits"] - st0["hits"],
                pipe_misses=st1["misses"] - st0["misses"],
                xla_compiles=st1["compiles"] - st0["compiles"],
                compile_s=round(st1["compile_s"] - st0["compile_s"], 3))
            # how the compile service resolved this fragment's pipeline
            # (executor/compile_service.py): the WORST mode that fired
            # wins the label — a fragment that paid a sync compile or
            # degraded on a pending background compile must not read
            # `cached` because a later lookup hit
            mode = next(
                (m for m in ("async_pending", "sync", "prewarmed",
                             "bg", "cached")
                 if st1["mode_" + m] - st0["mode_" + m] > 0), None)
            if mode is not None:
                self.annotate(compile_mode=mode)
            from .supervisor import abandoned_calls
            n_abandoned = abandoned_calls()
            if n_abandoned:
                # the supervisor's "abandoned calls outstanding" gauge:
                # a prior fragment's hung device call is still blocked on
                # its worker thread while this plan runs
                self.annotate(device_abandoned_calls=n_abandoned)
            # HBM residency (ops/residency.py): bytes this process holds
            # cached on-device after the dispatch, plus the eviction /
            # OOM-recovery counters when they have ever fired — "did this
            # query run under memory pressure" answered from the plan
            from ..ops import residency
            self.annotate(**residency.report_gauges())
            # serving scheduler (executor/scheduler.py): queue depth plus
            # the admission-wait / batching / degradation counters once
            # they have fired — "did this query contend for the device"
            from . import scheduler
            self.annotate(**scheduler.report_gauges())
            # MPP mesh path (executor/mpp_exec.py): placement-cache bytes
            # plus fragment/retry counters (incl. the radix-exchange
            # overflow retries) once the mesh path has ever run — "did
            # this query pay an exchange capacity recompile"
            from . import mpp_exec
            self.annotate(**mpp_exec.report_gauges())
            # compile service (executor/compile_service.py): background
            # queue depth plus pending-fragment / persistent-cache-hit /
            # prewarm counters once they have fired — "is this query's
            # executable still compiling behind the host result"
            from . import compile_service
            self.annotate(**compile_service.report_gauges())
            # serving fabric (tidb_tpu/fabric/state.py): live worker
            # count plus fragment-dedup / remote-compile counters —
            # "did this query's fragment ride a fleet peer's device
            # call".  Empty (no annotation noise) outside a fleet.
            from ..fabric import state
            self.annotate(**state.report_gauges())
            # durable shared store (kv/wal.py): append/fsync/group-
            # commit/recovery counters once a WAL has ever fired in
            # this process — "what did durability cost this query's
            # session" from the plan.  Empty on in-memory stores.
            from ..kv import wal
            self.annotate(**wal.report_gauges())
        return out


def build_executor(plan, ctx, stats=None) -> QueryExecutor:
    if isinstance(plan, Join):
        cls = {"merge": MergeJoinExec, "index": IndexJoinExec}.get(
            plan.join_algo, HashJoinExec)
    else:
        cls = _MAP.get(type(plan))
    if cls is None:
        raise TiDBError(f"no executor for {type(plan).__name__}")
    children = [build_executor(c, ctx, stats) for c in plan.children]
    exe = cls(plan, ctx, children)
    if stats is not None:
        from .execdetails import timed_execute
        exe.stats = stats
        exe.execute = timed_execute(exe, stats)
    if getattr(ctx, "check_killed", None) is not None:
        # every operator boundary is an interruption point (reference:
        # the killed check in each Next() call, executor/executor.go)
        inner = exe.execute

        def checked_execute():
            exe.check_killed()
            return inner()

        exe.execute = checked_execute
    return exe


def _collate_eval(expr, chunk):
    """Evaluate a sort/partition key with collation-aware transform:
    _ci string keys order by their case-folded sort key."""
    d, nl = expr.eval(chunk)
    from ..utils.collate import key_for_compare
    return key_for_compare(d, expr.ftype), nl


def eval_expr_to_column(expr, chunk: Chunk) -> Column:
    data, nulls = expr.eval(chunk)
    if data.dtype != object:
        want = np_dtype_for(expr.ftype)
        if want is not object and data.dtype != want:
            data = data.astype(want)
    return Column(expr.ftype, data, nulls)


def eval_conds_mask(conds, chunk: Chunk) -> np.ndarray:
    mask = np.ones(chunk.num_rows, dtype=bool)
    for c in conds:
        d, n = c.eval(chunk)
        mask &= (d != 0) & ~n
        if not mask.any():
            break
    return mask


def resolve_access_handles(tbl, access) -> list:
    """Planner access descriptor → row handles, via the (partition-aware)
    Table. ONE resolver shared by the read path and the SELECT FOR UPDATE
    lock path — they must fetch/lock the same row set."""
    kind = access[0]
    if kind == "point_pk":
        return [access[1]]
    if kind == "point_index":
        _k, idx, vals = access
        h = tbl.index_lookup(idx, vals)
        return [] if h is None else [h]
    if kind == "batch_pk":
        return list(access[1])
    if kind == "batch_index":
        _k, idx, values = access
        out = []
        for v in values:
            h = tbl.index_lookup(idx, [v])
            if h is not None:
                out.append(h)
        return out
    if kind == "index_merge":
        # UNION of the partial paths' handle sets (reference:
        # executor/index_merge_reader.go union mode); sorted-unique keeps
        # the fetch order deterministic
        seen = set()
        for sub in access[1]:
            seen.update(resolve_access_handles(tbl, sub))
        return sorted(seen)
    _k, idx, lo, hi = access
    return tbl.index_scan_handles(idx, lo_vals=lo, hi_vals=hi)


def fetch_handles_chunk(tbl, info, col_infos, handles) -> Chunk:
    """Handle list → visibility-correct Chunk: KV seeks through the txn
    (membuffer-aware, so uncommitted writes are visible — reference
    executor/point_get.go + union_scan.go). Shared by the access-path
    scan and the index-lookup join inner fetch."""
    from ..table import rows_to_chunk
    rowdicts = []
    kept = []
    for h in handles:
        row = tbl.get_row(h)
        if row is not None:
            kept.append(h)
            rowdicts.append(row)
    return rows_to_chunk(info, col_infos, kept, rowdicts)


class TableScanExec(QueryExecutor):
    def _access_chunk(self, txn):
        """Row fetch via the planner-chosen access path (PointGet /
        IndexLookUp), assembled into a Chunk. The pushed conds stay
        as post-filters, so path choice never changes semantics."""
        from ..table import Table
        p = self.plan
        tbl = Table(p.table_info, txn, parts=p.partitions)
        handles = resolve_access_handles(tbl, p.access)
        return fetch_handles_chunk(tbl, p.table_info, p.col_infos, handles)

    def _scan_partitioned(self, txn):
        """Concat per-partition chunks, each through the columnar cache keyed
        by the partition's physical id (reference: PartitionedTable readers +
        rule_partition_processor pruned access)."""
        from ..partition import partition_view
        from ..table import Table
        p = self.plan
        defs = (p.partitions if p.partitions is not None
                else p.table_info.partition.defs)
        chunks = []
        for d in defs:
            view = partition_view(p.table_info, d)
            if self.ctx.txn_dirty(view.id):
                chunks.append(Table(view, txn).scan_columnar(
                    col_infos=p.col_infos))
                continue
            entry = self.ctx.columnar_cache().get(view, txn)
            if entry is None:
                chunks.append(Table(view, txn).scan_columnar(
                    col_infos=p.col_infos))
            else:
                chunks.append(self.ctx.columnar_cache().project(
                    entry, p.col_infos, view))
        if not chunks:
            fts = [c.ftype for c in p.col_infos]
            return Chunk([Column(ft, np.empty(0, dtype=np_dtype_for(ft)),
                                 np.zeros(0, dtype=bool)) for ft in fts])
        return concat_chunks(chunks)

    def execute_raw(self):
        """-> (unfiltered chunk, pushed conds) for fused device pipelines."""
        self.check_killed()
        p = self.plan
        self._annotate_region_fanout()
        txn = self.ctx.txn_for_read()
        if p.access is not None:
            return self._access_chunk(txn), p.pushed_conds
        if p.table_info.partition is not None:
            return self._scan_partitioned(txn), p.pushed_conds
        if self.ctx.txn_dirty(p.table_info.id):
            from ..table import Table
            tbl = Table(p.table_info, txn)
            return tbl.scan_columnar(col_infos=p.col_infos), p.pushed_conds
        entry = self.ctx.columnar_cache().get(p.table_info, txn)
        if entry is None:
            # reader snapshot predates the cache watermark (old read view
            # in an explicit txn): scan through the snapshot directly
            from ..table import Table
            tbl = Table(p.table_info, txn)
            return tbl.scan_columnar(col_infos=p.col_infos), p.pushed_conds
        return (self.ctx.columnar_cache().project(entry, p.col_infos,
                                                  p.table_info),
                p.pushed_conds)

    def execute(self):
        p = self.plan
        txn = self.ctx.txn_for_read()
        if p.access is not None:
            chunk = self._access_chunk(txn)
        elif p.table_info.partition is not None:
            chunk = self._scan_partitioned(txn)
        elif self.ctx.txn_dirty(p.table_info.id):
            # union-scan path (reference: executor/union_scan.go): txn has
            # uncommitted writes on this table — materialize through the txn
            # (and never let dirty data into the shared columnar cache)
            from ..table import Table
            tbl = Table(p.table_info, txn)
            chunk = tbl.scan_columnar(col_infos=p.col_infos)
        else:
            entry = self.ctx.columnar_cache().get(p.table_info, txn)
            if entry is None:  # old read view: scan through the snapshot
                from ..table import Table
                chunk = Table(p.table_info, txn).scan_columnar(
                    col_infos=p.col_infos)
            else:
                chunk = self.ctx.columnar_cache().project(
                    entry, p.col_infos, p.table_info)
        if p.pushed_conds:
            mask = eval_conds_mask(p.pushed_conds, chunk)
            chunk = chunk.filter(mask)
        self._annotate_region_fanout()
        return chunk

    def _annotate_region_fanout(self):
        """EXPLAIN ANALYZE visibility for region-sharded stores: how
        many regions this table's record range spans (the scan fans out
        to that many per-region stores and concatenates in region
        order; cross-region results merge through the same ordered-
        concat the MPP partial-state machinery relies on)."""
        store = getattr(self.ctx, "store", None)
        rmap = getattr(getattr(store, "mvcc", None), "region_map", None)
        if rmap is None:
            return
        from .. import tablecodec
        start = tablecodec.record_prefix(self.plan.table_info.id)
        spans = rmap.split_range(start, start + b"\xff" * 9)
        if len(spans) > 1:
            self.annotate(region_fanout=len(spans))

    def execute_stream(self, batch_rows: int):
        """Slice the resident columnar view into bounded batches (zero-copy
        slices — cache residency is storage memory, not query memory; the
        reference likewise leaves TiKV block cache outside the query quota)."""
        p = self.plan
        txn = self.ctx.txn_for_read()
        if (p.access is not None or p.table_info.partition is not None
                or self.ctx.txn_dirty(p.table_info.id)):
            yield self.execute()
            return
        entry = self.ctx.columnar_cache().get(p.table_info, txn)
        if entry is None:
            yield self.execute()
            return
        chunk = self.ctx.columnar_cache().project(entry, p.col_infos,
                                                  p.table_info)
        n = chunk.num_rows
        for lo in range(0, max(n, 1), batch_rows):
            part = chunk.slice(lo, min(lo + batch_rows, n))
            if p.pushed_conds:
                part = part.filter(eval_conds_mask(p.pushed_conds, part))
            yield part
            if lo + batch_rows >= n:
                return


class MemScanExec(QueryExecutor):
    def execute(self):
        p = self.plan
        rows = p.rows_fn()
        fts = [r.ftype for r in p.schema.refs]
        return Chunk.from_rows(fts, rows)


class DualExec(QueryExecutor):
    """One-row source: a hidden marker column gives constants a row count to
    broadcast over (the plan schema is empty so it is never projected)."""

    def execute(self):
        return Chunk([Column(FieldType(tp=TYPE_LONGLONG),
                             np.zeros(1, dtype=np.int64),
                             np.zeros(1, dtype=bool))])


class SelectionExec(QueryExecutor):
    def execute(self):
        chunk = self.children[0].execute()
        mask = eval_conds_mask(self.plan.conds, chunk)
        return chunk.filter(mask)

    def execute_stream(self, batch_rows: int):
        for chunk in self.children[0].execute_stream(batch_rows):
            yield chunk.filter(eval_conds_mask(self.plan.conds, chunk))


class ProjectionExec(QueryExecutor):
    def execute(self):
        chunk = self.children[0].execute()
        cols = [eval_expr_to_column(e, chunk) for e in self.plan.exprs]
        if not cols:
            return chunk
        return Chunk(cols)

    def execute_stream(self, batch_rows: int):
        for chunk in self.children[0].execute_stream(batch_rows):
            cols = [eval_expr_to_column(e, chunk) for e in self.plan.exprs]
            yield Chunk(cols) if cols else chunk


def _inline_agg_projection(p, proj_exec):
    """HashAgg over a pure Projection: substitute the projection's
    expressions into the agg's group keys and aggregate arguments so the
    fused device/MPP fragment detectors see the scan/join underneath (the
    reference pushes such projections into the cop/MPP DAG —
    planner/core/plan_to_pb.go; here the fragment compiler fuses them).
    Returns (rewritten_agg_plan, projection_child) or None."""
    import copy
    exprs = proj_exec.plan.exprs

    def sub(c):
        return exprs[c.idx]

    try:
        new_groups = [e.transform_columns(sub) for e in p.group_exprs]
        new_aggs = []
        for d in p.aggs:
            nd = object.__new__(type(d))
            nd.name = d.name
            nd.args = [a.transform_columns(sub) for a in d.args]
            nd.distinct = d.distinct
            nd.ftype = d.ftype
            new_aggs.append(nd)
    except Exception:
        return None
    p2 = copy.copy(p)
    p2.group_exprs = new_groups
    p2.aggs = new_aggs
    return p2, proj_exec.children[0]


def _avg_exact(s, nonnull, ft, s_arg):
    """Exact decimal AVG from per-group (sum, count) partials — round
    half away from zero at the output scale on exact bigints.  ONE
    implementation shared by the host aggregate and the result cache's
    delta-fold merge (executor/agg_cache.py), so a folded average is
    bit-equal to a from-scratch one."""
    s = np.asarray(s, dtype=object)
    nonnull = np.asarray(nonnull)
    safe = np.maximum(nonnull, 1)
    shift = int(POW10[ft.scale - s_arg])
    num = s * shift
    den = safe.astype(object)
    sign = np.where(num < 0, -1, 1)
    q = (2 * np.abs(num) + den) // (2 * den)
    res = sign * q
    if np_dtype_for(ft) is object:    # wide decimal: exact bigints
        vals = res.astype(object)
    else:
        vals = np.array([int(x) for x in res], dtype=np.int64)
    return Column(ft, vals, nonnull == 0)


class HashAggExec(QueryExecutor):
    """Group-by aggregation (reference: executor/aggregate.go parallel hash
    agg; here single kernel call — parallelism comes from the device)."""

    def execute(self):
        # fleet result cache (executor/agg_cache.py): a version-stamped
        # page serves this whole fragment with NO admission ticket, HBM
        # charge or device dispatch; an invalidated page may fold just
        # the WAL delta.  build() is None outside a fleet — the wrapper
        # then costs one call and the plan reads exactly as before.
        from . import agg_cache
        spec = agg_cache.AggCacheSpec.build(self)
        if spec is None:
            return self._execute_uncached()
        served = spec.probe()
        if served is not None:
            self._mark_fragment("cache", served.num_rows)
            spec.annotate(self)
            return served
        try:
            with agg_cache.capture_partials() as cap:
                out = self._execute_uncached()
        except BaseException:
            # degrade/KILL/fault: free the claim so waiters fall back
            spec.release()
            raise
        spec.publish(out, cap)
        spec.annotate(self)
        return out

    def _execute_uncached(self):
        self.check_killed()
        p = self.plan
        # fused device pipeline: HashAgg directly over a TableScan compiles
        # scan-filter + grouping + aggregation into one XLA program
        from .device_exec import (
            want_device, device_agg, engine_mode, run_device,
            DeviceUnsupported)
        if getattr(p, "agg_hint", None) == "stream":
            # /*+ STREAM_AGG() */ pins the host streaming/spillable path
            # (reference: stream agg enforced by hint,
            # exhaust_physical_plans.go)
            self._mark_fragment("host", None)
            return self._execute_host_spillable(self.children[0].execute())
        child = self.children[0]
        # look through pure projections (they fuse into the fragment)
        eff_p = p
        while isinstance(child, ProjectionExec):
            r = _inline_agg_projection(eff_p, child)
            if r is None:
                break
            eff_p, child = r
        conds = []
        raw = None
        if isinstance(child, TableScanExec):
            raw, conds = child.execute_raw()
        elif isinstance(child, SelectionExec) and isinstance(
                child.children[0], TableScanExec):
            raw, inner_conds = child.children[0].execute_raw()
            conds = list(inner_conds) + list(child.plan.conds)
        join_child, agg_conds = child, []
        if raw is None:
            if isinstance(child, SelectionExec) and isinstance(
                    child.children[0], HashJoinExec):
                join_child = child.children[0]
                agg_conds = list(child.plan.conds)
        # MPP: the same fused fragment, SPMD over the session's device mesh
        # (partition-parallel partial agg / broadcast join + collectives)
        from .mpp_exec import mpp_mesh, mpp_agg, mpp_join_agg
        from ..storage.paged import chunk_is_paged, DEFAULT_PAGE_ROWS
        mesh = mpp_mesh(self.ctx)
        if mesh is not None and raw is not None and chunk_is_paged(raw):
            # paged scans ARE mesh-legal within the residency budget now
            # (placement materializes the pages per shard); a bigger disk
            # table still streams through the single-chip paged pipeline
            from .device_join import _col_row_bytes, _dim_resident_budget
            est = sum(_col_row_bytes(c)
                      for c in raw.columns) * raw.num_rows
            if est > _dim_resident_budget():
                mesh = None
        if mesh is not None:
            try:
                if raw is not None:
                    out = self._with_pipe_stats(
                        run_device, self.ctx, mpp_agg, eff_p, raw, conds,
                        self.ctx, mesh, shape="agg")
                    self._mark_fragment("tpu-mpp", raw.num_rows)
                    return out
                if isinstance(join_child, HashJoinExec):
                    out = self._with_pipe_stats(
                        run_device, self.ctx, mpp_join_agg, eff_p,
                        agg_conds, join_child, self.ctx, mesh,
                        shape="join")
                    self._mark_fragment("tpu-mpp", None)
                    return out
            except DeviceUnsupported:
                pass
        want = raw is not None and want_device(self.ctx, raw.num_rows)
        # fragment identity for admission batching AND the shared perf
        # store: computed once here so the device dispatches, the host
        # tail's timing and the EXPLAIN fleet line all key the same rows
        from .device_exec import agg_batch_key
        bkey = (agg_batch_key(eff_p, conds, raw.num_rows, self.ctx)
                if raw is not None else None)
        self._perf_bkey = bkey
        if raw is not None and engine_mode(self.ctx) == "auto":
            # the cost DP priced host-vs-device placement for this agg
            # from the calibrated constants; in auto mode its choice
            # replaces the raw row floor (planner/physical.py _best_cost)
            ec = getattr(p, "engine_choice", None)
            if ec == "host":
                want = False
            elif ec == "tpu":
                want = True
        if want:
            # streamed pipeline when the input exceeds the batch bound:
            # blocks transfer to HBM while the previous block computes
            # (reference: the cop-iterator worker pool overlap)
            try:
                batch = int(self.ctx.get_sysvar("tidb_device_stream_rows"))
            except Exception:
                batch = 0
            paged_in = chunk_is_paged(raw)
            if batch == 0:
                # auto: a paged (disk-resident) input MUST stream — its
                # columns exceed what one transfer (or one chip's HBM)
                # should hold; very large RAM-resident inputs stream too,
                # bounding HBM by the page size instead of the table.
                # batch=-1 opts resident inputs out of auto-streaming
                # (debug/bench escape hatch); paged inputs always stream.
                if paged_in or raw.num_rows > 4 * DEFAULT_PAGE_ROWS:
                    batch = DEFAULT_PAGE_ROWS
            elif batch < 0:
                batch = DEFAULT_PAGE_ROWS if paged_in else 0
            if batch > 0 and (paged_in or raw.num_rows > batch):
                from .device_exec import device_agg_streaming
                try:
                    out = self._with_pipe_stats(
                        run_device, self.ctx, device_agg_streaming,
                        eff_p, raw, conds, batch,
                        ctx=self.ctx, allow_single=paged_in, shape="agg",
                        batch_key=bkey)
                    self._mark_fragment("tpu-stream", raw.num_rows)
                    return out
                except DeviceUnsupported:
                    pass
            if not paged_in:
                # a paged chunk must NOT fall through to the whole-input
                # pipeline: to_device_col would read the entire memmap into
                # RAM + HBM — the exact failure paging exists to prevent
                try:
                    out = self._with_pipe_stats(
                        run_device, self.ctx, device_agg, eff_p, raw,
                        conds, ctx=self.ctx, shape="agg", batch_key=bkey)
                    self._mark_fragment("tpu", raw.num_rows)
                    return out
                except DeviceUnsupported:
                    pass
        # join fragment: HashAgg over an (inner equi-)join tree of scans
        # fuses scans+filters+joins+aggregate into one device program
        if (raw is None and isinstance(join_child, HashJoinExec)
                and engine_mode(self.ctx) != "host"):
            # collect_tree may MATERIALIZE a semi build side; in host mode
            # that work would be thrown away and re-done by the host path
            from .device_join import LAST_PAGED_STATS, device_join_agg
            try:
                LAST_PAGED_STATS.clear()
                out = self._with_pipe_stats(
                    run_device, self.ctx, device_join_agg, eff_p,
                    agg_conds, join_child, self.ctx, shape="join")
                self._mark_fragment("tpu", None)
                if LAST_PAGED_STATS:
                    st = dict(LAST_PAGED_STATS.items())
                    self.annotate(**st)
                    if "hj_partitions" in st:
                        # explicit keywords: the gauge-consistency rule
                        # reads annotate kwargs, and the hybrid gauges
                        # must surface on the EXPLAIN plane with THIS
                        # query's per-run values (hybrid_join.py)
                        self.annotate(
                            hj_partitions=st["hj_partitions"],
                            hj_spilled_partitions=st[
                                "hj_spilled_partitions"],
                            hj_spill_bytes=st["hj_spill_bytes"],
                            hj_coproc_host_rows=st["hj_coproc_host_rows"])
                return out
            except DeviceUnsupported:
                pass
        import time as _t
        t_host = _t.perf_counter()
        if raw is not None and eff_p is p:
            # reuse the materialized chunk on the host path (only valid
            # when no projection was inlined: self.plan's expressions are
            # written against the ORIGINAL child schema)
            self._mark_fragment("host", raw.num_rows)
            chunk = raw
            if conds:
                chunk = chunk.filter(eval_conds_mask(conds, chunk))
        else:
            chunk = self.children[0].execute()
        out = self._execute_host_spillable(chunk)
        if bkey is not None:
            # the host-side dispatch row for this fragment: the same
            # (sig, bucket) key as its device dispatches, so the perf
            # store can rank device vs host for the SAME fragment —
            # whether the host ran it by choice or as a fallback
            from ..fabric import perf as fabric_perf
            fabric_perf.note(*fabric_perf.dispatch_key(bkey), "host",
                             "dispatch", _t.perf_counter() - t_host)
        return out

    #: hash partitions for the quota-pressure spill path (reference:
    #: executor/aggregate.go parallel agg spill, util/chunk/disk.go:34)
    SPILL_PARTS = 16

    def _execute_host_spillable(self, chunk):
        """Group-by under memory pressure: when the input (≈ the agg
        state's order of magnitude) exceeds the remaining quota, hash-
        partition rows by group key and aggregate partition-by-partition —
        group keys are disjoint across partitions, so concatenating the
        per-partition outputs IS the full result. Each pass consumes and
        releases ~1/SPILL_PARTS of the input. (The input chunk itself is
        storage memory — the resident columnar cache — like the reference
        leaves the TiKV block cache outside the query quota; Sort spills
        its buffered copy to disk, utils/disk.py.)"""
        p = self.plan
        tracker = self.tracker()
        from ..utils.memory import approx_chunk_bytes
        if (tracker is None or not p.group_exprs or chunk.num_rows == 0
                or 2 * approx_chunk_bytes(chunk)
                <= tracker.remaining_chain()):
            return self._execute_host(chunk)
        # collation-aware keys: _ci case-variants must land in ONE
        # partition, exactly as _execute_host groups them
        keys = [_collate_eval(e, chunk) for e in p.group_exprs]
        pid = host.partition_ids(keys, self.SPILL_PARTS)
        outs = []
        for q in range(self.SPILL_PARTS):
            sel = np.nonzero(pid == q)[0]
            if not len(sel):
                continue
            sub = chunk.take(sel)
            out = self._execute_host(sub)
            outs.append(out)
            # the pass's hash-state charge is returned once its groups are
            # handed to the parent (delivery is the parent's accounting)
            tracker.release(approx_chunk_bytes(out))
        self.annotate(agg_spill_partitions=self.SPILL_PARTS)
        return concat_chunks(outs)

    def _mark_fragment(self, engine: str, scan_rows):
        """EXPLAIN ANALYZE annotation for a fused device fragment: the whole
        subtree below this HashAgg ran as ONE XLA program (the cop-task
        execution info analog, reference util/execdetails CopRuntimeStats)."""
        if self.stats is None:
            return
        self.annotate(engine=engine)
        bkey = getattr(self, "_perf_bkey", None)
        if bkey is not None:
            # fleet perf line (observe-only): what the WHOLE
            # fleet has seen for this fragment — "fleet: n=…, device
            # p50/p99 …, host p50/p99 …" — next to this run's engine
            from ..fabric import perf as fabric_perf
            line = fabric_perf.describe(
                fabric_perf.lookup(*fabric_perf.dispatch_key(bkey)))
            if line:
                self.annotate(fleet_perf=f"fleet: {line}")

        def walk(p):
            for c in p.children:
                self.stats.annotate(c, fused=f"into {engine} fragment")
                if scan_rows is not None and isinstance(c, DataSource):
                    self.stats.annotate(c, scan_rows=scan_rows)
                walk(c)
        walk(self.plan)

    def _execute_host(self, chunk):
        from .agg_cache import note_agg_pass
        note_agg_pass()
        tracker = self.tracker()
        p = self.plan
        n = chunk.num_rows
        group_cols = [e.eval(chunk) for e in p.group_exprs]
        if p.group_exprs:
            from ..utils.collate import key_for_compare
            key_cols = [(key_for_compare(d, e.ftype), nl)
                        for (d, nl), e in zip(group_cols, p.group_exprs)]
            gids, n_groups, first_idx = host.group_ids(key_cols)
        else:
            gids = np.zeros(n, dtype=np.int64)
            n_groups = 1 if n > 0 else 0
            first_idx = np.zeros(min(1, n), dtype=np.int64)
        out_cols = []
        # group key outputs
        for (data, nulls), e in zip(group_cols, p.group_exprs):
            out_cols.append(Column(e.ftype, data[first_idx], nulls[first_idx]))
        # aggregate outputs
        for desc in p.aggs:
            out_cols.append(self._eval_agg(desc, chunk, gids, n_groups))
        if not p.group_exprs and n == 0:
            # global aggregate over empty input: one row (count=0, sum=null)
            out_cols = []
            for desc in p.aggs:
                out_cols.append(self._empty_agg(desc))
        out = Chunk(out_cols)
        if tracker is not None:
            from ..utils.memory import approx_chunk_bytes
            # per-operator accounting (reference: the agg tracker holds the
            # hash-table STATE — one entry per group — not the child's
            # chunks, which are the storage layer's resident columns): the
            # state is the size of the grouped output, so a low-cardinality
            # GROUP BY over a huge partition charges its 3 groups, not its
            # 6000 input rows. A global reduction is O(1).
            tracker.consume(approx_chunk_bytes(out)
                            if p.group_exprs else 1024)
        return out

    def _empty_agg(self, desc):
        from ..expression.core import _null_fill_array
        ft = desc.ftype
        if desc.name in ("count", "approx_count_distinct"):
            return Column(ft, np.zeros(1, dtype=np.int64),
                          np.zeros(1, dtype=bool))
        return Column(ft, _null_fill_array(ft, 1), np.ones(1, dtype=bool))

    def _eval_agg(self, desc, chunk, gids, n_groups):
        name = desc.name
        ft = desc.ftype
        if desc.distinct:
            return self._eval_agg_distinct(desc, chunk, gids, n_groups)
        arg = desc.args[0] if desc.args else None
        if name == "count":
            data, nulls = arg.eval(chunk)
            cnt = host.seg_count(gids, n_groups, nulls)
            return Column(ft, cnt, np.zeros(n_groups, dtype=bool))
        data, nulls = arg.eval(chunk)
        k = phys_kind(arg.ftype)
        if name == "sum":
            nonnull = host.seg_count(gids, n_groups, nulls)
            if phys_kind(ft) == K_FLOAT or k == K_FLOAT or k == K_STR:
                from ..expression.core import _as_float
                s = host.seg_sum_float(gids, n_groups,
                                       _as_float(data, arg.ftype), nulls)
                return Column(ft, s, nonnull == 0)
            # decimal/int: exact int64 accumulation at arg scale == out scale
            s = host.seg_sum_int(gids, n_groups, data, nulls)
            return Column(ft, s, nonnull == 0)
        if name == "avg":
            nonnull = host.seg_count(gids, n_groups, nulls)
            safe = np.maximum(nonnull, 1)
            if phys_kind(ft) == K_FLOAT:
                from ..expression.core import _as_float
                s = host.seg_sum_float(gids, n_groups,
                                       _as_float(data, arg.ftype), nulls)
                return Column(ft, s / safe, nonnull == 0)
            s_arg = arg.ftype.scale if k == K_DEC else 0
            s = host.seg_sum_int(gids, n_groups, data, nulls).astype(object)
            from .agg_cache import note_avg_partial
            note_avg_partial(s, nonnull)
            return _avg_exact(s, nonnull, ft, s_arg)
        if name in ("min", "max"):
            fn = host.seg_min if name == "min" else host.seg_max
            vals, empty = fn(gids, n_groups, data, nulls)
            return Column(ft, vals, empty)
        if name == "first_row":
            idx = np.full(n_groups, np.iinfo(np.int64).max, dtype=np.int64)
            np.minimum.at(idx, gids, np.arange(len(gids), dtype=np.int64))
            return Column(ft, data[idx], nulls[idx])
        if name in ("bit_and", "bit_or", "bit_xor"):
            ident = {"bit_and": -1, "bit_or": 0, "bit_xor": 0}[name]
            acc = np.full(n_groups, ident, dtype=np.int64)
            v = np.where(nulls, ident, data.astype(np.int64))
            ufn = {"bit_and": np.bitwise_and, "bit_or": np.bitwise_or,
                   "bit_xor": np.bitwise_xor}[name]
            ufn.at(acc, gids, v)
            return Column(ft, acc, np.zeros(n_groups, dtype=bool))
        if name in ("stddev_pop", "var_pop", "stddev_samp", "var_samp"):
            from ..expression.core import _as_float
            f = _as_float(data, arg.ftype)
            nonnull = host.seg_count(gids, n_groups, nulls)
            s1 = host.seg_sum_float(gids, n_groups, f, nulls)
            s2 = host.seg_sum_float(gids, n_groups, f * f, nulls)
            cnt = np.maximum(nonnull, 1).astype(np.float64)
            mean = s1 / cnt
            var = s2 / cnt - mean * mean
            var = np.maximum(var, 0.0)
            if name.endswith("_samp"):
                denom = np.maximum(nonnull - 1, 1).astype(np.float64)
                var = var * cnt / denom
                bad = nonnull < 2
            else:
                bad = nonnull == 0
            if name.startswith("stddev"):
                var = np.sqrt(var)
            return Column(ft, var, bad)
        if name == "group_concat":
            sep = b","
            if len(desc.args) > 1:
                from ..expression import Constant
                last = desc.args[-1]
                if isinstance(last, Constant):
                    sep = last.value
            from ..sqltypes import TYPE_VARCHAR
            out = [[] for _ in range(n_groups)]
            sdata, snulls = _cast_to(data, nulls, arg.ftype,
                                     FieldType(tp=TYPE_VARCHAR))
            for i, g in enumerate(gids):
                if not snulls[i]:
                    out[g].append(sdata[i])
            vals = np.array([sep.join(x) for x in out], dtype=object)
            empty = np.array([len(x) == 0 for x in out], dtype=bool)
            return Column(ft, vals, empty)
        if name == "approx_count_distinct":
            return self._eval_agg_distinct(desc, chunk, gids, n_groups,
                                           force_count=True)
        raise TiDBError(f"unsupported aggregate {name}")

    def _eval_agg_distinct(self, desc, chunk, gids, n_groups, force_count=False):
        """DISTINCT aggregates: dedup (group, value) then re-aggregate.
        _ci string values dedup by their collation SORT KEY — 'abc' and
        'ABC' are one distinct value under utf8mb4_general_ci (MySQL
        semantics; the device kernel's ci-class codes agree)."""
        arg = desc.args[0]
        data, nulls = arg.eval(chunk)
        from ..utils.collate import key_for_compare
        # _ci strings dedup by collation sort key (same comparison-key
        # helper every other host comparison site uses)
        dedup_data = key_for_compare(data, arg.ftype)
        sub_gids, _n, first_idx = host.group_ids(
            [(gids, np.zeros(len(gids), dtype=bool)), (dedup_data, nulls)])
        d_gids = gids[first_idx]
        d_data = data[first_idx]
        d_nulls = nulls[first_idx]
        name = "count" if force_count else desc.name
        ft = desc.ftype
        if name == "count":
            cnt = host.seg_count(d_gids, n_groups, d_nulls)
            return Column(ft, cnt, np.zeros(n_groups, dtype=bool))
        if name == "sum":
            nonnull = host.seg_count(d_gids, n_groups, d_nulls)
            if phys_kind(ft) == K_FLOAT:
                from ..expression.core import _as_float
                s = host.seg_sum_float(d_gids, n_groups,
                                       _as_float(d_data, arg.ftype), d_nulls)
            else:
                s = host.seg_sum_int(d_gids, n_groups, d_data, d_nulls)
            return Column(ft, s, nonnull == 0)
        raise TiDBError(f"unsupported DISTINCT aggregate {desc.name}")


class HashJoinExec(QueryExecutor):
    """reference: executor/join.go — build on the smaller side, probe the
    larger; semantics per kind inner/left/semi/anti."""

    def execute(self):
        left = self.children[0].execute()
        right = self._inner_chunk(left)
        return self._join(left, right)

    def _inner_chunk(self, left):
        """Materialize the inner (build) side; IndexJoinExec overrides to
        fetch only key-matching rows through the index."""
        return self.children[1].execute()

    #: hash partitions for the quota-pressure spill path (reference:
    #: executor/join.go build-side spill partitioning)
    SPILL_PARTS = 16

    def _join(self, left, right):
        self.check_killed()
        p = self.plan
        if not p.left_keys:
            tracker = self.tracker()
            if tracker is not None:
                from ..utils.memory import approx_chunk_bytes
                tracker.consume(approx_chunk_bytes(right))
            return self._nested_loop(left, right)
        rkeys = [self._coerce_key(re_, le_, right)
                 for re_, le_ in zip(p.right_keys, p.left_keys)]
        lkeys = [self._coerce_key(le_, re_, left)
                 for le_, re_ in zip(p.left_keys, p.right_keys)]
        tracker = self.tracker()
        from ..utils.memory import approx_chunk_bytes
        need = approx_chunk_bytes(right)
        if (tracker is not None
                and 2 * need > tracker.remaining_chain()):
            # build side won't fit under the quota: hash-partition both
            # sides and join partition-by-partition (the spill path —
            # working set drops to ~1/SPILL_PARTS per pass)
            return self._join_partitioned(left, right, lkeys, rkeys,
                                          tracker)
        if tracker is not None:
            # build-side state is the join's memory footprint (reference:
            # hash table in executor/join.go; quota breach cancels)
            tracker.consume(need)
        return self._join_kind(left, right, lkeys, rkeys)

    def _join_partitioned(self, left, right, lkeys, rkeys, tracker):
        from ..utils.memory import approx_chunk_bytes
        p = self.plan
        parts = self.SPILL_PARTS
        lp = host.partition_ids(lkeys, parts)
        rp = host.partition_ids(rkeys, parts)
        outs = []
        for q in range(parts):
            lsel = np.nonzero(lp == q)[0]
            if not len(lsel):
                continue  # no probe/outer rows: nothing can be emitted
            rsel = np.nonzero(rp == q)[0]
            if p.kind == "inner" and not len(rsel):
                continue
            sub_l = left.take(lsel)
            sub_r = right.take(rsel)
            sub_lk = [(d[lsel], n[lsel]) for d, n in lkeys]
            sub_rk = [(d[rsel], n[rsel]) for d, n in rkeys]
            b = approx_chunk_bytes(sub_r)
            tracker.consume(b)
            try:
                outs.append(self._join_kind(sub_l, sub_r, sub_lk, sub_rk))
            finally:
                tracker.release(b)
        self.annotate(join_spill_partitions=parts)
        if not outs:
            return Chunk.empty([r.ftype for r in p.schema.refs])
        return concat_chunks(outs)

    def _join_kind(self, left, right, lkeys, rkeys):
        p = self.plan
        # join_match(build, probe) -> (probe_idx, build_idx); build on the
        # right side, probe with the left (reference builds the smaller side;
        # side choice by size comes with the cost model)
        if p.kind == "inner":
            li, ri = self._match(rkeys, lkeys)
            chunk = _combine(left, right, li, ri)
            if p.other_conds:
                chunk = chunk.filter(eval_conds_mask(p.other_conds, chunk))
            return chunk
        if p.kind == "left":
            li, ri = self._match(rkeys, lkeys)
            # li: left(probe) idx, ri: right(build) idx
            if p.other_conds:
                cand = _combine(left, right, li, ri)
                keep = eval_conds_mask(p.other_conds, cand)
                li, ri = li[keep], ri[keep]
            matched = np.zeros(left.num_rows, dtype=bool)
            matched[li] = True
            un = np.nonzero(~matched)[0]
            chunk_m = _combine(left, right, li, ri)
            chunk_u = _combine_left_nulls(left, right, un, p.right.schema)
            return concat_chunks([chunk_m, chunk_u])
        if p.kind in ("semi", "anti"):
            li, ri = self._match(rkeys, lkeys)
            if p.other_conds:
                cand = _combine(left, right, li, ri)
                keep = eval_conds_mask(p.other_conds, cand)
                li = li[keep]
            mask = np.zeros(left.num_rows, dtype=bool)
            mask[li] = True
            if p.kind == "anti":
                mask = ~mask
            return left.filter(mask)
        raise TiDBError(f"unsupported join kind {p.kind}")

    def _match(self, build_keys, probe_keys):
        """Dispatch the match kernel to device or host by engine mode."""
        from .device_exec import want_device, device_join_keys, run_device
        from .device_exec import DeviceUnsupported
        n = max(len(build_keys[0][0]), len(probe_keys[0][0])) if build_keys else 0
        if want_device(self.ctx, n):
            try:
                return self._with_pipe_stats(
                    run_device, self.ctx, device_join_keys,
                    probe_keys, build_keys, shape="join")
            except DeviceUnsupported:
                pass
        return self._host_match(build_keys, probe_keys)

    def _host_match(self, build_keys, probe_keys):
        return host.join_match(build_keys, probe_keys)

    def _coerce_key(self, expr, other, chunk):
        """Evaluate a join key, coercing decimals to a common scale with the
        other side so codes agree."""
        data, nulls = expr.eval(chunk)
        k1, k2 = phys_kind(expr.ftype), phys_kind(other.ftype)
        if k1 == K_DEC or k2 == K_DEC:
            s = max(expr.ftype.scale if k1 == K_DEC else 0,
                    other.ftype.scale if k2 == K_DEC else 0)
            from ..expression.core import _as_decimal
            return _as_decimal(data, expr.ftype, s), nulls
        if k1 == K_FLOAT or k2 == K_FLOAT:
            from ..expression.core import _as_float
            return _as_float(data, expr.ftype), nulls
        if data.dtype == np.int32:
            return data.astype(np.int64), nulls
        if k1 == K_STR:
            from ..utils.collate import ci_collation, sort_key_array
            coll = ci_collation(expr.ftype, other.ftype)
            if coll is not None:
                return sort_key_array(data, coll), nulls
        return data, nulls

    def _nested_loop(self, left, right):
        p = self.plan
        nl_, nr = left.num_rows, right.num_rows
        li = np.repeat(np.arange(nl_, dtype=np.int64), nr)
        ri = np.tile(np.arange(nr, dtype=np.int64), nl_)
        chunk = _combine(left, right, li, ri)
        if p.other_conds:
            chunk = chunk.filter(eval_conds_mask(p.other_conds, chunk))
        if p.kind == "inner":
            return chunk
        raise TiDBError("non-equi outer joins not supported yet")


class MergeJoinExec(HashJoinExec):
    """Single primitive-key join via direct sort+merge (reference:
    executor/merge_join.go; planner/physical.py picks it for large
    primitive-keyed joins where the factorization pass is the overhead —
    on the device path, device_join_keys's raw-int fast path skips the
    same factorization)."""

    def _host_match(self, build_keys, probe_keys):
        return host.merge_join_match(build_keys[0], probe_keys[0])


class IndexJoinExec(HashJoinExec):
    """Index-lookup join: the outer side's distinct key values drive
    index/handle seeks on the inner table, skipping its full scan
    (reference: executor/index_lookup_join.go; the 3 reference variants
    collapse to one here because matching is vectorized after the fetch)."""

    #: above this many distinct outer keys, seeks lose to the scan the
    #: planner expected to avoid — fall back to the plain inner scan
    MAX_KEYS = 1 << 17

    def _inner_chunk(self, left):
        p = self.plan
        data, nulls = p.left_keys[0].eval(left)
        vals = np.unique(data[~nulls])
        if (len(vals) > self.MAX_KEYS or self.ctx.columnar_cache().is_bulk(
                p.right.table_info.id)):
            # bulk-installed rows live only in the columnar store, where
            # the inner scan reads them; a KV seek would find none
            return self.children[1].execute()
        from ..table import Table
        ds = p.right
        txn = self.ctx.txn_for_read()
        tbl = Table(ds.table_info, txn)
        if p.index_join[0] == "pk":
            handles = [int(v) for v in vals]  # planner gates keys to ints
        else:
            idx = p.index_join[1]
            handles = []
            for v in vals:
                key = v.item() if isinstance(v, np.generic) else v
                handles.extend(tbl.index_scan_handles(
                    idx, lo_vals=[key], hi_vals=[key]))
        chunk = fetch_handles_chunk(tbl, ds.table_info, ds.col_infos,
                                    handles)
        if ds.pushed_conds:
            chunk = chunk.filter(eval_conds_mask(ds.pushed_conds, chunk))
        return chunk


def _combine(left: Chunk, right: Chunk, li, ri) -> Chunk:
    cols = [c.take(li) for c in left.columns] + [c.take(ri) for c in right.columns]
    return Chunk(cols)


def _combine_left_nulls(left: Chunk, right: Chunk, li, right_schema) -> Chunk:
    n = len(li)
    cols = [c.take(li) for c in left.columns]
    for rc in right.columns:
        dt = rc.data.dtype
        if dt == object:
            from ..utils.chunk import null_fill_value
            data = np.full(n, null_fill_value(rc.ftype), dtype=object)
        else:
            data = np.zeros(n, dtype=dt)
        cols.append(Column(rc.ftype, data, np.ones(n, dtype=bool)))
    return Chunk(cols)


class SortExec(QueryExecutor):
    """Sort with disk spill under memory pressure (reference:
    executor/sort.go:56 SortAndSpillDiskAction + util/chunk/disk.go): input
    batches accumulate against the statement quota; crossing it sorts the
    buffer into a run on disk and releases the memory.

    Known bound: the final merge materializes the full output chunk (this
    engine's block model returns one Chunk per query, unlike the
    reference's chunk-streamed resultset), so spill caps the WORKING set —
    buffered input + per-run state — not the output materialization. A
    streamed-resultset layer would remove that; np's stable sort on the
    concatenated (already-sorted) runs is timsort-style run-merging, so the
    merge costs ~O(n log k), not a full re-sort."""

    def _sort_chunk(self, chunk):
        if chunk.num_rows == 0:
            return chunk
        keys = [(_collate_eval(e, chunk), d) for e, d in self.plan.by]
        idx = host.sort_indices([k for k, _ in keys], [d for _, d in keys])
        return chunk.take(idx)

    def execute(self):
        from ..utils.disk import ChunkSpill
        from ..utils.memory import approx_chunk_bytes
        tracker = self.tracker()
        buf: list[Chunk] = []
        state = {"bytes": 0, "runs": [], "spilled": 0}

        def spill() -> int:
            if not buf:
                return 0
            run = ChunkSpill()
            run.append(self._sort_chunk(concat_chunks(buf)))
            state["runs"].append(run)
            state["spilled"] += run.bytes_written
            freed = state["bytes"]
            buf.clear()
            state["bytes"] = 0
            return freed

        if tracker is not None:
            tracker.register_spill(spill)
        try:
            for chunk in self.children[0].execute_stream(
                    self._batch_rows()):
                if chunk.num_rows == 0:
                    continue
                b = approx_chunk_bytes(chunk)
                buf.append(chunk)
                state["bytes"] += b
                if tracker is not None:
                    tracker.consume(b)  # may fire spill via the action chain
            if not state["runs"]:
                out = (self._sort_chunk(concat_chunks(buf)) if buf
                       else Chunk.empty([r.ftype for r in
                                         self.plan.schema.refs]))
                if tracker is not None and state["bytes"]:
                    tracker.release(state["bytes"])
                return out
            if buf and tracker is not None:
                tracker.release(spill())
            else:
                spill()
            parts = [run.read(0) for run in state["runs"]]
            merged = self._sort_chunk(concat_chunks(parts))
            self.annotate(spilled_runs=len(state["runs"]),
                          spill_bytes=state["spilled"])
            return merged
        finally:
            if tracker is not None:
                tracker.unregister_spill(spill)
            for run in state["runs"]:
                run.close()

    def _batch_rows(self) -> int:
        # finer batches than the scan default: spill granularity (and the
        # memory the quota can reclaim per action) is one buffered batch
        return 8192


class TopNExec(QueryExecutor):
    """Streaming top-N: memory bounded by offset+count regardless of input
    size (reference: executor/topn.go keeps a bounded heap)."""

    def execute(self):
        p = self.plan
        from ..utils.chunk import DEFAULT_CHUNK_SIZE
        k = p.offset + p.count
        best: Chunk | None = None
        for chunk in self.children[0].execute_stream(DEFAULT_CHUNK_SIZE):
            if chunk.num_rows == 0:
                continue
            cand = chunk if best is None else concat_chunks([best, chunk])
            keys = [(_collate_eval(e, cand), d) for e, d in p.by]
            idx = host.sort_indices([kk for kk, _ in keys],
                                    [d for _, d in keys])
            best = cand.take(idx[:k])
        if best is None:
            return Chunk.empty([r.ftype for r in p.schema.refs])
        return best.slice(p.offset, k)


class LimitExec(QueryExecutor):
    def execute(self):
        chunk = self.children[0].execute()
        p = self.plan
        return chunk.slice(p.offset, p.offset + p.count)


class SetOpExec(QueryExecutor):
    def execute(self):
        p = self.plan
        chunks = []
        for c, child_plan in zip(self.children, p.children):
            ch = c.execute()
            # unify column representations to the SetOp schema
            cols = []
            for i, r in enumerate(p.schema.refs):
                src = ch.columns[i]
                data, nulls = _cast_to(src.data, src.nulls, src.ftype, r.ftype)
                want = np_dtype_for(r.ftype)
                if want is not object and data.dtype != want:
                    data = data.astype(want)
                cols.append(Column(r.ftype, data, nulls))
            chunks.append(Chunk(cols))
        if p.kind == "union_all":
            return concat_chunks(chunks)
        if p.kind == "union":
            merged = concat_chunks(chunks)
            keys = [(c.data, c.nulls) for c in merged.columns]
            _gids, _n, first_idx = host.group_ids(keys)
            return merged.take(np.sort(first_idx))
        a, b = chunks
        akeys = [(c.data, c.nulls) for c in a.columns]
        bkeys = [(c.data, c.nulls) for c in b.columns]
        # dedup left first (set semantics)
        _g, _n, fi = host.group_ids(akeys)
        a = a.take(np.sort(fi))
        akeys = [(c.data, c.nulls) for c in a.columns]
        mask = host.semi_mask(bkeys, akeys)
        if p.kind == "except":
            mask = ~mask
        return a.filter(mask)


class WindowExec(QueryExecutor):
    """Window functions (reference: executor/window.go). Rows sort by
    (partition, order); functions compute vectorized within each partition
    slice over the default frame: with ORDER BY, RANGE UNBOUNDED PRECEDING
    .. CURRENT ROW (peer-aware); without, the whole partition."""

    def execute(self):
        p = self.plan
        chunk = self.children[0].execute()
        n = chunk.num_rows
        if n == 0:
            cols = list(chunk.columns)
            for f in p.funcs:
                dt = np_dtype_for(f.ftype)
                data = (np.empty(0, dtype=object) if dt is object
                        else np.zeros(0, dtype=dt))
                cols.append(Column(f.ftype, data, np.zeros(0, dtype=bool)))
            return Chunk(cols)
        from .device_exec import want_device, device_window, run_device
        from .device_exec import DeviceUnsupported as _DU
        if want_device(self.ctx, n):
            try:
                out = self._with_pipe_stats(
                    run_device, self.ctx, device_window, p, chunk,
                    self.ctx, shape="window")
                self.annotate(engine="tpu")
                return out
            except _DU:
                pass
        if p.partition_exprs:
            pk = [_collate_eval(e, chunk) for e in p.partition_exprs]
            gids, ng, _fi = host.group_ids(pk)
            # ShuffleExec repartitioning (reference: executor/shuffle.go:77):
            # hash partition groups onto worker shards; each shard runs the
            # full sort+compute pipeline independently
            try:
                workers = int(self.ctx.get_sysvar("tidb_window_concurrency"))
                min_rows = int(self.ctx.get_sysvar("tidb_shuffle_min_rows"))
            except Exception:
                workers, min_rows = 1, 1 << 63
            if workers > 1 and n >= min_rows and ng >= workers:
                from .shuffle import shuffle_execute
                self.annotate(shuffle=f"{workers} workers")
                return shuffle_execute(chunk, gids, workers, self._compute)
            return self._compute(chunk, gids)
        return self._compute(chunk)

    def _compute(self, chunk: Chunk, gids=None) -> Chunk:
        p = self.plan
        n = chunk.num_rows
        if gids is None:
            if p.partition_exprs:
                pk = [_collate_eval(e, chunk) for e in p.partition_exprs]
                gids, _ng, _fi = host.group_ids(pk)
            else:
                gids = np.zeros(n, dtype=np.int64)
        order_keys = [(_collate_eval(e, chunk), d) for e, d in p.order_by]
        keys = [(gids, np.zeros(n, dtype=bool))] + [k for k, _ in order_keys]
        descs = [False] + [d for _, d in order_keys]
        idx = host.sort_indices(keys, descs)
        sgids = gids[idx]
        starts = np.nonzero(np.r_[True, sgids[1:] != sgids[:-1]])[0]
        bounds = np.r_[starts, n]
        # peer-group change flags (equal order keys are peers)
        peer_change = np.r_[True, sgids[1:] != sgids[:-1]]
        for (data, nulls), _d in order_keys:
            ds, ns = data[idx], nulls[idx]
            peer_change[1:] |= (ds[1:] != ds[:-1]) | (ns[1:] != ns[:-1])
        inv = np.empty(n, dtype=np.int64)
        inv[idx] = np.arange(n)
        out_cols = list(chunk.columns)
        has_order = bool(order_keys)
        for f in p.funcs:
            vals, nulls = _window_func(f, chunk, idx, bounds, peer_change,
                                       has_order)
            out_cols.append(Column(f.ftype, vals[inv], nulls[inv]))
        return Chunk(out_cols)


def _frame_edges(frame, m, pos):
    """Per-row [start, end] row indexes for an explicit ROWS frame, plus an
    empty-frame mask (e.g. 2 PRECEDING AND 1 PRECEDING at row 0)."""
    _unit, lo, hi = frame

    def edge(b):
        kind, nn = b
        if kind == "unbounded_preceding":
            return np.zeros(m, dtype=np.int64)
        if kind == "unbounded_following":
            return np.full(m, m - 1, dtype=np.int64)
        if kind == "current":
            return pos
        if kind == "preceding":
            return pos - nn
        return pos + nn

    s_raw, e_raw = edge(lo), edge(hi)
    empty = (e_raw < s_raw) | (e_raw < 0) | (s_raw > m - 1)
    return (np.clip(s_raw, 0, m - 1), np.clip(e_raw, 0, m - 1), empty)


def _window_func(f, chunk, idx, bounds, peer_change, has_order):
    """Compute one window function in sorted order → (vals, nulls) arrays
    parallel to idx. Vectorized within each partition slice."""
    n = len(idx)
    name = f.name
    args = []
    for a in f.args:
        d, nl = a.eval(chunk)
        if len(d) != n:  # scalar constants broadcast
            d = np.broadcast_to(d, (n,)) if len(d) == 1 else np.resize(d, n)
            nl = np.broadcast_to(nl, (n,)) if len(nl) == 1 else np.resize(nl, n)
        args.append((np.asarray(d)[idx], np.asarray(nl)[idx]))
    dt = np_dtype_for(f.ftype)
    out = (np.empty(n, dtype=object) if dt is object
           else np.zeros(n, dtype=dt))
    if dt is object:
        out[:] = b""
    out_nulls = np.zeros(n, dtype=bool)

    def const_int(i, default):
        if len(f.args) <= i:
            return default
        d, nl = args[i]
        return default if (len(d) == 0 or nl[0]) else int(d[0])

    for pi in range(len(bounds) - 1):
        lo, hi = int(bounds[pi]), int(bounds[pi + 1])
        m = hi - lo
        pc = peer_change[lo:hi].copy()
        pc[0] = True
        pg = np.cumsum(pc) - 1
        pe = np.searchsorted(pg, pg, side="right") - 1  # peer-group end
        pos = np.arange(m)
        if name == "row_number":
            out[lo:hi] = pos + 1
        elif name == "rank":
            out[lo:hi] = np.searchsorted(pg, pg, side="left") + 1
        elif name == "dense_rank":
            out[lo:hi] = pg + 1
        elif name == "percent_rank":
            first = np.searchsorted(pg, pg, side="left")
            out[lo:hi] = first / (m - 1) if m > 1 else np.zeros(m)
        elif name == "cume_dist":
            out[lo:hi] = (pe + 1) / m
        elif name == "ntile":
            k = const_int(0, 1)
            if k < 1:
                raise TiDBError("Incorrect arguments to ntile")
            q, r = divmod(m, k)
            if q == 0:
                out[lo:hi] = pos + 1
            else:
                cut = r * (q + 1)
                out[lo:hi] = np.where(
                    pos < cut, pos // (q + 1), r + (pos - cut) // q) + 1
        elif name in ("lead", "lag"):
            d, nl = args[0]
            d, nl = d[lo:hi], nl[lo:hi]
            off = const_int(1, 1)
            src = pos + off if name == "lead" else pos - off
            ok = (src >= 0) & (src < m)
            safe = np.clip(src, 0, m - 1)
            if len(f.args) > 2:
                dd, dn = args[2]
                out[lo:hi] = np.where(ok, d[safe], dd[lo:hi])
                out_nulls[lo:hi] = np.where(ok, nl[safe], dn[lo:hi])
            else:
                out[lo:hi] = np.where(ok, d[safe], out[lo:hi])
                out_nulls[lo:hi] = np.where(ok, nl[safe], True)
        elif name == "first_value":
            d, nl = args[0]
            if f.frame is not None:
                ds, ns = d[lo:hi], nl[lo:hi]
                fs, _fe, emp = _frame_edges(f.frame, m, pos)
                out[lo:hi] = ds[fs]
                out_nulls[lo:hi] = ns[fs] | emp
            else:
                out[lo:hi] = d[lo]
                out_nulls[lo:hi] = nl[lo]
        elif name == "last_value":
            d, nl = args[0]
            d, nl = d[lo:hi], nl[lo:hi]
            if f.frame is not None:
                _fs, fe, emp = _frame_edges(f.frame, m, pos)
                out[lo:hi] = d[fe]
                out_nulls[lo:hi] = nl[fe] | emp
            else:
                src = pe if has_order else np.full(m, m - 1)
                out[lo:hi] = d[src]
                out_nulls[lo:hi] = nl[src]
        elif name == "nth_value":
            d, nl = args[0]
            d, nl = d[lo:hi], nl[lo:hi]
            k = const_int(1, 1)
            if k < 1:
                raise TiDBError("Incorrect arguments to nth_value")
            if f.frame is not None:
                fs, fe, emp = _frame_edges(f.frame, m, pos)
                tgt = fs + (k - 1)
                ok = ~emp & (tgt <= fe)
                safe = np.clip(tgt, 0, m - 1)
                out[lo:hi] = np.where(ok, d[safe], out[lo:hi])
                out_nulls[lo:hi] = np.where(ok, nl[safe], True)
            else:
                end = pe if has_order else np.full(m, m - 1)
                ok = (k - 1) <= end
                src = min(k - 1, m - 1)
                out[lo:hi] = np.where(ok, d[src], out[lo:hi])
                out_nulls[lo:hi] = np.where(ok, nl[src], True)
        elif name in ("count", "sum", "avg"):
            d, nl = args[0]
            d, nl = d[lo:hi], nl[lo:hi]
            k = phys_kind(f.args[0].ftype)
            if name == "avg" or k == K_FLOAT or k == K_STR:
                from ..expression.core import _as_float
                vals = np.where(nl, 0.0, _as_float(d, f.args[0].ftype))
            else:
                vals = np.where(nl, 0, d.astype(np.int64))
            cs0 = np.concatenate([[vals.dtype.type(0)], np.cumsum(vals)])
            cnt0 = np.concatenate([[0], np.cumsum(~nl)])
            if f.frame is not None:
                fs, fe, emp = _frame_edges(f.frame, m, pos)
                total = cs0[fe + 1] - cs0[fs]
                nonnull = cnt0[fe + 1] - cnt0[fs]
                nonnull = np.where(emp, 0, nonnull)
                total = np.where(emp, 0, total)
            else:
                at = pe if has_order else np.full(m, m - 1)
                total, nonnull = cs0[at + 1], cnt0[at + 1]
            if name == "count":
                out[lo:hi] = nonnull
            elif name == "avg":
                out[lo:hi] = total / np.maximum(nonnull, 1)
                out_nulls[lo:hi] = nonnull == 0
            else:
                out[lo:hi] = total
                out_nulls[lo:hi] = nonnull == 0
        elif name in ("min", "max"):
            d, nl = args[0]
            d, nl = d[lo:hi], nl[lo:hi]
            at = pe if has_order else np.full(m, m - 1)
            cnt = np.cumsum(~nl)
            if d.dtype == object:
                run = np.empty(m, dtype=object)
                best = None
                for i in range(m):
                    v = None if nl[i] else d[i]
                    if v is not None and (best is None or
                                          (v < best if name == "min"
                                           else v > best)):
                        best = v
                    run[i] = best if best is not None else b""
                out[lo:hi] = run[at]
            else:
                if np.issubdtype(d.dtype, np.floating):
                    sent = np.inf if name == "min" else -np.inf
                else:
                    info = np.iinfo(d.dtype)
                    sent = info.max if name == "min" else info.min
                masked = np.where(nl, sent, d)
                acc = (np.minimum.accumulate(masked) if name == "min"
                       else np.maximum.accumulate(masked))
                out[lo:hi] = acc[at]
            out_nulls[lo:hi] = cnt[at] == 0
        else:
            raise TiDBError(f"unsupported window function {name}")
    return out, out_nulls


_MAP = {
    DataSource: TableScanExec,
    MemSource: MemScanExec,
    Dual: DualExec,
    Selection: SelectionExec,
    Projection: ProjectionExec,
    Aggregation: HashAggExec,
    Join: HashJoinExec,
    Sort: SortExec,
    TopN: TopNExec,
    Limit: LimitExec,
    SetOp: SetOpExec,
    Window: WindowExec,
}
