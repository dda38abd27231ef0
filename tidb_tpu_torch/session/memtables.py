"""information_schema virtual tables (reference: infoschema/tables.go — 75+
memtables; the core set here, growing with the engine)."""

from __future__ import annotations

from ..errors import SchemaError
from ..sqltypes import TYPE_LONGLONG, TYPE_VARCHAR, FieldType

from ..sqltypes import TYPE_DOUBLE

_S = FieldType(tp=TYPE_VARCHAR)
_I = FieldType(tp=TYPE_LONGLONG)
_F = FieldType(tp=TYPE_DOUBLE)


def mem_table(session, db: str, name: str):
    """-> ([(col_name, ftype)], rows_fn)."""
    fn = _TABLES.get((db, name))
    if fn is None:
        raise SchemaError(f"Table '{db}.{name}' doesn't exist")
    return fn(session)


def _schemata(session):
    cols = [("catalog_name", _S), ("schema_name", _S),
            ("default_character_set_name", _S),
            ("default_collation_name", _S)]

    def rows():
        out = [(b"def", b"information_schema", b"utf8mb4", b"utf8mb4_bin")]
        for n in session.infoschema().schema_names():
            out.append((b"def", n.encode(), b"utf8mb4", b"utf8mb4_bin"))
        return out
    return cols, rows


def _tables(session):
    cols = [("table_catalog", _S), ("table_schema", _S), ("table_name", _S),
            ("table_type", _S), ("engine", _S), ("table_rows", _I),
            ("auto_increment", _I), ("tidb_table_id", _I)]

    def rows():
        out = []
        infos = session.infoschema()
        for dbn in infos.schema_names():
            for t in infos.tables_in_schema(dbn):
                ttype = (b"VIEW" if t.is_view
                         else b"SEQUENCE" if t.is_sequence
                         else b"BASE TABLE")
                nrows = (session.expr_ctx().table_rows(t.id)
                         if ttype == b"BASE TABLE" else 0)
                out.append((b"def", dbn.encode(), t.name.encode(),
                            ttype, b"tpu-htap", nrows,
                            t.auto_increment, t.id))
        return out
    return cols, rows


def _views(session):
    cols = [("table_catalog", _S), ("table_schema", _S), ("table_name", _S),
            ("view_definition", _S), ("definer", _S), ("security_type", _S)]

    def rows():
        out = []
        infos = session.infoschema()
        for dbn in infos.schema_names():
            for t in infos.tables_in_schema(dbn):
                if t.is_view:
                    out.append((b"def", dbn.encode(), t.name.encode(),
                                t.view["select"].encode(),
                                t.view.get("definer", "").encode(),
                                b"DEFINER"))
        return out
    return cols, rows


def _partitions(session):
    cols = [("table_catalog", _S), ("table_schema", _S), ("table_name", _S),
            ("partition_name", _S), ("partition_ordinal_position", _I),
            ("partition_method", _S), ("partition_expression", _S),
            ("partition_description", _S), ("tidb_partition_id", _I)]

    def rows():
        out = []
        infos = session.infoschema()
        for dbn in infos.schema_names():
            for t in infos.tables_in_schema(dbn):
                p = t.partition
                if p is None:
                    continue
                for pos, d in enumerate(p.defs, 1):
                    if p.type == "range":
                        desc = str(d.less_than)
                    elif p.type == "list":
                        desc = ",".join(str(v) for v in d.in_values)
                    else:
                        desc = ""
                    out.append((b"def", dbn.encode(), t.name.encode(),
                                d.name.encode(), pos,
                                p.type.upper().encode(), p.expr.encode(),
                                desc.encode(), d.id))
        return out
    return cols, rows


def _sequences(session):
    cols = [("table_catalog", _S), ("sequence_schema", _S),
            ("sequence_name", _S), ("start", _I), ("increment", _I),
            ("min_value", _I), ("max_value", _I), ("cache", _I),
            ("cycle", _I)]

    def rows():
        out = []
        infos = session.infoschema()
        for dbn in infos.schema_names():
            for t in infos.tables_in_schema(dbn):
                if t.is_sequence:
                    s = t.sequence
                    out.append((b"def", dbn.encode(), t.name.encode(),
                                s["start"], s["increment"], s["min"],
                                s["max"], s["cache"], s["cycle"]))
        return out
    return cols, rows


def _table_constraints(session):
    cols = [("constraint_catalog", _S), ("constraint_schema", _S),
            ("constraint_name", _S), ("table_schema", _S),
            ("table_name", _S), ("constraint_type", _S)]

    def rows():
        out = []
        infos = session.infoschema()
        for dbn in infos.schema_names():
            for t in infos.tables_in_schema(dbn):
                if t.is_view or t.is_sequence:
                    continue
                db_b = dbn.encode()
                if t.pk_is_handle:
                    out.append((b"def", db_b, b"PRIMARY", db_b,
                                t.name.encode(), b"PRIMARY KEY"))
                for idx in t.indexes:
                    if idx.primary:
                        kind = b"PRIMARY KEY"
                    elif idx.unique:
                        kind = b"UNIQUE"
                    else:
                        continue
                    out.append((b"def", db_b, idx.name.encode(), db_b,
                                t.name.encode(), kind))
                for fk in t.foreign_keys:
                    out.append((b"def", db_b, fk["name"].encode(), db_b,
                                t.name.encode(), b"FOREIGN KEY"))
        return out
    return cols, rows


def _gc_status(session):
    """GC worker state as rows (the mysql.tidb tikv_gc_* variables role,
    reference: gc_worker.go saveValueToSysTable)."""
    cols = [("variable_name", _S), ("variable_value", _S)]

    def rows():
        import time as _t
        st = session.domain.gc_worker.status()
        lr = st["last_run"]
        return [
            (b"tikv_gc_safe_point", str(st["safe_point"]).encode()),
            (b"tikv_gc_last_run_time",
             (_t.strftime("%Y-%m-%d %H:%M:%S", _t.localtime(lr)).encode()
              if lr else b"")),
            (b"tikv_gc_run_interval",
             f"{int(st['run_interval_s'])}s".encode()),
            (b"tikv_gc_life_time", f"{int(st['life_time_s'])}s".encode()),
            (b"tikv_gc_runs", str(st["runs"]).encode()),
            (b"tikv_gc_locks_resolved",
             str(st["locks_resolved"]).encode()),
        ]
    return cols, rows


def _referential_constraints(session):
    cols = [("constraint_catalog", _S), ("constraint_schema", _S),
            ("constraint_name", _S), ("table_name", _S),
            ("referenced_table_name", _S), ("update_rule", _S),
            ("delete_rule", _S)]

    def rows():
        out = []
        infos = session.infoschema()
        for dbn in infos.schema_names():
            for t in infos.tables_in_schema(dbn):
                for fk in getattr(t, "foreign_keys", []):
                    out.append((b"def", dbn.encode(), fk["name"].encode(),
                                t.name.encode(),
                                fk["ref_table"].encode(),
                                (fk.get("on_update") or
                                 "restrict").upper().encode(),
                                (fk.get("on_delete") or
                                 "restrict").upper().encode()))
        return out
    return cols, rows


def _columns(session):
    cols = [("table_catalog", _S), ("table_schema", _S), ("table_name", _S),
            ("column_name", _S), ("ordinal_position", _I),
            ("is_nullable", _S), ("data_type", _S), ("column_type", _S),
            ("column_key", _S)]

    def rows():
        out = []
        infos = session.infoschema()
        for dbn in infos.schema_names():
            for t in infos.tables_in_schema(dbn):
                for i, c in enumerate(t.public_columns(), 1):
                    out.append((b"def", dbn.encode(), t.name.encode(),
                                c.name.encode(), i,
                                b"NO" if c.ftype.not_null else b"YES",
                                c.ftype.type_name().encode(),
                                c.ftype.sql_string().encode(), b""))
        return out
    return cols, rows


def _statistics(session):
    cols = [("table_schema", _S), ("table_name", _S), ("non_unique", _I),
            ("index_name", _S), ("seq_in_index", _I), ("column_name", _S)]

    def rows():
        out = []
        infos = session.infoschema()
        for dbn in infos.schema_names():
            for t in infos.tables_in_schema(dbn):
                if t.pk_is_handle:
                    pk = next((c.name for c in t.columns
                               if c.id == t.pk_col_id), "")
                    out.append((dbn.encode(), t.name.encode(), 0,
                                b"PRIMARY", 1, pk.encode()))
                for idx in t.indexes:
                    for seq, ic in enumerate(idx.columns, 1):
                        out.append((dbn.encode(), t.name.encode(),
                                    0 if idx.unique else 1,
                                    idx.name.encode(), seq, ic.name.encode()))
        return out
    return cols, rows


def _engines(session):
    cols = [("engine", _S), ("support", _S), ("comment", _S)]

    def rows():
        return [(b"tpu-htap", b"DEFAULT", b"TPU-native HTAP engine")]
    return cols, rows


def processlist_rows(session, max_info=0):
    """One row per live session of the domain — the single source for
    SHOW [FULL] PROCESSLIST and information_schema.processlist
    (reference: executor/show.go fetchShowProcessList)."""
    import time as _t
    out = []
    for s in sorted(session.domain.sessions.values(),
                    key=lambda s: s.conn_id):
        running = s.current_sql is not None
        info = s.current_sql or ""
        if max_info:
            info = info[:max_info]
        out.append((
            s.conn_id, s.user.encode(), b"localhost",
            s.current_db().encode(),
            b"Query" if running else b"Sleep",
            int(_t.time() - s.stmt_start) if running else 0,
            b"autocommit" if s.txn is None else b"in transaction",
            info.encode()))
    return out


def _placement_policies(session):
    """reference: infoschema placement_policies (ddl/placement_policy.go)."""
    cols = [("policy_name", _S), ("primary_region", _S), ("regions", _S),
            ("followers", _I), ("learners", _I), ("schedule", _S),
            ("constraints", _S)]

    def rows():
        from ..meta import Meta
        txn = session.domain.store.begin()
        try:
            pols = Meta(txn).placement_policies()
        finally:
            txn.rollback()
        out = []
        for key, rec in sorted(pols.items()):
            o = rec.get("options", rec)  # tolerate pre-display records
            out.append((rec.get("display", key).encode(),
                        str(o.get("primary_region", "")).encode(),
                        str(o.get("regions", "")).encode(),
                        int(o.get("followers", 0) or 0),
                        int(o.get("learners", 0) or 0),
                        str(o.get("schedule", "")).encode(),
                        str(o.get("constraints", "")).encode()))
        return out
    return cols, rows


def _processlist(session):
    cols = [("id", _I), ("user", _S), ("host", _S), ("db", _S),
            ("command", _S), ("time", _I), ("state", _S), ("info", _S)]

    def rows():
        out = processlist_rows(session)
        return out
    return cols, rows


def _slow_query(session):
    """reference: executor/slow_query.go reading the slow log back as SQL."""
    cols = [("time", _S), ("user", _S), ("db", _S), ("query_time", _F),
            ("digest", _S), ("query", _S), ("result_rows", _I),
            ("succ", _I), ("plan", _S), ("trace", _S)]

    def rows():
        import datetime as _dt
        out = []
        for it in list(session.domain.observe.slow_queries):
            ts = _dt.datetime.fromtimestamp(it.ts).strftime(
                "%Y-%m-%d %H:%M:%S.%f")
            out.append((ts.encode(), it.user.encode(), it.db.encode(),
                        it.duration_s, it.digest.encode(), it.sql.encode(),
                        it.rows, 1 if it.succ else 0, it.plan.encode(),
                        getattr(it, "trace", "").encode()))
        return out
    return cols, rows


def _trace_records(session):
    """Recent query-lifecycle traces (session/tracing.py ring): one row
    per finished trace with its rendered span tree — the reference's
    trace memtable shape over the bounded process-wide ring."""
    from . import tracing
    cols = [("trace_id", _I), ("parent_id", _I), ("origin", _S),
            ("name", _S), ("start_ts", _S), ("duration_s", _F),
            ("spans", _I), ("dropped", _I), ("conn_id", _I), ("succ", _I),
            ("tree", _S)]

    def rows():
        import datetime as _dt
        out = []
        for tr in tracing.recent_traces():
            ts = _dt.datetime.fromtimestamp(tr.started_at).strftime(
                "%Y-%m-%d %H:%M:%S.%f")
            out.append((tr.trace_id, tr.parent_id or 0,
                        tr.origin.encode(), tr.name.encode(), ts.encode(),
                        tr.dur_s if tr.dur_s is not None else 0.0,
                        len(tr.spans), tr.dropped, tr.conn_id or 0,
                        1 if tr.succ else 0,
                        tracing.render_tree(tr).encode()))
        return out
    return cols, rows


def _statements_summary(session):
    """reference: util/stmtsummary/statement_summary.go."""
    cols = [("digest", _S), ("exec_count", _I), ("sum_latency", _F),
            ("max_latency", _F), ("min_latency", _F), ("avg_latency", _F),
            ("sum_result_rows", _I), ("err_count", _I),
            ("schema_name", _S), ("digest_text", _S)]

    def rows():
        out = []
        for st in list(session.domain.observe.stmt_summary.values()):
            avg = st.sum_latency / st.exec_count if st.exec_count else 0.0
            out.append((st.digest.encode(), st.exec_count, st.sum_latency,
                        st.max_latency,
                        0.0 if st.min_latency == float("inf")
                        else st.min_latency,
                        avg, st.sum_rows, st.err_count,
                        st.db.encode(), st.sample_sql.encode()))
        return out
    return cols, rows


def _metrics(session):
    """Flat counter registry snapshot (reference: metrics/metrics.go)."""
    cols = [("name", _S), ("value", _I)]

    def rows():
        return [(k.encode(), v) for k, v in
                sorted(session.domain.observe.counters.items())]
    return cols, rows


def _tidb_indexes(session):
    cols = [("table_schema", _S), ("table_name", _S), ("key_name", _S),
            ("column_name", _S), ("index_id", _I)]

    def rows():
        out = []
        infos = session.infoschema()
        for dbn in infos.schema_names():
            for t in infos.tables_in_schema(dbn):
                for idx in t.indexes:
                    for ic in idx.columns:
                        out.append((dbn.encode(), t.name.encode(),
                                    idx.name.encode(), ic.name.encode(),
                                    idx.id))
        return out
    return cols, rows


def _character_sets(session):
    cols = [("character_set_name", _S), ("default_collate_name", _S),
            ("description", _S), ("maxlen", _I)]

    def rows():
        from ..utils.collate import CHARSETS
        return [(name, dflt, desc, maxlen)
                for name, desc, dflt, maxlen in CHARSETS]
    return cols, rows


def _collations(session):
    cols = [("collation_name", _S), ("character_set_name", _S), ("id", _I),
            ("is_default", _S), ("is_compiled", _S), ("sortlen", _I)]

    def rows():
        from ..utils.collate import COLLATIONS
        return list(COLLATIONS)
    return cols, rows


def _key_column_usage(session):
    cols = [("constraint_name", _S), ("table_schema", _S), ("table_name", _S),
            ("column_name", _S), ("ordinal_position", _I)]

    def rows():
        out = []
        infos = session.infoschema()
        for dbn in infos.schema_names():
            for t in infos.tables_in_schema(dbn):
                for idx in t.indexes:
                    if not idx.unique:
                        continue
                    cname = b"PRIMARY" if idx.primary else idx.name.encode()
                    for seq, ic in enumerate(idx.columns, 1):
                        out.append((cname, dbn.encode(), t.name.encode(),
                                    ic.name.encode(), seq))
        return out
    return cols, rows


def _tidb_top_sql(session):
    """TopSQL per-digest CPU attribution (reference: util/topsql — the
    pubsub report surface becomes this memtable)."""
    cols = [("sql_digest", _S), ("sample_sql", _S), ("cpu_time_ms", _F),
            ("samples", _I), ("last_seen", _F)]

    def rows():
        return [(e.digest.encode(), e.sample_sql.encode(),
                 round(e.cpu_ms, 3), e.samples, e.last_seen)
                for e in session.domain.topsql.top()]
    return cols, rows


def _perf_stmt_summary(session):
    """performance_schema.events_statements_summary_by_digest (reference:
    perfschema/tables.go) — MySQL perf-schema shape over the engine's
    statement summary; latencies in picoseconds like MySQL."""
    cols = [("schema_name", _S), ("digest", _S), ("digest_text", _S),
            ("count_star", _I), ("sum_timer_wait", _I),
            ("min_timer_wait", _I), ("max_timer_wait", _I),
            ("sum_rows_sent", _I), ("sum_errors", _I),
            ("first_seen", _F), ("last_seen", _F)]
    ps = 1_000_000_000_000  # seconds → picoseconds

    def rows():
        obs = session.domain.observe
        out = []
        with obs._lock:
            items = list(obs.stmt_summary.values())
        for st in items:
            out.append((st.db.encode(), st.digest.encode(),
                        st.sample_sql.encode(), st.exec_count,
                        int(st.sum_latency * ps),
                        int((0 if st.min_latency == float("inf")
                             else st.min_latency) * ps),
                        int(st.max_latency * ps), st.sum_rows,
                        st.err_count, st.first_seen, st.last_seen))
        return out
    return cols, rows


def _metrics_summary(session):
    """metrics_schema.metrics_summary (reference:
    infoschema/metrics_schema.go — PromQL-backed there; backed by the
    engine's counter registry here)."""
    cols = [("metrics_name", _S), ("sum_value", _F), ("comment", _S)]

    def rows():
        obs = session.domain.observe
        with obs._lock:
            items = sorted(obs.counters.items())
        return [(k.encode(), float(v), b"engine counter") for k, v in items]
    return cols, rows


def _metrics_tables(session):
    """information_schema.metrics_tables: the defined-metrics registry
    (reference: infoschema/tables.go tableMetricTables)."""
    cols = [("table_name", _S), ("promql", _S), ("labels", _S),
            ("comment", _S)]

    def rows():
        obs = session.domain.observe
        with obs._lock:
            names = sorted(obs.counters)
        return [(k.encode(), f"sum({k})".encode(), b"", b"engine counter")
                for k in names]
    return cols, rows


def _zero(ft):
    if ft is _I:
        return 0
    if ft is _F:
        return 0.0
    return b""


def _coerce(v, ft):
    try:
        if ft is _I:
            return int(v or 0)
        if ft is _F:
            return float(v or 0.0)
        return ("" if v is None else str(v)).encode()
    except (TypeError, ValueError):
        return _zero(ft)


def _cluster(base_builder, kind: str):
    """A cluster_* memtable: the base table's rows from EVERY live
    worker, fetched as ``DIAG <kind>`` over each peer's direct port
    (session/diag.py cluster_fanout).  Two columns prefix the base
    schema: ``instance`` (which worker answered) and ``error`` — a dead
    peer contributes exactly one row with error="peer-lost: ..." and
    zero-valued base columns, after a bounded per-peer timeout.  Outside
    a fleet the local process answers alone as instance "local"."""
    def build(session):
        base_cols, _ = base_builder(session)
        cols = [("instance", _S), ("error", _S)] + base_cols

        def rows():
            from .diag import cluster_fanout
            out = []
            for inst, payload, err in cluster_fanout(session, kind):
                if err:
                    out.append((inst.encode(), err.encode()) + tuple(
                        _zero(ft) for _n, ft in base_cols))
                    continue
                for r in payload.get("rows", ()):
                    out.append((inst.encode(), b"") + tuple(
                        _coerce(v, ft)
                        for v, (_n, ft) in zip(r, base_cols)))
            return out
        return cols, rows
    return build


def _fragment_perf(session):
    """information_schema.tidb_fragment_perf: the shared fragment
    performance store (fabric/coord.py PERF section via fabric/perf.py)
    — fleet-aggregated count/sum/max and sketch percentiles per
    (fragment sig, row bucket, backend, duration kind), with this
    worker's own sample count alongside so "fleet > any single worker"
    is visible in one row.  Observe-only: nothing reads this to make a
    routing decision."""
    from ..fabric import perf
    cols = [("sig_hash", _S), ("bucket", _I), ("backend", _S),
            ("kind", _S), ("count", _I), ("sum_s", _F), ("max_s", _F),
            ("p50_s", _F), ("p99_s", _F), ("local_count", _I)]

    def rows():
        perf.flush()
        local = {(r["sig_hash"], r["bucket"], r["backend"], r["kind"]):
                 r["count"] for r in perf.local_rows()}
        out = []
        for r in perf.fleet_rows():
            key = (r["sig_hash"], r["bucket"], r["backend"], r["kind"])
            out.append((
                f"{r['sig_hash']:016x}".encode(), r["bucket"],
                perf.BACKENDS[r["backend"]].encode(),
                perf.KINDS[r["kind"]].encode(),
                r["count"], r["sum_s"], r["max_s"],
                perf.percentile(r["sketch"], r["count"], 0.50) or 0.0,
                perf.percentile(r["sketch"], r["count"], 0.99) or 0.0,
                local.get(key, 0)))
        return out
    return cols, rows


_TABLES = {
    ("information_schema", "tidb_top_sql"): _tidb_top_sql,
    ("information_schema", "metrics_tables"): _metrics_tables,
    ("performance_schema", "events_statements_summary_by_digest"):
        _perf_stmt_summary,
    ("metrics_schema", "metrics_summary"): _metrics_summary,
    ("information_schema", "schemata"): _schemata,
    ("information_schema", "tables"): _tables,
    ("information_schema", "columns"): _columns,
    ("information_schema", "statistics"): _statistics,
    ("information_schema", "engines"): _engines,
    ("information_schema", "processlist"): _processlist,
    ("information_schema", "tidb_indexes"): _tidb_indexes,
    ("information_schema", "character_sets"): _character_sets,
    ("information_schema", "collations"): _collations,
    ("information_schema", "placement_policies"): _placement_policies,
    ("information_schema", "key_column_usage"): _key_column_usage,
    ("information_schema", "slow_query"): _slow_query,
    ("information_schema", "trace_records"): _trace_records,
    ("information_schema", "statements_summary"): _statements_summary,
    ("information_schema", "cluster_slow_query"):
        _cluster(_slow_query, "slow"),
    ("information_schema", "cluster_trace_records"):
        _cluster(_trace_records, "traces"),
    ("information_schema", "cluster_statements_summary"):
        _cluster(_statements_summary, "statements"),
    ("information_schema", "cluster_processlist"):
        _cluster(_processlist, "processlist"),
    ("information_schema", "tidb_fragment_perf"): _fragment_perf,
    ("information_schema", "metrics"): _metrics,
    ("information_schema", "views"): _views,
    ("information_schema", "partitions"): _partitions,
    ("information_schema", "sequences"): _sequences,
    ("information_schema", "table_constraints"): _table_constraints,
    ("information_schema", "referential_constraints"):
        _referential_constraints,
    ("information_schema", "gc_status"): _gc_status,
}
