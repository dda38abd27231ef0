"""DIAG — the per-worker diagnostics op on the direct MySQL port.

Every fleet worker already listens on a private DIRECT port
(fabric/worker.py); ``DIAG <kind>`` over that wire serves the process's
observability state as one JSON cell: its trace ring, slow-log items,
statement summaries, metrics snapshot, fragment-perf rows.  The cluster
memtables (session/memtables.py ``cluster_*``) are exactly this op
fanned out to every live peer's direct port — same statement an
operator can type by hand against one worker when the fan-out itself is
what's broken.

Statement forms (pre-parse intercept — DIAG is a diagnostics verb, not
SQL grammar):

    DIAG TRACES                recent finished traces (ring rows)
    DIAG TRACEJSON [<gid>]     full stitched trace dicts, optionally
                               only those this process recorded on
                               behalf of origin trace <gid>
    DIAG SLOW | STATEMENTS | PROCESSLIST | METRICS | PERF | STATUS
"""

from __future__ import annotations

import json
import logging
import threading

log = logging.getLogger("tidb_tpu_torch.session.diag")

#: per-peer budget for a cluster fan-out hop: a dead worker costs this
#: long and contributes a tagged error row — never a hang, never a
#: failed query (the cluster memtables' contract)
PEER_TIMEOUT_S = 2.0

_KIND_TABLES = {
    "traces": ("information_schema", "trace_records"),
    "slow": ("information_schema", "slow_query"),
    "statements": ("information_schema", "statements_summary"),
    "processlist": ("information_schema", "processlist"),
}


def maybe_handle(session, sql: str):
    """Intercept a DIAG statement before the SQL parser; None when the
    text is not one (the caller parses normally)."""
    text = sql.strip().rstrip(";").strip()
    head = text[:4].upper()
    if head != "DIAG" or (len(text) > 4 and not text[4].isspace()):
        return None
    parts = text.split()
    kind = parts[1].lower() if len(parts) > 1 else "status"
    arg = parts[2] if len(parts) > 2 else ""
    from ..errors import TiDBError
    from ..sqltypes import TYPE_VARCHAR, FieldType
    from ..utils.chunk import Chunk
    from .session import Result
    try:
        out = payload(session, kind, arg)
    except KeyError:
        raise TiDBError(f"unknown DIAG kind {kind!r}") from None
    ft = FieldType(tp=TYPE_VARCHAR)
    cell = json.dumps(out, default=str).encode()
    return Result(names=["diag"], chunk=Chunk.from_rows([ft], [(cell,)]))


def _jsonify(v):
    if isinstance(v, bytes):
        return v.decode(errors="replace")
    return v


def payload(session, kind: str, arg: str = "") -> dict:
    """The JSON body for one DIAG kind (KeyError on an unknown one)."""
    kind = kind.lower()
    if kind in _KIND_TABLES:
        from .memtables import mem_table
        cols, rows_fn = mem_table(session, *_KIND_TABLES[kind])
        return {"kind": kind, "cols": [n for n, _ft in cols],
                "rows": [[_jsonify(v) for v in r] for r in rows_fn()]}
    if kind == "tracejson":
        from . import tracing
        if arg:
            trs = tracing.traces_for_origin(arg)
        else:
            trs = tracing.recent_traces()
        return {"kind": kind,
                "rows": [tr.to_dict() for tr in trs]}
    if kind == "metrics":
        obs = session.domain.observe
        with obs._lock:
            counters = dict(obs.counters)
        # histograms ride along so a fleet parent can aggregate e.g.
        # freshness_wait_seconds percentiles across workers without
        # scraping each /metrics port (hist_snapshot takes obs._lock
        # itself — must not be called inside the block above)
        hists = {name: {"bounds": list(bounds), "counts": list(counts),
                        "sum": hsum, "count": count}
                 for name, (bounds, counts, hsum, count)
                 in obs.hist_snapshot().items()}
        from . import tracing
        return {"kind": kind, "counters": counters, "hists": hists,
                "tracing": tracing.snapshot()}
    if kind == "perf":
        from ..fabric import perf
        perf.flush()
        return {"kind": kind, "local": perf.local_rows(),
                "fleet": perf.fleet_rows(), "stats": perf.stats()}
    if kind == "status":
        from ..fabric import state
        return {"kind": kind, "fabric": state.snapshot()}
    raise KeyError(kind)


def cluster_fanout(session, kind: str, arg: str = "") -> list:
    """Run one DIAG kind against every live worker's direct port.
    Returns ``[(instance, payload-or-None, err), ...]`` — a dead or
    unreachable peer contributes ``(instance, None, "peer-lost: ...")``
    after at most PEER_TIMEOUT_S, so the cluster memtable row set is
    complete whatever the fleet's health.  Outside a fleet (no
    coordinator, or no published ports) the local process answers alone
    under instance ``"local"`` — single-process deployments keep the
    cluster_* surface."""
    from ..fabric import state
    coord = state.coordinator()
    ports = {}
    if coord is not None:
        try:
            ports = coord.direct_ports()
        except Exception as e:  # noqa: BLE001 — degrade to local,
            #   never fail the query
            log.debug("peer discovery failed, answering locally: %s", e)
            ports = {}
    if not ports:
        return [("local", payload(session, kind, arg), "")]

    results = {}

    def ask(slot, port):
        inst = f"slot{slot}:{port}"
        try:
            from ..fabric.client import FleetClient
            cli = FleetClient(port, timeout=PEER_TIMEOUT_S)
            try:
                stmt = f"DIAG {kind} {arg}".strip()
                _cols, rows = cli.must_query(stmt)
                results[slot] = (inst, json.loads(rows[0][0]), "")
            finally:
                cli.close()
        except Exception as e:  # noqa: BLE001 — the tagged error row
            results[slot] = (inst, None,
                             f"peer-lost: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=ask, args=(s, p), daemon=True)
               for s, p in sorted(ports.items())]
    for t in threads:
        t.start()
    for t in threads:
        # the socket timeout bounds each peer; the join margin only
        # covers scheduling, so a wedged thread can't hold the query
        t.join(PEER_TIMEOUT_S + 1.0)
    for slot, port in sorted(ports.items()):
        if slot not in results:
            results[slot] = (f"slot{slot}:{port}", None,
                             "peer-lost: timeout")
    # the fan-out's hops land on the statement's trace: a dead peer is
    # a visible span event, not just an error cell — the post-mortem
    # for "why is this cluster query partial" reads off the trace
    from . import tracing
    for s in sorted(results):
        inst, _payload, err = results[s]
        tracing.event("cluster.fanout", instance=inst,
                      status="peer-lost" if err else "ok")
    return [results[s] for s in sorted(results)]
