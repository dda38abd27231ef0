"""This process's fabric identity + the ``fabric_*`` gauges.

A worker process calls :func:`activate` once at boot (fabric/worker.py)
with its slot id and an attached :class:`~tidb_tpu_torch.fabric.coord.Coordinator`;
that installs the cross-process hooks into the in-process layers:

* the admission scheduler's fleet hook (fleet-wide per-tenant running
  caps + the shared WFQ virtual clocks),
* the residency ledger's fleet hook (per-tenant HBM charges published to
  the segment; tenant shares read fleet-wide),
* the fragment-dedup handle consulted by device_exec.run_device,
* the span tracer's process label (trace post-mortems name the worker
  that served the statement — the "tracing context across process hops"
  anchor: dedup waits and remote compiles tag the owning slot next to
  this label).

Everything is a no-op in the ordinary single-process deployment:
``active()`` is False, every hook stays None, and ``report_gauges()``
returns ``{}`` so EXPLAIN ANALYZE annotations carry no fabric noise.

Gauges — ``fabric_workers`` (live leases), ``fabric_respawns`` (parent
restart counter), ``fabric_dedup_hits`` (fleet-wide follower reuses),
``fabric_compile_rtt_ms`` (last compile-server round trip) — surface in
EXPLAIN ANALYZE annotations (exec_select splats ``report_gauges()``),
``/status`` (``device_fabric`` payload) and ``/metrics``.
"""

from __future__ import annotations

import logging
import threading

log = logging.getLogger("tidb_tpu_torch.fabric.state")

_LOCK = threading.Lock()

#: the active fabric context: [coordinator, slot, compile_server_addr]
_CTX = [None, -1, None]
_DEDUP = [None]
#: the process's region router (fabric/region.RegionStore) when the
#: keyspace is region-sharded; worker heartbeats drive its lease
#: renewal + expired-lease failover sweep through this handle
_REGIONS = [None]

#: process-local fabric counters (the segment holds the fleet-global
#: ones; these attribute THIS worker's share for its /status payload)
STATS = {
    "fabric_dedup_hits": 0,        # followers served from a peer's page
    "fabric_dedup_leads": 0,       # dedup slots this worker led
    "fabric_dedup_waits": 0,       # dispatches that waited on a peer
    "fabric_dedup_timeouts": 0,    # waits that fell back to local compute
    "fabric_remote_compiles": 0,   # compiles served by the compile server
    "fabric_artifact_hits": 0,     # pipelines deserialized from artifacts
    "fabric_remote_errors": 0,     # compile-server transport failures
    "fabric_compile_rtt_ms": 0.0,  # last compile-server round trip
    "cache_hits": 0,               # versioned result-cache serves
    "cache_invalidations": 0,      # hits refused on a version advance
    "cache_delta_folds": 0,        # hits served by folding the WAL delta
    "cache_stale_reads": 0,        # page-level vv verify caught staleness
    "freshness_waits": 0,          # reads that blocked on the fleet frontier
    "freshness_timeouts": 0,       # waits that blew the budget (9011 raised)
    "freshness_stale_ok": 0,       # reads explicitly downgraded to stale_ok
}


def activate(coordinator, slot: int, compile_server: "str | None" = None,
             lease_hbm: bool = True):
    """Install the fleet hooks for this process (fabric/worker.py boot;
    tests activate in-process)."""
    from . import dedup as dedup_mod
    with _LOCK:
        _CTX[0] = coordinator
        _CTX[1] = int(slot)
        _CTX[2] = compile_server
        coordinator.set_claim_owner(int(slot))
        _DEDUP[0] = dedup_mod.Dedup(coordinator, int(slot))
    from ..executor import scheduler
    scheduler.set_fleet(_SchedFleet(coordinator, int(slot)))
    if lease_hbm:
        from ..ops import residency
        residency.set_fleet(_ResidencyFleet(coordinator, int(slot)))
    from ..session import tracing
    tracing.set_process_label(f"slot{int(slot)}")


def deactivate():
    with _LOCK:
        _CTX[0] = None
        _CTX[1] = -1
        _CTX[2] = None
        _DEDUP[0] = None
        _REGIONS[0] = None
    from ..executor import scheduler
    scheduler.set_fleet(None)
    from ..ops import residency
    residency.set_fleet(None)
    from ..session import tracing
    tracing.set_process_label("")


def active() -> bool:
    return _CTX[0] is not None


def coordinator():
    return _CTX[0]


def slot() -> int:
    return _CTX[1]


def compile_server_addr() -> "str | None":
    """The fleet compile server's socket address, or None.  Worker env
    (TIDB_TPU_COMPILE_SERVER) wins so a standalone process — no fleet —
    can still point at a host-shared compile server."""
    import os
    return os.environ.get("TIDB_TPU_COMPILE_SERVER") or _CTX[2]


def dedup_handle():
    """The fragment-dedup handle (device_exec.run_device consults this
    for batch_key'd dispatches), or None outside a fleet."""
    return _DEDUP[0]


def set_region_store(rs):
    """Register (or clear, with None) this process's region router —
    the worker heartbeat thread then renews its leases and sweeps
    expired siblings' regions for failover."""
    with _LOCK:
        _REGIONS[0] = rs


def region_store():
    return _REGIONS[0]


def host() -> "int | None":
    """The simulated host id this worker runs on (fleet.py spawns
    multi-host fleets with TIDB_TPU_FABRIC_HOST), or None."""
    import os
    h = os.environ.get("TIDB_TPU_FABRIC_HOST")
    return int(h) if h is not None else None


def bump(key: str, n=1):
    with _LOCK:
        STATS[key] += n


def note_rtt(ms: float):
    with _LOCK:
        STATS["fabric_compile_rtt_ms"] = round(ms, 2)


# -- the cross-process hooks --------------------------------------------------

class _SchedFleet:
    """executor/scheduler.py's view of the segment: fleet-wide per-tenant
    running caps (atomic check+charge) and the shared WFQ clocks."""

    def __init__(self, coordinator, slot: int):
        self._c = coordinator
        self._slot = slot

    def try_acquire(self, group: str, cap: int) -> bool:
        return self._c.try_acquire_running(self._slot, group, cap)

    def release(self, group: str):
        self._c.release_running(self._slot, group)

    def vtimes(self, groups) -> dict:
        return self._c.vtimes(groups)

    def advance(self, group: str, delta: float, floor: float):
        self._c.vtime_advance(group, delta, floor)


class _ResidencyFleet:
    """ops/residency.py's view: per-tenant HBM charges published to the
    segment; a tenant's share consumption is read fleet-wide."""

    def __init__(self, coordinator, slot: int):
        self._c = coordinator
        self._slot = slot

    def charge(self, group: str, delta: int):
        self._c.charge_hbm(self._slot, group, delta)

    def remote_bytes(self, group: str) -> int:
        return self._c.hbm_remote_bytes(group, self._slot)


# -- gauges -------------------------------------------------------------------

def snapshot() -> dict:
    """The ``device_fabric`` /status payload: this worker's counters plus
    the fleet-global segment view when attached."""
    with _LOCK:
        out = dict(STATS)
        c, s = _CTX[0], _CTX[1]
    out["slot"] = s
    out["active"] = c is not None
    if c is not None:
        try:
            fleet = c.counters()
            out["fabric_workers"] = len(c.live_slots())
            out["fabric_respawns"] = fleet["fabric_respawns"]
            out["fleet_dedup_hits"] = fleet["fabric_dedup_hits"]
            out["fabric_lease_reclaims"] = fleet["fabric_lease_reclaims"]
            out["fabric_prewarm_dedup"] = fleet["fabric_prewarm_dedup"]
            out["fleet_cache_hits"] = fleet.get("fabric_cache_hits", 0)
            out["fleet_cache_invalidations"] = fleet.get(
                "fabric_cache_invalidations", 0)
            out["fleet_cache_delta_folds"] = fleet.get(
                "fabric_cache_delta_folds", 0)
            out["fleet_cache_stale_reads"] = fleet.get(
                "fabric_cache_stale_reads", 0)
        except Exception as e:  # noqa: BLE001 — segment may be unlinked
            log.debug("fleet counters unreadable: %s", e)
            out["fabric_workers"] = 0
        try:
            seg = c.snapshot()
            out["fabric_perf_rows"] = seg.get("perf_rows_used", 0)
            out["fabric_perf_samples"] = seg.get("perf_samples", 0)
            out["fabric_perf_dropped"] = seg.get("fabric_perf_dropped", 0)
        except Exception as e:  # noqa: BLE001 — same degrade as above
            log.debug("perf-store counters unreadable: %s", e)
    # this process's share of the shared fragment-perf store
    from . import perf as _perf
    out["perf_store"] = _perf.stats()
    return out


def report_gauges() -> dict:
    """EXPLAIN ANALYZE / bench surfacing (same fired-only policy as the
    scheduler/compile-service reports).  Empty outside a fleet, so
    single-process plans carry zero fabric noise."""
    if not active():
        return {}
    s = snapshot()
    out = {"fabric_workers": s.get("fabric_workers", 0)}
    for k in ("fabric_dedup_hits", "fabric_dedup_waits",
              "fabric_artifact_hits", "fabric_remote_compiles",
              "fabric_remote_errors", "fabric_respawns",
              "cache_hits", "cache_invalidations",
              "cache_delta_folds", "cache_stale_reads",
              "freshness_waits", "freshness_timeouts",
              "freshness_stale_ok"):
        if s.get(k):
            out[k] = s[k]
    if s.get("fabric_compile_rtt_ms"):
        out["fabric_compile_rtt_ms"] = s["fabric_compile_rtt_ms"]
    return out


def reset_for_tests():
    with _LOCK:
        for k in STATS:
            STATS[k] = 0.0 if k == "fabric_compile_rtt_ms" else 0
