"""Network coordinator: the coordination segment behind a TCP service.

The shared-memory segment (fabric/coord.py) coordinates one MACHINE's
process fleet.  A multi-host region fleet needs the same lease / epoch /
claim / TSO layout reachable across hosts, so this module puts the
Coordinator's public surface behind a small TCP service speaking
fabric/codec's length-prefixed frames — the exact transport the compile
server already proved out.  The segment stays the storage; the service
is a thin op dispatcher over an attached Coordinator, so single-machine
callers keep the mmap hot path and networked callers get the same
semantics through :class:`NetCoordinator`.

Failure discipline (mirrors compile_client): a torn frame stays a loud
``FrameError`` — classified transport, never silently retried into a
half-read stream.  The client retries each call under a ``coordRetry``
Backoffer budget; when the budget exhausts it marks the server down for
a cooldown window and DEGRADES rather than fails: admission ops answer
locally (admit-all, zero vtimes — the single-tenant behaviors), liveness
reads answer empty, and anything that must not guess (TSO leases, region
epochs, lock claims, WAL frontier writes) raises
:class:`CoordUnavailableError` so the caller's own lease/abort paths
run.  Queries never fail on a coordinator blip; durability never
proceeds on one.
"""

from __future__ import annotations

import contextlib
import logging
import socket
import socketserver
import threading
import time

from . import codec
from ..session import tracing
from ..utils.backoff import Backoffer, BackoffExhaustedError

log = logging.getLogger("tidb_tpu_torch.fabric.coord_net")

DOWN_COOLDOWN_S = 5.0
CONNECT_TIMEOUT_S = 5.0
REQUEST_TIMEOUT_S = 10.0
#: per-call retry budget — coordinator ops are tiny; a call that cannot
#: land inside this is a down server, not a slow one
RETRY_BUDGET_MS = 200.0

#: ops a networked peer may invoke — everything stateful goes through
#: the segment's own locking; anything NOT listed (close/unlink/attach,
#: page-path helpers that only make sense machine-locally) is rejected
OPS = frozenset({
    "bump", "counters",
    "claim_slot", "heartbeat", "release_slot", "live_slots",
    "reclaim_expired",
    "try_acquire_running", "release_running", "running_total",
    "peak_running", "vtimes", "vtime_advance", "charge_hbm",
    "hbm_remote_bytes",
    "tso_lease", "publish_schema_version", "schema_version",
    "wal_len", "set_wal_len", "set_min_read_ts", "fleet_min_read_ts",
    "set_wal_applied", "min_wal_applied",
    "set_commit_frontier", "commit_frontiers",
    "ddl_claim", "ddl_heartbeat", "ddl_release", "ddl_check",
    "lock_claim", "lock_release",
    "region_claim", "region_heartbeat", "region_release",
    "region_release_all", "region_check", "region_set_committed",
    "region_committed_len", "region_set_applied", "region_info",
    "regions_expired", "region_owners",
    "dedup_claim", "dedup_publish", "dedup_fail", "dedup_poll",
    "next_result_id", "prewarm_claim", "result_page_path",
    "table_version_advance", "table_versions",
    "set_direct_port", "direct_ports",
    "perf_merge", "perf_rows", "perf_lookup",
    "snapshot", "verify_drained",
})

#: ops that degrade to a local answer inside the client's down-window —
#: the admission/liveness reads where "no coordination" must mean "solo
#: behavior", never a failed query
_DEGRADE = {
    "try_acquire_running": lambda args, kwargs: True,
    "release_running": lambda args, kwargs: None,
    "vtimes": lambda args, kwargs: {g: 0.0 for g in (args[0] if args
                                                     else [])},
    "vtime_advance": lambda args, kwargs: 0.0,
    "charge_hbm": lambda args, kwargs: None,
    "hbm_remote_bytes": lambda args, kwargs: 0,
    "running_total": lambda args, kwargs: 0,
    "peak_running": lambda args, kwargs: 0,
    "live_slots": lambda args, kwargs: [],
    "heartbeat": lambda args, kwargs: None,
    "set_min_read_ts": lambda args, kwargs: None,
    "fleet_min_read_ts": lambda args, kwargs: 0,
    # frontier publish during a down-window: drop it — the appender's
    # frontier is forward-only and the next fsync (or heartbeat
    # republish) repairs the cell.  commit_frontiers is deliberately NOT
    # degradable: an empty answer would read as "nothing to wait for"
    # and turn a down-window into a silent stale read; the reader's
    # entry point catches CoordUnavailableError and downgrades LOUDLY
    # (stale_ok surfaced in EXPLAIN ANALYZE).  The ddl_* lease ops are
    # not degradable either — a lease minted locally fences nothing
    "set_commit_frontier": lambda args, kwargs: None,
    "bump": lambda args, kwargs: 0,
    "counters": lambda args, kwargs: {},
    # result cache during a down-window: version advances are dropped
    # (the committing worker's tailer peers re-publish on apply, and the
    # cache TTL backstops the remainder) and version READS answer empty —
    # "no fleet version known" makes every fragment cache-ineligible,
    # which degrades to plain in-flight dedup, never to a stale hit
    "table_version_advance": lambda args, kwargs: None,
    "table_versions": lambda args, kwargs: {},
    # observability during a down-window: perf samples drop (observe-
    # only data, recomputed forever), peer discovery answers empty (a
    # cluster memtable degrades to local rows, never a failed query)
    "set_direct_port": lambda args, kwargs: None,
    "direct_ports": lambda args, kwargs: {},
    "perf_merge": lambda args, kwargs: 0,
    "perf_rows": lambda args, kwargs: [],
    "perf_lookup": lambda args, kwargs: [],
    # dedup during a down-window: "miss" is the solo answer — compute
    # locally, no claim held, nothing to publish or leak
    "dedup_claim": lambda args, kwargs: ("miss", -1, 0),
    "prewarm_claim": lambda args, kwargs: True,
}


class CoordUnavailableError(ConnectionError):
    """The coordinator service is unreachable and the op cannot degrade
    locally.  Subclasses ConnectionError so utils/backoff classifies it
    ``transport`` without special-casing."""


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        coord = self.server.coordinator  # type: ignore[attr-defined]
        sock = self.request
        sock.settimeout(REQUEST_TIMEOUT_S)
        while True:
            try:
                req = codec.read_frame(sock)
            except codec.FrameError as e:
                # torn/garbage frame: loud, then drop the connection —
                # resynchronizing a pickled stream is how corruption
                # spreads.  A clean EOF between frames ("got 0 of 8")
                # is the client hanging up, not a tear.
                if "got 0 of" not in str(e):
                    log.warning("torn frame from %s: %s",
                                self.client_address, e)
                return
            except OSError:
                return
            op = req.get("op")
            # record the hop into THIS process's ring on the caller's
            # behalf (one branch for untraced requests)
            rtr = tracing.begin_remote(req.pop("trace", None),
                                       f"coord.{op}")
            if op not in OPS:
                resp = {"ok": False, "err": f"op {op!r} not allowed"}
            else:
                try:
                    ret = getattr(coord, op)(*req.get("args", ()),
                                             **req.get("kwargs", {}))
                    resp = {"ok": True, "ret": ret}
                except Exception as e:  # noqa: BLE001 — errors cross the
                    #   wire by type name; the client re-raises loudly
                    resp = {"ok": False, "err": f"{type(e).__name__}: {e}",
                            "err_type": type(e).__name__}
            sub = tracing.finish_remote(rtr, succ=bool(resp.get("ok")))
            if sub is not None:
                resp["_trace"] = sub
            try:
                codec.write_frame(sock, resp)
            except OSError:
                return


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class CoordServer:
    """Serve an attached Coordinator over TCP.  One thread per
    connection (coordinator ops are microseconds under the segment
    lock; the thread count is bounded by the fleet size)."""

    def __init__(self, coordinator, host: str = "127.0.0.1",
                 port: int = 0):
        self.coordinator = coordinator
        self._srv = _Server((host, port), _Handler)
        self._srv.coordinator = coordinator
        self.address = "%s:%d" % self._srv.server_address[:2]
        self._thread = None

    def start(self) -> str:
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True, name="coord-server")
        self._thread.start()
        log.info("coordinator service on %s", self.address)
        return self.address

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


class NetCoordinator:
    """Client-side Coordinator facade: every segment op becomes one
    framed round trip.  Same method surface as fabric/coord.Coordinator
    (for the allowlisted ops), so RegionStore / DurableMVCCStore /
    admission code cannot tell the difference — except in failure
    behavior, which is the point (see module docstring)."""

    def __init__(self, address: str, *, nregions: "int | None" = None,
                 down_cooldown_s: float = DOWN_COOLDOWN_S):
        self.address = address
        self._down_until = 0.0
        self._down_cooldown = down_cooldown_s
        self._mu = threading.Lock()
        # mirror of Coordinator.nregions for RegionMap sizing; fetched
        # lazily from a snapshot when not given
        self._nregions = nregions

    @property
    def nregions(self) -> int:
        if self._nregions is None:
            snap = self._call("snapshot")
            self._nregions = len(snap.get("regions", []))
        return self._nregions

    def healthy(self) -> bool:
        return time.monotonic() >= self._down_until

    def _mark_down(self):
        self._down_until = time.monotonic() + self._down_cooldown

    def _connect(self):
        host, port = self.address.rsplit(":", 1)
        return socket.create_connection((host, int(port)),
                                        timeout=CONNECT_TIMEOUT_S)

    def _roundtrip(self, req: dict):
        ctx = tracing.wire_ctx()
        if ctx is not None:  # propagate the active trace across the hop
            req["trace"] = ctx
        with self._mu:
            sock = self._connect()
            try:
                sock.settimeout(REQUEST_TIMEOUT_S)
                codec.write_frame(sock, req)
                resp = codec.read_frame(sock)
            finally:
                with contextlib.suppress(OSError):
                    sock.close()
        # graft the coordinator's recorded subtree under the current span
        tracing.attach_remote(resp.pop("_trace", None))
        return resp

    def _call(self, op: str, *args, **kwargs):
        req = {"op": op, "args": args, "kwargs": kwargs}
        if not self.healthy():
            deg = _DEGRADE.get(op)
            if deg is not None:
                return deg(args, kwargs)
            raise CoordUnavailableError(
                f"coordinator {self.address} in down-window")
        bo = Backoffer(budget_ms=RETRY_BUDGET_MS)
        while True:
            try:
                resp = self._roundtrip(req)
                break
            except (OSError, codec.FrameError) as e:
                try:
                    bo.backoff("coordRetry", e)
                except BackoffExhaustedError:
                    self._mark_down()
                    from . import state
                    with contextlib.suppress(Exception):
                        state.bump("fabric_remote_errors")
                    deg = _DEGRADE.get(op)
                    if deg is not None:
                        log.warning("coordinator %s down; %s degrades "
                                    "to local-only", self.address, op)
                        return deg(args, kwargs)
                    raise CoordUnavailableError(
                        f"coordinator {self.address} unreachable: "
                        f"{type(e).__name__}: {e}") from e
        if not resp.get("ok"):
            raise CoordRemoteError(resp.get("err", "unknown error"),
                                   resp.get("err_type"))
        return resp.get("ret")

    #: dedup-claim owner slot (fabric/state.activate).  The server-side
    #: Coordinator instance is SHARED by every TCP client, so claim
    #: ownership cannot live in its instance attribute: remember the
    #: slot here and stamp it onto each dedup_claim request instead —
    #: crash reclaim needs the true owner on every claimed entry
    _owner_slot: "int | None" = None

    def set_claim_owner(self, slot: int):
        self._owner_slot = int(slot)

    def dedup_claim(self, key_hash, ttl_s, vv_hash: int = 0,
                    check_vv: bool = True):
        return self._call("dedup_claim", key_hash, ttl_s,
                          vv_hash=vv_hash, check_vv=check_vv,
                          owner=self._owner_slot)

    def __getattr__(self, name):
        if name.startswith("_") or name not in OPS:
            raise AttributeError(name)

        def call(*args, **kwargs):
            return self._call(name, *args, **kwargs)

        call.__name__ = name
        return call


class CoordRemoteError(RuntimeError):
    """The coordinator executed the op and it raised — a semantic
    failure (bad slot, out-of-range region), not a transport one."""

    def __init__(self, msg: str, err_type: "str | None" = None):
        super().__init__(msg)
        self.err_type = err_type
