"""One fleet worker process: Domain + MySQL wire listener behind the
fleet's advertised port, coordinated through the shared segment.

Spawned by fabric/fleet.py as ``python -m tidb_tpu_torch.fabric.worker``
with env config (the fleet's spawn contract — env, not argv, so a respawn
is a bit-identical re-exec):

    TIDB_TPU_FABRIC_COORD       coordinator-file path (required unless
                                COORD_ADDR is set)
    TIDB_TPU_FABRIC_COORD_ADDR  host:port of a CoordServer — the worker
                                coordinates over TCP (fabric/coord_net)
                                instead of attaching the segment; every
                                coordinator op becomes a traced
                                cross-process hop
    TIDB_TPU_FABRIC_SLOT        this worker's slot (required)
    TIDB_TPU_FABRIC_PORT        the advertised SO_REUSEPORT port
    TIDB_TPU_FABRIC_INIT        "module:callable" data-seeding hook(domain)
    TIDB_TPU_FABRIC_GLOBALS     "name=value;..." GLOBAL sysvars at boot
    TIDB_TPU_FABRIC_FAILPOINTS  "name=action;..." chaos failpoints
    TIDB_TPU_FABRIC_HOST        simulated host id (multi-host fleets;
                                presence means "my process group IS my
                                host" — the fabric-kill-host contract)
    TIDB_TPU_COMPILE_SERVER     the separated compile server's socket
    TIDB_TPU_TORCH_DEVICE       the device engine's device (default
                                ``cuda``; ``cpu`` runs every kernel's
                                plain version).  A worker whose device
                                does not exist exits 1 with
                                DeviceNotAvailable's message before it
                                claims its slot, and prints no ready line

Boot order matters: the conn-id base installs BEFORE the Domain
bootstraps (internal sessions must already mint fleet-unique ids), the
coordination hooks install before the listeners open (the first admitted
fragment must already see fleet caps).  Besides the shared listener,
each worker opens a DIRECT port (ephemeral) — the operator/bench door to
one specific process: health checks, per-worker SET GLOBAL, and pinning
load in the cross-process WFQ regression.

Shutdown: SIGTERM → drain (stop accepting, wait for in-flight
connections up to the grace window, emit the worker-summary JSON line,
release the lease) → exit 0.  A lost device (executor/supervisor.py
``mark_device_lost``: a sticky CUDA error, or a card still busy at a
fence's bound) drains the same way and exits LOST_EXIT: CUDA cannot
reconnect inside a process, so the parent's respawn gives the slot a
fresh context (the fleet's counterpart of the reference's backend
reconnect); the statement that met the loss is answered from the host
engine first.  SIGKILL (crash, or the
``fabric-kill-worker`` chaos action) skips all of it — that is the
point: the parent respawns, the lease expires, and the segment reclaim
must make the fleet whole without this process's cooperation.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time

#: lease heartbeat period; the fleet treats a lease older than
#: HEARTBEAT_S * 8 as dead (fleet.py LEASE_TIMEOUT_S)
HEARTBEAT_S = 0.25
#: drain grace for in-flight wire connections on SIGTERM
DRAIN_GRACE_S = 5.0
#: the worker's device: the counterpart of the JAX_PLATFORMS a reference
#: worker inherits (Fleet(env_extra={DEVICE_ENV: "cpu"}) on a box
#: without a card)
DEVICE_ENV = "TIDB_TPU_TORCH_DEVICE"
#: a worker's exit code after its device was lost (not a shutdown: the
#: fleet respawns the slot)
LOST_EXIT = 3
#: the kernel modules whose LAUNCHES the drain summary reports
LAUNCH_COUNTERS = ("expr_vm", "groupby_agg", "sort_topk", "join_probe",
                   "join_expand", "join_match", "merge_states",
                   "window_scan", "radix_exchange", "shuffle_join")


def _parse_kv(raw: str) -> list:
    out = []
    for part in (raw or "").split(";"):
        part = part.strip()
        if part and "=" in part:
            k, _, v = part.partition("=")
            out.append((k.strip(), v.strip()))
    return out


def main() -> int:
    coord_path = os.environ.get("TIDB_TPU_FABRIC_COORD", "")
    coord_addr = os.environ.get("TIDB_TPU_FABRIC_COORD_ADDR", "")
    slot = int(os.environ.get("TIDB_TPU_FABRIC_SLOT", "0"))
    port = int(os.environ.get("TIDB_TPU_FABRIC_PORT", "0"))
    init_spec = os.environ.get("TIDB_TPU_FABRIC_INIT", "")
    if not coord_path and not coord_addr:
        print("worker: TIDB_TPU_FABRIC_COORD not set", file=sys.stderr)
        return 2

    import tidb_tpu_torch  # noqa: F401
    from ..ops import device as dev
    try:
        dev.set_device(os.environ.get(DEVICE_ENV) or "cuda")
        dev.device()
    except dev.DeviceNotAvailable as e:
        print(f"worker: {e}", file=sys.stderr, flush=True)
        return 1
    from . import conn_id_base, state
    from .coord import Coordinator
    from ..session.session import Session

    # fleet-unique conn ids BEFORE any session exists (bootstrap runs
    # internal sessions; their ids must be fleet-unique too)
    Session.set_conn_id_base(conn_id_base(slot))

    if coord_addr:
        # TCP coordination: same op surface, every call a traced hop
        # into the CoordServer process (the bench trace phase runs the
        # fleet this way to prove cross-process stitching)
        from .coord_net import NetCoordinator
        coordinator = NetCoordinator(coord_addr)
    else:
        coordinator = Coordinator.attach(coord_path)
    coordinator.claim_slot(slot)
    state.activate(coordinator, slot,
                   os.environ.get("TIDB_TPU_COMPILE_SERVER") or None)
    from .compile_client import library_from_server
    library_from_server()

    from ..kv import new_store
    from ..session import bootstrap_domain
    from ..server.server import MySQLServer

    wal_dir = os.environ.get("TIDB_TPU_WAL_DIR", "")

    def _boot():
        """[open store → recover → bootstrap → seed], one worker at a
        time under the durable store's init lock: the FIRST worker in
        pays the genesis writes (bootstrap + the init hook's seed
        data), later workers replay them from the shared log and skip —
        the paper's one-storage-layer bootstrap, not N independent
        Domains that merely agree by seeding discipline."""
        d = bootstrap_domain(new_store())
        for name, val in _parse_kv(
                os.environ.get("TIDB_TPU_FABRIC_GLOBALS", "")):
            d.global_vars[name] = val
        if init_spec:
            mod_name, _, fn_name = init_spec.partition(":")
            import importlib
            import inspect
            hook = getattr(importlib.import_module(mod_name), fn_name)
            seeded_key = b"m:fabric_seeded"
            seeded = bool(
                wal_dir
                and d.store.get_snapshot().get(seeded_key) is not None)
            # the hook ALWAYS runs: KV-backed seed data replicates via
            # the shared log (the hook must skip it when `seeded`), but
            # process-LOCAL state — bulk-installed columnar caches —
            # must be rebuilt in every worker
            if "seeded" in inspect.signature(hook).parameters:
                hook(d, seeded=seeded)
            else:
                hook(d)
            if wal_dir and not seeded:
                d.store.mvcc.raw_put(seeded_key, b"1")
        return d

    if wal_dir:
        from ..kv.shared_store import store_init_lock
        with store_init_lock(wal_dir):
            domain = _boot()
    else:
        domain = _boot()

    # chaos failpoints arm AFTER bootstrap/seed: a kill-at-2PC-stage
    # schedule targets SERVED traffic, not the genesis writes (and the
    # fabric-kill-worker hook only ever fires inside _run_query anyway)
    from ..utils import failpoint
    for name, action in _parse_kv(
            os.environ.get("TIDB_TPU_FABRIC_FAILPOINTS", "")):
        failpoint.enable(name, action)

    class FabricMySQLServer(MySQLServer):
        def _run_query(self, io, session, sql):
            # the process-kill chaos hook: `fabric-kill-worker` with a
            # truthy return payload SIGKILLs this worker MID-QUERY — the
            # client must see a clean connection error, the parent must
            # respawn us, and the segment reclaim must free every count
            # this process held (bench_serve fleet chaos + test_fabric)
            if failpoint.inject("fabric-kill-worker"):
                os.kill(os.getpid(), signal.SIGKILL)
            # `fabric-kill-host` takes out the whole simulated HOST: the
            # worker's process group holds every sibling on this host
            # (fleet.py spawns multi-host fleets that way), so one
            # killpg is a machine losing power mid-commit — every
            # region lease the host held expires and must fail over.
            # Outside a multi-host fleet (no TIDB_TPU_FABRIC_HOST) the
            # group may be the test runner's own, so only this process
            # dies — same failpoint, blast radius scoped to what the
            # topology actually isolates.
            if failpoint.inject("fabric-kill-host"):
                if os.environ.get("TIDB_TPU_FABRIC_HOST") is not None:
                    os.killpg(os.getpgid(0), signal.SIGKILL)
                os.kill(os.getpid(), signal.SIGKILL)
            return super()._run_query(io, session, sql)

    shared = FabricMySQLServer(domain, port=port, users={},
                               reuse_port=True).start()
    direct = FabricMySQLServer(domain, port=0, users={}).start()
    try:
        # publish the direct port for peer discovery: cluster memtables
        # (session/diag.py cluster_fanout) reach this worker's DIAG op
        # through the segment's port column; release/reclaim zero it
        coordinator.set_direct_port(slot, direct.port)
    except Exception as e:  # noqa: BLE001 — observe-only surface
        print(f"worker: direct-port publish failed: {e}", file=sys.stderr)

    stop = threading.Event()

    import logging
    hb_log = logging.getLogger("tidb_tpu_torch.fabric.worker")

    def _min_read_ts() -> int:
        """This worker's oldest live snapshot (0 = none): the fleet GC
        floor column (kv/gcworker._fleet_min_read_ts reads the min)."""
        starts = [
            s.txn.start_ts for s in list(domain.sessions.values())
            if getattr(s, "txn", None) is not None and s.txn.valid]
        return min(starts) if starts else 0

    from . import perf as fabric_perf

    def heartbeat():
        n = 0
        while not stop.is_set():
            try:
                coordinator.heartbeat(slot)
                coordinator.set_min_read_ts(slot, _min_read_ts())
                # republish the durable commit frontier each beat: a
                # publish swallowed by a coordinator down-window is
                # repaired here, so peers' freshness waits never gate
                # on a stale column longer than one beat
                pf = getattr(domain.store.mvcc, "publish_frontier", None)
                if pf is not None:
                    pf()
                # drain buffered fragment-perf deltas into the shared
                # store (one locked merge; a no-op when nothing queued)
                fabric_perf.flush()
                n += 1
                if n % 8 == 0:
                    # peer-reclaim sweep: a crashed sibling's lease is
                    # reclaimed by whoever notices first (the parent
                    # usually wins; this covers a dead parent too)
                    coordinator.reclaim_expired(HEARTBEAT_S * 8)
                rs = state.region_store()
                if rs is not None:
                    # region leases ride the same beat: renew ours
                    # (losing one closes that store before a stale
                    # write can race the new owner), and every 8th
                    # beat sweep for a dead host's expired regions —
                    # the survivor side of host-loss failover
                    rs.heartbeat()
                    if n % 8 == 0:
                        rs.failover_expired()
            except Exception as e:  # noqa: BLE001 — a missed beat is
                #   recoverable; a dead segment means the fleet is gone
                hb_log.warning("lease heartbeat failed: %s", e)
            stop.wait(HEARTBEAT_S)

    threading.Thread(target=heartbeat, daemon=True,
                     name="fabric-heartbeat").start()

    def on_term(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    lost = []

    def on_lost(reason):
        hb_log.error("device lost (%s): draining; the fleet respawns "
                     "this slot", reason)
        lost.append(reason)
        stop.set()

    from ..executor import supervisor
    supervisor.on_device_lost(on_lost)

    print(json.dumps({"metric": "fabric_worker_ready", "slot": slot,
                      "pid": os.getpid(), "port": shared.port,
                      "direct_port": direct.port}), flush=True)
    stop.wait()

    # -- drain ---------------------------------------------------------------
    shared.shutdown()
    direct.shutdown()
    deadline = time.monotonic() + DRAIN_GRACE_S
    while ((shared.connections or direct.connections)
           and time.monotonic() < deadline):
        time.sleep(0.02)
    from ..executor import compile_service, scheduler
    summary = {
        "metric": "fabric_worker_summary", "slot": slot,
        "pid": os.getpid(),
        # where this worker imported the package from
        "package": os.path.dirname(os.path.dirname(os.path.abspath(
            __file__))),
        "drained_conns": not (shared.connections or direct.connections),
        "sched": {k: v for k, v in scheduler.snapshot().items()
                  if k in ("admitted", "queued", "fast_grants",
                           "sched_batched_fragments", "rejected_full",
                           "rejected_timeout",
                           "sched_admission_waits_ms")},
        "compile": compile_service.report_gauges(),
        "fabric": {k: v for k, v in state.snapshot().items()
                   if isinstance(v, (int, float))},
        "device_lost": lost[0] if lost else "",
    }
    from ..kv import wal as wal_mod
    summary["wal"] = {k: v for k, v in wal_mod.snapshot().items() if v}
    # this incarnation's card launches per kernel (the plain versions on
    # the CPU count none)
    import importlib
    summary["launches"] = {
        name: importlib.import_module(
            f"..ops.kernels.{name}", __package__).LAUNCHES[0]
        for name in LAUNCH_COUNTERS}
    # this incarnation's kernel-library builds: nvcc runs here, and the
    # times the compile server handed the library over instead
    from ..ops.kernels import build as kernel_build
    summary["kernel_build"] = dict(kernel_build.STATS)
    print(json.dumps(summary), flush=True)
    # last perf drain while the coordinator is still attached — the
    # samples this worker buffered since the final heartbeat
    try:
        fabric_perf.flush()
    except Exception as e:  # noqa: BLE001 — observe-only, never blocks
        #   the drain
        logging.getLogger("tidb_tpu_torch.fabric.worker").debug(
            "final perf drain failed: %s", e)
    # hooks OFF before the segment closes: session teardown + interpreter
    # exit still run residency GC callbacks, and a charge against a
    # closed coordinator would only log noise
    state.deactivate()
    # flush + close the durable store BEFORE releasing the lease: the
    # lease drop is the "my applied column no longer gates truncation"
    # signal, so the log handle must already be quiesced
    domain.store.close()
    coordinator.release_slot(slot)
    if hasattr(coordinator, "close"):  # NetCoordinator has no segment
        coordinator.close()
    return LOST_EXIT if lost else 0


if __name__ == "__main__":
    sys.exit(main())
