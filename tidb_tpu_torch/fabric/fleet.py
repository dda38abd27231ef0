"""The fleet parent supervisor: spawn N worker processes behind one
advertised port, restart crashed workers with backoff, drain on
shutdown.

The parent owns the shared pieces — the coordination segment
(fabric/coord.py), the advertised port reservation (a bound
SO_REUSEPORT socket that never listens, so the number stays ours while
only the workers' listening sockets receive connections), and optionally
the separated compile server subprocess — and supervises worker
lifecycles:

* **ready protocol**: each worker prints one ``fabric_worker_ready``
  JSON line (slot, pid, shared port, direct port); a per-child reader
  thread collects it plus the drain-time summary line.  Every other
  stdout line is forwarded to :attr:`Fleet.lines` for the bench.
* **restart-on-crash**: a worker exiting outside a shutdown is
  reclaimed (its segment lease + running counts zeroed, counted in
  ``fabric_lease_reclaims``) and respawned after an exponential backoff
  (`BACKOFF_BASE_S * 2^k`, capped) — `RESPAWN_LIMIT` consecutive fast
  deaths park the slot instead of hot-looping a crashing binary.
  Respawns count into the segment (``fabric_respawns``) so every worker
  and the bench see the same number.
* **drain-on-shutdown**: SIGTERM → workers stop accepting, finish
  in-flight connections, emit summaries, release leases; stragglers are
  SIGKILLed after the grace window and force-reclaimed.  The segment's
  :meth:`~tidb_tpu_torch.fabric.coord.Coordinator.verify_drained` is captured
  before unlink so callers can assert zero leaked leases/tickets.
* **simulated hosts** (``hosts=N``): workers are partitioned into N
  process groups, one per "host" (slot `i` lives on host ``i % N``); the
  first live worker of a host is its group leader.  :meth:`Fleet.kill_host`
  SIGKILLs the whole group at once — the chaos shape where an entire
  machine (every region lease it held) vanishes mid-commit, which is
  what region failover (fabric/region.py) must survive.  ``nregions``
  sizes the segment's region table so those leases exist to lose.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

from .coord import Coordinator

log = logging.getLogger("tidb_tpu_torch.fabric.fleet")

BACKOFF_BASE_S = 0.2
BACKOFF_CAP_S = 2.0
#: consecutive crash-respawns before a slot is parked (a worker that
#: lives longer than STABLE_S resets its slot's crash counter)
RESPAWN_LIMIT = 5
STABLE_S = 10.0
#: a lease older than this is a dead worker (worker.HEARTBEAT_S * 8)
LEASE_TIMEOUT_S = 2.0


class _Slot:
    def __init__(self, idx: int):
        self.idx = idx
        self.proc = None
        self.pid = 0
        self.direct_port = 0
        self.ready = threading.Event()
        self.summary = None
        self.crashes = 0          # consecutive fast deaths
        self.started_at = 0.0
        self.parked = False


class Fleet:
    def __init__(self, procs: int, *, init: str = "",
                 sysvars: "dict | None" = None,
                 compile_server: bool = True,
                 run_dir: "str | None" = None,
                 env_extra: "dict | None" = None,
                 slot_env: "dict | None" = None,
                 durable: bool = True,
                 hosts: int = 1,
                 nregions: int = 0,
                 net_coord: bool = False):
        """`init`: a "module:callable" data-seeding hook — under the
        durable store (the default) it runs ONCE fleet-wide (the first
        worker seeds, the rest replay the shared log); with
        ``durable=False`` every worker runs it against an independent
        in-memory Domain (the topology before the shared store).  `sysvars`:
        GLOBAL sysvars every worker applies at boot.  `slot_env`:
        {slot: {ENV: val}} extras for individual workers (the chaos
        schedule's door: e.g.
        ``{2: {"TIDB_TPU_FABRIC_FAILPOINTS": "fabric-kill-worker=1*return(1)"}}``).
        `hosts`: partition workers into this many per-host process
        groups (1 = the classic single-host fleet, no extra groups).
        `nregions`: region cells to allocate in the segment.
        `net_coord`: serve the segment over a CoordServer and point the
        workers at it (TIDB_TPU_FABRIC_COORD_ADDR) — every coordinator
        op becomes a traced TCP hop into the parent process, the
        topology the distributed-trace stitching bench asserts on.  The
        parent keeps its direct segment handle either way."""
        self.procs = procs
        self.hosts = max(int(hosts), 1)
        self.nregions = int(nregions)
        self._host_pgid: dict[int, int] = {}
        self.init = init
        self.durable = durable
        self.sysvars = dict(sysvars or {})
        self.with_compile_server = compile_server
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="torchfab-")
        self.env_extra = dict(env_extra or {})
        self.slot_env = {int(k): dict(v) for k, v in
                         (slot_env or {}).items()}
        self.slots = [_Slot(i) for i in range(procs)]
        self.lines: list = []      # non-protocol worker stdout lines
        self.net_coord = bool(net_coord)
        self.coord_server = None
        self.coord_addr = ""
        self.coord: "Coordinator | None" = None
        self.compile_server_proc = None
        self.compile_server_addr = ""
        self.port = 0
        self._reserve_sock = None
        self._stopping = threading.Event()
        self._monitor = None
        self._mu = threading.Lock()
        self.final_drained: "dict | None" = None

    # -- lifecycle -----------------------------------------------------------

    def start(self, timeout_s: float = 120.0) -> "Fleet":
        os.makedirs(self.run_dir, exist_ok=True)
        self.coord = Coordinator.create(
            os.path.join(self.run_dir, "coord.json"),
            nslots=max(self.procs, 2), nregions=self.nregions)
        if self.net_coord:
            from .coord_net import CoordServer
            self.coord_server = CoordServer(self.coord)
            self.coord_addr = self.coord_server.start()
        self._reserve_port()
        if self.with_compile_server:
            self._spawn_compile_server(timeout_s)
        for s in self.slots:
            self._spawn(s)
        deadline = time.monotonic() + timeout_s
        for s in self.slots:
            if not s.ready.wait(max(deadline - time.monotonic(), 0.1)):
                raise RuntimeError(
                    f"fabric worker slot {s.idx} not ready within "
                    f"{timeout_s}s (see its stderr above)")
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="fabric-fleet-monitor")
        self._monitor.start()
        return self

    def _reserve_port(self):
        """Hold the advertised number with a bound, never-listening
        SO_REUSEPORT socket: only LISTENING sockets receive connections,
        so the kernel balances purely across the workers."""
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind(("127.0.0.1", 0))
        self._reserve_sock = s
        self.port = s.getsockname()[1]

    def _spawn_compile_server(self, timeout_s: float):
        addr = os.path.join(self.run_dir, "compile.sock")
        proc = subprocess.Popen(
            [sys.executable, "-m", "tidb_tpu_torch.fabric.compile_server",
             "--socket", addr],
            env=self._base_env(), stdout=subprocess.PIPE,
            text=True, cwd=os.getcwd())
        self.compile_server_proc = proc
        # BOUNDED ready wait (a wedged server must fail start, not hang
        # it): the readline happens on a reaper-able thread and the
        # spawner waits on an event with the boot budget
        ready_evt = threading.Event()
        first_line = [""]

        def _read_first():
            first_line[0] = proc.stdout.readline()
            ready_evt.set()
            self._drain_stdout(proc)

        threading.Thread(target=_read_first, daemon=True,
                         name="fabric-compile-server-read").start()
        if not ready_evt.wait(timeout_s):
            with _suppress():
                proc.kill()
            raise RuntimeError(
                f"compile server not ready within {timeout_s}s")
        try:
            ready = json.loads(first_line[0])
            assert ready.get("metric") == "compile_server_ready"
        except Exception as e:
            raise RuntimeError(
                f"compile server failed to start: {first_line[0]!r}") \
                from e
        self.compile_server_addr = addr

    def _drain_stdout(self, proc):
        for line in proc.stdout:
            with self._mu:
                self.lines.append(line.rstrip("\n"))

    def _base_env(self) -> dict:
        env = dict(os.environ)
        env.update(self.env_extra)
        env["PYTHONPATH"] = (os.getcwd() + os.pathsep
                             + env.get("PYTHONPATH", ""))
        return env

    def _spawn(self, s: _Slot):
        env = self._base_env()
        env["TIDB_TPU_FABRIC_COORD"] = self.coord.path
        if self.coord_addr:
            env["TIDB_TPU_FABRIC_COORD_ADDR"] = self.coord_addr
        env["TIDB_TPU_FABRIC_SLOT"] = str(s.idx)
        env["TIDB_TPU_FABRIC_PORT"] = str(self.port)
        if self.durable:
            # the shared durable store: one WAL + checkpoint dir for the
            # whole fleet (kv/shared_store.py picks up the coordination
            # segment for TSO/locks/tailing from the worker's fabric
            # activation)
            env["TIDB_TPU_WAL_DIR"] = os.path.join(self.run_dir, "wal")
        if self.init:
            env["TIDB_TPU_FABRIC_INIT"] = self.init
        if self.sysvars:
            env["TIDB_TPU_FABRIC_GLOBALS"] = ";".join(
                f"{k}={v}" for k, v in self.sysvars.items())
        if self.compile_server_addr:
            env["TIDB_TPU_COMPILE_SERVER"] = self.compile_server_addr
        # slot extras apply to the FIRST incarnation only: a chaos
        # failpoint that kills the worker must not re-arm on every
        # respawn (the fleet would park the slot after RESPAWN_LIMIT
        # scripted deaths and call it a crash loop)
        env.update(self.slot_env.pop(s.idx, {}))
        s.ready.clear()
        s.started_at = time.monotonic()
        s.proc = self._popen_worker(s, env)
        threading.Thread(target=self._read_worker, args=(s, s.proc),
                         daemon=True, name=f"fabric-read-{s.idx}").start()

    def _popen_worker(self, s: _Slot, env: dict):
        argv = [sys.executable, "-m", "tidb_tpu_torch.fabric.worker"]
        if self.hosts <= 1:
            return subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                    text=True, cwd=os.getcwd())
        # multi-host: the worker joins its host's process group (the
        # first live worker of the host leads a fresh group), so
        # kill_host / the fabric-kill-host failpoint can take out the
        # whole "machine" with one killpg
        host = self.host_of(s.idx)
        env["TIDB_TPU_FABRIC_HOST"] = str(host)
        pgid = self._host_pgid.get(host, 0)
        if pgid and not _pg_alive(pgid):
            pgid = 0  # the old leader's group is gone: lead a new one
        try:
            proc = subprocess.Popen(
                argv, env=env, stdout=subprocess.PIPE, text=True,
                cwd=os.getcwd(),
                preexec_fn=_setpgid_fn(pgid))  # noqa: PLW1509 — single-
            #   threaded child pre-exec; only setpgid runs
        except (OSError, subprocess.SubprocessError):
            if not pgid:
                raise
            # the leader died between the aliveness probe and the fork:
            # this worker becomes the host's new group leader
            proc = subprocess.Popen(
                argv, env=env, stdout=subprocess.PIPE, text=True,
                cwd=os.getcwd(), preexec_fn=_setpgid_fn(0))  # noqa: PLW1509
            pgid = 0
        if not pgid:
            self._host_pgid[host] = proc.pid
        return proc

    def host_of(self, slot: int) -> int:
        return slot % self.hosts

    def host_slots(self, host: int) -> list:
        return [s.idx for s in self.slots if self.host_of(s.idx) == host]

    def kill_host(self, host: int, sig=signal.SIGKILL):
        """The host-loss chaos primitive: SIGKILL the whole simulated
        host's process group — every worker on it dies at once, leases
        and all, exactly like a machine losing power."""
        pgid = self._host_pgid.get(host)
        if pgid and _pg_alive(pgid):
            with _suppress():
                os.killpg(pgid, sig)
            return
        # no live group (group leader already gone): kill stragglers
        # individually so the semantic stays "the host is down"
        for idx in self.host_slots(host):
            self.kill_worker(idx, sig)

    def _read_worker(self, s: _Slot, proc):
        for line in proc.stdout:
            line = line.rstrip("\n")
            try:
                obj = json.loads(line)
            except ValueError:
                obj = None
            if isinstance(obj, dict) and obj.get("metric") == \
                    "fabric_worker_ready":
                s.pid = obj["pid"]
                s.direct_port = obj["direct_port"]
                s.ready.set()
            elif isinstance(obj, dict) and obj.get("metric") == \
                    "fabric_worker_summary":
                s.summary = obj
                with self._mu:
                    self.lines.append(line)
            else:
                with self._mu:
                    self.lines.append(line)

    # -- supervision ---------------------------------------------------------

    def _monitor_loop(self):
        while not self._stopping.is_set():
            for s in self.slots:
                p = s.proc
                if p is None or s.parked:
                    continue
                rc = p.poll()
                if rc is None:
                    if s.crashes and \
                            time.monotonic() - s.started_at > STABLE_S:
                        s.crashes = 0  # lived long enough: forgiven
                    continue
                if self._stopping.is_set():
                    break
                # unexpected death: reclaim its segment state NOW (the
                # lease would expire anyway; the parent knows sooner),
                # then respawn with backoff
                try:
                    self.coord.release_slot(s.idx)
                    self.coord.bump("fabric_lease_reclaims")
                except Exception as e:  # noqa: BLE001 — peers re-reclaim
                    log.warning("segment reclaim for dead slot %d failed "
                                "(lease expiry will finish it): %s",
                                s.idx, e)
                s.crashes += 1
                if s.crashes > RESPAWN_LIMIT:
                    s.parked = True
                    with self._mu:
                        self.lines.append(json.dumps({
                            "metric": "fabric_slot_parked",
                            "slot": s.idx, "exit": rc,
                            "crashes": s.crashes}))
                    continue
                delay = min(BACKOFF_BASE_S * (2 ** (s.crashes - 1)),
                            BACKOFF_CAP_S)
                with self._mu:
                    self.lines.append(json.dumps({
                        "metric": "fabric_worker_respawn",
                        "slot": s.idx, "exit": rc,
                        "backoff_s": round(delay, 3)}))
                if self._stopping.wait(delay):
                    break
                try:
                    self.coord.bump("fabric_respawns")
                except Exception as e:  # noqa: BLE001 — counter only
                    log.warning("respawn counter bump failed: %s", e)
                self._spawn(s)
            self._stopping.wait(0.05)

    @property
    def respawns(self) -> int:
        try:
            return self.coord.counters()["fabric_respawns"]
        except Exception as e:  # noqa: BLE001 — gauge read post-unlink
            log.debug("respawn counter unreadable: %s", e)
            return 0

    def direct_port(self, slot: int) -> int:
        return self.slots[slot].direct_port

    def worker_pid(self, slot: int) -> int:
        return self.slots[slot].pid

    def kill_worker(self, slot: int, sig=signal.SIGKILL):
        """The chaos primitive: hard-kill one worker."""
        p = self.slots[slot].proc
        if p is not None and p.poll() is None:
            os.kill(p.pid, sig)

    def wait_respawn(self, slot: int, old_pid: int,
                     timeout_s: float = 30.0) -> bool:
        """Block until `slot` is serving again under a NEW pid."""
        s = self.slots[slot]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if s.ready.is_set() and s.pid and s.pid != old_pid \
                    and s.proc is not None and s.proc.poll() is None:
                return True
            time.sleep(0.05)
        return False

    # -- shutdown ------------------------------------------------------------

    def shutdown(self, drain: bool = True,
                 timeout_s: float = 20.0) -> "dict | None":
        """Stop the fleet; returns the segment's final verify_drained
        (captured before unlink) — the no-leaked-leases invariant the
        bench and the chaos tests assert."""
        self._stopping.set()
        if self._monitor is not None:
            self._monitor.join(5.0)
        procs = [s.proc for s in self.slots if s.proc is not None]
        if drain:
            for p in procs:
                if p.poll() is None:
                    with _suppress():
                        p.send_signal(signal.SIGTERM)
            deadline = time.monotonic() + timeout_s
            for p in procs:
                with _suppress():
                    p.wait(max(deadline - time.monotonic(), 0.1))
        for p in procs:
            if p.poll() is None:
                with _suppress():
                    p.kill()
                with _suppress():
                    p.wait(5.0)
        # a SIGKILLed straggler never released its lease: reclaim so the
        # drained verdict reflects reality, not the straggler's rudeness
        with _suppress():
            self.coord.reclaim_expired(0.0)
        with _suppress():
            self.final_drained = self.coord.verify_drained()
        if self.compile_server_proc is not None:
            with _suppress():
                self.compile_server_proc.send_signal(signal.SIGTERM)
            with _suppress():
                self.compile_server_proc.wait(5.0)
            if self.compile_server_proc.poll() is None:
                with _suppress():
                    self.compile_server_proc.kill()
        if self._reserve_sock is not None:
            with _suppress():
                self._reserve_sock.close()
        if self.coord_server is not None:
            with _suppress():
                self.coord_server.stop()
        with _suppress():
            self.coord.unlink()
        return self.final_drained


def _suppress():
    import contextlib
    return contextlib.suppress(Exception)


def _pg_alive(pgid: int) -> bool:
    """Is any process left in this group?  Signal 0 probes without
    delivering."""
    try:
        os.killpg(pgid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _setpgid_fn(pgid: int):
    """Child-side pre-exec: join (or, with 0, lead) a process group —
    Python 3.10 has no Popen(process_group=...) yet."""
    def fn():
        os.setpgid(0, pgid)
    return fn
