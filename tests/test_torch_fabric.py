"""The port's cross-process serving fabric (``tidb_tpu_torch/fabric``),
every case of tests/test_fabric.py on the port: the coordination
segment's admission/dedup/lease mechanics, fleet-unique connection ids
across forked servers, fragment dedup through real dispatches, the
fleet-aware residency shares, and the process-kill chaos invariants
(respawn within the backoff budget, lease reclaim with zero orphaned
counts, clean classified client errors, survivors serving).  The fleets
spawn port workers on the CPU (``TIDB_TPU_TORCH_DEVICE=cpu``), where
every kernel runs its plain version.

The in-process cases (the segment, conn-id arithmetic, dedup, the
scheduler and residency hooks) run once in each package on the same
inputs, each in a segment of its own; the reference test's assertions
hold on both, and the port's record of what the calls answered (claim
kinds and indexes, the segment's counters, dedup key hashes, coalesce
outcomes, shares) must equal the reference's.

Beyond those:

* a port fleet spawns port workers: their command line names
  ``tidb_tpu_torch.fabric.worker``, and neither JAX nor the reference
  package is in their ``sys.modules``;
* a worker asked for ``cuda`` where no card is visible exits 1 with
  ``DeviceNotAvailable``'s message and prints no ready line, and
  ``Fleet.start`` raises;
* a fleet with its default compile server starts and answers: the
  server records the workers' fragment signatures, never initialises
  CUDA, and no worker runs nvcc;
* a dedup result chunk whose columns hold device uploads pickles
  without a tensor;
* the fleet's init hook (``carry.fleet_seed``) gives every worker the
  same TPC-H columns and one ledger, and the device engine answers over
  the wire as the host engine does.

Every fleet starts with a bounded ``start(timeout_s=...)`` and is shut
down in a ``finally``."""

import importlib
import os
import pickle
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tidb_tpu_torch.fabric import slot_of_conn_id
from tidb_tpu_torch.fabric.coord import Coordinator
from torch_fleet_harness import CPU_ENV
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")


@pytest.fixture()
def coord(tmp_path):
    c = Coordinator.create(str(tmp_path / "coord.json"), nslots=4)
    yield c
    c.unlink()


PKGS = ("tidb_tpu", "tidb_tpu_torch")


def _pkg(pkg: str) -> SimpleNamespace:
    """The names an in-process case uses, from package `pkg`."""
    m = SimpleNamespace()
    for mod, names in (
            ("fabric", "CONN_SLOT_SHIFT conn_id_base slot_of_conn_id"),
            ("fabric.coord", "Coordinator"),
            ("fabric.dedup", "Dedup"),
            ("fabric.state", "_SchedFleet _ResidencyFleet"),
            ("ops.device", "DeviceUnsupported"),
            ("sqltypes", "FieldType TYPE_LONG"),
            ("utils.chunk", "Chunk Column")):
        mod = importlib.import_module(f"{pkg}.{mod}")
        for n in names.split():
            setattr(m, n, getattr(mod, n))
    m.scheduler = importlib.import_module(f"{pkg}.executor.scheduler")
    m.residency = importlib.import_module(f"{pkg}.ops.residency")
    return m


def _both(tmp_path, body):
    """body(m, root, coord) once per package, each in its own `root`
    with a fresh 4-slot ``root/coord.json`` segment; the port's record
    must equal the reference's."""
    got = {}
    for pkg in PKGS:
        m = _pkg(pkg)
        root = tmp_path / pkg
        root.mkdir()
        c = m.Coordinator.create(str(root / "coord.json"), nslots=4)
        try:
            got[pkg] = body(m, root, c)
        finally:
            c.unlink()
    assert got["tidb_tpu_torch"] == got["tidb_tpu"], got
    return got["tidb_tpu_torch"]


class TestCoordinator:
    def test_create_attach_roundtrip(self, tmp_path):
        def body(m, root, coord):
            c2 = m.Coordinator.attach(str(root / "coord.json"))
            try:
                assert c2.nslots == coord.nslots
                coord.claim_slot(0)
                c2.claim_slot(1)
                live = coord.live_slots(5.0)
                assert live == [0, 1]
                return c2.nslots, live
            finally:
                c2.close()
        _both(tmp_path, body)

    def test_fleet_running_cap_is_atomic_across_attachments(self, tmp_path):
        """Two attachments = two processes' views: the SECOND acquire of
        a cap-1 tenant must refuse even though it runs through a
        different attachment (the in-process scheduler alone would have
        granted it)."""
        def body(m, root, coord):
            c2 = m.Coordinator.attach(str(root / "coord.json"))
            try:
                got = [coord.try_acquire_running(0, "t", cap=1),
                       c2.try_acquire_running(1, "t", cap=1)]
                assert got == [True, False]
                coord.release_running(0, "t")
                got.append(c2.try_acquire_running(1, "t", cap=1))
                assert got[2]
                assert coord.peak_running("t") == 1
                c2.release_running(1, "t")
                return got, coord.peak_running("t"), c2.counters()
            finally:
                c2.close()
        _both(tmp_path, body)

    def test_vtime_shared_and_floor_reentry(self, tmp_path):
        def body(m, root, coord):
            coord.vtime_advance("a", 1.0)
            coord.vtime_advance("a", 1.0)
            # an idle tenant re-enters at the floor, not at zero credit
            coord.vtime_advance("b", 0.5, floor=2.0)
            vts = coord.vtimes(["a", "b"])
            assert vts["a"] == pytest.approx(2.0)
            assert vts["b"] == pytest.approx(2.5)
            return vts
        _both(tmp_path, body)

    def test_lease_reclaim_zeroes_dead_slot_columns(self, tmp_path):
        """The crash invariant: a dead worker's running counts and HBM
        charges are reclaimed by lease expiry — no orphaned WFQ weight
        or tenant running-cap leak."""
        def body(m, root, coord):
            coord.claim_slot(0)
            assert coord.try_acquire_running(0, "t", cap=2)
            coord.charge_hbm(0, "t", 4096)
            time.sleep(0.02)
            n = coord.reclaim_expired(0.01)
            assert n == 1
            assert coord.running_total("t") == 0
            assert coord.hbm_remote_bytes("t", exclude_slot=3) == 0
            drained = coord.verify_drained()
            assert drained["ok"]
            assert coord.counters()["fabric_lease_reclaims"] == 1
            return n, drained, coord.counters()
        _both(tmp_path, body)

    def test_dedup_lifecycle(self, tmp_path):
        def body(m, root, coord):
            kh = b"k" * 16
            kind, idx, _ = coord.dedup_claim(kh, ttl_s=5.0)
            assert kind == "lead"
            second = coord.dedup_claim(kh, ttl_s=5.0)[0]
            assert second == "wait"
            rid = coord.next_result_id()
            coord.dedup_publish(idx, kh, rid)
            k2, _i2, r2 = coord.dedup_claim(kh, ttl_s=5.0)
            assert (k2, r2) == ("hit", rid)
            polled = coord.dedup_poll(idx, kh)
            assert polled == ("done", rid)
            return kind, idx, second, rid, k2, polled, coord.counters()
        _both(tmp_path, body)

    def test_dedup_failed_lead_frees_waiters(self, tmp_path):
        def body(m, root, coord):
            kh = b"f" * 16
            kind, idx, _ = coord.dedup_claim(kh, ttl_s=5.0)
            coord.dedup_fail(idx, kh)
            polled = coord.dedup_poll(idx, kh)[0]
            assert polled == "gone"
            # the next claimant takes the slot over
            again = coord.dedup_claim(kh, ttl_s=5.0)[0]
            assert again == "lead"
            return kind, idx, polled, again, coord.counters()
        _both(tmp_path, body)

    def test_dead_leader_building_slot_reclaimed(self, tmp_path):
        """A building entry owned by a crashed slot flips to FAILED on
        reclaim, so waiters fall back to a local dispatch instead of
        waiting out the full build lease."""
        def body(m, root, coord):
            coord.claim_slot(2)
            coord.set_claim_owner(2)
            kh = b"d" * 16
            kind, idx, _ = coord.dedup_claim(kh, ttl_s=5.0)
            assert kind == "lead"
            time.sleep(0.02)
            coord.reclaim_expired(0.01)
            polled = coord.dedup_poll(idx, kh)[0]
            assert polled == "gone"
            assert coord.verify_drained()["ok"]
            return kind, idx, polled, coord.counters()
        _both(tmp_path, body)

    def test_prewarm_claim_at_most_once(self, tmp_path):
        def body(m, root, coord):
            c2 = m.Coordinator.attach(str(root / "coord.json"))
            try:
                kh = b"p" * 16
                claims = [coord.prewarm_claim(kh), c2.prewarm_claim(kh)]
                assert claims == [True, False]
                assert c2.counters()["fabric_prewarm_dedup"] == 1
                # the claim is not a dedup lead/hit in the gauge sense
                assert c2.counters()["fabric_dedup_hits"] == 0
                assert c2.counters()["fabric_dedup_leads"] == 0
                return claims, c2.counters()
            finally:
                c2.close()
        _both(tmp_path, body)


class TestConnIds:
    #: two "forked servers": each subprocess plays one fleet worker slot
    #: and mints session ids through the REAL allocator
    _WORKLOAD = r"""
import json, sys
from tidb_tpu_torch.fabric import conn_id_base
from tidb_tpu_torch.session.session import Session
from tidb_tpu_torch.session import bootstrap_domain
from tidb_tpu_torch.kv import new_store

slot = int(sys.argv[1])
Session.set_conn_id_base(conn_id_base(slot))
dom = bootstrap_domain(new_store())
ids = []
for _ in range(3):
    s = dom.sessions and None
from tidb_tpu_torch.session import new_session
for _ in range(3):
    ids.append(new_session(dom).conn_id)
print(json.dumps(ids))
"""

    def test_two_forked_servers_mint_disjoint_ids(self):
        """The satellite acceptance: two worker processes can never
        allocate the same conn id (KILL / slow-log attribution resolve
        by id), and the minting slot is recoverable from any id."""
        out = {}
        for slot in (0, 1):
            r = subprocess.run(
                [sys.executable, "-c", self._WORKLOAD, str(slot)],
                capture_output=True, text=True, timeout=240, check=True)
            import json
            out[slot] = json.loads(r.stdout.strip().splitlines()[-1])
        assert not set(out[0]) & set(out[1]), out
        for slot, ids in out.items():
            assert all(slot_of_conn_id(i) == slot for i in ids), out

    def test_base_arithmetic(self, tmp_path):
        def body(m, root, coord):
            assert m.conn_id_base(0) == 1 << m.CONN_SLOT_SHIFT
            assert m.slot_of_conn_id(m.conn_id_base(3) + 17) == 3
            assert m.slot_of_conn_id(42) is None  # non-fabric id
            # the whole id must fit the MySQL handshake's u32 field
            assert m.conn_id_base(200) + (1 << 23) < 2 ** 32
            return (m.CONN_SLOT_SHIFT,
                    [m.conn_id_base(s) for s in (0, 1, 3, 200)],
                    [m.slot_of_conn_id(i) for i in (
                        42, m.conn_id_base(3) + 17, m.conn_id_base(200))])
        _both(tmp_path, body)


def _mk_chunk(m, vals):
    return m.Chunk([m.Column(m.FieldType(tp=m.TYPE_LONG),
                             np.asarray(vals, dtype=np.int64))])


class TestDedup:
    def test_key_hash_binds_data_content(self, tmp_path):
        def body(m, root, coord):
            d = m.Dedup(coord, 0)
            bk = ("agg", "sig", 1024)
            h1 = d.key_hash(bk, (None, _mk_chunk(m, [1, 2, 3]), []))
            h2 = d.key_hash(bk, (None, _mk_chunk(m, [1, 2, 3]), []))
            h3 = d.key_hash(bk, (None, _mk_chunk(m, [1, 2, 4]), []))
            assert h1 == h2
            # an INSERTed delta can never reuse a stale page
            assert h1 != h3
            h4 = d.key_hash(("other", "sig", 1024),
                            (None, _mk_chunk(m, [1, 2, 3]), []))
            assert h4 != h1
            # no chunk in the args -> no data identity -> no dedup
            none = d.key_hash(bk, (None, [], 7))
            assert none is None
            return h1, h3, h4, none
        _both(tmp_path, body)

    def test_leader_publishes_follower_reuses(self, tmp_path):
        """Two attachments, one compute: the follower's compute fn must
        NEVER run — it maps the leader's result page."""
        def body(m, root, coord):
            c2 = m.Coordinator.attach(str(root / "coord.json"))
            try:
                d1, d2 = m.Dedup(coord, 0), m.Dedup(c2, 1)
                res_chunk = _mk_chunk(m, [7, 8, 9])
                kh = d1.key_hash(("agg", "s", 64), (_mk_chunk(m, [1, 2]),))
                calls = []

                def compute_leader():
                    calls.append("lead")
                    return res_chunk

                def compute_follower():
                    calls.append("follow")
                    return _mk_chunk(m, [0])

                out1 = d1.coalesce(None, "agg", kh, compute_leader)
                out2 = d2.coalesce(None, "agg", kh, compute_follower)
                assert calls == ["lead"]
                rows = [out1.columns[0].data.tolist(),
                        out2.columns[0].data.tolist()]
                assert rows == [[7, 8, 9], [7, 8, 9]]
                assert c2.counters()["fabric_dedup_hits"] == 1
                assert coord.verify_drained()["ok"]
                return kh, calls, rows, c2.counters()
            finally:
                c2.close()
        _both(tmp_path, body)

    def test_failing_leader_frees_the_slot(self, tmp_path):
        def body(m, root, coord):
            d = m.Dedup(coord, 0)
            kh = b"x" * 16
            with pytest.raises(m.DeviceUnsupported):
                d.coalesce(None, "agg", kh,
                           lambda: (_ for _ in ()).throw(
                               m.DeviceUnsupported("degrade")))
            # the slot is reclaimable, not wedged building
            drained = coord.verify_drained()
            assert drained["ok"]
            return drained, coord.counters()
        _both(tmp_path, body)

    def test_result_chunk_pickle_strips_device_slot(self, tmp_path):
        """Fabric result pages must never smuggle another process's HBM
        handles: the pickled Column carries material only."""
        def body(m, root, coord):
            col = m.Column(m.FieldType(tp=m.TYPE_LONG),
                           np.arange(4, dtype=np.int64))
            state = col.__getstate__()
            assert set(state) == {"ftype", "data", "nulls"}
            col2 = pickle.loads(pickle.dumps(col))
            assert col2.data.tolist() == [0, 1, 2, 3]
            assert col2.value_at(2) == 2
            return sorted(state), col2.data.tolist(), col2.value_at(2)
        _both(tmp_path, body)


class TestSchedulerFleetHook:
    def test_fleet_cap_crosses_scheduler_instances(self, tmp_path):
        """The in-process scheduler consults the segment: with the hook
        installed and a fleet-wide cap of 1, a second admit for the same
        tenant queues even though THIS process runs nothing."""
        def body(m, root, coord):
            sched = m.scheduler
            sched.set_fleet(m._SchedFleet(coord, 0))
            try:
                # a peer process (slot 1) holds the tenant's only slot
                assert coord.try_acquire_running(1, "default", cap=1)
                with sched._LOCK:
                    held = sched._try_acquire_locked("default", 1)
                assert not held
                coord.release_running(1, "default")
                with sched._LOCK:
                    free = sched._try_acquire_locked("default", 1)
                    assert free
                    sched._fleet_release_locked("default")
            finally:
                sched.set_fleet(None)
            drained = coord.verify_drained()
            assert drained["ok"]
            return held, free, drained
        _both(tmp_path, body)


class TestResidencyFleetHook:
    def test_remote_bytes_shrink_free_share(self, tmp_path):
        """free_share_bytes must see a tenant's bytes in SIBLING workers
        (the hybrid join's partition sizing reads this)."""
        def body(m, root, coord):
            res = m.residency
            res.set_fleet(m._ResidencyFleet(coord, 0))
            try:
                res.set_budget(1 << 20)
                base = res.free_share_bytes("g")
                assert base > 0
                # the same tenant holds 512KB on ANOTHER worker (slot 1)
                coord.charge_hbm(1, "g", 512 << 10)
                shrunk = res.free_share_bytes("g")
                assert shrunk < base
                return base, shrunk
            finally:
                res.set_fleet(None)
                res.set_budget(0)
        _both(tmp_path, body)


@pytest.mark.chaos_threads
class TestFleetDurability:
    """The fleet serves ONE durable store.  A
    committed INSERT on any worker is readable on every other worker; a
    worker SIGKILLed at a randomized WAL/2PC stage loses ZERO acked
    commits and surfaces ZERO un-acked rows after respawn+recovery
    (torn tails CRC-truncated); and a full fleet restart over the same
    run dir recovers everything from the log."""

    def test_cross_worker_visibility(self, tmp_path):
        """The satellite: INSERT on slot 0, SELECT on slot 1."""
        from tidb_tpu_torch.fabric.client import FleetClient
        from tidb_tpu_torch.fabric.fleet import Fleet
        fleet = Fleet(2, compile_server=False, env_extra=CPU_ENV,
                      run_dir=str(tmp_path / "fleet"))
        fleet.start(timeout_s=240.0)
        try:
            c0 = FleetClient(fleet.direct_port(0))
            c0.must_exec("use test")
            c0.must_exec("create table viz (id int primary key, v int)")
            c0.must_exec("insert into viz values (1, 11), (2, 22)")
            c0.close()
            c1 = FleetClient(fleet.direct_port(1))
            c1.must_exec("use test")
            assert c1.must_query(
                "select id, v from viz order by id")[1] == \
                [("1", "11"), ("2", "22")]
            # and the reverse direction, post-DDL
            c1.must_exec("insert into viz values (3, 33)")
            c1.close()
            c0b = FleetClient(fleet.direct_port(0))
            c0b.must_exec("use test")
            assert c0b.must_query(
                "select count(*) from viz")[1] == [("3",)]
            c0b.close()
        finally:
            drained = fleet.shutdown()
        assert drained and drained["ok"], drained

    def test_sigkill_mid_commit_loop_recovers(self, tmp_path):
        """SIGKILL workers at randomized WAL/2PC stage failpoints while
        clients insert; after respawn + recovery: every ACKED row
        visible on EVERY worker, the un-acked mid-kill row GONE (the
        armed stages all precede the commit record), then a cold fleet
        restart over the same run dir replays the log and still serves
        everything."""
        import random
        from tests.chaos_harness import FLEET_FAULTS
        from tidb_tpu_torch.fabric.client import FleetClient, WireError
        from tidb_tpu_torch.fabric.fleet import Fleet
        rng = random.Random(15)
        stages = ["txn-before-commit", "txn-after-prewrite",
                  "wal-append-torn"]
        doomed = {1: rng.choice(stages), 2: rng.choice(stages)}
        for s in doomed.values():
            assert s in FLEET_FAULTS  # catalogued kill stages only
        run_dir = str(tmp_path / "fleet")
        fleet = Fleet(4, compile_server=False, env_extra=CPU_ENV,
                      run_dir=run_dir, slot_env={
                          s: {"TIDB_TPU_FABRIC_FAILPOINTS":
                              f"{stage}=1*return(kill)"}
                          for s, stage in doomed.items()})
        fleet.start(timeout_s=300.0)
        acked = []
        try:
            c = FleetClient(fleet.direct_port(0))
            c.must_exec("use test")
            c.must_exec("create table dur (id int primary key, v int)")
            c.close()
            row_id = 0
            for slot in (0, 1, 2, 3, 1, 2):
                row_id += 1
                old_pid = fleet.worker_pid(slot)
                try:
                    cw = FleetClient(fleet.direct_port(slot))
                    cw.must_exec("use test")
                    cw.must_exec(
                        f"insert into dur values ({row_id}, {row_id})")
                    acked.append(row_id)
                    cw.close()
                except WireError:
                    # the armed stage SIGKILLed this worker mid-commit:
                    # a clean classified drop, never an ack — the row
                    # must be GONE fleet-wide (all stages pre-commit-
                    # record)
                    assert fleet.wait_respawn(slot, old_pid, 30.0), (
                        f"slot {slot} not respawned")
            assert len(acked) >= 4, acked
            # every worker (incl. the recovered ones) serves every
            # acked row and nothing else
            for slot in range(4):
                cv = FleetClient(fleet.direct_port(slot))
                cv.must_exec("use test")
                rows = cv.must_query(
                    "select id from dur order by id")[1]
                assert rows == [(str(i),) for i in acked], (
                    f"slot {slot}: {rows} != acked {acked}")
                cv.close()
            assert fleet.respawns >= 1, "no kill stage ever fired"
        finally:
            drained = fleet.shutdown()
        assert drained and drained["ok"], drained
        # cold restart: a fresh fleet over the same run dir must
        # recover the acked rows from the checkpoint + log alone
        fleet2 = Fleet(2, compile_server=False, env_extra=CPU_ENV,
                       run_dir=run_dir)
        fleet2.start(timeout_s=240.0)
        try:
            for slot in range(2):
                cv = FleetClient(fleet2.direct_port(slot))
                cv.must_exec("use test")
                rows = cv.must_query(
                    "select id from dur order by id")[1]
                assert rows == [(str(i),) for i in acked], (
                    f"restarted slot {slot}: {rows}")
                cv.close()
        finally:
            drained2 = fleet2.shutdown()
        assert drained2 and drained2["ok"], drained2


@pytest.mark.chaos_threads
class TestFleetProcessKill:
    """The fabric-kill-worker chaos satellite, end to end with real
    processes: SIGKILL mid-query -> clean classified client error,
    parent respawn within the backoff budget, segment lease reclaimed
    (zero orphaned counts), survivors serving throughout."""

    def test_kill_respawn_reclaim_survivors(self, tmp_path):
        from tidb_tpu_torch.fabric.client import FleetClient, WireError
        from tidb_tpu_torch.fabric.fleet import Fleet
        fleet = Fleet(
            2, compile_server=False, env_extra=CPU_ENV,
            run_dir=str(tmp_path / "fleet"),
            slot_env={0: {"TIDB_TPU_FABRIC_FAILPOINTS":
                          "fabric-kill-worker=1*return(1)"}})
        fleet.start(timeout_s=240.0)
        try:
            old_pid = fleet.worker_pid(0)
            c0 = FleetClient(fleet.direct_port(0))
            t0 = time.monotonic()
            with pytest.raises(WireError):
                # the first query trips the failpoint: SIGKILL mid-query
                c0.must_query("select 1")
            # survivor serves while the corpse is reclaimed
            c1 = FleetClient(fleet.direct_port(1))
            assert c1.must_query("select 41+1")[1] == [("42",)]
            c1.close()
            assert fleet.wait_respawn(0, old_pid, 30.0), (
                "no respawn within the backoff budget")
            respawn_s = time.monotonic() - t0
            assert respawn_s < 30.0
            assert fleet.respawns == 1
            # the respawned incarnation serves (failpoint NOT re-armed)
            c0b = FleetClient(fleet.direct_port(0))
            assert c0b.must_query("select 2")[1] == [("2",)]
            assert c0b.slot == 0
            c0b.close()
            counters = fleet.coord.counters()
            assert counters["fabric_lease_reclaims"] >= 1
        finally:
            drained = fleet.shutdown()
        assert drained and drained["ok"], drained


# -- the port's own fleet ------------------------------------------------------

Q1_SMALL = ("select l_returnflag, l_linestatus, sum(l_quantity), "
            "sum(l_extendedprice * (1 - l_discount)), avg(l_discount), "
            "count(*) from lineitem where l_shipdate <= '1998-09-02' "
            "group by l_returnflag, l_linestatus "
            "order by l_returnflag, l_linestatus")


class _NoTorchUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        assert module.split(".")[0] != "torch", (module, name)
        return super().find_class(module, name)


def _load_without_torch(blob: bytes):
    """Unpickle `blob`, failing on any reference to a torch class."""
    import io
    return _NoTorchUnpickler(io.BytesIO(blob)).load()


class TestPortFleet:
    def test_port_fleet_spawns_port_workers(self, tmp_path):
        """The fleet's hook seeds once through the shared log; both
        workers are ``tidb_tpu_torch.fabric.worker`` processes that never
        import JAX or the reference, hold the same columns, and answer
        Q1 on the device engine as on the host engine."""
        import json
        from tidb_tpu_torch import carry
        from tidb_tpu_torch.fabric.client import FleetClient
        from tidb_tpu_torch.fabric.fleet import Fleet
        probe = tmp_path / "probe"
        probe.mkdir()
        fleet = Fleet(2, init="tests.torch_fleet_harness:probe_seed",
                      compile_server=False,
                      env_extra={**CPU_ENV, "TORCH_FLEET_PROBE_DIR":
                                 str(probe)},
                      run_dir=str(tmp_path / "fleet"))
        fleet.start(timeout_s=240.0)
        pids = [fleet.worker_pid(s) for s in range(2)]
        try:
            assert os.path.basename(fleet.run_dir) == "fleet"
            for pid in pids:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    argv = f.read().split(b"\0")
                assert b"tidb_tpu_torch.fabric.worker" in argv, argv
            got = {}
            for slot in range(2):
                c = FleetClient(fleet.direct_port(slot))
                try:
                    c.must_exec("use tpch")
                    c.must_exec("set tidb_result_cache = 'OFF'")
                    c.must_exec("set tidb_executor_engine = 'tpu'")
                    dev = c.must_query(Q1_SMALL)
                    plan = c.must_query("explain analyze " + Q1_SMALL)[1]
                    assert any("engine:tpu" in str(x) for r in plan
                               for x in r if "HashAgg" in str(r[0])), plan
                    c.must_exec("set tidb_executor_engine = 'host'")
                    assert c.must_query(Q1_SMALL) == dev
                    ledger = c.must_query(
                        "select count(*), sum(bal) from test.ledger")[1]
                    got[slot] = (dev, ledger)
                finally:
                    c.close()
            # DIAG's peer fan-out: worker 0 reaches worker 1's direct port
            c = FleetClient(fleet.direct_port(0))
            try:
                rows = c.must_query(
                    "select distinct instance, error from "
                    "information_schema.cluster_statements_summary")[1]
            finally:
                c.close()
            assert sorted(rows) == sorted(
                (f"slot{s}:{fleet.direct_port(s)}", "") for s in range(2))
            assert got[0] == got[1]
            assert got[0][1] == [(str(carry.LEDGER_ACCTS),
                                  str(carry.LEDGER_ACCTS
                                      * carry.LEDGER_SEED_BAL))]
        finally:
            drained = fleet.shutdown()
        assert drained and drained["ok"], drained
        reports = {}
        for pid in pids:
            with open(probe / f"{pid}.json") as f:
                reports[pid] = json.load(f)
        assert [r["forbidden"] for r in reports.values()] == [[], []]
        # one worker wrote the KV half, the other replayed it
        assert sorted(r["seeded"] for r in reports.values()) == [False,
                                                                 True]
        import tidb_tpu_torch
        for s in fleet.slots:
            assert s.summary is not None
            assert set(s.summary["launches"]) >= {"expr_vm", "groupby_agg"}
            assert s.summary["package"] == os.path.dirname(
                os.path.abspath(tidb_tpu_torch.__file__))

    def test_worker_without_card_exits_1(self, tmp_path):
        """A worker whose device does not exist exits 1 before it claims
        its slot, and prints no ready line; a fleet of such workers fails
        to start."""
        import torch
        from tidb_tpu_torch.fabric.fleet import Fleet
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is visible")
        coord = Coordinator.create(str(tmp_path / "coord.json"), nslots=2)
        try:
            env = {**os.environ, "TIDB_TPU_FABRIC_COORD": coord.path,
                   "TIDB_TPU_FABRIC_SLOT": "0",
                   "TIDB_TPU_TORCH_DEVICE": "cuda"}
            r = subprocess.run(
                [sys.executable, "-m", "tidb_tpu_torch.fabric.worker"],
                env=env, capture_output=True, text=True, timeout=120)
            assert r.returncode == 1, (r.returncode, r.stderr[-800:])
            assert "no CUDA device is available" in r.stderr
            assert "fabric_worker_ready" not in r.stdout
            assert coord.live_slots(60.0) == []
        finally:
            coord.unlink()
        fleet = Fleet(2, compile_server=False, durable=False,
                      env_extra={"TIDB_TPU_TORCH_DEVICE": "cuda"},
                      run_dir=str(tmp_path / "fleet"))
        try:
            with pytest.raises(RuntimeError, match="not ready"):
                fleet.start(timeout_s=15.0)
            assert all(s.proc.wait(60) == 1 for s in fleet.slots)
        finally:
            fleet.shutdown()

    def test_default_fleet_serves_through_its_compile_server(self,
                                                            tmp_path):
        """``Fleet``'s default spawns the port's compile server first; the
        workers start, answer Q1 on the device engine as on the host
        engine, and record the fragment's signature through the server
        (one record, the second worker's a dedup).  The server never
        initialises CUDA, and no worker runs nvcc."""
        from tidb_tpu_torch.fabric.client import FleetClient
        from tidb_tpu_torch.fabric.compile_client import CompileClient
        from tidb_tpu_torch.fabric.fleet import Fleet
        fleet = Fleet(2, init="tidb_tpu_torch.carry:fleet_seed",
                      env_extra={**CPU_ENV, "TIDB_TPU_COMPILE_INDEX":
                                 str(tmp_path / "idx")},
                      run_dir=str(tmp_path / "fleet"))
        assert fleet.with_compile_server
        fleet.start(timeout_s=240.0)
        try:
            assert fleet.compile_server_proc.poll() is None
            assert fleet.compile_server_addr
            got = []
            for slot in range(2):
                c = FleetClient(fleet.direct_port(slot))
                try:
                    c.must_exec("use tpch")
                    c.must_exec("set tidb_result_cache = 'OFF'")
                    c.must_exec("set tidb_executor_engine = 'tpu'")
                    dev = c.must_query(Q1_SMALL)
                    c.must_exec("set tidb_executor_engine = 'host'")
                    assert c.must_query(Q1_SMALL) == dev
                    got.append(dev)
                finally:
                    c.close()
            assert got[0] == got[1]
            st = CompileClient(fleet.compile_server_addr).request(
                {"op": "stats"})
            assert st["compiles"] >= 1 and st["dedup_served"] >= 1
            assert st["errors"] == 0
            assert st["cuda_initialized"] is False
            assert os.listdir(tmp_path / "idx")
        finally:
            drained = fleet.shutdown()
        assert drained and drained["ok"], drained
        for s in fleet.slots:
            assert s.summary["kernel_build"]["nvcc_runs"] == 0
            assert s.summary["fabric"]["fabric_remote_errors"] == 0
            assert (s.summary["fabric"]["fabric_remote_compiles"]
                    + s.summary["fabric"]["fabric_artifact_hits"]) >= 1

    def test_dedup_page_carries_no_tensor(self, coord, tmp_path):
        """A leader's result chunk whose columns hold device uploads
        ships as material only: no tensor in the page, and the follower's
        columns come back without a device slot."""
        import torch
        from tidb_tpu_torch.fabric.dedup import Dedup
        from tidb_tpu_torch.ops import residency
        from tidb_tpu_torch.sqltypes import FieldType, TYPE_LONG
        from tidb_tpu_torch.utils.chunk import Chunk, Column
        cols = [Column(FieldType(tp=TYPE_LONG),
                       np.arange(5, dtype=np.int64) * k) for k in (1, 3)]
        for c in cols:
            residency.publish(c, torch.from_numpy(c.data.copy()),
                              torch.zeros(5, dtype=torch.bool))
            assert isinstance(c._device.data, torch.Tensor)
        res = Chunk(cols)
        _load_without_torch(pickle.dumps(res, protocol=4))
        c2 = Coordinator.attach(str(tmp_path / "coord.json"))
        try:
            d1, d2 = Dedup(coord, 0), Dedup(c2, 1)
            kh = d1.key_hash(("agg", "s", 64), (res,))
            assert d1.coalesce(None, "agg", kh, lambda: res) is res
            pages = [p for p in os.listdir(coord.pages_dir)
                     if not p.endswith(".tmp")]
            assert pages
            for p in pages:
                with open(os.path.join(coord.pages_dir, p), "rb") as f:
                    _load_without_torch(f.read())
            out = d2.coalesce(None, "agg", kh,
                              lambda: pytest.fail("the follower computed"))
            assert [c.data.tolist() for c in out.columns] == \
                [[0, 1, 2, 3, 4], [0, 3, 6, 9, 12]]
            assert all(c._device is None for c in out.columns)
        finally:
            c2.close()
            for c in cols:
                c._device = None
