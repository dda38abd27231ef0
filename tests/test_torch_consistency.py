"""The port's cross-worker consistency contract, every case of
tests/test_consistency.py on ``tidb_tpu_torch``: fleet-linearizable
reads via the per-origin committed-frontier watermark — immediate
visibility in both directions, bounded freshness waits with LOUD
9011 refusal (never a silent stale answer), dead-slot ungating at
lease reclaim, the stalled-origin breaker with explicit stale_ok
downgrade, the view-anchored write-conflict regression (a peer commit
with a LOWER commit_ts than our snapshot must still conflict), and
the epoch-fenced DDL owner lease incl. failover mid-CREATE.

Beyond those:

* one seeded transfer schedule runs on a two-replica durable store of
  each package: the outcomes (commit, skip or error code) and the final
  balances on both replicas are equal, and the balances keep their sum;
* the DDL worker thread of an idle domain outside the fleet leaves the
  active segment's DDL owner cell alone (the thread runs until its
  process ends, and an empty queue never claims the cell)."""

import threading
import time

import pytest

from tidb_tpu_torch.errors import FreshnessWaitError, WriteConflictError
from tidb_tpu_torch.kv import shared_store as shared_mod
from tidb_tpu_torch.kv import wal as wal_mod
from tidb_tpu_torch.kv.shared_store import DurableMVCCStore, SegmentTSOracle
from tidb_tpu_torch.kv.store import Storage
from tidb_tpu_torch.fabric import state as fabric_state
from tidb_tpu_torch.fabric.coord import Coordinator
from tidb_tpu_torch.utils import failpoint
from tidb_tpu_torch.utils.backoff import LeaseExpiredError
from torch_fleet_harness import PkgReplicas, transfer_schedule


def _mk_storage(engine) -> Storage:
    s = Storage.__new__(Storage)
    s.mvcc = engine
    s.backend = type(engine).__name__
    s._lock = threading.Lock()
    return s


class _Replicas:
    """Two storage replicas over one shared WAL + coordination segment
    (same harness as tests/test_wal.py TestFleetCoherence)."""

    def __init__(self, tmp_path, nslots=4):
        self.c0 = Coordinator.create(str(tmp_path / "coord.json"), nslots=nslots)
        self.c1 = Coordinator.attach(str(tmp_path / "coord.json"))
        self.c0.claim_slot(0)
        self.c1.claim_slot(1)
        self.wal_dir = str(tmp_path / "wal")
        self.s0 = self._mk(self.c0, 0)
        self.s1 = self._mk(self.c1, 1)

    def _mk(self, coord, slot):
        w = wal_mod.WAL(self.wal_dir, coordinator=coord)
        eng = DurableMVCCStore(w, coordinator=coord, slot=slot,
                               oracle=SegmentTSOracle(coord))
        eng.recover()
        return _mk_storage(eng)

    def close(self):
        self.s0.close()
        self.s1.close()
        self.c1.close()
        self.c0.unlink()


@pytest.fixture()
def replicas(tmp_path):
    r = _Replicas(tmp_path)
    yield r
    r.close()


# -- tentpole: frontier-gated snapshot acquisition ---------------------------

class TestFrontierFreshness:
    def test_immediate_visibility_both_directions(self, replicas):
        """Read-your-peers'-writes, the paper's strong-consistency
        contract: a snapshot taken on EITHER worker after the other's
        commit acked must see the write — and its ts must be fenced
        above the writer's published frontier commit_ts."""
        pairs = [(replicas.s0, replicas.s1, 0, b"left"),
                 (replicas.s1, replicas.s0, 1, b"right")]
        for writer, reader, wslot, val in pairs:
            t = writer.begin()
            t.put(b"vis", val)
            t.commit()
            snap = reader.get_snapshot()
            assert snap.get(b"vis") == val
            fronts = replicas.c0.commit_frontiers()
            assert wslot in fronts, fronts
            # ts fence: the reader's snapshot ts sits above the acked
            # durable frontier it was required to observe
            assert snap.ts > fronts[wslot][0]

    def test_frontier_wait_timeout_is_loud_9011(self, replicas,
                                                monkeypatch):
        """A live origin whose frontier this replica cannot apply up to
        within the budget must produce a CLASSIFIED refusal — never a
        silently stale result set."""
        monkeypatch.setattr(shared_mod, "FRESHNESS_BUDGET_MS", 80.0)
        c2 = Coordinator.attach(str(replicas.c0.path))
        try:
            c2.claim_slot(2)  # live lease, but no replica ever applies
            c2.set_commit_frontier(2, replicas.s0.next_ts() + (1 << 30),
                                   1 << 40)
            before = dict(fabric_state.STATS)
            with pytest.raises(FreshnessWaitError) as ei:
                replicas.s1.get_snapshot()
            assert ei.value.code == 9011
            assert "refusing stale read" in str(ei.value)
            assert fabric_state.STATS["freshness_timeouts"] \
                >= before["freshness_timeouts"] + 1
            assert fabric_state.STATS["freshness_waits"] \
                >= before["freshness_waits"] + 1
        finally:
            c2.close()

    def test_dead_slot_stops_gating_at_lease_reclaim(self, replicas,
                                                     monkeypatch):
        """A dead worker must not wedge the fleet's read path: once its
        lease is reclaimed its frontier stops gating and reads go back
        to fast + clean (no stale_ok downgrade either)."""
        monkeypatch.setattr(shared_mod, "FRESHNESS_BUDGET_MS", 80.0)
        c2 = Coordinator.attach(str(replicas.c0.path))
        try:
            c2.claim_slot(2)
            fts = replicas.s0.next_ts() + (1 << 30)
            c2.set_commit_frontier(2, fts, 1 << 40)
            with pytest.raises(FreshnessWaitError):
                replicas.s0.get_snapshot()
            # lease-age filtering at the coordinator: a silent slot
            # drops out of the gating set once its lease lapses
            time.sleep(0.1)
            assert 2 not in replicas.c0.commit_frontiers(
                lease_timeout_s=0.05)
            # explicit reclaim (the worker died / was released)
            c2.release_slot(2)
            eng = replicas.s0.mvcc
            stale_before = eng._stale_reads
            t0 = time.monotonic()
            snap = replicas.s0.get_snapshot()
            assert time.monotonic() - t0 < 0.5
            assert snap.ts > fts  # ts fence survives the reclaim
            assert eng._stale_reads == stale_before  # clean, not stale_ok
        finally:
            c2.close()

    def test_stalled_slot_breaker_downgrades_to_stale_ok(self, replicas,
                                                         monkeypatch):
        """A stalled-but-alive origin trips its per-origin breaker after
        one budget exhaustion; subsequent reads proceed WITH an explicit
        stale_ok annotation (counted + surfaced in wal_status), so
        availability degrades loudly instead of wedging."""
        monkeypatch.setattr(shared_mod, "FRESHNESS_BUDGET_MS", 80.0)
        c2 = Coordinator.attach(str(replicas.c0.path))
        try:
            t = replicas.s0.begin()
            t.put(b"bk", b"v")
            t.commit()
            c2.claim_slot(2)
            c2.set_commit_frontier(2, replicas.s0.next_ts() + (1 << 30),
                                   1 << 40)
            with pytest.raises(FreshnessWaitError):
                replicas.s1.get_snapshot()
            c2.heartbeat(2)  # still alive: stays in the gating set
            eng = replicas.s1.mvcc
            before_stats = fabric_state.STATS["freshness_stale_ok"]
            stale_before = eng._stale_reads
            snap = replicas.s1.get_snapshot()  # breaker open: no wait
            assert snap.get(b"bk") == b"v"  # local data still fresh
            assert eng._stale_reads == stale_before + 1
            assert "breaker" in eng.wal_status()["last_stale_reason"]
            assert fabric_state.STATS["freshness_stale_ok"] \
                >= before_stats + 1
        finally:
            c2.close()


# -- tentpole: view-anchored write-conflict detection ------------------------

class TestViewAnchoredConflict:
    def test_peer_commit_below_snapshot_ts_still_conflicts(self, replicas):
        """Lost-update regression: with a shared oracle a peer's
        commit_ts can be BELOW our snapshot ts while its apply lands
        after our read.  The plain has-commit-after-ts check passes and
        silently overwrites; the view-anchored check must refuse."""
        big = replicas.s1.next_ts() + (1 << 30)
        t1 = replicas.s1.begin(start_ts=big)  # view_seq captured NOW
        t0 = replicas.s0.begin()
        t0.put(b"lu", b"peer")
        t0.commit()  # cts allocated from the segment: far below `big`
        assert replicas.s0.mvcc.tso.next_ts() < big
        replicas.s1.mvcc.catch_up()  # peer write applies AFTER our view
        t1.put(b"lu", b"mine")
        with pytest.raises(WriteConflictError) as ei:
            t1.commit()
        assert "view" in str(ei.value)

    def test_pessimistic_lock_anchored_to_view(self, replicas):
        """Same hazard on the pessimistic path: lock acquisition after a
        foreign apply invalidated the statement's read view conflicts
        (the session retries at a fresh for_update_ts)."""
        big = replicas.s1.next_ts() + (1 << 30)
        t1 = replicas.s1.begin(start_ts=big)
        t0 = replicas.s0.begin()
        t0.put(b"pl", b"peer")
        t0.commit()
        replicas.s1.mvcc.catch_up()
        with pytest.raises(WriteConflictError):
            t1.lock_keys([b"pl"], for_update_ts=big)

    def test_own_pessimistic_claim_exempts_key(self, replicas):
        """A key we already hold a pessimistic lock on is exempt from
        the view check at prewrite — the conflict was checked at lock
        time and the held claim excludes foreign applies since."""
        t1 = replicas.s1.begin()
        t1.lock_keys([b"ex"], for_update_ts=replicas.s1.next_ts())
        t1.put(b"ex", b"mine")
        t1.commit()
        assert replicas.s0.get_snapshot().get(b"ex") == b"mine"


# -- tentpole: epoch-fenced DDL owner lease ----------------------------------

class TestDDLOwnerLease:
    def test_claim_steal_and_fence(self, replicas):
        c0, c1 = replicas.c0, replicas.c1
        e1 = c0.ddl_claim(0)
        assert e1 >= 1
        assert c0.ddl_check(e1)
        assert c0.ddl_heartbeat(0, e1)
        # a live foreign lease blocks the claim (caller backs off)
        assert c1.ddl_claim(1) == 0
        # ... until it lapses: failover bumps the epoch (the fence)
        time.sleep(0.06)
        e2 = c1.ddl_claim(1, lease_timeout_s=0.05)
        assert e2 == e1 + 1
        assert not c0.ddl_check(e1)
        assert not c0.ddl_heartbeat(0, e1)  # deposed owner learns loudly
        assert c1.ddl_check(e2)
        c1.ddl_release(1)
        # clean handoff keeps the epoch: next claim bumps past it
        assert c0.ddl_claim(0) == e2 + 1

    def test_fence_check_raises_for_deposed_owner(self, replicas,
                                                  monkeypatch):
        from tidb_tpu_torch import ddl as ddl_mod
        monkeypatch.setattr(fabric_state, "coordinator",
                            lambda: replicas.c0)
        monkeypatch.setattr(fabric_state, "slot", lambda: 0)
        e1 = replicas.c0.ddl_claim(0)
        time.sleep(0.06)
        replicas.c1.ddl_claim(1, lease_timeout_s=0.05)  # steal
        with pytest.raises(LeaseExpiredError):
            ddl_mod.ddl_fence_check(e1)
        assert ddl_mod.ddl_lease_heartbeat(e1) is False

    def test_owner_failover_mid_create(self, replicas, monkeypatch):
        """THE failover acceptance: an owner stalled mid-CREATE past its
        lease loses the cell to a peer; its commit-point fence trips and
        the job txn aborts — the deposed owner can never land its job on
        top of the new owner's schema state."""
        from tidb_tpu_torch.testkit import TestKit
        monkeypatch.setattr(fabric_state, "coordinator",
                            lambda: replicas.c0)
        monkeypatch.setattr(fabric_state, "slot", lambda: 0)
        tk = TestKit()
        stolen = []

        def thief():
            time.sleep(0.15)
            e = replicas.c1.ddl_claim(1, lease_timeout_s=0.1)
            stolen.append(e)

        th = threading.Thread(target=thief)
        with failpoint.enabled("ddl-mid-job", "1*sleep(0.4)"):
            th.start()
            with pytest.raises(LeaseExpiredError):
                tk.must_exec("create table fo (a int)")
        th.join()
        assert stolen and stolen[0] > 0
        # the aborted job left no schema behind
        from tidb_tpu_torch.errors import SchemaError
        with pytest.raises(SchemaError):
            tk.session.infoschema().table_by_name("test", "fo")
        # the new owner proceeds cleanly once the thief releases
        replicas.c1.ddl_release(1)
        tk.must_exec("create table fo (a int)")
        assert tk.session.infoschema().table_by_name("test", "fo") \
            is not None


# -- the same transfer schedule in both packages -----------------------------

def test_transfer_schedule_parity(tmp_path):
    got = {}
    for pkg in ("tidb_tpu", "tidb_tpu_torch"):
        (tmp_path / pkg).mkdir()
        reps = PkgReplicas(pkg, tmp_path / pkg)
        try:
            got[pkg] = transfer_schedule(reps)
        finally:
            reps.close()
    outcomes, rows0, rows1 = got["tidb_tpu_torch"]
    assert got["tidb_tpu_torch"] == got["tidb_tpu"]
    assert rows0 == rows1
    assert sum(int(v) for v in rows0.values()) == 600
    flat = [o for step in outcomes
            for o in (step if isinstance(step, tuple) else (step,))]
    # the schedule exercises commits and cross-replica write conflicts
    assert flat.count("ok") >= 20
    assert str(WriteConflictError.code) in flat, outcomes


# -- a DDL worker outside the fleet ------------------------------------------

def test_idle_ddl_worker_leaves_the_owner_cell_alone(replicas):
    """A domain's DDL worker thread runs until its process ends and ticks
    every half second.  Once a fleet segment is active in that process,
    an idle worker of a domain outside the fleet must not claim the
    segment's DDL owner cell: each claim would bump the cell's epoch and
    fence the fleet domain's own DDL job mid-drain."""
    from tidb_tpu_torch.session.session import bootstrap_domain
    from tidb_tpu_torch.testkit import TestKit
    idle = TestKit()
    idle.must_exec("use test")
    idle.must_exec("create table t (a int)")
    idle.must_exec("alter table t add index i (a)")
    worker = idle.domain.ddl_worker
    assert worker._thread is not None and worker._thread.is_alive()
    c0 = replicas.c0
    fabric_state.activate(c0, 0, lease_hbm=False)
    try:
        before = c0.snapshot()["ddl_epoch"]
        worker._wake.set()
        time.sleep(1.2)     # two ticks of the idle worker's loop
        snap = c0.snapshot()
        assert (snap["ddl_epoch"], snap["ddl_owner"]) == (before, -1)
        # the fleet domain's own DDL job claims the cell and runs clean
        tk = TestKit(bootstrap_domain(replicas.s0))
        tk.must_exec("use test")
        tk.must_exec("create table f (a int)")
        tk.must_exec("alter table f add index i (a)")
        tk.must_exec("admin check table f")
        snap = c0.snapshot()
        assert snap["ddl_epoch"] > before and snap["ddl_owner"] == -1
        tk.domain.ddl_worker.stop()
    finally:
        fabric_state.deactivate()
        worker.stop()
