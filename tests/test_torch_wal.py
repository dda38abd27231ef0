"""The port's durable shared store (``tidb_tpu_torch/kv/wal.py`` and
``kv/shared_store.py``), every case of tests/test_wal.py on the port:
WAL framing + group commit + checkpoint/truncation units, the
crash-recovery matrix (SIGKILL at every WAL/2PC stage failpoint → reopen
→ committed-visible / uncommitted-gone / torn-tail-CRC-truncated), fleet
coherence over one log (shared lock table, cross-replica visibility,
schema cell, fleet GC floor), the oracle abstraction, and the BR
wal-tail round trip.

Beyond those, the two packages write one log format: a log that either
package wrote recovers in the other to the same keys and values."""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from tidb_tpu_torch.errors import LockedError
from tidb_tpu_torch.kv import new_store, wal as wal_mod
from tidb_tpu_torch.kv.mvcc import MVCCStore, TSOracle
from tidb_tpu_torch.kv.shared_store import (DurableMVCCStore, SegmentTSOracle,
                                      key_hash)
from tidb_tpu_torch.kv.store import Storage
from tidb_tpu_torch.utils import failpoint
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")


@pytest.fixture()
def wal_dir(tmp_path):
    return str(tmp_path / "wal")


def _mk_storage(engine) -> Storage:
    s = Storage.__new__(Storage)
    s.mvcc = engine
    s.backend = type(engine).__name__
    s._lock = threading.Lock()
    return s


# -- WAL unit layer -----------------------------------------------------------

class TestWalFraming:
    def test_append_read_roundtrip(self, wal_dir):
        w = wal_mod.WAL(wal_dir)
        l1 = w.append(("raw", -1, 7, [(b"a", b"1")], []))
        l2 = w.append(("rollback", -1, 9, [b"b"]))
        assert l2 > l1 > 0
        recs = list(w.read_records(w.base_lsn))
        assert [r[0][0] for r in recs] == ["raw", "rollback"]
        assert recs[-1][1] == l2
        w.close()

    def test_torn_tail_truncated_at_crc(self, wal_dir):
        w = wal_mod.WAL(wal_dir)
        good = w.append(("raw", -1, 1, [(b"k", b"v")], []))
        # torn frame: a header promising more bytes than exist
        w._f.seek(0, os.SEEK_END)
        w._f.write(b"\x40\x00\x00\x00\x00\x00\x00\x00half")
        w._f.flush()
        assert w.scan_valid_end() == good
        torn = w.truncate_torn_tail()
        assert torn > 0
        assert list(w.read_records(w.base_lsn))[-1][1] == good
        w.close()

    def test_crc_corruption_stops_replay(self, wal_dir):
        w = wal_mod.WAL(wal_dir)
        l1 = w.append(("raw", -1, 1, [(b"k", b"v")], []))
        w.append(("raw", -1, 2, [(b"k2", b"v2")], []))
        # flip one payload byte of the SECOND record
        off = l1 - w.base_lsn + 16 + 8 + 3
        w._f.seek(off)
        b = w._f.read(1)
        w._f.seek(off)
        w._f.write(bytes([b[0] ^ 0xFF]))
        w._f.flush()
        assert w.scan_valid_end() == l1  # corrupt record excluded
        w.close()

    def test_checkpoint_truncates_and_replays(self, wal_dir):
        st = new_store(wal_dir=wal_dir)
        t = st.begin(); t.put(b"k1", b"v1"); t.commit()
        lsn = st.mvcc.wal.checkpoint(st.mvcc.dump_state())
        assert st.mvcc.wal.base_lsn == lsn  # tail truncated (solo)
        t = st.begin(); t.put(b"k2", b"v2"); t.commit()
        st.close()
        st2 = new_store(wal_dir=wal_dir)
        snap = st2.get_snapshot()
        assert snap.get(b"k1") == b"v1"
        assert snap.get(b"k2") == b"v2"
        st2.close()

    def test_group_commit_policies(self, wal_dir, tmp_path):
        wal_mod.reset_for_tests()
        st = new_store(wal_dir=wal_dir)
        st.mvcc.wal.policy_source = lambda: "never"
        t = st.begin(); t.put(b"a", b"1"); t.commit()
        assert wal_mod.snapshot()["wal_fsyncs"] == 0
        st.mvcc.wal.policy_source = lambda: "commit"
        t = st.begin(); t.put(b"b", b"2"); t.commit()
        assert wal_mod.snapshot()["wal_fsyncs"] >= 1
        st.mvcc.wal.policy_source = lambda: "interval"
        t = st.begin(); t.put(b"c", b"3"); t.commit()
        deadline = time.monotonic() + 2.0
        base = wal_mod.snapshot()["wal_fsyncs"]
        while (wal_mod.snapshot()["wal_fsyncs"] <= base
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert wal_mod.snapshot()["wal_fsyncs"] > base  # bg flusher ran
        st.close()

    def test_group_commit_shares_fsyncs_across_threads(self, wal_dir):
        wal_mod.reset_for_tests()
        st = new_store(wal_dir=wal_dir)
        st.mvcc.wal.policy_source = lambda: "commit"

        def committer(i):
            t = st.begin()
            t.put(b"gk%d" % i, b"v")
            t.commit()

        threads = [threading.Thread(target=committer, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        s = wal_mod.snapshot()
        # every commit either fsynced or rode a peer's group fsync; the
        # group protocol must have produced at least one shared ride OR
        # at most one fsync per commit (no double syncs)
        assert s["wal_fsyncs"] + s["wal_group_commits"] >= 8 \
            or s["wal_fsyncs"] <= 8
        snap = st.get_snapshot()
        for i in range(8):
            assert snap.get(b"gk%d" % i) == b"v"
        st.close()

    def test_fsync_failure_rolls_back_cleanly(self, wal_dir):
        st = new_store(wal_dir=wal_dir)
        t = st.begin(); t.put(b"base", b"1"); t.commit()
        with failpoint.enabled("wal-fsync-fail", "1*panic"):
            t = st.begin()
            t.put(b"doomed", b"x")
            with pytest.raises(Exception):
                t.commit()
        assert st.get_snapshot().get(b"doomed") is None
        # last-disposition-wins: recovery agrees with the live store
        st2 = new_store(wal_dir=wal_dir)
        assert st2.get_snapshot().get(b"doomed") is None
        assert st2.get_snapshot().get(b"base") == b"1"
        st2.close()
        st.close()

    def test_fsync_eio_retried_within_budget(self, wal_dir):
        """A TRANSIENT fsync error (one EIO) gets
        one budgeted Backoffer retry (kind walSyncRetry) before the
        owner aborts — the commit succeeds, and the stats show exactly
        one error absorbed by one retry."""
        wal_mod.reset_for_tests()
        st = new_store(wal_dir=wal_dir)
        st.mvcc.wal.policy_source = lambda: "commit"
        with failpoint.enabled("wal-fsync-fail", "1*return(eio)"):
            t = st.begin()
            t.put(b"survives", b"v")
            t.commit()          # the retry absorbs the EIO
        assert st.get_snapshot().get(b"survives") == b"v"
        s = wal_mod.snapshot()
        assert s["wal_fsync_errors"] >= 1, s
        assert s["wal_fsync_retries"] >= 1, s
        # durable for real: recovery sees the retried commit
        st2 = new_store(wal_dir=wal_dir)
        assert st2.get_snapshot().get(b"survives") == b"v"
        st2.close()
        st.close()

    def test_fsync_eio_persistent_aborts_cleanly(self, wal_dir):
        """A PERSISTENT fsync failure exhausts the walSyncRetry budget
        and aborts the txn with the original OSError — never an ack on
        storage that cannot sync, and recovery agrees the row is gone."""
        wal_mod.reset_for_tests()
        st = new_store(wal_dir=wal_dir)
        st.mvcc.wal.policy_source = lambda: "commit"
        t = st.begin(); t.put(b"base", b"1"); t.commit()
        with failpoint.enabled("wal-fsync-fail", "return(eio)"):
            t = st.begin()
            t.put(b"doomed", b"x")
            with pytest.raises(OSError):
                t.commit()
        assert st.get_snapshot().get(b"doomed") is None
        assert wal_mod.snapshot()["wal_fsync_errors"] >= 2
        st2 = new_store(wal_dir=wal_dir)
        assert st2.get_snapshot().get(b"doomed") is None
        assert st2.get_snapshot().get(b"base") == b"1"
        st2.close()
        st.close()

    def test_torn_append_heals_in_process(self, wal_dir):
        st = new_store(wal_dir=wal_dir)
        with failpoint.enabled("wal-append-torn", "1*return(torn)"):
            t = st.begin()
            t.put(b"doomed", b"x")
            with pytest.raises(Exception):
                t.commit()
        # the torn bytes were healed: later appends land on a clean tail
        t = st.begin(); t.put(b"after", b"1"); t.commit()
        st2 = new_store(wal_dir=wal_dir)
        assert st2.get_snapshot().get(b"after") == b"1"
        assert st2.get_snapshot().get(b"doomed") is None
        st2.close()
        st.close()


# -- the oracle abstraction satellite ----------------------------------------

class TestOracleAbstraction:
    def test_injected_oracle_feeds_raw_put_python(self):
        class Fixed:
            def __init__(self):
                self.n = 1000

            def next_ts(self):
                self.n += 1
                return self.n

        eng = MVCCStore(oracle=(o := Fixed()))
        eng.raw_put(b"k", b"v")
        assert o.n == 1001  # raw_put's self-allocated ts used the oracle
        assert eng.map.read(b"k", 1 << 62) == (0, b"v")

    def test_injected_oracle_feeds_raw_put_native(self):
        from tidb_tpu_torch.kv.native import NativeMVCCStore, load_engine
        if load_engine() is None:
            pytest.skip("no native toolchain")

        class Fixed:
            def __init__(self):
                self.n = 5000

            def next_ts(self):
                self.n += 1
                return self.n

        eng = NativeMVCCStore(oracle=(o := Fixed()))
        eng.raw_put(b"k", b"v")
        assert o.n == 5001

    def test_advance_to_keeps_monotonic(self):
        o = TSOracle()
        ts = o.next_ts()
        o.advance_to(ts + (5 << 18))
        assert o.next_ts() > ts + (5 << 18)

    def test_segment_oracle_fleet_monotonic(self, tmp_path):
        from tidb_tpu_torch.fabric.coord import Coordinator
        c = Coordinator.create(str(tmp_path / "c.json"), nslots=2)
        try:
            o1, o2 = SegmentTSOracle(c, batch=4), SegmentTSOracle(c, batch=4)
            seen = [o1.next_ts() for _ in range(10)]
            seen += [o2.next_ts() for _ in range(10)]
            assert len(set(seen)) == 20  # never a collision
            # advance_to pushes past a foreign commit even mid-lease
            hi = max(seen) + 100
            o1.advance_to(hi)
            assert o1.next_ts() > hi
        finally:
            c.unlink()


# -- crash-recovery matrix (SIGKILL at each stage, real processes) -----------

_CHILD = r"""
import json, sys
from tidb_tpu_torch.utils import failpoint
from tidb_tpu_torch.kv import new_store

wal_dir, stage = sys.argv[1], sys.argv[2]
st = new_store(wal_dir=wal_dir)
for i in range(4):
    t = st.begin()
    t.put(b"k%d" % i, b"v%d" % i)
    t.commit()
    print(json.dumps({"acked": i}), flush=True)
failpoint.enable(stage, "1*return(kill)")
t = st.begin()
t.put(b"doomed", b"x")
t.commit()  # SIGKILL fires at the armed stage
print(json.dumps({"acked": "doomed"}), flush=True)
"""

_RECOVER_CHILD = r"""
import sys
from tidb_tpu_torch.utils import failpoint
from tidb_tpu_torch.kv import new_store

failpoint.enable("store-recover-replay", "2*return(kill)")
new_store(wal_dir=sys.argv[1])  # SIGKILL mid-replay
print("survived")
"""

#: stages strictly BEFORE the commit record reaches the log: the dying
#: txn must be GONE after recovery.  wal-fsync-fail kills after the
#: record is written (ambiguity window: present-and-complete or absent
#: are both legal; the client never got an ack either way).
_PRE_COMMIT_STAGES = ("txn-before-prewrite", "txn-after-prewrite",
                      "txn-before-commit", "wal-append-torn")


@pytest.mark.chaos
class TestCrashRecoveryMatrix:
    @pytest.mark.parametrize("stage", [
        "txn-before-prewrite", "txn-after-prewrite", "txn-before-commit",
        "wal-append-torn", "wal-fsync-fail"])
    def test_kill_at_stage_then_recover(self, stage, tmp_path):
        wal_dir = str(tmp_path / "wal")
        r = subprocess.run(
            [sys.executable, "-c", _CHILD, wal_dir, stage],
            capture_output=True, text=True, timeout=300)
        assert r.returncode == -9, (r.returncode, r.stderr[-1000:])
        acked = [json.loads(l)["acked"]
                 for l in r.stdout.strip().splitlines() if l.strip()]
        assert acked == [0, 1, 2, 3], acked  # doomed never acked
        wal_mod.reset_for_tests()
        st = new_store(wal_dir=wal_dir)
        snap = st.get_snapshot()
        # every ACKED commit survived the SIGKILL
        for i in acked:
            assert snap.get(b"k%d" % i) == b"v%d" % i, (stage, i)
        doomed = snap.get(b"doomed")
        if stage in _PRE_COMMIT_STAGES:
            assert doomed is None, (
                f"{stage}: un-acked txn visible after recovery")
        else:
            assert doomed in (None, b"x")
        if stage == "wal-append-torn":
            # the half-written commit record was CRC-truncated
            assert wal_mod.snapshot()["wal_truncated_records"] >= 1
        # no orphaned locks survive recovery (resolve-via-primary ran)
        assert not st.mvcc.locks, st.mvcc.locks
        st.close()

    def test_kill_mid_recovery_is_idempotent(self, tmp_path):
        wal_dir = str(tmp_path / "wal")
        st = new_store(wal_dir=wal_dir)
        for i in range(4):
            t = st.begin()
            t.put(b"r%d" % i, b"v%d" % i)
            t.commit()
        st.close()
        r = subprocess.run(
            [sys.executable, "-c", _RECOVER_CHILD, wal_dir],
            capture_output=True, text=True, timeout=300)
        assert r.returncode == -9, (r.returncode, r.stderr[-800:])
        st2 = new_store(wal_dir=wal_dir)  # recovery restarts cleanly
        snap = st2.get_snapshot()
        for i in range(4):
            assert snap.get(b"r%d" % i) == b"v%d" % i
        st2.close()


# -- fleet coherence over one log (two replicas in one process) --------------

class _Replicas:
    def __init__(self, tmp_path, nslots=4):
        from tidb_tpu_torch.fabric.coord import Coordinator
        self.c0 = Coordinator.create(str(tmp_path / "coord.json"),
                                     nslots=nslots)
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


class TestFleetCoherence:
    def test_commit_visible_on_sibling_snapshot(self, replicas):
        t = replicas.s0.begin()
        t.put(b"x", b"w0")
        t.commit()
        # the sibling's NEXT snapshot catches up synchronously
        assert replicas.s1.get_snapshot().get(b"x") == b"w0"

    def test_concurrent_prewrite_conflicts_via_shared_locks(self, replicas):
        ta = replicas.s0.begin()
        tb = replicas.s1.begin()
        ta.put(b"y", b"a")
        tb.put(b"y", b"b")
        # drive ta through prewrite ONLY (hold the shared claim)
        muts = [(b"y", 0, b"a")]
        replicas.s0.mvcc.prewrite(muts, b"y", ta.start_ts)
        with pytest.raises(LockedError):
            replicas.s1.mvcc.prewrite([(b"y", 0, b"b")], b"y", tb.start_ts)
        # release via rollback; the sibling can then claim
        replicas.s0.mvcc.rollback([b"y"], ta.start_ts)
        replicas.s1.mvcc.prewrite([(b"y", 0, b"b")], b"y", tb.start_ts)
        replicas.s1.mvcc.commit([b"y"], tb.start_ts,
                                replicas.s1.next_ts())
        assert replicas.s0.get_snapshot().get(b"y") == b"b"
        assert not replicas.c0.verify_drained()["held_locks"]

    def test_dead_slot_lock_claims_reclaimed(self, replicas):
        replicas.s0.mvcc.prewrite([(b"z", 0, b"v")], b"z", 12345)
        assert replicas.c0.snapshot()["held_locks"] >= 1
        time.sleep(0.02)
        replicas.c1.reclaim_expired(0.01)  # slot 0's lease lapsed
        assert replicas.c1.snapshot()["held_locks"] == 0

    def test_schema_cell_published_on_meta_commit(self, replicas):
        t = replicas.s0.begin()
        t.put(b"m:schema_version", json.dumps(7).encode())
        t.commit()
        assert replicas.c1.schema_version() == 7
        assert replicas.s1.mvcc.fleet_schema_version() == 7

    def test_min_read_ts_floors_fleet_gc(self, replicas):
        replicas.c0.set_min_read_ts(0, 500)
        replicas.c1.set_min_read_ts(1, 300)
        assert replicas.c0.fleet_min_read_ts() == 300
        replicas.c1.set_min_read_ts(1, 0)
        assert replicas.c0.fleet_min_read_ts() == 500
        replicas.c0.set_min_read_ts(0, 0)
        assert replicas.c0.verify_drained()["min_read_pinned"] == []

    def test_tailer_applies_in_background(self, replicas):
        replicas.s1.mvcc.start_tailer()
        t = replicas.s0.begin()
        t.put(b"bg", b"tail")
        t.commit()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if replicas.s1.mvcc.map.read(b"bg", 1 << 62) is not None:
                break
            time.sleep(0.01)
        assert replicas.s1.mvcc.map.read(b"bg", 1 << 62) == (0, b"tail")

    def test_append_survives_peer_truncation_rewrite(self, replicas):
        """A peer's checkpoint truncation rewrites wal.log (os.replace):
        an appender still holding the OLD inode must revalidate under
        the flock, or its acked commit lands in an unlinked file no
        reader can ever see."""
        t = replicas.s0.begin()
        t.put(b"pre", b"1")
        t.commit()
        replicas.s1.mvcc.catch_up()
        # replica 1 checkpoints + truncates: wal.log is a NEW inode now
        replicas.s1.mvcc.wal.checkpoint(replicas.s1.mvcc.dump_state())
        # replica 0 appends WITHOUT any explicit reopen
        t = replicas.s0.begin()
        t.put(b"post", b"2")
        t.commit()
        # a fresh reader over the path sees the post-truncation commit
        w = wal_mod.WAL(replicas.wal_dir)
        kinds = [r[0][0] for r in w.read_records(w.base_lsn)]
        w.close()
        assert "commit" in kinds, kinds
        replicas.s1.mvcc.catch_up()
        assert replicas.s1.mvcc.map.read(b"post", 1 << 62) == (0, b"2")

    def test_truncation_floor_respects_stalled_claimed_slot(self, tmp_path):
        """min_wal_applied gates on CLAIMED slots regardless of lease
        age: a stalled-but-alive worker must not be truncated past."""
        from tidb_tpu_torch.fabric.coord import Coordinator
        c = Coordinator.create(str(tmp_path / "c.json"), nslots=4)
        try:
            c.claim_slot(0)
            c.claim_slot(1)
            c.set_wal_applied(0, 1000)
            c.set_wal_applied(1, 400)
            time.sleep(0.02)
            c.heartbeat(0)  # slot 1's lease is now stale, slot 0 fresh
            assert c.min_wal_applied() == 400  # the stalled slot gates
            c.release_slot(1)  # genuinely dead: reclaimed, stops gating
            assert c.min_wal_applied() == 1000
        finally:
            c.unlink()

    def test_rawdel_after_backup_ts_not_in_tail(self, tmp_path):
        """A delete-range racing past the backup snapshot must be
        EXCLUDED from the shipped tail (its rows are in the backup)."""
        from tidb_tpu_torch.kv.shared_store import _record_ts
        st = new_store(wal_dir=str(tmp_path / "wal"))
        st.mvcc.raw_put(b"t1", b"v")
        cut = st.next_ts()
        st.mvcc.raw_delete_range(b"t0", b"t9")  # after the "backup"
        recs = [r for r, _l in st.mvcc.wal.read_records(
            st.mvcc.wal.base_lsn)]
        dels = [r for r in recs if r[0] == "rawdel"]
        assert dels and _record_ts(dels[0]) > cut
        assert [r for r in recs
                if r[0] == "raw" and _record_ts(r) <= cut]
        st.close()

    def test_orphaned_prewrite_resolved_via_primary(self, tmp_path):
        # craft a log where txn A prewrote but never committed, and txn
        # B prewrote AND committed: recovery must roll A back and
        # commit B's leftovers (the Percolator primary rule)
        wal_dir = str(tmp_path / "wal")
        w = wal_mod.WAL(wal_dir)
        w.append(("prewrite", -1, 100, b"a", [(b"a", 0, b"va")]))
        w.append(("prewrite", -1, 200, b"b", [(b"b", 0, b"vb")]))
        w.append(("commit", -1, 200, 201, [b"b"], []))
        w.close()
        st = new_store(wal_dir=wal_dir)
        assert st.get_snapshot().get(b"b") == b"vb"
        assert st.get_snapshot().get(b"a") is None
        assert not st.mvcc.locks  # A rolled back, nothing orphaned
        st.close()


# -- BR integration -----------------------------------------------------------

class TestBrWalTail:
    def test_backup_ships_tail_and_restore_replays_to_ts(self, tmp_path):
        from tidb_tpu_torch.session import bootstrap_domain, new_session
        from tidb_tpu_torch import br
        wal_dir = str(tmp_path / "wal")
        dom = bootstrap_domain(new_store(wal_dir=wal_dir))
        s = new_session(dom)
        s.execute("use test")
        s.execute("create table bt (id int primary key, v int)")
        s.execute("insert into bt values (1, 10), (2, 20)")
        dest = f"local://{tmp_path}/bk"
        meta = br.backup_database(s, "test", dest)
        assert meta["wal"] is not None
        assert meta["wal"]["tail_records"] > 0
        # a LATER commit must not leak into the tail replay
        s.execute("insert into bt values (3, 30)")
        fresh = new_store(wal_dir=str(tmp_path / "wal2"))
        n = br.restore_wal_tail(fresh, dest)
        assert n == meta["wal"]["tail_records"]
        # the replayed store holds the backup-ts rows, not the late one
        live = {k: v for k, v in fresh.get_snapshot().scan(b"", b"")
                if k.startswith(b"t")}
        src = {k: v for k, v in dom.store.get_snapshot(
            meta["ts"]).scan(b"", b"") if k.startswith(b"t")}
        assert live == src
        fresh.close()
        dom.store.close()


class TestWalGauges:
    def test_status_and_metrics_surfaces(self, tmp_path):
        from tidb_tpu_torch.server.http_status import StatusServer
        from tidb_tpu_torch.session import bootstrap_domain
        dom = bootstrap_domain(new_store(wal_dir=str(tmp_path / "wal")))
        srv = StatusServer(dom, port=0)
        try:
            payload = srv._status()
            assert payload["storage_wal"]["wal_appends"] > 0
            assert "applied_lsn" in payload["storage_wal"]
            text = srv._metrics()
            assert "wal_appends " in text or "wal_appends{" in text
        finally:
            # never start()ed: shutdown() would block waiting for the
            # serve loop to acknowledge — just release the socket
            srv._server.server_close()
        dom.store.close()

    def test_report_gauges_empty_without_wal(self):
        wal_mod.reset_for_tests()
        assert wal_mod.report_gauges() == {}


# -- one log format in both packages ----------------------------------------

def _write_log(pkg, wal_dir):
    """Commits, a rollback, a raw put and a torn tail through `pkg`'s
    durable store; returns the committed key → value map."""
    import importlib
    kv = importlib.import_module(f"{pkg}.kv")
    fp = importlib.import_module(f"{pkg}.utils.failpoint")
    st = kv.new_store(wal_dir=wal_dir)
    want = {}
    for i in range(6):
        t = st.begin()
        t.put(b"k%d" % i, b"v%d" % (i * i))
        if i % 3 == 2:
            t.rollback()
            continue
        t.commit()
        want[b"k%d" % i] = b"v%d" % (i * i)
    t = st.begin()
    t.delete(b"k0")
    t.commit()
    del want[b"k0"]
    st.mvcc.raw_put(b"m:raw", b"1")
    want[b"m:raw"] = b"1"
    with fp.enabled("wal-append-torn", "return(torn)"):
        t = st.begin()
        t.put(b"torn", b"x")
        with pytest.raises(Exception):
            t.commit()
    st.close()
    return want


@pytest.mark.parametrize("writer,reader", [("tidb_tpu", "tidb_tpu_torch"),
                                           ("tidb_tpu_torch", "tidb_tpu")])
def test_log_recovers_in_the_other_package(writer, reader, tmp_path):
    import importlib
    wal_dir = str(tmp_path / "wal")
    want = _write_log(writer, wal_dir)
    importlib.import_module(f"{reader}.kv.wal").reset_for_tests()
    st = importlib.import_module(f"{reader}.kv").new_store(wal_dir=wal_dir)
    try:
        got = dict(st.get_snapshot().scan(b"", b""))
        assert got == want
        assert not st.mvcc.locks
    finally:
        st.close()
