"""The port's region-sharded multi-host fleet (``tidb_tpu_torch/fabric/
region.py``, ``blob.py``, ``coord_net.py``) against the reference's:
every case of tests/test_region.py on both packages — the RegionMap
keyspace partition, the object-store-shaped blob API (rename-last
uploads, torn uploads invisible), per-region WAL replication (checkpoint
+ committed tail + MANIFEST-last), region failover (survivor claims an
expired lease, restores from blobs alone, replays, resolves orphans),
epoch fencing (a zombie host's appender can never write into a
failed-over region), and the network coordinator's parity / degrade
discipline.

Each case runs once in each package on the same inputs, in a directory
and coordination segment of its own.  The reference test's assertions
hold on both, and each case records what the calls answered (region ids
and bounds, epochs, rows read back, manifests' sealed lengths, replayed
record counts, which error was raised); the port's record must equal the
reference's.  Timestamps and CRCs (which cover commit timestamps) are
left out of the records: they differ between any two runs."""

import contextlib
import importlib
import os
import time
from types import SimpleNamespace

import pytest
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

NREGIONS = 4
PKGS = ("tidb_tpu", "tidb_tpu_torch")


def _pkg(pkg: str) -> SimpleNamespace:
    """The names a case uses, from package `pkg`."""
    mods = {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "fabric.blob", "fabric.coord", "fabric.coord_net", "fabric.region",
        "kv.wal", "kv.store")}
    m = SimpleNamespace(wal_mod=mods["kv.wal"])
    for mod, names in (
            ("fabric.blob", "BlobError LocalDirBlobStore open_blob_store"),
            ("fabric.coord", "Coordinator"),
            ("fabric.coord_net", "CoordRemoteError CoordServer "
             "CoordUnavailableError NetCoordinator"),
            ("fabric.region", "RegionEpochError RegionMap RegionStore "
             "verify_region_invariants"),
            ("kv.store", "OP_PUT Storage")):
        for n in names.split():
            setattr(m, n, getattr(mods[mod], n))
    return m


def _both(tmp_path, body):
    """body(m, root, coord) once per package, each in its own `root`
    with a fresh ``root/coord`` segment of NREGIONS regions; the port's
    record must equal the reference's."""
    got = {}
    for pkg in PKGS:
        m = _pkg(pkg)
        root = tmp_path / pkg
        root.mkdir()
        coord = m.Coordinator.create(str(root / "coord"), nregions=NREGIONS)
        try:
            got[pkg] = body(m, root, coord)
        finally:
            with contextlib.suppress(Exception):
                coord.unlink()
    assert got["tidb_tpu_torch"] == got["tidb_tpu"], got
    return got["tidb_tpu_torch"]


def _blob(m, root):
    return m.LocalDirBlobStore(str(root / "blob"))


def _raises(exc, fn, *args):
    """The type name of what fn(*args) raised; it must be an `exc`."""
    with pytest.raises(exc) as ei:
        fn(*args)
    return type(ei.value).__name__


def _man(man: dict) -> dict:
    """A manifest's fields that do not depend on commit timestamps."""
    return {k: man[k] for k in ("region", "epoch", "committed_len",
                                "base_lsn", "checkpoint", "checkpoint_lsn",
                                "tail")}


def _replayed(m) -> int:
    return m.wal_mod.snapshot()["wal_replayed_records"]


def rkey(rid: int, suffix: bytes = b"k", n: int = NREGIONS) -> bytes:
    """A key guaranteed to land in region ``rid`` of an n-region map."""
    return ((rid << 64) // n).to_bytes(8, "big") + suffix


# -- keyspace partition -------------------------------------------------------

class TestRegionMap:
    def test_regions_partition_the_keyspace(self, tmp_path):
        def body(m, root, coord):
            rm = m.RegionMap(NREGIONS)
            for rid in range(NREGIONS):
                assert rm.region_of(rkey(rid)) == rid
            assert rm.region_of(b"") == 0
            assert rm.region_of(b"\xff" * 16) == NREGIONS - 1
            probes = [b"", b"\x00", b"\x3f\xff", b"\x40", b"\x7f\xff\xff",
                      b"\x80", b"\xbf", b"\xc0\x00", b"\xff" * 16] + [
                rkey(r, b"x") for r in range(NREGIONS)]
            return [rm.region_of(k) for k in probes]
        _both(tmp_path, body)

    def test_bounds_are_contiguous_and_open_ended(self, tmp_path):
        def body(m, root, coord):
            rm = m.RegionMap(NREGIONS)
            assert rm.bounds(0)[0] == b""
            assert rm.bounds(NREGIONS - 1)[1] == b""
            for rid in range(NREGIONS - 1):
                assert rm.bounds(rid)[1] == rm.bounds(rid + 1)[0]
            err = _raises(IndexError, rm.bounds, NREGIONS)
            return [rm.bounds(r) for r in range(NREGIONS)], err
        _both(tmp_path, body)

    def test_split_range_fans_out_and_clamps(self, tmp_path):
        def body(m, root, coord):
            rm = m.RegionMap(NREGIONS)
            spans = rm.split_range(b"", b"")
            assert [s[0] for s in spans] == list(range(NREGIONS))
            # a range inside one region stays one span with its own
            # bounds
            one = rm.split_range(rkey(2, b"a"), rkey(2, b"z"))
            assert one == [(2, rkey(2, b"a"), rkey(2, b"z"))]
            # a straddling range clamps each span to the region grid
            two = rm.split_range(rkey(1, b"x"), rkey(2, b"x"))
            assert [s[0] for s in two] == [1, 2]
            assert two[0][1] == rkey(1, b"x") and two[1][2] == rkey(2, b"x")
            return spans, one, two
        _both(tmp_path, body)


# -- blob store ---------------------------------------------------------------

class TestBlobStore:
    def test_upload_list_fetch_round_trip(self, tmp_path):
        def body(m, root, coord):
            blob = _blob(m, root)
            blob.put("region-0/a.bin", b"alpha")
            blob.put("region-0/b.bin", b"beta")
            blob.put("region-1/c.bin", b"gamma")
            assert blob.get("region-0/a.bin") == b"alpha"
            listed = blob.list("region-0/")
            assert listed == ["region-0/a.bin", "region-0/b.bin"]
            assert blob.exists("region-1/c.bin")
            blob.delete("region-0/a.bin")
            assert not blob.exists("region-0/a.bin")
            err = _raises(m.BlobError, blob.get, "region-0/a.bin")
            return listed, blob.list(), err
        _both(tmp_path, body)

    def test_torn_upload_invisible(self, tmp_path):
        """rename-last: a crash mid-upload leaves only a tmp file, which
        list() skips and get() refuses — a reader can never fetch half
        an object."""
        def body(m, root, coord):
            blob = _blob(m, root)
            blob.put("region-0/whole.bin", b"x" * 64)
            torn = os.path.join(str(root / "blob"), "region-0",
                                ".tmp-crashed")
            with open(torn, "wb") as f:
                f.write(b"half an uplo")
            listed = blob.list("region-0/")
            assert listed == ["region-0/whole.bin"]
            # and a COMPLETED put leaves no tmp residue behind
            names = os.listdir(os.path.join(str(root / "blob"),
                                            "region-0"))
            assert [n for n in names if n.startswith(".tmp-")] == \
                [".tmp-crashed"]
            return listed, sorted(names)
        _both(tmp_path, body)

    def test_open_blob_store_schemes(self, tmp_path):
        def body(m, root, coord):
            d = str(root / "x")
            assert isinstance(m.open_blob_store(d), m.LocalDirBlobStore)
            assert isinstance(m.open_blob_store("file://" + d),
                              m.LocalDirBlobStore)
            return _raises(NotImplementedError, m.open_blob_store,
                           "gs://bucket/prefix")
        _both(tmp_path, body)


# -- coordination-segment region cells ----------------------------------------

class TestRegionCells:
    def test_claim_fences_foreign_live_lease(self, tmp_path):
        def body(m, root, coord):
            coord.claim_slot(0)
            coord.claim_slot(1)
            e1 = coord.region_claim(0, 0)
            assert e1 > 0
            # a live foreign lease is not up for grabs
            foreign = coord.region_claim(0, 1)
            assert foreign == 0
            assert coord.region_heartbeat(0, 0, e1)
            assert coord.region_check(0, e1)
            # release -> next claim bumps the epoch (fencing token)
            coord.region_release(0, 0)
            e2 = coord.region_claim(0, 1)
            assert e2 > e1
            fenced = (coord.region_check(0, e1),
                      coord.region_heartbeat(0, 0, e1),
                      coord.region_set_committed(0, e1, 128))
            assert fenced == (False, False, False)
            assert coord.region_set_committed(0, e2, 128)
            assert coord.region_committed_len(0) == 128
            return e1, foreign, e2, fenced, coord.region_info(0)["owner"]
        _both(tmp_path, body)

    def test_expiry_and_drain_listing(self, tmp_path):
        def body(m, root, coord):
            coord.claim_slot(0)
            e = coord.region_claim(2, 0, lease_timeout_s=0.05)
            assert e > 0
            assert coord.regions_expired(60.0) == []
            time.sleep(0.08)
            expired = coord.regions_expired(0.05)
            assert 2 in expired
            d = coord.verify_drained()
            assert not d["ok"] and 2 in d["region_leases"]
            coord.region_release_all(0)
            coord.release_slot(0)
            assert coord.verify_drained()["ok"]
            return e, expired, d["region_leases"]
        _both(tmp_path, body)


# -- the router ---------------------------------------------------------------

class TestRegionStoreRouting:
    def test_cross_region_txn_and_ordered_scan(self, tmp_path):
        def body(m, root, coord):
            coord.claim_slot(0)
            rs = m.RegionStore(str(root / "h0"), coord, 0)
            opened = rs.open_regions()
            assert opened == list(range(NREGIONS))
            st = m.Storage(mvcc=rs)
            # ONE txn spanning three regions: Percolator primary in
            # region 0
            t = st.begin()
            for rid in (0, 1, 3):
                t.put(rkey(rid, b"row"), b"v%d" % rid)
            t.commit()
            ts = rs.tso.next_ts()
            assert rs.get(rkey(1, b"row"), ts) == b"v1"
            # full-range scan fans out per region and concatenates
            # ordered
            rows = rs.scan(b"", b"", ts)
            assert [v for _k, v in rows] == [b"v0", b"v1", b"v3"]
            assert [k for k, _v in rows] == sorted(k for k, _v in rows)
            assert rs.scan(b"", b"", ts, limit=2) == rows[:2]
            lens = {r: s["end_lsn"] for r, s in rs.wal_status().items()}
            rs.close()
            return opened, rows, lens
        _both(tmp_path, body)

    def test_unowned_region_raises_not_serves(self, tmp_path):
        def body(m, root, coord):
            coord.claim_slot(0)
            rs = m.RegionStore(str(root / "h0"), coord, 0)
            # regions 2,3 belong to nobody here
            opened = rs.open_regions([0, 1])
            err = _raises(m.RegionEpochError, rs.raw_put, rkey(3), b"x")
            rs.close()
            return opened, err
        _both(tmp_path, body)


# -- replication + failover ---------------------------------------------------

class TestReplicationFailover:
    def test_restore_is_bit_equal(self, tmp_path):
        def body(m, root, coord):
            blob = _blob(m, root)
            coord.claim_slot(0)
            rs = m.RegionStore(str(root / "h0"), coord, 0, blob=blob)
            rs.open_regions()
            st = m.Storage(mvcc=rs)
            for i in range(8):
                t = st.begin()
                t.put(rkey(i % NREGIONS, b"k%03d" % i), b"v%d" % i)
                t.commit()
            # one region restores via checkpoint
            rs.checkpoint_region(0)
            manifests = rs.replicate()
            assert sorted(manifests) == list(range(NREGIONS))
            ts = rs.tso.next_ts()
            before = rs.scan(b"", b"", ts)
            rs.close()
            coord.release_slot(0)
            # cold restart from the blob store ALONE: fresh segment +
            # dirs
            c2 = m.Coordinator.create(str(root / "coord2"),
                                      nregions=NREGIONS)
            try:
                c2.claim_slot(0)
                cold = m.RegionStore(str(root / "cold"), c2, 0, blob=blob)
                r0 = _replayed(m)
                cold.open_regions(restore=True)
                replayed = _replayed(m) - r0
                after = cold.scan(b"", b"", ts)
                assert after == before
                cold.close(replicate=False)
            finally:
                with contextlib.suppress(Exception):
                    c2.unlink()
            return ({r: _man(x) for r, x in manifests.items()}, after,
                    replayed)
        _both(tmp_path, body)

    def test_failover_fences_zombie_and_rolls_back_orphan(self, tmp_path):
        def body(m, root, coord):
            blob = _blob(m, root)
            coord.claim_slot(0)
            coord.claim_slot(1)
            dead = m.RegionStore(str(root / "h0"), coord, 0, blob=blob)
            dead.open_regions()
            st = m.Storage(mvcc=dead)
            t = st.begin()
            t.put(rkey(1, b"acked"), b"safe")
            t.commit()
            dead.replicate()
            # the mid-kill crash window: prewrite in the replicated log,
            # commit never written
            t2 = st.begin()
            orphan = rkey(1, b"orphan")
            dead.prewrite([(orphan, m.OP_PUT, b"doomed")], orphan,
                          t2.start_ts)
            dead.replicate()
            ts = dead.tso.next_ts()
            # the survivor treats the leases as expired and takes over
            # from the blob store alone
            surv = m.RegionStore(str(root / "h1"), coord, 1, blob=blob,
                                 lease_timeout_s=0.0)
            r0 = _replayed(m)
            took = sorted(surv.failover_expired())
            replayed = _replayed(m) - r0
            assert took == list(range(NREGIONS))
            acked = surv.get(rkey(1, b"acked"), ts)
            assert acked == b"safe"
            # rolled back
            gone = surv.get(orphan, surv.tso.next_ts())
            assert gone is None
            restored = surv.scan(b"", b"", surv.tso.next_ts())
            # the zombie is epoch-fenced before any byte hits its log
            err = _raises(m.RegionEpochError, dead.raw_put,
                          rkey(1, b"zombie"), b"x")
            # and its close-time replicate must not clobber the
            # survivor's MANIFEST (epoch check skips fenced regions)
            dead.close()
            surv_epoch = surv.epochs[1]
            man = surv._replicator.manifest(1)
            surv.replicate()
            man2 = surv._replicator.manifest(1)
            assert man2["epoch"] == surv_epoch >= man["epoch"]
            epochs = dict(surv.epochs)
            surv.close()
            coord.release_slot(0)
            coord.release_slot(1)
            inv = m.verify_region_invariants(coord, blob)
            assert inv["ok"], inv
            assert coord.verify_drained()["ok"]
            return (took, replayed, acked, gone, restored, err, epochs,
                    _man(man), _man(man2), inv)
        _both(tmp_path, body)

    def test_lost_heartbeat_drops_the_store(self, tmp_path):
        """A host that misses its lease renewal must DROP the region the
        moment a heartbeat is rejected — keeping serving would split-
        brain against the failover owner."""
        def body(m, root, coord):
            blob = _blob(m, root)
            coord.claim_slot(0)
            coord.claim_slot(1)
            a = m.RegionStore(str(root / "h0"), coord, 0, blob=blob)
            a.open_regions([2])
            b = m.RegionStore(str(root / "h1"), coord, 1, blob=blob,
                              lease_timeout_s=0.0)
            took = b.failover_expired()
            assert took == [2]
            lost = a.heartbeat()           # rejected -> dropped
            assert lost == [2]
            assert 2 not in a.stores
            epochs = dict(b.epochs)
            a.close()
            b.close()
            return took, lost, epochs
        _both(tmp_path, body)

    def test_invariants_catch_a_lying_manifest(self, tmp_path):
        def body(m, root, coord):
            blob = _blob(m, root)
            coord.claim_slot(0)
            rs = m.RegionStore(str(root / "h0"), coord, 0, blob=blob)
            rs.open_regions([0])
            rs.raw_put(rkey(0), b"v")
            man = rs.replicate()[0]
            rs.close()
            coord.release_slot(0)
            assert m.verify_region_invariants(coord, blob)["ok"]
            # the manifest now references a ghost
            blob.delete(man["tail"])
            inv = m.verify_region_invariants(coord, blob)
            assert not inv["ok"] and inv["manifest_errors"]
            return _man(man), inv
        _both(tmp_path, body)

    def test_region_wal_dir_layout(self, tmp_path):
        def body(m, root, coord):
            w = str(root / "w")
            for rid in (0, 3, 7):
                os.makedirs(m.wal_mod.region_dir(w, rid))
            assert m.wal_mod.region_ids(w) == [0, 3, 7]
            return [os.path.relpath(m.wal_mod.region_dir(w, r), w)
                    for r in (0, 3, 7)]
        _both(tmp_path, body)


# -- the network coordinator --------------------------------------------------

class TestNetCoordinator:
    def test_parity_and_remote_errors(self, tmp_path):
        def body(m, root, coord):
            srv = m.CoordServer(coord)
            addr = srv.start()
            try:
                net = m.NetCoordinator(addr)
                assert net.nregions == NREGIONS
                net.claim_slot(3)
                e = net.region_claim(1, 3)
                assert e > 0 and coord.region_check(1, e)
                owner = net.region_info(1)["owner"]
                assert owner == 3
                assert net.tso_lease(8)[1] > 0
                # a semantic error crosses the wire typed, not as a hang
                with pytest.raises(m.CoordRemoteError) as ei:
                    net.region_claim(NREGIONS + 9, 3)
                assert ei.value.err_type == "IndexError"
                # ops outside the allowlist don't exist on the client
                with pytest.raises(AttributeError):
                    net.unlink
                net.region_release(1, 3)
                net.release_slot(3)
            finally:
                srv.stop()
            return e, owner, ei.value.err_type
        _both(tmp_path, body)

    def test_region_store_over_the_wire(self, tmp_path):
        def body(m, root, coord):
            srv = m.CoordServer(coord)
            addr = srv.start()
            try:
                net = m.NetCoordinator(addr)
                net.claim_slot(2)
                rs = m.RegionStore(str(root / "net"), net, 2)
                opened = rs.open_regions([0, 1])
                rs.raw_put(rkey(0), b"over-tcp")
                got = rs.get(rkey(0), rs.tso.next_ts())
                assert got == b"over-tcp"
                epochs = dict(rs.epochs)
                rs.close()
                net.release_slot(2)
                assert coord.verify_drained()["ok"]
            finally:
                srv.stop()
            return opened, got, epochs
        _both(tmp_path, body)

    def test_down_window_degrades_admission_not_correctness(self, tmp_path):
        """With the coordinator unreachable, admission-shaped ops
        degrade to local-only (never a failed query) while
        correctness-critical ops (TSO) raise CoordUnavailableError
        FAST inside the down-window instead of re-paying the budget."""
        def body(m, root, coord):
            net = m.NetCoordinator("127.0.0.1:9", down_cooldown_s=60.0)
            t0 = time.monotonic()
            admitted = net.try_acquire_running(0, "g", 4)
            assert admitted is True
            assert not net.healthy()
            vts = net.vtimes(["g"])
            assert vts == {"g": 0.0}
            assert net.live_slots() == []
            err = _raises(m.CoordUnavailableError, net.tso_lease, 8)
            # one budgeted retry burst + instant short-circuits
            # afterwards
            assert time.monotonic() - t0 < 5.0
            return admitted, vts, err
        _both(tmp_path, body)
