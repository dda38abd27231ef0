"""The port's fleet version-stamped fragment result cache
(executor/agg_cache.py + fabric/dedup.claim_versioned + fabric/coord.py
versioned claims), every case of tests/test_result_cache.py on
``tidb_tpu_torch``: two in-process replicas over ONE durable shared
store — repeat hits, cross-worker invalidation within one tail cycle
(both directions), the delta-fold bit-equality oracle, page GC under
version churn, and the ``cache-stale-read`` failpoint's loud refusal.

Beyond those, the same cache in front of the device engine (its
kernels' plain versions on the CPU): a miss runs ``engine:tpu``, the
peer replica is served ``engine:cache``, an INSERT folds, and every
answer equals the host engine's and the reference package's."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from tidb_tpu_torch.fabric.coord import Coordinator  # noqa: E402
from tidb_tpu_torch.fabric import state as fabric_state  # noqa: E402
from tidb_tpu_torch.kv import wal as wal_mod  # noqa: E402
from tidb_tpu_torch.kv.shared_store import (DurableMVCCStore,  # noqa: E402
                                      SegmentTSOracle)
from tidb_tpu_torch.kv.store import Storage  # noqa: E402
from tidb_tpu_torch.session.session import bootstrap_domain  # noqa: E402
from tidb_tpu_torch.testkit import TestKit  # noqa: E402
from tidb_tpu_torch.utils import failpoint  # noqa: E402
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

Q = ("select grp, count(*), sum(val), avg(val) from t "
     "group by grp order by grp")


class _CacheFleet:
    """Two replicas (slots 0 and 1) of one durable shared store inside
    one process, with the fabric state activated so the executor's
    cache spec builds.  No tailer threads: Storage.begin's synchronous
    catch-up IS the "one tail cycle" the invalidation contract names."""

    def __init__(self, tmp_path):
        self.c0 = Coordinator.create(str(tmp_path / "coord.json"),
                                     nslots=4)
        self.c1 = Coordinator.attach(str(tmp_path / "coord.json"))
        self.c0.claim_slot(0)
        self.c1.claim_slot(1)
        fabric_state.activate(self.c0, 0, lease_hbm=False)
        self.wal_dir = str(tmp_path / "wal")
        self.s0 = self._mk(self.c0, 0)
        self.s1 = self._mk(self.c1, 1)
        self.k0 = TestKit(bootstrap_domain(self.s0))
        self.k1 = TestKit(bootstrap_domain(self.s1))
        for k in (self.k0, self.k1):
            k.must_exec("use test")
        self.k0.must_exec("create table t (id int primary key, grp int, "
                          "val int)")
        self.k0.must_exec("insert into t values " + ",".join(
            f"({i},{i % 3},{i * 10})" for i in range(1, 31)))
        # force the cross-worker replica past its 50ms schema lease so
        # the DDL is visible before any test touches it
        self.k1.domain.maybe_reload_schema(force=True)
        self.k1.must_query("select count(*) from t")

    def _mk(self, coord, slot):
        w = wal_mod.WAL(self.wal_dir, coordinator=coord)
        eng = DurableMVCCStore(w, coordinator=coord, slot=slot,
                               oracle=SegmentTSOracle(coord))
        eng.recover()
        return Storage(mvcc=eng)

    def counters(self):
        return self.c0.counters()

    def agg_line(self, kit, query=Q):
        rows = kit.must_query("explain analyze " + query).rows
        for r in rows:
            line = " | ".join(str(c) for c in r)
            if "HashAgg" in line:
                return line
        raise AssertionError(f"no HashAgg line in {rows}")

    def close(self):
        fabric_state.deactivate()
        self.s0.close()
        self.s1.close()
        self.c1.close()
        self.c0.unlink()


@pytest.fixture()
def cf(tmp_path):
    f = _CacheFleet(tmp_path)
    yield f
    f.close()


def test_repeat_hit_bypasses_compute(cf):
    first = cf.k0.must_query(Q).rows
    base = cf.counters()["fabric_cache_hits"]
    for _ in range(3):
        assert cf.k0.must_query(Q).rows == first
    assert cf.counters()["fabric_cache_hits"] >= base + 3
    line = cf.agg_line(cf.k0)
    assert "cache:hit" in line and "cache_vv:" in line


def test_cross_worker_hit_and_invalidation_a_to_b(cf):
    before = cf.k1.must_query(Q).rows  # k1 serves (or leads) the page
    hits0 = cf.counters()["fabric_cache_hits"]
    assert cf.k1.must_query(Q).rows == before
    assert cf.counters()["fabric_cache_hits"] == hits0 + 1
    # INSERT on worker A must invalidate worker B's cached entry within
    # one tail cycle (the next statement's synchronous catch-up)
    cf.k0.must_exec("insert into t values (31, 0, 999)")
    inv0 = cf.counters()["fabric_cache_invalidations"]
    after = cf.k1.must_query(Q).rows
    assert after != before
    assert after[0][1] == "11"  # grp 0 gained a row
    assert cf.counters()["fabric_cache_invalidations"] == inv0 + 1


def test_cross_worker_invalidation_b_to_a(cf):
    before = cf.k0.must_query(Q).rows
    cf.k1.must_exec("insert into t values (32, 1, -5)")
    after = cf.k0.must_query(Q).rows
    assert after != before
    assert after[1][1] == "11"  # grp 1 gained a row


def test_delta_fold_bit_equal_to_fresh(cf):
    cf.k0.must_query(Q)  # publish at the current version
    folds0 = cf.counters()["fabric_cache_delta_folds"]
    cf.k1.must_exec("insert into t values (33, 2, 123)")
    folded = cf.k0.must_query(Q).rows  # pure-insert delta -> fold
    assert cf.counters()["fabric_cache_delta_folds"] == folds0 + 1
    cf.k1.must_exec("set tidb_result_cache = 'OFF'")
    fresh = cf.k1.must_query(Q).rows
    assert folded == fresh  # bit-equal: same strings, same rounding


def test_update_delta_recomputes_not_folds(cf):
    cf.k0.must_query(Q)
    folds0 = cf.counters()["fabric_cache_delta_folds"]
    inv0 = cf.counters()["fabric_cache_invalidations"]
    cf.k1.must_exec("update t set val = val + 1 where id = 1")
    folded = cf.k0.must_query(Q).rows  # non-insert delta: full recompute
    assert cf.counters()["fabric_cache_delta_folds"] == folds0
    assert cf.counters()["fabric_cache_invalidations"] == inv0 + 1
    cf.k1.must_exec("set tidb_result_cache = 'OFF'")
    assert folded == cf.k1.must_query(Q).rows


def test_page_gc_under_version_churn(cf):
    """Repeated version bumps republish the page each round; superseded
    pages must be unlinked, keeping the pages dir bounded."""
    pages = pathlib.Path(cf.c0.pages_dir)
    cf.k0.must_query(Q)
    for i in range(12):
        cf.k0.must_exec(f"insert into t values ({40 + i}, {i % 3}, {i})")
        cf.k0.must_query(Q)  # fold or recompute -> republish
    n_pages = len(list(pages.glob("*")))
    assert n_pages <= 8, (
        f"pages dir grew to {n_pages} files under version churn — "
        "superseded result pages are not being unlinked")


def test_stale_read_failpoint_refused_loudly(cf):
    """cache-stale-read skips the claim-time vector check, serving a
    deliberately version-STALE page into the in-page verify — which
    must refuse it (cache_stale_reads), recompute locally and still
    return the right answer.  A silent wrong answer is the one
    unforgivable cache failure."""
    cf.k0.must_query(Q)  # page at version T0
    cf.k1.must_exec("insert into t values (50, 0, 777)")
    stale0 = cf.counters()["fabric_cache_stale_reads"]
    with failpoint.enabled("cache-stale-read", "return(1)"):
        rows = cf.k0.must_query(Q).rows
    assert rows[0][1] == "11"  # the insert IS visible: exact answer
    assert cf.counters()["fabric_cache_stale_reads"] == stale0 + 1


def test_explain_analyze_outcomes_and_sysvar_off(cf):
    cf.k0.must_exec("set tidb_result_cache = 'OFF'")
    line = cf.agg_line(cf.k0)
    assert "cache:" not in line  # OFF: no spec, no EXPLAIN noise
    cf.k0.must_exec("set tidb_result_cache = 'ON'")
    line = cf.agg_line(cf.k0)  # explain executes: first eligible run
    assert "cache:miss" in line or "cache:hit" in line
    line = cf.agg_line(cf.k0)
    assert "cache:hit" in line and "cache_vv:" in line
    # a non scan-agg shape reports why it can't cache
    j = ("select a.grp, count(*) from t a join t b on a.id = b.id "
         "group by a.grp order by a.grp")
    line = cf.agg_line(cf.k0, j)
    assert "cache:miss" in line and "cache_why:" in line


def test_device_engine_miss_hit_fold(cf, tmp_path):
    from tidb_tpu.testkit import TestKit as RefKit
    from tidb_tpu_torch.ops import device
    device.set_device("cpu")
    for k in (cf.k0, cf.k1):
        k.must_exec("set tidb_executor_engine = 'tpu'")
    line = cf.agg_line(cf.k0)
    assert "engine:tpu" in line and "cache:miss" in line, line
    line = cf.agg_line(cf.k1)
    assert "engine:cache" in line and "cache:hit" in line, line
    hit = cf.k1.must_query(Q).rows
    cf.k1.must_exec("insert into t values (33, 2, 123)")
    folds0 = cf.counters()["fabric_cache_delta_folds"]
    folded = cf.k0.must_query(Q).rows
    assert cf.counters()["fabric_cache_delta_folds"] == folds0 + 1
    cf.k1.must_exec("set tidb_result_cache = 'OFF'")
    cf.k1.must_exec("set tidb_executor_engine = 'host'")
    assert folded == cf.k1.must_query(Q).rows
    ref = RefKit()
    ref.must_exec("use test")
    ref.must_exec("create table t (id int primary key, grp int, val int)")
    ref.must_exec("insert into t values " + ",".join(
        f"({i},{i % 3},{i * 10})" for i in range(1, 31)))
    assert hit == ref.must_query(Q).rows
    ref.must_exec("insert into t values (33, 2, 123)")
    assert folded == ref.must_query(Q).rows
