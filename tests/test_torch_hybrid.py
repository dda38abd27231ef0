"""The port's hybrid hash join (``tidb_tpu_torch/executor/hybrid_join.py``)
against the JAX reference on the CPU.

Every case of tests/test_hybrid_join.py but two runs here on the same
tables in the reference's ``TestKit`` and the port's (the same seeded
INSERT statements, or the same ``PagedTableWriter`` pages): rows equal
the reference's (tests/test_device_ops.py's ``_rows_equal``: doubles
within rtol 1e-9 / atol 1e-12, everything else exact) and the port's host
engine's exactly; ``hybrid_join.STATS["hj_runs"]`` moved in the port (a
row compare alone would pass if the port declined to its host engine);
the first run's partition count and spilled-partition count equal the
reference's; no spill set stays open and the residency ledger is
consistent.  Not ported here: ``test_compile_pending_shifts_hostward``
(the port builds its programs synchronously; ROADMAP queue 1, the
compile layer); ``test_paged_leaf_on_mesh_within_budget`` runs in
tests/test_torch_mpp_sql.py.

Beyond those: the radix split against the reference's MPP mix64 and
radix-bucket destination fold, the host half's numpy fold against the
reference's, a CUDA out-of-memory error's classification, and TPC-H Q5 /
Q3 / Q9 at SF 0.01 under budgets that scale chip_smoke.py's SF10
``[hybrid]`` budgets (300 MB, 120 MB) by the same 1/1000.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from test_device_ops import _rows_equal
from tidb_tpu.executor import device_exec as rexec
from tidb_tpu.executor import hybrid_join as rhj
from tidb_tpu.ops import residency as rres
from tidb_tpu.parallel import mpp as rmpp
from tidb_tpu.storage.paged import PagedTableWriter as RefWriter
from tidb_tpu.storage.paged import spill_outstanding as ref_spill
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.utils import failpoint as rfp
from tidb_tpu_torch import carry
from tidb_tpu_torch.executor import device_exec as pexec
from tidb_tpu_torch.executor import hybrid_join as phj
from tidb_tpu_torch.executor.device_join import LAST_PAGED_STATS
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops import residency as pres
from tidb_tpu_torch.storage.paged import PagedTableWriter as PortWriter
from tidb_tpu_torch.storage.paged import SpillSet, spill_outstanding
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import backoff
from tidb_tpu_torch.utils import failpoint as pfp


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


@pytest.fixture(autouse=True)
def _reset_budget():
    # a clean ledger and throughput store per test in both packages (the
    # reference test's fixture): prior uploads would shrink the free
    # share, and the measured host rate would move later splits
    # host-ward, so the split geometry under test would drift
    for res, hj in ((rres, rhj), (pres, phj)):
        res.evict_all("hybrid-join test reset")
        hj._THROUGHPUT.clear()
    yield
    for res in (rres, pres):
        res.set_budget(0)
    rfp.disable_all()
    leaked = pfp.list_active()
    pfp.disable_all()
    assert not leaked, f"test leaked active port failpoints: {leaked}"


def _kits(setup, db, **kw):
    kits = (RefKit(), PortKit())
    for tk in kits:
        tk.must_exec(f"create database {db}")
        tk.must_exec(f"use {db}")
        setup(tk, **kw)
    return kits


def _q5_tables(tk, nl=4500, no=4000):
    """tests/test_hybrid_join.py's Q5-shaped schema: fact li ⋈ BIG ord
    (date-filtered) ⋈ cust ⋈ nation, grouped by a string key."""
    tk.must_exec("create table nation (nk bigint primary key, "
                 "nname varchar(20))")
    tk.must_exec("create table cust (ck bigint primary key, cnk bigint)")
    tk.must_exec("create table ord (ok_ bigint primary key, ock bigint, "
                 "odate date, pad1 bigint, pad2 bigint, pad3 bigint)")
    tk.must_exec("create table li (lok bigint, lval bigint, lsk bigint)")
    rng = np.random.default_rng(11)
    nn, nc = 5, 50
    tk.must_exec("insert into nation values "
                 + ",".join(f"({i},'nat{i}')" for i in range(nn)))
    tk.must_exec("insert into cust values "
                 + ",".join(f"({i},{int(rng.integers(0, nn))})"
                            for i in range(nc)))
    days = rng.integers(0, 1000, no)
    base = np.datetime64("1994-01-01")
    rows = ",".join(
        f"({i},{int(rng.integers(0, nc))},"
        f"'{base + np.timedelta64(int(days[i]), 'D')}',{i % 3},{i % 5},"
        f"{i % 7})" for i in range(no))
    tk.must_exec(f"insert into ord values {rows}")
    loks = rng.integers(0, no, nl)
    lvs = rng.integers(1, 100, nl)
    lsks = rng.integers(0, nn, nl)
    rows = ",".join(f"({int(loks[i])},{int(lvs[i])},{int(lsks[i])})"
                    for i in range(nl))
    tk.must_exec(f"insert into li values {rows}")


Q5SQL = ("select nname, sum(lval*pad2) rev, count(*) c "
         "from li, ord, cust, nation "
         "where lok = ok_ and ock = ck and cnk = nk and lsk = nk "
         "and odate < '1995-06-01' "
         "group by nname order by rev desc, nname")


def _wide_tables(tk, nb=6000, nf=8000):
    """tests/test_hybrid_join.py's 2-table shape with a WIDE build side:
    a mid budget fits some partitions on the device and spills the
    rest."""
    tk.must_exec("create table fact (fk bigint, v bigint)")
    tk.must_exec("create table big (id bigint primary key, w1 bigint, "
                 "w2 bigint, w3 bigint, w4 bigint)")
    rng = np.random.default_rng(3)
    rows = ",".join(f"({i},{i % 7},{i % 11},{i % 13},{i % 17})"
                    for i in range(nb))
    tk.must_exec(f"insert into big values {rows}")
    vals = rng.integers(0, nb, nf)
    vv = rng.integers(1, 50, nf)
    rows = ",".join(f"({int(vals[i])},{int(vv[i])})" for i in range(nf))
    tk.must_exec(f"insert into fact values {rows}")


WIDESQL = ("select w1, sum(v*w2) s, sum(w3+w4) t, count(*) c "
           "from fact, big where fk = id group by w1 order by w1")


@pytest.fixture(scope="module")
def q5_kits():
    """The Q5-shaped tables at their default size, shared by the cases
    that only read them."""
    return _kits(_q5_tables, "hjq5")


@pytest.fixture(scope="module")
def wide_kits():
    """The wide-build tables, shared by the cases that only read them."""
    return _kits(_wide_tables, "hjwide")


def _split(stats):
    return stats["hj_partitions"], stats["hj_spilled_partitions"]


def _both(kits, sql, budget, host_sql=None):
    """`sql` on the port's host engine, then on both device engines under
    `budget`: the port's rows equal the reference's and its host
    engine's, the port's first-run split equals the reference's, the
    spill sets are drained and the port's ledger is consistent.  Returns
    (rows, the port's hj_runs delta)."""
    ref, port = kits
    port.must_exec("set tidb_executor_engine = 'host'")
    host = port.must_query(host_sql or sql).rows
    for tk in kits:
        tk.must_exec(f"set global tidb_device_mem_budget = {budget}")
        tk.must_exec("set tidb_executor_engine = 'tpu'")
    r0, p0 = rhj.STATS["hj_runs"], phj.STATS["hj_runs"]
    want = ref.must_query(sql).rows
    got = port.must_query(sql).rows
    ran_ref = rhj.STATS["hj_runs"] - r0
    ran = phj.STATS["hj_runs"] - p0
    assert _rows_equal(got, want), (f"port/reference divergence\n"
                                    f"port: {got[:5]}\nref:  {want[:5]}")
    assert got == host, f"port hybrid/host divergence\n{got[:5]}\n{host[:5]}"
    assert ran == ran_ref
    if ran:
        assert _split(phj.STATS) == _split(rhj.STATS)
    assert spill_outstanding()["open_sets"] == 0
    assert ref_spill()["open_sets"] == 0
    led = pres.verify_ledger()
    assert led["ok"], f"port ledger drift: {led}"
    return got, ran


class TestSpillParity:
    def test_no_spill_generous_budget(self, q5_kits):
        """0% spill: a budget above the build estimate never triggers the
        hybrid path in either package."""
        _rows, ran = _both(q5_kits, Q5SQL, 10_000_000)
        assert ran == 0

    def test_nearly_all_spill_edge(self):
        """~100% spill: no partition fits on the device — the host
        co-processing half carries the whole join."""
        kits = _kits(_q5_tables, "hj100", nl=9000)
        _rows, ran = _both(kits, Q5SQL, 90_000)
        assert ran == 1
        s = phj.STATS
        assert s["hj_partitions"] >= 2
        assert s["hj_spilled_partitions"] == s["hj_partitions"]

    def test_mixed_split_acceptance(self, wide_kits):
        """Some partitions on the device, some spilled, exact rows, and
        the gauges in the port's EXPLAIN ANALYZE (hj_partitions >
        hj_spilled_partitions > 0) with the device pass's page stats."""
        kits = wide_kits
        _rows, ran = _both(kits, WIDESQL, 120_000)
        assert ran == 1
        s = phj.STATS
        assert s["hj_spilled_partitions"] > 0
        assert s["hj_partitions"] > s["hj_spilled_partitions"]
        st = dict(LAST_PAGED_STATS.items())
        assert st["kind"] == "hybrid" and st["pages"] >= 1
        assert st["merges"] >= 2  # the page fold and the final fold
        info = "\n".join(str(r) for r in kits[1].must_query(
            "explain analyze " + WIDESQL).rows)
        for key in ("hj_partitions", "hj_spilled_partitions",
                    "hj_spill_bytes", "hj_coproc_host_rows",
                    "kind:hybrid", "engine:tpu"):
            assert key in info, info
        assert spill_outstanding()["open_sets"] == 0

    def test_string_group_key_across_halves(self, q5_kits):
        """String group keys flow through BOTH halves (device partitions
        through dictionary codes, host partitions through the same code
        space)."""
        _rows, ran = _both(q5_kits, Q5SQL, 90_000)
        assert ran == 1
        assert phj.STATS["hj_spilled_partitions"] > 0

    @pytest.mark.parametrize("sql", [
        "select w1, min(w2) a, max(v) b, avg(v*w3) c, count(w4) d "
        "from fact, big where fk = id and v > 3 group by w1 order by w1",
        "select count(*) c, sum(v*w2) s, max(w4) m from fact, big "
        "where fk = id",
        "select w1, w2, sum(v) s from fact, big where fk = id "
        "group by w1, w2 order by s desc, w1, w2 limit 5",
    ], ids=["min_max_avg", "global", "top_n"])
    def test_merge_ops_across_halves(self, wide_kits, sql):
        """MIN / MAX / AVG (a sum and a count slot) / COUNT of a column,
        a global aggregate and a top-N over the mixed split: every merge
        op folds device and host states together."""
        _rows, ran = _both(wide_kits, sql, 120_000)
        assert ran == 1
        assert 0 < phj.STATS["hj_spilled_partitions"] \
            < phj.STATS["hj_partitions"]


class TestZeroRecompile:
    def test_repeat_and_within_bucket_insert(self):
        """A repeat run reuses the fragment program; a within-bucket
        build-side INSERT rebuilds only the numpy partition indexes —
        no new program build either way."""
        kits = _kits(_wide_tables, "hjzc")
        host, ran = _both(kits, WIDESQL, 120_000)
        assert ran == 1
        port = kits[1]
        c0 = pexec.pipe_cache_stats()["compiles"]
        assert port.must_query(WIDESQL).rows == host
        assert pexec.pipe_cache_stats()["compiles"] == c0, \
            "repeat run built a program"
        port.must_exec("insert into big values (6001, 1, 2, 3, 4)")
        port.must_exec("set tidb_executor_engine = 'tpu'")
        dev3 = port.must_query(WIDESQL).rows
        port.must_exec("set tidb_executor_engine = 'host'")
        assert dev3 == port.must_query(WIDESQL).rows
        assert pexec.pipe_cache_stats()["compiles"] == c0, (
            "within-bucket build INSERT rebuilt the hybrid program")


class TestChaos:
    def test_spill_failpoint_degrades_clean(self, q5_kits):
        """An injected spill-write failure degrades the fragment to the
        host engine (exact rows) and leaves no spilled pages and no
        ledger drift."""
        port = q5_kits[1]
        port.must_exec("set tidb_executor_engine = 'host'")
        host = port.must_query(Q5SQL).rows
        port.must_exec("set global tidb_device_mem_budget = 90000")
        port.must_exec("set tidb_executor_engine = 'tpu'")
        aborts0 = phj.STATS["hj_aborts"]
        with pfp.enabled("device-join-spill", "spill-fail"):
            rows = port.must_query(Q5SQL).rows
        assert rows == host
        assert phj.STATS["hj_aborts"] > aborts0
        assert spill_outstanding()["open_sets"] == 0
        led = pres.verify_ledger()
        assert led["ok"], f"ledger drift after spill abort: {led}"

    def test_transient_spill_failure_recovers(self):
        """1*spill-fail: the first partition write fails (this query
        degrades), the NEXT run spills clean and answers exactly — with
        the reference's hybrid runs and aborts."""
        kits = _kits(_q5_tables, "hjfp1", nl=2000)
        port = kits[1]
        port.must_exec("set tidb_executor_engine = 'host'")
        host = port.must_query(Q5SQL).rows
        moved = []
        for tk, hj, fp in zip(kits, (rhj, phj), (rfp, pfp)):
            tk.must_exec("set global tidb_device_mem_budget = 90000")
            tk.must_exec("set tidb_executor_engine = 'tpu'")
            s0 = dict(hj.STATS)
            with fp.enabled("device-join-spill", "1*spill-fail"):
                assert tk.must_query(Q5SQL).rows == host
                assert tk.must_query(Q5SQL).rows == host
            moved.append((hj.STATS["hj_runs"] - s0["hj_runs"],
                          hj.STATS["hj_aborts"] - s0["hj_aborts"]))
        assert moved[1] == moved[0]
        assert spill_outstanding()["open_sets"] == 0

    def test_mid_probe_oom_no_leaks(self, q5_kits):
        """A device OOM at the upload boundary mid-hybrid walks the
        evict-all ladder / degrades, with no spilled pages or ledger
        bytes leaked and an exact answer either way."""
        port = q5_kits[1]
        port.must_exec("set tidb_executor_engine = 'host'")
        host = port.must_query(Q5SQL).rows
        port.must_exec("set global tidb_device_mem_budget = 90000")
        port.must_exec("set tidb_executor_engine = 'tpu'")
        with pfp.enabled("device-upload-oom", "oom"):
            assert port.must_query(Q5SQL).rows == host
        assert spill_outstanding()["open_sets"] == 0
        led = pres.verify_ledger()
        assert led["ok"], f"ledger drift after OOM chaos: {led}"

    def test_cuda_oom_is_a_device_oom(self):
        """The card's own out-of-memory error classifies as a device OOM,
        so run_device's ladder (residency.recover_oom) runs for it."""
        err = torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB")
        assert backoff.classify(err) == backoff.CLASS_DEVICE
        assert backoff.is_device_oom(err)
        assert not backoff.is_device_oom(RuntimeError("CUDA error: an "
                                                      "illegal memory "
                                                      "access"))


class TestConcurrency:
    def test_concurrent_sessions(self, wide_kits):
        """Eight sessions run the mixed split at once (the host pass of
        each on a supervisor worker, STATS shared): every run answers
        the host engine's rows, every run is counted, no spill set stays
        open and the ledger stays consistent."""
        import sys
        import threading
        from tidb_tpu_torch.session import new_session
        port = wide_kits[1]
        port.must_exec("set tidb_executor_engine = 'host'")
        host = port.must_query(WIDESQL).rows
        port.must_exec("set global tidb_device_mem_budget = 120000")
        n_threads, reps = 8, 3
        results, errors = [], []

        def work():
            try:
                s = new_session(port.domain)
                s.execute("use hjwide")
                s.execute("set tidb_executor_engine = 'tpu'")
                for _ in range(reps):
                    results.append(s.execute(WIDESQL)[-1].rows)
            except BaseException as e:  # reported below
                errors.append(repr(e))

        runs0 = phj.STATS["hj_runs"]
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert len(results) == n_threads * reps
        assert all(r == host for r in results)
        assert phj.STATS["hj_runs"] - runs0 == n_threads * reps
        assert spill_outstanding()["open_sets"] == 0
        assert pres.verify_ledger()["ok"]


class TestPagedBuild:
    def test_paged_build_deferred_partition_index(self, tmp_path):
        """A DISK-BACKED build side too big to index whole (the plan-time
        paged guard) joins through deferred per-partition indexes."""
        rng = np.random.default_rng(7)
        nb, nf = 5000, 8000
        ids = np.arange(nb, dtype=np.int64)
        w = rng.integers(1, 100, nb)
        fks = rng.integers(0, nb, nf)
        vv = rng.integers(1, 50, nf)
        kits = (RefKit(), PortKit())
        for tk, writer, tag in ((kits[0], RefWriter, "ref"),
                                (kits[1], PortWriter, "port")):
            tk.must_exec("create database hjpg")
            tk.must_exec("use hjpg")
            tk.must_exec("create table fact (fk bigint, v bigint)")
            tk.must_exec("create table pbig (id bigint, w bigint)")
            tk.must_exec("create table refbig (id bigint, w bigint)")
            info = tk.domain.infoschema().table_by_name("hjpg", "pbig")
            pw = writer(str(tmp_path / tag / "pbig"), info)
            for lo in range(0, nb, 1500):
                hi = min(lo + 1500, nb)
                pw.append({"id": ids[lo:hi], "w": w[lo:hi]})
            columns, handles = pw.finalize()
            tk.domain.columnar_cache.install_bulk(info, columns, handles)
            tk.must_exec("insert into refbig values " + ",".join(
                f"({ids[i]},{w[i]})" for i in range(nb)))
            tk.must_exec("insert into fact values " + ",".join(
                f"({int(fks[i])},{int(vv[i])})" for i in range(nf)))
        sql = "select count(*) c, sum(v*w) s from fact, {b} where fk = id"
        port = kits[1]
        port.must_exec("set tidb_executor_engine = 'host'")
        host = port.must_query(sql.format(b="refbig")).rows
        # rows*16 > budget: the plan-time guard refuses the whole index,
        # the deferred reorder + hybrid partition path must carry it
        for tk in kits:
            tk.must_exec("set global tidb_device_mem_budget = 60000")
            tk.must_exec("set tidb_executor_engine = 'tpu'")
        r0, p0 = rhj.STATS["hj_runs"], phj.STATS["hj_runs"]
        want = kits[0].must_query(sql.format(b="pbig")).rows
        got = port.must_query(sql.format(b="pbig")).rows
        assert got == host and _rows_equal(got, want)
        assert phj.STATS["hj_runs"] - p0 == 1
        assert rhj.STATS["hj_runs"] - r0 == 1
        assert _split(phj.STATS) == _split(rhj.STATS)
        assert spill_outstanding()["open_sets"] == 0


class TestSpillSet:
    def test_roundtrip_and_drain(self):
        s = SpillSet(tag="unit")
        d = np.arange(100, dtype=np.int64)
        nl = np.zeros(100, dtype=bool)
        s.write(3, {0: (d, nl), 2: (d * 2, nl)})
        assert spill_outstanding()["open_sets"] == 1
        back = s.read(3)
        assert np.array_equal(np.asarray(back[0][0]), d)
        assert np.array_equal(np.asarray(back[2][0]), d * 2)
        s.close()
        s.close()  # idempotent
        assert spill_outstanding()["open_sets"] == 0

    def test_object_arrays_refused(self):
        s = SpillSet(tag="obj")
        try:
            with pytest.raises(ValueError):
                s.write(0, {0: (np.array([b"x"], dtype=object),
                               np.zeros(1, dtype=bool))})
        finally:
            s.close()


# -- the gauges the status page reads ------------------------------------------

_GAUGES = ("hj_partitions", "hj_spilled_partitions", "hj_spill_bytes",
           "hj_coproc_host_rows")


class TestStatusGauges:
    """``hybrid_join.snapshot`` / ``report_gauges`` and
    ``compile_service.snapshot``, which the status page's
    ``device_hybrid_join`` / ``device_compiler`` and /metrics read."""

    def test_snapshot_keys_equal_reference(self):
        from tidb_tpu.executor import compile_service as rcs
        from tidb_tpu_torch.executor import compile_service as pcs
        assert sorted(phj.snapshot()) == sorted(rhj.snapshot())
        assert sorted(pcs.snapshot()) == sorted(rcs.snapshot())
        # a synchronous service: no queue, no workers, no background
        # build
        snap = pcs.snapshot()
        assert pcs.queue_depth() == snap["compile_queue_depth"] == 0
        assert snap["workers"] == snap["bg_submitted"] == 0
        assert pcs.report_gauges()["compile_queue_depth"] == 0

    def test_counters_move_on_a_hybrid_run(self, wide_kits):
        before = phj.snapshot()
        _rows, ran = _both(wide_kits, WIDESQL, 120_000)
        assert ran == 1
        after = phj.snapshot()
        assert after["hj_runs"] == before["hj_runs"] + 1
        assert after["hj_partitions"] > after["hj_spilled_partitions"] > 0
        assert after["hj_spill_bytes"] > 0
        assert after["hj_coproc_host_rows"] > 0
        assert after["spill_open_sets"] == after["spill_open_bytes"] == 0
        gauges = phj.report_gauges()
        assert gauges == {k: after[k] for k in _GAUGES}
        ref = rhj.report_gauges()
        assert sorted(ref) == sorted(gauges)
        assert [gauges[k] for k in _GAUGES[:2]] == [ref[k]
                                                     for k in _GAUGES[:2]]

    def test_report_gauges_empty_before_any_hybrid_run(self):
        """A fresh process: the gauges appear only once the path ran."""
        import subprocess
        import sys
        proc = subprocess.run(
            [sys.executable, "-c",
             "from tidb_tpu_torch.executor import hybrid_join as h, "
             "compile_service as c; print(h.report_gauges(), "
             "h.snapshot()['hj_runs'], c.report_gauges())"],
            capture_output=True, text=True, timeout=120,
            cwd=__file__.rsplit("/tests/", 1)[0])
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split() == ["{}", "0", "{'compile_queue_depth':",
                                       "0}"]


# -- the radix split and the host fold against the reference ----------------

@pytest.mark.parametrize("n_parts", [2, 8, 128])
def test_part_ids_match_mpp_radix_bucket(n_parts):
    """The port's partition ids equal the reference's MPP exchange
    destinations (``parallel.mpp._mix64`` + ``_radix_bucket``'s
    destination fold) on seeded int64 keys, int64 min/max and negatives
    included; rows that cannot match park at -1 (the exchange parks them
    past every bucket)."""
    rng = np.random.default_rng(5)
    i64 = np.iinfo(np.int64)
    keys = np.concatenate([
        rng.integers(i64.min, i64.max, 5000, dtype=np.int64),
        rng.integers(-1000, 1000, 2000),
        np.array([i64.min, i64.max, -1, 0, 1], dtype=np.int64)])
    ok = rng.random(len(keys)) < 0.9
    h_ref = np.asarray(rmpp._mix64(jnp.asarray(keys)))
    assert np.array_equal(phj._mix64_np(keys), h_ref)
    bucket, nb = rmpp._radix_bucket(jnp.asarray(h_ref), jnp.asarray(ok),
                                    n_parts, rmpp.RADIX_SUB)
    bucket = np.asarray(bucket)
    want = np.where(bucket < nb, bucket // rmpp.RADIX_SUB, -1)
    assert np.array_equal(phj._part_ids(keys, ok, n_parts), want)
    # and the hybrid reference's own numpy split
    assert np.array_equal(phj._part_ids(keys, ok, n_parts),
                          rhj._part_ids(keys, ok, n_parts))


def test_host_fold_matches_reference():
    """The host half's fold (page_singleton_state + _merge_states_host)
    equals the reference's on seeded raw rows with NULL keys, NULL
    values and every merge op."""
    rng = np.random.default_rng(9)
    n = 3000
    keys = (rng.integers(0, 40, n), rng.integers(-3, 3, n))
    knulls = (rng.random(n) < 0.05, np.zeros(n, bool))
    vals = (rng.integers(-10**6, 10**6, n), rng.standard_normal(n),
            rng.integers(0, 9, n), rng.integers(0, 9, n),
            rng.integers(0, 99, n), rng.integers(0, 99, n))
    vnulls = tuple(rng.random(n) < 0.1 for _ in vals)
    mask = rng.random(n) < 0.8
    agg_ops = ("sum_i", "sum_f", "min", "max", "first", "count")
    merge_ops = tuple(pexec._MERGE_OPS[o] for o in agg_ops)
    pack = ((7, 0), (4, 3))
    pages_p = [pexec.page_singleton_state(
        keys, knulls, vals, vnulls, mask & (np.arange(n) % 3 == r), agg_ops)
        for r in range(3)]
    pages_r = [rexec.page_singleton_state(
        keys, knulls, vals, vnulls, mask & (np.arange(n) % 3 == r), agg_ops)
        for r in range(3)]
    got, cap_p = pexec._merge_states_host(pages_p, 16, 2, len(vals),
                                          merge_ops, pack)
    want, cap_r = rexec._merge_states_host(pages_r, 16, 2, len(vals),
                                           merge_ops, pack)
    assert cap_p == cap_r and got[4] == int(want[4]) > 16
    for a, b in zip(got[:4], want[:4]):
        for x, y in zip(a, b):
            assert isinstance(x, np.ndarray)
            assert np.array_equal(x, np.asarray(y))
    assert np.array_equal(got[5], np.asarray(want[5]))


# -- the slice as a whole: TPC-H at SF 0.01 under scaled budgets -------------

@pytest.fixture(scope="module")
def tpch_kits():
    ref = RefKit()
    bench.gen_all(ref, 0.01)
    port = PortKit()
    carry.install_tpch(port.must_exec, port.domain, "tpch",
                       carry.gen_tpch(0.01))
    return ref, port


@pytest.mark.parametrize("budget", [300_000, 120_000])
@pytest.mark.parametrize("q", ["q5", "q3", "q9"])
def test_tpch_under_budget(tpch_kits, q, budget):
    """bench.py's Q5 / Q3 / Q9 under 1/1000 of chip_smoke's SF10 budgets:
    the same rows as the reference and the port's host engine, and the
    same path — hybrid in both with the same first-run split, or in
    neither.  Q5 takes the hybrid path at both budgets, and at the
    smaller one spills at least one partition (the SF10 contract)."""
    sql = bench.QUERIES[q]
    # Q9 on the host engine: bulk tables bypass the KV store its index
    # join seeks, so the hint keeps it on hash joins (chip_smoke.py's
    # HOST_TEXT)
    host_sql = sql.replace("from (select n_name",
                           "from (select /*+ HASH_JOIN(part, orders) */ "
                           "n_name")
    rows, ran = _both(tpch_kits, sql, budget, host_sql=host_sql)
    assert rows
    if q == "q5":
        assert ran == 1
        if budget == 120_000:
            assert phj.STATS["hj_spilled_partitions"] > 0
