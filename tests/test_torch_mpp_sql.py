"""The port's MPP engine (K12, ``tidb_executor_engine = 'tpu-mpp'``)
through the full SQL path, against the JAX reference on the CPU.

Every case runs the same statements on a reference ``TestKit`` (its mesh:
the 8 virtual devices tests/conftest.py forces) and on the port's (its
local mesh: ``tidb_mpp_devices`` logical shards on the CPU, every kernel
on its plain version), both at ``tidb_mpp_devices = 8`` unless stated.
Rows compare under the parity bar (exact but DOUBLE, which compare within
rtol 1e-9 / atol 1e-12; same order), each package's mesh rows also equal
its own host engine's, and each case holds the port's MPP_STATS deltas
(fragments, shuffles, skew broadcasts, retries) to the reference's — so a
port fragment that quietly fell back to one device or to the host fails.

The cases are those of tests/test_mpp_sql.py (16), tests/test_mpp_bucket.py
(13: ``test_status_and_metrics`` needs the HTTP status server, which the
port does not have yet — ROADMAP queue 1), tests/test_mpp_exchange_faults.py
(7) and tests/test_hybrid_join.py's ``test_paged_leaf_on_mesh_within_budget``;
then the placement bytes on the residency ledger against the reference's,
and one mesh of 3 shards.
"""

import json

import numpy as np
import pytest

import test_tpch
from test_device_ops import _rows_equal
from tidb_tpu.executor import mpp_exec as rexec
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.utils import failpoint as rfailpoint
from tidb_tpu_torch.executor import mpp_exec as pexec
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import failpoint as pfailpoint
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

RSTATS, PSTATS = rexec.MPP_STATS, pexec.MPP_STATS


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


@pytest.fixture(autouse=True)
def _no_port_failpoint_leaks():
    yield
    leaked = pfailpoint.list_active()
    if leaked:
        pfailpoint.disable_all()
        pytest.fail(f"test leaked active port failpoints: {leaked}")


@pytest.fixture(autouse=True)
def _cold_capacity_stores():
    """Each case starts from empty learned-capacity stores in both
    packages, as in a fresh process, and leaves them as it found them: a
    capacity one case learned would spare a later query of the same shape
    its exchange overflow retry — in the reference's own tests too, when
    they share this worker process."""
    from tidb_tpu.executor import device_join as rdj
    from tidb_tpu_torch.executor import device_join as pdj
    saved = [(m._CAP_STORE, m._CAP_STORE.copy()) for m in (rdj, pdj)]
    for store, _copy in saved:
        store.clear()
    yield
    for store, copy in saved:
        store.clear()
        store.update(copy)


class Kits:
    """The reference's kit and the port's, driven with the same
    statements."""

    def __init__(self):
        self.ref = RefKit()
        self.port = PortKit()

    def pairs(self):
        return (("ref", self.ref, RSTATS), ("port", self.port, PSTATS))

    def must_exec(self, sql):
        for _n, tk, _s in self.pairs():
            tk.must_exec(sql)


def _delta(stats, before):
    return {k: stats[k] - before[k] for k in stats}


def _run_both(kits, sql, setup=(), reset=(), host_sql=None):
    """Per package: its host engine's rows, then its mesh rows under
    `setup` (statements undone by `reset`) and the MPP_STATS deltas of the
    mesh run.  Returns {pkg: (host_rows, mesh_rows, deltas)}."""
    out = {}
    for name, tk, stats in kits.pairs():
        tk.must_exec("set tidb_executor_engine = 'host'")
        host = tk.must_query(host_sql or sql).rows
        for s in setup:
            tk.must_exec(s)
        before = dict(stats)
        tk.must_exec("set tidb_executor_engine = 'tpu-mpp'")
        try:
            mesh = tk.must_query(sql).rows
        finally:
            tk.must_exec("set tidb_executor_engine = 'auto'")
            for s in reset:
                tk.must_exec(s)
        out[name] = (host, mesh, _delta(stats, before))
    return out


def _check(out, expect_mpp=True, keys=("fragments", "shuffle_joins",
                                        "skew_broadcasts")):
    (rh, rm, rd), (ph, pm, pd) = out["ref"], out["port"]
    assert rh == rm, f"reference mesh/host divergence:\n{rm[:5]}\n{rh[:5]}"
    assert _rows_equal(pm, ph), \
        f"port mesh/host divergence:\n{pm[:5]}\n{ph[:5]}"
    assert _rows_equal(pm, rm), (f"port != reference:\nport({len(pm)}): "
                                 f"{pm[:5]}\nref({len(rm)}): {rm[:5]}")
    for k in keys:
        assert pd[k] == rd[k], (k, pd, rd)
    if expect_mpp:
        assert pd["fragments"] > 0, "the port never reached the mesh path"
    return pm


# -- tests/test_mpp_sql.py ----------------------------------------------------

@pytest.fixture(scope="module")
def tpch():
    """test_tpch.make_tpch_tk's tables in both kits (Kits stands in for
    its TestKit)."""
    tdev.set_device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_tpch, "TestKit", Kits)
        kits = test_tpch.make_tpch_tk(db="tpch_mpp_port")
    kits.must_exec("set tidb_mpp_devices = 8")
    return kits


def mpp_both(kits, sql, expect_mpp=True):
    return _check(_run_both(kits, sql), expect_mpp)


def test_q1_scan_agg(tpch):
    q = """
        select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
               sum(l_extendedprice) as sum_base_price,
               sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
               avg(l_quantity) as avg_qty, count(1) as count_order
        from lineitem where l_shipdate <= '1998-09-02'
        group by l_returnflag, l_linestatus
        order by l_returnflag, l_linestatus"""
    assert mpp_both(tpch, q)
    tk = tpch.port
    tk.must_exec("set tidb_executor_engine = 'tpu-mpp'")
    try:
        rows = tk.must_query("explain analyze " + q).rows
    finally:
        tk.must_exec("set tidb_executor_engine = 'auto'")
    assert any("engine:tpu-mpp" in str(c) for r in rows for c in r), rows


def test_q6_global_agg(tpch):
    rows = mpp_both(tpch, """
        select sum(l_extendedprice * l_discount) as revenue from lineitem
        where l_shipdate >= '1994-01-01' and l_shipdate < '1995-01-01'
          and l_discount between 0.02 and 0.08 and l_quantity < 24""")
    assert len(rows) == 1


def test_q3_join_agg(tpch):
    mpp_both(tpch, """
        select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as rev,
               o_orderdate, o_shippriority
        from customer, orders, lineitem
        where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
          and l_orderkey = o_orderkey and o_orderdate < '1995-03-15'
          and l_shipdate > '1995-03-15'
        group by l_orderkey, o_orderdate, o_shippriority
        order by rev desc, o_orderdate limit 10""")


def test_q5_multiway_join_agg(tpch):
    mpp_both(tpch, """
        select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
        from customer, orders, lineitem, supplier, nation, region
        where c_custkey = o_custkey and l_orderkey = o_orderkey
          and l_suppkey = s_suppkey and c_nationkey = s_nationkey
          and s_nationkey = n_nationkey and n_regionkey = r_regionkey
          and r_name = 'ASIA' and o_orderdate >= '1994-01-01'
          and o_orderdate < date_add('1994-01-01', interval 1 year)
        group by n_name order by revenue desc""")


def test_q9_expr_group_key(tpch):
    mpp_both(tpch, """
        select nationx, o_year, sum(amount) as sum_profit
        from (select n_name as nationx, year(o_orderdate) as o_year,
                     l_extendedprice * (1 - l_discount)
                     - ps_supplycost * l_quantity as amount
              from part, supplier, lineitem, partsupp, orders, nation
              where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
                and ps_partkey = l_partkey and p_partkey = l_partkey
                and o_orderkey = l_orderkey and s_nationkey = n_nationkey
                and p_name like '%thing%'
             ) as profit
        group by nationx, o_year order by nationx, o_year desc""")


def test_q10_wide_group_keys(tpch):
    mpp_both(tpch, """
        select c_custkey, c_name,
               sum(l_extendedprice * (1 - l_discount)) as revenue,
               c_acctbal, n_name, c_address, c_phone, c_comment
        from customer, orders, lineitem, nation
        where c_custkey = o_custkey and l_orderkey = o_orderkey
          and o_orderdate >= '1993-10-01'
          and o_orderdate < date_add('1993-10-01', interval 3 month)
          and l_returnflag = 'R' and c_nationkey = n_nationkey
        group by c_custkey, c_name, c_acctbal, c_phone, n_name,
                 c_address, c_comment
        order by revenue desc limit 20""")


def test_q18_semi_join_fallback(tpch):
    """The IN-subquery's own group-by runs on the mesh; the outer fragment
    goes where each package's planner sends it — the port's choice held
    to the reference's by the fragment counts."""
    mpp_both(tpch, """
        select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
               sum(l_quantity)
        from customer, orders, lineitem
        where o_orderkey in (select l_orderkey from lineitem
                             group by l_orderkey
                             having sum(l_quantity) > 100)
          and c_custkey = o_custkey and o_orderkey = l_orderkey
        group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
        order by o_totalprice desc, o_orderdate limit 100""")


def test_min_max_first_aggs(tpch):
    mpp_both(tpch, """
        select l_returnflag, min(l_quantity), max(l_extendedprice),
               min(l_shipdate), max(l_shipdate), count(l_comment)
        from lineitem group by l_returnflag order by l_returnflag""")


def test_agg_retry_capacity_overflow(tpch):
    """A high-cardinality group key overflows the bounded partial state;
    the host retries with a larger capacity (retry counts held equal)."""
    out = _run_both(tpch, """
        select l_orderkey, l_linenumber, count(1), sum(l_quantity)
        from lineitem group by l_orderkey, l_linenumber
        order by l_orderkey, l_linenumber limit 50""")
    _check(out, keys=("fragments", "retries"))


class TestShuffleJoin:
    """The hash-shuffle (all_to_all) join: when the build side exceeds
    tidb_broadcast_join_threshold_count, both sides are radix-partitioned
    over the mesh by join key before the local join."""

    def _shuffle(self, kits, sql, threshold):
        out = _run_both(
            kits, sql,
            setup=(f"set tidb_broadcast_join_threshold_count = {threshold}",),
            reset=("set tidb_broadcast_join_threshold_count = 10240",))
        _check(out, keys=("fragments", "shuffle_joins", "retries",
                          "exchange_overflow_retries"))
        return out["port"][2]["shuffle_joins"]

    def test_q18_shape_fact_fact_shuffle(self, tpch):
        ran = self._shuffle(tpch, """
            select o_orderstatus, count(1), sum(l_quantity)
            from orders, lineitem where o_orderkey = l_orderkey
            group by o_orderstatus order by o_orderstatus""", threshold=50)
        assert ran > 0, "build side above threshold never took shuffle"

    def test_below_threshold_stays_broadcast(self, tpch):
        ran = self._shuffle(tpch, """
            select o_orderstatus, count(1), sum(l_quantity)
            from orders, lineitem where o_orderkey = l_orderkey
            group by o_orderstatus order by o_orderstatus""",
            threshold=1000000)
        assert ran == 0, "tiny build side must stay broadcast"

    def test_shuffle_with_filters_and_dims(self, tpch):
        ran = self._shuffle(tpch, """
            select c_mktsegment, sum(l_extendedprice * (1 - l_discount))
            from customer, orders, lineitem
            where c_custkey = o_custkey and l_orderkey = o_orderkey
              and l_shipdate > '1995-03-15'
            group by c_mktsegment order by c_mktsegment""", threshold=50)
        assert ran > 0

    def test_shuffle_multi_key_join(self, tpch):
        ran = self._shuffle(tpch, """
            select count(1), sum(ps_availqty)
            from partsupp, lineitem
            where ps_partkey = l_partkey and ps_suppkey = l_suppkey""",
            threshold=40)
        assert ran > 0


def test_q18_full_shape_on_mesh(tpch):
    rows = mpp_both(tpch, """
        select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
               sum(l_quantity)
        from customer, orders, lineitem
        where o_orderkey in (select l_orderkey from lineitem
                             group by l_orderkey
                             having sum(l_quantity) > 60)
          and c_custkey = o_custkey and o_orderkey = l_orderkey
        group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
        order by o_totalprice desc, o_orderdate limit 20""")
    assert rows


class TestSkewExchange:
    def _skew(self, tpch, build_rows, probe_rows, name):
        tpch.must_exec(f"create table {name}b (k bigint, v bigint)")
        tpch.must_exec(f"insert into {name}b values "
                       + ",".join(f"({k}, {i})" for i, k in build_rows))
        tpch.must_exec(f"create table {name}p (k bigint, w bigint)")
        tpch.must_exec(f"insert into {name}p values "
                       + ",".join(f"({k}, {i})" for i, k in probe_rows))
        sql = (f"select count(1), sum({name}p.w + {name}b.v) from {name}p, "
               f"{name}b where {name}p.k = {name}b.k")
        out = _run_both(
            tpch, sql,
            setup=("set tidb_broadcast_join_threshold_count = 50",),
            reset=("set tidb_broadcast_join_threshold_count = 10240",))
        _check(out)
        return out["port"][2]

    def test_adversarial_skew_falls_back_to_broadcast(self, tpch):
        d = self._skew(tpch, [(i, 1 if i % 2 == 0 else i) for i in range(800)],
                       [(i, i % 400) for i in range(1600)], "skew")
        assert d["skew_broadcasts"] > 0, \
            "hot-key build side took the Hash exchange anyway"

    def test_mild_skew_keeps_hash_exchange(self, tpch):
        d = self._skew(tpch, [(i, i % 200) for i in range(800)],
                       [(i, i % 200) for i in range(1600)], "even")
        assert d["shuffle_joins"] > 0, \
            "uniform keys should keep the Hash exchange"


# -- tests/test_mpp_bucket.py -------------------------------------------------

@pytest.fixture()
def kits():
    k = Kits()
    k.must_exec("set tidb_mpp_devices = 8")
    k.must_exec("set tidb_executor_engine = 'tpu-mpp'")
    return k


def _port_stats():
    from tidb_tpu_torch.executor.device_exec import pipe_cache_stats
    s = pipe_cache_stats()
    return s["traces"], s["misses"]


def _parity(kits, q, expect_mpp=True):
    """Both packages' mesh rows against their host rows and each other,
    with the kits left on the mesh engine."""
    out = _check(_run_both(kits, q), expect_mpp)
    kits.must_exec("set tidb_executor_engine = 'tpu-mpp'")
    return out


def _make_fact_dim(kits, n_fact=320, n_dim=40, hot_frac=0.0):
    kits.must_exec("create table dim (k bigint primary key, g varchar(8), "
                   "w bigint)")
    vals = ",".join(f"({i}, 'g{i % 5}', {i * 3})"
                    for i in range(1, n_dim + 1))
    kits.must_exec(f"insert into dim values {vals}")
    kits.must_exec("create table fact (a bigint primary key, k bigint, "
                   "v bigint)")
    n_hot = int(n_fact * hot_frac)
    rows = []
    for i in range(1, n_fact + 1):
        k = 7 if i <= n_hot else (i % n_dim) + 1
        rows.append(f"({i}, {k}, {i * 10})")
    kits.must_exec("insert into fact values " + ",".join(rows))


JOIN_AGG_Q = ("select dim.g, count(1), sum(fact.v + dim.w) from fact, dim "
              "where fact.k = dim.k group by dim.g order by dim.g")


class TestZeroRecompile:
    """A warm re-run and a within-bucket INSERT build no new pipeline."""

    def _warm_then_insert(self, kits, q, insert):
        host0 = _parity(kits, q)
        t0 = _port_stats()
        assert kits.port.must_query(q).rows == host0
        assert _port_stats() == t0, "warm mesh round built a pipeline"
        kits.must_exec(insert)
        host1 = _parity(kits, q)
        assert host1 != host0
        kits.port.must_query(q)
        assert _port_stats()[0] == t0[0], \
            "within-bucket INSERT built a new mesh pipeline"

    def test_join_agg_zero_recompile_within_bucket(self, kits):
        _make_fact_dim(kits)
        self._warm_then_insert(kits, JOIN_AGG_Q, "insert into fact values "
                               "(321, 3, 11), (322, 4, 12)")

    def test_shuffle_join_zero_recompile_within_bucket(self, kits):
        kits.must_exec("create table bigdim (k bigint primary key, "
                       "w bigint)")
        kits.must_exec("insert into bigdim values " + ",".join(
            f"({i}, {i})" for i in range(1, 101)))
        kits.must_exec("create table bfact (a bigint primary key, k bigint, "
                       "v bigint)")
        kits.must_exec("insert into bfact values " + ",".join(
            f"({i}, {(i % 100) + 1}, {i})" for i in range(1, 241)))
        kits.must_exec("set tidb_broadcast_join_threshold_count = 50")
        q = ("select count(1), sum(bfact.v + bigdim.w) from bfact, bigdim "
             "where bfact.k = bigdim.k")
        before = PSTATS["shuffle_joins"]
        self._warm_then_insert(kits, q,
                               "insert into bfact values (241, 9, 90)")
        assert PSTATS["shuffle_joins"] > before

    def test_scan_agg_zero_recompile_within_bucket(self, kits):
        _make_fact_dim(kits)
        self._warm_then_insert(
            kits, "select k, count(1), sum(v) from fact group by k "
                  "order by k limit 5",
            "insert into fact values (321, 1, 10)")


class TestMppPaddingInvariants:
    """Nearly-all-padded edge buckets: 9 live rows shard to 2 per shard,
    bucket 8 per shard, 64 slots of which 55 are padding."""

    def _tiny(self, kits, n=9):
        kits.must_exec("create table pdim (k bigint primary key, "
                       "g varchar(4))")
        kits.must_exec("insert into pdim values " + ",".join(
            f"({i}, 'g{i % 2}')" for i in range(1, 4)))
        kits.must_exec("create table pf (a bigint primary key, k bigint, "
                       "v bigint)")
        kits.must_exec("insert into pf values " + ",".join(
            f"({i}, {(i % 3) + 1}, {i * 10})" for i in range(1, n + 1)))

    def test_unfiltered_count_sees_only_live_rows(self, kits):
        self._tiny(kits)
        assert _parity(kits, "select count(1) from pf") == [("9",)]

    def test_agg_merge_never_counts_padding(self, kits):
        self._tiny(kits)
        _parity(kits, "select k, count(1), sum(v), min(v), max(v) "
                      "from pf group by k order by k")

    def test_join_probe_never_matches_padding(self, kits):
        self._tiny(kits)
        _parity(kits, "select pdim.g, count(1), sum(pf.v) from pf, pdim "
                      "where pf.k = pdim.k group by pdim.g order by pdim.g")

    def test_exchange_never_ships_padding(self, kits):
        self._tiny(kits, n=24)
        kits.must_exec("create table pb (k bigint primary key, w bigint)")
        kits.must_exec("insert into pb values " + ",".join(
            f"({i}, {i})" for i in range(1, 13)))
        kits.must_exec("set tidb_broadcast_join_threshold_count = 4")
        before = PSTATS["shuffle_joins"]
        _parity(kits, "select count(1), sum(pf.v + pb.w) from pf, pb "
                      "where pf.k = pb.k")
        assert PSTATS["shuffle_joins"] > before

    def test_null_keys_never_exchange(self, kits):
        self._tiny(kits)
        kits.must_exec("insert into pf values (100, null, 1000)")
        _parity(kits, "select count(1), sum(pf.v) from pf, pdim "
                      "where pf.k = pdim.k")

    def test_filter_on_nearly_padded_leaf(self, kits):
        self._tiny(kits)
        _parity(kits, "select count(1), sum(v) from pf where v > 30")


class TestHotKeySkewExchange:
    """A dominant probe-side key overflows the radix exchange's initial
    sub-bucket capacity; the retry jumps to the exact need, converges
    with zero dropped rows (parity), and the count surfaces in EXPLAIN
    ANALYZE."""

    Q = ("select count(1), sum(fact.v + dim.w) from fact, dim "
         "where fact.k = dim.k")

    def _skewed(self, kits):
        _make_fact_dim(kits, n_fact=320, n_dim=64, hot_frac=0.7)
        kits.must_exec("set tidb_broadcast_join_threshold_count = 30")

    def test_hot_key_converges_no_drops(self, kits):
        self._skewed(kits)
        out = _run_both(kits, self.Q)
        _check(out, keys=("fragments", "shuffle_joins",
                          "exchange_overflow_retries"))
        d = out["port"][2]
        assert d["shuffle_joins"] > 0
        assert d["exchange_overflow_retries"] > 0

    def test_retry_count_in_explain_analyze(self, kits):
        self._skewed(kits)
        for _n, tk, _s in kits.pairs():
            tk.must_query(self.Q)  # pay the discovery retry first
            rows = tk.must_query(f"explain analyze {self.Q}").rows
            blob = "\n".join(" ".join(str(c) for c in r) for r in rows)
            assert "mpp_exchange_overflow_retries" in blob, blob
            assert "mpp_place_bytes" in blob
            assert "engine:tpu-mpp" in blob


class TestMeshEpochFence:
    def test_fence_invalidates_placements_then_reparity(self, kits):
        from tidb_tpu_torch.executor import supervisor
        _make_fact_dim(kits)
        host = _parity(kits, JOIN_AGG_Q)
        assert pexec.place_cache_bytes() > 0
        supervisor.fence("test: mesh fence")
        assert pexec.place_cache_bytes() == 0
        assert kits.port.must_query(JOIN_AGG_Q).rows == host
        assert pexec.place_cache_bytes() > 0

    def test_ledger_accounts_placement_bytes(self, kits):
        from tidb_tpu_torch.ops import residency
        _make_fact_dim(kits)
        kits.port.must_query(JOIN_AGG_Q)
        led = residency.verify_ledger()
        assert led["ok"], f"ledger drift with mesh placements: {led}"
        assert pexec.place_cache_bytes() <= residency.resident_bytes()


def test_placement_bytes_equal_reference(kits):
    """The ledger charges the port's placements the reference's logical
    bytes: sharded and replicated columns, strings as codes."""
    _make_fact_dim(kits)
    kits.must_exec("set tidb_broadcast_join_threshold_count = 30")
    for mod in (rexec, pexec):
        with mod._PLACE_LOCK:
            mod._MPP_PLACE_CACHE.clear()
    for q in (JOIN_AGG_Q, "select g, count(1) from dim group by g",
              "select count(1), sum(fact.v) from fact, dim "
              "where fact.k = dim.k"):
        for _n, tk, _s in kits.pairs():
            tk.must_query(q)
        assert pexec.place_cache_bytes() == rexec.place_cache_bytes() > 0
    assert json.dumps(pexec.report_gauges(), sort_keys=True)


# -- tests/test_mpp_exchange_faults.py ----------------------------------------

FQ = "select a, sum(b) from t group by a order by a"


@pytest.fixture()
def fkits():
    """tests/test_mpp_exchange_faults.py's table at tidb_mpp_devices = 8 on
    both kits: its fixture leaves the sysvar at 0, which is the
    reference's 8 virtual devices but no mesh in the port (0 gives none
    until a multi-card backend exists), so the port's copy names the mesh
    explicitly."""
    k = Kits()
    k.must_exec("use test")
    k.must_exec("create table t (a int, b int)")
    k.must_exec("insert into t values " + ",".join(
        f"({i % 5},{i})" for i in range(400)))
    k.must_exec("set tidb_mpp_devices = 8")
    return k


def _golden(tk, q=FQ):
    tk.must_exec("set tidb_executor_engine = 'host'")
    rows = tk.must_query(q).rows
    tk.must_exec("set tidb_executor_engine = 'tpu-mpp'")
    return rows


def _pkg(name):
    if name == "ref":
        from tidb_tpu import errors
        from tidb_tpu.executor.circuit import get_breaker
        return rfailpoint, errors, get_breaker
    from tidb_tpu_torch import errors
    from tidb_tpu_torch.executor.circuit import get_breaker
    return pfailpoint, errors, get_breaker


class TestExchangeFaults:
    def test_transient_send_fault_retried_exact(self, fkits):
        got = {}
        for name, tk, stats in fkits.pairs():
            fp, _e, _b = _pkg(name)
            golden = _golden(tk)
            before = stats["exchange_retries"]
            with fp.enabled("mpp-exchange-send", "2*panic"):
                assert tk.must_query(FQ).rows == golden
            got[name] = (golden, stats["exchange_retries"] - before)
        assert got["port"] == got["ref"]
        assert got["port"][1] == 2

    def test_transient_recv_fault_retried_exact(self, fkits):
        got = {}
        for name, tk, _s in fkits.pairs():
            fp, _e, _b = _pkg(name)
            golden = _golden(tk)
            with fp.enabled("mpp-exchange-recv", "1*panic"):
                got[name] = tk.must_query(FQ).rows
            assert got[name] == golden
        assert got["port"] == got["ref"]

    def test_persistent_fault_exhausts_classified(self, fkits):
        for name, tk, _s in fkits.pairs():
            fp, errors, _b = _pkg(name)
            _golden(tk)
            with fp.enabled("mpp-exchange-send", "panic"):
                e = tk.exec_error(FQ)
            assert isinstance(e, errors.BackoffExhaustedError), (name, e)
            assert e.code == errors.ErrCode.BackoffExhausted
            assert e.retry_kind == "exchangeRetry"
            assert e.error_class == "exchange"

    def test_exhaustion_feeds_device_breaker(self, fkits):
        for name, tk, _s in fkits.pairs():
            fp, _e, get_breaker = _pkg(name)
            _golden(tk)
            before = get_breaker(tk.session).snapshot()["failures"]
            with fp.enabled("mpp-exchange-recv", "panic"):
                tk.exec_error(FQ)
            assert get_breaker(tk.session).snapshot()["failures"] \
                == before + 1, name

    def test_recovery_after_fault_clears(self, fkits):
        for name, tk, _s in fkits.pairs():
            fp, _e, _b = _pkg(name)
            golden = _golden(tk)
            with fp.enabled("mpp-exchange-send", "panic"):
                tk.exec_error(FQ)
            assert tk.must_query(FQ).rows == golden

    def test_join_fragment_send_fault_retried(self, fkits):
        fkits.must_exec("create table o (id int, ref int, amt int)")
        fkits.must_exec("insert into o values " + ",".join(
            f"({i},{i % 400},{i % 50})" for i in range(300)))
        qj = ("select t.a, sum(o.amt) from t join o on t.b = o.ref "
              "group by t.a order by t.a")
        got = {}
        for name, tk, stats in fkits.pairs():
            fp, _e, _b = _pkg(name)
            golden = _golden(tk, qj)
            before = stats["fragments"]
            with fp.enabled("mpp-exchange-send", "1*panic"):
                got[name] = tk.must_query(qj).rows
            assert got[name] == golden
            assert stats["fragments"] > before, name
        assert got["port"] == got["ref"]

    def test_join_exhaustion_charges_join_breaker_not_agg(self, fkits):
        fkits.must_exec("create table o2 (id int, ref int, amt int)")
        fkits.must_exec("insert into o2 values " + ",".join(
            f"({i},{i % 400},{i % 50})" for i in range(300)))
        qj = ("select t.a, sum(o2.amt) from t join o2 on t.b = o2.ref "
              "group by t.a order by t.a")
        for name, tk, _s in fkits.pairs():
            fp, errors, get_breaker = _pkg(name)
            tk.must_exec("set tidb_executor_engine = 'tpu-mpp'")
            tk.must_query(qj)
            agg0 = get_breaker(tk.session, shape="agg").snapshot()["failures"]
            join0 = get_breaker(tk.session,
                                shape="join").snapshot()["failures"]
            with fp.enabled("mpp-exchange-send", "panic"):
                e = tk.exec_error(qj)
            assert isinstance(e, errors.BackoffExhaustedError), (name, e)
            assert get_breaker(tk.session, shape="join").snapshot()[
                "failures"] == join0 + 1, name
            assert get_breaker(tk.session, shape="agg").snapshot()[
                "failures"] == agg0, name


# -- tests/test_hybrid_join.py: a paged leaf on the mesh ----------------------

def test_paged_leaf_on_mesh_within_budget(tmp_path):
    """A small paged table is legal on the mesh (placement materializes
    its pages per shard under the residency budget): parity with the
    reference and the host engine, and the mesh ran."""
    from tidb_tpu.storage.paged import PagedTableWriter as RWriter
    from tidb_tpu_torch.storage.paged import PagedTableWriter as PWriter
    kits = Kits()
    kits.must_exec("create database hjmpp")
    kits.must_exec("use hjmpp")
    kits.must_exec("create table pfact (k bigint, grp bigint, v bigint)")
    kits.must_exec("create table reff (k bigint, grp bigint, v bigint)")
    rng = np.random.default_rng(5)
    n = 8000
    k = np.arange(n, dtype=np.int64)
    grp = rng.integers(0, 6, n)
    v = rng.integers(0, 500, n)
    for (name, tk, _s), writer in zip(kits.pairs(), (RWriter, PWriter)):
        info = tk.domain.infoschema().table_by_name("hjmpp", "pfact")
        pw = writer(str(tmp_path / name), info)
        pw.append({"k": k, "grp": grp, "v": v})
        columns, handles = pw.finalize()
        tk.domain.columnar_cache.install_bulk(info, columns, handles)
    kits.must_exec("insert into reff values "
                   + ",".join(f"({k[i]},{grp[i]},{v[i]})" for i in range(n)))
    sql = "select grp, count(*), sum(v) from {t} group by grp order by grp"
    out = _run_both(kits, sql.format(t="pfact"),
                    setup=("set tidb_mpp_devices = 8",),
                    host_sql=sql.format(t="reff"))
    _check(out)


# -- a mesh of 3 shards -------------------------------------------------------

def test_three_shard_mesh(kits):
    """n_dest = 3 off a power of two: a scan aggregate, a broadcast join
    and a shuffle join at tidb_mpp_devices = 3."""
    _make_fact_dim(kits, n_fact=301)
    kits.must_exec("set tidb_mpp_devices = 3")
    for q in ("select k, count(1), sum(v), min(v) from fact group by k "
              "order by k", JOIN_AGG_Q):
        _check(_run_both(kits, q))
    out = _run_both(kits, JOIN_AGG_Q,
                    setup=("set tidb_broadcast_join_threshold_count = 30",),
                    reset=("set tidb_broadcast_join_threshold_count = 10240",))
    _check(out)
    assert out["port"][2]["shuffle_joins"] > 0


def test_zero_devices_gives_no_mesh(monkeypatch):
    """tidb_mpp_devices = 0 gives the port no mesh, however many cards are
    visible (the local mesh would put them all on one): the query runs on
    the single-device engine with the host's rows and no fragment."""
    monkeypatch.setattr(pexec.torch.cuda, "device_count", lambda: 4)
    tk = PortKit()
    tk.must_exec("use test")
    tk.must_exec("create table t (a int, b int)")
    tk.must_exec("insert into t values " + ",".join(
        f"({i % 5},{i})" for i in range(400)))
    q = "select a, count(1), sum(b) from t group by a order by a"
    host = tk.must_query(q).rows
    tk.must_exec("set tidb_mpp_devices = 0")
    tk.must_exec("set tidb_executor_engine = 'tpu-mpp'")
    before = dict(PSTATS)
    rows = tk.must_query(q).rows
    assert PSTATS["fragments"] == before["fragments"]
    assert rows == host
    tk.must_exec("set tidb_mpp_devices = 2")
    assert tk.must_query(q).rows == host
    assert PSTATS["fragments"] == before["fragments"] + 1
