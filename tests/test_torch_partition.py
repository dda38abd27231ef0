"""The port's partitioned tables (``tidb_tpu_torch/partition.py``:
RANGE / LIST / HASH routing, pruning, partition DDL) against the
reference's, on the CPU.

Every case of tests/test_partition.py runs once in each package on the
same statements; each case records what the statements answered (rows,
EXPLAIN text, or the error's code and message) and the port's record must
equal the reference's.  The reference test's own assertions hold on both.

Beyond those:

* an aggregate over a partitioned table on the device engine, pruned to
  one partition and over all of them: rows equal to the reference's
  device engine, ``engine:tpu`` in the port's EXPLAIN ANALYZE and K2's
  and K1's wrappers called (on the CPU they run the plain versions);
* ``carry.install_bulk_numpy`` into a partitioned table: each partition
  holds the rows an INSERT of the same values puts there;
* a stated divergence: on RANGE over YEAR / TO_DAYS of a date the port
  prunes date ranges as bounds on the function's value (the reference
  prunes no range there), and skips a DATETIME bound on a DATE column
  (``DATE_ADD``), where the reference raises OverflowError; rows equal
  an unpartitioned table's.
"""

import numpy as np
import pytest

from tidb_tpu.errors import TiDBError as RefError
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch import carry
from tidb_tpu_torch.errors import TiDBError as PortError
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops.kernels import expr_vm, groupby_agg
from tidb_tpu_torch.testkit import TestKit as PortKit
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


class Side:
    def __init__(self, kit, error):
        self.kit_cls, self.error = kit, error

    def kit(self):
        tk = self.kit_cls()
        tk.must_exec("use test")
        return tk

    def err(self, tk, sql):
        with pytest.raises(self.error) as ei:
            tk.must_exec(sql)
        return ei.value.code, str(ei.value)


SIDES = {"ref": Side(RefKit, RefError), "port": Side(PortKit, PortError)}


def _both(body):
    """body(side) in each package; the records must be equal."""
    got = {name: body(side) for name, side in SIDES.items()}
    assert got["port"] == got["ref"], got
    return got["port"]


def _q(tk, sql):
    return [tuple(r) for r in tk.must_query(sql).rows]


def _explain(tk, sql):
    return "\n".join(" ".join(str(c) for c in r)
                     for r in tk.must_query("EXPLAIN " + sql).rows)


RANGE_S = """create table s (id int, amount int)
    partition by range (amount) (
      partition p0 values less than (100),
      partition p1 values less than (200),
      partition pmax values less than maxvalue)"""


class TestRangePartition:
    def test_route_and_scan(self):
        def body(x):
            tk = x.kit()
            tk.must_exec(RANGE_S)
            tk.must_exec("insert into s values (1,50),(2,150),(3,250),(4,90)")
            return [_q(tk, "select id from s order by id"),
                    _q(tk, "select id from s partition (p0) order by id"),
                    _q(tk, "select id from s partition (p1, pmax) "
                           "order by id")]
        assert _both(body) == [[("1",), ("2",), ("3",), ("4",)],
                               [("1",), ("4",)], [("2",), ("3",)]]

    def test_no_partition_for_value(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table s (a int) partition by range (a) "
                         "(partition p0 values less than (10))")
            return x.err(tk, "insert into s values (10)")
        assert "no partition" in _both(body)[1]

    def test_pruning_eq_and_range(self):
        def body(x):
            tk = x.kit()
            tk.must_exec(RANGE_S)
            tk.must_exec("insert into s values (1,50),(2,150),(3,250)")
            return ([_explain(tk, f"select * from s where {c}") for c in (
                "amount = 150", "amount < 100", "amount >= 200")],
                _q(tk, "select count(*) from s where amount = 150"),
                _q(tk, "select count(*) from s where amount < 100"))
        (eq, lt, ge), n_eq, n_lt = _both(body)
        assert "partition:p1" in eq
        assert "partition:p0" in lt and "p1" not in lt
        assert "partition:pmax" in ge and "p0" not in ge
        assert n_eq == n_lt == [("1",)]

    def test_update_moves_row_between_partitions(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table s (id int, amount int) "
                         "partition by range (amount) ("
                         "partition p0 values less than (100), "
                         "partition p1 values less than (200))")
            tk.must_exec("insert into s values (1, 50)")
            tk.must_exec("update s set amount = 150 where id = 1")
            return (_q(tk, "select count(*) from s partition (p0)"),
                    _q(tk, "select id from s partition (p1)"))
        assert _both(body) == ([("0",)], [("1",)])

    def test_null_routes_to_first(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table s (a int) partition by range (a) "
                         "(partition p0 values less than (10), "
                         "partition p1 values less than (20))")
            tk.must_exec("insert into s values (null)")
            return _q(tk, "select count(*) from s partition (p0)")
        assert _both(body) == [("1",)]

    def test_year_func_partitioning(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table o (d date, v int) "
                         "partition by range (year(d)) ("
                         "partition y94 values less than (1995), "
                         "partition y95 values less than (1996), "
                         "partition ymax values less than maxvalue)")
            tk.must_exec("insert into o values ('1994-03-01',1),"
                         "('1995-07-01',2),('1999-01-01',3)")
            return (_q(tk, "select count(*) from o partition (y95)"),
                    _q(tk, "select v from o where d = '1995-07-01'"),
                    _explain(tk, "select v from o where d = '1995-07-01'"))
        n, v, plan = _both(body)
        assert n == [("1",)] and v == [("2",)] and "partition:y95" in plan

    def test_range_not_increasing_rejected(self):
        def body(x):
            return x.err(x.kit(), "create table s (a int) partition by "
                                  "range (a) (partition p0 values less than"
                                  " (20), partition p1 values less than "
                                  "(10))")
        assert "strictly increasing" in _both(body)[1]


class TestHashPartition:
    def test_route_and_point_read(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table h (id int primary key, v int) "
                         "partition by hash (id) partitions 4")
            tk.must_exec("insert into h values (1,10),(2,20),(3,30),"
                         "(4,40),(5,50)")
            return (_q(tk, "select v from h where id = 3"),
                    _q(tk, "select count(*) from h"))
        assert _both(body) == ([("30",)], [("5",)])

    def test_rows_spread_across_partitions(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table h (id int primary key) "
                         "partition by hash (id) partitions 2")
            tk.must_exec("insert into h values (1),(2),(3),(4)")
            return [_q(tk, f"select count(*) from h partition ({p})")
                    for p in ("p0", "p1")]
        assert _both(body) == [[("2",)], [("2",)]]


class TestListPartition:
    def test_route_and_null(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table l (r int, v int) "
                         "partition by list (r) ("
                         "partition pa values in (1, 2), "
                         "partition pb values in (3, null))")
            tk.must_exec("insert into l values (1,1),(3,3),(null,9)")
            return (_q(tk, "select count(*) from l partition (pb)"),
                    x.err(tk, "insert into l values (7,7)"))
        n, e = _both(body)
        assert n == [("2",)] and "no partition" in e[1]

    def test_pruning_eq(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table l (r int) partition by list (r) ("
                         "partition pa values in (1), "
                         "partition pb values in (2))")
            return _explain(tk, "select * from l where r = 2")
        assert "partition:pb" in _both(body)


class TestPartitionDDL:
    def test_add_partition(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table s (a int) partition by range (a) "
                         "(partition p0 values less than (10))")
            tk.must_exec("alter table s add partition "
                         "(partition p1 values less than (20))")
            tk.must_exec("insert into s values (15)")
            n = _q(tk, "select count(*) from s partition (p1)")
            tk.must_exec("alter table s add partition "
                         "(partition pm values less than maxvalue)")
            return n, x.err(tk, "alter table s add partition "
                                "(partition px values less than (99))")
        n, e = _both(body)
        assert n == [("1",)] and "strictly increasing" in e[1]

    def test_drop_partition(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table s (a int) partition by range (a) "
                         "(partition p0 values less than (10), "
                         "partition p1 values less than (20))")
            tk.must_exec("insert into s values (5), (15)")
            tk.must_exec("alter table s drop partition p0")
            return (_q(tk, "select a from s"),
                    x.err(tk, "alter table s drop partition p1"))
        rows, e = _both(body)
        assert rows == [("15",)] and "Cannot remove all partitions" in e[1]

    def test_truncate_partition(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table s (a int) partition by range (a) "
                         "(partition p0 values less than (10), "
                         "partition p1 values less than (20))")
            tk.must_exec("insert into s values (5), (15)")
            tk.must_exec("alter table s truncate partition p0")
            return _q(tk, "select a from s")
        assert _both(body) == [("15",)]

    def test_unique_key_must_cover_partition_col(self):
        def body(x):
            tk = x.kit()
            return (x.err(tk, "create table bad (a int primary key, b int) "
                              "partition by range (b) "
                              "(partition p0 values less than (10))"),
                    x.err(tk, "create table bad2 (a int, b int, "
                              "unique key(a)) partition by hash (b) "
                              "partitions 2"))
        pk, uk = _both(body)
        assert "PRIMARY KEY" in pk[1] and "UNIQUE INDEX" in uk[1]

    def test_show_create_table_includes_partitions(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table s (a int) partition by range (a) "
                         "(partition p0 values less than (10))")
            ddl = tk.must_query("show create table s").rows[0][1]
            return ddl.decode() if isinstance(ddl, bytes) else ddl
        ddl = _both(body)
        assert "PARTITION BY RANGE" in ddl and "`p0`" in ddl

    def test_truncate_table_reallocates_partition_ids(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table s (a int) partition by hash (a) "
                         "partitions 2")
            tk.must_exec("insert into s values (1),(2),(3)")
            tk.must_exec("truncate table s")
            n0 = _q(tk, "select count(*) from s")
            tk.must_exec("insert into s values (9)")
            return n0, _q(tk, "select count(*) from s")
        assert _both(body) == ([("0",)], [("1",)])

    def test_partition_mgmt_on_nonpartitioned(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table plain (a int)")
            return (x.err(tk, "alter table plain drop partition p0"),
                    x.err(tk, "select * from plain partition (p0)"))
        drop, sel = _both(body)
        assert "not partitioned" in drop[1] and "PARTITION" in sel[1]


class TestPartitionIndexes:
    def test_add_index_backfills_all_partitions(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table t (id int, v int) "
                         "partition by range (id) ("
                         "partition p0 values less than (10), "
                         "partition p1 values less than (20))")
            tk.must_exec("insert into t values (1, 100), (15, 200)")
            tk.must_exec("alter table t add index iv (id)")
            return (_q(tk, "select v from t where id = 1"),
                    _q(tk, "select v from t where id = 15"))
        assert _both(body) == ([("100",)], [("200",)])

    def test_unique_index_must_cover_partition_col(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table t (id int, v int) "
                         "partition by range (id) ("
                         "partition p0 values less than (10), "
                         "partition p1 values less than (20))")
            e = x.err(tk, "alter table t add unique index uv (v)")
            tk.must_exec("alter table t add unique index uid (id)")
            return e
        assert "partitioning function" in _both(body)[1]

    def test_drop_index_cleans_partition_ranges(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table t (id int, v int) "
                         "partition by hash (id) partitions 2")
            tk.must_exec("insert into t values (1,10),(2,20)")
            tk.must_exec("alter table t add index iv (v)")
            tk.must_exec("alter table t drop index iv")
            tk.must_exec("alter table t add index iv (v)")
            return _q(tk, "select id from t where v = 20")
        assert _both(body) == [("2",)]

    def test_stats_delta_rolls_up_to_logical_table(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table t (id int) partition by hash (id) "
                         "partitions 2")
            tk.must_exec("insert into t values (1),(2),(3)")
            logical = tk.session.infoschema().table_by_name("test", "t")
            counts = tk.session.domain.stats_worker.modify_counts
            return (counts.get(logical.id, 0) >= 3,
                    [d.id in counts for d in logical.partition.defs])
        assert _both(body) == (True, [False, False])


class TestPartitionTxn:
    def test_uncommitted_writes_visible_and_rollback(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table h (id int primary key) "
                         "partition by hash (id) partitions 2")
            tk.must_exec("insert into h values (1),(2)")
            tk.must_exec("begin")
            tk.must_exec("insert into h values (3)")
            inside = _q(tk, "select count(*) from h")
            tk.must_exec("rollback")
            return inside, _q(tk, "select count(*) from h")
        assert _both(body) == ([("3",)], [("2",)])

    def test_isolation_across_sessions(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table h (id int primary key) "
                         "partition by hash (id) partitions 2")
            tk2 = tk.new_session()
            tk2.must_exec("use test")
            tk.must_exec("begin")
            tk.must_exec("insert into h values (1)")
            before = _q(tk2, "select count(*) from h")
            tk.must_exec("commit")
            return before, _q(tk2, "select count(*) from h")
        assert _both(body) == ([("0",)], [("1",)])


class TestPartitionBackup:
    def test_physical_backup_restore_roundtrip(self, tmp_path):
        import importlib

        def body(x):
            br = importlib.import_module(
                x.kit_cls.__module__.split(".")[0] + ".br")
            d = str(tmp_path / x.kit_cls.__module__.split(".")[0])
            tk = x.kit()
            tk.must_exec("""create table s (a int) partition by hash (a)
                partitions 2""")
            tk.must_exec("insert into s values (1),(2),(3),(4)")
            meta = br.backup_database(tk.session, "test", d)
            t = next(t for t in meta["tables"] if t["name"] == "s")
            tk.must_exec("create database r2")
            br.restore_database(tk.session, d, "r2")
            out = [t["rows"], _q(tk, "select count(*) from r2.s"),
                   _q(tk, "select a from r2.s order by a")]
            # both tables remain independently writable (fresh physical ids)
            tk.must_exec("insert into r2.s values (5)")
            return out + [_q(tk, "select count(*) from test.s")]
        assert _both(body) == [4, [("4",)], [("1",), ("2",), ("3",), ("4",)],
                               [("4",)]]


class TestPartitionAggDevicePath:
    def test_group_by_over_partitions(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table s (id int, grp int, amount int) "
                         "partition by range (amount) ("
                         "partition p0 values less than (100), "
                         "partition p1 values less than (200), "
                         "partition pmax values less than maxvalue)")
            tk.must_exec("insert into s values " + ",".join(
                f"({i}, {i % 3}, {i})" for i in range(300)))
            return _q(tk, "select grp, count(*), sum(amount) from s "
                          "group by grp order by grp")
        assert _both(body) == [(str(g), "100", str(sum(range(g, 300, 3))))
                               for g in range(3)]


class TestColumnsPartitioning:
    def test_range_columns_string(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table rcs (name varchar(20), v bigint) "
                         "partition by range columns(name) ("
                         "partition pa values less than ('h'), "
                         "partition pm values less than ('q'), "
                         "partition pz values less than (maxvalue))")
            tk.must_exec("insert into rcs values ('alice', 1), "
                         "('mike', 2), ('zara', 3)")
            return (_q(tk, "select name from rcs partition (pa)"),
                    _q(tk, "select name from rcs partition (pz)"),
                    _explain(tk, "select * from rcs where name < 'b'"))
        pa, pz, plan = _both(body)
        assert pa == [("alice",)] and pz == [("zara",)]
        assert "partition:pa" in plan

    def test_range_columns_date(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table rcd (d date, v bigint) "
                         "partition by range columns(d) ("
                         "partition p1 values less than ('2020-01-01'), "
                         "partition p2 values less than (maxvalue))")
            tk.must_exec("insert into rcd values ('2019-06-01', 1), "
                         "('2021-06-01', 2)")
            return (_q(tk, "select v from rcd partition (p1)"),
                    _q(tk, "select v from rcd partition (p2)"))
        assert _both(body) == ([("1",)], [("2",)])

    def test_list_columns_string(self):
        def body(x):
            tk = x.kit()
            tk.must_exec("create table lcs (region varchar(10), v bigint) "
                         "partition by list columns(region) ("
                         "partition pe values in ('east', 'ne'), "
                         "partition pw values in ('west'))")
            tk.must_exec("insert into lcs values ('east', 1), ('ne', 2), "
                         "('west', 3)")
            return (_q(tk, "select sum(v) from lcs partition (pe)"),
                    x.err(tk, "insert into lcs values ('south', 9)"))
        total, e = _both(body)
        assert total == [("3",)] and "partition" in e[1].lower()


# -- the device engine over partitions ----------------------------------------

def _orders(tk, n=3000, seed=5):
    """A RANGE-by-YEAR table and its unpartitioned twin, the same seeded
    rows (NULL amounts and a NULL date included)."""
    tk.must_exec("create table op (d date, g varchar(2), v decimal(10,2), "
                 "f double) partition by range (year(d)) (" + ", ".join(
                     f"partition p{y} values less than ({y + 1})"
                     for y in range(1992, 1998))
                 + ", partition pmax values less than maxvalue)")
    tk.must_exec("create table ou (d date, g varchar(2), v decimal(10,2), "
                 "f double)")
    rng = np.random.default_rng(seed)
    days = rng.integers(np.datetime64("1992-01-01").astype(int),
                        np.datetime64("1999-01-01").astype(int), n)
    rows = ",".join(
        f"({'null' if i == 7 else repr(str(np.datetime64(int(d), 'D')))}, "
        f"'{'abc'[i % 3]}{i % 2}', "
        f"{'null' if i % 11 == 0 else f'{rng.integers(0, 99999) / 100:.2f}'}"
        f", {float(rng.uniform(-1e3, 1e3))!r})"
        for i, d in enumerate(days))
    for t in ("op", "ou"):
        tk.must_exec(f"insert into {t} values {rows}")


DEVICE_SQL = {
    "pruned": "select g, sum(v), count(*), max(d) from {t} "
              "where d = '1995-06-15' group by g order by g",
    "all": "select g, sum(v), avg(v), count(*), min(d) from {t} "
           "group by g order by g",
    "range": "select g, sum(v), count(v), sum(f) from {t} "
             "where d >= '1994-01-01' and d < '1995-01-01' "
             "group by g order by g",
}


@pytest.fixture(scope="module")
def device_kits():
    kits = {}
    for name, side in SIDES.items():
        tk = side.kit()
        _orders(tk)
        tk.must_exec("set tidb_executor_engine = 'tpu'")
        kits[name] = tk
    return kits


@pytest.mark.parametrize("case", sorted(DEVICE_SQL))
def test_device_engine_over_partitions(device_kits, case, monkeypatch):
    calls = {"K2": 0, "K1": 0}
    run_vm, run_agg = expr_vm.run, groupby_agg.groupby_agg

    def vm_spy(*a, **kw):
        calls["K2"] += 1
        return run_vm(*a, **kw)

    def agg_spy(*a, **kw):
        calls["K1"] += 1
        return run_agg(*a, **kw)
    monkeypatch.setattr(expr_vm, "run", vm_spy)
    monkeypatch.setattr(groupby_agg, "groupby_agg", agg_spy)
    sql = DEVICE_SQL[case]
    ref, port = device_kits["ref"], device_kits["port"]
    got = _q(port, sql.format(t="op"))
    assert calls["K2"] > 0 and calls["K1"] > 0, calls
    want = _q(ref, sql.format(t="op"))
    unpart = _q(port, sql.format(t="ou"))
    from test_device_ops import _rows_equal
    assert _rows_equal(got, want) and _rows_equal(got, unpart), (got, want)
    plan = "\n".join(" ".join(map(str, r)) for r in port.must_query(
        "explain analyze " + sql.format(t="op")).rows)
    assert "engine:tpu" in plan
    scan = {"pruned": "partition:p1995", "all": "partition:all",
            "range": "partition:p1994"}[case]
    assert scan in plan, plan


def test_bulk_install_routes_like_insert():
    """carry.install_bulk_numpy into a partitioned table puts each row in
    the partition an INSERT of its values picks (RANGE on YEAR of a date,
    HASH on an integer)."""
    rng = np.random.default_rng(9)
    n = 500
    days = rng.integers(np.datetime64("1992-01-01").astype(int),
                        np.datetime64("1999-06-01").astype(int), n)
    keys = rng.integers(-1000, 1000, n)
    ddl = {"yr": "partition by range (year(d)) (" + ", ".join(
        f"partition p{y} values less than ({y + 1})"
        for y in range(1992, 1999)) + ", partition pmax values less than "
        "maxvalue)", "hs": "partition by hash (k) partitions 3"}
    port = SIDES["port"].kit()
    ref = SIDES["ref"].kit()
    for name, part in ddl.items():
        for tk in (port, ref):
            tk.must_exec(f"create table {name} (k bigint, d date) {part}")
        ref.must_exec(f"insert into {name} values " + ",".join(
            f"({int(k)}, '{np.datetime64(int(d), 'D')}')"
            for k, d in zip(keys, days)))
        views = carry.install_bulk_numpy(
            port.domain, "test", name, {"k": keys, "d": days}, n)
        info = port.domain.infoschema().table_by_name("test", name)
        assert len(views) == len(info.partition.defs)
        for d in info.partition.defs:
            sql = (f"select k, d from {name} partition ({d.name}) "
                   "order by k, d")
            assert _q(port, sql) == _q(ref, sql), d.name


def test_year_range_pruning_and_datetime_bound_divergence():
    """The stated divergence: a date range on RANGE (YEAR(d)) prunes in
    the port (bounds on YEAR's value), not in the reference; a DATE_ADD
    bound (a DATETIME) prunes nothing in the port and raises
    OverflowError in the reference.  Rows equal the unpartitioned
    table's in both packages wherever the reference answers."""
    kits = {name: side.kit() for name, side in SIDES.items()}
    for tk in kits.values():
        _orders(tk, n=400, seed=13)
    sql = ("select count(*), sum(v) from {t} "
           "where d >= '1994-01-01' and d < '1995-01-01'")
    for tk in kits.values():
        assert _q(tk, sql.format(t="op")) == _q(tk, sql.format(t="ou"))
    assert "partition:p1994" in _explain(kits["port"], sql.format(t="op"))
    assert "partition:all" in _explain(kits["ref"], sql.format(t="op"))
    bound = sql.replace("'1995-01-01'",
                        "date_add('1994-01-01', interval 1 year)")
    port = kits["port"]
    assert _q(port, bound.format(t="op")) == _q(port, sql.format(t="ou"))
    with pytest.raises(OverflowError):
        kits["ref"].must_query(bound.format(t="op"))
