"""The port's first slice as a whole: the same tables in the reference's
``TestKit`` and the port's, the same SQL on the device engine of each,
equal rows, and ``engine:tpu`` on the port's HashAgg in EXPLAIN ANALYZE
(a row compare alone would pass if the port fell back to its host
engine).

Rows compare by tests/test_device_ops.py's rule: ints, decimals, dates
and strings exact; doubles within rtol 1e-9 / atol 1e-12, because group
sums of doubles are added in another order on each side.
"""

import pytest

import bench
from test_device_ops import QUERIES as DEVICE_OPS_QUERIES
from test_device_ops import _rows_equal
from test_device_ops import _setup as _device_ops_setup
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch import carry
from tidb_tpu_torch.executor import device_exec as texec
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import failpoint as tfailpoint
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

Q01 = """
    select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
        sum(l_extendedprice) as sum_base_price,
        sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
        sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
        avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
        avg(l_discount) as avg_disc, count(*) as count_order
    from lineitem where l_shipdate <= date_sub('1998-12-01', interval 90 day)
    group by l_returnflag, l_linestatus
    order by l_returnflag, l_linestatus"""
Q06 = """
    select sum(l_extendedprice * l_discount) as revenue from lineitem
    where l_shipdate >= '1994-01-01'
      and l_shipdate < date_add('1994-01-01', interval 1 year)
      and l_discount between 0.02 and 0.08 and l_quantity < 24"""
TOPN = ("select l_orderkey, sum(l_extendedprice*(1-l_discount)) as rev "
        "from lineitem group by l_orderkey order by rev desc, l_orderkey "
        "limit 10")

#: string expressions through dictionary codes (LUTs, remaps, IN-lists,
#: LIKE, string-valued CASE) — the K2 paths the numeric queries miss; the
#: `s` / `n` queries are tests/test_device_strings.py's
STRING_QUERIES = [
    "select l_returnflag, count(*) from lineitem where l_returnflag in "
    "('A', 'R') group by l_returnflag order by 1",
    "select l_linestatus, sum(l_quantity) from lineitem where "
    "l_returnflag like 'N%' group by l_linestatus order by 1",
    "select case when l_returnflag = 'A' then 'acc' else 'other' end, "
    "count(*), max(l_discount) from lineitem group by 1 order by 1",
    "select g, count(*), min(h) from t where g >= 'bb' group by g order by g",
    "select length(g), count(*) from t group by length(g) order by 1",
    "select lower(g), sum(v) from t group by lower(g) order by 1",
    "select h, count(*) from t where g <> 'cc' and dt < '1994-09-10' "
    "group by h order by h",
    "select year(l_shipdate), month(l_shipdate), count(*) from lineitem "
    "where l_discount > 0.05 group by 1, 2 order by 1, 2 limit 8",
    "select sum(case when nation = 'BRAZIL' then amt else 0 end), sum(amt) "
    "from s",
    "select case when v < 10 then 'low' when v < 30 then 'mid' else 'high' "
    "end as bucket, count(*), sum(v) from s group by bucket order by bucket",
    "select case when v < 25 then nation else 'OTHER' end k, count(*) "
    "from s group by k order by k",
    "select coalesce(nation, 'UNKNOWN') k, count(*) from s group by k "
    "order by k",
    "select substring(phone, 1, 2) cc, count(*), sum(amt) from s where "
    "substring(phone, 1, 2) in ('11', '13', '17') group by cc order by cc",
    "select lower(nation) k, count(*) from s group by k order by k",
    "select sum(length(phone)), count(*) from s where length(phone) > 6",
    "select concat(nation, '-x') k, count(*) from s group by k order by k",
    "select count(*) from s where substring(phone, 4, 8) like '1%'",
    "select count(*), sum(v) from s where nation = other",
    "select count(*) from s where nation < other",
    "select min(nation), max(concat(nation, '!')) from s where v > 5",
    "select year(ts) y, month(ts) m, count(*), sum(v) from s group by y, m "
    "order by y, m",
    "select nation, year(ts) o_year, sum(amt) from s group by nation, "
    "o_year order by nation, o_year desc",
    "select upper(coalesce(s, 'x')) k, count(*), sum(v) from n group by k "
    "order by k",
    "select sum(v) from n where upper(coalesce(s, 'x')) = 'X'",
    "select sum(length(coalesce(s, ''))) from n",
]

#: aggregate shapes that take K1's other paths: no pack (a group key
#: without known bounds → hash table, NULL groups last), COUNT DISTINCT
#: (the pair set) over ints and string codes, float min/max
AGG_PATH_QUERIES = [
    "select v * 2 + 1, count(*), sum(d) from t group by v * 2 + 1 "
    "order by 1",
    "select g, count(distinct h), count(distinct v) from t group by g "
    "order by g",
    "select h, count(distinct g) from t group by h order by h",
    "select min(f), max(f), avg(f) from t where f > 0",
]

#: expression shapes the queries above leave out: casts (decimal scale
#: down, float to int and decimal), decimal and float division (division
#: by zero is NULL), NULL tests, OR / NOT / numeric IN, COALESCE, IF and
#: CASE over floats, month / day parts, BETWEEN on floats and dates
EXPR_SHAPE_QUERIES = [
    "select h, sum(cast(d as signed)), sum(cast(d as decimal(10,1))) "
    "from t group by h order by h",
    "select h, sum(d / 3), sum(v / 7) from t group by h order by h",
    "select h, sum(f / v), max(abs(f)), min(-v) from t group by h order by h",
    "select g, count(*) from t where v is null or f > 1 group by g order by g",
    "select g, count(*) from t where not (v in (1, 2, 3, 50)) group by g "
    "order by g",
    "select g, sum(coalesce(v, h, 0)), sum(if(f > 0, f, 0)) from t "
    "group by g order by g",
    "select g, sum(cast(f as signed)), sum(cast(f * 100 as decimal(12,2))) "
    "from t group by g order by g",
    "select month(dt), dayofmonth(dt), count(*) from t group by 1, 2 "
    "order by 1, 2",
    "select g, count(*) from t where f between -0.5 and 0.5 group by g "
    "order by g",
    "select g, sum(v * 1.5), sum(d * d) from t group by g order by g",
    "select g, sum(abs(d)), max(-d), sum(case when v > 0 then 1.5 "
    "when v < -50 then -2 end) from t group by g order by g",
    "select h, count(*) from t where dt between '1994-08-20' and "
    "'1994-09-05' and g is not null group by h order by h",
    "select year(ts), count(*), sum(amt / 4) from s where v < 20 group by 1 "
    "order by 1",
    "select g, sum(cast(v as double) / 3), sum(cast(h as decimal(6,2)) "
    "* 1.25) from t group by g order by g",
]

SLICE_QUERIES = ([("device_ops", q) for q in DEVICE_OPS_QUERIES]
                 + [("q1", bench.QUERIES["q1"]), ("q01", Q01),
                    ("q06", Q06), ("topn", TOPN)]
                 + [("strings", q) for q in STRING_QUERIES]
                 + [("agg_paths", q) for q in AGG_PATH_QUERIES]
                 + [("expr_shapes", q) for q in EXPR_SHAPE_QUERIES])


def setup_tables(tk, data, n):
    """The device-ops table `t`, the string tables `s` and `n` of
    tests/test_device_strings.py, and `lineitem` from `data`."""
    _device_ops_setup(tk)
    tk.must_exec("create table s (id int primary key, nation varchar(20), "
                 "phone varchar(15), other varchar(20), v int, amt "
                 "decimal(10,2), ts datetime)")
    nations = ["BRAZIL", "CANADA", "FRANCE", "PERU", "JAPAN"]
    rows = [f"({i}, '{nations[i % 5]}', '{11 + i % 25}-{1000 + i}', "
            f"'{nations[(i * 3) % 5]}', {i % 50}, {i}.25, "
            f"'199{i % 9}-0{i % 9 + 1}-15 0{i % 9}:30:00')"
            for i in range(600)]
    rows.append("(9000, null, '99-1', null, 1, 1.00, '1995-01-01 00:00:00')")
    tk.must_exec("insert into s values " + ",".join(rows))
    tk.must_exec("create table n (id int primary key, s varchar(20), v int)")
    tk.must_exec("insert into n values (1,'brazil',1), (2,null,2), "
                 "(3,'peru',3), (4,null,4), (5,'brazil',5)")
    tk.must_exec(carry.LINEITEM_DDL)
    carry.install_bulk_numpy(tk.domain, "test", "lineitem", data, n)


@pytest.fixture(scope="module")
def kits():
    tdev.set_device("cpu")
    data, n = carry.gen_lineitem(0.002, seed=42)
    out = []
    for K in (RefKit, PortKit):
        tk = K()
        setup_tables(tk, data, n)
        tk.must_exec("set @@tidb_executor_engine = 'tpu'")
        out.append(tk)
    return out


@pytest.fixture(autouse=True)
def _no_port_failpoint_leaks():
    """The port keeps its own failpoint registry (tests/conftest.py
    watches only the reference's)."""
    yield
    leaked = tfailpoint.list_active()
    if leaked:
        tfailpoint.disable_all()
        pytest.fail(f"test leaked active port failpoints: {leaked}")


def _engine_line(tk, sql):
    rows = tk.must_query("explain analyze " + sql).rows
    return " ".join(str(c) for r in rows if "HashAgg" in str(r[0])
                    for c in r)


@pytest.mark.parametrize("name,sql", SLICE_QUERIES,
                         ids=[f"{n}{i}" for i, (n, _q) in
                              enumerate(SLICE_QUERIES)])
def test_slice_rows_match_reference(kits, name, sql):
    ref, port = kits
    want = ref.must_query(sql).rows
    got = port.must_query(sql).rows
    assert _rows_equal(got, want), f"port != reference:\n{got}\n{want}"
    assert "engine:tpu" in _engine_line(port, sql)


def test_topn_selects_groups_on_device(kits, monkeypatch):
    """The top-N's ORDER BY ... LIMIT over 3000 groups runs through the
    port's top-k selector (K4) and fetches only the top groups.  A result
    this small is normally fetched whole in one copy; with the small-fetch
    bound at 0 the fetch takes the path SF1 takes."""
    ref, port = kits
    monkeypatch.setattr(texec, "_SMALL_FETCH_BYTES", 0)
    texec._TOPK_CACHE.clear()
    got = port.must_query(TOPN).rows
    assert texec._TOPK_CACHE
    assert got == ref.must_query(TOPN).rows


def test_capacity_retry_keeps_all_groups(kits):
    """More groups than the first capacity estimate (64 per key without
    statistics): the retry at the reported n_groups returns every group."""
    ref, port = kits
    sql = ("select l_orderkey, count(*) from lineitem group by l_orderkey "
           "order by l_orderkey")
    got = port.must_query(sql).rows
    assert len(got) > 64
    assert got == ref.must_query(sql).rows


def test_port_host_engine_agrees(kits):
    """The port's own host engine (the copied numpy executor) gives the
    device engine's rows."""
    _ref, port = kits
    dev = port.must_query(Q01).rows
    port.must_exec("set @@tidb_executor_engine = 'host'")
    try:
        host = port.must_query(Q01).rows
    finally:
        port.must_exec("set @@tidb_executor_engine = 'tpu'")
    assert _rows_equal(dev, host)


def test_port_declines_where_reference_declines(kits):
    """COUNT of a string-valued expression does not compile for the
    device in the reference (DeviceUnsupported → host engine); the port
    declines it the same way and gives the same rows."""
    ref, port = kits
    sql = "select count(*), count(upper(s)) from n"
    assert port.must_query(sql).rows == ref.must_query(sql).rows
    for tk in kits:
        assert "engine:host" in _engine_line(tk, sql)


def test_device_failure_degrades_to_host(kits):
    """A device runtime failure at the fragment boundary (the port's own
    `device-agg-exec` failpoint) is classified by the copied breaker
    layer: the query degrades to the host engine with the same rows."""
    ref, port = kits
    sql = DEVICE_OPS_QUERIES[1]
    want = ref.must_query(sql).rows
    with tfailpoint.enabled("device-agg-exec", "panic"):
        got = port.must_query(sql).rows
    assert _rows_equal(got, want)
