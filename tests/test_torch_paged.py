"""The port's out-of-core path against the JAX reference on the CPU:
paged (disk-backed, memmap) tables, the streamed scan-aggregate over
them, and the paged probe join — tests/test_paged_storage.py's cases and
TPC-H Q3/Q5/Q9/Q18 with ``lineitem`` and ``orders`` paged.

Each package writes the same seeded tables with its own
``PagedTableWriter`` under the test's temporary directory.  Rows compare
by tests/test_device_ops.py's ``_rows_equal`` (doubles within rtol 1e-9
/ atol 1e-12, everything else exact), and every query asserts that the
port's device path ran: ``LAST_PAGED_STATS`` records the streamed
aggregate (``kind`` "stream") or the paged join (``kind`` "paged") with
at least two pages — a row compare alone would pass if the port fell
back to its host engine.
"""

import os

import numpy as np
import pytest

import bench
from test_device_ops import _rows_equal
from test_torch_slice import Q06, TOPN
from tidb_tpu.storage.paged import PagedTableWriter as RefWriter
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch import carry
from tidb_tpu_torch.executor import device_join as pdj
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.storage.paged import PagedTableWriter as PortWriter
from tidb_tpu_torch.storage.paged import chunk_is_paged, open_paged_columns
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils.chunk import Chunk, LazyDictColumn
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

N = 9_000
PAGE = 2_000


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _write(tk, writer_cls, db, table, root, pages, dicts=()):
    """Write `pages` (a list of {column: array} dicts) as table
    `db.table` with `writer_cls` and install it."""
    info = tk.domain.infoschema().table_by_name(db, table)
    w = writer_cls(str(root), info)
    for name, values in dicts:
        w.set_dictionary(name, values)
    for page in pages:
        w.append(page)
    columns, handles = w.finalize()
    tk.domain.columnar_cache.install_bulk(info, columns, handles)


def _query(kits, sql, rows, kind):
    """`sql` on both device engines at `rows` rows per page: equal rows,
    and the port's streamed / paged path ran with at least 2 pages."""
    ref, port = kits
    for tk in kits:
        tk.must_exec("set tidb_executor_engine = 'tpu'")
        tk.must_exec(f"set tidb_device_stream_rows = {rows}")
    try:
        want = ref.must_query(sql).rows
        got = port.must_query(sql).rows
        stats = dict(pdj.LAST_PAGED_STATS.items())
    finally:
        for tk in kits:
            tk.must_exec("set tidb_device_stream_rows = 0")
    assert _rows_equal(got, want), f"port != reference:\n{got}\n{want}"
    assert stats.get("kind") == kind and stats["pages"] >= 2, stats
    return got


@pytest.fixture(scope="module")
def pg_kits(tmp_path_factory):
    """tests/test_paged_storage.py's `pg` table, paged in both packages."""
    rng = np.random.default_rng(3)
    k = np.arange(1, N + 1, dtype=np.int64)
    grp = rng.integers(0, 7, N)
    amount = rng.integers(-50, 500, N)
    price = rng.integers(0, 100000, N)  # cents
    tag_codes = rng.integers(0, 3, N).astype(np.int32)
    pages = [{"k": k[lo:lo + PAGE], "grp": grp[lo:lo + PAGE],
              "amount": amount[lo:lo + PAGE], "price": price[lo:lo + PAGE],
              "tag": tag_codes[lo:lo + PAGE]} for lo in range(0, N, PAGE)]
    kits = (RefKit(), PortKit())
    for tk, writer, tag in ((kits[0], RefWriter, "ref"),
                            (kits[1], PortWriter, "port")):
        tk.must_exec("use test")
        tk.must_exec("create table pg (k bigint, grp bigint, amount bigint, "
                     "price decimal(10,2), tag varchar(8))")
        root = tmp_path_factory.mktemp(tag) / "pg"
        _write(tk, writer, "test", "pg", root, pages,
               [("tag", [b"alpha", b"beta", b"gamma"])])
        tk._paged_root = str(root)
    return kits


AGG = ("select grp, tag, count(*), sum(amount), min(amount), max(price), "
       "avg(price) from pg where amount > 0 group by grp, tag "
       "order by grp, tag")


@pytest.mark.parametrize("sql", [
    AGG,
    "select count(*), sum(price), min(k), max(k) from pg",
    "select tag, count(distinct grp) from pg group by tag order by tag",
], ids=["grouped", "global", "count_distinct"])
def test_streamed_scan_agg_on_paged_table(pg_kits, sql):
    _query(pg_kits, sql, PAGE, "stream")


def test_streaming_keeps_the_writer_codes(pg_kits):
    """The device scan reads the dictionary CODES the writer stored,
    straight from the memmap, and never builds the object view."""
    port = pg_kits[1]
    info = port.domain.infoschema().table_by_name("test", "pg")
    cols = open_paged_columns(port._paged_root, info)
    port.domain.columnar_cache.install_bulk(
        info, cols, np.arange(1, N + 1, dtype=np.int64))
    assert chunk_is_paged(Chunk(list(cols.values())))
    _query(pg_kits, AGG, PAGE, "stream")
    lazy = [c for c in cols.values() if isinstance(c, LazyDictColumn)]
    assert lazy and all(c._mat is None for c in lazy)
    codes, uniques = lazy[0].dict_encode()
    assert isinstance(codes, np.memmap)
    assert list(uniques) == [b"alpha", b"beta", b"gamma"]


@pytest.fixture(scope="module")
def join_kits(tmp_path_factory):
    """tests/test_paged_storage.py's paged fact table and its resident
    dimension tables, in both packages."""
    rng = np.random.default_rng(11)
    nf, nd = 12_000, 40
    fk = np.arange(1, nf + 1, dtype=np.int64)
    dk = rng.integers(1, nd + 1, nf)
    v = rng.integers(0, 1000, nf)
    pages = [{"fk": fk[lo:lo + 2_500], "dk": dk[lo:lo + 2_500],
              "v": v[lo:lo + 2_500]} for lo in range(0, nf, 2_500)]
    kits = (RefKit(), PortKit())
    for tk, writer, tag in ((kits[0], RefWriter, "ref"),
                            (kits[1], PortWriter, "port")):
        tk.must_exec("use test")
        tk.must_exec("create table fact (fk bigint, dk bigint, v bigint)")
        tk.must_exec("create table dim (dk bigint, dname varchar(8), "
                     "region bigint)")
        tk.must_exec("create table dim2 (region bigint, rname varchar(8))")
        _write(tk, writer, "test", "fact",
               tmp_path_factory.mktemp(tag) / "fact", pages)
        tk.must_exec("insert into dim values " + ",".join(
            f"({d}, 'd{d % 7}', {d % 5})" for d in range(1, nd + 1)))
        tk.must_exec("insert into dim2 values " + ",".join(
            f"({r}, 'r{r}')" for r in range(5)))
        for t in ("dim", "dim2"):
            tk.must_exec(f"analyze table {t}")
    return kits


JOINQ = ("select dname, count(*), sum(v) from fact, dim "
         "where fact.dk = dim.dk and v > 100 group by dname order by dname")

JOIN2Q = ("select rname, count(*), sum(v), min(v) from fact, dim, dim2 "
          "where fact.dk = dim.dk and dim.region = dim2.region "
          "group by rname order by rname")


@pytest.mark.parametrize("sql,rows", [
    (JOINQ, 2_500), (JOIN2Q, 2_500), (JOINQ, 1_700),
    ("select fk, sum(v) from fact, dim where fact.dk = dim.dk "
     "group by fk order by sum(v) desc, fk limit 7", 2_500),
], ids=["single_join", "chain_join", "odd_tail_page", "topn_groups"])
def test_paged_probe_join(join_kits, sql, rows):
    got = _query(join_kits, sql, rows, "paged")
    assert len(got) > 0


@pytest.fixture(scope="module")
def tpch_kits(tmp_path_factory):
    """carry.gen_tpch(0.05): lineitem and orders paged in both packages
    (the port through carry.install_tpch's paged option, the reference
    through its own writer), the other six tables bulk, ANALYZEd."""
    tables = carry.gen_tpch(0.05)
    ref, port = RefKit(), PortKit()
    carry.install_tpch(port.must_exec, port.domain, "tpch", tables,
                       analyze=False,
                       paged_root=str(tmp_path_factory.mktemp("port")))
    ref.must_exec("create database tpch")
    ref.must_exec("use tpch")
    for ddl in carry.TPCH_DDL:
        ref.must_exec(ddl)
    root = tmp_path_factory.mktemp("ref")
    for name in carry.TPCH_TABLES:
        if name not in tables:
            continue
        data, n = tables[name]
        if name not in carry.PAGED_TABLES:
            bench._install(ref, name, data, n)
            continue
        dicts, pages = [], []
        for col, arr in data.items():
            if isinstance(arr, tuple):
                dicts.append((col, sorted(arr[1])))
        for lo in range(0, n, 50_000):
            page = {}
            for col, arr in data.items():
                if isinstance(arr, tuple):
                    codes, d = arr
                    order = np.argsort(np.asarray(d, dtype=object))
                    remap = np.empty(len(d), np.int32)
                    remap[order] = np.arange(len(d))
                    page[col] = remap[codes[lo:lo + 50_000]]
                else:
                    page[col] = arr[lo:lo + 50_000]
            pages.append(page)
        _write(ref, RefWriter, "tpch", name, root / name, pages, dicts)
    for i, (nm, rk) in enumerate(carry.NATIONS):
        ref.must_exec(f"insert into nation values ({i}, '{nm}', {rk})")
    for i, r in enumerate(carry.REGIONS):
        ref.must_exec(f"insert into region values ({i}, '{r}')")
    for tk in (ref, port):
        for t in carry.TPCH_TABLES:
            tk.must_exec(f"analyze table {t}")
    return ref, port


@pytest.mark.parametrize("name", ["q3", "q5", "q9", "q18"])
def test_tpch_paged_join_matches_reference(tpch_kits, name):
    got = _query(tpch_kits, bench.QUERIES[name], 65_536, "paged")
    assert len(got) > 0


@pytest.mark.parametrize("sql", [bench.QUERIES["q1"], Q06, TOPN],
                         ids=["q1", "q6", "topn"])
def test_tpch_streamed_agg_matches_reference(tpch_kits, sql):
    _query(tpch_kits, sql, 65_536, "stream")


@pytest.mark.parametrize("table", ["lineitem", "orders", "customer"])
def test_paged_install_equals_bulk_install(tmp_path, table):
    """carry.install_paged_numpy (pages of 1,000 rows) and
    install_bulk_numpy of the same arrays hold the same rows; string
    columns (customer's, whose segment dictionary is unsorted) go through
    their sorted dictionaries."""
    data, n = carry.gen_tpch(0.002)[table]
    kits = []
    for paged in (False, True):
        tk = PortKit()
        tk.must_exec("create database tpch")
        tk.must_exec("use tpch")
        for ddl in carry.TPCH_DDL:
            tk.must_exec(ddl)
        if paged:
            carry.install_paged_numpy(tk.domain, "tpch", table, data, n,
                                      str(tmp_path), page_rows=1_000)
        else:
            carry.install_bulk_numpy(tk.domain, "tpch", table, data, n)
        kits.append(tk)
    assert os.path.exists(tmp_path / "MANIFEST.json")
    sql = f"select * from {table}"
    bulk, paged = (tk.must_query(sql).rows for tk in kits)
    assert len(bulk) == n and paged == bulk


def _stat_columns(mod):
    """Seeded columns of every kind ANALYZE meets on these tables, built
    with `mod` (either package's utils.chunk): ints with NULLs, floats, a
    dictionary-encoded string column and a paged (lazy) one."""
    from tidb_tpu_torch.sqltypes import (TYPE_DOUBLE, TYPE_LONGLONG,
                                         TYPE_VARCHAR, FieldType)
    rng = np.random.default_rng(9)
    n = 5_000
    ints = rng.integers(-10**12, 10**12, n) // rng.integers(1, 10**9, n)
    nulls = rng.random(n) < 0.1
    words = np.array(sorted({f"w{i:03d}é".encode() for i in
                             rng.integers(0, 300, 400)}), dtype=object)
    codes = rng.integers(0, len(words), n).astype(np.int32)
    dcol = mod.Column(FieldType(tp=TYPE_VARCHAR), words[codes],
                      rng.random(n) < 0.05)
    dcol.set_dict(codes, words)
    return [mod.Column(FieldType(tp=TYPE_LONGLONG), ints, nulls),
            mod.Column(FieldType(tp=TYPE_DOUBLE), rng.standard_normal(n),
                       np.zeros(n, bool)),
            dcol,
            mod.LazyDictColumn(FieldType(tp=TYPE_VARCHAR), codes, words)]


@pytest.mark.parametrize("kind", range(4),
                         ids=["int_nulls", "double", "dict", "lazy_dict"])
def test_analyze_column_stats_match_reference(kind):
    """The port's ANALYZE (integer and bytes count-min sketches hashed in
    one pass, dictionary columns counted by code) builds exactly the
    reference's statistics."""
    from tidb_tpu.statistics import analyze as ran
    from tidb_tpu.utils import chunk as rchunk
    from tidb_tpu_torch.statistics import analyze as pan
    from tidb_tpu_torch.utils import chunk as pchunk
    want = ran._column_stats(_stat_columns(rchunk)[kind])
    port_col = _stat_columns(pchunk)[kind]
    got = pan._column_stats(port_col)
    assert got == want and got["ndv"] > 100 and "cmsketch" in got
    if kind == 3:
        assert port_col._mat is None  # counted by code, not materialized
