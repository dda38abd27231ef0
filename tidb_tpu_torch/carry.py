"""State carried across from the reference package, as numpy arrays.

The JAX package and the port keep their tables in their own columnar
caches.  This module installs the same host arrays into the port, so a
test (or ``chip_smoke.py``) can load identical tables into both packages
and compare their answers:

* :func:`install_bulk_numpy` — the port's counterpart of the reference
  benchmark's bulk loader (``bench.py _install``): numpy arrays, or
  ``(codes, dictionary)`` pairs for dictionary-encoded strings, installed
  through ``columnar_cache.install_bulk`` (a partitioned table partition
  by partition);
* :func:`install_paged_numpy` — the same arrays as a paged (disk-backed,
  memmap) table, as ``bench.py gen_all`` writes its big tables from SF5;
* :func:`to_torch` — the numpy argument tree of ``_agg_kernel`` /
  ``_topk_indices`` as tensors on a device;
* :func:`gen_lineitem` — the TPC-H-shaped ``lineitem`` generator of the
  reference benchmark (``bench.py gen_all``), seeded;
* :func:`gen_tpch` / :func:`install_tpch` — all eight TPC-H-shaped tables
  of that generator, drawn as it draws them, with their DDL, the
  ``nation`` / ``region`` rows and ANALYZE;
* :func:`fleet_seed` — the data a fleet's workers carry: those tables in
  every worker, their KV half and a ledger written once through the
  shared log.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .storage.paged import DEFAULT_PAGE_ROWS, PagedTableWriter
from .utils.chunk import Column

#: the reference benchmark's lineitem schema (bench.py gen_all)
LINEITEM_DDL = """
create table lineitem (
    l_orderkey bigint, l_partkey bigint, l_suppkey bigint,
    l_quantity decimal(15,2),
    l_extendedprice decimal(15,2), l_discount decimal(15,2),
    l_tax decimal(15,2), l_returnflag varchar(1),
    l_linestatus varchar(1), l_shipdate date)"""

_EPOCH = np.datetime64("1970-01-01")


def _days(date_str: str) -> int:
    return int((np.datetime64(date_str) - _EPOCH).astype(int))


def gen_lineitem(sf: float, seed: int = 42) -> tuple:
    """(data, n): lineitem at scale factor `sf`, drawn in the order and
    with the ranges of the reference benchmark's generator (seed 42 gives
    its table).  SF1 is 6,001,215 rows."""
    rng = np.random.default_rng(seed)
    n_line = int(6_001_215 * sf)
    n_orders = max(int(1_500_000 * sf), 2)
    n_supp = max(int(10_000 * sf), 4)
    n_part = max(int(200_000 * sf), 4)
    supp_stride = max(n_supp // 4, 1)
    orderkey = rng.integers(1, n_orders + 1, n_line)
    partkey = rng.integers(1, n_part + 1, n_line)
    # one of each part's 4 partsupp suppliers
    supp_slot = rng.integers(0, 4, n_line)
    suppkey = (partkey - 1 + supp_slot * supp_stride) % n_supp + 1
    qty = rng.integers(1, 51, n_line) * 100              # 1.00-50.00
    price = rng.integers(900_00, 105_000_00, n_line)     # ~dbgen prices
    disc = rng.integers(0, 11, n_line)                   # 0.00-0.10
    tax = rng.integers(0, 9, n_line)                     # 0.00-0.08
    shipdate = rng.integers(_days("1992-01-01"), _days("1998-12-01"),
                            n_line).astype(np.int32)
    flag_codes = rng.integers(0, 3, n_line).astype(np.int32)
    status_codes = rng.integers(0, 2, n_line).astype(np.int32)
    return {
        "l_orderkey": orderkey, "l_partkey": partkey, "l_suppkey": suppkey,
        "l_quantity": qty, "l_extendedprice": price, "l_discount": disc,
        "l_tax": tax, "l_shipdate": shipdate,
        "l_returnflag": (flag_codes, [b"A", b"N", b"R"]),
        "l_linestatus": (status_codes, [b"F", b"O"]),
    }, n_line


def _dict_col(codes, dictionary, ft):
    """Dict-encoded string Column (set_dict requires sorted uniques)."""
    n = len(codes)
    arr = np.asarray(dictionary, dtype=object)
    order = np.argsort(arr)
    remap = np.empty(len(arr), dtype=np.int64)
    remap[order] = np.arange(len(arr))
    c = Column(ft, arr[codes], np.zeros(n, dtype=bool))
    c.set_dict(remap[codes].astype(np.int32), arr[order])
    return c


def install_bulk_numpy(domain, db: str, table: str, data: dict, n: int):
    """Install `data` (column name → numpy array, or (codes, dictionary)
    for a dict-encoded string column) as table `db.table`'s rows through
    the bulk loader; handles are 1..n.  A partitioned table's rows go to
    their partitions (:func:`partition_rows`), each installed on its
    physical view (``partition.partition_view``); the return value is
    then the list of the partitions' views."""
    info = domain.infoschema().table_by_name(db, table)
    handles = np.arange(1, n + 1, dtype=np.int64)
    if info.partition is None:
        return domain.columnar_cache.install_bulk(
            info, _bulk_columns(info, data, n), handles)
    from .partition import partition_view
    part = partition_rows(info, data, n)
    views = []
    for i, d in enumerate(info.partition.defs):
        rows = np.flatnonzero(part == i)
        sub = {name: ((arr[0][rows], arr[1]) if isinstance(arr, tuple)
                      else np.asarray(arr)[rows])
               for name, arr in data.items()}
        views.append(domain.columnar_cache.install_bulk(
            partition_view(info, d), _bulk_columns(info, sub, len(rows)),
            handles[rows]))
    return views


def _bulk_columns(info, data: dict, n: int) -> dict:
    cols = {c.name: c for c in info.public_columns()}
    z = np.zeros(n, dtype=bool)
    columns = {}
    for name, arr in data.items():
        c = cols[name]
        if isinstance(arr, tuple):
            codes, dictionary = arr
            columns[c.id] = _dict_col(codes, dictionary, c.ftype)
        else:
            columns[c.id] = Column(c.ftype, np.asarray(arr), z)
    return columns


def partition_rows(info, data: dict, n: int) -> np.ndarray:
    """Each row's partition, as an index into ``info.partition.defs``: the
    partition function (a bare column, or YEAR / MONTH / TO_DAYS of a
    date) over the rows' internal values, routed as
    ``partition.locate_partition`` routes one row.  The partition column
    must be a plain array without NULLs."""
    from .partition import _TO_DAYS_EPOCH, locate_partition
    from .sqltypes import TYPE_DATETIME, TYPE_TIMESTAMP
    p = info.partition
    col = info.find_column(p.col_name)
    v = np.asarray(data[col.name]).astype(np.int64)
    if p.func and col.ftype.tp in (TYPE_DATETIME, TYPE_TIMESTAMP):
        v = v // 86_400_000_000  # micros → days
    if p.func == "year":
        v = v.astype("datetime64[D]").astype("datetime64[Y]").astype(
            np.int64) + 1970
    elif p.func == "month":
        v = v.astype("datetime64[D]").astype("datetime64[M]").astype(
            np.int64) % 12 + 1
    elif p.func == "to_days":
        v = v + _TO_DAYS_EPOCH
    if p.type == "hash":
        return np.abs(v) % p.num
    uniq, inv = np.unique(v, return_inverse=True)
    index = {d.id: i for i, d in enumerate(p.defs)}
    return np.asarray([index[locate_partition(p, int(u)).id] for u in uniq],
                      dtype=np.int64)[inv]


def install_paged_numpy(domain, db: str, table: str, data: dict, n: int,
                        root: str, page_rows: int = DEFAULT_PAGE_ROWS):
    """Install `data` (as for :func:`install_bulk_numpy`) as a PAGED
    table: the arrays go page by page through ``PagedTableWriter`` into
    column files under `root`, string columns as codes into their sorted
    dictionaries (``set_dictionary``, as ``bench.py gen_all`` writes its
    paged tables), and the memmap-backed columns are installed through
    the bulk loader.  The rows are exactly those of a bulk install of
    the same arrays."""
    info = domain.infoschema().table_by_name(db, table)
    w = PagedTableWriter(root, info)
    remaps = {}
    for name, arr in data.items():
        if isinstance(arr, tuple):
            codes, dictionary = arr
            d = np.asarray(dictionary, dtype=object)
            order = np.argsort(d)
            remap = np.empty(len(d), dtype=np.int32)
            remap[order] = np.arange(len(d), dtype=np.int32)
            w.set_dictionary(name, d[order])
            remaps[name] = remap
    for lo in range(0, n, page_rows):
        hi = min(lo + page_rows, n)
        w.append({name: (remaps[name][arr[0][lo:hi]]
                         if isinstance(arr, tuple) else arr[lo:hi])
                  for name, arr in data.items()})
    columns, handles = w.finalize()
    return domain.columnar_cache.install_bulk(info, columns, handles)


def to_torch(tree, device):
    """numpy arrays in a nested tuple → tensors on `device`; every other
    leaf (ints, op names, specs) is kept as is."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    if isinstance(tree, tuple):
        return tuple(to_torch(x, device) for x in tree)
    return tree


#: the reference benchmark's eight-table schema (bench.py gen_all), in its
#: creation order
TPCH_DDL = (
    LINEITEM_DDL,
    """create table orders (
        o_orderkey bigint primary key, o_custkey bigint,
        o_orderdate date,
        o_shippriority bigint, o_totalprice decimal(15,2))""",
    """create table customer (
        c_custkey bigint primary key, c_name varchar(25),
        c_mktsegment varchar(10), c_nationkey bigint)""",
    """create table supplier (
        s_suppkey bigint primary key, s_nationkey bigint)""",
    """create table part (
        p_partkey bigint primary key, p_name varchar(55))""",
    """create table partsupp (
        ps_partkey bigint, ps_suppkey bigint,
        ps_supplycost decimal(15,2))""",
    """create table nation (
        n_nationkey bigint primary key, n_name varchar(25),
        n_regionkey bigint)""",
    """create table region (
        r_regionkey bigint primary key, r_name varchar(25))""",
)

TPCH_TABLES = ("lineitem", "orders", "customer", "supplier", "part",
               "partsupp", "nation", "region")

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
SEGMENTS = [b"AUTOMOBILE", b"BUILDING", b"FURNITURE", b"MACHINERY",
            b"HOUSEHOLD"]
_COLORS = [b"almond", b"green", b"blue", b"red", b"ivory", b"khaki",
           b"lemon", b"linen", b"navy", b"olive", b"orchid", b"peach",
           b"plum", b"puff", b"rose", b"salmon", b"sienna", b"snow"]


def gen_tpch(sf: float, seed: int = 42, dim_seed: int = 7) -> dict:
    """{table: (data, n)} for the six bulk-loaded tables at scale factor
    `sf`, drawn in the order and with the ranges of the reference
    benchmark's generator (``bench.py gen_all``, whose streams are seeds
    42 for ``lineitem`` and 7 for the rest): ``lineitem`` from `seed`,
    ``orders``, ``customer``, ``supplier``, ``part`` and ``partsupp``
    from `dim_seed`.  ``nation`` and ``region`` are fixed rows
    (:func:`install_tpch` inserts them)."""
    n_orders = max(int(1_500_000 * sf), 2)
    n_cust = max(int(150_000 * sf), 2)
    n_supp = max(int(10_000 * sf), 4)
    n_part = max(int(200_000 * sf), 4)
    supp_stride = max(n_supp // 4, 1)
    out = {"lineitem": gen_lineitem(sf, seed)}
    rng2 = np.random.default_rng(dim_seed)
    out["orders"] = ({
        "o_orderkey": np.arange(1, n_orders + 1),
        "o_custkey": rng2.integers(1, n_cust + 1, n_orders),
        "o_orderdate": rng2.integers(_days("1992-01-01"),
                                     _days("1998-08-02"),
                                     n_orders).astype(np.int32),
        "o_shippriority": np.zeros(n_orders, dtype=np.int64),
        "o_totalprice": rng2.integers(1000_00, 400_000_00, n_orders),
    }, n_orders)
    cname = [f"Customer#{i:09d}".encode() for i in range(1, n_cust + 1)]
    out["customer"] = ({
        "c_custkey": np.arange(1, n_cust + 1),
        "c_name": (np.arange(n_cust, dtype=np.int32), cname),
        "c_mktsegment": (rng2.integers(0, 5, n_cust).astype(np.int32),
                         SEGMENTS),
        "c_nationkey": rng2.integers(0, 25, n_cust),
    }, n_cust)
    out["supplier"] = ({
        "s_suppkey": np.arange(1, n_supp + 1),
        "s_nationkey": rng2.integers(0, 25, n_supp),
    }, n_supp)
    pcodes = rng2.integers(0, len(_COLORS), n_part).astype(np.int32)
    out["part"] = ({
        "p_partkey": np.arange(1, n_part + 1),
        "p_name": (pcodes, [c + b" anodized thing" for c in _COLORS]),
    }, n_part)
    n_ps = n_part * 4
    ps_part = np.repeat(np.arange(1, n_part + 1), 4)
    ps_slot = np.tile(np.arange(4), n_part)
    out["partsupp"] = ({
        "ps_partkey": ps_part,
        "ps_suppkey": (ps_part - 1 + ps_slot * supp_stride) % n_supp + 1,
        "ps_supplycost": rng2.integers(1_00, 1000_00, n_ps),
    }, n_ps)
    return out


#: the tables ``bench.py gen_all`` writes paged from SF5 on
PAGED_TABLES = ("lineitem", "orders")


def install_tpch(execute, domain, db: str, tables: dict,
                 analyze: bool = True, paged_root: str | None = None):
    """Create database `db` with the eight-table schema, install `tables`
    (:func:`gen_tpch`'s output) through the bulk loader, insert the
    ``nation`` and ``region`` rows and, with `analyze`, ANALYZE all eight
    tables, as ``bench.py gen_all`` does (without statistics, Q5's greedy
    join order builds a >2x-lineitem intermediate).  `execute` runs one
    SQL statement (``session.execute`` or ``TestKit.must_exec``).

    With `paged_root`, ``lineitem`` and ``orders`` go in as paged tables
    (:func:`install_paged_numpy`, files under ``paged_root/<table>``),
    the other six as bulk tables.

    Where the schema is there already (a fleet worker over a shared
    durable store, which replays the schema, the ``nation`` / ``region``
    rows and the statistics from the log), only the process-local bulk
    installs run and the statistics are loaded, as ``gen_all`` does."""
    execute(f"create database if not exists {db}")
    execute(f"use {db}")
    fresh = not domain.infoschema().has_table(db, "lineitem")
    if fresh:
        for ddl in TPCH_DDL:
            execute(ddl)
    for name in TPCH_TABLES:
        if name in tables:
            data, n = tables[name]
            if paged_root is not None and name in PAGED_TABLES:
                install_paged_numpy(domain, db, name, data, n,
                                    os.path.join(paged_root, name))
            else:
                install_bulk_numpy(domain, db, name, data, n)
    if not fresh:
        domain.load_stats()
        return
    for i, (nm, rk) in enumerate(NATIONS):
        execute(f"insert into nation values ({i}, '{nm}', {rk})")
    for i, r in enumerate(REGIONS):
        execute(f"insert into region values ({i}, '{r}')")
    if analyze:
        for t in TPCH_TABLES:
            execute(f"analyze table {t}")


#: the fleet hook's scale factor and lineitem seed (a worker's
#: environment; Fleet(..., env_extra={FLEET_SF_ENV: "1"}))
FLEET_SF_ENV = "TIDB_TPU_TORCH_FLEET_SF"
FLEET_SEED_ENV = "TIDB_TPU_TORCH_FLEET_SEED"
#: the fleet hook's KV-backed ledger: accounts, branches, seed balance
LEDGER_ACCTS = 1024
LEDGER_BRANCHES = 8
LEDGER_SEED_BAL = 1000


def fleet_seed(domain, seeded: bool = False):
    """Fleet init hook (``Fleet(init="tidb_tpu_torch.carry:fleet_seed")``,
    the counterpart of ``bench_serve.py _fabric_seed``): the TPC-H tables
    of :func:`gen_tpch` at ``$TIDB_TPU_TORCH_FLEET_SF`` (default 0.002),
    lineitem from ``$TIDB_TPU_TORCH_FLEET_SEED`` (default 42) and the
    rest from seed 7, in database ``tpch``, and the ledger
    ``test.ledger (acct, branch, bal)``.

    The bulk-installed columnar caches are process-local, so every
    worker installs the tables, and every worker holds the same columns:
    the fleet's dedup keys hash a fragment's data.  The KV half (the
    schema, ``nation`` / ``region``, the statistics and the ledger) is
    written once, by the worker that is not `seeded`; the others replay
    it from the shared log."""
    from .session import new_session
    sf = float(os.environ.get(FLEET_SF_ENV) or "0.002")
    seed = int(os.environ.get(FLEET_SEED_ENV) or "42")
    s = new_session(domain)
    install_tpch(s.execute, domain, "tpch", gen_tpch(sf, seed, 7))
    if seeded:
        return
    s.execute("use test")
    s.execute("create table ledger (acct int primary key, branch int, "
              "bal bigint)")
    for lo in range(0, LEDGER_ACCTS, 256):
        s.execute("insert into ledger values " + ",".join(
            f"({a}, {a % LEDGER_BRANCHES}, {LEDGER_SEED_BAL})"
            for a in range(lo + 1, min(lo + 256, LEDGER_ACCTS) + 1)))
