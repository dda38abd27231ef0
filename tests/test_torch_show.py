"""The port's SHOW statements, information_schema and performance
tables, ADMIN CHECK and DIAG (``session/show.py``, ``session/memtables.py``,
``executor/admin.py``, ``session/diag.py``) against the reference's, on
the CPU: the same schema made by the same statements in each package,
and each statement's rows (or error) set beside the other's.  Columns
that hold a clock time or a process's own numbers (connection ids,
elapsed seconds, process ids) are left out of the comparison and checked
for shape instead.
"""

import json

import pytest

from tidb_tpu import tablecodec as rcodec
from tidb_tpu.errors import TiDBError as RefError
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch import tablecodec as pcodec
from tidb_tpu_torch.errors import TiDBError as PortError
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.session import diag as pdiag
from tidb_tpu_torch.testkit import TestKit as PortKit

SCHEMA = (
    "create database shop",
    "use shop",
    "create table item (id int primary key, name varchar(20) not null, "
    "price decimal(10,2) default 0.00, stock bigint, added date, "
    "key i_name (name), unique key u_stock (stock))",
    "create table sale (id bigint, item int, d date, qty int) "
    "partition by range (year(d)) ("
    "partition p2023 values less than (2024), "
    "partition pmax values less than maxvalue)",
    "create view cheap as select id, name from item where price < 10",
    "insert into item values (1, 'pen', 1.50, 10, '2024-01-02'), "
    "(2, 'ink', 12.00, 20, null), (3, 'pad', 3.25, null, '2023-05-06')",
    "insert into sale values (1, 1, '2023-03-03', 2), "
    "(2, 3, '2024-04-04', 1)",
)


@pytest.fixture(scope="module")
def kits():
    tdev.set_device("cpu")
    out = {"ref": RefKit(), "port": PortKit()}
    for tk in out.values():
        for sql in SCHEMA:
            tk.must_exec(sql)
    return out


def _rows(tk, sql):
    return [tuple(c.decode() if isinstance(c, bytes) else c for c in r)
            for r in tk.must_query(sql).rows]


def _both(kits, sql):
    got = {side: _rows(tk, sql) for side, tk in kits.items()}
    assert got["port"] == got["ref"], (sql, got)
    return got["port"]


@pytest.mark.parametrize("sql", [
    "show create table item",
    "show create table sale",
    "show create view cheap",
    "show tables",
    "show full tables",
    "show databases",
    "show columns from item",
    "show full columns from item",
    "show index from item",
    "show table status like 'item'",
    "show engines",
    "show charset",
    "show collation",
    "show variables like 'tidb_executor_engine'",
    "show global variables like 'tidb_device%'",
    "show variables like 'max_execution_time'",
    "show status like 'Threads%'",
    "show warnings",
])
def test_show_equals_reference(kits, sql):
    rows = _both(kits, sql)
    if sql == "show create table item":
        assert "ENGINE=tpu-htap" in rows[0][1]
    if sql == "show create table sale":
        assert "PARTITION BY RANGE (YEAR(`d`))" in rows[0][1]
    if sql == "show engines":
        assert rows[0][0] == "tpu-htap"


def test_show_variables_all_equal_reference(kits):
    """Every session variable and its value, as both packages print them:
    the port keeps the reference's names and values (the engine values
    ``tpu`` / ``tpu-mpp`` included)."""
    got = {side: dict(_rows(tk, "show variables"))
           for side, tk in kits.items()}
    assert sorted(got["port"]) == sorted(got["ref"])
    differ = {k for k in got["ref"] if got["port"][k] != got["ref"][k]}
    assert differ <= CLOCK_VARIABLES, differ
    assert len(got["port"]) > 100
    assert got["port"]["tidb_executor_engine"] == \
        got["ref"]["tidb_executor_engine"]


#: variables whose values are the store's timestamps or the process's
CLOCK_VARIABLES = {"tidb_last_txn_info", "tidb_current_ts", "timestamp",
                   "tidb_config", "hostname", "pid_file", "tidb_snapshot"}


@pytest.mark.parametrize("sql", [
    "select table_schema, table_name, table_type, engine, table_rows "
    "from information_schema.tables where table_schema = 'shop' "
    "order by table_name",
    "select table_name, column_name, ordinal_position, is_nullable, "
    "data_type, column_type, column_key "
    "from information_schema.columns where table_schema = 'shop' "
    "order by table_name, ordinal_position",
    "select table_name, index_name, non_unique, column_name "
    "from information_schema.statistics where table_schema = 'shop' "
    "order by table_name, index_name, seq_in_index",
    "select schema_name from information_schema.schemata order by 1",
    "select table_name, partition_name, partition_method, "
    "partition_expression, partition_description "
    "from information_schema.partitions where table_schema = 'shop' "
    "and table_name = 'sale' order by partition_ordinal_position",
    "select table_name, view_definition from information_schema.views "
    "where table_schema = 'shop'",
    "select * from information_schema.engines",
    "select character_set_name from information_schema.character_sets "
    "order by 1",
    "select count(*) from information_schema.collations",
])
def test_information_schema_equals_reference(kits, sql):
    assert _both(kits, sql)


def test_processlist(kits):
    """One row per session of the domain: the port's row for this session
    says what the reference's says, but for its id and time."""
    got = {}
    for side, tk in kits.items():
        rows = _rows(tk, "select id, user, host, db, command, time, state, "
                         "info from information_schema.processlist")
        mine = [r for r in rows if r[7] and "processlist" in r[7]]
        assert len(mine) == 1, rows
        assert int(mine[0][0]) == tk.session.conn_id
        assert int(mine[0][5]) >= 0
        got[side] = (mine[0][1:5], mine[0][6:])
        show = _rows(tk, "show processlist")
        assert any(int(r[0]) == tk.session.conn_id for r in show)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("sql", [
    "admin check table item",
    "admin check table sale",
    "admin check index item i_name",
    "admin check index item u_stock",
])
def test_admin_check_passes_in_both(kits, sql):
    for tk in kits.values():
        tk.must_exec(sql)


def test_admin_check_errors_equal_reference(kits):
    codes = {}
    for side, tk in kits.items():
        err = {"ref": RefError, "port": PortError}[side]
        out = []
        for sql in ("admin check table nosuch", "admin check index item nope"):
            with pytest.raises(err) as ei:
                tk.must_exec(sql)
            out.append((ei.value.code, str(ei.value)))
        codes[side] = out
    assert codes["port"] == codes["ref"]


def test_admin_check_finds_a_missing_index_entry():
    """An index entry deleted behind the table's back: ADMIN CHECK INDEX
    and TABLE fail in both packages with the same error."""
    out = {}
    for side, kit, codec in (("ref", RefKit, rcodec),
                             ("port", PortKit, pcodec)):
        tk = kit()
        tk.must_exec("create table t (a int primary key, b int, key ib (b))")
        tk.must_exec("insert into t values (1, 10), (2, 20)")
        info = tk.session.infoschema().table_by_name("test", "t")
        idx = next(i for i in info.indexes if i.name == "ib")
        txn = tk.session.domain.store.begin()
        prefix = codec.index_prefix(info.id, idx.id)
        keys = [k for k, _v in txn.scan(prefix, prefix + b"\xff")]
        txn.delete(keys[0])
        txn.commit()
        err = {"ref": RefError, "port": PortError}[side]
        got = []
        for sql in ("admin check index t ib", "admin check table t"):
            with pytest.raises(err) as ei:
                tk.must_exec(sql)
            got.append((ei.value.code, str(ei.value)))
        out[side] = got
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("kind", ["status", "processlist", "slow",
                                  "statements", "traces", "metrics",
                                  "perf"])
def test_diag_with_no_peers(kits, kind):
    """DIAG answers locally (no fleet peer registered): one JSON cell,
    the same keys in both packages; cluster_* memtables answer from the
    local process under instance 'local'."""
    got = {}
    for side, tk in kits.items():
        rows = _rows(tk, f"diag {kind}")
        assert len(rows) == 1 and len(rows[0]) == 1
        body = json.loads(rows[0][0])
        got[side] = (sorted(body) if isinstance(body, dict)
                     else type(body).__name__)
    assert got["port"] == got["ref"]
    assert pdiag.log.name == "tidb_tpu_torch.session.diag"


def test_cluster_memtable_answers_locally(kits):
    got = {}
    for side, tk in kits.items():
        rows = _rows(tk, "select instance, count(*) from "
                         "information_schema.cluster_processlist "
                         "group by instance")
        got[side] = [r[0] for r in rows]
    assert got["port"] == got["ref"] == ["local"]
