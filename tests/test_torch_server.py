"""The port's MySQL wire server, status server and process entry
(``tidb_tpu_torch/server/``) against the reference's
(``tidb_tpu/server/``), on the CPU.

Every case of tests/test_server.py, tests/test_server_entry.py and
tests/test_protocol_breadth.py runs here against a server of each
package: the same client (the reference tests' own hand-rolled
protocol-41 clients) sends the same bytes to both, and what each server
answers is set beside the other's.  Beyond those:

* TPC-H Q1 over ``carry.gen_tpch`` / ``bench.gen_all`` at SF 0.002
  through both servers on the device engine: decoded rows equal (DOUBLE
  within rtol 1e-9 / atol 1e-12, every other cell exact); in the port,
  ``engine:tpu`` in EXPLAIN ANALYZE sent over the wire, and K2's and
  K1's wrappers called (``expr_vm.run``, ``groupby_agg.groupby_agg``: on
  the CPU they run the plain versions, which leave ``LAUNCHES``, a count
  of card launches, where it was);
* ``python -m tidb_tpu_torch.server --device cpu --config-check`` and
  ``-V`` in a process of their own;
* ``run_server`` with ``--device cuda`` and no card: exit 1 with
  ``DeviceNotAvailable``'s message, before anything listens.

Every fixture shuts its servers down and joins their threads.
"""

import json
import struct
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import bench
import test_protocol_breadth as breadth
from test_server import MiniClient
from tidb_tpu import config as rconfig
from tidb_tpu.errors import TiDBError as RefError
from tidb_tpu.kv import new_store as ref_new_store
from tidb_tpu.server import main as rmain
from tidb_tpu.server.http_status import StatusServer as RefStatus
from tidb_tpu.server.server import MySQLServer as RefServer
from tidb_tpu.session import bootstrap_domain as ref_bootstrap
from tidb_tpu.session import new_session as ref_new_session
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch import carry
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch.errors import TiDBError as PortError
from tidb_tpu_torch.kv import new_store as port_new_store
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops.kernels import expr_vm, groupby_agg
from tidb_tpu_torch.server import main as pmain
from tidb_tpu_torch.server.http_status import StatusServer as PortStatus
from tidb_tpu_torch.server.server import MySQLServer as PortServer
from tidb_tpu_torch.session import bootstrap_domain as port_bootstrap
from tidb_tpu_torch.session import new_session as port_new_session
from tidb_tpu_torch.testkit import TestKit as PortKit

ROOT = __file__.rsplit("/tests/", 1)[0]

SIDES = {
    "ref": dict(server=RefServer, status=RefStatus, boot=ref_bootstrap,
                session=ref_new_session, store=ref_new_store, main=rmain,
                config=rconfig, error=RefError),
    "port": dict(server=PortServer, status=PortStatus, boot=port_bootstrap,
                 session=port_new_session, store=port_new_store, main=pmain,
                 config=pconfig, error=PortError),
}


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _stop(*servers):
    for srv in servers:
        srv.shutdown()
        if srv._thread is not None:
            srv._thread.join(10)
            assert not srv._thread.is_alive()


def _both(fn):
    """fn(side) for the reference and the port; the two answers must be
    equal.  Returns the port's."""
    got = {side: fn(side) for side in SIDES}
    assert got["port"] == got["ref"], got
    return got["port"]


@pytest.fixture(scope="module")
def servers():
    """A wire server of each package over a bootstrapped domain."""
    out = {side: s["server"](s["boot"](), port=0).start()
           for side, s in SIDES.items()}
    yield out
    _stop(*out.values())


def _session(fn, port, **kw):
    c = MiniClient(port, **kw)
    try:
        return fn(c)
    finally:
        c.close()


# -- tests/test_server.py ------------------------------------------------------

def test_handshake_and_query(servers):
    got = _both(lambda side: _session(
        lambda c: c.query("select 1 + 1 as s"), servers[side].port))
    assert got == ("rows", (["s"], [("2",)]))


def test_ddl_dml_roundtrip(servers):
    def run(c):
        return [c.query("create database if not exists srv"),
                c.query("use srv"),
                c.query("create table t (a bigint, b varchar(10))"),
                c.query("insert into t values (1,'x'),(2,null)"),
                c.query("select * from t order by a")]
    got = _both(lambda side: _session(run, servers[side].port))
    assert got[3] == ("ok", 2)
    assert got[4] == ("rows", (["a", "b"], [("1", "x"), ("2", None)]))


def test_error_packet(servers):
    got = _both(lambda side: _session(
        lambda c: [c.query("select * from srv.nosuch"),
                   c.query("selecz 1")], servers[side].port))
    assert [(k, v[0]) for k, v in got] == [("err", 1146), ("err", 1064)]


def test_connect_with_db_and_auth(servers):
    got = _both(lambda side: _session(
        lambda c: c.query("select count(*) from t"), servers[side].port,
        db="srv"))
    assert got == ("rows", (["count(*)"], [("2",)]))


def test_auth_rejected():
    def run(side):
        s = SIDES[side]
        srv = s["server"](s["boot"](), port=0,
                          users={"root": "secret"}).start()
        try:
            with pytest.raises(AssertionError, match="1045") as ei:
                MiniClient(srv.port, user="root", password="wrong")
            return str(ei.value), _session(lambda c: c.query("select 1"),
                                           srv.port, password="secret")
        finally:
            _stop(srv)
    got = _both(run)
    assert got[1][0] == "rows"


def test_prepared_statement(servers):
    got = _both(lambda side: _session(
        lambda c: c.prepare_execute(
            "select a from t where a = ? or b = ?", [2, "x"]),
        servers[side].port, db="srv"))
    assert sorted(got[1][1]) == [("1",), ("2",)]


def test_prepared_binary_nulls_and_strings(servers):
    def run(c):
        return [c.prepare_execute("select a, b from t where a = ?", [2]),
                c.prepare_execute("select b, a from t order by a", [])]
    got = _both(lambda side: _session(run, servers[side].port, db="srv"))
    assert got[0][1][1] == [("2", None)]
    assert got[1][1][1] == [("x", "1"), (None, "2")]


def test_multi_statement(servers):
    got = _both(lambda side: _session(lambda c: c.query("select 1"),
                                      servers[side].port, db="srv"))
    assert got[0] == "rows"


def test_two_connections_share_domain(servers):
    def run(side):
        c1 = MiniClient(servers[side].port, db="srv")
        c2 = MiniClient(servers[side].port, db="srv")
        try:
            c1.query("insert into t values (3, 'y')")
            out = c2.query("select count(*) from t")
            c1.query("delete from t where a = 3")
            return out
        finally:
            c1.close()
            c2.close()
    assert _both(run) == ("rows", (["count(*)"], [("3",)]))


class TestTLS:
    """The in-handshake TLS upgrade, each package's auto-TLS context."""

    @pytest.fixture(scope="class")
    def tls_servers(self, tmp_path_factory):
        out = {}
        for side, s in SIDES.items():
            ctx = s["main"].make_tls_context(
                auto_dir=str(tmp_path_factory.mktemp(f"tls_{side}")))
            if ctx is None:
                _stop(*out.values())
                pytest.skip("openssl unavailable for auto-TLS")
            out[side] = s["server"](s["boot"](), port=0, users={},
                                    ssl_ctx=ctx).start()
        yield out
        _stop(*out.values())

    def test_query_over_tls(self, tls_servers):
        from test_server import TestTLS as RefTLS

        def run(side):
            io, tls = RefTLS()._tls_client(tls_servers[side].port)
            assert tls.version() is not None
            c = MiniClient.__new__(MiniClient)
            c.io, c.sock = io, tls
            try:
                return c.query("select 1+1")
            finally:
                tls.close()
        assert _both(run)[1][1] == [("2",)]

    def test_plaintext_still_works_alongside(self, tls_servers):
        got = _both(lambda side: _session(lambda c: c.query("select 2+2"),
                                          tls_servers[side].port))
        assert got[1][1] == [("4",)]


# -- tests/test_server_entry.py ------------------------------------------------

def test_config_defaults():
    cfgs = {side: s["config"].Config() for side, s in SIDES.items()}
    assert repr(cfgs["port"]) == repr(cfgs["ref"])
    assert cfgs["port"].port == 4000 and cfgs["port"].status.status_port \
        == 10080


def test_config_toml_and_flag_override(tmp_path):
    p = tmp_path / "cfg.toml"
    p.write_text('host = "0.0.0.0"\nport = 4567\n[performance]\n'
                 'mem-quota-query = 123456\nexecutor-engine = "host"\n'
                 '[status]\nstatus-port = 9999\n')

    def run(side):
        m = SIDES[side]["main"]
        cfg = m.resolve_config(m.build_arg_parser().parse_args(
            ["--config", str(p), "--port", "5000"]))
        return repr(cfg)
    got = _both(run)
    assert "port=5000" in got and "mem_quota_query=123456" in got


def test_config_strict_rejects_unknown(tmp_path):
    p = tmp_path / "bad.toml"
    p.write_text("nonsense = 1\n")

    def run(side):
        cfgmod = SIDES[side]["config"]
        with pytest.raises(ValueError) as ei:
            cfgmod.load_config(str(p), strict=True)
        return str(ei.value), repr(cfgmod.load_config(str(p), strict=False))
    _both(run)


@pytest.fixture()
def running_servers():
    """Each package's wire and status servers on ephemeral ports."""
    out = {}
    for side, s in SIDES.items():
        domain = s["boot"](s["store"]())
        sql = s["server"](domain, port=0).start()
        out[side] = (domain, sql, s["status"](domain, sql, port=0).start())
    yield out
    for _domain, sql, status in out.values():
        status.shutdown()
        status._thread.join(10)
        _stop(sql)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.status, r.read().decode()


def test_status_api(running_servers):
    def run(side):
        domain, _sql, status = running_servers[side]
        out = {}
        code, body = _get(status.port, "/status")
        st = json.loads(body)
        assert code == 200 and st["version"].endswith("tpu-htap")
        out["status_keys"] = sorted(st)
        out["sub_keys"] = {k: sorted(v) for k, v in st.items()
                           if isinstance(v, dict) and k not in (
                               "device_breakers", "storage_wal")}
        s = SIDES[side]["session"](domain)
        s.execute("create table st (a int primary key)")
        s.execute("insert into st values (1)")
        s.execute("create index i_a on st (a)")
        out["schema"] = json.loads(_get(status.port, "/schema")[1])
        out["tables"] = json.loads(_get(status.port, "/schema/test")[1])
        out["st"] = json.loads(_get(status.port, "/schema/test/st")[1])[
            "name"]
        hist = json.loads(_get(status.port, "/ddl/history")[1])
        out["history"] = [(j["type"], j["state"]) for j in hist]
        metrics = _get(status.port, "/metrics")[1]
        out["metrics"] = sorted({ln.split()[2] for ln in metrics.splitlines()
                                 if ln.startswith("# TYPE")})
        out["regions"] = bool(json.loads(_get(status.port, "/regions")[1]))
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(status.port, "/nope")
        out["nope"] = ei.value.code
        return out
    got = _both(run)
    assert "st" in got["tables"] and got["st"] == "st"
    assert ("add_index", "synced") in got["history"]
    assert {"executor_statement_total", "server_connections",
            "hj_partitions", "compile_queue_depth"} <= set(got["metrics"])
    assert got["nope"] == 404 and got["regions"]
    assert {"device_hybrid_join", "device_compiler"} <= set(
        got["status_keys"])


def test_wire_and_status_together(running_servers):
    def run(side):
        _domain, sql, status = running_servers[side]

        def wire(c):
            c.query("create table wt (a int primary key)")
            c.query("insert into wt values (7)")
            return c.query("select a from wt")
        rows = _session(wire, sql.port)
        return rows, "wt" in json.loads(_get(status.port, "/schema/test")[1])
    assert _both(run) == (("rows", (["a"], [("7",)])), True)


def test_version_flag(capsys):
    outs = {}
    for side, s in SIDES.items():
        assert s["main"].main(["--version"]) == 0
        outs[side] = capsys.readouterr().out
    assert "tpu-htap" in outs["ref"] and "tpu-htap" in outs["port"]
    assert outs["port"] == outs["ref"].replace("tidb-tpu-server",
                                               "tidb-tpu-torch-server")


def test_config_check_mode(tmp_path, capsys):
    ok, bad = tmp_path / "ok.toml", tmp_path / "bad.toml"
    ok.write_text("port = 4001\n")
    bad.write_text("bogus = true\n")

    def run(side):
        m = SIDES[side]["main"]
        return (m.main(["--config", str(ok), "--config-check"]),
                m.main(["--config", str(bad), "--config-check"]))
    assert _both(run) == (0, 1)


# -- tests/test_protocol_breadth.py --------------------------------------------

@pytest.fixture(scope="module")
def breadth_servers():
    """test_protocol_breadth.py's server set-up, in each package."""
    out = {}
    for side, s in SIDES.items():
        dom = s["boot"]()
        srv = s["server"](dom, port=0).start()
        ses = s["session"](dom)
        ses.execute("create user 'sha2user'@'%' identified with "
                    "'caching_sha2_password' by 'secret2'")
        ses.execute("create user 'nativeuser'@'%' identified by 'secret1'")
        ses.execute("grant all on *.* to 'sha2user'@'%'")
        ses.execute("grant all on *.* to 'nativeuser'@'%'")
        ses.execute("create database pb")
        ses.execute("use pb")
        ses.execute("create table t (id int primary key, v varchar(2000))")
        ses.execute("insert into t values " + ",".join(
            f"({i}, 'row{i}')" for i in range(25)))
        out[side] = srv
    yield out
    _stop(*out.values())


def _login(port, user, password, plugin):
    c = breadth.Client(port, user, password, plugin=plugin)
    try:
        return c.fast_auth, bytes(c.query_ok("select 1")[:1])
    finally:
        c.close()


class TestCachingSha2:
    def test_direct_sha2_login_fast_path(self, breadth_servers):
        got = _both(lambda side: _login(breadth_servers[side].port,
                                        "sha2user", "secret2",
                                        "caching_sha2_password"))
        assert got[0]  # 0x01 0x03 marker seen by the port's server too

    def test_auth_switch_from_native_client(self, breadth_servers):
        _both(lambda side: _login(breadth_servers[side].port, "sha2user",
                                  "secret2", "mysql_native_password"))

    def test_auth_switch_to_native(self, breadth_servers):
        _both(lambda side: _login(breadth_servers[side].port, "nativeuser",
                                  "secret1", "caching_sha2_password"))

    def test_wrong_password_rejected(self, breadth_servers):
        def run(side):
            with pytest.raises(AssertionError, match="auth failed") as ei:
                breadth.Client(breadth_servers[side].port, "sha2user",
                               "wrong", plugin="caching_sha2_password")
            return str(ei.value)
        assert "auth failed" in _both(run)


class TestCursorFetch:
    def test_cursor_execute_then_fetch_pages(self, breadth_servers):
        def run(side):
            c = breadth.Client(breadth_servers[side].port, "sha2user",
                               "secret2", plugin="caching_sha2_password")
            c.query_ok("use pb")
            sid, ncols, nparams = c.prepare("select id from t order by id")
            c.io.reset_seq()
            c.io.write_packet(bytes([breadth.P.COM_STMT_EXECUTE])
                              + struct.pack("<I", sid)
                              + bytes([breadth.P.CURSOR_TYPE_READ_ONLY])
                              + struct.pack("<I", 1))
            c.io.read_packet()
            c.io.read_packet()
            status = struct.unpack_from("<H", c.io.read_packet(), 3)[0]
            got, last, pages = [], False, 0
            while not last:
                c.io.reset_seq()
                c.io.write_packet(bytes([breadth.P.COM_STMT_FETCH])
                                  + struct.pack("<II", sid, 10))
                pages += 1
                while True:
                    pkt = c.io.read_packet()
                    if pkt[:1] == b"\xfe" and len(pkt) < 9:
                        last = bool(struct.unpack_from("<H", pkt, 3)[0]
                                    & breadth.P.SERVER_STATUS_LAST_ROW_SENT)
                        break
                    got.append(struct.unpack_from("<i", pkt, 2)[0])
            c.close()
            return (ncols, nparams,
                    bool(status & breadth.P.SERVER_STATUS_CURSOR_EXISTS),
                    pages, got)
        assert _both(run) == (1, 0, True, 3, list(range(25)))


class TestLongData:
    def test_send_long_data_param(self, breadth_servers):
        big = "A" * 600 + "B" * 600
        P = breadth.P

        def run(side):
            port = breadth_servers[side].port
            c = breadth.Client(port, "sha2user", "secret2",
                               plugin="caching_sha2_password")
            c.query_ok("use pb")
            sid, _nc, nparams = c.prepare("insert into t values (100, ?)")
            for part in (big[:600], big[600:]):
                c.io.reset_seq()
                c.io.write_packet(bytes([P.COM_STMT_SEND_LONG_DATA])
                                  + struct.pack("<IH", sid, 0)
                                  + part.encode())
            c.io.reset_seq()
            c.io.write_packet(bytes([P.COM_STMT_EXECUTE])
                              + struct.pack("<I", sid) + bytes([0])
                              + struct.pack("<I", 1) + bytes([0, 1, 0xFE, 0]))
            ok = c.io.read_packet()[0]
            c2 = breadth.Client(port, "sha2user", "secret2",
                                plugin="caching_sha2_password")
            c2.query_ok("use pb")
            sid2, _, _ = c2.prepare("select v from t where id = 100")
            c2.io.reset_seq()
            c2.io.write_packet(bytes([P.COM_STMT_EXECUTE])
                               + struct.pack("<I", sid2) + bytes([0])
                               + struct.pack("<I", 1))
            for _ in range(3):
                c2.io.read_packet()
            row = c2.io.read_packet()
            c2.close()
            reset = c.cmd(P.COM_STMT_RESET, struct.pack("<I", sid))[0]
            c.close()
            return nparams, ok, big.encode() in row, reset
        assert _both(run) == (1, 0, True, 0)


def test_alter_user_rejects_unknown_plugin():
    def run(side):
        s = SIDES[side]
        ses = s["session"](s["boot"]())
        ses.execute("create user 'pu'@'%' identified by 'x'")
        codes = []
        for sql in ("alter user 'pu'@'%' identified with 'bogus_plugin' "
                    "by 'y'",
                    "create user 'pu2'@'%' identified with "
                    "'evil'', super_priv=''Y' by 'y'"):
            with pytest.raises(s["error"]) as ei:
                ses.execute(sql)
            codes.append(ei.value.code)
        return codes
    assert _both(run) == [1524, 1524]


# -- the device engine over the wire -------------------------------------------

def _decode(kind_payload, float_cols):
    kind, (cols, rows) = kind_payload
    return cols, [tuple(float(v) if i in float_cols and v is not None else v
                        for i, v in enumerate(r)) for r in rows]


@pytest.fixture(scope="module")
def tpch_servers():
    """bench.gen_all's tables in the reference and carry.gen_tpch's in
    the port at SF 0.002, each behind its package's wire server."""
    ref, port = RefKit(), PortKit()
    bench.gen_all(ref, 0.002)
    carry.install_tpch(port.must_exec, port.domain, "tpch",
                       carry.gen_tpch(0.002))
    out = {"ref": RefServer(ref.domain, port=0).start(),
           "port": PortServer(port.domain, port=0).start()}
    yield out
    _stop(*out.values())


def test_q1_over_the_wire_on_the_device_engine(tpch_servers, monkeypatch):
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
    q1 = " ".join(bench.QUERIES["q1"].split())
    got = {}
    for side, srv in tpch_servers.items():
        c = MiniClient(srv.port, db="tpch")
        try:
            assert c.query("set tidb_executor_engine = 'tpu'")[0] == "ok"
            before = dict(calls)
            res = c.query(q1)
            moved = {k: calls[k] - before[k] for k in calls}
            ex = c.query("explain analyze " + q1)[1][1]
        finally:
            c.close()
        got[side] = res
        agg = [r for r in ex if "HashAgg" in r[0]]
        assert agg and all("engine:tpu" in " ".join(map(str, r))
                           for r in agg), ex
        if side == "port":
            assert moved["K2"] > 0 and moved["K1"] > 0, moved
    assert len(got["port"][1][1]) == 6
    # avg_* columns are DECIMAL, every column here is exact
    assert got["port"] == got["ref"]


def _execute_with_date(c, sql, y, m, d):
    """COM_STMT_PREPARE `sql`, then COM_STMT_EXECUTE it with one binary
    DATE parameter (type 0x0A); the rows come back in the binary
    protocol."""
    c.io.reset_seq()
    c.io.write_packet(bytes([0x16]) + sql.encode())
    resp = c.io.read_packet()
    sid, n_cols, n_params = struct.unpack_from("<IHH", resp, 1)
    for _ in range(n_params + 1 + n_cols + 1):
        c.io.read_packet()
    c.io.reset_seq()
    c.io.write_packet(bytes([0x17]) + struct.pack("<IBI", sid, 0, 1)
                      + b"\x00\x01" + bytes([0x0A, 0])
                      + bytes([4]) + struct.pack("<HBB", y, m, d))
    return c._read_result(binary=True)


def test_q1_prepared_with_a_binary_date_parameter(tpch_servers):
    q = " ".join(bench.QUERIES["q1"].split()).replace("'1998-09-02'", "?")

    def run(side):
        return _session(lambda c: [
            c.query("set tidb_executor_engine = 'tpu'"),
            _execute_with_date(c, q, 1998, 9, 2),
            c.query(q.replace("?", "'1998-09-02'"))],
            tpch_servers[side].port, db="tpch")
    _ok, binary, text = _both(run)
    assert len(binary[1][1]) == 6
    # DECIMAL and BIGINT cells: the binary rows read as the text rows
    assert binary == text


def test_window_over_the_wire_doubles_within_tolerance(tpch_servers):
    """A DOUBLE running sum over the wire: decoded within rtol 1e-9."""
    q = ("select count(*), sum(rn), max(s) from (select row_number() over "
         "(partition by l_suppkey order by l_shipdate) rn, sum(l_extendedprice"
         " * 1e0) over (partition by l_suppkey order by l_shipdate) s "
         "from lineitem) t")
    got = {}
    for side, srv in tpch_servers.items():
        got[side] = _session(lambda c: [
            c.query("set tidb_executor_engine = 'tpu'"), c.query(q)][1],
            srv.port, db="tpch")
    cols, rows = _decode(got["port"], {2})
    rcols, rrows = _decode(got["ref"], {2})
    assert cols == rcols and rows[0][:2] == rrows[0][:2]
    assert np.isclose(rows[0][2], rrows[0][2], rtol=1e-9, atol=1e-12)


# -- the process entry ---------------------------------------------------------

def _entry(*args):
    return subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.server", *args],
        capture_output=True, text=True, timeout=240, cwd=ROOT)


def test_process_entry_config_check_and_version():
    proc = _entry("--device", "cpu", "--config-check")
    assert proc.returncode == 0 and proc.stdout.strip() == "config OK", \
        proc.stderr
    proc = _entry("-V")
    assert proc.returncode == 0
    assert proc.stdout.strip() == "tidb-tpu-torch-server 8.0.11-tpu-htap"


def test_server_without_card_exits_1(monkeypatch, capsys):
    """--device cuda with no card visible: run_server refuses before it
    bootstraps or listens, exit 1 with DeviceNotAvailable's message."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    listens = []
    monkeypatch.setattr(PortServer, "start",
                        lambda self: listens.append(self) or self)
    try:
        rc = pmain.main(["--device", "cuda", "--port", "0",
                         "--status-port", "-1"])
    finally:
        tdev.set_device("cpu")
    assert rc == 1 and not listens
    err = capsys.readouterr().err
    assert "no CUDA device is available for the device engine" in err
