"""The port's privileges (``privilege.py``, ``priv_check.py`` and the new
``executor/priv_exec.py``: CREATE / ALTER / DROP USER, GRANT, REVOKE,
SHOW GRANTS, wire authentication against ``mysql.user``) against the
reference's, on the CPU.

Every case of tests/test_privileges.py runs once in each package, on the
same statements; each case records what the statements answered (rows,
or the error's code and message) and the port's record must equal the
reference's.  The reference test's own assertions hold on both records.
"""

import pytest

from test_server import MiniClient
from tidb_tpu.errors import TiDBError as RefError
from tidb_tpu.server import MySQLServer as RefServer
from tidb_tpu.server import protocol as rproto
from tidb_tpu.session import Session as RefSession
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch.errors import TiDBError as PortError
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.server import MySQLServer as PortServer
from tidb_tpu_torch.server import protocol as pproto
from tidb_tpu_torch.session import Session as PortSession
from tidb_tpu_torch.testkit import TestKit as PortKit
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


class Side:
    """One package's names, as the reference test uses them."""

    def __init__(self, kit, session, error, server, proto):
        self.kit_cls, self.session_cls = kit, session
        self.error, self.server, self.proto = error, server, proto

    def kit(self):
        tk = self.kit_cls()
        tk.must_exec("create table t (a int primary key, b int)")
        tk.must_exec("insert into t values (1, 2), (3, 4)")
        return tk

    def as_user(self, tk, user, host="%"):
        s = self.session_cls(tk.session.domain)
        s.user = f"{user}@{host}"
        return s

    def err(self, fn, *args):
        """The (code, message) of the TiDBError `fn(*args)` must raise."""
        with pytest.raises(self.error) as ei:
            fn(*args)
        return ei.value.code, str(ei.value)


SIDES = {"ref": Side(RefKit, RefSession, RefError, RefServer, rproto),
         "port": Side(PortKit, PortSession, PortError, PortServer, pproto)}


def _both(body):
    """body(side) in each package; the records must be equal."""
    got = {name: body(side) for name, side in SIDES.items()}
    assert got["port"] == got["ref"], got
    return got["port"]


def _rows(res):
    return [tuple(r) for r in res[-1].rows]


def test_grant_tables_bootstrap():
    def body(x):
        r = x.kit().must_query(
            "select user, host, select_priv, super_priv from mysql.user")
        return sorted(tuple(row) for row in r.rows)
    assert ("root", "%", "Y", "Y") in _both(body)


def test_create_user_and_deny_by_default():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'bob'@'%' identified by 'pw1'")
        bob = x.as_user(tk, "bob")
        return [x.err(bob.execute, sql) for sql in (
            "select * from t", "insert into t values (9, 9)", "drop table t")]
    assert "denied" in _both(body)[0][1]


def test_grant_table_level_select():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'bob'@'%'")
        tk.must_exec("grant select on test.t to 'bob'@'%'")
        bob = x.as_user(tk, "bob")
        return (_rows(bob.execute("select count(*) from t")),
                x.err(bob.execute, "insert into t values (9, 9)"))
    assert _both(body)[0] == [("2",)]


def test_grant_db_level():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'carl'@'%'")
        tk.must_exec("grant select, insert on test.* to 'carl'@'%'")
        carl = x.as_user(tk, "carl")
        carl.execute("insert into t values (9, 9)")
        return (_rows(carl.execute("select count(*) from t")),
                x.err(carl.execute, "delete from t where a = 9"))
    assert _both(body)[0] == [("3",)]


def test_grant_global_all():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'admin2'@'%'")
        tk.must_exec("grant all on *.* to 'admin2'@'%'")
        a = x.as_user(tk, "admin2")
        a.execute("create table t2 (x int primary key)")
        a.execute("insert into t2 values (1)")
        out = _rows(a.execute("select x from t2"))
        a.execute("drop table t2")
        return out
    assert _both(body) == [("1",)]


def test_revoke():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'bob'@'%'")
        tk.must_exec("grant select on test.* to 'bob'@'%'")
        bob = x.as_user(tk, "bob")
        before = _rows(bob.execute("select * from t order by a"))
        tk.must_exec("revoke select on test.* from 'bob'@'%'")
        return before, x.err(bob.execute, "select * from t")
    _both(body)


def test_drop_user():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'gone'@'%'")
        tk.must_exec("drop user 'gone'@'%'")
        r = tk.must_query(
            "select count(*) from mysql.user where user = 'gone'").rows
        return r, x.err(tk.session.execute, "drop user 'gone'@'%'")
    rows, (_code, msg) = _both(body)
    assert rows == [("0",)] and "DROP USER failed" in msg


def test_show_grants():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'bob'@'%'")
        tk.must_exec("grant select on test.t to 'bob'@'%'")
        tk.must_exec("grant insert on test.* to 'bob'@'%'")
        return (tk.must_query("show grants for 'bob'@'%'").rows,
                tk.must_query("show grants").rows)
    bob, root = _both(body)
    text = "\n".join(row[0] for row in bob)
    assert "ON test.t" in text and "ON test.*" in text
    assert "ALL PRIVILEGES" in root[0][0]


def test_grantee_cannot_grant():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'bob'@'%'")
        tk.must_exec("grant select on test.* to 'bob'@'%'")
        bob = x.as_user(tk, "bob")
        return [x.err(bob.execute, sql) for sql in (
            "grant select on test.* to 'bob'@'%'", "create user 'eve'@'%'")]
    _both(body)


def test_explain_analyze_checked():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'bob'@'%'")
        return x.err(x.as_user(tk, "bob").execute,
                     "explain analyze select * from t")
    _both(body)


def test_information_schema_open():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'bob'@'%'")
        bob = x.as_user(tk, "bob")
        tables = bob.execute("select table_schema, table_name from "
                             "information_schema.tables order by 1, 2")
        return _rows(tables), _rows(bob.execute("show databases"))
    tables, dbs = _both(body)
    assert tables and dbs


def test_wire_auth_against_grant_tables():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'wire'@'%' identified by 'sekret'")
        tk.must_exec("grant select on test.* to 'wire'@'%'")
        srv = x.server(tk.session.domain, port=0).start()
        try:
            c = MiniClient(srv.port, user="wire", password="sekret")
            out = c.query("select count(*) from test.t")
            c.close()
            with pytest.raises(AssertionError) as ei:
                MiniClient(srv.port, user="wire", password="nope")
            MiniClient(srv.port, user="root", password="").close()
            return out, str(ei.value)
        finally:
            srv.shutdown()
            srv._thread.join(10)
    out, denied = _both(body)
    assert out == ("rows", (["count(*)"], [("2",)])) and "1045" in denied


def test_alter_user_password():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'pw'@'%' identified by 'old'")
        tk.must_exec("alter user 'pw'@'%' identified by 'new'")
        priv, salt = tk.session.domain.priv, b"s" * 20
        return [bool(priv.check_password_response(
            "pw", salt, x.proto.native_password_hash(p, salt)))
            for p in (b"new", b"old")]
    assert _both(body) == [True, False]


def test_grant_in_explicit_txn_effective():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'txu'@'%'")
        tk.must_exec("begin")
        tk.must_exec("insert into t values (50, 50)")
        tk.must_exec("grant select on test.t to 'txu'@'%'")
        x.as_user(tk, "txu").execute("select * from t")
        return tk.must_query("select count(*) from t where a = 50").rows
    assert _both(body) == [("1",)]


def test_update_with_read_only_subquery():
    def body(x):
        tk = x.kit()
        tk.must_exec("create table src (x int primary key)")
        tk.must_exec("insert into src values (7)")
        tk.must_exec("create user 'upd'@'%'")
        tk.must_exec("grant select, update on test.t to 'upd'@'%'")
        tk.must_exec("grant select on test.src to 'upd'@'%'")
        x.as_user(tk, "upd").execute(
            "update t set b = (select max(x) from src) where a = 1")
        return tk.must_query("select b from t where a = 1").rows
    assert _both(body) == [("7",)]


def test_revoke_usage_noop():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'ru'@'%'")
        tk.must_exec("revoke usage on *.* from 'ru'@'%'")
        return tk.must_query("show grants for 'ru'@'%'").rows
    _both(body)


def test_localhost_scoped_user():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'loc'@'localhost' identified by 'pw'")
        priv, salt = tk.session.domain.priv, b"x" * 20
        resp = x.proto.native_password_hash(b"pw", salt)
        rec = priv.check_password_response("loc", salt, resp,
                                           host="127.0.0.1")
        far = priv.check_password_response("loc", salt, resp,
                                           host="8.8.8.8")
        return rec is not None and rec.host, far
    assert _both(body) == ("localhost", None)


def test_grant_cannot_escalate():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'esc'@'%'")
        tk.must_exec("grant select on test.* to 'esc'@'%' "
                     "with grant option")
        tk.must_exec("update mysql.user set grant_priv = 'Y' "
                     "where user = 'esc'")
        tk.session.domain.priv.load()
        esc = x.as_user(tk, "esc")
        out = [x.err(esc.execute, sql) for sql in (
            "grant all on *.* to 'esc'@'%'",
            "grant insert on test.* to 'esc'@'%'")]
        tk.must_exec("create user 'peer'@'%'")
        esc.execute("grant select on test.* to 'peer'@'%'")
        return out, tk.must_query("show grants for 'peer'@'%'").rows
    _both(body)


def test_rename_table_checked():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'ren'@'%'")
        out = x.err(x.as_user(tk, "ren").execute, "rename table t to stolen")
        return out, tk.session.infoschema().has_table("test", "t")
    assert _both(body)[1]


def test_deeply_nested_fails_closed():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'deep'@'%'")
        q = "select * from t"
        for _ in range(80):
            q = f"select * from ({q}) x"
        return x.err(x.as_user(tk, "deep").execute, q)
    _both(body)


def test_show_grants_other_user_denied():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'nosy'@'%'")
        nosy = x.as_user(tk, "nosy")
        return (x.err(nosy.execute, "show grants for 'root'@'%'"),
                _rows(nosy.execute("show grants")))
    _both(body)


def test_db_level_denial_error_code():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'dbu'@'%'")
        return x.err(x.as_user(tk, "dbu").execute,
                     "create database offlimits")
    assert _both(body)[0] == 1044


def test_join_and_derived_sources_checked():
    def body(x):
        tk = x.kit()
        tk.must_exec("create table t2 (a int primary key)")
        tk.must_exec("insert into t2 values (1)")
        tk.must_exec("create user 'jn'@'%'")
        tk.must_exec("grant select on test.t2 to 'jn'@'%'")
        jn = x.as_user(tk, "jn")
        out = [x.err(jn.execute, sql) for sql in (
            "select * from t2 join t on t2.a = t.a",
            "select * from (select * from t) x", "select * from t2, t")]
        return out, _rows(jn.execute("select * from (select * from t2) x"))
    assert _both(body)[1] == [("1",)]


def test_db_scoped_grant_option_delegates():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'dlg'@'%'")
        tk.must_exec("create user 'peer2'@'%'")
        tk.must_exec("grant select on test.* to 'dlg'@'%' "
                     "with grant option")
        grants = tk.must_query("show grants for 'dlg'@'%'").rows
        dlg = x.as_user(tk, "dlg")
        dlg.execute("grant select on test.* to 'peer2'@'%'")
        rows = _rows(x.as_user(tk, "peer2").execute(
            "select * from t order by a"))
        return grants, rows, [x.err(dlg.execute, sql) for sql in (
            "grant insert on test.* to 'peer2'@'%'",
            "grant select on *.* to 'peer2'@'%'")]
    grants, _rows_, _errs = _both(body)
    assert any("WITH GRANT OPTION" in row[0] for row in grants)


def test_deep_or_chain_not_rejected():
    def body(x):
        cond = " or ".join(f"a = {i}" for i in range(400))
        return x.kit().must_query(
            f"select count(*) from t where {cond}").rows
    assert _both(body) == [("2",)]


def test_db_scoped_grant_all_delegation():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'dba'@'%'")
        tk.must_exec("create user 'peer3'@'%'")
        tk.must_exec("grant all on test.* to 'dba'@'%' with grant option")
        x.as_user(tk, "dba").execute("grant all on test.* to 'peer3'@'%'")
        peer = x.as_user(tk, "peer3")
        peer.execute("select * from t")
        peer.execute("insert into t values (77, 77)")
        return tk.must_query("select count(*) from t").rows
    assert _both(body) == [("3",)]


def test_table_level_revoke_all_clears_grant_option():
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'tg'@'%'")
        tk.must_exec("grant select on test.t to 'tg'@'%' with grant option")
        tk.must_exec("revoke all on test.t from 'tg'@'%'")
        return tk.must_query("show grants for 'tg'@'%'").rows
    assert not any("GRANT OPTION" in row[0] for row in _both(body))


def test_caching_sha2_verifier_through_the_port():
    """CREATE USER ... WITH caching_sha2_password stores the verifier the
    port's ``server.protocol`` computes (``privilege.py`` imports it), and
    the fast-auth check accepts the right scramble only."""
    def body(x):
        tk = x.kit()
        tk.must_exec("create user 'sha'@'%' identified with "
                     "'caching_sha2_password' by 'pw2'")
        rows = tk.must_query("select plugin, authentication_string from "
                             "mysql.user where user = 'sha'").rows
        nonce = b"n" * 20
        return rows, [x.proto.caching_sha2_check(
            rows[0][1], nonce, x.proto.caching_sha2_scramble(p, nonce))
            for p in (b"pw2", b"pw3")]
    rows, checks = _both(body)
    assert rows[0][0] == "caching_sha2_password" and checks == [True, False]
