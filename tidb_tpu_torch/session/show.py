"""SHOW statement execution (reference: executor/show.go)."""

from __future__ import annotations

from ..errors import TiDBError, ErrCode, SchemaError
from ..expression import like_to_regex
from ..model import SchemaState
from ..parser import ast
from ..sqltypes import TYPE_LONGLONG, TYPE_VARCHAR, FieldType
from ..utils.chunk import Chunk
from . import sysvars as sv

_S = FieldType(tp=TYPE_VARCHAR)
_I = FieldType(tp=TYPE_LONGLONG)


def _match(like_pat, s: str) -> bool:
    if like_pat is None:
        return True
    return like_to_regex(like_pat).match(s.encode()) is not None


def exec_show(session, stmt: ast.ShowStmt):
    from .session import Result
    like = None
    if stmt.like is not None:
        from ..expression import ExprBuilder, Schema
        v = ExprBuilder(Schema([]), session.expr_ctx()).build(stmt.like).eval_scalar()
        like = v if isinstance(v, bytes) else str(v).encode()

    if stmt.kind == "databases":
        names = session.infoschema().schema_names()
        names = [n for n in names if _match(like, n)]
        names.append("information_schema") if "information_schema" not in names else None
        names.sort()
        rows = [(n.encode(),) for n in names if _match(like, n)]
        return Result(names=["Database"], chunk=Chunk.from_rows([_S], rows))

    if stmt.kind == "tables":
        db = stmt.db or session.current_db()
        infos = session.infoschema()
        if infos.schema_by_name(db) is None:
            raise SchemaError(f"Unknown database '{db}'", code=ErrCode.BadDB)
        tbls = sorted(infos.tables_in_schema(db), key=lambda t: t.name)
        if stmt.full:
            rows = [(t.name.encode(),
                     b"VIEW" if t.is_view else b"BASE TABLE")
                    for t in tbls if _match(like, t.name)]
            return Result(names=[f"Tables_in_{db}", "Table_type"],
                          chunk=Chunk.from_rows([_S, _S], rows))
        rows = [(t.name.encode(),) for t in tbls if _match(like, t.name)]
        return Result(names=[f"Tables_in_{db}"], chunk=Chunk.from_rows([_S], rows))

    if stmt.kind == "columns":
        tn = stmt.target
        db = tn.schema or stmt.db or session.current_db()
        info = session.infoschema().table_by_name(db, tn.name)
        rows = []
        for c in info.public_columns():
            null = b"NO" if c.ftype.not_null else b"YES"
            key = b""
            if session  and info.pk_is_handle and c.id == info.pk_col_id:
                key = b"PRI"
            else:
                for idx in info.indexes:
                    if idx.columns and idx.columns[0].name.lower() == c.name.lower():
                        key = b"PRI" if idx.primary else (b"UNI" if idx.unique else b"MUL")
                        break
            from ..sqltypes import format_value
            default = (format_value(c.default_value, c.ftype) or "").encode() \
                if c.has_default and c.default_value is not None else None
            rows.append((c.name.encode(), c.ftype.sql_string().encode(),
                         null, key, default, b""))
        return Result(names=["Field", "Type", "Null", "Key", "Default", "Extra"],
                      chunk=Chunk.from_rows([_S] * 6, rows))

    if stmt.kind == "index":
        tn = stmt.target
        db = tn.schema or session.current_db()
        info = session.infoschema().table_by_name(db, tn.name)
        rows = []
        if info.pk_is_handle:
            pk = info.find_column_by_id(info.pk_col_id) if hasattr(info, 'find_column_by_id') else None
            pkname = next((c.name for c in info.columns if c.id == info.pk_col_id), "")
            rows.append((info.name.encode(), 0, b"PRIMARY", 1, pkname.encode()))
        for idx in info.indexes:
            for seq, ic in enumerate(idx.columns, 1):
                rows.append((info.name.encode(), 0 if idx.unique else 1,
                             idx.name.encode(), seq, ic.name.encode()))
        return Result(names=["Table", "Non_unique", "Key_name", "Seq_in_index",
                             "Column_name"],
                      chunk=Chunk.from_rows([_S, _I, _S, _I, _S], rows))

    if stmt.kind == "create_table":
        tn = stmt.target
        db = tn.schema or session.current_db()
        info = session.infoschema().table_by_name(db, tn.name)
        if info.is_sequence:
            s = info.sequence
            ddl = (f"CREATE SEQUENCE `{info.name}` START WITH {s['start']} "
                   f"INCREMENT BY {s['increment']} MINVALUE {s['min']} "
                   f"MAXVALUE {s['max']} "
                   + (f"CACHE {s['cache']}" if s.get("cache") else "NOCACHE")
                   + (" CYCLE" if s.get("cycle") else " NOCYCLE"))
            return Result(names=["Sequence", "Create Sequence"],
                          chunk=Chunk.from_rows(
                              [_S, _S], [(info.name.encode(), ddl.encode())]))
        if info.is_view:
            cols = ", ".join(f"`{c}`" for c in info.view["cols"])
            ddl = (f"CREATE VIEW `{info.name}` ({cols}) AS "
                   + info.view["select"])
            return Result(names=["View", "Create View"],
                          chunk=Chunk.from_rows(
                              [_S, _S], [(info.name.encode(), ddl.encode())]))
        ddl = render_create_table(info)
        return Result(names=["Table", "Create Table"],
                      chunk=Chunk.from_rows([_S, _S],
                                            [(info.name.encode(), ddl.encode())]))

    if stmt.kind == "variables":
        rows = []
        reg = sv.get_registry()
        for name in sorted(reg):
            if not _match(like, name):
                continue
            scope = "global" if stmt.global_scope else "session"
            try:
                v = session.get_sysvar(name, scope)
            except TiDBError:
                v = reg[name].default
            rows.append((name.encode(), str(v).encode()))
        return Result(names=["Variable_name", "Value"],
                      chunk=Chunk.from_rows([_S, _S], rows))

    if stmt.kind == "status":
        return Result(names=["Variable_name", "Value"],
                      chunk=Chunk.from_rows([_S, _S], []))

    if stmt.kind == "warnings":
        rows = [(b"Warning", 1105, w.encode()) for w in session.warnings]
        return Result(names=["Level", "Code", "Message"],
                      chunk=Chunk.from_rows([_S, _I, _S], rows))

    if stmt.kind == "errors":
        return Result(names=["Level", "Code", "Message"],
                      chunk=Chunk.from_rows([_S, _I, _S], []))

    if stmt.kind == "engines":
        rows = [(b"tpu-htap", b"DEFAULT",
                 b"TPU-native HTAP storage engine", b"YES", b"YES", b"YES")]
        return Result(names=["Engine", "Support", "Comment", "Transactions",
                             "XA", "Savepoints"],
                      chunk=Chunk.from_rows([_S] * 6, rows))

    if stmt.kind == "charset":
        from ..utils.collate import CHARSETS
        return Result(names=["Charset", "Description", "Default collation",
                             "Maxlen"],
                      chunk=Chunk.from_rows([_S, _S, _S, _I],
                                            list(CHARSETS)))

    if stmt.kind == "collation":
        from ..utils.collate import COLLATIONS
        return Result(names=["Collation", "Charset", "Id", "Default",
                             "Compiled", "Sortlen"],
                      chunk=Chunk.from_rows([_S, _S, _I, _S, _S, _I],
                                            list(COLLATIONS)))

    if stmt.kind == "processlist":
        # same row source as information_schema.processlist
        from .memtables import processlist_rows
        rows = processlist_rows(
            session, max_info=0 if getattr(stmt, "full", False) else 100)
        return Result(names=["Id", "User", "Host", "db", "Command", "Time",
                             "State", "Info"],
                      chunk=Chunk.from_rows([_I, _S, _S, _S, _S, _I, _S, _S],
                                            rows))

    if stmt.kind == "grants":
        cur_user, _, cur_host = session.user.partition("@")
        if stmt.target is not None:
            user, host = stmt.target
            if (user, host) != (cur_user, cur_host or "%"):
                # another account's grants: requires read access to the
                # grant tables (reference: ShowGrants SELECT on mysql.*)
                session.domain.priv.verify(session.user, "mysql", "user",
                                           "select")
        else:
            user, host = cur_user, cur_host or "%"
        lines = session.domain.priv.grants_for(user, host)
        if not lines:
            lines = [f"GRANT USAGE ON *.* TO '{user}'@'{host}'"]
        rows = [(ln.encode(),) for ln in lines]
        return Result(names=[f"Grants for {user}@{host}"],
                      chunk=Chunk.from_rows([_S], rows))

    if stmt.kind == "bindings":
        recs = (session.domain.bind_handle.list() if stmt.global_scope
                else session.session_bindings)
        rows = []
        for norm in sorted(recs):
            r = recs[norm]
            rows.append((r["original"].encode(), r["bind"].encode(),
                         r.get("db", "").encode(),
                         r.get("status", "enabled").encode(),
                         r.get("created", "").encode()))
        return Result(names=["Original_sql", "Bind_sql", "Default_db",
                             "Status", "Create_time"],
                      chunk=Chunk.from_rows([_S] * 5, rows))

    if stmt.kind == "plugins":
        rows = [(p.name.encode(), b"ACTIVE", p.kind.encode(),
                 str(p.version).encode(), b"")
                for p in session.domain.plugins.list()]
        return Result(names=["Name", "Status", "Type", "Library", "License"],
                      chunk=Chunk.from_rows([_S] * 5, rows))

    if stmt.kind == "table_status":
        db = stmt.db or session.current_db()
        infos = session.infoschema()
        rows = []
        for t in infos.tables_in_schema(db):
            rows.append((t.name.encode(), b"tpu-htap", 10, b"Fixed"))
        return Result(names=["Name", "Engine", "Version", "Row_format"],
                      chunk=Chunk.from_rows([_S, _S, _I, _S], rows))

    if stmt.kind == "create_database":
        name = stmt.db
        return Result(names=["Database", "Create Database"],
                      chunk=Chunk.from_rows([_S, _S],
                                            [(name.encode(),
                                              f"CREATE DATABASE `{name}`".encode())]))

    raise TiDBError(f"unsupported SHOW {stmt.kind}")


def render_create_table(info) -> str:
    """reference: executor/show.go ConstructResultOfShowCreateTable."""
    lines = []
    for c in info.public_columns():
        l = f"  `{c.name}` {c.ftype.sql_string()}"
        if c.ftype.not_null:
            l += " NOT NULL"
        if c.has_default and c.default_value is not None:
            from ..sqltypes import format_value, STRING_TYPES
            v = format_value(c.default_value, c.ftype)
            if c.ftype.tp in STRING_TYPES or not str(v).lstrip("-").isdigit():
                l += f" DEFAULT '{v}'"
            else:
                l += f" DEFAULT {v}"
        if (info.auto_random_bits and info.pk_is_handle
                and c.id == info.pk_col_id):
            l += f" /*T![auto_rand] AUTO_RANDOM({info.auto_random_bits}) */"
        lines.append(l)
    if info.pk_is_handle:
        pkname = next((c.name for c in info.columns if c.id == info.pk_col_id), None)
        if pkname:
            lines.append(f"  PRIMARY KEY (`{pkname}`)")
    for idx in info.indexes:
        cols = ", ".join(f"`{ic.name}`" for ic in idx.columns)
        if idx.primary:
            lines.append(f"  PRIMARY KEY ({cols})")
        elif idx.unique:
            lines.append(f"  UNIQUE KEY `{idx.name}` ({cols})")
        else:
            lines.append(f"  KEY `{idx.name}` ({cols})")
    for fk in info.foreign_keys:
        cols = ", ".join(f"`{c}`" for c in fk["cols"])
        rcols = ", ".join(f"`{c}`" for c in fk["ref_cols"])
        l = (f"  CONSTRAINT `{fk['name']}` FOREIGN KEY ({cols}) "
             f"REFERENCES `{fk['ref_table']}` ({rcols})")
        if fk.get("on_delete"):
            l += f" ON DELETE {fk['on_delete'].upper()}"
        if fk.get("on_update"):
            l += f" ON UPDATE {fk['on_update'].upper()}"
        lines.append(l)
    body = ",\n".join(lines)
    s = (f"CREATE TABLE `{info.name}` (\n{body}\n) "
         "ENGINE=tpu-htap DEFAULT CHARSET=utf8mb4")
    if info.partition is not None:
        s += "\n" + render_partition_clause(info)
    return s


def render_partition_clause(info) -> str:
    """reference: show.go ConstructResultOfShowCreateTable partition tail."""
    from ..partition import MAXVALUE
    p = info.partition
    if p.type == "hash":
        return f"PARTITION BY HASH ({p.expr}) PARTITIONS {p.num}"
    col = info.find_column(p.col_name)

    def _fmt(v):
        if v == MAXVALUE:
            return "MAXVALUE"
        if v is None:
            return "NULL"
        if p.func:
            return str(v)
        from ..sqltypes import format_value, STRING_TYPES
        txt = format_value(v, col.ftype)
        if isinstance(txt, bytes):
            txt = txt.decode("utf-8", "replace")
        if col.ftype.tp in STRING_TYPES or not str(txt).lstrip("-").isdigit():
            return f"'{txt}'"
        return str(txt)

    parts = []
    for d in p.defs:
        if p.type == "range":
            b = ("MAXVALUE" if d.less_than == MAXVALUE
                 else f"({_fmt(d.less_than)})")
            parts.append(f" PARTITION `{d.name}` VALUES LESS THAN {b}")
        else:
            vs = ", ".join(_fmt(v) for v in d.in_values)
            parts.append(f" PARTITION `{d.name}` VALUES IN ({vs})")
    return (f"PARTITION BY {p.type.upper()} ({p.expr})\n(" +
            ",\n".join(parts) + ")")
