"""CREATE/DROP/ALTER USER, GRANT, REVOKE (reference: executor/grant.go,
revoke.go, simple.go executeCreateUser) — all execute as internal DML on
the mysql.* grant tables, then reload the privilege cache."""

from __future__ import annotations

from ..errors import TiDBError, ErrCode
from ..privilege import DB_PRIVS, PRIVS, mysql_native_hash


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace("'", "\\'")


def _internal(session, sql: str):
    session._internal += 1
    try:
        return session.execute(sql)
    finally:
        session._internal -= 1


def _user_exists(session, user, host) -> bool:
    r = _internal(session,
                  f"select 1 from mysql.user where user = '{_esc(user)}' "
                  f"and host = '{_esc(host)}'")
    return bool(r[-1].rows)


def create_user(session, stmt):
    from ..privilege import (DEFAULT_AUTH_PLUGIN, SUPPORTED_AUTH_PLUGINS,
                             auth_string_for)
    for user, host, pw, plugin in stmt.users:
        plugin = plugin or DEFAULT_AUTH_PLUGIN
        if plugin not in SUPPORTED_AUTH_PLUGINS:
            raise TiDBError(f"Plugin '{plugin}' is not loaded",
                            code=ErrCode.PluginIsNotLoaded)
        if _user_exists(session, user, host):
            if stmt.if_not_exists:
                continue
            raise TiDBError(f"Operation CREATE USER failed for "
                            f"'{user}'@'{host}'", code=ErrCode.CannotUser)
        if isinstance(pw, tuple):       # IDENTIFIED ... AS '<auth string>'
            auth = pw[1]                # already a stored verifier
        else:
            auth = auth_string_for(pw or "", plugin)
        flags = ", ".join(["'N'"] * len(PRIVS))
        _internal(session,
                  f"insert into mysql.user values ('{_esc(host)}', "
                  f"'{_esc(user)}', '{_esc(auth)}', '{plugin}', {flags})")
    session.domain.priv.load()


def alter_user(session, stmt):
    from ..privilege import (DEFAULT_AUTH_PLUGIN, SUPPORTED_AUTH_PLUGINS,
                             auth_string_for)
    for user, host, pw, plugin in stmt.users:
        if plugin is not None and plugin not in SUPPORTED_AUTH_PLUGINS:
            # whitelist doubles as the injection guard: the plugin name is
            # interpolated into internal SQL below
            raise TiDBError(f"Plugin '{plugin}' is not loaded",
                            code=ErrCode.PluginIsNotLoaded)
        if not _user_exists(session, user, host):
            if stmt.if_exists:
                continue
            raise TiDBError(f"Operation ALTER USER failed for "
                            f"'{user}'@'{host}'", code=ErrCode.CannotUser)
        if plugin is None:
            rec = session.domain.priv.match_user(user, host)
            plugin = rec.plugin if rec is not None else DEFAULT_AUTH_PLUGIN
        if isinstance(pw, tuple):       # IDENTIFIED ... AS '<auth string>'
            auth = pw[1]
        else:
            auth = auth_string_for(pw or "", plugin)
        _internal(session,
                  f"update mysql.user set authentication_string = "
                  f"'{_esc(auth)}',"
                  f" plugin = '{plugin}' "
                  f"where user = '{_esc(user)}' and host = '{_esc(host)}'")
    session.domain.priv.load()


def drop_user(session, stmt):
    for user, host in stmt.users:
        if not _user_exists(session, user, host):
            if stmt.if_exists:
                continue
            raise TiDBError(f"Operation DROP USER failed for "
                            f"'{user}'@'{host}'", code=ErrCode.CannotUser)
        cond = f"user = '{_esc(user)}' and host = '{_esc(host)}'"
        _internal(session, f"delete from mysql.user where {cond}")
        _internal(session, f"delete from mysql.db where {cond}")
        _internal(session, f"delete from mysql.tables_priv where {cond}")
    session.domain.priv.load()


def _expand(privs, level_privs):
    if "all" in privs:
        return [p for p in level_privs if p != "grant"]
    bad = [p for p in privs if p not in level_privs and p != "usage"]
    if bad:
        raise TiDBError(f"privilege '{bad[0]}' not grantable at this level")
    return [p for p in privs if p != "usage"]


def grant(session, stmt):
    db = stmt.db or session.current_db()
    from ..privilege import (DEFAULT_AUTH_PLUGIN, SUPPORTED_AUTH_PLUGINS,
                             auth_string_for)
    for user, host, pw, plugin in stmt.users:
        plugin = plugin or DEFAULT_AUTH_PLUGIN
        if plugin not in SUPPORTED_AUTH_PLUGINS:
            raise TiDBError(f"Plugin '{plugin}' is not loaded",
                            code=ErrCode.PluginIsNotLoaded)
        if not _user_exists(session, user, host):
            # 5.7-style implicit user creation on GRANT
            if isinstance(pw, tuple):
                auth = pw[1]
            else:
                auth = auth_string_for(pw or "", plugin)
            flags = ", ".join(["'N'"] * len(PRIVS))
            _internal(session,
                      f"insert into mysql.user values ('{_esc(host)}', "
                      f"'{_esc(user)}', '{_esc(auth)}', "
                      f"'{plugin}', {flags})")
        cond = f"user = '{_esc(user)}' and host = '{_esc(host)}'"
        if stmt.db == "*":                     # global level
            sets = [f"{p}_priv = 'Y'" for p in _expand(stmt.privs, PRIVS)]
            if stmt.with_grant:
                sets.append("grant_priv = 'Y'")
            if sets:
                _internal(session,
                          f"update mysql.user set {', '.join(sets)} "
                          f"where {cond}")
        elif stmt.table == "*":                # database level
            privs = _expand(stmt.privs, DB_PRIVS)
            if stmt.with_grant:
                privs = privs + ["grant"]
            r = _internal(session,
                          f"select 1 from mysql.db where {cond} and "
                          f"db = '{_esc(db)}'")
            if not r[-1].rows:
                flags = ", ".join(
                    "'Y'" if p in privs else "'N'" for p in DB_PRIVS)
                _internal(session,
                          f"insert into mysql.db values ('{_esc(host)}', "
                          f"'{_esc(db)}', '{_esc(user)}', {flags})")
            else:
                sets = [f"{p}_priv = 'Y'" for p in privs]
                _internal(session,
                          f"update mysql.db set {', '.join(sets)} where "
                          f"{cond} and db = '{_esc(db)}'")
        else:                                  # table level
            privs = _expand(stmt.privs, DB_PRIVS)
            if stmt.with_grant:
                privs = privs + ["grant"]
            tcond = f"{cond} and db = '{_esc(db)}' and " \
                    f"table_name = '{_esc(stmt.table)}'"
            r = _internal(session,
                          f"select table_priv from mysql.tables_priv "
                          f"where {tcond}")
            if not r[-1].rows:
                _internal(session,
                          f"insert into mysql.tables_priv values "
                          f"('{_esc(host)}', '{_esc(db)}', '{_esc(user)}', "
                          f"'{_esc(stmt.table)}', '{','.join(privs)}')")
            else:
                cur = {p for p in r[-1].rows[0][0].split(",") if p}
                cur.update(privs)
                _internal(session,
                          f"update mysql.tables_priv set table_priv = "
                          f"'{','.join(sorted(cur))}' where {tcond}")
    session.domain.priv.load()


def revoke(session, stmt):
    db = stmt.db or session.current_db()
    for user, host in stmt.users:
        cond = f"user = '{_esc(user)}' and host = '{_esc(host)}'"
        if stmt.db == "*":
            sets = [f"{p}_priv = 'N'" for p in _expand(stmt.privs, PRIVS)]
            if "all" in stmt.privs:
                sets.append("grant_priv = 'N'")
            if sets:
                _internal(session,
                          f"update mysql.user set {', '.join(sets)} "
                          f"where {cond}")
        elif stmt.table == "*":
            sets = [f"{p}_priv = 'N'"
                    for p in _expand(stmt.privs, DB_PRIVS)]
            if "all" in stmt.privs:
                sets.append("grant_priv = 'N'")
            if sets:
                _internal(session,
                          f"update mysql.db set {', '.join(sets)} where "
                          f"{cond} and db = '{_esc(db)}'")
        else:
            tcond = f"{cond} and db = '{_esc(db)}' and " \
                    f"table_name = '{_esc(stmt.table)}'"
            r = _internal(session,
                          f"select table_priv from mysql.tables_priv "
                          f"where {tcond}")
            if r[-1].rows:
                cur = {p for p in r[-1].rows[0][0].split(",") if p}
                cur -= set(_expand(stmt.privs, DB_PRIVS))
                if "all" in stmt.privs:
                    cur.discard("grant")
                if cur:
                    _internal(session,
                              f"update mysql.tables_priv set table_priv = "
                              f"'{','.join(sorted(cur))}' where {tcond}")
                else:
                    _internal(session,
                              f"delete from mysql.tables_priv where {tcond}")
    session.domain.priv.load()
