"""MySQL protocol server (reference: server/server.go accept loop +
server/conn.go clientConn.Run dispatch loop / handshake at conn.go:256,810,
resultset streaming at conn.go:2096).

Threaded TCP server; each connection owns a Session over the shared
Domain — the reference's per-conn goroutine becomes a thread. Prepared
statements parse once at PREPARE ('?' lexes to real ParamMarker nodes)
and bind decoded binary parameters through the session's parameter
pathway at EXECUTE (binary row encoding is a follow-up)."""

from __future__ import annotations

import socket
import socketserver
import struct
import threading

from ..errors import TiDBError
from ..session import new_session
from . import protocol as P
from .packet import (PacketIO, lenenc_int, read_lenenc_int, read_nul_str)


class MySQLServer:
    def __init__(self, domain, host="127.0.0.1", port=4000, users=None,
                 ssl_ctx=None, reuse_port=False):
        """users: optional static {user: password} map override. Default
        (None) authenticates against the mysql.user grant tables (falling
        back to empty-password root when the domain has no grant tables).
        Pass users={} to explicitly accept any login (hermetic tests).
        ssl_ctx: an ssl.SSLContext enabling the in-handshake TLS upgrade
        (reference: server/conn.go:256 upgradeToTLS; see make_tls_context
        / auto-TLS in server/main.py).
        reuse_port: bind with SO_REUSEPORT so N fabric worker processes
        (fabric/) can listen behind ONE advertised port — the
        kernel load-balances incoming connections across the fleet.

        Connection ids come from the Session allocator (session.py),
        which a fabric worker prefixes with its process-slot base —
        fleet-UNIQUE ids, so KILL and information_schema attribution
        resolve to the owning process (a per-server counter here would
        let two workers mint the same id)."""
        self.domain = domain
        self.users = users
        self.ssl_ctx = ssl_ctx
        self._lock = threading.Lock()
        self.connections = {}

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer._handle_conn(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

            def server_bind(self):
                if reuse_port:
                    self.socket.setsockopt(socket.SOL_SOCKET,
                                           socket.SO_REUSEPORT, 1)
                super().server_bind()

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = None

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def shutdown(self):
        """Graceful-ish shutdown (reference: server.go GracefulDown)."""
        self._server.shutdown()
        self._server.server_close()

    # -- connection ---------------------------------------------------------

    def _handle_conn(self, sock: socket.socket):
        io = PacketIO(sock)
        # the session is created BEFORE the handshake so the conn id the
        # client displays is the one KILL resolves in domain.sessions —
        # two counters here meant KILL <shown id> hit the wrong session
        session = new_session(self.domain)
        conn_id = session.conn_id
        salt = P.new_salt()
        extra = P.CLIENT_SSL if self.ssl_ctx is not None else 0
        io.write_packet(P.build_handshake(conn_id, salt, extra))
        try:
            resp = io.read_packet()
            caps0 = (struct.unpack_from("<I", resp, 0)[0]
                     if len(resp) >= 4 else 0)
            if (self.ssl_ctx is not None and (caps0 & P.CLIENT_SSL)
                    and len(resp) <= 32):
                # SSLRequest: upgrade the conn IN the handshake, then the
                # client resends the full response encrypted (reference:
                # server/conn.go:256 upgradeToTLS)
                sock = self.ssl_ctx.wrap_socket(sock, server_side=True)
                io.sock = sock
                resp = io.read_packet()
            user, db, auth, client_plugin = \
                self._parse_handshake_response(resp)
        except ConnectionError:
            session.close()
            return
        except Exception:
            # garbage from a non-MySQL client (port scan, HTTP, TLS probe)
            try:
                io.write_packet(P.build_err(1043, "Bad handshake", b"08S01"))
            except Exception:
                pass
            session.close()
            return
        try:
            peer = sock.getpeername()[0]
        except OSError:
            peer = "%"
        # authentication plugins decide first (reference: plugin auth
        # sub-manifest consulted before the grant tables)
        plug = getattr(self.domain, "plugins", None)
        decided = plug.authenticate(user, peer, auth) if plug else None
        if decided is False:
            matched_host = None
        elif decided is True:
            matched_host = "%"
        else:
            # when the account's auth plugin differs from what the client
            # used, ask it to re-scramble (AuthSwitchRequest — reference:
            # server/conn.go:810 handleAuthPlugin/authSwitchRequest); this
            # is how caching_sha2_password accounts log in from clients
            # that defaulted to mysql_native_password and vice versa
            rec_plugin = self._account_plugin(user, peer)
            if rec_plugin is not None and rec_plugin != client_plugin:
                try:
                    io.write_packet(P.build_auth_switch(rec_plugin, salt))
                    auth = io.read_packet()
                    client_plugin = rec_plugin
                except Exception:
                    auth = b""
            matched_host = self._check_auth(user, auth, salt, peer)
            fast_auth = (matched_host is not None
                         and client_plugin == "caching_sha2_password")
            if fast_auth:
                io.write_packet(P.FAST_AUTH_SUCCESS)
        if matched_host is None:
            if plug:
                plug.audit_connection({"user": user, "host": peer},
                                      "ConnectionReject")
            io.write_packet(P.build_err(
                1045, f"Access denied for user '{user}'", b"28000"))
            session.close()
            return
        session.user = f"{user}@{matched_host}"
        if plug:
            plug.audit_connection(
                {"user": user, "host": peer, "conn_id": session.conn_id},
                "Connect")
        if db:
            try:
                session.execute(f"use `{db}`")
            except TiDBError as e:
                io.write_packet(P.build_err(
                    getattr(e, "code", 1049) or 1049, str(e)))
                session.close()
                return
        io.write_packet(P.build_ok())
        self.connections[conn_id] = session
        try:
            self._command_loop(io, session)
        finally:
            self.connections.pop(conn_id, None)
            if plug:
                plug.audit_connection(
                    {"user": user, "host": peer,
                     "conn_id": session.conn_id}, "Disconnect")
            session.close()

    def _parse_handshake_response(self, buf: bytes):
        caps = struct.unpack_from("<I", buf, 0)[0]
        pos = 4 + 4 + 1 + 23  # caps, max packet, charset, filler
        user, pos = read_nul_str(buf, pos)
        if caps & P.CLIENT_SECURE_CONNECTION:
            alen = buf[pos]
            pos += 1
            auth = buf[pos:pos + alen]
            pos += alen
        else:
            auth, pos = read_nul_str(buf, pos)
        db = b""
        if caps & P.CLIENT_CONNECT_WITH_DB and pos < len(buf):
            db, pos = read_nul_str(buf, pos)
        plugin = b"mysql_native_password"
        if caps & P.CLIENT_PLUGIN_AUTH and pos < len(buf):
            plugin, pos = read_nul_str(buf, pos)
        return user.decode(), db.decode(), auth, plugin.decode()

    def _account_plugin(self, user: str, peer: str) -> str | None:
        """The grant-table account's auth plugin, or None when auth is
        driven by the users dict / bootstrap fallback (native only)."""
        if self.users is not None:
            return None
        priv = getattr(self.domain, "priv", None)
        if priv is not None and priv.enabled:
            rec = priv.match_user(user, peer)
            return rec.plugin if rec is not None else None
        return None

    def _check_auth(self, user: str, auth: bytes, salt: bytes,
                    peer: str = "%") -> str | None:
        """-> the matched account's host scope, or None on rejection."""
        if self.users == {}:
            return "%"  # explicit opt-in: accept any login
        if self.users is not None:
            if user not in self.users:
                return None
            expected = P.native_password_hash(
                self.users[user].encode(), salt)
            return "%" if auth == expected else None
        # grant tables (reference: privileges.ConnectionVerification)
        priv = getattr(self.domain, "priv", None)
        if priv is not None and priv.enabled:
            rec = priv.check_password_response(user, salt[:20], auth, peer)
            return rec.host if rec is not None else None
        # no grant tables: bootstrap behavior, empty-password root only
        return "%" if (user == "root" and not auth) else None

    # -- command dispatch ---------------------------------------------------

    def _command_loop(self, io: PacketIO, session):
        stmts = {}  # stmt_id -> [ast, n_params, types]
        long_data = {}  # (stmt_id, param_idx) -> bytearray
        cursors = {}  # stmt_id -> [rows, ftypes, pos]
        next_stmt = 0
        while True:
            io.reset_seq()
            try:
                pkt = io.read_packet()
            except ConnectionError:
                return
            if not pkt:
                io.write_packet(P.build_err(1047, "empty command", b"08S01"))
                continue
            cmd, payload = pkt[0], pkt[1:]
            try:
                if cmd == P.COM_QUIT:
                    return
                elif cmd == P.COM_PING:
                    io.write_packet(P.build_ok())
                elif cmd == P.COM_INIT_DB:
                    session.execute(f"use `{payload.decode()}`")
                    io.write_packet(P.build_ok())
                elif cmd == P.COM_QUERY:
                    self._run_query(io, session, payload.decode("utf-8"))
                elif cmd == P.COM_FIELD_LIST:
                    io.write_packet(P.build_eof())
                elif cmd == P.COM_STMT_PREPARE:
                    sql = payload.decode("utf-8")
                    next_stmt += 1
                    sid = next_stmt
                    # parse ONCE: '?' are real ParamMarker nodes, so the
                    # count follows SQL lexing (strings/comments excluded)
                    ast_stmt, n_params = session.prepare(sql)
                    col_names, col_fts = session.prepared_schema(
                        ast_stmt, n_params)
                    stmts[sid] = [ast_stmt, n_params, None]
                    out = (b"\x00" + struct.pack("<I", sid)
                           + struct.pack("<H", len(col_names))
                           + struct.pack("<H", n_params)
                           + b"\x00" + struct.pack("<H", 0))
                    io.write_packet(out)
                    for _ in range(n_params):
                        io.write_packet(P.column_def(
                            "?", _param_ftype()))
                    if n_params:
                        io.write_packet(P.build_eof())
                    for name, ft in zip(col_names, col_fts):
                        io.write_packet(P.column_def(name, ft))
                    if col_names:
                        io.write_packet(P.build_eof())
                elif cmd == P.COM_STMT_EXECUTE:
                    self._stmt_execute(io, session, stmts, payload,
                                       long_data, cursors)
                elif cmd == P.COM_STMT_SEND_LONG_DATA:
                    # append-only, NO response (reference:
                    # server/conn_stmt.go handleStmtSendLongData)
                    sid = struct.unpack_from("<I", payload, 0)[0]
                    pid = struct.unpack_from("<H", payload, 4)[0]
                    long_data.setdefault((sid, pid),
                                         bytearray()).extend(payload[6:])
                elif cmd == P.COM_STMT_FETCH:
                    self._stmt_fetch(io, session, cursors, payload)
                elif cmd == P.COM_STMT_RESET:
                    sid = struct.unpack_from("<I", payload, 0)[0]
                    for k in [k for k in long_data if k[0] == sid]:
                        long_data.pop(k, None)
                    cursors.pop(sid, None)
                    io.write_packet(P.build_ok())
                elif cmd == P.COM_STMT_CLOSE:
                    sid = struct.unpack_from("<I", payload, 0)[0]
                    stmts.pop(sid, None)
                    cursors.pop(sid, None)
                    for k in [k for k in long_data if k[0] == sid]:
                        long_data.pop(k, None)
                else:
                    io.write_packet(P.build_err(
                        1047, f"Unknown command {cmd:#x}", b"08S01"))
            except TiDBError as e:
                io.write_packet(P.build_err(
                    getattr(e, "code", 1105) or 1105, str(e)))
            except Exception as e:  # never kill the conn loop on a bug
                io.write_packet(P.build_err(1105, f"internal: {e}"))
            if getattr(session, "kill_conn", False):
                return  # KILL CONNECTION: drop the wire connection

    def _run_query(self, io, session, sql: str):
        results = session.execute(sql)
        if not results:
            io.write_packet(P.build_ok())
            return
        for i, res in enumerate(results):
            more = i < len(results) - 1
            status = P.SERVER_STATUS_AUTOCOMMIT | (
                P.SERVER_MORE_RESULTS_EXISTS if more else 0)
            if res.chunk is None:
                io.write_packet(P.build_ok(
                    affected=res.affected,
                    last_insert_id=res.last_insert_id, status=status))
                continue
            self._write_resultset(io, res, status)

    @staticmethod
    def _session_status(session) -> int:
        """Real connection status flags for EOF/OK packets (reference:
        server status bits in conn.go writeOK): autocommit + in-txn."""
        status = 0
        try:
            if session.autocommit():
                status |= P.SERVER_STATUS_AUTOCOMMIT
            if session.txn is not None and session.txn.valid:
                status |= P.SERVER_STATUS_IN_TRANS
        except Exception:
            status = P.SERVER_STATUS_AUTOCOMMIT
        return status

    def _write_result_header(self, io, res, status):
        """column count + defs + EOF — shared by the immediate resultset
        path and the server-side cursor open."""
        io.write_packet(lenenc_int(len(res.names)))
        for name, ft in zip(res.names, res.ftypes):
            io.write_packet(P.column_def(name, ft))
        io.write_packet(P.build_eof(status=status))

    def _write_resultset(self, io, res, status, binary=False):
        """binary=True after COM_STMT_EXECUTE: the binary protocol requires
        Protocol::BinaryResultsetRow, not text rows (reference:
        server/conn_stmt.go handleStmtExecute → writeResultset(binary))."""
        fts = res.ftypes
        self._write_result_header(io, res, status)
        if binary:
            for row in res.rows:
                io.write_packet(P.binary_row(row, fts))
        else:
            for row in res.rows:
                io.write_packet(P.text_row(row))
        io.write_packet(P.build_eof(status=status))

    def _stmt_execute(self, io, session, stmts, payload, long_data=None,
                      cursors=None):
        sid = struct.unpack_from("<I", payload, 0)[0]
        if sid not in stmts:
            io.write_packet(P.build_err(1243, "Unknown prepared statement"))
            return
        ast_stmt, n_params, bound_types = stmts[sid]
        if cursors is not None:
            # a new execution supersedes any open cursor on this stmt id
            # (the reference closes the prior cursor on execute)
            cursors.pop(sid, None)
        cursor_flags = payload[4]
        pos = 4 + 1 + 4  # id, flags, iteration count
        args = []
        long_data = long_data if long_data is not None else {}
        if n_params:
            nullmap_len = (n_params + 7) // 8
            nullmap = payload[pos:pos + nullmap_len]
            pos += nullmap_len
            new_bound = payload[pos]
            pos += 1
            if new_bound:
                types = []
                for _ in range(n_params):
                    types.append((payload[pos], payload[pos + 1]))
                    pos += 2
                stmts[sid][2] = types  # persist: later executes send no types
            else:
                types = bound_types
            if not types:
                raise TiDBError("prepared statement executed with no "
                                "parameter types bound")
            for i in range(n_params):
                ld = long_data.get((sid, i))
                if ld is not None:
                    # long-data params carry no value in the execute
                    # payload (reference: conn_stmt.go parseExecArgs)
                    args.append(bytes(ld))
                    continue
                if nullmap[i // 8] & (1 << (i % 8)):
                    args.append(None)
                    continue
                tp, flags = types[i]
                v, pos = _decode_binary_value(payload, pos, tp, flags)
                args.append(v)
        res = session.execute_prepared(ast_stmt, args)
        status = self._session_status(session)
        if res.chunk is None:
            io.write_packet(P.build_ok(
                affected=res.affected,
                last_insert_id=res.last_insert_id, status=status))
            return
        if (cursor_flags & P.CURSOR_TYPE_READ_ONLY) and cursors is not None:
            # server-side cursor: column defs now, rows via COM_STMT_FETCH
            # (reference: server/conn_stmt.go useCursor branch)
            cursors[sid] = [list(res.rows), res.ftypes, 0]
            self._write_result_header(
                io, res, status | P.SERVER_STATUS_CURSOR_EXISTS)
            return
        self._write_resultset(io, res, status, binary=True)

    def _stmt_fetch(self, io, session, cursors, payload):
        """COM_STMT_FETCH: next n rows of an open cursor (reference:
        server/conn_stmt.go handleStmtFetch)."""
        sid = struct.unpack_from("<I", payload, 0)[0]
        n = struct.unpack_from("<I", payload, 4)[0]
        cur = cursors.get(sid)
        if cur is None:
            io.write_packet(P.build_err(
                1243, "Unknown prepared statement (no open cursor)"))
            return
        rows, fts, pos = cur
        end = min(pos + max(n, 1), len(rows))
        for row in rows[pos:end]:
            io.write_packet(P.binary_row(row, fts))
        cur[2] = end
        status = self._session_status(session) \
            | P.SERVER_STATUS_CURSOR_EXISTS
        if end >= len(rows):
            status |= P.SERVER_STATUS_LAST_ROW_SENT
        io.write_packet(P.build_eof(status=status))


def _param_ftype():
    from ..sqltypes import FieldType, TYPE_VARCHAR
    return FieldType(tp=TYPE_VARCHAR)


def _decode_binary_value(buf, pos, tp, flags=0):
    """Binary protocol parameter decode (reference: server/conn_stmt.go
    parseExecArgs)."""
    unsigned = bool(flags & 0x80)
    if tp == 0x01:                          # TINY
        return struct.unpack_from("<B" if unsigned else "<b",
                                  buf, pos)[0], pos + 1
    if tp in (0x02, 0x0D):                  # SHORT / YEAR
        return struct.unpack_from("<H" if unsigned else "<h",
                                  buf, pos)[0], pos + 2
    if tp in (0x03, 0x09):                  # LONG / INT24
        return struct.unpack_from("<I" if unsigned else "<i",
                                  buf, pos)[0], pos + 4
    if tp == 0x08:                          # LONGLONG
        return struct.unpack_from("<Q" if unsigned else "<q",
                                  buf, pos)[0], pos + 8
    if tp == 0x04:                          # FLOAT
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if tp == 0x05:                          # DOUBLE
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tp == 0x06:                          # NULL
        return None, pos
    if tp in (0x07, 0x0A, 0x0C):            # TIMESTAMP / DATE / DATETIME
        n = buf[pos]
        pos += 1
        f = buf[pos:pos + n]
        pos += n
        if n == 0:
            return "0000-00-00", pos
        y, mo, d = struct.unpack_from("<H", f, 0)[0], f[2], f[3]
        if n == 4:
            return f"{y:04d}-{mo:02d}-{d:02d}", pos
        h, mi, sec = f[4], f[5], f[6]
        if n == 7:
            return f"{y:04d}-{mo:02d}-{d:02d} {h:02d}:{mi:02d}:{sec:02d}", pos
        us = struct.unpack_from("<I", f, 7)[0]
        return (f"{y:04d}-{mo:02d}-{d:02d} "
                f"{h:02d}:{mi:02d}:{sec:02d}.{us:06d}"), pos
    if tp == 0x0B:                          # TIME
        n = buf[pos]
        pos += 1
        f = buf[pos:pos + n]
        pos += n
        if n == 0:
            return "00:00:00", pos
        sign = "-" if f[0] else ""
        days = struct.unpack_from("<I", f, 1)[0]
        h, mi, sec = f[5], f[6], f[7]
        h += days * 24
        base = f"{sign}{h:02d}:{mi:02d}:{sec:02d}"
        if n > 8:
            us = struct.unpack_from("<I", f, 8)[0]
            base += f".{us:06d}"
        return base, pos
    n, pos = read_lenenc_int(buf, pos)
    return buf[pos:pos + n], pos + n


