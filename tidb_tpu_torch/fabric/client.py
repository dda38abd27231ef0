"""Minimal MySQL text-protocol client for the fleet: bench_serve's
multi-process mode and the fabric tests drive worker processes over the
real wire with it (no external mysql lib in the image).

Deliberately small: handshake (native password), COM_QUERY with text
resultsets, COM_QUIT.  The handshake's connection id is exposed — under
the fabric its high bits carry the worker slot
(``tidb_tpu_torch.fabric.slot_of_conn_id``), which is how the bench attributes
per-process latency without any side channel.
"""

from __future__ import annotations

import socket
import struct

from ..server import protocol as P
from ..server.packet import PacketIO, read_lenenc_int, read_lenenc_str, \
    read_nul_str


class WireError(Exception):
    """Connection-level failure (classified clean by the bench: a killed
    worker's clients see exactly this, never a hang)."""


class FleetClient:
    def __init__(self, port: int, host: str = "127.0.0.1",
                 user: str = "root", password: str = "", db: str = "",
                 timeout: float = 30.0):
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self.io = PacketIO(self.sock)
            self.conn_id = self._handshake(user, password, db)
        except (OSError, ConnectionError) as e:
            raise WireError(f"connect {host}:{port}: {e}") from e

    @property
    def slot(self) -> "int | None":
        from . import slot_of_conn_id
        return slot_of_conn_id(self.conn_id)

    def host(self, hosts: int) -> "int | None":
        """The simulated host serving this connection, per the fleet's
        slot->host convention (fleet.Fleet.host_of: ``slot % hosts``) —
        how the bench proves a query landed on a SURVIVING host after a
        kill-host fault."""
        s = self.slot
        return None if s is None else s % max(int(hosts), 1)

    def _handshake(self, user, password, db) -> int:
        pkt = self.io.read_packet()
        if not pkt or pkt[0] != 10:
            raise WireError("bad handshake packet")
        _ver, pos = read_nul_str(pkt, 1)
        conn_id = struct.unpack_from("<I", pkt, pos)[0]
        pos += 4
        salt1 = pkt[pos:pos + 8]
        pos += 9
        pos += 2 + 1 + 2 + 2
        salt_len = pkt[pos]
        pos += 1 + 10
        salt2 = pkt[pos:pos + max(13, salt_len - 8) - 1]
        salt = salt1 + salt2
        caps = (P.CLIENT_PROTOCOL_41 | P.CLIENT_SECURE_CONNECTION
                | P.CLIENT_PLUGIN_AUTH | P.CLIENT_MULTI_RESULTS
                | (P.CLIENT_CONNECT_WITH_DB if db else 0))
        auth = P.native_password_hash(password.encode(), salt[:20])
        out = struct.pack("<I", caps) + struct.pack("<I", 1 << 24)
        out += bytes([255]) + b"\x00" * 23
        out += user.encode() + b"\x00"
        out += bytes([len(auth)]) + auth
        if db:
            out += db.encode() + b"\x00"
        out += b"mysql_native_password\x00"
        self.io.write_packet(out)
        resp = self.io.read_packet()
        if resp and resp[0] == 0xFF:
            code = struct.unpack_from("<H", resp, 1)[0]
            raise WireError(f"auth failed: {code} {resp[9:].decode()}")
        if not resp or resp[0] != 0x00:
            raise WireError("unexpected handshake response")
        return conn_id

    def query(self, sql: str):
        """-> ('ok', affected) | ('rows', (cols, rows)) | ('err', (code,
        msg)).  WireError on a dead connection (a killed worker)."""
        try:
            self.io.reset_seq()
            self.io.write_packet(bytes([P.COM_QUERY]) + sql.encode())
            return self._read_result()
        except (OSError, ConnectionError, IndexError, struct.error) as e:
            raise WireError(f"connection lost mid-query: "
                            f"{type(e).__name__}: {e}") from e

    def must_query(self, sql: str):
        kind, payload = self.query(sql)
        if kind == "err":
            raise WireError(f"query failed {payload[0]}: {payload[1]} "
                            f"({sql[:120]!r})")
        return payload if kind == "rows" else ([], [])

    def must_exec(self, sql: str):
        kind, payload = self.query(sql)
        if kind == "err":
            raise WireError(f"exec failed {payload[0]}: {payload[1]} "
                            f"({sql[:120]!r})")
        return payload

    def _read_result(self):
        first = self.io.read_packet()
        if first[0] == 0x00:
            affected, _pos = read_lenenc_int(first, 1)
            return "ok", affected
        if first[0] == 0xFF:
            code = struct.unpack_from("<H", first, 1)[0]
            return "err", (code, first[9:].decode(errors="replace"))
        ncols, _ = read_lenenc_int(first, 0)
        cols = []
        for _ in range(ncols):
            pkt = self.io.read_packet()
            pos = 0
            vals = []
            for _f in range(6):
                v, pos = read_lenenc_str(pkt, pos)
                vals.append(v)
            cols.append(vals[4].decode())
        eof = self.io.read_packet()
        if eof[0] != 0xFE:
            raise WireError("missing column EOF")
        rows = []
        while True:
            pkt = self.io.read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            pos = 0
            row = []
            for _ in range(ncols):
                if pkt[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                else:
                    v, pos = read_lenenc_str(pkt, pos)
                    row.append(v.decode())
            rows.append(tuple(row))
        return "rows", (cols, rows)

    def close(self):
        try:
            self.io.reset_seq()
            self.io.write_packet(bytes([P.COM_QUIT]))
        except Exception:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
