"""MySQL protocol payloads: handshake, OK/ERR/EOF, column definitions and
text resultset rows (reference: server/conn.go writeInitialHandshake /
writeOK / writeError, server/column.go Dump, server/conn.go:2096
writeResultset)."""

from __future__ import annotations

import hashlib
import os
import struct

from ..sqltypes import (
    TYPE_DATE, TYPE_DATETIME, TYPE_DOUBLE, TYPE_DURATION, TYPE_FLOAT,
    TYPE_INT24, TYPE_LONG, TYPE_LONGLONG, TYPE_NEWDECIMAL, TYPE_NULL,
    TYPE_SHORT, TYPE_TIMESTAMP, TYPE_TINY, TYPE_VARCHAR, TYPE_YEAR,
)
from .packet import lenenc_int, lenenc_str

PROTOCOL_VERSION = 10
SERVER_VERSION = b"8.0.11-tidb-tpu"

# capability flags (subset)
CLIENT_LONG_PASSWORD = 0x1
CLIENT_FOUND_ROWS = 0x2
CLIENT_LONG_FLAG = 0x4
CLIENT_CONNECT_WITH_DB = 0x8
CLIENT_PROTOCOL_41 = 0x200
CLIENT_SSL = 0x800
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_MULTI_STATEMENTS = 0x10000
CLIENT_MULTI_RESULTS = 0x20000
CLIENT_PLUGIN_AUTH = 0x80000

SERVER_CAPABILITIES = (
    CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS | CLIENT_LONG_FLAG
    | CLIENT_CONNECT_WITH_DB | CLIENT_PROTOCOL_41 | CLIENT_TRANSACTIONS
    | CLIENT_SECURE_CONNECTION | CLIENT_MULTI_STATEMENTS
    | CLIENT_MULTI_RESULTS | CLIENT_PLUGIN_AUTH)

SERVER_STATUS_AUTOCOMMIT = 0x2
SERVER_MORE_RESULTS_EXISTS = 0x8

# commands
COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_SEND_LONG_DATA = 0x18
COM_STMT_CLOSE = 0x19
COM_STMT_RESET = 0x1A
COM_STMT_FETCH = 0x1C

SERVER_STATUS_IN_TRANS = 0x0001

#: COM_STMT_EXECUTE cursor flags (reference: server/conn_stmt.go)
CURSOR_TYPE_READ_ONLY = 0x01
SERVER_STATUS_CURSOR_EXISTS = 0x0040
SERVER_STATUS_LAST_ROW_SENT = 0x0080

CHARSET_UTF8MB4 = 255


def caching_sha2_scramble(password: bytes, nonce: bytes) -> bytes:
    """Client-side caching_sha2_password scramble:
    XOR(SHA256(p), SHA256(SHA256(SHA256(p)) || nonce)) (reference:
    server/conn.go:810 authCachingSha2; used by tests/minclients)."""
    import hashlib as _h
    if not password:
        return b""
    p1 = _h.sha256(password).digest()
    p2 = _h.sha256(_h.sha256(p1).digest() + nonce).digest()
    return bytes(a ^ b for a, b in zip(p1, p2))


def caching_sha2_verifier(password: str) -> str:
    """Stored verifier S = SHA256(SHA256(p)); the fast-auth check needs
    only S, which is what the reference's in-memory cache holds."""
    import hashlib as _h
    if not password:
        return ""
    return "$S$" + _h.sha256(
        _h.sha256(password.encode()).digest()).hexdigest().upper()


def caching_sha2_check(verifier: str, nonce: bytes, response: bytes) -> bool:
    """Fast-path verify: SHA256(response XOR SHA256(S || nonce)) == S."""
    import hashlib as _h
    s = bytes.fromhex(verifier[3:])
    mix = _h.sha256(s + nonce).digest()
    if len(response) != len(mix):
        return False
    p1 = bytes(a ^ b for a, b in zip(response, mix))
    return _h.sha256(p1).digest() == s


def build_auth_switch(plugin: str, salt: bytes) -> bytes:
    """AuthSwitchRequest (reference: server/conn.go writeAuthSwitchRequest)."""
    return b"\xfe" + plugin.encode() + b"\x00" + salt + b"\x00"


#: caching_sha2 fast-auth-success marker (0x01 0x03)
FAST_AUTH_SUCCESS = b"\x01\x03"


def native_password_hash(password: bytes, salt: bytes) -> bytes:
    """mysql_native_password scramble: SHA1(pwd) XOR SHA1(salt+SHA1(SHA1(pwd)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def build_handshake(conn_id: int, salt: bytes, extra_caps: int = 0) -> bytes:
    caps = SERVER_CAPABILITIES | extra_caps
    out = bytes([PROTOCOL_VERSION]) + SERVER_VERSION + b"\x00"
    out += struct.pack("<I", conn_id)
    out += salt[:8] + b"\x00"
    out += struct.pack("<H", caps & 0xFFFF)
    out += bytes([CHARSET_UTF8MB4])
    out += struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
    out += struct.pack("<H", (caps >> 16) & 0xFFFF)
    out += bytes([len(salt) + 1])
    out += b"\x00" * 10
    out += salt[8:] + b"\x00"
    out += b"mysql_native_password\x00"
    return out


def build_ok(affected=0, last_insert_id=0, status=SERVER_STATUS_AUTOCOMMIT,
             warnings=0) -> bytes:
    return (b"\x00" + lenenc_int(affected) + lenenc_int(last_insert_id)
            + struct.pack("<HH", status, warnings))


def build_eof(status=SERVER_STATUS_AUTOCOMMIT, warnings=0) -> bytes:
    return b"\xfe" + struct.pack("<HH", warnings, status)


def build_err(code: int, message: str, state: bytes = b"HY000") -> bytes:
    return (b"\xff" + struct.pack("<H", code) + b"#" + state
            + message.encode("utf-8"))


def new_salt() -> bytes:
    # 20 printable bytes, no NULs (reference: util.RandomBuf)
    out = bytearray(os.urandom(20))
    for i, b in enumerate(out):
        out[i] = 1 + (b % 125)
    return bytes(out)


def column_def(name: str, ftype, db: str = "", table: str = "") -> bytes:
    """Protocol::ColumnDefinition41."""
    tp = ftype.tp
    flen = ftype.flen if ftype.flen and ftype.flen > 0 else 255
    decimals = 0
    charset = CHARSET_UTF8MB4
    if tp in (TYPE_LONGLONG, TYPE_DOUBLE, TYPE_FLOAT, TYPE_NEWDECIMAL):
        charset = 63  # binary
        if tp == TYPE_NEWDECIMAL:
            decimals = ftype.scale
        flen = 21
    elif tp in (TYPE_DATE, TYPE_DATETIME, TYPE_TIMESTAMP):
        charset = 63
        flen = 26
    elif tp == TYPE_NULL:
        charset = 63
    out = lenenc_str(b"def")
    out += lenenc_str(db.encode())
    out += lenenc_str(table.encode())
    out += lenenc_str(table.encode())
    out += lenenc_str(name.encode())
    out += lenenc_str(name.encode())
    out += bytes([0x0C])
    out += struct.pack("<H", charset)
    out += struct.pack("<I", flen)
    out += bytes([tp & 0xFF])
    out += struct.pack("<H", ftype.flag)
    out += bytes([decimals])
    out += b"\x00\x00"
    return out


def text_row(row) -> bytes:
    """One text-protocol row: display strings, NULL = 0xFB."""
    out = b""
    for v in row:
        if v is None:
            out += b"\xfb"
        else:
            out += lenenc_str(v.encode("utf-8") if isinstance(v, str)
                              else bytes(v))
    return out


def _pack_datetime(s: str) -> bytes:
    """Pack 'YYYY-MM-DD[ HH:MM:SS[.ffffff]]' into the binary wire form
    (length byte + packed fields, trailing zero parts trimmed)."""
    date_part, _, time_part = s.partition(" ")
    y, mo, d = (int(x) for x in date_part.split("-"))
    h = mi = sec = us = 0
    if time_part:
        hms, _, frac = time_part.partition(".")
        h, mi, sec = (int(x) for x in hms.split(":"))
        us = int(frac.ljust(6, "0")) if frac else 0
    if us:
        return (bytes([11]) + struct.pack("<H", y) + bytes([mo, d, h, mi, sec])
                + struct.pack("<I", us))
    if h or mi or sec:
        return bytes([7]) + struct.pack("<H", y) + bytes([mo, d, h, mi, sec])
    if y or mo or d:
        return bytes([4]) + struct.pack("<H", y) + bytes([mo, d])
    return bytes([0])


def _pack_duration(s: str) -> bytes:
    """Pack '[-]HH:MM:SS[.ffffff]' into the binary TIME wire form."""
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    hms, _, frac = s.partition(".")
    h, mi, sec = (int(x) for x in hms.split(":"))
    us = int(frac.ljust(6, "0")) if frac else 0
    days, h = divmod(h, 24)
    if not (days or h or mi or sec or us):
        return bytes([0])
    body = bytes([1 if neg else 0]) + struct.pack("<I", days) + bytes([h, mi, sec])
    if us:
        return bytes([12]) + body + struct.pack("<I", us)
    return bytes([8]) + body


_LENENC_TYPES = frozenset({
    TYPE_NEWDECIMAL, TYPE_VARCHAR, TYPE_NULL,
}) | {0x10, 0xF5, 0xF7, 0xF8, 0xF9, 0xFA, 0xFB, 0xFC, 0xFD, 0xFE, 0xFF}


def binary_row(row, ftypes) -> bytes:
    """One Protocol::BinaryResultsetRow: 0x00 header, NULL bitmap at bit
    offset 2, then values encoded by the advertised column type — matching
    column_def's tp byte so real binary-protocol clients (libmysqlclient,
    JDBC, mysql-connector) can parse EXECUTE results (reference:
    server/column.go Column.Dump / conn_stmt.go writeBinaryRow)."""
    n = len(row)
    bitmap = bytearray((n + 7 + 2) // 8)
    vals = b""
    for i, (v, ft) in enumerate(zip(row, ftypes)):
        if v is None:
            bit = i + 2
            bitmap[bit // 8] |= 1 << (bit % 8)
            continue
        tp = ft.tp
        unsigned = bool(ft.flag & 0x20)
        s = None
        if tp not in _LENENC_TYPES:
            s = v if isinstance(v, str) else (
                v.decode("utf-8", "surrogateescape")
                if isinstance(v, (bytes, bytearray)) else str(v))
        if tp == TYPE_TINY:
            vals += struct.pack("<B" if unsigned else "<b", int(s))
        elif tp in (TYPE_SHORT, TYPE_YEAR):
            vals += struct.pack("<H" if unsigned else "<h", int(s))
        elif tp in (TYPE_LONG, TYPE_INT24):
            vals += struct.pack("<I" if unsigned else "<i", int(s))
        elif tp == TYPE_LONGLONG:
            vals += struct.pack("<Q" if unsigned else "<q", int(s))
        elif tp == TYPE_FLOAT:
            vals += struct.pack("<f", float(s))
        elif tp == TYPE_DOUBLE:
            vals += struct.pack("<d", float(s))
        elif tp in (TYPE_DATE, TYPE_DATETIME, TYPE_TIMESTAMP):
            vals += _pack_datetime(s)
        elif tp == TYPE_DURATION:
            vals += _pack_duration(s)
        else:  # NEWDECIMAL / VARCHAR / STRING / BLOB / JSON / ENUM / SET
            vals += lenenc_str(
                v.encode("utf-8") if isinstance(v, str)
                else bytes(v) if isinstance(v, (bytes, bytearray))
                else str(v).encode("utf-8"))
    return b"\x00" + bytes(bitmap) + vals
