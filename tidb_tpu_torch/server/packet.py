"""MySQL wire packet framing and primitives (reference: server/packetio.go
+ server/util.go — 4-byte header [3-byte little-endian length, 1-byte
sequence id], length-encoded integers/strings, 16MB continuation)."""

from __future__ import annotations

import struct

MAX_PAYLOAD = 0xFFFFFF


class PacketIO:
    """Sequenced packet reader/writer over a socket-like object."""

    def __init__(self, sock):
        self.sock = sock
        self.seq = 0

    def reset_seq(self):
        self.seq = 0

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("connection closed")
            buf += chunk
        return buf

    def read_packet(self) -> bytes:
        payload = b""
        while True:
            header = self._read_exact(4)
            length = header[0] | (header[1] << 8) | (header[2] << 16)
            self.seq = (header[3] + 1) & 0xFF
            payload += self._read_exact(length)
            if length < MAX_PAYLOAD:
                return payload

    def write_packet(self, payload: bytes):
        data = payload
        while True:
            chunk, data = data[:MAX_PAYLOAD], data[MAX_PAYLOAD:]
            header = struct.pack("<I", len(chunk))[:3] + bytes([self.seq])
            self.sock.sendall(header + chunk)
            self.seq = (self.seq + 1) & 0xFF
            if len(chunk) < MAX_PAYLOAD:
                return


def lenenc_int(n: int) -> bytes:
    if n < 251:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def lenenc_str(s: bytes) -> bytes:
    return lenenc_int(len(s)) + s


def read_lenenc_int(buf: bytes, pos: int):
    first = buf[pos]
    if first < 251:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return (buf[pos + 1] | (buf[pos + 2] << 8)
                | (buf[pos + 3] << 16)), pos + 4
    if first == 0xFE:
        return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9
    raise ValueError(f"invalid lenenc int prefix {first:#x}")


def read_lenenc_str(buf: bytes, pos: int):
    n, pos = read_lenenc_int(buf, pos)
    return buf[pos:pos + n], pos + n


def read_nul_str(buf: bytes, pos: int):
    end = buf.index(0, pos)
    return buf[pos:end], end + 1
