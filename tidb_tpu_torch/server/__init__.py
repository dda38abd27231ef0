"""MySQL wire protocol server (reference: server/ — protocol at conn.go,
packet framing at packetio.go, resultset encode at conn.go:2096)."""

from .server import MySQLServer

__all__ = ["MySQLServer"]
