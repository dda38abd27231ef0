"""Worker-side client of the separated compile server.

Two things cross the socket (``fabric/compile_server.py``):

* **the kernel library** (:func:`library_from_server`): where the
  server's artifact directory is not the worker's kernel build
  directory, a fleet worker asks the server for the library before it
  first loads it; the server builds it once per source digest and the
  worker fetches its bytes (checked against their sha256).  Where the
  two directories are one (the default), the build's own ``fcntl`` lock
  already makes the fleet run ``nvcc`` once, and nothing is asked;
* **fragment signatures** (:meth:`CompileClient.serve`): a cold pipeline
  resolution records its signature on the server, which writes it into
  the fleet's signature index, so a sibling or a restarted worker finds
  it there (``compile_persist_hits``).  A port pipeline is a Python
  closure over the library's kernels, so there is no module to ship:
  the worker assembles it inline in milliseconds.  The reference's
  StableHLO export (``export_pipeline`` / ``wrap_exported``) has no
  counterpart.

Failure discipline (the reference's): the client NEVER raises out of
``serve`` or ``library`` — a dead socket, torn frame or server-side
error returns a classified error (``serve``) or False (``library``) so
the caller builds inline; a down-window then short-circuits further
attempts for a few seconds so a dead server costs one timeout, not one
per fragment.  The remote failure is counted (``fabric_remote_errors``)
but not charged to the compile-scoped breaker (9010), which the
reference charges: here the server builds nothing a fragment needs, so
its death must not move work off the card.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import socket
import threading
import time

from . import codec

log = logging.getLogger("tidb_tpu_torch.fabric.compile_client")

#: how long a transport failure silences remote attempts (the breaker's
#: cooldown shapes query-visible behavior; this just stops re-dialing a
#: dead socket on every obtain in between)
DOWN_COOLDOWN_S = 5.0
CONNECT_TIMEOUT_S = 5.0
#: per-request bound — the library build is the slow request (the
#: parallel nvcc build of every kernel source)
REQUEST_TIMEOUT_S = 300.0
#: a fragment signature's round trip (the server only writes an entry)
SIGNATURE_TIMEOUT_S = 10.0

_LOCK = threading.Lock()
_CLIENTS: dict = {}


def get_client(address: "str | None" = None) -> "CompileClient | None":
    """The process's client for `address` (default: the fabric state's
    compile-server address), or None when no server is configured."""
    if address is None:
        from . import state
        address = state.compile_server_addr()
    if not address:
        return None
    with _LOCK:
        cli = _CLIENTS.get(address)
        if cli is None:
            cli = _CLIENTS[address] = CompileClient(address)
        return cli


class CompileClient:
    def __init__(self, address: str,
                 down_cooldown_s: float = DOWN_COOLDOWN_S):
        self.address = address
        self._down_until = 0.0
        self._down_cooldown = down_cooldown_s
        self._mu = threading.Lock()

    def healthy(self) -> bool:
        return time.monotonic() >= self._down_until

    def _mark_down(self):
        self._down_until = time.monotonic() + self._down_cooldown

    def _connect(self):
        if ":" in self.address:
            host, port = self.address.rsplit(":", 1)
            return socket.create_connection((host, int(port)),
                                            timeout=CONNECT_TIMEOUT_S)
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(CONNECT_TIMEOUT_S)
        s.connect(self.address)
        return s

    def request(self, obj: dict, timeout_s: float = REQUEST_TIMEOUT_S):
        """One round trip.  Raises DeviceCompileError (errno 9010,
        taxonomy class ``compile``) on any transport/frame/server
        failure — the caller classifies and counts exactly that."""
        from ..errors import DeviceCompileError
        from ..session import tracing
        from . import state
        ctx = tracing.wire_ctx()
        if ctx is not None:  # propagate the statement's trace across the hop
            obj["trace"] = ctx
        t0 = time.perf_counter()
        try:
            with self._mu:  # one in-flight request per client: the
                #             server serializes builds anyway
                sock = self._connect()
                try:
                    sock.settimeout(timeout_s)
                    codec.write_frame(sock, obj)
                    resp = codec.read_frame(sock)
                finally:
                    with contextlib.suppress(OSError):
                        sock.close()
        except (OSError, codec.FrameError) as e:
            self._mark_down()
            state.bump("fabric_remote_errors")
            raise DeviceCompileError(
                f"compile server {self.address} unreachable/torn: "
                f"{type(e).__name__}: {e}") from e
        state.note_rtt((time.perf_counter() - t0) * 1000.0)
        # stitch the server's recorded subtree (attached even on a
        # server-side error reply: the failed hop still belongs in the
        # statement's timeline)
        tracing.attach_remote(resp.pop("_trace", None))
        if not resp.get("ok"):
            state.bump("fabric_remote_errors")
            raise DeviceCompileError(
                f"compile server {self.address} failed the request: "
                f"{resp.get('error', 'unknown error')}")
        return resp

    def ping(self, timeout_s: float = 5.0) -> dict:
        return self.request({"op": "ping"}, timeout_s=timeout_s)

    # -- the pipeline-resolution entry ---------------------------------------

    def serve(self, key, build, spec, shape: str, sig) -> tuple:
        """Record one cold pipeline's signature in the fleet's index:
        ``(None, None)`` when the server recorded it (or knew it) and
        when the client is in its down-window — the caller assembles the
        pipeline inline either way — and ``(None, classified_error)``
        when the remote path failed (the caller still builds inline and
        records it).  `build` and `spec` are the
        reference's arguments; nothing of them crosses the socket."""
        from ..executor.compile_service import _persist_hash
        from ..session import tracing
        from . import state
        if not self.healthy():
            return None, None
        try:
            with tracing.span("compile.remote", shape=shape):
                resp = self.request(
                    {"op": "compile", "kind": "fragment",
                     "key_hash": _persist_hash(key), "shape": shape,
                     "sig": repr(sig)[:512]},
                    timeout_s=SIGNATURE_TIMEOUT_S)
        except Exception as e:  # noqa: BLE001 — classified DeviceCompileError
            return None, e
        if resp.get("dedup"):
            state.bump("fabric_artifact_hits")
            tracing.event("fabric.compile", mode="index")
        else:
            state.bump("fabric_remote_compiles")
            tracing.event("fabric.compile", mode="remote")
        return None, None

    # -- the kernel library --------------------------------------------------

    def library(self, digest: str, dest: str) -> bool:
        """Have the server build the kernel library of source digest
        `digest` (once per digest, fleet-wide) and put it at `dest`:
        True when `dest` now holds it — the server built it into this
        process's build directory, or its bytes were fetched and matched
        their sha256.  False (never raises) when the server is down or
        failed: the caller then runs nvcc itself."""
        from . import state
        if not self.healthy():
            return False
        try:
            self.request({"op": "compile", "kind": "library",
                          "digest": digest})
            if os.path.exists(dest):
                state.bump("fabric_artifact_hits")
                return True
            resp = self.request({"op": "fetch", "key_hash": digest},
                                timeout_s=60.0)
            if not resp.get("found"):
                return False
            blob = bytes(resp["module"])
            if hashlib.sha256(blob).hexdigest() != resp.get("sha256"):
                raise ValueError("library bytes do not match their sha256")
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            tmp = f"{dest}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, dest)
            state.bump("fabric_artifact_hits")
            return True
        except Exception as e:  # noqa: BLE001 — remote is an optimization
            log.warning("kernel library from the compile server failed "
                        "(building locally): %s", e)
            return False


def library_from_server() -> bool:
    """A fleet worker's first step before it loads the kernel library:
    True when the configured compile server handed the library over
    (``build.STATS["from_server"]``).  Asks nothing where no server is
    configured, the library is here already, or the server's artifact
    directory is this process's build directory (there the build lock
    makes one nvcc run fleet-wide)."""
    from ..ops.kernels import build
    from .compile_server import artifact_dir
    cli = get_client()
    art = artifact_dir()
    dest = build.library_path()
    if (cli is None or art is None or os.path.exists(dest)
            or os.path.realpath(art) == os.path.realpath(build.BUILD_DIR)):
        return False
    if not cli.library(build._digest(), dest):
        return False
    build.STATS["from_server"] += 1
    return True


def reset_for_tests():
    with _LOCK:
        _CLIENTS.clear()
