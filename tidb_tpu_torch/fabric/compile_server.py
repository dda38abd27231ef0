"""The separated compile server: one subprocess per host owns the
expensive builds for the whole fleet.

On the card the expensive build is the ``nvcc`` build of the kernel
library (``ops/kernels/build.py``), and every fleet worker on a fresh
tree would otherwise pay it.  The split of labor follows the
reference's (``tidb_tpu/fabric/compile_server.py``), with what a
compile is on the card:

    worker                          compile server
    ------                          --------------
    lib(): library missing
    ---- compile(library, digest) ->  build.build() into the artifact
                                      directory, once per digest
    <------------- ok ------------
    load it (shared directory), or
    ---- fetch(digest) ----------->   the library's bytes + sha256
    cold obtain of a fragment
    ---- compile(fragment, hash) ->   record the signature in the
                                      fleet's signature index
    <------------- ok ------------
    assemble the pipeline inline    (a sibling's obtain of the same
                                     signature is a persist hit)

The server NEVER initialises CUDA: ``nvcc`` needs no card, and every
CUDA context costs card memory.  ``stats`` reports
``torch.cuda.is_initialized()``.

Protocol: length-prefixed frames (fabric/codec.py) over a unix-domain
socket (or ``host:port`` TCP).  Ops: ``ping``, ``compile``, ``fetch``,
``stats``, ``shutdown``.  Every worker-side failure — dead socket, torn
frame, server-side build error — is CLASSIFIED (DeviceCompileError
9010 / transport) and walks the compile service's resilience ladder:
retry curve, compile-scoped breaker, degrade to an inline build.  The
server going away can slow builds down; it can never fail a query.

Run:  python -m tidb_tpu_torch.fabric.compile_server --socket /path/c.sock
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import logging
import os
import socket
import sys
import threading
import time

from . import codec

log = logging.getLogger("tidb_tpu_torch.fabric.compile_server")


def artifact_dir() -> "str | None":
    """Where the server builds the kernel library:
    ``TIDB_TPU_COMPILE_ARTIFACTS``, ``off`` for none, else the kernel
    build directory itself (so a worker of the same checkout loads the
    server's build in place)."""
    d = os.environ.get("TIDB_TPU_COMPILE_ARTIFACTS", "")
    if d == "off":
        return None
    if d:
        return d
    from ..ops.kernels import build
    return build.BUILD_DIR


def artifact_path(key_hash: str) -> "str | None":
    """The library of source digest `key_hash` in the artifact
    directory."""
    d = artifact_dir()
    if d is None:
        return None
    from ..ops.kernels import build
    return build.library_path(d, key_hash)


def load_artifact(key_hash: str) -> "bytes | None":
    path = artifact_path(key_hash)
    if path is None:
        return None
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


class CompileServer:
    """The serving loop.  One thread per connection; builds serialize
    through one lock (an nvcc build takes every core anyway, and one at a
    time keeps one build per digest)."""

    def __init__(self, address: str):
        self.address = address
        self._compile_lock = threading.Lock()
        self._stop = threading.Event()
        self.stats = {"compiles": 0, "compile_s": 0.0, "fetches": 0,
                      "errors": 0, "pings": 0, "dedup_served": 0,
                      # the kernel library: nvcc builds this server ran,
                      # their seconds, and requests it found built
                      "builds": 0, "build_s": 0.0, "artifact_hits": 0}
        self._known: dict = {}  # fragment key_hash -> recorded
        self._sock = self._bind(address)

    @staticmethod
    def _bind(address: str):
        if ":" in address:
            host, port = address.rsplit(":", 1)
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, int(port)))
        else:
            with contextlib.suppress(OSError):
                os.unlink(address)
            os.makedirs(os.path.dirname(address) or ".", exist_ok=True)
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.bind(address)
            os.chmod(address, 0o600)
        s.listen(64)
        return s

    @property
    def port(self) -> int:
        if self._sock.family == socket.AF_INET:
            return self._sock.getsockname()[1]
        return 0

    def serve_forever(self):
        self._sock.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
        with contextlib.suppress(OSError):
            self._sock.close()

    def start(self) -> "CompileServer":
        threading.Thread(target=self.serve_forever, daemon=True,
                         name="compile-server-accept").start()
        return self

    def shutdown(self):
        self._stop.set()
        with contextlib.suppress(OSError):
            self._sock.close()

    # -- per-connection loop -------------------------------------------------

    def _serve_conn(self, conn):
        from ..session import tracing
        with contextlib.suppress(Exception), conn:
            while True:
                try:
                    req = codec.read_frame(conn)
                except codec.FrameError:
                    return  # torn frame / disconnect: drop the conn
                # record this hop into OUR ring on behalf of the caller's
                # trace (one branch when the request carries no context)
                rtr = tracing.begin_remote(
                    req.pop("trace", None),
                    f"compile_server.{req.get('op', '?')}")
                try:
                    resp = self._handle(req)
                except Exception as e:  # noqa: BLE001 — reply, never die
                    self.stats["errors"] += 1
                    log.warning("compile server: %s failed: %s",
                                req.get("op"), e, exc_info=True)
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                sub = tracing.finish_remote(rtr, succ=bool(resp.get("ok")))
                if sub is not None:
                    resp["_trace"] = sub
                codec.write_frame(conn, resp)
                if req.get("op") == "shutdown":
                    self.shutdown()
                    return

    def _handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            self.stats["pings"] += 1
            return {"ok": True, "pid": os.getpid(),
                    "compiles": self.stats["compiles"]}
        if op == "stats":
            import torch
            return {"ok": True, **self.stats, "known": len(self._known),
                    "cuda_initialized": torch.cuda.is_initialized()}
        if op == "compile":
            if req.get("kind") == "library":
                return self._build_library(req)
            return self._compile(req)
        if op == "fetch":
            self.stats["fetches"] += 1
            blob = load_artifact(req["key_hash"])
            if blob is None:
                return {"ok": True, "found": False}
            return {"ok": True, "found": True, "module": blob,
                    "sha256": hashlib.sha256(blob).hexdigest()}
        if op == "shutdown":
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _compile(self, req: dict) -> dict:
        """Record a fragment signature in the fleet's index (the
        compile service's ``_persist_lookup`` keys by the same hash), so
        a worker restart or a sibling sees it as built."""
        from ..session import tracing
        key_hash = str(req["key_hash"])
        if not key_hash or not all(c in "0123456789abcdef"
                                   for c in key_hash):
            raise ValueError(f"malformed signature hash {key_hash!r}")
        with self._compile_lock:
            if key_hash in self._known:
                # fleet-wide dedup: N workers racing the same cold
                # signature record it ONCE
                self.stats["dedup_served"] += 1
                tracing.event("compile.dedup", key=key_hash[:12])
                return {"ok": True, "compile_s": 0.0, "dedup": True}
            t0 = time.perf_counter()
            _record_index(key_hash, req.get("shape", ""),
                          req.get("sig", ""))
            elapsed = time.perf_counter() - t0
            self._known[key_hash] = elapsed
            self.stats["compiles"] += 1
            self.stats["compile_s"] += elapsed
        return {"ok": True, "compile_s": elapsed}

    def _build_library(self, req: dict) -> dict:
        """Build the kernel library of this checkout into the artifact
        directory, once per digest: a request for a built digest is an
        artifact hit."""
        from ..ops.kernels import build
        digest = str(req.get("digest", ""))
        mine = build._digest()
        if digest != mine:
            raise ValueError(f"library digest {digest!r} is not this "
                             f"server's sources ({mine})")
        d = artifact_dir()
        if d is None:
            raise ValueError("compile artifacts are off "
                             "(TIDB_TPU_COMPILE_ARTIFACTS=off)")
        with self._compile_lock:
            path = build.library_path(d)
            if os.path.exists(path):
                self.stats["artifact_hits"] += 1
                return {"ok": True, "path": path, "built": False,
                        "build_s": 0.0}
            t0 = time.perf_counter()
            build.build(out_dir=d)
            elapsed = time.perf_counter() - t0
            self.stats["builds"] += 1
            self.stats["build_s"] += elapsed
        return {"ok": True, "path": path, "built": True,
                "build_s": elapsed}


def _record_index(key_hash: str, shape: str, sig: str):
    """Write the signature-index entry the compile service reads."""
    from ..executor.compile_service import _persist_dir, _write_index_entry
    d = _persist_dir()
    if d is None:
        return
    try:
        _write_index_entry(d, key_hash, shape, str(sig), "compile-server")
    except OSError:
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--socket", required=True,
                    help="unix socket path, or host:port")
    args = ap.parse_args(argv)
    import tidb_tpu_torch  # noqa: F401
    from tidb_tpu_torch.session import tracing
    tracing.set_process_label("compile-server")
    srv = CompileServer(args.socket)
    print(json.dumps({"metric": "compile_server_ready",
                      "pid": os.getpid(), "address": args.socket,
                      "port": srv.port}), flush=True)
    import signal

    def _stop(_sig, _frm):
        srv.shutdown()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
