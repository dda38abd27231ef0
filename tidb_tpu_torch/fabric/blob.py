"""Object-store-shaped blob API for region replication.

Region checkpoints and sealed WAL tails replicate to a *blob store* so a
host loss becomes a region failover instead of data loss: the surviving
host restores checkpoint + tail from here and replays.  The interface is
deliberately the GCS/S3 shape — flat string names, whole-object put/get,
prefix list — so the local-directory implementation below can be swapped
for a real bucket later without touching the replication protocol.

Durability contract of :meth:`BlobStore.put` (the property the torn-
upload test pins): an object is visible under its final name only when
its bytes are complete — write to a temp name, fsync, then rename LAST.
A reader can therefore trust any listed object; a crash mid-upload
leaves at most an invisible temp file, never a short object.
"""

from __future__ import annotations

import os
import tempfile

from ..session import tracing


class BlobError(Exception):
    """A blob-store operation failed (missing object, bad name)."""


class BlobStore:
    """The object-store surface the region replicator codes against."""

    def put(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, name: str) -> bytes:
        raise NotImplementedError

    def list(self, prefix: str = "") -> "list[str]":
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def delete(self, name: str) -> None:
        raise NotImplementedError


class LocalDirBlobStore(BlobStore):
    """Blob store over a local directory ("/" in names maps to
    subdirectories).  put() is rename-last: tmp file + fsync +
    ``os.replace`` + directory fsync, so a SIGKILL mid-upload can never
    leave a torn object under its final name."""

    #: temp-upload prefix; never listed, swept lazily
    TMP_PREFIX = ".tmp-"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, name: str) -> str:
        if not name or name.startswith(("/", ".")) or ".." in name.split("/"):
            raise BlobError(f"bad blob name {name!r}")
        return os.path.join(self.root, *name.split("/"))

    def put(self, name: str, data: bytes) -> None:
        tracing.event("blob.put", blob=name, bytes=len(data))
        path = self._path(name)
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=self.TMP_PREFIX, dir=d)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # rename LAST: visibility == completeness
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        dirfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)

    def get(self, name: str) -> bytes:
        tracing.event("blob.get", blob=name)
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise BlobError(f"no such blob: {name}") from None

    def list(self, prefix: str = "") -> "list[str]":
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            base = "" if rel == "." else rel.replace(os.sep, "/") + "/"
            for fn in files:
                if fn.startswith(self.TMP_PREFIX):
                    continue  # an in-flight (or abandoned) upload
                name = base + fn
                if name.startswith(prefix):
                    out.append(name)
        out.sort()
        return out

    def exists(self, name: str) -> bool:
        return os.path.isfile(self._path(name))

    def delete(self, name: str) -> None:
        try:
            os.unlink(self._path(name))
        except FileNotFoundError:
            pass


def open_blob_store(url: str) -> BlobStore:
    """Factory: a plain path or ``file://`` URL opens the local-dir
    implementation; ``gs://`` / ``s3://`` are the same interface backed
    by a real bucket — not wired in this repo (no cloud SDK dependency),
    gated loudly rather than silently falling back."""
    if url.startswith("file://"):
        return LocalDirBlobStore(url[len("file://"):])
    if url.startswith(("gs://", "s3://")):
        raise NotImplementedError(
            f"remote blob store {url!r} needs a cloud SDK this build "
            "does not ship; use a local path (same BlobStore interface)")
    return LocalDirBlobStore(url)
