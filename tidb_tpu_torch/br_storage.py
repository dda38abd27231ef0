"""External storage abstraction for BR/dump/import (reference:
br/pkg/storage — the ExternalStorage interface with local / S3 / GCS /
Azure backends selected by URL scheme, storage.go ParseBackend).

Backends here:
- ``local://`` (or a bare path) — directory-backed files.
- ``memory://<bucket>`` — an in-process object store with the same
  write-whole-object semantics as the cloud backends (their test
  stand-in; process-lifetime persistence).
- ``s3://`` / ``gcs://`` / ``azure://`` — recognized and rejected with a
  configuration error: this build is zero-egress, and pretending to
  write to a bucket would corrupt someone's backup story. The interface
  boundary is exactly where a cloud SDK plugs in.

Every BR entry point routes file IO through this layer, so a backup
written to one backend restores from any other.
"""

from __future__ import annotations

import os
import threading

from .errors import TiDBError

_MEM_BUCKETS: dict[str, dict[str, bytes]] = {}
_MEM_MU = threading.Lock()


class ExternalStorage:
    """write/read whole objects + listing — the minimal surface BR needs
    (reference: br/pkg/storage/storage.go ExternalStorage)."""

    def write_file(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def read_file(self, name: str) -> bytes:
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> list:
        raise NotImplementedError

    def delete(self, name: str) -> None:
        raise NotImplementedError

    # text conveniences
    def write_text(self, name: str, text: str) -> None:
        self.write_file(name, text.encode("utf-8"))

    def read_text(self, name: str) -> str:
        return self.read_file(name).decode("utf-8")

    # streaming seam: big table payloads must not materialize wholesale
    # (reference: br streams SST/row batches). Defaults buffer through the
    # whole-object API; LocalStorage overrides with real files.
    # Publish-on-clean-exit: leaving the with-block on an exception must
    # NOT commit a truncated object over a previous good one (write_file's
    # atomic-publish contract). One parametrized wrapper serves the text
    # and bytes variants so the abort contract lives in one place.
    def _buffered_writer(self, io_cls, publish):
        class _Buf(io_cls):
            _aborted = False

            def __exit__(self, et, ev, tb):
                self._aborted = et is not None
                return super().__exit__(et, ev, tb)

            def close(self):
                if not self._aborted:
                    publish(self.getvalue())
                super().close()
        return _Buf()

    def open_write(self, name: str):
        import io as _io
        return self._buffered_writer(
            _io.StringIO, lambda s: self.write_text(name, s))

    def open_read(self, name: str):
        import io as _io
        return _io.StringIO(self.read_text(name))

    def open_write_bytes(self, name: str):
        import io as _io
        return self._buffered_writer(
            _io.BytesIO, lambda b: self.write_file(name, b))

    def open_read_bytes(self, name: str):
        import io as _io
        return _io.BytesIO(self.read_file(name))


class _PublishOnClose:
    """File proxy: atomic-publish on clean close, discard on aborted
    with-block."""

    def __init__(self, f, tmp, path):
        self._f, self._tmp, self._path = f, tmp, path
        self._aborted = False

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        self._aborted = et is not None
        self.close()
        return False

    def write(self, data):
        return self._f.write(data)

    def __getattr__(self, attr):
        return getattr(self._f, attr)

    def close(self):
        if self._f.closed:
            return
        self._f.close()
        if self._aborted:
            try:
                os.remove(self._tmp)
            except FileNotFoundError:
                pass
        else:
            os.replace(self._tmp, self._path)


class LocalStorage(ExternalStorage):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _p(self, name):
        return os.path.join(self.root, name)

    def write_file(self, name, data):
        path = self._p(name)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish, crash-safe partial writes

    def read_file(self, name):
        with open(self._p(name), "rb") as f:
            return f.read()

    def exists(self, name):
        return os.path.exists(self._p(name))

    def list(self, prefix=""):
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                if rel.startswith(prefix) and not rel.endswith(".tmp"):
                    out.append(rel)
        return sorted(out)

    def delete(self, name):
        try:
            os.remove(self._p(name))
        except FileNotFoundError:
            pass

    def _open_write_publish(self, name, mode):
        """Stream into name.tmp; os.replace to the final name ONLY on a
        clean close — a with-block unwinding on an exception discards the
        partial file instead of clobbering a previous good object. A
        wrapper class, not instance monkey-patching: `with` looks
        __exit__ up on the TYPE, so an instance attribute would never
        fire."""
        path = self._p(name)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        return _PublishOnClose(open(tmp, mode), tmp, path)

    def open_write(self, name):
        return self._open_write_publish(name, "w")

    def open_read(self, name):
        return open(self._p(name), "r")

    def open_write_bytes(self, name):
        return self._open_write_publish(name, "wb")

    def open_read_bytes(self, name):
        return open(self._p(name), "rb")


class MemStorage(ExternalStorage):
    """Bucket semantics without a network: whole-object puts, flat keys.
    Buckets are process-global so distinct open_storage() calls against
    the same URL see the same data (like a real object store would)."""

    def __init__(self, bucket: str):
        with _MEM_MU:
            self._objs = _MEM_BUCKETS.setdefault(bucket, {})

    def write_file(self, name, data):
        with _MEM_MU:
            self._objs[name] = bytes(data)

    def read_file(self, name):
        with _MEM_MU:
            if name not in self._objs:
                raise FileNotFoundError(name)
            return self._objs[name]

    def exists(self, name):
        with _MEM_MU:
            return name in self._objs

    def list(self, prefix=""):
        with _MEM_MU:
            return sorted(k for k in self._objs if k.startswith(prefix))

    def delete(self, name):
        with _MEM_MU:
            self._objs.pop(name, None)


def open_storage(url: str) -> ExternalStorage:
    """URL → backend (reference: br/pkg/storage ParseBackend)."""
    if url.startswith("local://"):
        return LocalStorage(url[len("local://"):])
    if url.startswith("memory://"):
        return MemStorage(url[len("memory://"):] or "default")
    for scheme in ("s3://", "gcs://", "gs://", "azure://", "azblob://"):
        if url.startswith(scheme):
            raise TiDBError(
                f"storage scheme {scheme} requires cloud credentials and "
                f"network egress, neither of which this deployment has; "
                f"use local:// or memory://, or plug an SDK-backed "
                f"ExternalStorage into br_storage.open_storage")
    return LocalStorage(url)  # bare path
