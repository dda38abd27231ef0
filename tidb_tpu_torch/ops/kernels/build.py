"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with its own ``nvcc`` process (all started
together), and one ``nvcc -shared`` links the objects into a shared
library with a plain C interface, loaded with ctypes.  The library's name
carries a hash of the sources, so an edited kernel never loads a stale
build.  The build directory (``build/`` beside this file) is git-ignored;
the first caller on a machine with the CUDA toolkit builds it, and later
callers load it.  An ``fcntl`` lock on ``build/.build.lock`` makes two
processes on one fresh tree run ``nvcc`` once: the second waits and
loads the first one's library.

Run ``python -m tidb_tpu_torch.ops.kernels.build`` to build ahead of
time and print the compiler's register and shared-memory report.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

#: Hopper with its architecture-specific features (the ``a`` keeps
#: wgmma/setmaxnreg available to later kernels)
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_LOCK = threading.Lock()
_LIB = [None]

#: this process's library builds: how many ran nvcc and their seconds,
#: and how many times a fleet's compile server handed the library over
#: instead (``fabric/compile_client.py library_from_server``)
STATS = {"nvcc_runs": 0, "nvcc_s": 0.0, "from_server": 0}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def sources() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def _headers() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cuh"))


def _digest() -> str:
    h = hashlib.sha1()
    for p in _headers() + sources():
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def nvcc_path() -> str:
    cand = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cand.append(os.path.join(home, "bin", "nvcc"))
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put the CUDA "
                           "toolkit's bin/ on PATH)")


def library_path(out_dir: "str | None" = None,
                 digest: "str | None" = None) -> str:
    return os.path.join(out_dir or BUILD_DIR,
                        f"libtidb_kernels_{digest or _digest()}.so")


def build(force: bool = False, out_dir: "str | None" = None) -> str:
    """Compile every source in parallel and link them into `out_dir`
    (default ``build/``); returns the library path.  Writes each
    compiler's output to ``<out_dir>/<name>.log``.  Holds an ``fcntl``
    lock on ``<out_dir>/.build.lock`` while it builds, so a concurrent
    build of the same tree waits and finds the library made."""
    out_dir = out_dir or BUILD_DIR
    out = library_path(out_dir)
    if os.path.exists(out) and not force:
        return out
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".build.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(out) and not force:
            return out
        t0 = time.perf_counter()
        _build_locked(out_dir, out)
        STATS["nvcc_runs"] += 1
        STATS["nvcc_s"] += time.perf_counter() - t0
    return out


def _build_locked(out_dir: str, out: str):
    nvcc = nvcc_path()
    tmpdir = tempfile.mkdtemp(prefix="obj-", dir=out_dir)
    try:
        procs = []
        for src in sources():
            name = os.path.splitext(os.path.basename(src))[0]
            obj = os.path.join(tmpdir, name + ".o")
            cmd = ([nvcc] + ARCH_FLAGS + NVCC_FLAGS
                   + ["-I", CSRC, "-c", src, "-o", obj])
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, _obj, p in procs:
            text = p.communicate()[0].decode(errors="replace")
            with open(os.path.join(out_dir, name + ".log"), "w") as f:
                f.write(text)
            if p.returncode != 0:
                errors.append(f"--- {name}.cu (exit {p.returncode})\n{text}")
        if errors:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
        fd, tmp_so = tempfile.mkstemp(suffix=".so.tmp", dir=out_dir)
        os.close(fd)
        cmd = ([nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp_so]
               + [obj for _n, obj, _p in procs])
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            os.unlink(tmp_so)
            raise KernelBuildError("nvcc link failed:\n" + r.stdout
                                   + r.stderr)
        os.rename(tmp_so, out)  # atomic: no process loads a partial file
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    with _LOCK:
        if _LIB[0] is None:
            _LIB[0] = ctypes.CDLL(build())
        return _LIB[0]


def declare(name: str, n_args: int, int_args=()) -> "ctypes._CFuncPtr":
    """Look up C function `name` and declare its arguments: every
    argument is a ``c_void_p`` (pointers and the stream) except the
    positions in `int_args`, which are ``c_longlong``; returns int (a
    ``cudaError_t``)."""
    fn = getattr(lib(), name)
    fn.argtypes = [ctypes.c_longlong if i in int_args else ctypes.c_void_p
                   for i in range(n_args)]
    fn.restype = ctypes.c_int
    return fn


def raw_stream(dev) -> int:
    """The current CUDA stream of `dev` (a device with its index) as an
    int ``cudaStream_t``: torch's raw getter where the build has it (a
    fraction of ``torch.cuda.current_stream``'s host time), else the
    public call."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


#: calls of the library's launchers by (C function, card index), counted
#: in :func:`launch`: which cards a run's kernels ran on
CARD_LAUNCHES: "collections.Counter" = collections.Counter()


def launch(dev, fn, *args) -> int:
    """Call the launcher `fn` (a function of :func:`lib`) with `dev` the
    calling thread's current CUDA device, whatever the thread's own is,
    and return its ``cudaError_t``.  A launcher launches on the current
    device and sizes its grid from it, so a kernel on tensors of another
    card runs there; the thread's device is set back after the call.
    The device is switched only when it differs (one ``cudaGetDevice``
    otherwise)."""
    idx = dev.index
    CARD_LAUNCHES[(fn.__name__, idx)] += 1
    cur = torch.cuda.current_device()
    if idx is None or idx == cur:
        return fn(*args)
    torch.cuda.set_device(idx)
    try:
        return fn(*args)
    finally:
        torch.cuda.set_device(cur)


def check(rc: int, what: str):
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if rc != 0:
        f = lib().tidb_cuda_error_string
        f.argtypes = [ctypes.c_int]
        f.restype = ctypes.c_char_p
        raise RuntimeError(f"CUDA kernel {what} failed: error {rc} "
                           f"({f(int(rc)).decode()})")


if __name__ == "__main__":
    t0 = time.perf_counter()
    path = build(force=True)
    print(f"built {path} in {time.perf_counter() - t0:.1f}s")
    for src in sources():
        name = os.path.splitext(os.path.basename(src))[0]
        with open(os.path.join(BUILD_DIR, name + ".log")) as f:
            print(f"--- {name}\n{f.read()}")
