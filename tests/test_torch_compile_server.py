"""The port's separated compile server (``tidb_tpu_torch/fabric/
compile_server.py`` and ``compile_client.py``), against the cases of
tests/test_compile_server.py:

* the frame codec, every case run on both packages' codecs with the
  same bytes and the same outcome;
* the protocol in process: ping and stats (``cuda_initialized`` false),
  the kernel library built once per digest into the artifact directory
  and fetched bit for bit with its sha256, a fragment signature recorded
  in the index once (a second client is a dedup), a server-side error
  classified (DeviceCompileError 9010) with the server still serving, a
  dead socket classified with its down-window; a worker asks for the
  library only where its build directory is not the server's artifact
  directory;
* two worker processes against a server process: the second finds the
  first one's signature in the shared index (persist hits) and both
  return the host engine's rows, which equal the reference's; a dead
  server degrades to inline builds with rows intact, fragments stay on
  the device engine and the compile breaker stays closed (the
  reference charges that breaker);
* the library build's lock: two processes building one fresh tree run
  nvcc once.

There is no nvcc here, so a fake ``nvcc`` (a script that writes its
``-o`` file and logs its command line) stands in for the compiler; the
server and the lock see only its outputs.  The reference's zero-traces
second worker has no counterpart: a port pipeline is a closure each
process assembles (milliseconds), so what a sibling reuses is the
library and the signature index, not a traced module.  Every subprocess
has its own timeout.
"""

import hashlib
import io
import json
import os
import pickle
import struct
import subprocess
import sys
import textwrap
import time

import pytest

import tidb_tpu.fabric.codec as rcodec
import tidb_tpu_torch.fabric.codec as pcodec
from tidb_tpu_torch.ops.kernels import build
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import os, sys
    log = os.environ.get("FAKE_NVCC_LOG")
    if log:
        with open(log, "a") as f:
            f.write(" ".join(sys.argv[1:]) + "\\n")
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(out, "wb") as f:
        f.write(b"object of " + " ".join(sys.argv[1:]).encode())
    print("ptxas info    : 0 bytes stack frame, 0 bytes spill stores")
    """)


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc first on PATH; returns its log's path."""
    bindir = tmp_path / "fakebin"
    bindir.mkdir()
    p = bindir / "nvcc"
    p.write_text(FAKE_NVCC.format(python=sys.executable))
    p.chmod(0o755)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    return log


def _nvcc_runs(log) -> int:
    """How many library builds a fake-nvcc log holds (one link each)."""
    if not os.path.exists(log):
        return 0
    with open(log) as f:
        return sum(" -shared " in f" {line} " for line in f)


# -- the frame codec, on both packages ----------------------------------------

def _codec_both(fn):
    got = {}
    for name, codec in (("ref", rcodec), ("port", pcodec)):
        try:
            got[name] = ("ok", fn(codec))
        except Exception as e:  # noqa: BLE001 — the outcome is the record
            got[name] = (type(e).__name__, str(e))
    assert got["port"] == got["ref"], got
    return got["port"]


class TestFrameCodec:
    def test_roundtrip(self):
        obj = {"op": "compile", "module": b"\x00\x01" * 100, "n": 7}
        out = _codec_both(lambda c: c.read_frame(io.BytesIO(
            c.frame_bytes(obj))))
        assert out == ("ok", obj)
        assert pcodec.frame_bytes(obj) == rcodec.frame_bytes(obj)

    @pytest.mark.parametrize("cut", [1, 4, 7, 9])
    def test_torn_frame_raises_loud(self, cut):
        out = _codec_both(lambda c: c.read_frame(io.BytesIO(
            c.frame_bytes({"op": "ping"})[:cut])))
        assert out[0] == "FrameError"
        assert "short read" in out[1] or " of " in out[1]

    def test_short_read_mid_payload(self):
        out = _codec_both(lambda c: c.read_frame(io.BytesIO(
            c.frame_bytes({"op": "x", "blob": b"y" * 1000})[:-100])))
        assert out[0] == "FrameError" and "short read" in out[1]

    def test_bad_magic(self):
        out = _codec_both(lambda c: c.read_frame(io.BytesIO(
            b"NOPE" + c.frame_bytes({"op": "ping"})[4:])))
        assert out[0] == "FrameError" and "magic" in out[1]

    def test_oversized_length_rejected_before_allocation(self):
        out = _codec_both(lambda c: c.read_frame(io.BytesIO(
            struct.pack("!4sI", c.MAGIC, c.MAX_FRAME + 1))))
        assert out[0] == "FrameError" and "exceeds" in out[1]

    def test_non_dict_payload_rejected(self):
        payload = pickle.dumps([1, 2, 3])
        out = _codec_both(lambda c: c.read_frame(io.BytesIO(
            struct.pack("!4sI", c.MAGIC, len(payload)) + payload)))
        assert out[0] == "FrameError" and "expected dict" in out[1]


# -- the protocol, in process -------------------------------------------------

class TestServerProtocol:
    @pytest.fixture()
    def server(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TIDB_TPU_COMPILE_ARTIFACTS",
                           str(tmp_path / "artifacts"))
        monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", str(tmp_path / "idx"))
        from tidb_tpu_torch.fabric.compile_server import CompileServer
        srv = CompileServer(str(tmp_path / "c.sock")).start()
        yield srv
        srv.shutdown()

    def _client(self, server):
        from tidb_tpu_torch.fabric.compile_client import CompileClient
        return CompileClient(server.address)

    def test_ping_and_stats(self, server):
        cli = self._client(server)
        assert cli.ping()["ok"]
        st = cli.request({"op": "stats"})
        assert st["ok"] and st["pings"] == 1
        assert st["builds"] == st["artifact_hits"] == 0
        assert st["cuda_initialized"] is False

    def test_library_build_fetch_roundtrip_bit_exact(self, server,
                                                     tmp_path, fake_nvcc):
        """The library is built once per digest into the artifact
        directory; a client whose build directory is elsewhere fetches
        its bytes, checked against their sha256; a second client (another
        worker) is an artifact hit with no second build."""
        digest = build._digest()
        art = build.library_path(str(tmp_path / "artifacts"))
        dest = str(tmp_path / "w1" / os.path.basename(art))
        cli = self._client(server)
        assert cli.library(digest, dest)
        with open(art, "rb") as f:
            built = f.read()
        with open(dest, "rb") as f:
            assert f.read() == built
        assert _nvcc_runs(fake_nvcc) == 1
        resp = cli.request({"op": "fetch", "key_hash": digest})
        assert resp["found"] and resp["module"] == built
        assert resp["sha256"] == hashlib.sha256(built).hexdigest()
        dest2 = str(tmp_path / "w2" / os.path.basename(art))
        assert self._client(server).library(digest, dest2)
        with open(dest2, "rb") as f:
            assert f.read() == built
        st = cli.request({"op": "stats"})
        assert (st["builds"], st["artifact_hits"]) == (1, 1)
        assert _nvcc_runs(fake_nvcc) == 1  # the fleet paid nvcc once
        assert st["cuda_initialized"] is False
        # a digest of other sources is refused, classified
        assert not cli.library("0" * 12, str(tmp_path / "w3" / "x.so"))

    def test_worker_asks_for_the_library_only_from_another_dir(
            self, server, tmp_path, fake_nvcc, monkeypatch):
        """A fleet worker whose build directory is not the server's
        artifact directory fetches the server's library bit for bit
        before it loads it (one nvcc run fleet-wide); once it has the
        library, or where the two directories are one (the build's lock
        then makes one nvcc run), it asks nothing."""
        from tidb_tpu_torch.fabric import compile_client
        monkeypatch.setenv("TIDB_TPU_COMPILE_SERVER", server.address)
        monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "worker"))
        compile_client.reset_for_tests()
        got0 = build.STATS["from_server"]
        try:
            assert compile_client.library_from_server()
            art = build.library_path(str(tmp_path / "artifacts"))
            with open(build.library_path(), "rb") as f, \
                    open(art, "rb") as g:
                assert f.read() == g.read()
            assert build.STATS["from_server"] == got0 + 1
            assert not compile_client.library_from_server()
            shared = str(tmp_path / "shared")
            monkeypatch.setattr(build, "BUILD_DIR", shared)
            monkeypatch.setenv("TIDB_TPU_COMPILE_ARTIFACTS", shared)
            assert not compile_client.library_from_server()
            assert not os.path.exists(shared)
            assert _nvcc_runs(fake_nvcc) == 1
            st = self._client(server).request({"op": "stats"})
            assert (st["builds"], st["artifact_hits"]) == (1, 0)
        finally:
            compile_client.reset_for_tests()

    def test_signature_recorded_once_in_the_index(self, server, tmp_path):
        from tidb_tpu_torch.executor import compile_service as pcs
        from tidb_tpu_torch.fabric import state
        key = ("proto-key", 64, ((4, 0),), ("sum",))
        assert not pcs._persist_lookup(key)
        r0 = dict(state.STATS)
        assert self._client(server).serve(key, None, None, "agg",
                                          "sig") == (None, None)
        assert pcs._persist_lookup(key)
        entry = json.loads((tmp_path / "idx" / (
            pcs._persist_hash(key) + ".json")).read_text())
        assert entry["origin"] == "compile-server"
        assert entry["shape"] == "agg"
        # a second client (another worker): the server knew it
        assert self._client(server).serve(key, None, None, "agg",
                                          "sig") == (None, None)
        st = self._client(server).request({"op": "stats"})
        assert (st["compiles"], st["dedup_served"], st["known"]) == (1, 1, 1)
        assert state.STATS["fabric_remote_compiles"] \
            == r0["fabric_remote_compiles"] + 1
        assert state.STATS["fabric_artifact_hits"] \
            == r0["fabric_artifact_hits"] + 1

    def test_server_side_error_is_classified_not_fatal(self, server):
        from tidb_tpu_torch.errors import DeviceCompileError
        cli = self._client(server)
        with pytest.raises(DeviceCompileError):
            cli.request({"op": "compile", "key_hash": "zz",
                         "module": b"not a module", "shape": "agg",
                         "sig": ""})
        # the server survives a poisoned request
        assert cli.ping()["ok"]
        assert cli.request({"op": "stats"})["errors"] == 1

    def test_dead_socket_classified_and_down_window(self, tmp_path):
        from tidb_tpu_torch.errors import DeviceCompileError
        from tidb_tpu_torch.fabric.compile_client import CompileClient
        cli = CompileClient(str(tmp_path / "nobody.sock"))
        fn, err = cli.serve(("k",), lambda: None, None, "agg", "")
        assert fn is None and err is not None
        assert isinstance(err, DeviceCompileError)
        assert err.code == 9010
        assert not cli.healthy()
        # inside the down-window: no dial, quiet inline fallback
        fn2, err2 = cli.serve(("k2",), lambda: None, None, "agg", "")
        assert fn2 is None and err2 is None
        assert not cli.library(build._digest(), str(tmp_path / "x.so"))


# -- the library build's lock --------------------------------------------------

_BUILD = ("import sys; sys.path.insert(0, {repo!r}); "
          "from tidb_tpu_torch.ops.kernels import build; "
          "print(build.build(out_dir={out!r})); print(build.STATS)")


def test_two_processes_build_one_fresh_tree_once(tmp_path, fake_nvcc):
    """Two processes that build the same fresh tree at once: nvcc runs
    for one of them; the other waits on the lock and finds the library.
    The digest and the atomic rename are unchanged."""
    out = str(tmp_path / "kb")
    code = _BUILD.format(repo=REPO, out=out)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].splitlines() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert {o[0] for o in outs} == {build.library_path(out)}
    runs = sorted(eval(o[1])["nvcc_runs"] for o in outs)  # noqa: S307
    assert runs == [0, 1]
    assert _nvcc_runs(fake_nvcc) == 1
    assert not [f for f in os.listdir(out)
                if f.endswith(".tmp") or f.startswith("obj-")]


# -- separated processes ------------------------------------------------------

#: worker workload: one scan-agg query on the device engine (the plain
#: kernels on the CPU) and the host engine, with the counters
_WORKLOAD = r"""
import json, sys
from tidb_tpu_torch.ops import device
device.set_device("cpu")
from tidb_tpu_torch.testkit import TestKit
from tidb_tpu_torch.executor import compile_service
from tidb_tpu_torch.executor.device_exec import pipe_cache_stats
from tidb_tpu_torch.fabric import state as fabric_state
from tidb_tpu_torch.ops.kernels import build

tk = TestKit()
tk.must_exec("use test")
tk.must_exec("create table w (id int primary key, g int, v int)")
rows = ",".join(f"({i},{i%7},{(i*13)%101})" for i in range(300))
tk.must_exec(f"insert into w values {rows}")
tk.must_exec("analyze table w")
q = "select g, sum(v), count(*) from w group by g order by g"
tk.must_exec("set tidb_executor_engine = 'host'")
host = [[str(c) for c in r] for r in tk.must_query(q).rows]
tk.must_exec("set tidb_executor_engine = 'tpu'")
dev = [[str(c) for c in r] for r in tk.must_query(q).rows]
ps = pipe_cache_stats()
cs = compile_service.snapshot()
fs = fabric_state.STATS
print(json.dumps({
    "rows": dev, "host": host,
    "traces": ps["traces"] + ps["bg_traces"],
    "sync_compiles": cs["sync_compiles"],
    "persist_hits": cs["compile_persist_hits"],
    "remote_compiles": fs["fabric_remote_compiles"],
    "artifact_hits": fs["fabric_artifact_hits"],
    "remote_errors": fs["fabric_remote_errors"],
    "nvcc_runs": build.STATS["nvcc_runs"],
    "breaker": {s: b.snapshot()["state"] for s, b in
                getattr(tk.domain, "_device_breakers", {}).items()},
}))
"""


def _run_worker(tmp_path, server_addr, timeout=240):
    out = subprocess.run(
        [sys.executable, "-c", _WORKLOAD],
        env={**os.environ, "PYTHONPATH": REPO,
             "TIDB_TPU_COMPILE_INDEX": str(tmp_path / "idx"),
             "TIDB_TPU_COMPILE_SERVER": str(server_addr)},
        capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _reference_rows():
    from tidb_tpu.testkit import TestKit as RefKit
    tk = RefKit()
    tk.must_exec("use test")
    tk.must_exec("create table w (id int primary key, g int, v int)")
    rows = ",".join(f"({i},{i%7},{(i*13)%101})" for i in range(300))
    tk.must_exec(f"insert into w values {rows}")
    tk.must_exec("set tidb_executor_engine = 'host'")
    return [[str(c) for c in r] for r in tk.must_query(
        "select g, sum(v), count(*) from w group by g order by g").rows]


@pytest.mark.chaos_threads
class TestSeparatedCompileServer:
    def _spawn_server(self, tmp_path):
        sock = str(tmp_path / "compile.sock")
        proc = subprocess.Popen(
            [sys.executable, "-m", "tidb_tpu_torch.fabric.compile_server",
             "--socket", sock],
            env={**os.environ, "PYTHONPATH": REPO,
                 "TIDB_TPU_COMPILE_INDEX": str(tmp_path / "idx"),
                 "TIDB_TPU_COMPILE_ARTIFACTS": str(tmp_path / "art")},
            stdout=subprocess.PIPE, text=True)
        ready = proc.stdout.readline()
        assert json.loads(ready)["metric"] == "compile_server_ready"
        return proc, sock

    def test_second_worker_starts_warm(self, tmp_path):
        """Worker 1 builds and the server records its signature; worker
        2 finds it in the shared index (a persist hit: an inline build
        even where async would defer), and the server dedups its record.
        Rows equal the host engine's and the reference's."""
        ref = _reference_rows()
        proc, sock = self._spawn_server(tmp_path)
        try:
            w1 = _run_worker(tmp_path, sock)
            assert w1["rows"] == w1["host"] == ref
            assert w1["remote_compiles"] >= 1, w1
            assert w1["remote_errors"] == 0, w1
            assert w1["persist_hits"] == 0 and w1["traces"] >= 1
            w2 = _run_worker(tmp_path, sock)
            assert w2["rows"] == w2["host"] == ref
            assert w2["persist_hits"] > 0, w2
            assert w2["artifact_hits"] >= 1, w2
            assert w2["remote_errors"] == 0, w2
            assert w1["nvcc_runs"] == w2["nvcc_runs"] == 0
            from tidb_tpu_torch.fabric.compile_client import CompileClient
            st = CompileClient(sock).request({"op": "stats"})
            assert st["compiles"] >= 1 and st["dedup_served"] >= 1
            assert st["cuda_initialized"] is False
        finally:
            proc.terminate()
            proc.wait(10)

    def test_dead_server_degrades_to_inline_not_failure(self, tmp_path):
        """A server that never started costs builds, not queries: the
        worker counts the classified remote failure and builds INLINE —
        rows stay exact and the compile breaker stays closed."""
        w = _run_worker(tmp_path, str(tmp_path / "dead.sock"))
        assert w["rows"] == w["host"] == _reference_rows()
        assert w["remote_errors"] >= 1, w
        assert w["remote_compiles"] == 0
        assert w["sync_compiles"] >= 1, w
        assert w["traces"] >= 1
        assert w["breaker"].get("compile", "closed") == "closed", w


def test_dead_server_keeps_fragments_on_the_card(tmp_path, monkeypatch):
    """A dead compile server is not a compile failure: the server only
    records signatures, so more cold fragments than the compile
    breaker's threshold, each dialled after the client's down-window
    ran out, all run on the device engine with the host's rows, and the
    compile breaker stays closed with no failure charged."""
    from tidb_tpu_torch.fabric import compile_client
    from tidb_tpu_torch.fabric import state as fabric_state
    from tidb_tpu_torch.ops import device
    from tidb_tpu_torch.testkit import TestKit
    from torch_dual import clear_compile_state
    device.set_device("cpu")
    dead = str(tmp_path / "dead.sock")
    monkeypatch.setenv("TIDB_TPU_COMPILE_SERVER", dead)
    monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", "off")
    clear_compile_state()
    compile_client.reset_for_tests()
    compile_client.get_client(dead)._down_cooldown = 0.05
    tk = TestKit()
    tk.must_exec("use test")
    tk.must_exec("create table dd (id int primary key, g int, v int)")
    tk.must_exec("insert into dd values " + ",".join(
        f"({i},{i % 5},{(i * 29) % 97})" for i in range(200)))
    threshold = int(tk.must_query(
        "select @@global.tidb_device_circuit_threshold").rows[0][0])
    errs0 = fabric_state.STATS["fabric_remote_errors"]
    try:
        n = threshold + 2
        for k in range(n):
            q = (f"select g, sum(v) from dd where v > {k} "
                 "group by g order by g")
            tk.must_exec("set tidb_executor_engine = 'host'")
            host = tk.must_query(q).rows
            tk.must_exec("set tidb_executor_engine = 'tpu'")
            time.sleep(0.06)                     # past the down-window
            plan = "\n".join(" ".join(str(c) for c in r) for r in
                             tk.must_query(f"explain analyze {q}").rows)
            assert "engine:tpu" in plan, (k, plan)
            assert tk.must_query(q).rows == host, k
        assert fabric_state.STATS["fabric_remote_errors"] - errs0 >= n
        br = tk.domain._device_breakers["compile"].snapshot()
        assert (br["state"], br["failures"]) == ("closed", 0), br
    finally:
        compile_client.reset_for_tests()
        clear_compile_state()
