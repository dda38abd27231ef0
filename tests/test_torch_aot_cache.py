"""The port's counterpart of tests/test_aot_cache.py: what scopes a
persisted build, and a second process that starts warm.

The reference scopes its XLA cache directory by a host fingerprint
(CPU flags, machine, jax version), so another machine's executables are
unreachable.  The port persists no executable: its kernels are one
library per source digest (``ops/kernels/build.py``), and its signature
index (``executor/compile_service.py``) names each entry by a hash of
the pipeline key, the library's digest and the device's identity (the
card's name and compute capability, or ``cpu``).  So an entry recorded
against other kernel sources or another kind of card is unreachable by
construction, whether the index is the default directory or one shared
through ``TIDB_TPU_COMPILE_INDEX``.

The acceptance case runs a fresh process twice against one index, in
each package: the second run reports ``compile_persist_hits`` > 0 and
returns the host engine's rows, and the port's rows equal the
reference's.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestIndexScope:
    def test_stable_and_hexish(self):
        from tidb_tpu_torch.executor import compile_service as pcs
        h = pcs._persist_hash(("sig", 64))
        assert h == pcs._persist_hash(("sig", 64))
        assert len(h) == 40 and all(c in "0123456789abcdef" for c in h)
        digest, ident = pcs._backend_ident()
        assert len(digest) == 12 and all(c in "0123456789abcdef"
                                         for c in digest)

    def test_this_process_index_is_in_the_build_dir(self, monkeypatch):
        from tidb_tpu_torch.executor import compile_service as pcs
        from tidb_tpu_torch.ops.kernels import build
        monkeypatch.delenv("TIDB_TPU_COMPILE_INDEX", raising=False)
        d = pcs._persist_dir()
        assert os.path.dirname(d) == build.BUILD_DIR
        assert os.path.basename(d) == "pipe-index"

    def test_explicit_dir_is_scoped_too(self, tmp_path, monkeypatch):
        """A SHARED explicit index (a fleet's) still keys by the library
        and the device: an entry another build recorded sits under
        another name and is never a hit here."""
        from tidb_tpu_torch.executor import compile_service as pcs
        from tidb_tpu_torch.ops import device as tdev
        monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", str(tmp_path))
        key = ("sig", 64, ((4, 0),), ("sum",))
        digest, ident = pcs._backend_ident()
        dev = tdev._DEVICE[0]
        monkeypatch.setitem(pcs._IDENT, dev, ("f" * 12, ident))
        pcs._persist_record(key, "agg", "sig", "sync")
        foreign = pcs._persist_hash(key)
        monkeypatch.setitem(pcs._IDENT, dev, (digest, ident))
        assert not pcs._persist_lookup(key)
        assert os.listdir(tmp_path) == [foreign + ".json"]
        pcs._persist_record(key, "agg", "sig", "sync")
        assert pcs._persist_lookup(key)
        assert sorted(os.listdir(tmp_path)) == sorted(
            [foreign + ".json", pcs._persist_hash(key) + ".json"])


_PERSIST_WORKLOAD = r"""
import json, sys
pkg = sys.argv[1]
if pkg == "tidb_tpu_torch":
    from tidb_tpu_torch.ops import device
    device.set_device("cpu")
TestKit = __import__(pkg + ".testkit", fromlist=["TestKit"]).TestKit
compile_service = __import__(pkg + ".executor.compile_service",
                             fromlist=["snapshot"])
tk = TestKit()
tk.must_exec("use test")
tk.must_exec("create table p (id int primary key, g int, v int)")
rows = ",".join(f"({i},{i%5},{(i*31)%97})" for i in range(200))
tk.must_exec(f"insert into p values {rows}")
# pin the group-count estimate: the pipeline's capacity rides the stats,
# and the index key must be IDENTICAL across processes
tk.must_exec("analyze table p")
q = "select g, sum(v), count(*) from p group by g order by g"
tk.must_exec("set tidb_executor_engine = 'host'")
host = [[str(c) for c in r] for r in tk.must_query(q).rows]
tk.must_exec("set tidb_executor_engine = 'tpu'")
dev = [[str(c) for c in r] for r in tk.must_query(q).rows]
snap = compile_service.snapshot()
print(json.dumps({"rows": dev, "host": host,
                  "persist_hits": snap["compile_persist_hits"],
                  "sync_compiles": snap["sync_compiles"]}))
"""


class TestPersistentIndex:
    def _run(self, pkg, tmp_path):
        out = subprocess.run(
            [sys.executable, "-c", _PERSIST_WORKLOAD, pkg],
            env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
                 "TIDB_TPU_JAX_CACHE": str(tmp_path / "jax"),
                 "TIDB_TPU_COMPILE_INDEX": str(tmp_path / "idx")},
            capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr[-4000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    def test_second_process_starts_warm_and_exact(self, tmp_path):
        got = {}
        for pkg in ("tidb_tpu", "tidb_tpu_torch"):
            first = self._run(pkg, tmp_path / pkg)
            assert first["rows"] == first["host"]
            assert first["sync_compiles"] >= 1  # cold: built + recorded
            assert first["persist_hits"] == 0
            second = self._run(pkg, tmp_path / pkg)
            # the restart is WARM: the cold obtain found its signature
            assert second["persist_hits"] > 0
            assert second["rows"] == second["host"] == first["host"]
            got[pkg] = (first["rows"], second["rows"],
                        second["persist_hits"] > 0)
        assert got["tidb_tpu_torch"] == got["tidb_tpu"], got
