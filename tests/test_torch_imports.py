"""The port stands alone: ``tidb_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the reference package, import and serve SQL with both
blocked (in process and over the port's MySQL server), and without a card (and without ``set_device('cpu')``) a device
query raises instead of running somewhere else.
"""

import ast
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tidb_tpu_torch")

_FORBIDDEN = re.compile(r"^(jax|jaxlib|tidb_tpu)(\.|$)")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        out += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    return sorted(out)


def test_port_sources_import_neither_jax_nor_reference():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        for node in ast.walk(ast.parse(text, filename=path)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", None) == "__import__"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names if _FORBIDDEN.match(n)]
    assert len(_port_sources()) > 80
    assert not bad, "\n".join(bad)


_BLOCKER = textwrap.dedent("""
    import sys

    class _Block:
        def find_spec(self, name, path=None, target=None):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "tidb_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, _Block())
    sys.path.insert(0, %r)
""") % ROOT


def _run(script):
    proc = subprocess.run([sys.executable, "-c", _BLOCKER + script],
                          capture_output=True, text=True, timeout=240,
                          cwd=ROOT)
    return proc


def test_port_serves_sql_with_jax_blocked():
    proc = _run(textwrap.dedent("""
        from tidb_tpu_torch.ops import device
        device.set_device("cpu")
        from tidb_tpu_torch.testkit import TestKit
        tk = TestKit()
        tk.must_exec("create table t (g varchar(3), v decimal(8,2))")
        tk.must_exec("insert into t values ('a', 1.50), ('b', 2.25), "
                     "('a', null), (null, 4.00)")
        tk.must_exec("set @@tidb_executor_engine = 'tpu'")
        q = "select g, sum(v), count(*) from t group by g order by g"
        print(tk.must_query(q).rows)
        ex = tk.must_query("explain analyze " + q).rows
        assert any("engine:tpu" in str(c) for r in ex for c in r), ex
        # the same query over the port's MySQL server and a socket
        import socket, struct
        from tidb_tpu_torch.server import MySQLServer
        from tidb_tpu_torch.server import protocol as P
        from tidb_tpu_torch.server.packet import (
            PacketIO, read_lenenc_int, read_lenenc_str)
        srv = MySQLServer(tk.domain, port=0).start()
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        io = PacketIO(sock)
        io.read_packet()
        io.write_packet(struct.pack("<II", P.CLIENT_PROTOCOL_41
                                    | P.CLIENT_SECURE_CONNECTION
                                    | P.CLIENT_PLUGIN_AUTH, 1 << 24)
                        + bytes([255]) + bytes(23) + b"root" + bytes(2)
                        + b"mysql_native_password" + bytes(1))
        assert io.read_packet()[0] == 0
        io.reset_seq()
        io.write_packet(bytes([P.COM_QUERY])
                        + b"set @@tidb_executor_engine = 'tpu'")
        assert io.read_packet()[0] == 0
        io.reset_seq()
        io.write_packet(bytes([P.COM_QUERY])
                        + q.replace("from t", "from test.t").encode())
        ncols = read_lenenc_int(io.read_packet(), 0)[0]
        for _ in range(ncols + 1):
            io.read_packet()
        wire = []
        while True:
            pkt = io.read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            row, pos = [], 0
            for _ in range(ncols):
                if pkt[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                else:
                    v, pos = read_lenenc_str(pkt, pos)
                    row.append(v.decode())
            wire.append(tuple(row))
        sock.close()
        srv.shutdown()
        print("wire", wire)
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu")]
    """))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = "[(None, '4.00', '1'), ('a', '1.50', '2'), ('b', '2.25', '1')]"
    assert rows in proc.stdout
    assert "wire " + rows in proc.stdout


def test_device_query_without_card_raises():
    """No card and no set_device('cpu'): the first device operation
    raises DeviceNotAvailable to the caller — neither a quiet fallback to
    the host engine nor a silent run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    proc = _run(textwrap.dedent("""
        from tidb_tpu_torch.ops.device import DeviceNotAvailable
        from tidb_tpu_torch.testkit import TestKit
        tk = TestKit()
        tk.must_exec("create table t (g int, v int)")
        tk.must_exec("insert into t values (1, 2), (1, 3), (2, 4)")
        tk.must_exec("set @@tidb_executor_engine = 'tpu'")
        try:
            tk.must_query("select g, sum(v) from t group by g")
        except DeviceNotAvailable as e:
            print("raised:", e)
        else:
            raise SystemExit("device query ran without a device")
        tk.must_exec("set @@tidb_executor_engine = 'host'")
        print(tk.must_query("select g, sum(v) from t group by g "
                            "order by g").rows)
    """))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "raised: no CUDA device is available" in proc.stdout
    assert "[('1', '5'), ('2', '4')]" in proc.stdout


def test_chip_smoke_refuses_without_card():
    """chip_smoke.py exits non-zero and prints no result line where no
    CUDA card is visible."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_mpp_modules_are_ports_not_stubs():
    """The MPP slice's modules import neither JAX nor the reference, and
    are the mesh path, not the earlier stubs."""
    for rel in ("tidb_tpu_torch/parallel/mpp.py",
                "tidb_tpu_torch/executor/mpp_exec.py",
                "tidb_tpu_torch/ops/kernels/radix_exchange.py",
                "tidb_tpu_torch/ops/kernels/shuffle_join.py"):
        path = os.path.join(ROOT, rel)
        assert path in _port_sources()
        with open(path) as f:
            text = f.read()
        assert "not yet ported" not in text, rel
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert not _FORBIDDEN.match(node.module or ""), rel
            if isinstance(node, ast.Import):
                assert not any(_FORBIDDEN.match(a.name)
                               for a in node.names), rel


def test_port_logger_names_are_its_own():
    """Every logger the port names is under ``tidb_tpu_torch.``: a level or
    handler set on a reference logger never reaches the port's."""
    names = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "getLogger"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.append((os.path.relpath(path, ROOT),
                              str(node.args[0].value)))
    assert len(names) >= 26
    bad = [f"{p}: {n}" for p, n in names
           if not n.startswith("tidb_tpu_torch.")]
    assert not bad, "\n".join(bad)
    # the durable store, the fleet and BR name theirs too
    named = {p for p, _n in names}
    for rel in ("kv/shared_store.py", "fabric/coord_net.py",
                "fabric/dedup.py", "fabric/worker.py", "fabric/fleet.py",
                "fabric/region.py"):
        assert os.path.join("tidb_tpu_torch", rel) in named, rel
    from tidb_tpu_torch.executor import supervisor
    from tidb_tpu_torch.ops import residency
    from tidb_tpu_torch.utils import backoff
    assert residency.log.name == "tidb_tpu_torch.residency"
    assert supervisor.log.name == "tidb_tpu_torch.supervisor"
    assert backoff.log.name == "tidb_tpu_torch.backoff"


#: the modules of the durable store, the fleet and BR
FLEET_MODULES = ("kv/shared_store.py", "fabric/coord_net.py",
                 "fabric/dedup.py", "fabric/client.py", "fabric/worker.py",
                 "fabric/fleet.py", "fabric/blob.py", "fabric/region.py",
                 "br_storage.py", "br.py")


def test_fleet_modules_are_the_ports(tmp_path):
    """The ten modules exist, import neither JAX nor the reference, and
    the fleet spawns the port's worker and compile server under the
    port's own segment and run-directory prefixes."""
    for rel in FLEET_MODULES:
        assert os.path.join(PORT, rel) in _port_sources(), rel
    proc = _run(textwrap.dedent("""
        import os, sys, tempfile
        from tidb_tpu_torch import br, br_storage
        from tidb_tpu_torch.fabric import (blob, client, coord_net, dedup,
                                           fleet, region, worker)
        from tidb_tpu_torch.fabric.coord import Coordinator
        from tidb_tpu_torch.kv import shared_store
        d = tempfile.mkdtemp(dir=%r)
        c = Coordinator.create(os.path.join(d, "coord.json"), nslots=2)
        print("segment", c._shm.name)
        c.unlink()
        f = fleet.Fleet(2)
        print("run_dir", os.path.basename(f.run_dir))
        os.rmdir(f.run_dir)
        assert not [m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu")]
    """ % str(tmp_path)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "segment torchfab-" in proc.stdout
    assert "run_dir torchfab-" in proc.stdout
    with open(os.path.join(PORT, "fabric", "fleet.py")) as f:
        text = f.read()
    assert '"tidb_tpu_torch.fabric.worker"' in text
    assert '"tidb_tpu_torch.fabric.compile_server"' in text
    assert "tpufab-" not in text


def test_port_lint_runs_with_jax_blocked():
    """The port's lint imports neither JAX nor the reference (the card's
    machine has no JAX): ``python -m tidb_tpu_torch.lint --list`` exits 0
    with both blocked, and lists the port's 20 rules."""
    proc = _run(textwrap.dedent("""
        import runpy, sys
        sys.argv = ["python -m tidb_tpu_torch.lint", "--list"]
        try:
            runpy.run_module("tidb_tpu_torch.lint", run_name="__main__")
        except SystemExit as e:
            assert not [m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu")]
            raise
    """))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rules = [ln.split()[0] for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(rules) == 20
    assert "launch-confinement" in rules and "pipeline-host-sync" in rules
    assert "jit-confinement" not in rules
    assert "traced-value-hazard" not in rules
