"""The port's compile service (``tidb_tpu_torch/executor/
compile_service.py``) against the reference's: every case of
tests/test_compile_service.py, plus tests/test_tracing.py's
``test_bg_compile_links_child_trace``, run once in each package on the
same seeded table, with the reference test's assertions on both and the
port's record of what the calls answered (rows, the pipe-cache and
service counter deltas, ADMIN COMPILE's counts, breaker states) equal
to the reference's.

What a compile is differs (the module docstring of each package says
how): an XLA compile in the reference; the pipeline's assembly and its
first launches at a shape in the port, where a "trace" is a pipeline's
first call at an argument shape (``device_exec._Pipeline``).  On the
CPU the port's kernels run their plain versions; a spy on the K2 and K1
wrappers (``expr_vm.run``, ``groupby_agg.groupby_agg``) counts each
call by thread, so a test can show that a host-served execution called
no kernel on the query's thread and that the flipped one did.

The reference's ``TestJitConfinementLint`` (raw ``jax.jit`` confined to
the compile layer) has its counterpart in ``TestLaunchConfinementLint``:
the port compiles no pipeline, and its gate is the kernel launch — the
library loaded and its launchers declared only in ``ops/kernels/``, and
every launcher called through ``ops/kernels/build.py launch``
(``launch-confinement`` of ``tidb_tpu_torch/lint``).
"""

import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tidb_tpu.executor import compile_service as rcs
from tidb_tpu.executor import device_exec as rde
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu.utils import failpoint as rfp
from tidb_tpu_torch.executor import compile_service as pcs
from tidb_tpu_torch.executor import device_exec as pde
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops.kernels import expr_vm, groupby_agg
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import failpoint as pfp
from torch_dual import clear_compile_state, isolated  # noqa: F401

SIDES = {
    "ref": SimpleNamespace(name="ref", Kit=RefKit, cs=rcs,
                           stats=rde.pipe_cache_stats, fp=rfp,
                           pkg="tidb_tpu"),
    "port": SimpleNamespace(name="port", Kit=PortKit, cs=pcs,
                            stats=pde.pipe_cache_stats, fp=pfp,
                            pkg="tidb_tpu_torch"),
}

ROWS = ",".join(f"({i},{i % 7},{(i * 37) % 101},{(i * 13) % 89})"
                for i in range(300))


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu(isolated):
    tdev.set_device("cpu")
    yield


@pytest.fixture(autouse=True)
def _cold_caches():
    """Each case starts, and leaves the process, with no compiled
    pipeline in either package (the reference's own tests of the same
    queries expect a cold cache)."""
    clear_compile_state()
    yield
    clear_compile_state()


@pytest.fixture(scope="module")
def kits():
    """One TestKit a package over the same `cs` table, on the device
    engine."""
    out = {}
    for name, side in SIDES.items():
        tk = side.Kit()
        tk.must_exec("use test")
        tk.must_exec("create table cs (id int primary key, g int, v int, "
                     "w int)")
        tk.must_exec(f"insert into cs values {ROWS}")
        tk.must_exec("set tidb_executor_engine = 'tpu'")
        out[name] = tk
    yield out
    for name, side in SIDES.items():
        side.fp.disable_all()
        out[name].must_exec("set tidb_executor_engine = 'auto'")
        out[name].must_exec("set tidb_compile_async = 'OFF'")


def both(kits, body):
    """body(side, tk) in each package; the records must be equal."""
    got = {name: body(side, kits[name]) for name, side in SIDES.items()}
    assert got["port"] == got["ref"], got
    return got["port"]


def _host_rows(tk, q):
    tk.must_exec("set tidb_executor_engine = 'host'")
    try:
        return tk.must_query(q).rows
    finally:
        tk.must_exec("set tidb_executor_engine = 'tpu'")


class _KernelSpy:
    """Counts the port's K2 and K1 wrapper calls by thread."""

    def __init__(self, monkeypatch):
        self.calls = {}
        run, agg = expr_vm.run, groupby_agg.groupby_agg

        def vm_spy(*a, **kw):
            self._count("expr_vm")
            return run(*a, **kw)

        def agg_spy(*a, **kw):
            self._count("groupby_agg")
            return agg(*a, **kw)
        monkeypatch.setattr(expr_vm, "run", vm_spy)
        monkeypatch.setattr(groupby_agg, "groupby_agg", agg_spy)

    def _count(self, name):
        key = (threading.get_ident(), name)
        self.calls[key] = self.calls.get(key, 0) + 1

    def mine(self) -> dict:
        me = threading.get_ident()
        return {n: c for (t, n), c in self.calls.items() if t == me}


@pytest.fixture()
def spy(monkeypatch):
    return _KernelSpy(monkeypatch)


# -- unit helpers -------------------------------------------------------------

class TestHelpers:
    @pytest.mark.parametrize("per_double", [1, 2, 4])
    def test_next_buckets_geometric(self, per_double):
        from tidb_tpu.ops.device import bucket_rows as rbucket
        out = pcs.next_buckets(363, 3, per_double)
        assert out == rcs.next_buckets(363, 3, per_double)
        assert out == sorted(set(out)) and len(out) == 3
        assert out[0] > 363
        for b in out:
            assert tdev.bucket_rows(b, per_double) == b == rbucket(
                b, per_double)
        assert pcs.next_buckets(363, 3, 0) == rcs.next_buckets(363, 3, 0) \
            == []

    def test_spec_roundtrip_preserves_weak_scalars(self):
        import jax
        ref = rcs._spec_of(({"x": (np.arange(8), np.zeros(8, bool))},
                            np.int64(5), 3))
        spec = pcs._spec_of(({"x": (torch.arange(8),
                                    torch.zeros(8, dtype=torch.bool))},
                             torch.tensor(5), 3))
        env, n_live, lit = spec
        assert isinstance(env["x"][0], pcs.TensorSpec)
        assert n_live.shape == () and n_live.dtype == torch.int64
        assert lit == 0 == ref[2]  # python scalar stays a literal zero
        # the same leaves as the reference's ShapeDtypeStructs
        for mine, theirs in ((env["x"][0], ref[0]["x"][0]),
                             (env["x"][1], ref[0]["x"][1])):
            assert isinstance(theirs, jax.ShapeDtypeStruct)
            assert mine.shape == theirs.shape
            assert str(mine.dtype).split(".")[-1] == str(theirs.dtype)
        zeros = pcs._zeros_of(spec)
        assert zeros[0]["x"][0].shape == (8,) == \
            rcs._zeros_of(ref)[0]["x"][0].shape
        assert not zeros[0]["x"][0].any() and zeros[2] == 0
        assert pcs._spec_bytes(spec) == 8 * 8 + 8 + 8
        with pytest.raises(TypeError):
            pcs._spec_of((object(),))

    def test_base_bucket_and_scale(self):
        spec = pcs._spec_of(({"x": (torch.zeros(16), torch.zeros(
            16, dtype=torch.bool))}, torch.tensor(3)))
        ref = rcs._spec_of(({"x": (np.zeros(16), np.zeros(16, bool))},
                            np.int64(3)))
        assert pcs._base_bucket(spec) == rcs._base_bucket(ref) == 16
        scaled = pcs._scale_spec(spec, 16, 23)
        assert pcs._base_bucket(scaled) == 23 == rcs._base_bucket(
            rcs._scale_spec(ref, 16, 23))
        assert scaled[0]["x"][1].dtype == torch.bool
        spec2 = pcs._spec_of(({"x": (torch.zeros(16), torch.zeros(16)),
                               "y": (torch.zeros(8), torch.zeros(8))},))
        ref2 = rcs._spec_of(({"x": (np.zeros(16), np.zeros(16, bool)),
                              "y": (np.zeros(8), np.zeros(8, bool))},))
        assert pcs._base_bucket(spec2) is rcs._base_bucket(ref2) is None


# -- async compile, host-first serving ---------------------------------------

class TestAsyncFlip:
    def test_cold_query_host_served_then_flips_to_device(self, kits, spy,
                                                           monkeypatch):
        monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", "off")
        q = ("select g, sum(v), min(w) from cs where v > 5 "
             "group by g order by g")

        def body(side, tk):
            golden = _host_rows(tk, q)
            tk.must_exec("set tidb_compile_async = 'ON'")
            try:
                st0 = side.stats(thread_local=True)
                snap0 = side.cs.snapshot()
                k0 = spy.mine()
                rows = tk.must_query(q).rows
                st1 = side.stats(thread_local=True)
                host_served = (rows == golden, spy.mine() == k0,
                               st1["traces"] - st0["traces"],
                               st1["compile_s"] - st0["compile_s"],
                               st1["mode_async_pending"]
                               - st0["mode_async_pending"],
                               side.cs.snapshot()["bg_submitted"]
                               - snap0["bg_submitted"])
                assert side.cs.wait_idle(60.0), "bg compile stuck"
                snap1 = side.cs.snapshot()
                landed = (snap1["bg_completed"] - snap0["bg_completed"],
                          snap1["compile_bg_seconds"] > 0)
                st0 = side.stats(thread_local=True)
                k0 = spy.mine()
                rows2 = tk.must_query(q).rows
                st1 = side.stats(thread_local=True)
                k1 = spy.mine()
                flipped = (rows2 == golden, st1["traces"] - st0["traces"],
                           st1["hits"] - st0["hits"] >= 1,
                           st1["mode_async_pending"]
                           - st0["mode_async_pending"])
                if side.name == "port":
                    # the flip ran the kernels on the query's thread
                    assert k1.get("expr_vm", 0) > k0.get("expr_vm", 0)
                    assert k1.get("groupby_agg", 0) > \
                        k0.get("groupby_agg", 0)
                    assert st1["mode_bg"] - st0["mode_bg"] == 1
                return host_served, landed, flipped
            finally:
                tk.must_exec("set tidb_compile_async = 'OFF'")
        rec = both(kits, body)
        assert rec == ((True, True, 0, 0.0, 1, 1), (1, True),
                       (True, 0, True, 0))

    def test_pending_compile_serves_host_without_resubmit(self, kits,
                                                            monkeypatch):
        monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", "off")
        q = ("select g, max(v), count(w) from cs where w > 3 "
             "group by g order by g")

        def body(side, tk):
            golden = _host_rows(tk, q)
            tk.must_exec("set tidb_compile_async = 'ON'")
            try:
                with side.fp.enabled("device-compile",
                                     "1*compile-slow(0.4)"):
                    snap0 = side.cs.snapshot()
                    rows = tk.must_query(q).rows      # submits, host serves
                    rows2 = tk.must_query(q).rows     # still in flight
                    snap1 = side.cs.snapshot()
                    pending = (rows == golden, rows2 == golden,
                               snap1["bg_submitted"] - snap0["bg_submitted"],
                               snap1["compile_pending_fragments"]
                               - snap0["compile_pending_fragments"])
                assert side.cs.wait_idle(60.0)
                st0 = side.stats(thread_local=True)
                rows3 = tk.must_query(q).rows
                st1 = side.stats(thread_local=True)
                return pending, rows3 == golden, \
                    st1["traces"] - st0["traces"]
            finally:
                tk.must_exec("set tidb_compile_async = 'OFF'")
        assert both(kits, body) == ((True, True, 1, 2), True, 0)


# -- prewarm ladder -----------------------------------------------------------

class TestPrewarmLadder:
    def test_admin_compile_prewarms_next_buckets(self, kits):
        q = ("select g, sum(w), count(*) from cs where v < 90 "
             "group by g order by g")
        more = ",".join(
            f"({i},{i % 7},{(i * 37) % 101},{(i * 13) % 89})"
            for i in range(300, 600))

        def body(side, tk):
            # drop recipes of earlier cases: ADMIN COMPILE prewarms EVERY
            # hot recipe, and this case counts its own
            side.cs.reset_for_tests()
            tk.must_query(q)  # registers the recipe at the 300-row bucket
            rep = tk.must_query("admin compile").rows
            # INSERT across the bucket boundary, inside the warmed ladder
            # (300 rows sit in bucket 363; 600 lands in 725, two rungs up)
            tk.must_exec(f"insert into cs values {more}")
            golden = _host_rows(tk, q)
            st0 = side.stats(thread_local=True)
            rows = tk.must_query(q).rows
            st1 = side.stats(thread_local=True)
            tk.must_exec("delete from cs where id >= 300")
            return (rep, rows == golden, st1["traces"] - st0["traces"],
                    st1["compile_s"] - st0["compile_s"],
                    st1["mode_prewarmed"] - st0["mode_prewarmed"])
        rep, ok, traces, secs, prewarmed = both(kits, body)
        assert len(rep) == 1 and int(rep[0][0]) >= 1  # submitted
        assert rep == [("2", "2", "0")]
        assert (ok, traces, secs, prewarmed) == (True, 0, 0.0, 1)
        # each rung's bytes and seconds, as ADMIN COMPILE warmed them
        rungs = [w for w in pcs.WARM_LOG if w["origin"] == "prewarm"]
        assert sorted(w["bucket"] for w in rungs) == [512, 725]
        assert all(w["bytes"] > 0 and not w["skipped"] for w in rungs)

    def test_prewarm_reports_counts(self, kits):
        def body(side, tk):
            rep = side.cs.prewarm(ctx=tk.session, ladder_up=1,
                                  max_recipes=4, wait=True, timeout_s=60.0)
            return rep["submitted"] >= 0, side.cs.verify_drained()["ok"]
        assert both(kits, body) == (True, True)

    def test_rung_past_the_free_share_is_skipped(self, kits, monkeypatch):
        """A ladder rung whose tensors exceed the free share of the
        device budget allocates nothing and launches nothing: it is
        skipped and counted (the port's; the reference has no such
        check)."""
        from tidb_tpu_torch.ops import residency
        tk = kits["port"]
        q = ("select g, min(w), count(*) from cs where v < 70 "
             "group by g order by g")
        pcs.reset_for_tests()
        tk.must_query(q)
        monkeypatch.setattr(residency, "free_share_bytes", lambda g=None: 1)
        rep = pcs.prewarm(ctx=tk.session, ladder_up=2, wait=True,
                          timeout_s=60.0)
        assert rep == {"submitted": 2, "prewarmed": 0, "failed": 0}
        assert pcs.WARM["warm_skipped"] == 2 and pcs.WARM["warms"] == 0
        snap = pcs.snapshot()
        assert snap["bg_discarded"] == 2 and snap["bg_failed"] == 0
        assert pcs.verify_drained()["ok"]


# -- classified compile failures + breaker ------------------------------------

class TestCompileFailChaos:
    def test_sync_compile_fail_degrades_exact(self, kits):
        q = ("select g, min(v), max(w) from cs where v > 50 "
             "group by g order by g")

        def body(side, tk):
            golden = _host_rows(tk, q)
            agg_br = tk.domain._device_breakers.get("agg")
            agg_fail0 = agg_br.snapshot()["failures"] if agg_br else 0
            with side.fp.enabled("device-compile", "compile-fail"):
                rows = tk.must_query(q).rows
            br = tk.domain._device_breakers["compile"]
            return (rows == golden, br.snapshot()["failures"] >= 1,
                    agg_br is None
                    or agg_br.snapshot()["failures"] == agg_fail0)
        assert both(kits, body) == (True, True, True)

    def test_bg_transient_fail_absorbed_by_retry(self, kits, monkeypatch):
        monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", "off")
        q = ("select g, sum(v + w) from cs where w > 42 "
             "group by g order by g")

        def body(side, tk):
            golden = _host_rows(tk, q)
            tk.must_exec("set tidb_compile_async = 'ON'")
            try:
                snap0 = side.cs.snapshot()
                with side.fp.enabled("device-compile", "1*compile-fail"):
                    rows = tk.must_query(q).rows
                    assert side.cs.wait_idle(60.0)
                snap1 = side.cs.snapshot()
                st0 = side.stats(thread_local=True)
                rows2 = tk.must_query(q).rows
                st1 = side.stats(thread_local=True)
                return (rows == golden == rows2,
                        snap1["bg_completed"] - snap0["bg_completed"],
                        snap1["bg_failed"] - snap0["bg_failed"],
                        st1["traces"] - st0["traces"])
            finally:
                tk.must_exec("set tidb_compile_async = 'OFF'")
        assert both(kits, body) == (True, 1, 0, 0)

    def test_breaker_opens_and_recovers_half_open(self, kits):
        qs = [(f"select g, count(*) from cs where v > {k} "
               "group by g order by g") for k in (71, 72, 73, 74)]

        def body(side, tk):
            tk.must_exec("set global tidb_device_circuit_threshold = 2")
            tk.must_exec("set global tidb_device_circuit_cooldown = 0.5")
            try:
                goldens = [_host_rows(tk, q) for q in qs]
                with side.fp.enabled("device-compile", "compile-fail"):
                    ok = [tk.must_query(q).rows == g
                          for q, g in zip(qs[:2], goldens[:2])]
                br = tk.domain._device_breakers["compile"]
                opened = br.snapshot()["state"]
                deg0 = side.cs.snapshot()["breaker_degrades"]
                ok.append(tk.must_query(qs[2]).rows == goldens[2])
                degraded = side.cs.snapshot()["breaker_degrades"] - deg0
                time.sleep(0.55)
                ok.append(tk.must_query(qs[3]).rows == goldens[3])
                return ok, opened, degraded, br.snapshot()["state"]
            finally:
                tk.must_exec("set global tidb_device_circuit_threshold = 5")
                tk.must_exec("set global tidb_device_circuit_cooldown = 30")
        assert both(kits, body) == ([True] * 4, "open", 1, "closed")

    def test_no_leaked_compile_jobs(self, kits):
        def body(side, tk):
            assert side.cs.wait_idle(30.0)
            d = side.cs.verify_drained()
            return d["ok"], d["in_flight"]
        assert both(kits, body) == (True, 0)


# -- persistent signature index ----------------------------------------------

class TestPersistIndex:
    def test_record_then_lookup(self, tmp_path, monkeypatch):
        def body(side, _tk):
            d = tmp_path / side.name
            monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", str(d))
            key = ("sig-a", 64, None, ("sum",))
            before = side.cs._persist_lookup(key)
            side.cs._persist_record(key, "agg", "sig-a", "sync")
            fname = side.cs._persist_hash(key) + ".json"
            blob = json.loads((d / fname).read_text())
            return (before, side.cs._persist_lookup(key),
                    side.cs._persist_lookup(("sig-b", 64)),
                    blob["shape"], blob["origin"])
        assert both({"ref": None, "port": None}, body) == (
            False, True, False, "agg", "sync")

    def test_off_disables(self, monkeypatch):
        monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", "off")

        def body(side, _tk):
            side.cs._persist_record(("k",), "agg", "", "sync")
            return side.cs._persist_dir(), side.cs._persist_lookup(("k",))
        assert both({"ref": None, "port": None}, body) == (None, False)

    def test_backend_identity_in_hash(self, monkeypatch):
        h1 = pcs._persist_hash(("sig", 64))
        assert h1 == pcs._persist_hash(("sig", 64))
        assert h1 != pcs._persist_hash(("sig", 128))
        # the library's digest and the device's identity scope the hash:
        # another build or another card is another set of kernels
        digest, ident = pcs._backend_ident()
        from tidb_tpu_torch.ops.kernels import build
        assert digest == build._digest() and ident == "cpu"
        monkeypatch.setitem(pcs._IDENT, "cpu", ("0" * 12, "cpu"))
        assert pcs._persist_hash(("sig", 64)) != h1
        monkeypatch.setitem(pcs._IDENT, "cpu",
                            (digest, ("NVIDIA H100 80GB HBM3", (9, 0))))
        assert pcs._persist_hash(("sig", 64)) != h1

    def test_default_dir_is_the_kernel_build_dir(self, monkeypatch):
        import os
        from tidb_tpu_torch.ops.kernels import build
        monkeypatch.delenv("TIDB_TPU_COMPILE_INDEX", raising=False)
        assert pcs._persist_dir() == os.path.join(build.BUILD_DIR,
                                                  "pipe-index")


# -- gauges / annotations -----------------------------------------------------

class TestGaugesSurfaced:
    def test_explain_observe_status_and_metrics(self, kits, monkeypatch):
        monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", "off")
        q = ("select g, sum(v), max(v + w) from cs where w < 80 "
             "group by g order by g")

        def body(side, tk):
            tk.must_exec("set tidb_compile_async = 'ON'")
            try:
                tk.must_query(q)                       # async submit
                assert side.cs.wait_idle(60.0)
                tk.must_query(q)                       # device flip
            finally:
                tk.must_exec("set tidb_compile_async = 'OFF'")
            rows = tk.must_query(f"explain analyze {q}").rows
            blob = "\n".join(" ".join(str(c) for c in r) for r in rows)
            g = tk.domain.observe.gauge_snapshot()
            srv_mod = __import__(f"{side.pkg}.server.http_status",
                                 fromlist=["StatusServer"])
            srv = srv_mod.StatusServer(tk.domain, port=0).start()
            try:
                base = f"http://127.0.0.1:{srv.port}"
                status = json.load(urllib.request.urlopen(f"{base}/status"))
                cs = status["device_compiler"]
                metrics = urllib.request.urlopen(f"{base}/metrics").read()
            finally:
                srv.shutdown()
            return ("compile_queue_depth" in blob, "compile_mode" in blob,
                    "compile_queue_depth" in g,
                    g.get("compile_bg_seconds", 0) > 0,
                    cs["bg_completed"] >= 1, cs["compile_bg_seconds"] > 0,
                    "compile" in status["device_breakers"],
                    sorted(cs) == sorted(side.cs.snapshot()),
                    [k in metrics for k in (b"compile_queue_depth",
                                            b"compile_bg_seconds",
                                            b"compile_pending_fragments")])
        assert both(kits, body) == (True,) * 8 + ([True] * 3,)

    def test_bg_attribution_survives_supervisor_deadline(self, kits,
                                                         monkeypatch):
        """With tidb_compile_timeout > 0 the background build runs on a
        REUSED supervisor worker thread — its compile charges must still
        route to the bg_* mirror, and the worker must not stay marked
        when it serves query fragments next."""
        monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", "off")
        q = ("select g, sum(w + 2) from cs where v < 77 "
             "group by g order by g")
        q2 = ("select g, min(w + 3) from cs where v < 76 "
              "group by g order by g")

        def body(side, tk):
            tk.must_exec("set tidb_compile_async = 'ON'")
            tk.must_exec("set global tidb_compile_timeout = 30")
            try:
                s0 = side.stats()
                tk.must_query(q)
                assert side.cs.wait_idle(60.0)
                s1 = side.stats()
                bg = (s1["bg_compile_s"] > s0["bg_compile_s"],
                      s1["compile_s"] == s0["compile_s"])
            finally:
                tk.must_exec("set global tidb_compile_timeout = 0")
                tk.must_exec("set tidb_compile_async = 'OFF'")
            tk.must_exec("set tidb_device_call_timeout = 5")
            try:
                s0 = side.stats()
                tk.must_query(q2)
                s1 = side.stats()
                return bg, s1["compile_s"] > s0["compile_s"]
            finally:
                tk.must_exec("set tidb_device_call_timeout = 0")
        assert both(kits, body) == ((True, True), True)

    def test_bg_compile_charged_to_bg_mirror(self, kits):
        def body(side, _tk):
            st = side.stats()
            return st["bg_compile_s"] > 0, st["bg_traces"] >= 1
        assert both(kits, body) == (True, True)


# -- tests/test_tracing.py: the background build's linked child trace --------

#: filter constants no other test of the process uses (tests/test_tracing.py
#: counts up from 777001), so the query's pipeline is cold in both packages
_UNIQ = iter(range(-10 ** 9, -777001))


class TestThreadPropagation:
    def test_bg_compile_links_child_trace(self, monkeypatch):
        monkeypatch.setenv("TIDB_TPU_COMPILE_INDEX", "off")
        q = (f"select b, sum(a) from t where a > {next(_UNIQ)} "
             "group by b order by b")

        def body(side, _tk):
            tracing = __import__(f"{side.pkg}.session.tracing",
                                 fromlist=["tracing"])
            tk = side.Kit()
            tk.must_exec("create table t (a int primary key, b int, "
                         "c varchar(16))")
            tk.must_exec("insert into t values " + ",".join(
                f"({i}, {i % 3}, 'v{i % 5}')" for i in range(16)))
            tk.must_exec("set tidb_executor_engine = 'tpu'")
            tk.must_exec("set tidb_compile_async = 'ON'")
            tk.must_exec("set tidb_trace_sampling_rate = 1")
            tk.must_query(q)
            assert side.cs.wait_idle(30)
            parent = tracing.last_trace(tk.session.conn_id)
            links = [tg for sp in parent.spans
                     for (_t, n, tg) in sp.events
                     if n == "linked_child_trace"]
            ch = next(t for t in tracing.recent_traces()
                      if t.trace_id == links[0]["trace_id"])
            return (parent.origin, len(links), ch.origin,
                    ch.parent_id == parent.trace_id, ch.name,
                    "supervisor.call" in [sp.name for sp in ch.spans],
                    tracing.verify_drained()["ok"])
        assert both({"ref": None, "port": None}, body) == (
            "sampled", 1, "child", True, "compile.bg", True, True)


# -- the compile layer's gate ---------------------------------------------

class TestLaunchConfinementLint:
    def test_kernel_launches_confined_to_build_launch(self):
        """Registry rule (tidb_tpu_torch/lint rules/confinement.py): the
        kernel library is loaded and its launchers declared only in
        ops/kernels/, and every launcher call goes through build.launch,
        which runs it under its tensors' card and counts it — the port's
        counterpart of the reference's raw jax.jit confinement."""
        from tidb_tpu_torch.lint import RULES, run_rule
        findings = run_rule("launch-confinement")
        assert not findings, [f.to_json() for f in findings]
        assert RULES["launch-confinement"].allowlistable is False
