"""The port's static checker (``tidb_tpu_torch/lint``) against the
reference's (``tidb_tpu/lint``).

The engine and 18 of the 20 rules are the reference's.  Every case of
tests/test_lint.py runs in both packages through ``torch_dual.dual`` —
the reference body, then the body retargeted to ``tidb_tpu_torch``, each
with the reference test's own assertions — but these, which the port's
cases below take the place of:

* ``TestConfinementRules.test_jit_confinement``, ``test_jit_aot_chain``
  and ``test_confinement_not_allowlistable``: the port has no
  ``jax.jit``; its ``launch-confinement`` replaces ``jit-confinement``
  (``TestLaunchConfinement``);
* ``TestTracedValueHazard`` (2 cases): the port has no trace; its
  ``pipeline-host-sync`` replaces ``traced-value-hazard``
  (``TestPipelineHostSync``);
* ``TestFullRepo`` (7 cases): each lints the reference's whole tree; the
  port's tree is ``TestPortTree``, one report shared by its cases, and
  ``TestParity`` runs the port's engine over the reference's tree.

``TestParity``: the port's engine and its 18 unchanged rules over
``tidb_tpu/`` with the reference's allowlist give the reference's own
findings, allowlisted keys and stale entries, rule by rule — a copy
error in the retargeting (a ``package="tidb_tpu"`` default left behind,
which blinds the cross-module rules to the port's absolute imports)
shows here or in ``TestImportMap``.

The port's budget (``TestPortTree.test_runtime_budget``) is in CPU
seconds of the linting process (``time.process_time``), so a loaded
test box does not fail it: a full run over ``tidb_tpu_torch/`` took
21.2-25.0 CPU s in process (28.3-28.5 s of user time through the CLI,
interpreter start included) on an idle 8-core x86 CPU, and the budget
is 60, about twice the largest.
"""

import ast
import json
import os
import re
import subprocess
import sys
import time

import pytest

import tidb_tpu.lint.rules  # noqa: F401 — populate the reference registry
import tidb_tpu_torch.lint.rules  # noqa: F401 — and the port's
from tidb_tpu.lint import engine as ref_engine
from tidb_tpu_torch.lint import (Allowlist, Context, RULES, collect,
                                 default_allowlist_path, run_rules)
from tidb_tpu_torch.lint.engine import SourceFile
from tidb_tpu_torch.lint.rules import confinement
from tidb_tpu_torch.lint.rules._util import import_map
from torch_dual import dual

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: CPU seconds of one full run of the port's lint (see the module note)
BUDGET_CPU_S = 60.0

RENAMED = {"jit-confinement": "launch-confinement",
           "traced-value-hazard": "pipeline-host-sync"}
SHARED = sorted(set(ref_engine.RULES) - set(RENAMED))

globals().update(dual("test_lint.py", exclude=(
    "TestConfinementRules.test_jit_confinement",
    "TestConfinementRules.test_jit_aot_chain",
    "TestConfinementRules.test_confinement_not_allowlistable",
    "TestTracedValueHazard", "TestFullRepo")))


def make_ctx(files: dict) -> Context:
    return Context([SourceFile(rel, rel, text, ast.parse(text))
                    for rel, text in files.items()])


def run_one(rule: str, files: dict):
    return RULES[rule].run(make_ctx(files))


# -- the registry -------------------------------------------------------------

class TestRegistry:
    def test_reference_rules_with_two_renames(self):
        want = {RENAMED.get(n, n) for n in ref_engine.RULES}
        assert set(RULES) == want
        assert len(RULES) == 20

    def test_renamed_rules_keep_their_allowlist_rule(self):
        assert RULES["launch-confinement"].allowlistable is False
        assert RULES["pipeline-host-sync"].allowlistable is True
        for name in SHARED:
            assert (RULES[name].allowlistable
                    == ref_engine.RULES[name].allowlistable), name


# -- the package the import map resolves --------------------------------------

class TestImportMap:
    SRC = ("import tidb_tpu_torch.executor.scheduler as sched\n"
           "from tidb_tpu_torch.ops import residency\n"
           "from . import supervisor\n")

    def test_default_package_is_the_port(self):
        m = import_map(ast.parse(self.SRC), "executor/x.py")
        assert m["sched"] == "executor/scheduler"
        assert m["residency"] == "ops/residency"
        assert m["supervisor"] == "executor/supervisor"

    def test_reference_imports_resolve_only_when_asked(self):
        src = self.SRC.replace("tidb_tpu_torch", "tidb_tpu")
        assert "sched" not in import_map(ast.parse(src), "executor/x.py")
        m = import_map(ast.parse(src), "executor/x.py", package="tidb_tpu")
        assert m["sched"] == "executor/scheduler"

    def test_context_carries_its_package(self):
        assert make_ctx({}).package == "tidb_tpu_torch"
        ctx = collect(ROOT, package="tidb_tpu", aux=())
        assert ctx.package == "tidb_tpu"
        assert ctx.file("lint/engine.py") is not None

    def test_cross_module_guard_votes_through_absolute_imports(self):
        # the reference's cross-module case, written with an absolute
        # import of the port: the vote must still see the clearer
        guarded = ("import threading\n_LOCK = threading.Lock()\n"
                   "_CACHE = {}\n\ndef locked_read(k):\n    with _LOCK:\n"
                   "        return _CACHE.get(k)\n\n"
                   "def locked_write(k, v):\n    with _LOCK:\n"
                   "        _CACHE[k] = v\n")
        clearer = ("from tidb_tpu_torch.executor import scheduler\n"
                   "def clear_all():\n    scheduler._CACHE.clear()\n")
        out = run_one("guarded-state",
                      {"executor/scheduler.py": guarded,
                       "executor/supervisor.py": clearer})
        assert [f.ident for f in out] == ["unguarded:_CACHE@clear_all"]


# -- launch-confinement -------------------------------------------------------

#: the fault ops/kernels/build.py launch repaired: a launcher called on
#: the calling thread's current card
DIRECT = """
from . import build

def run(hdr, stream):
    fn = build.declare("x_run", 2)
    return fn(hdr, stream)
"""

THROUGH_LAUNCH = """
from . import build

def run(dev, hdr, stream):
    fn = build.declare("x_run", 2)
    return build.check(build.launch(dev, fn, hdr, stream), "x_run")
"""

CACHES = """
import functools
from . import build
_FN = [None]
_FNS = {}

def _kernel():
    if _FN[0] is None:
        _FN[0] = build.declare("k_run", 2)
    return _FN[0]

def _fn(name):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = build.declare(name, 2)
    return fn

def _launch(name, dev, hdr):
    build.check(build.launch(dev, _fn(name), hdr), name)

def good(dev, hdr):
    build.launch(dev, _kernel(), hdr)
    _launch("a_run", dev, hdr)
    f = _fn("b_run")
    build.launch(dev, f, hdr)

def bad(dev, hdr):
    _kernel()(hdr)
    _FN[0](hdr)
    _FNS["a_run"](hdr)
    g = _fn("c_run")

    def inner():
        return g(hdr)
    functools.partial(_kernel(), hdr)
    build.lib().k_run(hdr)
"""

#: a bound library and one of its attributes handed to build.launch
HANDLE = """
from . import build

def run(dev, hdr):
    L = build.lib()
    L.x_run(hdr)
    build.launch(dev, build.lib().x_run, hdr)
"""

#: build under another name
ALIAS = """
from . import build as kb

def run(hdr):
    fn = kb.declare("x_run", 2)
    fn(hdr)
"""

SYMBOLS = """
from .build import declare, launch as go

def run(dev, hdr):
    go(dev, declare("x_run", 2), hdr)
    go(dev, hdr, hdr)
"""

OWN_LAUNCH = """
from . import build

def launch(dev, fn, *a):
    return fn(*a)

def run(dev, hdr):
    fn = build.declare("x_run", 2)
    launch(dev, fn, hdr)
"""


class TestLaunchConfinement:
    def test_direct_launcher_call_flagged(self):
        out = run_one("launch-confinement", {"ops/kernels/x.py": DIRECT})
        assert [f.ident for f in out] == ["direct-call@run"]

    def test_call_through_build_launch_clean(self):
        assert run_one("launch-confinement",
                       {"ops/kernels/x.py": THROUGH_LAUNCH}) == []

    def test_caches_helpers_and_locals(self):
        out = run_one("launch-confinement", {"ops/kernels/x.py": CACHES})
        assert sorted(f.ident for f in out) == sorted([
            "direct-call@bad", "direct-call@bad#1", "direct-call@bad#2",
            "build.lib@bad", "direct-call@bad.inner", "escape@bad"])

    def test_library_handle_flagged(self):
        """``build.lib`` in a kernel module is flagged where it is read:
        a handle bound to it, and ``build.launch`` of one of its
        attributes (a C function no declare saw)."""
        out = run_one("launch-confinement", {"ops/kernels/x.py": HANDLE})
        assert sorted(f.ident for f in out) == [
            "build.lib@run", "build.lib@run", "launch-fn@run"]
        out = run_one("launch-confinement", {
            "ops/kernels/x.py": "from .build import lib\n"})
        assert [f.ident for f in out] == ["import-build@<module>"]

    def test_build_resolved_through_aliases(self):
        out = run_one("launch-confinement", {"ops/kernels/x.py": ALIAS})
        assert [f.ident for f in out] == ["direct-call@run"]
        outside = ALIAS.replace("from . import build as kb",
                                "from ..ops.kernels import build as kb")
        out = run_one("launch-confinement", {"executor/rogue.py": outside})
        assert [f.ident for f in out] == ["build.declare@run"]
        absolute = ALIAS.replace(
            "from . import build as kb",
            "import tidb_tpu_torch.ops.kernels.build as kb")
        out = run_one("launch-confinement", {"ops/kernels/x.py": absolute})
        assert [f.ident for f in out] == ["direct-call@run"]
        # build's own functions imported by name, under another name
        out = run_one("launch-confinement", {"ops/kernels/x.py": SYMBOLS})
        assert [f.ident for f in out] == ["launch-fn@run"]

    def test_own_launch_helper_is_not_builds(self):
        """A module's own function called ``launch`` does not exempt its
        fn argument: handing it a launcher is an escape."""
        out = run_one("launch-confinement",
                      {"ops/kernels/x.py": OWN_LAUNCH})
        assert [f.ident for f in out] == ["escape@run"]

    def test_declare_outside_kernels_flagged(self):
        out = run_one("launch-confinement",
                      {"executor/rogue.py": THROUGH_LAUNCH})
        assert [f.ident for f in out] == ["build.declare@run"]
        src = ("import ctypes\nfrom ..ops.kernels.build import lib\n"
               "L = ctypes.CDLL('libx.so')\n")
        out = run_one("launch-confinement", {"session/rogue.py": src})
        assert {f.ident for f in out} == {"import-build@<module>",
                                         "ctypes.CDLL@<module>"}
        # the KV store's host library and the kernel library's own loader
        # are rule config
        assert run_one("launch-confinement",
                       {"kv/native.py": "import ctypes\n"
                                        "L = ctypes.CDLL('x')\n"}) == []
        assert run_one("launch-confinement",
                       {"ops/kernels/build.py": "import ctypes\n"
                        "def lib():\n    return ctypes.CDLL('x')\n"}) == []
        out = run_one("launch-confinement",
                      {"ops/kernels/x.py": "import ctypes\n"
                                           "L = ctypes.CDLL('x')\n"})
        assert [f.ident for f in out] == ["ctypes.CDLL@<module>"]

    def test_not_allowlistable(self, tmp_path):
        """An allowlist line cannot silence the gate: the finding stays
        and the entry goes stale."""
        p = tmp_path / "al.txt"
        p.write_text("launch-confinement ops/kernels/x.py:* -- nope\n")
        report = run_rules(make_ctx({"ops/kernels/x.py": DIRECT}),
                           Allowlist.load(str(p)),
                           rules=["launch-confinement"])
        assert [f.ident for f in report.findings] == ["direct-call@run"]
        assert len(report.stale) == 1
        assert not report.ok

    def test_declared_names_followed_through_helpers(self):
        names, unread = confinement.declared_launchers(
            make_ctx({"ops/kernels/x.py": CACHES}))
        assert set(names) == {"k_run", "a_run", "b_run", "c_run"}
        assert unread == []
        src = ("from . import build\n\ndef f(n):\n"
               "    name = n + '_run'\n    return build.declare(name, 2)\n")
        out = run_one("launch-confinement", {"ops/kernels/y.py": src})
        assert [f.ident for f in out] == ["declare-unnamed@f"]

    def test_port_declares_every_exported_launcher(self):
        """The static view of ops/kernels/ names every launcher the
        sources export (every ``extern "C" int``), and nothing else."""
        names, unread = confinement.declared_launchers(collect(ROOT,
                                                               aux=()))
        csrc = os.path.join(ROOT, "tidb_tpu_torch", "ops", "kernels", "csrc")
        exported = set()
        for f in os.listdir(csrc):
            if f.endswith(".cu"):
                with open(os.path.join(csrc, f)) as fh:
                    exported |= set(re.findall(r'extern "C" int (\w+)\(',
                                               fh.read()))
        assert unread == []
        assert set(names) == exported
        assert len(names) == 15


# -- pipeline-host-sync -------------------------------------------------------

PIPE = """
def _timed_jit(fn, t0=None):
    return fn

def build(prog):
    def body(x, n):
        if n > 0:
            x = x + 1
        return x.sum().item()
    return _timed_jit(body)

def plain(x, n):
    if n > 0:
        x = x + 1
    return x.sum().item()
"""


class TestPipelineHostSync:
    def test_item_and_branch_in_body_flagged(self):
        out = run_one("pipeline-host-sync", {"executor/m.py": PIPE})
        assert {f.ident for f in out} == {"branch@build.body",
                                          "item@build.body"}
        assert all("host sync" in f.msg for f in out)

    def test_same_code_outside_a_body_clean(self):
        src = PIPE.replace("return _timed_jit(body)", "return body")
        assert run_one("pipeline-host-sync", {"executor/m.py": src}) == []

    def test_metadata_clean_reads_flagged(self):
        src = ("def f(env, xs, n):\n"
               "    d = xs.device if env else None\n"
               "    m = len(xs) + xs.shape[0]\n"
               "    for i in range(n):\n        pass\n"
               "    for v in xs:\n        pass\n"
               "    return int(n), xs.tolist(), xs.dtype, m, d\n"
               "p = _Pipeline(f)\n")
        out = run_one("pipeline-host-sync", {"executor/m.py": src})
        assert sorted(f.ident for f in out) == sorted([
            "branch@f", "iterate@f", "iterate@f#1", "int@f", "tolist@f"])

    def test_locals_computed_from_arguments_flagged(self):
        """A local computed from an argument carries it (``m = x.sum()``,
        a loop variable, a nested def's local); one the body makes from
        nothing of its arguments does not."""
        src = ("def f(x, n):\n"
               "    m = x.sum()\n"
               "    if m:\n        pass\n"
               "    y = x * 2\n"
               "    k = [1]\n"
               "    if k:\n        pass\n"
               "    for v in [m]:\n        w = v\n"
               "    def g(z):\n"
               "        t = y + z\n        return t.item()\n"
               "    return y.item(), bool(w), g\n"
               "p = _Pipeline(f)\n")
        out = run_one("pipeline-host-sync", {"executor/m.py": src})
        assert sorted(f.ident for f in out) == sorted([
            "branch@f", "item@f", "item@f#1", "bool@f", "iterate@f"])

    def test_forwarding_wrapper_makes_a_body(self):
        src = ("def _built(step, t0):\n"
               "    from ..executor.device_exec import _timed_jit\n"
               "    return _timed_jit(step, t0)\n\n"
               "def dist(t0):\n"
               "    def step(x):\n        return bool(x)\n"
               "    return _built(step, t0)\n")
        out = run_one("pipeline-host-sync", {"parallel/m.py": src})
        assert [f.ident for f in out] == ["bool@dist.step"]


# -- the port's own tree ------------------------------------------------------

def _cli(*args):
    return subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.lint", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)


def _done(proc):
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def port_runs():
    """One fresh full run of the port's lint in this process (its CPU
    seconds timed), with the CLI runs the cases read started beside it
    in child processes."""
    procs = {"json": _cli("--json"),
             "filtered": _cli("--rule", "guarded-state", "--path",
                              "executor/*", "--json"),
             "stats": _cli("--rule", "lock-order", "--stats")}
    try:
        t0 = time.process_time()
        ctx = collect(ROOT)  # fresh Context: no cached analysis models
        report = run_rules(ctx, Allowlist.load(default_allowlist_path()))
        cpu_s = time.process_time() - t0
    finally:
        cli = {k: _done(p) for k, p in procs.items()}
    return {"report": report, "cpu_s": cpu_s, "cli": cli}


class TestPortTree:
    def test_clean(self, port_runs):
        report = port_runs["report"]
        assert len(report.rules_run) == 20
        assert not report.findings, report.human()

    def test_no_stale_entries(self, port_runs):
        assert not port_runs["report"].stale, port_runs["report"].human()

    def test_every_entry_has_a_reason(self, port_runs):
        al = Allowlist.load(default_allowlist_path())
        assert al.entries
        for e in al.entries:
            assert e.reason and not e.reason.startswith("TODO"), e.pattern
        assert all(e.reason for _f, e in port_runs["report"].allowlisted)

    def test_launch_confinement_finds_nothing(self, port_runs):
        report = port_runs["report"]
        assert not [f for f in report.findings
                    if f.rule == "launch-confinement"]
        assert not [f for f, _e in report.allowlisted
                    if f.rule == "launch-confinement"]

    def test_host_sync_inventory(self, port_runs):
        """Every Python read inside a pipeline body, of its arguments or
        of a local computed from them, is written down."""
        got = sorted(f.key for f, _e in port_runs["report"].allowlisted
                     if f.rule == "pipeline-host-sync")
        assert got == sorted([
            "executor/device_exec.py:int@_build_pipeline.pipeline",
            "executor/device_exec.py:int@_build_pipeline.pipeline#1",
            "executor/device_exec.py:branch@_build_pipeline.pipeline",
            "executor/device_exec.py:int@_topk_indices.run",
            "executor/device_exec.py:branch@device_window.build.run",
            "executor/device_exec.py:branch@device_window.build.run#1",
            "executor/device_join.py:branch@compile_fragment.run",
            "executor/device_join.py:int@compile_fragment.run"])

    def test_cli_json_exit_zero(self, port_runs):
        rc, out, err = port_runs["cli"]["json"]
        assert rc == 0, out + err
        payload = json.loads(out)
        assert payload["ok"] is True
        assert payload["counts"]["findings"] == 0
        assert payload["counts"]["stale_allowlist"] == 0
        assert (payload["counts"]["allowlisted"]
                == len(port_runs["report"].allowlisted))
        assert set(payload["timings_s"]) - {"shared-models"} \
            == set(payload["rules"])

    def test_cli_rule_and_path_filters(self, port_runs):
        rc, out, err = port_runs["cli"]["filtered"]
        assert rc == 0, out + err
        payload = json.loads(out)
        assert payload["rules"] == ["guarded-state"]
        assert payload["counts"]["findings"] == 0
        assert payload["allowlisted"]
        assert all(f["file"].startswith("executor/")
                   for f in payload["allowlisted"])
        assert payload["counts"]["stale_allowlist"] == 0
        rc, out, err = port_runs["cli"]["stats"]
        assert rc == 0, out + err
        assert "lock-order" in out and "ms" in out

    def test_runtime_budget(self, port_runs):
        """A fresh full run (parse and every rule, shared models
        included) in under BUDGET_CPU_S CPU seconds of this process."""
        assert port_runs["cpu_s"] < BUDGET_CPU_S, (
            f"full port lint took {port_runs['cpu_s']:.1f} CPU s "
            f"(budget {BUDGET_CPU_S:.0f})")


# -- the port's engine over the reference's tree ------------------------------

def _keys(report, rule):
    return (sorted(f.key for f in report.findings if f.rule == rule),
            sorted(f.key for f, _e in report.allowlisted if f.rule == rule),
            sorted(e.pattern for e in report.stale if e.rule == rule))


@pytest.fixture(scope="module")
def parity_runs():
    ref_al = ref_engine.default_allowlist_path()
    ref = ref_engine.run_rules(ref_engine.collect(ROOT),
                               ref_engine.Allowlist.load(ref_al), SHARED)
    port = run_rules(collect(ROOT, package="tidb_tpu"),
                     Allowlist.load(ref_al), SHARED)
    return ref, port


class TestParity:
    @pytest.mark.parametrize("rule", SHARED)
    def test_same_report_over_the_reference(self, parity_runs, rule):
        ref, port = parity_runs
        assert _keys(port, rule) == _keys(ref, rule)

    def test_rules_ran_and_found_sites(self, parity_runs):
        ref, port = parity_runs
        assert port.rules_run == ref.rules_run == SHARED
        # the comparison is not of two empty reports
        assert len(port.allowlisted) == len(ref.allowlisted) > 100
