"""Run a reference test file's cases in both packages and compare them.

:func:`dual` loads ``tests/<file>`` twice: as written (``tidb_tpu``) and
with every ``tidb_tpu`` retargeted to ``tidb_tpu_torch`` (plus any edits
the port needs, given as exact text replacements).  It returns the names
a port test module puts in its globals:

* every fixture of the file under two names, ``<name>__ref`` and
  ``<name>__port``, each built by its own copy of the file (a fixture's
  parameters that name other fixtures of the file are renamed likewise;
  ``tmp_path`` becomes ``tmp_path/ref`` or ``tmp_path/port``);
* for every test function, and every ``test_*`` method of a ``Test*``
  class, one test of the same name and marks that runs the reference
  body on the reference's fixtures, then the port body on the port's,
  each with the reference test's own assertions, and asserts that the
  port's record equals the reference's.

The record of one body is ``record(pkg)`` taken after it minus the one
taken before, key by key where both are dicts of numbers (a counter that
moved by the same amount in both packages), or the value after where it
is not a dict.  ``None`` records nothing.  The collector runs before each
body, so no finalizer of an earlier test's garbage fires inside one.

Both packages' process-wide compile state — the pipe cache, the learned
capacities, the hybrid join's throughput memo, the compile service's
recipes — is cleared before each body and after the test
(:func:`clear_compile_state`), so each body starts as in a fresh process
and the reference's own test file, run later in the same process, finds
none of it.  :func:`isolated` is a module fixture for any test file that
drives the reference: it clears that state and stops the DDL worker
threads its domains started (an idle reference DDL worker claims the
owner cell of whatever fabric segment a later test activates).
"""

import gc
import importlib
import inspect
import os
import re
import sys
import threading
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
TAGS = ("ref", "port")
PKGS = ("tidb_tpu", "tidb_tpu_torch")


def clear_compile_state():
    """Drop both packages' compiled pipelines, learned capacities,
    hybrid throughput memo and compile recipes (waiting out background
    builds first)."""
    for pkg in PKGS:
        cs = importlib.import_module(f"{pkg}.executor.compile_service")
        cs.wait_idle(30.0)
        de = importlib.import_module(f"{pkg}.executor.device_exec")
        with de._PIPE_LOCK:
            de._PIPE_CACHE.clear()
        with cs._LOCK:
            cs._RECIPES.clear()
            cs._ORIGIN.clear()
        importlib.import_module(f"{pkg}.executor.device_join")._CAP_STORE \
            .clear()
        importlib.import_module(f"{pkg}.executor.hybrid_join")._THROUGHPUT \
            .clear()


def _ddl_workers() -> dict:
    out = {}
    for t in threading.enumerate():
        w = getattr(getattr(t, "_target", None), "__self__", None)
        if t.name == "ddl-worker" and w is not None:
            out[id(t)] = w
    return out


@pytest.fixture(scope="module")
def isolated():
    """Module fixture: clear both packages' compile state around the
    module and stop the DDL worker threads it started."""
    before = set(_ddl_workers())
    clear_compile_state()
    yield
    clear_compile_state()
    for tid, w in _ddl_workers().items():
        if tid not in before:
            w.stop()


class _FixtureSpec:
    def __init__(self, fn, kw):
        self.fn, self.kw = fn, kw

    @property
    def name(self):
        return self.kw.get("name") or self.fn.__name__


class _PytestProxy:
    """``pytest`` as the loaded file sees it: ``fixture`` records the
    fixture (re-registered under the package's name by :func:`dual`)."""

    def __init__(self):
        self.specs = []

    def fixture(self, *args, **kw):
        if args and callable(args[0]) and not kw:
            spec = _FixtureSpec(args[0], {})
            self.specs.append(spec)
            return spec

        def deco(fn):
            spec = _FixtureSpec(fn, dict(kw))
            self.specs.append(spec)
            return spec
        return deco

    def __getattr__(self, name):
        return getattr(pytest, name)


def _retarget(src: str) -> str:
    return re.sub(r"\btidb_tpu\b(?!_torch)", "tidb_tpu_torch", src)


def _load(path, tag, patches):
    with open(path) as f:
        src = f.read()
    if tag == "port":
        src = _retarget(src)
        for old, new in patches:
            if src.count(old) != 1:
                raise AssertionError(f"port patch not found once in "
                                     f"{os.path.basename(path)}: {old!r}")
            src = src.replace(old, new)
    src = re.sub(r"^import pytest$", "import pytest\npytest = __dual_pytest__",
                 src, flags=re.M)
    name = f"_dual_{tag}_{os.path.splitext(os.path.basename(path))[0]}"
    mod = types.ModuleType(name)
    mod.__file__ = path
    proxy = _PytestProxy()
    mod.__dict__["__dual_pytest__"] = proxy
    sys.modules[name] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod, proxy.specs


def _params(fn, skip_self):
    ps = list(inspect.signature(fn).parameters)
    return ps[1:] if skip_self else ps


def _arg(p, tag, fixtures, kw):
    if p in fixtures:
        return kw[f"{p}__{tag}"]
    if p == "tmp_path":
        d = kw["tmp_path"] / tag
        d.mkdir(exist_ok=True)
        return d
    return kw[p]


def _outer(params, fixtures):
    out = []
    for p in params:
        if p in fixtures:
            out += [f"{p}__{t}" for t in TAGS]
        elif p not in out:
            out.append(p)
    return out


def _with_signature(fn, names, self_first=False):
    ps = [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
          for n in (["self"] if self_first else []) + names]
    fn.__signature__ = inspect.Signature(ps)
    return fn


def _fixture(spec, tag, fixtures, owner=None):
    """The file's fixture `spec` of package `tag`, renamed."""
    fn = spec.fn
    params = _params(fn, owner is not None)
    outer = [f"{p}__{tag}" if p in fixtures else p for p in params]

    def call(kw):
        args = {p: (kw[f"{p}__{tag}"] if p in fixtures else
                    _arg(p, tag, fixtures, kw)) for p in params}
        if owner is not None:
            return fn(owner(), **args)
        return fn(**args)
    if inspect.isgeneratorfunction(fn):
        def wrapped(*a, **kw):
            yield from call(kw)
    else:
        def wrapped(*a, **kw):
            return call(kw)
    _with_signature(wrapped, outer, self_first=owner is not None)
    kw = {k: v for k, v in spec.kw.items() if k != "name"}
    return pytest.fixture(name=f"{spec.name}__{tag}", **kw)(wrapped)


def _delta(before, after):
    if isinstance(before, dict) and isinstance(after, dict):
        return {k: (after[k] - before[k]
                    if isinstance(after[k], (int, float))
                    and not isinstance(after[k], bool)
                    and isinstance(before.get(k), (int, float)) else after[k])
                for k in after}
    return after


def _test(name, getters, params, fixtures, record, mods, drop=(),
          reset=None):
    """One dual test: `getters[tag]()` gives the bound body; the keys in
    `drop` leave its record; `reset(module)` runs before each body."""
    def body(*a, **kw):
        try:
            _bodies(kw)
        finally:
            clear_compile_state()

    def _bodies(kw):
        got = {}
        for tag in TAGS:
            args = {p: _arg(p, tag, fixtures, kw) for p in params}
            # the garbage of earlier tests is collected before a body, so
            # a finalizer does not move a counter in the middle of one
            gc.collect()
            clear_compile_state()
            if reset is not None:
                reset(mods[tag])
            before = record(mods[tag]) if record else None
            getters[tag]()(**args)
            got[tag] = _delta(before, record(mods[tag])) if record else None
            if drop:
                got[tag] = {k: v for k, v in got[tag].items()
                            if k not in drop}
        assert got["port"] == got["ref"], (name, got)
    return body


def dual(ref_file: str, *, patches=(), exclude=(),
         classes=None, record=None, unsteady=None, reset=None) -> dict:
    """The names of a port test module running ``tests/<ref_file>`` in
    both packages (see the module note).  `exclude`: test names (or
    ``Class.test`` names) left out; `classes`: only these ``Test*``
    classes (module-level tests are kept); `record(module)`: the record
    of one body, given the loaded copy of the file (its imports are the
    package's modules); `unsteady`: {test or ``Class.test`` name: record
    keys that thread or collector timing decides in that test}, left out
    of its comparison; `reset(module)`: run before each body (and its
    first record), so both start from the same state of the layer."""
    unsteady = unsteady or {}
    path = os.path.join(HERE, ref_file)
    mods, specs = {}, {}
    for tag in TAGS:
        mods[tag], specs[tag] = _load(path, tag,
                                      patches if tag == "port" else ())
    fixtures = {s.name for s in specs["ref"]}
    out = {"isolated": isolated,
           "_dual_isolated": pytest.fixture(scope="module", autouse=True,
                                            name="_dual_isolated")(
               lambda isolated: None)}
    # module-level fixtures (a Test class's own are attached below)
    for tag in TAGS:
        for spec in specs[tag]:
            if "." not in spec.fn.__qualname__:
                f = _fixture(spec, tag, fixtures)
                out[f"_{spec.name}__{tag}"] = f
    ref = mods["ref"]
    for name, obj in list(vars(ref).items()):
        if name.startswith("test_") and callable(obj) and name not in exclude:
            params = _params(obj, False)
            getters = {t: (lambda t=t, n=name: getattr(mods[t], n))
                       for t in TAGS}
            fn = _test(name, getters, params, fixtures, record, mods,
                       unsteady.get(name, ()), reset)
            _with_signature(fn, _outer(params, fixtures))
            fn.pytestmark = list(getattr(obj, "pytestmark", []))
            fn.__name__ = name
            out[name] = fn
        elif (name.startswith("Test") and isinstance(obj, type)
              and (classes is None or name in classes)
              and name not in exclude):
            attrs = {}
            for tag in TAGS:
                cls_t = getattr(mods[tag], name)
                for spec in specs[tag]:
                    if spec.fn.__qualname__.startswith(name + "."):
                        attrs[f"_{spec.name}__{tag}"] = _fixture(
                            spec, tag, fixtures, owner=cls_t)
            for meth, fobj in vars(obj).items():
                if not meth.startswith("test_") or not callable(fobj) \
                        or f"{name}.{meth}" in exclude or meth in exclude:
                    continue
                params = _params(fobj, True)
                getters = {t: (lambda t=t, c=name, m=meth: getattr(
                    getattr(mods[t], c)(), m)) for t in TAGS}
                inner = _test(f"{name}.{meth}", getters, params, fixtures,
                              record, mods,
                              unsteady.get(f"{name}.{meth}", ()), reset)

                def method(self, *a, _inner=inner, **kw):
                    return _inner(**kw)
                _with_signature(method, _outer(params, fixtures),
                                self_first=True)
                method.pytestmark = list(getattr(fobj, "pytestmark", []))
                method.__name__ = meth
                attrs[meth] = method
            cls = type(name, (), attrs)
            cls.pytestmark = list(getattr(obj, "pytestmark", []))
            out[name] = cls
    return out
