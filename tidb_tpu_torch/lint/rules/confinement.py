"""The confinement rules: the reference's four migrated from their
test-file copies (tests/test_compile_service.py, test_residency.py,
test_scheduler.py, test_supervisor.py) plus the fleet's, sharing the
engine's one parse.  The port's ``launch-confinement`` takes the place
of the reference's ``jit-confinement``: the port compiles no pipeline,
and its architectural gate is the kernel launch.

Each rule carries its sanctioned-layer file set as rule config (these
are permanent architecture facts, not burn-down debt — the allowlist
file is reserved for entries that are supposed to shrink).
"""

from __future__ import annotations

import ast

from ..engine import Rule, register
from ._util import call_name, const_str, dotted, import_map


#: ops/kernels/build.py, as import_map names a module
_BUILD = "ops/kernels/build"


class _BuildRefs:
    """How one file names ``ops/kernels/build.py``: the module under any
    alias and import form (``from . import build as kb``, ``import
    <package>.ops.kernels.build``), spelled ``build`` or ``<x>.build``,
    and its functions imported by name (``from .build import launch as
    go``).  A name of the file's own (a local helper called ``launch``)
    is not build's."""

    def __init__(self, sf, package):
        self.package = package
        self.imap = import_map(sf.tree, sf.rel, package)
        self.syms = {k[:-len("::sym")]: v.split("::", 1)[1]
                     for k, v in self.imap.items()
                     if k.endswith("::sym") and v.split("::", 1)[0] == _BUILD}

    def _module(self, node):
        if isinstance(node, ast.Name):
            return "" if node.id == self.package else self.imap.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._module(node.value)
            if base is not None:
                return f"{base}/{node.attr}" if base else node.attr
        return None

    def is_module(self, node) -> bool:
        name = dotted(node)
        return (name == "build" or name.endswith(".build")
                or self._module(node) == _BUILD)

    def is_fn(self, node, leaves) -> bool:
        """``<build>.<leaf>``, or a name imported from build as one, for
        a leaf in `leaves`."""
        if isinstance(node, ast.Attribute):
            return node.attr in leaves and self.is_module(node.value)
        return isinstance(node, ast.Name) and self.syms.get(node.id) in leaves

    def is_call_of(self, node, leaf) -> bool:
        return isinstance(node, ast.Call) and self.is_fn(node.func, (leaf,))

    def is_import(self, node, leaves) -> bool:
        """``from <build> import <leaf>`` for a leaf in `leaves`."""
        return (isinstance(node, ast.ImportFrom)
                and (node.module or "").split(".")[-1] == "build"
                and any(a.name in leaves for a in node.names))


def _params(fn) -> list:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _own_nodes(body):
    """The nodes of a scope's statements outside its nested scopes."""
    stack = [n for n in body if not isinstance(n, _SCOPES)]
    while stack:
        node = stack.pop()
        yield node
        stack += [c for c in ast.iter_child_nodes(node)
                  if not isinstance(c, _SCOPES)]


def _enclosing_fn(node, parents):
    """The innermost def around `node` (None at module scope)."""
    p = parents.get(id(node))
    while p is not None and not isinstance(
            p, (ast.FunctionDef, ast.AsyncFunctionDef)):
        p = parents.get(id(p))
    return p


class _Launchers:
    """Which expressions of one kernel module are launchers (functions
    ``build.declare`` returned): the call itself, the module caches it
    is stored in (``_FN[0] = ...``, ``_FNS[name] = ...``), the helpers
    that return one (``_kernel()``, ``_fn(...)``), and a local name bound
    to one (closures see their enclosing function's).  Found by a
    fixpoint over the module.  (``build.lib`` itself is flagged in a
    kernel module: its attributes are C functions no declare saw.)"""

    def __init__(self, sf, refs):
        self.sf = sf
        self.refs = refs
        self.caches: set = set()
        self.helpers: set = set()
        self.local: dict = {}     # id(fn) -> launcher-bound local names
        self.fns = [n for n in ast.walk(sf.tree)
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))]
        self.outer = {id(fn): _enclosing_fn(fn, sf.parents())
                      for fn in self.fns}
        changed = True
        while changed:
            changed = self._sweep()

    def names_in(self, fn) -> set:
        """Launcher-bound names visible in `fn` (None: module scope)."""
        if fn is None:
            return set()
        own = self.local.get(id(fn), set())
        inherited = self.names_in(self.outer.get(id(fn))) - set(
            _params(fn))
        return own | inherited

    def is_launcher(self, node, names) -> bool:
        if isinstance(node, ast.Call):
            if self.refs.is_call_of(node, "declare"):
                return True
            if isinstance(node.func, ast.Name) and \
                    node.func.id in self.helpers:
                return True
            f = node.func
            return (isinstance(f, ast.Attribute) and f.attr == "get"
                    and isinstance(f.value, ast.Name)
                    and f.value.id in self.caches)
        if isinstance(node, ast.Subscript):
            return (isinstance(node.value, ast.Name)
                    and node.value.id in self.caches)
        if isinstance(node, ast.Name):
            return node.id in names
        return False

    def _bind(self, targets, fn) -> bool:
        changed = False
        for tgt in targets:
            if isinstance(tgt, ast.Subscript) and isinstance(
                    tgt.value, ast.Name) and \
                    tgt.value.id not in self.caches:
                self.caches.add(tgt.value.id)
                changed = True
            elif isinstance(tgt, ast.Name) and fn is not None:
                own = self.local.setdefault(id(fn), set())
                if tgt.id not in own:
                    own.add(tgt.id)
                    changed = True
        return changed

    def _sweep(self) -> bool:
        changed = False
        scopes = [(None, self.sf.tree.body)] + [(fn, fn.body)
                                               for fn in self.fns]
        for fn, body in scopes:
            names = self.names_in(fn)
            for node in _own_nodes(body):
                if isinstance(node, ast.Assign) and self.is_launcher(
                        node.value, names):
                    changed |= self._bind(node.targets, fn)
                    names = self.names_in(fn)
                elif (isinstance(node, ast.Return) and fn is not None
                        and node.value is not None
                        and fn.name not in self.helpers
                        and self.is_launcher(node.value, names)):
                    self.helpers.add(fn.name)
                    changed = True
        return changed


#: where ``build.declare`` takes the C function's name
_DECLARE_NAME = (0, "name")


def declared_launchers(ctx) -> tuple:
    """The C functions ``build.declare`` is given in ``ops/kernels/``:
    ``({name: "rel:line"}, [(rel, line, qualname)] of declares whose
    name is not a string the module spells out)``.  A name reaches
    ``declare`` as a literal, or through parameters of the module's
    helpers (``_launch("join_probe_run", ...)`` -> ``_fn(name)`` ->
    ``declare(name, ...)``), followed to the literal at each call."""
    names, unread = {}, []
    for sf in ctx.package_files:
        if not sf.rel.startswith(LaunchConfinement.KERNELS) or \
                sf.rel in LaunchConfinement.ALLOWED:
            continue
        refs = _BuildRefs(sf, ctx.package)
        top = {n.name: n for n in sf.tree.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

        # (call, the parameter that carries the name): the declares
        # first, then the calls of each module-level helper that hands a
        # parameter of its own on as the name
        sites = [(n, _DECLARE_NAME) for n in ast.walk(sf.tree)
                 if refs.is_call_of(n, "declare")]
        forwarders: set = set()
        while sites:
            call, (pos, kw) = sites.pop()
            arg = (call.args[pos] if pos is not None and len(call.args) > pos
                   else next((k.value for k in call.keywords
                              if k.arg == kw), None))
            if const_str(arg) is not None:
                names.setdefault(const_str(arg), f"{sf.rel}:{call.lineno}")
                continue
            fn = _enclosing_fn(call, sf.parents())
            if not (isinstance(arg, ast.Name) and fn is not None
                    and top.get(fn.name) is fn
                    and arg.id in _params(fn)):
                unread.append((sf.rel, call.lineno, sf.qualname(call)))
            elif fn.name not in forwarders:
                forwarders.add(fn.name)
                ps = [a.arg for a in fn.args.posonlyargs + fn.args.args]
                param = (ps.index(arg.id) if arg.id in ps else None, arg.id)
                sites += [(n, param) for n in ast.walk(sf.tree)
                          if isinstance(n, ast.Call)
                          and isinstance(n.func, ast.Name)
                          and n.func.id == fn.name]
    return names, unread


@register
class LaunchConfinement(Rule):
    """The kernel library is loaded, and its launchers declared, only in
    ``ops/kernels/``, and every launcher call there goes through
    ``ops/kernels/build.py launch(dev, fn, ...)``: ``launch`` makes the
    tensors' card current for the call and counts it in
    ``build.CARD_LAUNCHES``.  A launcher called directly launches on the
    calling thread's current card, whatever card its tensors are on,
    and no count sees it.

    Flagged: (a) ``build.declare`` outside ``ops/kernels/``,
    ``build.lib`` anywhere but ``build.py`` (its attributes are C
    functions no declare saw), and ``ctypes.CDLL`` anywhere but
    ``build.py`` and ``kv/native.py`` (which loads the KV store's host
    library, not the kernel library); (b) inside ``ops/kernels/``, a
    launcher (see :class:`_Launchers`) called, or handed to any call,
    other than as the ``fn`` argument of ``build.launch``; a
    ``build.launch`` whose ``fn`` is not such a launcher; and a
    ``build.declare`` whose C function name the module does not spell
    out as a string (:func:`declared_launchers` must see every
    launcher).  ``build`` is resolved through the file's imports, under
    any alias; a module's own function called ``launch`` or ``declare``
    is not build's."""

    name = "launch-confinement"
    allowlistable = False
    title = "kernel launches confined to ops/kernels/build.py launch"

    #: the kernel modules: they declare launchers and launch them
    KERNELS = "ops/kernels/"
    #: the sanctioned layer: it loads the library, defines launch and
    #: check, and reads the library's error strings
    ALLOWED = ("ops/kernels/build.py",)
    #: the two ctypes loaders: the kernel library's, and the KV store's
    #: host library (native/), which holds no kernel
    CDLL_ALLOWED = ("ops/kernels/build.py", "kv/native.py")

    def run(self, ctx):
        out = []
        for sf in ctx.package_files:
            refs = _BuildRefs(sf, ctx.package)
            out += self._loads(sf, refs)
            if sf.rel.startswith(self.KERNELS) and \
                    sf.rel not in self.ALLOWED:
                out += self._calls(sf, refs)
        for rel, line, qn in declared_launchers(ctx)[1]:
            out.append(self.finding(
                rel, line, f"declare-unnamed@{qn}",
                "build.declare of a C function whose name is not a string "
                "literal of this module (directly or through a helper's "
                "parameter): the launcher inventory cannot see it"))
        return out

    def _loads(self, sf, refs):
        out = []
        if sf.rel in self.ALLOWED:
            banned = ()
        elif sf.rel.startswith(self.KERNELS):
            banned = ("lib",)
        else:
            banned = ("lib", "declare")
        for node in ast.walk(sf.tree):
            hit = None
            if isinstance(node, ast.Attribute) and refs.is_fn(node, banned):
                hit = f"build.{node.attr}"
            elif refs.is_import(node, banned):
                hit = "import-build"
            elif sf.rel not in self.CDLL_ALLOWED and (
                    (isinstance(node, ast.Attribute)
                     and node.attr in ("CDLL", "cdll")
                     and dotted(node.value) == "ctypes")
                    or (isinstance(node, ast.ImportFrom)
                        and node.module == "ctypes"
                        and any(a.name in ("CDLL", "cdll")
                                for a in node.names))):
                hit = "ctypes.CDLL"
            if hit is not None:
                out.append(self.finding(
                    sf.rel, node.lineno, f"{hit}@{sf.qualname(node)}",
                    f"{hit} outside its layer: the kernel library is "
                    "loaded in ops/kernels/build.py, and its launchers "
                    "declared in ops/kernels/ only"))
        return out

    def _calls(self, sf, refs):
        out = []
        seen: dict = {}
        ln = _Launchers(sf, refs)
        parents = sf.parents()

        def emit(node, kind, msg):
            base = f"{kind}@{sf.qualname(node)}"
            k = seen.get(base, 0)
            seen[base] = k + 1
            out.append(self.finding(sf.rel, node.lineno,
                                    base + (f"#{k}" if k else ""), msg))

        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            names = ln.names_in(_enclosing_fn(node, parents))
            if ln.is_launcher(node.func, names):
                emit(node, "direct-call",
                     "launcher called directly: it launches on the "
                     "thread's current card and no count sees it (call "
                     "build.launch(dev, fn, ...))")
                continue
            args = list(node.args) + [k.value for k in node.keywords]
            if refs.is_call_of(node, "launch"):
                fn = (node.args[1] if len(node.args) > 1 else
                      next((k.value for k in node.keywords
                            if k.arg == "fn"), None))
                if fn is None or not ln.is_launcher(fn, names):
                    emit(node, "launch-fn",
                         "build.launch of a function that is not a "
                         "declared launcher (build.declare, through a "
                         "cache, a helper or a local): the launcher "
                         "inventory cannot see it")
                args = [a for a in args if a is not fn]
            for a in args:
                if ln.is_launcher(a, names):
                    emit(node, "escape",
                         "launcher handed to a call other than "
                         "build.launch's fn argument")
        return out


@register
class DeviceSlotConfinement(Rule):
    """Any direct read/write of ``._device`` outside ops/residency.py is
    unaccounted HBM caching — the ledger (budget, epoch, OOM eviction)
    only works if every cached upload goes through the manager.  The
    ``self._device = None`` slot inits in the Column constructors
    (NONE_INIT_ALLOWED) are the one sanctioned exception."""

    name = "device-slot-confinement"
    allowlistable = False
    title = "._device access confined to the residency manager"

    #: the residency manager owns the slot; the Column constructors may
    #: initialize it to None (a fresh column has no cache to account)
    ALLOWED = ("ops/residency.py",)
    NONE_INIT_ALLOWED = ("utils/chunk.py",)

    def run(self, ctx):
        out = []
        for sf in ctx.package_files:
            if sf.rel in self.ALLOWED:
                continue
            none_inits = set()
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Constant)
                        and node.value.value is None):
                    for tgt in node.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and tgt.attr == "_device"):
                            none_inits.add(id(tgt))
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.Attribute)
                        and node.attr == "_device"):
                    continue
                if id(node) in none_inits:
                    if sf.rel in self.NONE_INIT_ALLOWED:
                        continue
                    ident = f"_device=None@{sf.qualname(node)}"
                    msg = ("._device = None slot init outside "
                           "ops/residency.py")
                else:
                    ident = f"_device@{sf.qualname(node)}"
                    msg = ("._device accessed outside ops/residency.py "
                           "(unaccounted HBM caching)")
                out.append(self.finding(sf.rel, node.lineno, ident, msg))
        return out


@register
class SupervisedConfinement(Rule):
    """Every device dispatch must pass the admission queue: direct
    ``call_supervised`` / ``supervised_call`` use is confined to
    run_device (which admits first), the scheduler, and the compile
    service's bounded worker pool — a new dispatch path must not silently
    bypass per-tenant scheduling."""

    name = "supervised-confinement"
    allowlistable = False
    title = "supervised dispatch confined to the admission layer"

    #: the admission layer: run_device admits before dispatching, the
    #: scheduler/supervisor are the mechanism itself, mpp.py's embedder
    #: hook admits per dist_* step, and the compile service's bounded
    #: worker pool is the bg builds' own admission
    ALLOWED = ("executor/supervisor.py", "executor/device_exec.py",
               "executor/scheduler.py", "parallel/mpp.py",
               "executor/compile_service.py")

    def run(self, ctx):
        out = []
        for sf in ctx.package_files:
            if sf.rel in self.ALLOWED:
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node).rsplit(".", 1)[-1]
                if name in ("call_supervised", "supervised_call"):
                    out.append(self.finding(
                        sf.rel, node.lineno,
                        f"{name}@{sf.qualname(node)}",
                        "direct supervised dispatch bypasses the admission "
                        "queue (route through device_exec.run_device)"))
        return out


@register
class SharedMemoryConfinement(Rule):
    """Direct ``multiprocessing.shared_memory`` use outside
    ``tidb_tpu_torch/fabric/`` bypasses the fleet coordination layer: the
    segment's struct layout, the flock critical sections, the lease
    reclaim and the drain invariant only hold if every cross-process
    byte goes through fabric/coord.py.  Any other layer coordinates via
    the typed hooks fabric/state.py installs (scheduler.set_fleet,
    residency.set_fleet, dedup_handle) — the same pattern as the
    ``._device`` confinement to the residency manager."""

    name = "shared-memory-confinement"
    allowlistable = False
    title = "multiprocessing.shared_memory confined to tidb_tpu_torch/fabric/"

    ALLOWED_PREFIX = "fabric/"

    def run(self, ctx):
        out = []
        for sf in ctx.package_files:
            if sf.rel.startswith(self.ALLOWED_PREFIX):
                continue
            for node in ast.walk(sf.tree):
                hit = None
                if isinstance(node, ast.ImportFrom):
                    mod = node.module or ""
                    if mod.endswith("shared_memory") or (
                            mod == "multiprocessing" and any(
                            a.name == "shared_memory"
                            for a in node.names)):
                        hit = "import"
                elif isinstance(node, ast.Import):
                    if any(a.name.endswith(".shared_memory")
                           for a in node.names):
                        hit = "import"
                elif (isinstance(node, ast.Attribute)
                        and node.attr == "shared_memory"):
                    hit = "attr"
                elif (isinstance(node, ast.Call)
                        and call_name(node).rsplit(".", 1)[-1]
                        == "SharedMemory"):
                    hit = "ctor"
                if hit is not None:
                    out.append(self.finding(
                        sf.rel, node.lineno,
                        f"shm-{hit}@{sf.qualname(node)}",
                        "multiprocessing.shared_memory used outside "
                        "tidb_tpu_torch/fabric/ (coordinate through the "
                        "fabric/state.py hooks)"))
        return out


@register
class SocketConfinement(Rule):
    """Raw ``socket``/``socketserver`` use for COORDINATION is confined
    to ``tidb_tpu_torch/fabric/``: the length-prefixed frame codec
    (fabric/codec.py), its torn-frame discipline, the down-window retry
    budgets and the drain invariants only hold if every coordination
    byte rides the fabric's transports (coord_net, compile server,
    fleet port reservation, the bench wire client).  The ONE other
    sanctioned socket owner is ``server/`` — the MySQL wire protocol IS
    a socket listener; that is its job, not coordination.  A new layer
    that wants cross-process bytes goes through fabric/state.py hooks
    or a fabric service, never its own ad-hoc socket."""

    name = "socket-confinement"
    allowlistable = False
    title = "raw socket use confined to fabric/ (and the MySQL wire in server/)"

    ALLOWED_PREFIXES = ("fabric/", "server/")

    def run(self, ctx):
        out = []
        for sf in ctx.package_files:
            if sf.rel.startswith(self.ALLOWED_PREFIXES):
                continue
            for node in ast.walk(sf.tree):
                hit = None
                if isinstance(node, ast.Import):
                    if any(a.name in ("socket", "socketserver")
                           for a in node.names):
                        hit = "import"
                elif isinstance(node, ast.ImportFrom):
                    if (node.module or "") in ("socket", "socketserver"):
                        hit = "import"
                elif (isinstance(node, ast.Call)
                        and call_name(node) in (
                            "socket.socket", "socket.create_connection")):
                    hit = "ctor"
                if hit is not None:
                    out.append(self.finding(
                        sf.rel, node.lineno,
                        f"socket-{hit}@{sf.qualname(node)}",
                        "raw socket use outside fabric/ and server/ "
                        "(coordination goes through a fabric transport)"))
        return out


@register
class SnapshotConfinement(Rule):
    """Every read view over the durable fleet store must acquire its
    timestamp through the frontier-waiting entry points —
    kv/store.Storage.begin / get_snapshot routing ``_fresh_read_ts()``
    — so the ts is fenced above every live peer's durable commit
    frontier and the replica has applied through it.  A ``Snapshot``
    constructed anywhere else inside kv/ would mint a read view that
    skips that wait: exactly the silent stale read the consistency
    contract forbids.  Layers above kv/ may build snapshots only from
    an already-acquired ts (AS OF / stale-read paths own their
    staleness explicitly)."""

    name = "snapshot-confinement"
    allowlistable = False
    title = "Snapshot construction confined to the frontier-waiting entry point"

    #: Storage.begin/get_snapshot (and Transaction, same file) are the
    #: sanctioned constructors — both route _fresh_read_ts
    ALLOWED = ("kv/store.py",)

    def run(self, ctx):
        out = []
        for sf in ctx.package_files:
            if not sf.rel.startswith("kv/") or sf.rel in self.ALLOWED:
                continue
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Call)
                        and call_name(node).rsplit(".", 1)[-1]
                        == "Snapshot"):
                    out.append(self.finding(
                        sf.rel, node.lineno,
                        f"Snapshot@{sf.qualname(node)}",
                        "Snapshot constructed outside kv/store.py "
                        "(bypasses the fleet-frontier freshness wait)"))
        return out


@register
class RunDeviceShape(Rule):
    """A run_device call without ``shape=`` silently shares the 'agg'
    breaker — a new fragment class must never piggyback unnoticed.
    Direct calls AND the ``_with_pipe_stats(run_device, ...)``
    indirection both count."""

    name = "run-device-shape"
    allowlistable = False
    title = "run_device call sites name their breaker shape"

    def run(self, ctx):
        out = []
        for sf in ctx.package_files:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node).rsplit(".", 1)[-1]
                direct = name == "run_device"
                indirect = (name == "_with_pipe_stats" and node.args
                            and isinstance(node.args[0], ast.Name)
                            and node.args[0].id == "run_device")
                if not (direct or indirect):
                    continue
                if not any(kw.arg == "shape" for kw in node.keywords):
                    out.append(self.finding(
                        sf.rel, node.lineno,
                        f"{name}@{sf.qualname(node)}",
                        "run_device call site missing explicit shape= "
                        "(breaker scoping)"))
        return out
