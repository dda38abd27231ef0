"""Compile service of the port: background warm-up on the card, the
signature index, prewarmed bucket ladders, and the fleet's compile
server.

Every fragment pipeline resolves through :func:`obtain` (the sole caller
is ``device_exec.acquire_pipeline``).  What a "compile" is differs from
the reference (``tidb_tpu/executor/compile_service.py``), where it is an
XLA compile of seconds to minutes.  On the card it is two things, and
a warm takes a third off the query path:

* the ``nvcc`` build of the kernel library, once per source digest and
  checkout (``ops/kernels/build.py``, under a lock; a fleet's compile
  server builds it where its artifact directory is elsewhere,
  ``fabric/compile_server.py``);
* the assembly of the pipeline: the expression program and the kernels
  it binds (``device_exec._build_pipeline``, ``device_join.
  compile_fragment``), a Python closure built in milliseconds; its
  seconds are the compile time (``compile_s``);
* the first launches of a pipeline at a shape in a process: loading each
  kernel's module from the library, growing the caching allocator, the
  kernels' workspaces.  ``device_exec._Pipeline`` counts a "trace" at a
  pipeline's first call at each argument shape, as jit retraces per
  shape in the reference.

The layers a device fragment passes (run_device order) are the
reference's: admission, this service, the supervisor's deadline, the
circuit breaker, residency.

* **Async compile, host-first serving** (``tidb_compile_async``, OFF by
  default): a cold ``_PIPE_CACHE`` miss SUBMITS the signature to a
  bounded worker pool (``_BACKLOG_MAX`` jobs; refusals counted
  ``bg_backlog_rejects``) and raises ``DeviceUnsupported``, so the host
  engine serves this execution (``compile_pending_fragments``, no
  breaker charge).  The worker builds the pipeline, then warms it: one
  call on zero-filled tensors of the recorded spec, on the card, on a
  ``torch.cuda.Stream`` of its own (the launchers take the calling
  thread's current stream, and a warm on the default stream would
  serialise with every query), and it synchronises that stream before
  the entry lands in ``_PIPE_CACHE`` with origin ``bg``.  The warm calls
  the pipeline once at its recorded capacities and never enters the
  caller's capacity retry; a warm's tensors that do not fit
  ``residency.free_share_bytes`` are not allocated (the entry lands
  unwarmed, counted in :data:`WARM`).  A warm that fails is classified
  and charged to the compile breaker; its entry never lands.  The next
  same-shaped query then runs on the card with zero new traces.

* **Signature index**: a directory of recorded signatures
  (``ops/kernels/build/pipe-index/``; ``TIDB_TPU_COMPILE_INDEX``
  overrides it, ``off`` disables it).  A cold obtain whose signature is
  there builds INLINE even under async and counts
  ``compile_persist_hits``: the library it binds is already built, so a
  restart or a sibling worker assembles the pipeline in milliseconds.
  The hash is scoped by the library's source digest and the device's
  identity (the card's name and compute capability, or ``cpu``).

* **Prewarm ladder** (``tidb_compile_prewarm``, ``ADMIN COMPILE``,
  :func:`prewarm`): every build registers a RECIPE (builder + argument
  spec); prewarm warms each hot recipe at the next ``ladder_up`` row
  buckets, so a table that grows past a bucket finds the pipeline's
  first launches at the new shape already paid.  A rung whose tensors
  do not fit the free share is skipped and counted.  Join and MPP
  recipes keep no builder, so a recipe never pins a table.

* **Resilience**: a worker runs under the supervisor's deadline
  (``tidb_compile_timeout``), classified failures retry on the
  Backoffer's ``compileRetry`` curve, terminal failures charge the
  compile-scoped breaker; failpoint ``device-compile`` with
  ``compile-fail`` / ``[N*]compile-slow(s)``.

Gauges (``compile_queue_depth``, ``compile_pending_fragments``,
``compile_bg_seconds``, ``compile_persist_hits``) and the per-fragment
``compile_mode`` (``cached`` / ``bg`` / ``prewarmed`` /
``async_pending`` / ``sync``) surface as in the reference: EXPLAIN
ANALYZE, observe gauges, ``/status`` (``device_compiler``) and
``/metrics``.  ``bg`` (a hit on an entry a background job landed) is
the port's: the reference reads ``cached`` there.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import json
import logging
import os
import queue
import threading
import time
import weakref

log = logging.getLogger("tidb_tpu_torch.compile_service")

_LOCK = threading.Lock()

#: in-flight background jobs keyed by job key (pipeline cache key, or
#: (pipeline key, ("ladder", bucket)) for prewarm shape warms)
_JOBS: dict = {}
#: async backlog bound (the bg pool's admission, mirroring the
#: scheduler's bounded queue): every queued job pins its builder closure
#: until the build runs, so an unbounded burst of distinct signatures
#: would grow host memory without limit
_BACKLOG_MAX = 32
_JOB_Q: "queue.SimpleQueue" = queue.SimpleQueue()
_WORKERS: list = []
_WORKER_SEQ = itertools.count()

#: how a cached pipeline entry came to exist: "bg" (async background
#: compile) or "prewarm" (ladder warm) — anything absent was built sync.
#: Drives the per-fragment compile_mode annotation on later cache hits.
_ORIGIN: dict = {}
_ORIGIN_MAX = 512

#: prewarm recipes: every first build records its builder + argument
#: spec so the ladder can warm the signature at neighboring bucket
#: shapes (and rebuild it after a fence dropped the pipe cache)
_RECIPES: "collections.OrderedDict" = collections.OrderedDict()
_RECIPES_MAX = 128

STATS = {
    "bg_submitted": 0,        # background jobs enqueued
    "bg_completed": 0,        # jobs whose pipeline landed in the cache
    "bg_failed": 0,           # jobs that failed classified (breaker fed)
    "bg_discarded": 0,        # jobs dropped (stale after a fence, or a
    #                           ladder rung that did not fit)
    "sync_compiles": 0,       # builds done inline on the query path
    "compile_pending_fragments": 0,  # dispatches degraded to host because
    #                                  their compile was pending/in flight
    "compile_prewarmed": 0,   # ladder shape warms completed
    "compile_persist_hits": 0,  # cold obtains served inline by the index
    "compile_bg_seconds": 0.0,  # wall seconds spent in background builds
    "breaker_degrades": 0,    # obtains refused by an OPEN compile breaker
    "bg_backlog_rejects": 0,  # submits refused by the _BACKLOG_MAX bound
}
_LAST_ERROR = [""]

#: the port's record of the warm calls (the reference has no such
#: record: its warm is the XLA compile): warms run, their seconds and
#: bytes, warms skipped because their tensors did not fit the free
#: share, and the last `WARM_LOG_MAX` warms one by one (origin, shape,
#: bucket, bytes, seconds, skipped) — what ADMIN COMPILE's rungs cost
WARM = {"warms": 0, "warm_s": 0.0, "warm_bytes": 0, "warm_skipped": 0}
WARM_LOG_MAX = 256
WARM_LOG: "collections.deque" = collections.deque(maxlen=WARM_LOG_MAX)

#: resolved config (GLOBAL-vars discipline, same as scheduler._refresh_cfg:
#: the worker pool is process-wide, so a session SET must not resize it)
_CFG = {"workers": 2, "timeout_s": 0.0}

#: observe sinks mirroring the gauges (pattern of scheduler/residency)
_SINKS: "weakref.WeakSet" = weakref.WeakSet()

#: the warm's own CUDA stream, one per (thread, device)
_TLS = threading.local()


class _Recipe:
    __slots__ = ("key", "build", "spec", "dict_refs", "shape", "sig",
                 "uses", "bucket", "pd")

    def __init__(self, key, build, spec, dict_refs, shape, sig,
                 ladder=True, per_double=2):
        self.key = key
        self.build = build
        self.spec = spec
        self.dict_refs = dict_refs
        self.shape = shape
        self.sig = sig
        self.uses = 1
        # bucket None = no ladder: streamed fragments always dispatch at
        # the FIXED tidb_device_stream_rows block shape, so a
        # bigger-bucket warm could never serve traffic (only the
        # post-eviction rebuild applies to them)
        self.bucket = _base_bucket(spec) if ladder else None
        # the registering session's bucket granularity
        # (tidb_device_shape_buckets): the ladder must climb the SAME
        # curve the dispatch sites bucket on, or every warm is a shape
        # traffic never hits
        self.pd = per_double


class _Job:
    __slots__ = ("jkey", "cache_key", "build", "spec", "dict_refs",
                 "shape", "sig", "br", "sid", "origin", "done", "error",
                 "fence_gen", "tchild")

    def __init__(self, jkey, cache_key, build, spec, dict_refs, shape,
                 sig, br, sid, origin):
        self.jkey = jkey
        self.cache_key = cache_key
        self.build = build          # None: warm an already-cached fn
        self.spec = spec
        self.dict_refs = dict_refs
        self.shape = shape
        self.sig = sig
        self.br = br                # compile-scoped breaker (may be None)
        self.sid = sid              # probe-owner token for the breaker
        self.origin = origin        # "bg" | "prewarm"
        self.done = threading.Event()
        self.error = None
        self.fence_gen = _fence_gen()
        # linked child trace (session/tracing.py link_child): a bg job
        # submitted by a TRACED statement runs under its own trace whose
        # parent_id is the statement's — the async compile's lifetime
        # stays attributable to the query that triggered it
        self.tchild = None


# -- config / small helpers --------------------------------------------------

def _refresh_cfg(ctx):
    src = None
    dom = getattr(ctx, "domain", None)
    if dom is not None:
        gv = dom.global_vars
        src = lambda name, d: gv.get(name, d)  # noqa: E731
    elif ctx is not None:
        src = lambda name, d: ctx.get_sysvar(name)  # noqa: E731
    if src is None:
        return
    # resolve outside _LOCK (sysvar reads do arbitrary session work),
    # publish under it (the pool size and deadline are read under _LOCK
    # by _ensure_workers and the worker loop)
    vals = {}
    try:
        vals["workers"] = max(int(src("tidb_compile_workers", 2)), 1)
    except Exception:
        pass
    try:
        vals["timeout_s"] = max(float(src("tidb_compile_timeout", 0.0)),
                                0.0)
    except Exception:
        pass
    with _LOCK:
        _CFG.update(vals)


def _async_on(ctx) -> bool:
    if ctx is None:
        return False
    try:
        return str(ctx.get_sysvar("tidb_compile_async")).upper() in (
            "ON", "1", "TRUE")
    except Exception:
        return False


def _fence_gen() -> int:
    try:
        from . import supervisor
        return supervisor.fence_generation()
    except Exception:
        return 0


def _remote_serve(key, build, spec, shape, sig):
    """Record a cold pipeline's signature with the separated compile
    server (fabric/compile_client.py) when one is configured.  A port
    pipeline is a closure over the library's kernels, so nothing else
    crosses the socket and the caller always assembles the pipeline
    itself.  Returns the classified error when the remote path failed
    (the caller records it and builds inline), else None."""
    try:
        from ..fabric.compile_client import get_client
        cli = get_client()
    except Exception as e:  # noqa: BLE001 — remote is an optimization
        log.warning("fabric compile client unavailable (building "
                    "locally): %s", e)
        return None
    if cli is None:
        return None
    return cli.serve(key, build, spec, shape, sig)[1]


class TensorSpec(collections.namedtuple("TensorSpec",
                                        "shape dtype device")):
    """A tensor argument's shape, torch dtype and device: the spec leaf
    of a recorded call (the counterpart of jax.ShapeDtypeStruct)."""

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n * self.dtype.itemsize


def _tree_map(f, x):
    """`f` over the leaves of nested tuples / lists / dicts."""
    if isinstance(x, tuple) and not isinstance(x, TensorSpec):
        return tuple(_tree_map(f, v) for v in x)
    if isinstance(x, list):
        return [_tree_map(f, v) for v in x]
    if isinstance(x, dict):
        return {k: _tree_map(f, v) for k, v in x.items()}
    return f(x)


def _tree_leaves(x, out=None):
    out = [] if out is None else out
    if isinstance(x, tuple) and not isinstance(x, TensorSpec):
        for v in x:
            _tree_leaves(v, out)
    elif isinstance(x, list):
        for v in x:
            _tree_leaves(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tree_leaves(v, out)
    else:
        out.append(x)
    return out


def _spec_of(args):
    """args tree (tensors / scalars in tuples, lists, dicts) → spec tree
    of :class:`TensorSpec` leaves.  Derived at submit time so the job
    never pins the query's real data.  Python scalars stay literal zeros
    of their type (a live count of 0 keeps the warm cheap: no row is
    live, so a join's expansion stays empty instead of n × m pairs of
    zero keys); numpy scalars likewise.  Any other leaf raises
    TypeError."""
    import numpy as np
    import torch

    def leaf(a):
        if isinstance(a, bool):
            return False
        if isinstance(a, int):
            return 0
        if isinstance(a, float):
            return 0.0
        if a is None or isinstance(a, str):
            return a
        if isinstance(a, np.generic):
            return type(a)(0)
        if isinstance(a, torch.Tensor):
            return TensorSpec(tuple(a.shape), a.dtype, str(a.device))
        raise TypeError(f"no spec for a {type(a).__name__} argument")
    return _tree_map(leaf, args)


def _zeros_of(spec):
    """Zero-filled tensors matching a spec — the warm call's arguments,
    on each leaf's recorded device (allocated on the calling thread's
    current stream).  Zeros are safe: the pipelines are total over any
    input (padding is masked, division is guarded) and the warm's result
    is discarded."""
    import torch

    def leaf(s):
        if isinstance(s, TensorSpec):
            return torch.zeros(s.shape, dtype=s.dtype, device=s.device)
        return s
    return _tree_map(leaf, spec)


def _spec_bytes(spec) -> int:
    """Bytes the warm's zero tensors take."""
    return sum(s.nbytes for s in _tree_leaves(spec)
               if isinstance(s, TensorSpec))


def _base_bucket(spec):
    """The single leading dimension shared by every tensor leaf of the
    spec (the fragment's row bucket), or None when leaves disagree —
    only single-bucket pipelines get a prewarm ladder."""
    dims = {s.shape[0] for s in _tree_leaves(spec)
            if isinstance(s, TensorSpec) and len(s.shape) >= 1}
    if len(dims) == 1:
        return next(iter(dims))
    return None


def next_buckets(base: int, count: int, per_double: int = 2) -> list:
    """The `count` geometric row buckets strictly above `base` (the
    prewarm ladder: shapes growing traffic will hit next)."""
    from ..ops.device import bucket_rows
    if per_double <= 0:
        return []  # exact shapes: there is no bucket curve to climb
    out = []
    b = int(base)
    for _ in range(count):
        nb = bucket_rows(b + 1, per_double)
        if nb <= b:
            break
        out.append(nb)
        b = nb
    return out


def _scale_spec(spec, base: int, bucket: int):
    """The recipe's spec with every `base`-length leading dim scaled to
    `bucket` — the ladder shape one step up."""

    def leaf(s):
        if isinstance(s, TensorSpec) and len(s.shape) >= 1 \
                and s.shape[0] == base:
            return s._replace(shape=(bucket,) + tuple(s.shape[1:]))
        return s
    return _tree_map(leaf, spec)


# -- persistent signature index ----------------------------------------------

def _persist_dir():
    """The signature-index directory, or None when persistence is off.
    By default it lives in the kernel library's build directory, beside
    the library whose digest scopes every entry."""
    d = os.environ.get("TIDB_TPU_COMPILE_INDEX", "")
    if d == "off":
        return None
    if d:
        return d
    from ..ops.kernels import build
    return os.path.join(build.BUILD_DIR, "pipe-index")


_IDENT: dict = {}


def _backend_ident() -> tuple:
    """(kernel library digest, device identity) — the scope of every
    index entry: another library build or another kind of card is
    another set of kernels."""
    from ..ops import device as dev
    name = dev._DEVICE[0]
    got = _IDENT.get(name)
    if got is None:
        import torch
        from ..ops.kernels import build
        d = torch.device(name)
        if d.type == "cuda" and torch.cuda.is_available():
            i = d.index if d.index is not None else torch.cuda.current_device()
            ident = (torch.cuda.get_device_name(i),
                     torch.cuda.get_device_capability(i))
        else:
            ident = "cpu"
        got = _IDENT[name] = (build._digest(), ident)
    return got


def _persist_hash(key) -> str:
    """Stable hash of a pipeline cache key (sig strings / ints / tuples —
    repr-stable by construction) + the library digest and the device's
    identity."""
    ident = repr((key, _backend_ident()))
    return hashlib.sha1(ident.encode()).hexdigest()


def _persist_lookup(key) -> bool:
    d = _persist_dir()
    if d is None:
        return False
    try:
        return os.path.exists(os.path.join(d, _persist_hash(key) + ".json"))
    except Exception:
        return False


def _persist_record(key, shape: str, sig: str, origin: str):
    """Record that this signature has been built against this library on
    this kind of device: a later process's obtain of the same key builds
    inline (compile_persist_hits)."""
    d = _persist_dir()
    if d is None:
        return
    try:
        _write_index_entry(d, _persist_hash(key), shape, repr(sig), origin)
    except Exception:
        pass  # the index is an optimization; never fail a compile on it


def _write_index_entry(d: str, key_hash: str, shape: str, sig: str,
                       origin: str):
    """One index entry, written atomically; shared with the compile
    server, which records a fleet's signatures in the same directory."""
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, key_hash + ".json")
    if os.path.exists(path):
        return
    tmp = path + f".{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        # the entry is diagnostic: the HASH in the filename is the key
        json.dump({"shape": shape, "sig": sig[:512], "origin": origin,
                   "ts": time.time()}, f)
    os.replace(tmp, path)


# -- stats plumbing -----------------------------------------------------------

def _mode(mode: str):
    """Record the per-fragment compile mode into the pipe-cache stats
    (process totals + thread-local), riding the supervisor's existing
    TLS bridging so EXPLAIN ANALYZE sees it through worker threads."""
    from .device_exec import _bump
    _bump("mode_" + mode)


def note_hit(key):
    """acquire_pipeline reports a pipe-cache HIT: compile_mode is
    `prewarmed` when the prewarm ladder produced/touched this entry,
    `bg` when a background job landed it, plain `cached` otherwise.  Deliberately LOCK-FREE: this runs on
    every warm fragment dispatch, and serializing all sessions on the
    compile-service lock would contend the steady-state path that does
    zero compile work — plain dict gets are GIL-atomic, and the uses
    bump is a prewarm-ranking heuristic where a lost increment under a
    race only nudges the ordering."""
    origin = _ORIGIN.get(key)
    rec = _RECIPES.get(key)
    if rec is not None:
        rec.uses += 1
    _mode({"prewarm": "prewarmed", "bg": "bg"}.get(origin, "cached"))


def _set_origin(key, origin: str):
    with _LOCK:
        _ORIGIN[key] = origin
        while len(_ORIGIN) > _ORIGIN_MAX:
            _ORIGIN.pop(next(iter(_ORIGIN)))


def _register_recipe(key, build, spec, dict_refs, shape, sig, ladder=True,
                     per_double=2):
    with _LOCK:
        rec = _RECIPES.get(key)
        if rec is not None:
            rec.uses += 1
            _RECIPES.move_to_end(key)
            return
        _RECIPES[key] = _Recipe(key, build, spec, dict_refs, shape, sig,
                                ladder, per_double)
        while len(_RECIPES) > _RECIPES_MAX:
            _RECIPES.popitem(last=False)


# -- the obtain chokepoint ----------------------------------------------------

def obtain(key, build, dict_refs, *, ctx=None, args=None, spec=None,
           shape="agg", sig="", ladder=True):
    """Resolve a compiled pipeline for a ``_PIPE_CACHE`` MISS (the sole
    caller is device_exec.acquire_pipeline, which already tried the
    cache).  Returns the built fn (sync path), or raises
    ``DeviceUnsupported`` when the fragment should run on the host
    engine instead: compile pending in the background, compile breaker
    open, or the build itself failed classified."""
    from ..session import tracing
    # the statement's span tracer: the compile span carries the MODE the
    # service resolved this fragment with (sync / async_pending /
    # persist_hit / breaker_open) — one branch when sampling is off
    with tracing.span("compile.obtain", shape=shape) as _tsp:
        return _obtain_impl(key, build, dict_refs, ctx, args, spec, shape,
                            sig, ladder, _tsp)


def _obtain_impl(key, build, dict_refs, ctx, args, spec, shape, sig,
                 ladder, _tsp):
    from ..ops.device import DeviceUnsupported
    from ..session import tracing
    from ..utils import failpoint
    from ..utils.backoff import classify, CLASS_COMPILE, CLASS_TRANSPORT
    from .circuit import get_breaker
    attach(ctx)
    _refresh_cfg(ctx)
    # a concurrent resolver may have LANDED this key between the caller's
    # cache miss and here (its bg job completed, or another session built
    # it sync): serve the fresh entry instead of rebuilding it
    fn = _cached_fn(key)
    if fn is not None:
        note_hit(key)
        if _tsp is not None:
            _tsp.tags["mode"] = "cached"
        return fn
    if spec is None and args is not None:
        try:
            spec = _spec_of(args)
        except TypeError:
            spec = None  # an argument with no spec: sync build, no ladder
    if spec is not None:
        # join/MPP builders close over the execution's LEAVES — the full
        # host table chunk and its device-resident columns.  A recipe
        # lives for the process, so retaining such a builder would pin
        # whole tables in RAM and make residency eviction a lie (the
        # ledger drops the entry, the closure keeps the buffer).  Those
        # shapes register builder-less: they still dedup in-flight jobs
        # and count uses; only the post-eviction REBUILD (which needs a
        # builder) is skipped for them.  Agg/window builders close over
        # compiled expression fns only — safe to retain.
        keep = build if shape not in ("join", "mpp") else None
        from ..ops.device import shape_buckets
        _register_recipe(key, keep, spec,
                         dict_refs if keep is not None else (), shape, sig,
                         ladder, shape_buckets(ctx))

    br = get_breaker(ctx, shape="compile")
    sid = getattr(ctx, "conn_id", None)
    group = None
    try:
        from .scheduler import resource_group
        group = resource_group(ctx)
    except Exception:
        pass

    with _LOCK:
        in_flight = key in _JOBS
    if in_flight:
        # the executable is being built right now: this execution (and
        # any concurrent ones) serve host-side until it lands
        with _LOCK:
            STATS["compile_pending_fragments"] += 1
        _mode("async_pending")
        _publish_gauges()
        if _tsp is not None:
            _tsp.tags["mode"] = "async_pending"
        tracing.event("host_degraded", reason="compile_pending",
                      shape=shape)
        raise DeviceUnsupported(
            f"device executable for this {shape} fragment is compiling "
            "in the background (fragment served by the host engine)")

    if not br.allow(session=sid, group=group):
        # compile path unhealthy (the Q5 dead-tunnel mode): don't even
        # queue — degrade instantly, recover via the half-open probe
        with _LOCK:
            STATS["breaker_degrades"] += 1
        if _tsp is not None:
            _tsp.tags["mode"] = "breaker_open"
        tracing.event("host_degraded", reason="compile_breaker_open",
                      shape=shape)
        raise DeviceUnsupported(
            f"compile circuit open for device executables (cooling "
            f"down; {shape} fragment degraded to host engine)")

    persist_warm = _persist_lookup(key)
    if persist_warm:
        with _LOCK:
            STATS["compile_persist_hits"] += 1
        if _tsp is not None:
            _tsp.tags["persist_hit"] = True

    if _async_on(ctx) and spec is not None and not persist_warm:
        # async path: submit and serve this execution host-side.  The
        # probe slot (if this allow() won one) transfers to the job —
        # its verdict is the background compile's outcome.
        job = _Job(key, key, build, spec, dict_refs, shape, sig, br, sid,
                   "bg")
        with _LOCK:
            # re-check ATOMICALLY with the insert: a concurrent miss on
            # the same key between the fast-path check above and here
            # must not double-submit (the overwrite would let the first
            # job's finish pop the second's live entry — leaked-job
            # false positives in verify_drained, and a duplicate build
            # and warm)
            if key in _JOBS:
                job = None
                STATS["compile_pending_fragments"] += 1
            elif len(_JOBS) >= _BACKLOG_MAX:
                # backlog full: degrade to host WITHOUT submitting — the
                # signature re-submits on a later miss once the queue
                # drains (see the _BACKLOG_MAX comment for why the bound
                # exists at all)
                job = None
                STATS["bg_backlog_rejects"] += 1
                STATS["compile_pending_fragments"] += 1
            else:
                _JOBS[key] = job
                STATS["bg_submitted"] += 1
                STATS["compile_pending_fragments"] += 1
        if job is None:
            br.release_probe(session=sid)
            _mode("async_pending")
            _publish_gauges()
            if _tsp is not None:
                _tsp.tags["mode"] = "async_pending"
            tracing.event("host_degraded", reason="compile_pending",
                          shape=shape)
            raise DeviceUnsupported(
                f"device executable for this {shape} fragment is "
                "compiling in the background (fragment served by the "
                "host engine)")
        # linked child trace: the background build's own timeline, tied
        # back to this statement's trace by parent_id (the async
        # compile's lifetime is attributable to the query it serves)
        job.tchild = tracing.link_child("compile.bg", shape=shape)
        _ensure_workers()
        _JOB_Q.put(job)
        _mode("async_pending")
        _publish_gauges()
        if _tsp is not None:
            _tsp.tags["mode"] = "async_submitted"
            if job.tchild is not None:
                _tsp.tags["bg_trace_id"] = job.tchild.trace_id
        tracing.event("host_degraded", reason="compile_submitted",
                      shape=shape)
        raise DeviceUnsupported(
            f"device executable for this {shape} fragment submitted for "
            "background compilation (fragment served by the host engine)")

    # sync path (async off, no shape spec, or a persistent-index hit —
    # the library the pipeline binds is built, so inline is an assembly)
    try:
        # chaos hook: a compile-fail here models the remote-compile
        # service refusing/failing the build on the query path
        failpoint.inject("device-compile")
        # a failed remote path (remote_err set) still builds INLINE —
        # the separated compile server degrades to local compilation,
        # never to a failed query
        remote_err = _remote_serve(key, build, spec, shape, sig)
        fn = build()
    except DeviceUnsupported:
        br.release_probe(session=sid)
        raise
    except Exception as e:
        cls = classify(e)
        if cls not in (CLASS_COMPILE, CLASS_TRANSPORT):
            br.release_probe(session=sid)
            raise
        # wrap in the taxonomy's own error (errno 9010): the breaker
        # record, the log chain and any re-classification all see a
        # COMPILE-path failure — a raw transport error from a future
        # remote compiler must not masquerade as an execution fault
        from ..errors import DeviceCompileError
        err = DeviceCompileError(
            f"device compile failed ({cls}): {e}")
        err.__cause__ = e
        br.record_failure(err, session=sid, group=group)
        with _LOCK:
            _LAST_ERROR[0] = f"{cls}: {e}"
        if _tsp is not None:
            _tsp.tags["mode"] = "sync_failed"
        tracing.event("host_degraded", reason="compile_" + cls,
                      shape=shape)
        raise DeviceUnsupported(
            f"device compile failed ({cls}): {e} "
            f"({shape} fragment degraded to host engine)") from err
    if remote_err is not None:
        # the server only records the signature; the pipeline was built
        # here all the same, so a dead server is not a compile failure:
        # it is counted (fabric_remote_errors, last_error) and silenced
        # by the client's down-window, and never charged to the breaker
        # (the reference charges it: its server compiles the module)
        with _LOCK:
            _LAST_ERROR[0] = f"remote: {remote_err}"
    br.record_success(session=sid)
    from .device_exec import _pipe_cache_put
    _pipe_cache_put(key, fn, dict_refs)
    with _LOCK:
        STATS["sync_compiles"] += 1
    _mode("sync")
    if _tsp is not None:
        _tsp.tags["mode"] = "sync"
    _persist_record(key, shape, sig, "sync")
    return fn


# -- the worker pool ----------------------------------------------------------

def _ensure_workers():
    with _LOCK:
        want = _CFG["workers"]
        live = [t for t in _WORKERS if t.is_alive()]
        _WORKERS[:] = live
        need = want - len(live)
        for _ in range(max(need, 0)):
            t = threading.Thread(
                target=_worker_loop, daemon=True,
                name=f"compile-worker-{next(_WORKER_SEQ)}")
            _WORKERS.append(t)
            t.start()


def _worker_loop():
    from .device_exec import mark_bg_thread
    mark_bg_thread()  # route this thread's compile stats to the bg_* keys
    while True:
        job = _JOB_Q.get()
        try:
            _run_job(job)
        except BaseException:  # noqa: BLE001 — a worker must never die
            log.exception("compile worker: unexpected job failure")
            _finish_job(job, failed=True)


def _warm_stream(device):
    """This thread's own CUDA stream on `device` (created once)."""
    import torch
    streams = getattr(_TLS, "streams", None)
    if streams is None:
        streams = _TLS.streams = {}
    s = streams.get(device)
    if s is None:
        s = streams[device] = torch.cuda.Stream(device=device)
    return s


def _warm(fn, job: "_Job") -> bool:
    """One call of `fn` on zero-filled tensors of the job's spec.  On a
    card it runs on this thread's own stream, synchronised before it
    returns.  Returns False (nothing allocated, nothing launched) when
    the tensors do not fit the free share of the device budget."""
    import torch
    from ..ops import residency
    nbytes = _spec_bytes(job.spec)
    devs = {s.device for s in _tree_leaves(job.spec)
            if isinstance(s, TensorSpec)}
    cuda = sorted(d for d in devs if d.startswith("cuda"))
    free = residency.free_share_bytes()
    if free > 0 and nbytes > free:
        with _LOCK:
            WARM["warm_skipped"] += 1
            WARM_LOG.append({"origin": job.origin, "shape": job.shape,
                             "bucket": _base_bucket(job.spec),
                             "bytes": nbytes, "s": 0.0, "skipped": True,
                             "free_share": free})
        return False
    t0 = time.perf_counter()
    if cuda:
        d = torch.device(cuda[0])
        s = _warm_stream(d)
        with torch.cuda.device(d), torch.cuda.stream(s):
            fn(*_zeros_of(job.spec))
        s.synchronize()
    else:
        fn(*_zeros_of(job.spec))
    el = time.perf_counter() - t0
    with _LOCK:
        WARM["warms"] += 1
        WARM["warm_s"] += el
        WARM["warm_bytes"] += nbytes
        WARM_LOG.append({"origin": job.origin, "shape": job.shape,
                         "bucket": _base_bucket(job.spec), "bytes": nbytes,
                         "s": el, "skipped": False, "free_share": free})
    return True


def _do_compile(job: "_Job"):
    """One build+warm attempt (runs under the supervisor deadline).  The
    build assembles the pipeline; the warm pays its first launches at the
    recorded shape, so the real dispatch counts zero new traces.  A
    ladder rung that does not fit returns None (nothing to install)."""
    from ..utils import failpoint
    from .device_exec import mark_bg_thread
    # SCOPED bg mark: under tidb_compile_timeout this runs on a REUSED
    # supervisor worker thread, not the compile worker — the charges
    # must still route to the bg_* mirror, and the mark must not outlive
    # the job (that worker serves query fragments next)
    prev = mark_bg_thread()
    try:
        failpoint.inject("device-compile")
        if job.build is not None and job.spec is not None:
            # the compile server first (when configured): it records the
            # signature in the fleet's index; the pipeline itself is a
            # closure this process assembles (no module to ship)
            rerr = _remote_serve(job.cache_key, job.build, job.spec,
                                 job.shape, job.sig)
            if rerr is not None:
                log.warning("bg compile: remote path failed, building "
                            "inline: %s", rerr)
                with _LOCK:
                    _LAST_ERROR[0] = f"remote: {rerr}"
        fn = (job.build() if job.build is not None
              else _cached_fn(job.cache_key))
        if fn is None:
            return None
        if job.spec is not None and not _warm(fn, job) \
                and job.build is None:
            return _SKIPPED
        return fn
    finally:
        mark_bg_thread(prev)


#: _do_compile's answer for a ladder rung whose tensors did not fit
_SKIPPED = object()


def _cached_fn(key):
    from . import device_exec
    with device_exec._PIPE_LOCK:
        hit = device_exec._PIPE_CACHE.get(key)
    return hit[0] if hit is not None else None


def _run_job(job: "_Job"):
    """Build + warm one executable with the full resilience ladder:
    supervisor deadline (a hung remote compile is abandoned + fenced like
    any device hang), compileRetry backoff on classified failures, then
    a terminal verdict into the compile-scoped breaker.  A job carrying a
    linked child trace runs UNDER it, so its supervisor/backoff spans and
    events land on the timeline attributed to the submitting query."""
    if job.tchild is not None:
        from ..session import tracing
        with tracing.adopt(job.tchild):
            return _run_job_traced(job)
    return _run_job_traced(job)


def _run_job_traced(job: "_Job"):
    from ..utils.backoff import (Backoffer, classify, CLASS_COMPILE,
                                 CLASS_DEVICE, CLASS_EXCHANGE, CLASS_HANG,
                                 CLASS_TRANSPORT)
    from . import supervisor
    from ..ops.device import DeviceUnsupported
    t0 = time.perf_counter()
    bo = Backoffer(budget_ms=2000.0)
    fn = None
    while True:
        try:
            with _LOCK:
                deadline = _CFG["timeout_s"]
            fn = supervisor.call_supervised(
                _do_compile, (job,), deadline_s=deadline, ctx=None,
                shape="compile", label=f"bg compile ({job.shape})")
            break
        except DeviceUnsupported:
            # the builder says this fragment can't run on device at all:
            # not a health verdict — drop the job quietly
            if job.br is not None:
                job.br.release_probe(session=job.sid)
            _finish_job(job, failed=True, charge=False)
            return
        except Exception as e:  # noqa: BLE001 — classified below
            cls = classify(e)
            with _LOCK:
                _LAST_ERROR[0] = f"{cls}: {e}"
            if cls not in (CLASS_COMPILE, CLASS_TRANSPORT, CLASS_DEVICE,
                           CLASS_EXCHANGE, CLASS_HANG):
                log.warning("background compile failed unclassified: %s",
                            e, exc_info=True)
                if job.br is not None:
                    job.br.release_probe(session=job.sid)
                _finish_job(job, failed=True, charge=False)
                return
            try:
                bo.backoff("compileRetry", e)
            except Exception:
                # retry budget exhausted: terminal classified failure —
                # the compile breaker opens after enough of these and
                # obtain() degrades fragments without queueing.  Wrapped
                # as DeviceCompileError (9010) so the breaker record and
                # the job's error carry the compile taxonomy class.
                from ..errors import DeviceCompileError
                term = DeviceCompileError(
                    f"background compile failed terminally ({cls}): {e}")
                term.__cause__ = e
                job.error = term
                if job.br is not None:
                    job.br.record_failure(term, session=job.sid)
                _finish_job(job, failed=True)
                return
    elapsed = time.perf_counter() - t0
    with _LOCK:
        STATS["compile_bg_seconds"] += elapsed
    if fn is None:
        # prewarm warm whose cached fn vanished (LRU/fence) and carried
        # no builder: nothing to install
        _finish_job(job, failed=True, charge=False)
        return
    if fn is _SKIPPED:
        # a ladder rung whose tensors did not fit the free share
        _finish_job(job, discarded=True)
        return
    from ..ops import device as dev
    from . import device_exec
    stale = False
    with device_exec._PIPE_LOCK:
        # fence-generation read under the SAME lock the fence's cache
        # clear takes (_reinit_backend): either the clear ran first —
        # the generation this read returns is already bumped, so the
        # stale pipeline is discarded — or our put lands first and the
        # clear removes it.  Without the shared lock a clear could slip
        # between an unlocked gen check and the put, installing a
        # pipeline warmed against the fenced backend.  (Lock order
        # _PIPE_LOCK → supervisor._LOCK; the supervisor never takes the
        # pipe lock while holding its own.)  The CPU's fence is pure
        # accounting, so its warms stay valid.
        if (dev._DEVICE[0].startswith("cuda")
                and job.fence_gen != _fence_gen()):
            stale = True
        elif job.build is not None:
            device_exec._PIPE_CACHE[job.cache_key] = (fn, job.dict_refs)
            while len(device_exec._PIPE_CACHE) > \
                    device_exec._PIPE_CACHE_MAX:
                device_exec._PIPE_CACHE.popitem(last=False)
    if stale:
        _finish_job(job, discarded=True)
        return
    _set_origin(job.cache_key, job.origin)
    if job.br is not None:
        job.br.record_success(session=job.sid)
    _persist_record(job.cache_key, job.shape, job.sig, job.origin)
    _finish_job(job)
    log.info("background compile landed (%s, %.2fs): next same-shape "
             "query flips to device", job.shape, elapsed)


def _finish_job(job: "_Job", failed: bool = False, discarded: bool = False,
                charge: bool = True):
    with _LOCK:
        _JOBS.pop(job.jkey, None)
        if discarded:
            STATS["bg_discarded"] += 1
        elif failed:
            if charge:
                STATS["bg_failed"] += 1
            else:
                STATS["bg_discarded"] += 1
        else:
            STATS["bg_completed"] += 1
            if job.origin == "prewarm":
                STATS["compile_prewarmed"] += 1
    if job.br is not None:
        # paths that end a job WITHOUT a breaker verdict (fence discard,
        # the worker-loop catch-all) must still free a HALF_OPEN probe
        # slot the job inherited from obtain()'s allow(), or the breaker
        # wedges host-side until the grace reclaim; ownership-checked
        # and a no-op when record_success/failure already resolved it
        job.br.release_probe(session=job.sid)
    if job.tchild is not None:
        # retire the linked child trace on EVERY job outcome (finish is
        # idempotent — the worker-loop catch-all may land here twice)
        from ..session import tracing
        tracing.finish(job.tchild, succ=not failed and not discarded)
    job.done.set()
    _publish_gauges()


# -- prewarm ------------------------------------------------------------------

def _prewarm_claim_fleet(jkey) -> bool:
    """Fleet-wide prewarm dedup: N workers prewarming the same recipe
    ladder should warm each rung ONCE across the fleet — the
    coordination segment's claim makes the submission itself
    at-most-once.  Always True outside
    a fleet."""
    try:
        from ..fabric import state as fabric_state
        coord = fabric_state.coordinator()
        if coord is None:
            return True
        ident = hashlib.blake2b(repr(jkey).encode(),
                                digest_size=16).digest()
        return coord.prewarm_claim(ident)
    except Exception as e:  # noqa: BLE001 — dedup is best-effort
        log.warning("fleet prewarm claim failed (warming locally): %s", e)
        return True


def prewarm(ctx=None, ladder_up: int = 2, max_recipes: int = 32,
            wait: bool = False, timeout_s: float = 120.0) -> dict:
    """Background-compile the bucket ladder for the hot recipes: for each
    registered fragment signature (most-used first; signatures with
    learned capacities in device_join._CAP_STORE rank hottest — they are
    the shapes traffic converged on), warm the next `ladder_up` row
    buckets above the seen shape, plus rebuild any signature an off-CPU
    fence evicted.  `wait` blocks until the submitted warms finish
    (ADMIN COMPILE uses this so the statement returns a final count)."""
    _refresh_cfg(ctx)
    from .device_join import _CAP_STORE
    # snapshot: concurrent queries mutate the cap store un-locked, and a
    # mid-sort resize would raise out of the priority key function
    try:
        hot_sigs = {k[0] for k in list(_CAP_STORE)}
    except RuntimeError:  # resized mid-snapshot: lose the priority boost
        hot_sigs = set()
    with _LOCK:
        warm0 = STATS["compile_prewarmed"]
        fail0 = STATS["bg_failed"]
        recipes = sorted(
            _RECIPES.values(),
            key=lambda r: (r.sig in hot_sigs if r.sig else False, r.uses),
            reverse=True)[:max_recipes]
    jobs = []
    for rec in recipes:
        targets = []
        if _cached_fn(rec.key) is None and rec.build is not None:
            # evicted/fenced: rebuild at the seen shape first
            # (builder-less join/MPP recipes can't rebuild — skip)
            targets.append((rec.spec, rec.build))
        if rec.bucket is not None:
            for nb in next_buckets(rec.bucket, ladder_up, rec.pd):
                targets.append((_scale_spec(rec.spec, rec.bucket, nb),
                                None))
        for spec, build in targets:
            # a REBUILD installs under the plain cache key, so it takes
            # the plain key as its job key too: a concurrent async
            # obtain() of the same signature then finds it in _JOBS and
            # serves host-side instead of double-submitting the same
            # multi-minute compile.  Pure shape warms (build None, never
            # install a new fn) keep a ladder-scoped key per bucket.
            jkey = (rec.key if build is not None
                    else (rec.key, ("ladder", _base_bucket(spec))))
            if not _prewarm_claim_fleet(jkey):
                continue  # another worker is already warming this rung
            with _LOCK:
                if jkey in _JOBS or rec.key in _JOBS:
                    continue
                job = _Job(jkey, rec.key, build, spec, rec.dict_refs,
                           rec.shape, rec.sig, None, None, "prewarm")
                _JOBS[jkey] = job
                STATS["bg_submitted"] += 1
            jobs.append(job)
            _ensure_workers()
            _JOB_Q.put(job)
    if wait:
        # poll in ticks and consult check_killed so ADMIN COMPILE stays
        # KILL-responsive while compiles run (same convention as the
        # scheduler's queued admission waits: KILL answers in ~a tick,
        # not after timeout_s)
        deadline = time.monotonic() + timeout_s
        check = getattr(ctx, "check_killed", None)
        for job in jobs:
            while (not job.done.wait(0.05)
                   and time.monotonic() < deadline):
                if check is not None:
                    check()
    _publish_gauges()
    with _LOCK:
        # DELTAS since this invocation started: ADMIN COMPILE reports
        # what THIS prewarm did, not process-lifetime totals
        return {"submitted": len(jobs),
                "prewarmed": STATS["compile_prewarmed"] - warm0,
                "failed": STATS["bg_failed"] - fail0}


def maybe_prewarm_on_start(domain):
    """Prewarm kick: called at Domain start and from SET GLOBAL
    ``tidb_compile_prewarm``.  Globals are in-memory only, so at Domain
    START the sysvar is never yet ON — the boot-time opt-in is the
    ``TIDB_TPU_COMPILE_PREWARM=ON`` env var (a serving process restart
    then rebuilds its ladder from the persistent index without waiting
    for a session to SET anything); the sysvar path fires the moment the
    operator SETs it (session/session.py)."""
    try:
        on = str(domain.global_vars.get("tidb_compile_prewarm",
                                        "OFF")).upper() in ("ON", "1")
    except Exception:
        on = False
    if not on:
        on = os.environ.get("TIDB_TPU_COMPILE_PREWARM",
                            "").upper() in ("ON", "1")
    if not on:
        return
    threading.Thread(target=prewarm, kwargs={"wait": False}, daemon=True,
                     name="compile-prewarm").start()


# -- fencing ------------------------------------------------------------------

def on_backend_reinit():
    """The supervisor fenced the backend and cleared the pipe cache, so
    the origin map is stale; recipes stay — they are how prewarm
    rebuilds the ladder after the fence."""
    with _LOCK:
        _ORIGIN.clear()


# -- gauges / introspection ---------------------------------------------------

def queue_depth() -> int:
    with _LOCK:
        return len(_JOBS)


def snapshot() -> dict:
    with _LOCK:
        return {"compile_queue_depth": len(_JOBS),
                "recipes": len(_RECIPES),
                "workers": len([t for t in _WORKERS if t.is_alive()]),
                "last_error": _LAST_ERROR[0],
                **{k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in STATS.items()}}


def report_gauges() -> dict:
    """Surfacing policy shared by EXPLAIN ANALYZE and bench lines (same
    rule as scheduler.report_gauges): queue depth always, the counters
    only once they have ever fired."""
    s = snapshot()
    out = {"compile_queue_depth": s["compile_queue_depth"]}
    for k in ("compile_pending_fragments", "compile_persist_hits",
              "compile_prewarmed", "bg_failed"):
        if s[k]:
            out[k] = s[k]
    if s["compile_bg_seconds"]:
        out["compile_bg_seconds"] = s["compile_bg_seconds"]
    return out


def attach(ctx):
    dom = getattr(ctx, "domain", None)
    obs = getattr(dom, "observe", None)
    if obs is not None and hasattr(obs, "set_gauge"):
        with _LOCK:
            _SINKS.add(obs)


def observe_hist(name, value):
    """Record one latency sample into every attached observe registry
    (device_exec._charge_compile_s feeds `sync_compile_seconds` through
    here — the compile-layer histogram in /metrics)."""
    with _LOCK:
        sinks = list(_SINKS)
    for obs in sinks:
        f = getattr(obs, "observe_hist", None)
        if f is not None:
            f(name, value)


def _publish_gauges():
    with _LOCK:
        if not _SINKS:
            return
        sinks = list(_SINKS)
        vals = {
            "compile_queue_depth": len(_JOBS),
            "compile_pending_fragments":
                STATS["compile_pending_fragments"],
            "compile_bg_seconds": round(STATS["compile_bg_seconds"], 3),
            "compile_persist_hits": STATS["compile_persist_hits"],
        }
    for obs in sinks:
        try:
            for k, v in vals.items():
                obs.set_gauge(k, v)
        except Exception:
            pass


def wait_idle(timeout_s: float = 30.0) -> bool:
    """Block until no background compile is in flight (tests + ADMIN)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with _LOCK:
            if not _JOBS:
                return True
        time.sleep(0.01)
    with _LOCK:
        return not _JOBS


def verify_drained() -> dict:
    """Chaos invariant (mirrors scheduler.verify_drained and the
    ticket invariant): once traffic stops, no compile job is leaked —
    nothing in flight, and every submitted job is accounted completed,
    failed or discarded."""
    with _LOCK:
        in_flight = len(_JOBS)
        accounted = (STATS["bg_completed"] + STATS["bg_failed"]
                     + STATS["bg_discarded"])
        return {"ok": in_flight == 0
                and accounted == STATS["bg_submitted"],
                "in_flight": in_flight,
                "submitted": STATS["bg_submitted"],
                "accounted": accounted}


def reset_for_tests():
    """Drop recipes/origins/counters (unit tests only).  In-flight jobs
    are waited out first so a stale worker can't repopulate the stats."""
    wait_idle(timeout_s=10.0)
    with _LOCK:
        _RECIPES.clear()
        _ORIGIN.clear()
        for k in STATS:
            STATS[k] = 0.0 if k == "compile_bg_seconds" else 0
        for k in WARM:
            WARM[k] = 0.0 if k == "warm_s" else 0
        WARM_LOG.clear()
        _LAST_ERROR[0] = ""
