"""Compile service of the port: where every fragment pipeline is built.

In the reference (``tidb_tpu/executor/compile_service.py``) this layer
compiles XLA executables in the background, keeps a persistent
executable index and prewarms bucket ladders, because an XLA compile
costs seconds to minutes.  The port's pipelines are built in
milliseconds: ``device_exec._build_pipeline`` assembles the expression
program and binds the kernels, which are compiled once per checkout
(``ops/kernels/build.py``).  So :func:`obtain` builds synchronously on
the query path; the async warm-up, the AOT index and the prewarm ladder
wait for ROADMAP queue 1's compile layer.

What stays as in the reference: the compile-scoped circuit breaker, the
``device-compile`` failpoint, the per-fragment ``compile_mode``
annotation, the ``sync_compile_seconds`` histogram, and the gauges of
:func:`snapshot` under the reference's keys (the status page's
``device_compiler``).  The background keys hold what a synchronous
service has: no queue, no workers, no background builds; the inline
builds, the breaker's refusals and the last classified error are
counted.
"""

from __future__ import annotations

import threading
import weakref

_LOCK = threading.Lock()


#: observe sinks mirroring the gauges (pattern of scheduler/residency)
_SINKS: "weakref.WeakSet" = weakref.WeakSet()

#: the reference's counters; only the synchronous ones ever move here
STATS = {
    "bg_submitted": 0,        # background jobs enqueued (none here)
    "bg_completed": 0,
    "bg_failed": 0,
    "bg_discarded": 0,
    "sync_compiles": 0,       # builds done inline on the query path
    "compile_pending_fragments": 0,
    "compile_prewarmed": 0,
    "compile_persist_hits": 0,
    "compile_bg_seconds": 0.0,
    "breaker_degrades": 0,    # obtains refused by an OPEN compile breaker
    "bg_backlog_rejects": 0,
}
_LAST_ERROR = [""]


def _mode(mode: str):
    """Record the per-fragment compile mode into the pipe-cache stats
    (process totals + thread-local) for the EXPLAIN ANALYZE annotation."""
    from .device_exec import _bump
    _bump("mode_" + mode)


def note_hit(key):
    """acquire_pipeline reports a pipe-cache HIT."""
    _mode("cached")


def obtain(key, build, dict_refs, *, ctx=None, args=None, spec=None,
           shape="agg", sig="", ladder=True):
    """Build the pipeline for a ``_PIPE_CACHE`` miss (the sole caller is
    device_exec.acquire_pipeline) and install it.  Raises
    ``DeviceUnsupported`` when the compile breaker is open or the build
    failed classified, so the fragment runs on the host engine."""
    from ..session import tracing
    with tracing.span("compile.obtain", shape=shape) as _tsp:
        return _obtain_impl(key, build, dict_refs, ctx, shape, _tsp)


def _obtain_impl(key, build, dict_refs, ctx, shape, _tsp):
    from ..ops.device import DeviceUnsupported
    from ..session import tracing
    from ..utils import failpoint
    from ..utils.backoff import classify, CLASS_COMPILE, CLASS_TRANSPORT
    from .circuit import get_breaker
    attach(ctx)
    br = get_breaker(ctx, shape="compile")
    sid = getattr(ctx, "conn_id", None)
    group = None
    try:
        from .scheduler import resource_group
        group = resource_group(ctx)
    except Exception:
        pass
    if not br.allow(session=sid, group=group):
        with _LOCK:
            STATS["breaker_degrades"] += 1
        if _tsp is not None:
            _tsp.tags["mode"] = "breaker_open"
        tracing.event("host_degraded", reason="compile_breaker_open",
                      shape=shape)
        raise DeviceUnsupported(
            f"compile circuit open for device pipelines (cooling down; "
            f"{shape} fragment degraded to host engine)")
    try:
        # chaos hook: a compile-fail here models the build failing on the
        # query path
        failpoint.inject("device-compile")
        fn = build()
    except DeviceUnsupported:
        br.release_probe(session=sid)
        raise
    except Exception as e:
        cls = classify(e)
        if cls not in (CLASS_COMPILE, CLASS_TRANSPORT):
            br.release_probe(session=sid)
            raise
        from ..errors import DeviceCompileError
        err = DeviceCompileError(f"device compile failed ({cls}): {e}")
        err.__cause__ = e
        with _LOCK:
            _LAST_ERROR[0] = f"{cls}: {e}"
        br.record_failure(err, session=sid, group=group)
        if _tsp is not None:
            _tsp.tags["mode"] = "sync_failed"
        tracing.event("host_degraded", reason="compile_" + cls, shape=shape)
        raise DeviceUnsupported(
            f"device compile failed ({cls}): {e} "
            f"({shape} fragment degraded to host engine)") from err
    br.record_success(session=sid)
    with _LOCK:
        STATS["sync_compiles"] += 1
    from .device_exec import _pipe_cache_put
    _pipe_cache_put(key, fn, dict_refs)
    _mode("sync")
    if _tsp is not None:
        _tsp.tags["mode"] = "sync"
    return fn


def prewarm(ctx=None, ladder_up: int = 2, max_recipes: int = 32,
            wait: bool = False, timeout_s: float = 120.0) -> dict:
    """ADMIN COMPILE: the port builds synchronously, so there is nothing
    to warm ahead of traffic yet (ROADMAP queue 1, the compile
    layer)."""
    return {"submitted": 0, "prewarmed": 0, "failed": 0}


def maybe_prewarm_on_start(domain):
    """Domain-start prewarm kick: a no-op while builds are synchronous."""
    return None


def on_backend_reinit():
    """The supervisor fenced the backend and cleared the pipe cache."""
    return None


# -- gauges -------------------------------------------------------------------

def queue_depth() -> int:
    """Background jobs waiting: builds are synchronous, so none."""
    return 0


def snapshot() -> dict:
    with _LOCK:
        return {"compile_queue_depth": 0,
                "recipes": 0,
                "workers": 0,
                "last_error": _LAST_ERROR[0],
                **{k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in STATS.items()}}


def report_gauges() -> dict:
    """What EXPLAIN ANALYZE shows (the reference's policy: queue depth
    always, the counters only once they have ever fired)."""
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
    (device_exec._charge_compile_s feeds `sync_compile_seconds`)."""
    with _LOCK:
        sinks = list(_SINKS)
    for obs in sinks:
        f = getattr(obs, "observe_hist", None)
        if f is not None:
            f(name, value)
