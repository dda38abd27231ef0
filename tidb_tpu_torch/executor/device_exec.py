"""Device (CUDA) execution paths for the hot operators.

The fused scan→filter→aggregate pipeline: when a HashAgg sits directly on a
TableScan, the pushed-down filters, the aggregate input expressions and the
grouping run as two kernels — the expression VM (ops/kernels/expr_vm.py,
one program for the mask, keys and values) and the group-by aggregate
(ops/kernels/groupby_agg.py) — and the host only dict-encodes strings and
reads back `capacity`-bounded results.  An ORDER BY ... LIMIT over the
groups selects its rows on the device (ops/kernels/sort_topk.py).

The whole-table scan-aggregate path, the streamed scan-aggregate
(``device_agg_streaming``: pages through ops/stream.py, per-page K2 + K1,
partial states folded by the merge kernel ops/kernels/merge_states.py),
the standalone join match (``device_join_keys``: K4 + K5a + K5b
through ``ops/device.py device_join_match``) and window functions
(``device_window``: K2 for the keys and arguments, K4 for the window's
order, K10 ops/kernels/window_scan.py for the flags, scans and scatter)
are ported.
"""

from __future__ import annotations

import collections
import time as _time

import numpy as np
import torch

from ..errors import TiDBError
from ..expression import phys_kind, K_DEC, K_FLOAT, K_STR, K_DATE
from ..expression.core import Column as ExprColumn
from ..ops import device as dev, stream
from ..ops.device import DeviceUnsupported
from ..ops.kernels import expr_vm, merge_states, sort_topk, window_scan
from ..sqltypes import POW10
from ..utils.chunk import Chunk, Column, np_dtype_for


def engine_mode(ctx) -> str:
    # a statement-scoped /*+ READ_FROM_STORAGE(...) */ pin outranks the
    # session sysvar (set per root executor build; see executor/__init__)
    eh = getattr(ctx, "stmt_engine_hint", None)
    if eh:
        return eh
    try:
        return ctx.get_sysvar("tidb_executor_engine")
    except Exception:
        return "auto"


def run_device(ctx, fn, /, *args, shape="agg", batch_key=None, **kw):
    """Dispatch one device fragment through the serving admission layer
    (executor/scheduler.py), the circuit breaker (executor/circuit.py)
    and the device-runtime supervisor (executor/supervisor.py) — the four
    layers every fragment passes, in order: ADMISSION (may this fragment
    occupy the shared device now?) → SUPERVISOR deadline → BREAKER →
    RESIDENCY budget.

    Admission: the fragment holds a scheduler ticket for the duration of
    the device call — weighted fair queueing across resource groups
    (`tidb_resource_group`), bounded queue depth, per-tenant running
    caps.  A refusal (queue full / wait timeout, classified
    DeviceAdmissionError 9009) degrades this fragment to the host engine
    exactly like an OPEN breaker — overload means host and device serve
    DIFFERENT work concurrently, not an error.  `batch_key` (the
    compiled-pipeline identity of the fragment, when the dispatch site
    can compute it cheaply) lets queued same-shaped fragments coalesce
    onto one scheduling slot, sharing the compiled program and resident
    uploads cross-session.

    An OPEN breaker degrades to the host engine up front
    (DeviceUnsupported → the caller's existing fallback), and a
    classified device/transport failure — an XLA runtime error, a dead
    remote-compile tunnel, an injected fault — records into the breaker
    and ALSO degrades instead of killing the query.  DeviceUnsupported
    and TiDBError pass through untouched: "this fragment doesn't fit the
    device" and genuine user errors are not health signals.

    When a deadline is in force (`tidb_device_call_timeout` sysvar or a
    running `max_execution_time` window) the fragment executes on a
    supervised worker thread: a backend HANG raises a classified
    DeviceHangError into the query (recorded against the breaker, so
    repeated hangs trip degradation), the abandoned call is fenced, and
    the wait stays KILL-interruptible even while the backend blocks
    inside a GIL-holding C call.

    A classified device OUT-OF-MEMORY walks the recovery ladder before
    degrading: evict every residency-tracked HBM upload
    (ops/residency.recover_oom) → retry the fragment ONCE against the
    emptied device → only then record the failure and degrade to host.
    Transient HBM pressure (another session's working set, a one-off
    giant intermediate) costs one re-upload instead of a cooldown.

    `shape` scopes the breaker per fragment class (agg / join / window):
    one failing shape cools down without degrading healthy paths.

    Under the serving fabric (tidb_tpu/fabric) a batch_key'd dispatch
    first consults the FLEET fragment-dedup table: identical concurrent
    fragments — same structural batch key AND same input-chunk content
    hash — anywhere in the fleet dispatch ONE device call; followers
    wait (before admission, so they hold no device slot) and map the
    leader's result page back in.  No fleet, no batch key, or no
    hashable input -> the plain dispatch below."""
    if batch_key is not None:
        from ..fabric import state as fabric_state
        ded = fabric_state.dedup_handle()
        if ded is not None:
            kh = ded.key_hash(batch_key, args)
            if kh is not None:
                return ded.coalesce(
                    ctx, shape, kh,
                    lambda: _run_device_dispatch(ctx, fn, args, kw, shape,
                                                 batch_key))
    return _run_device_dispatch(ctx, fn, args, kw, shape, batch_key)


def _run_device_dispatch(ctx, fn, args, kw, shape, batch_key):
    """The admitted dispatch (layer 1 onward) for one fragment — the
    fabric dedup leader's compute path, and the whole of run_device
    outside a fleet."""
    from ..errors import DeviceAdmissionError
    from ..fabric import perf as fabric_perf
    from ..session import tracing
    from . import scheduler
    group = scheduler.resource_group(ctx)
    scheduler.attach(ctx)
    # shared fragment-perf store feed (fabric/perf.py): this dispatch's
    # admission wait, sync-compile share and device wall time accumulate
    # under the fragment's (sig, bucket) — fleet-mergeable observe-only
    # data, buffered locally and flushed off the hot path
    psig, pbucket = fabric_perf.dispatch_key(batch_key, shape)
    with tracing.span("device.dispatch", shape=shape, group=group):
        ta0 = _time.perf_counter()
        try:
            ticket = scheduler.admit(ctx, shape=shape, batch_key=batch_key)
        except DeviceAdmissionError as e:
            # load pressure, not device ill-health: no breaker charge —
            # the fragment runs on the host engine (per-tenant gauge
            # records it; the trace carries the classified reason)
            scheduler.note_degradation(group)
            tracing.event("host_degraded", reason="admission", shape=shape)
            raise DeviceUnsupported(
                f"device admission refused for {shape} fragment "
                f"(resource group '{group}'; degraded to host engine): "
                f"{e}") from e
        finally:
            # refusals contribute too: the timeout wait a refused
            # fragment paid is exactly the tail this series exists for
            fabric_perf.note(psig, pbucket, "device", "admission_wait",
                             _time.perf_counter() - ta0)
        t0 = _time.perf_counter()
        c0 = _tls_stats()["compile_s"]
        try:
            return _run_device_admitted(ctx, fn, args, kw, shape, group)
        finally:
            scheduler.release(ticket)
            # per-fragment latency histogram (session/observe.py
            # HIST_BUCKETS): one admitted dispatch end-to-end — in the
            # finally so FAILED dispatches (supervisor-deadline hangs,
            # post-OOM degrades) contribute too; the pathological
            # latencies are exactly the p99 this series exists to show
            dt = _time.perf_counter() - t0
            # the TLS pipe-stats mirror attributes exactly this thread's
            # sync-compile seconds to this dispatch (concurrent sessions
            # can't cross-charge — same contract as pipe_cache_stats)
            dc = _tls_stats()["compile_s"] - c0
            if dc > 0:
                fabric_perf.note(psig, pbucket, "device", "compile", dc)
            fabric_perf.note(psig, pbucket, "device", "dispatch", dt)
            obs = getattr(getattr(ctx, "domain", None), "observe", None)
            if obs is not None and hasattr(obs, "observe_hist"):
                obs.observe_hist("device_dispatch_seconds", dt)


def _run_device_admitted(ctx, fn, args, kw, shape, group):
    """Layers 2-4 (supervisor deadline → breaker → residency) for a
    fragment that holds its admission ticket."""
    from ..errors import DeviceHangError
    from ..ops import residency
    from ..session import tracing
    from ..utils.backoff import (classify, is_device_oom, CLASS_DEVICE,
                                 CLASS_EXCHANGE, CLASS_FAULT,
                                 CLASS_TRANSPORT)
    from . import supervisor
    from .circuit import get_breaker
    br = get_breaker(ctx, shape=shape)
    sid = getattr(ctx, "conn_id", None)
    if not br.allow(session=sid, group=group):
        tracing.event("host_degraded", reason="breaker_open", shape=shape)
        raise DeviceUnsupported(
            f"device circuit open for {shape} fragments (cooling down; "
            "fragment degraded to host engine)")
    residency.attach(ctx)  # budget sysvar + tenant + observe gauge sink
    deadline_s, fence_on_expiry = supervisor.deadline_for(ctx)
    oom_retried = False
    while True:
        try:
            out = supervisor.call_supervised(
                fn, args, kw, deadline_s=deadline_s, ctx=ctx, shape=shape,
                fence_on_expiry=fence_on_expiry)
        except DeviceHangError as e:
            # the hang IS a health verdict: count it toward opening the
            # breaker, then surface the classified error — the query fails
            # (its device call is still in flight; a silent host fallback
            # would hide that the deadline fired) but the NEXT queries
            # degrade once the breaker trips
            br.record_failure(e, session=sid, group=group)
            tracing.event("breaker.recorded", cls="hang", shape=shape)
            raise
        except (DeviceUnsupported, TiDBError):
            # no health verdict: if this fragment held the HALF_OPEN probe
            # slot, free it — otherwise the breaker wedges with no prober
            br.release_probe(session=sid)
            raise
        except (KeyboardInterrupt, SystemExit):
            # Ctrl-C mid-probe must not wedge the breaker in HALF_OPEN
            br.release_probe(session=sid)
            raise
        except Exception as e:
            cls = classify(e)
            if cls not in (CLASS_DEVICE, CLASS_TRANSPORT, CLASS_FAULT,
                           CLASS_EXCHANGE):
                # an UNCLASSIFIED error is a programming bug, not a device
                # health signal: surface it instead of silently degrading
                br.release_probe(session=sid)
                raise
            if not oom_retried and is_device_oom(e):
                # OOM ladder step 1+2: evict all cached HBM, ONE retry.
                # No breaker charge yet — an OOM the eviction absorbs is
                # pressure, not device ill-health; a SECOND failure of any
                # class takes the normal degrade path below.
                oom_retried = True
                tracing.event("oom_ladder", step="evict_all_retry",
                              shape=shape)
                residency.recover_oom(e)
                continue
            br.record_failure(e, session=sid, group=group)
            tracing.event("host_degraded", reason=cls, shape=shape)
            raise DeviceUnsupported(
                f"device failure ({cls}): {e}") from e
        br.record_success(session=sid)
        return out


def want_device(ctx, n_rows: int) -> bool:
    mode = engine_mode(ctx)
    if mode == "host":
        return False
    if mode == "tpu":
        return True
    try:  # auto: device dispatch overhead beneath this row floor
        floor = int(ctx.get_sysvar("tidb_device_dispatch_rows"))
    except Exception:
        floor = 65536
    if floor <= 0:
        # derive the floor from the calibrated cost constants (one
        # currency for planner placement AND runtime gating — with
        # uncalibrated defaults this is the historical 65536)
        from ..planner.cost_model import CostModel
        floor = CostModel.from_ctx(ctx).device_breakeven_rows()
    return n_rows >= floor


#: built fused pipelines keyed by plan signature — the whole
#: filter→keys→values program is ONE expression-VM program, assembled once
#: and re-dispatched on later executions (reference analog: coprocessor DAG
#: compiled per plan digest). LRU-bounded; each entry pins strong refs to
#: the string dictionaries whose codes are baked into the program.
#: Key components that depend on a dictionary use its CONTENT signature
#: (utils/chunk.py dict_content_sig), not its id: a delta append re-encodes
#: into new dictionary objects whose content — and therefore every baked
#: code LUT — is usually unchanged, and shape bucketing (ops/device.py
#: bucket_rows) keeps the traced array shapes stable too, so the compiled
#: program survives the delta.
_PIPE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_PIPE_CACHE_MAX = 256

#: compiled-fragment cache observability: hits/misses are _PIPE_CACHE
#: lookups; traces / compiles count pipeline builds; compile_s is their
#: wall time. Surfaced
#: per query through EXPLAIN ANALYZE annotations and bench.py compile_s.
#: Process totals are lock-guarded; a THREAD-LOCAL mirror gives per-query
#: delta attribution that concurrent sessions can't cross-charge.
import threading as _threading

_PIPE_STATS = {"hits": 0, "misses": 0, "traces": 0, "compiles": 0,
               "compile_s": 0.0,
               # background mirror: compile work done on compile-service
               # worker threads lands here instead, so per-query compile_s
               # stays the SYNC cost
               "bg_traces": 0, "bg_compiles": 0, "bg_compile_s": 0.0,
               # compile-mode counters (executor/compile_service.py):
               # how each pipeline resolution was served — drives the
               # per-fragment compile_mode EXPLAIN ANALYZE annotation
               "mode_cached": 0, "mode_bg": 0, "mode_prewarmed": 0,
               "mode_async_pending": 0, "mode_sync": 0}
_PIPE_LOCK = _threading.Lock()
_PIPE_TLS = _threading.local()

#: process-total keys a compile-service worker thread redirects into the
#: bg_* mirror (its own TLS keeps the plain names)
_BG_ROUTED = frozenset({"traces", "compiles", "compile_s"})


def mark_bg_thread(on: bool = True) -> bool:
    """Mark the CALLING thread as a background compile worker: its
    trace/compile charges route to the process bg_* keys (query-path
    compile accounting must not absorb background work).  Returns the
    previous mark so a SCOPED marking (compile_service._do_compile under
    a supervisor deadline runs on a REUSED supervisor worker thread)
    can restore it."""
    prev = getattr(_PIPE_TLS, "bg", False)
    _PIPE_TLS.bg = on
    return prev


def _tls_stats() -> dict:
    st = getattr(_PIPE_TLS, "stats", None)
    if st is None:
        st = _PIPE_TLS.stats = {"hits": 0, "misses": 0, "traces": 0,
                                "compiles": 0, "compile_s": 0.0,
                                "mode_cached": 0, "mode_bg": 0,
                                "mode_prewarmed": 0,
                                "mode_async_pending": 0, "mode_sync": 0}
    return st


def _bump(key, amt=1):
    pkey = key
    if key in _BG_ROUTED and getattr(_PIPE_TLS, "bg", False):
        pkey = "bg_" + key
    with _PIPE_LOCK:
        _PIPE_STATS[pkey] += amt
    st = _tls_stats()
    if key in st:
        st[key] += amt


def pipe_cache_stats(thread_local: bool = False) -> dict:
    """Cache/compile counters: process-wide totals by default, or this
    thread's own (for before/after deltas around one dispatch — the
    process totals would charge a concurrent session's compile here)."""
    if thread_local:
        return dict(_tls_stats())
    with _PIPE_LOCK:
        return dict(_PIPE_STATS)


def _pipe_cache_get(key):
    # OrderedDict LRU mutation is NOT thread-safe; concurrent sessions
    # (threaded chaos, server connections) share this cache, so every
    # structural touch happens under the stats lock
    with _PIPE_LOCK:
        hit = _PIPE_CACHE.get(key)
        if hit is not None:
            _PIPE_CACHE.move_to_end(key)
    if hit is None:
        _bump("misses")
        return None
    _bump("hits")
    return hit[0]


def _pipe_cache_put(key, fn, dict_refs):
    with _PIPE_LOCK:
        _PIPE_CACHE[key] = (fn, dict_refs)
        if len(_PIPE_CACHE) > _PIPE_CACHE_MAX:
            _PIPE_CACHE.popitem(last=False)


def acquire_pipeline(key, build, dict_refs, *, ctx=None, args=None,
                     spec=None, shape="agg", sig="", ladder=True):
    """THE pipeline resolution chokepoint: every compiled query pipeline
    (scan-agg, streamed, window, join fragment, MPP) resolves through
    here — cache hit, or the compile service (async background compile /
    persistent-index warm start / sync build; executor/compile_service).

    `build` is a zero-arg builder returning the jitted fn; `args` the
    concrete call arguments (shapes recorded for background warming and
    the prewarm ladder — pass them whenever the dispatch site has them).
    Raises DeviceUnsupported when the fragment should run host-side
    while its executable compiles in the background."""
    fn = _pipe_cache_get(key)
    if fn is not None:
        from . import compile_service
        compile_service.note_hit(key)
        from ..session import tracing
        tracing.event("compile.cached", shape=shape)
        return fn
    from . import compile_service
    return compile_service.obtain(key, build, dict_refs, ctx=ctx,
                                  args=args, spec=spec, shape=shape,
                                  sig=sig, ladder=ladder)


def _count_trace():
    """Called at a pipeline's first call at each argument shape, never on
    a repeat — and on the thread that dispatched, so the thread-local
    mirror attributes the build to the right query."""
    _bump("traces")


def _charge_compile_s(seconds):
    _bump("compiles")
    _bump("compile_s", seconds)
    from ..session import tracing
    tracing.event("compile.xla", s=round(seconds, 4))
    if not getattr(_PIPE_TLS, "bg", False):
        # sync compiles only: the query path PAID this wall time, so it
        # belongs in the scrapeable per-layer histogram — background
        # builds overlap host serving and would poison the p99
        from . import compile_service
        compile_service.observe_hist("sync_compile_seconds", seconds)


def _shape_sig(x, out):
    """The (shape, dtype) of every tensor in an argument tree, in order;
    other leaves do not key a pipeline's shape (as a jit traces Python
    scalars as values, not as new programs)."""
    if isinstance(x, torch.Tensor):
        out.append((x.shape, x.dtype))
    elif isinstance(x, (tuple, list)):
        for v in x:
            _shape_sig(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _shape_sig(v, out)
    return out


class _Pipeline:
    """A built pipeline: `fn` with the reference's jit retrace rule.  Its
    first call at each argument shape counts one trace (the port's
    counterpart of a jit retrace: the kernels' first launches at that
    shape); a repeat at a seen shape costs one walk over the argument
    tree.  Compile time stays the assembly's alone, charged where the
    pipeline is built (:func:`_timed_jit`)."""

    __slots__ = ("fn", "_seen", "__weakref__")

    def __init__(self, fn):
        self.fn = fn
        self._seen = set()

    def __call__(self, *args, **kw):
        sig = tuple(_shape_sig(kw, _shape_sig(args, [])))
        if sig not in self._seen:
            with _PIPE_LOCK:
                new = sig not in self._seen
                self._seen.add(sig)
            if new:
                _count_trace()
        return self.fn(*args, **kw)


def _timed_jit(fn, t0=None):
    """Where the reference jit-compiles a pipeline.  The port's pipelines
    are plain Python over prebuilt kernels: this charges the seconds
    since `t0` — the program assembly — as compile time, and the
    returned :class:`_Pipeline` counts a trace at each new argument shape
    (the `traces`/`compiles` stats behind EXPLAIN ANALYZE's
    xla_compiles)."""
    _charge_compile_s(_time.perf_counter() - t0 if t0 is not None else 0.0)
    return _Pipeline(fn)


def _dc_sig(dc) -> str:
    """Content signature of a DeviceCol's dictionary for cache keys (falls
    back to id() only when no backing host column exists)."""
    if dc.dictionary is None:
        return ""
    hc = dc.host_col
    if hc is not None:
        try:
            return hc.dict_sig()
        except Exception:
            pass
    from ..utils.chunk import dict_content_sig
    return dict_content_sig(dc.dictionary)


def _expr_sig(e) -> str:
    """Structural signature of an expression (type-aware; reprs alone drop
    decimal scales, which change the traced program)."""
    from ..expression.core import Constant as _Const, ScalarFunc as _SF
    ft = e.ftype
    base = f"{ft.tp}.{ft.scale}"
    if isinstance(e, ExprColumn):
        return f"c{e.idx}:{base}"
    if isinstance(e, _Const):
        return f"k{e.value!r}:{base}"
    if isinstance(e, _SF):
        extra = f"|{e.extra!r}" if e.extra is not None else ""
        return (f"{e.op}({','.join(_expr_sig(a) for a in e.args)})"
                f"{extra}:{base}")
    # apply-subqueries etc. never run on device
    raise DeviceUnsupported(f"{type(e).__name__} in device fragment")


#: optional callback(prog, inputs, n, n_live, n_keys, agg_ops, capacity,
#: pack) run at every pipeline dispatch: lets a harness (chip_smoke.py)
#: hold the kernels against their plain versions on the main path's own
#: programs and inputs.  None in serving.
PIPELINE_OBSERVER = [None]


def _build_pipeline(cond_fns, key_fns, n_keys, val_plan, agg_ops,
                    capacity, pack, raw_tail=False):
    """Assemble the compiled expression nodes into ONE VM program and bind
    it with the aggregate: mask, keys and values come out of one pass of
    the expression kernel, and the group-by kernel consumes them.

    The pipeline takes `(env, n_live)` where env tensors may be
    BUCKET-PADDED past the live rows (ops/device.py bucket_rows): rows at
    positions >= n_live are masked out before the aggregate, so padding
    can never survive a filter or contribute to any group.

    raw_tail: stop before the aggregate and return the evaluated
    (key_cols, key_nulls, val_cols, val_nulls, mask) rows."""
    t0 = _time.perf_counter()
    prog = expr_vm.Program.build(cond_fns, key_fns, val_plan)

    def pipeline(env, n_live):
        first = next(iter(env.values()))[0]
        n = first.shape[0]
        inputs = [env[idx] for idx in prog.in_cols]
        obs = PIPELINE_OBSERVER[0]
        if obs is not None:
            obs(prog, inputs, n, int(n_live), n_keys, agg_ops, capacity,
                pack)
        mask, outs = expr_vm.run(prog, inputs, n, int(n_live), first.device)
        key_cols = [outs[s][0] for s in prog.key_slots]
        key_nulls = [outs[s][1] for s in prog.key_slots]
        if not key_cols:
            key_cols = [torch.zeros(n, dtype=torch.int64, device=first.device)]
            key_nulls = [torch.zeros(n, dtype=torch.bool, device=first.device)]
        val_cols = [outs[s][0] for s in prog.val_slots]
        val_nulls = [outs[s][1] for s in prog.val_slots]
        if raw_tail:
            return (tuple(key_cols), tuple(key_nulls), tuple(val_cols),
                    tuple(val_nulls), mask)
        return dev._agg_impl(tuple(key_cols), tuple(key_nulls),
                             tuple(val_cols), tuple(val_nulls), mask,
                             n_keys=n_keys, agg_ops=agg_ops,
                             capacity=capacity, pack=pack)

    return _timed_jit(pipeline, t0)


def _agg_used_columns(plan, conds) -> set:
    used = set()
    for e in plan.group_exprs:
        e.columns_used(used)
    for d in plan.aggs:
        for a in d.args:
            a.columns_used(used)
    for c in conds:
        c.columns_used(used)
    return used


def _agg_struct_parts(plan, conds) -> list:
    """The STRUCTURAL part of a scan-agg fragment's signature (conds,
    group exprs, agg descs — everything except dictionary content).  One
    helper feeds both _agg_sig and agg_batch_key so the admission batch
    key can never silently diverge from the compiled-pipeline identity
    it claims to prefix."""
    return (
        [_expr_sig(c) for c in conds] + ["|g|"] +
        [_expr_sig(e) for e in plan.group_exprs] + ["|a|"] +
        [f"{d.name}:{_expr_sig(d.args[0]) if d.args else ''}"
         for d in plan.aggs])


def _agg_sig(plan, conds, dcols) -> tuple:
    """(signature string, dictionary refs) for the pipeline cache — shared
    by the whole-table and streamed paths so their caches never diverge.
    Dictionaries contribute their CONTENT signature: a delta append that
    re-encodes the same value set must hit the cached pipeline."""
    sig = ";".join(
        _agg_struct_parts(plan, conds) +
        [f"{idx}:{_dc_sig(dc)}" for idx, dc in sorted(dcols.items())
         if dc.dictionary is not None])
    refs = tuple(dc.dictionary for dc in dcols.values()
                 if dc.dictionary is not None)
    return sig, refs


def agg_batch_key(plan, conds, n_rows: int, ctx=None):
    """Cheap admission-batching identity for a scan-agg fragment: the
    structural (plan sig, bucket shape) prefix of the compiled-pipeline
    cache key — dictionary CONTENT sigs are deliberately omitted (they
    require the columns in hand; admission runs before the upload).
    Queued fragments sharing this key coalesce onto one scheduling slot
    (executor/scheduler.py): identical keys re-dispatch the same cached
    XLA program against the same bucket, so N concurrent same-shaped
    queries cost ~one device call.  None when the fragment contains
    expressions the device can't sign (it won't batch, just queue)."""
    try:
        sig = ";".join(_agg_struct_parts(plan, conds))
        return ("agg", sig, dev.bucket_rows(n_rows, dev.shape_buckets(ctx)))
    except Exception:
        return None


def device_agg(plan, chunk: Chunk, conds, ctx=None) -> Chunk:
    """Fused filter+group+aggregate on device. Raises DeviceUnsupported to
    trigger host fallback."""
    from ..utils import failpoint
    # chaos/breaker hook: a `panic` here models a device runtime failure
    # (dead tunnel, OOM) at the fragment boundary
    failpoint.inject("device-agg-exec")
    n = chunk.num_rows
    if n == 0:
        raise DeviceUnsupported("empty input")
    # canonicalize the traced shape: upload at the row bucket, mask live
    # rows in-program — a within-bucket delta reuses the compiled pipeline
    nb = dev.bucket_rows(n, dev.shape_buckets(ctx))
    used = _agg_used_columns(plan, conds)
    dcols = {}
    env = {}
    for idx in used:
        dc = dev.to_device_col(chunk.columns[idx], bucket=nb)
        dcols[idx] = dc
        env[idx] = (dc.data, dc.nulls)
    if not env:
        raise DeviceUnsupported("no columns")
    from ..session import tracing
    tracing.event("device.upload", cols=len(env), bucket=nb, rows=n)

    # --- host-side planning only below (no device ops until dispatch) ---
    cond_fns = [dev.compile_expr(c, dcols) for c in conds]
    (key_fns, key_meta, key_pack, val_plan, agg_ops,
     slots) = _plan_agg(plan, dcols)
    n_keys = max(len(key_fns), 1)
    sig_exprs, dict_refs = _agg_sig(plan, conds, dcols)
    est = _estimate_groups(plan, n, ctx)
    capacity = dev.next_pow2(min(n, max(est, 16)))
    while True:
        key = (sig_exprs, capacity, key_pack, tuple(agg_ops))
        cap = capacity

        def build(cap=cap):
            return _build_pipeline(cond_fns, key_fns, n_keys, val_plan,
                                   tuple(agg_ops), cap, key_pack)
        fn = acquire_pipeline(key, build, dict_refs, ctx=ctx,
                              args=(env, n), shape="agg", sig=sig_exprs)
        f = AggFetch(fn(env, n), topn=resolve_topn(plan, slots))
        ng = f.ng
        if ng <= capacity:
            break
        capacity = dev.next_pow2(ng)
    if ng == 0 and not plan.group_exprs:
        # global aggregate over zero kept rows still yields ONE row
        # (count=0, sum/min/max NULL) — host path has the special case
        raise DeviceUnsupported("empty global aggregate")
    body = f.body()
    return _assemble_agg(plan, key_meta, slots, dcols, body, f.out_rows)


#: below this payload, one batched round trip beats two
_SMALL_FETCH_BYTES = 1 << 18


def _fetch(tree):
    """Device → host copy of a nested tuple of tensors in ONE transfer:
    every leaf is flattened into one int64 buffer (float64 by bit view,
    bools widened), copied with a single ``.cpu()``, and split back into
    numpy arrays of the leaves' dtypes and shapes."""
    leaves, shapes = [], []

    def walk(t):
        if isinstance(t, (tuple, list)):
            return tuple(walk(x) for x in t)
        i = len(leaves)
        leaves.append(t)
        shapes.append((tuple(t.shape), t.dtype))
        return i

    skel = walk(tree)
    if not leaves:
        return skel
    flat = []
    for t in leaves:
        t = t.reshape(-1)
        if t.dtype == torch.float64:
            t = t.view(torch.int64)
        elif t.dtype != torch.int64:
            t = t.to(torch.int64)
        flat.append(t)
    host = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for shape, dt in shapes:
        size = int(np.prod(shape)) if shape else 1
        part = host[off:off + size]
        off += size
        if dt == torch.float64:
            arr = part.view(np.float64)
        elif dt == torch.bool:
            arr = part.astype(bool)
        elif dt == torch.int64:
            arr = part
        else:
            arr = part.astype(str(dt).replace("torch.", ""))
        out.append(arr.reshape(shape))

    def build(x):
        return tuple(build(y) for y in x) if isinstance(x, tuple) else out[x]
    return build(skel)


class AggFetch:
    """Device→host fetch of an _agg_impl result tree: big capacities read
    the group count (+ any convergence scalars) first and then ONE copy of
    just the live [:ng] prefix — or, under a TopN annotation, of the top
    candidate groups selected on the device.  Small results keep the
    single round trip.  On a retry (caller sees ng/overflow and runs again
    with a bigger capacity) the body is never fetched at all."""

    def __init__(self, agg_out, extras=(), topn=None):
        (self._keys, self._key_nulls, self._results, self._result_nulls,
         n_groups, _valid) = agg_out
        arrays = (*self._keys, *self._key_nulls, *self._results,
                  *self._result_nulls)
        self._cap = int(arrays[0].shape[0]) if arrays else 0
        row_bytes = sum(a.element_size() for a in arrays) or 1
        self._topn = topn
        self._body = None
        self.out_rows = None  # rows in body(); set on fetch
        if self._cap * row_bytes <= _SMALL_FETCH_BYTES:
            self._body, ngv, self.extras = _fetch(
                (tuple(agg_out[:4]), n_groups, tuple(extras)))
            self.ng = self.out_rows = int(ngv)
        else:
            ngv, self.extras = _fetch((n_groups, tuple(extras)))
            self.ng = int(ngv)

    def body(self):
        """(key_out, key_null_out, results, result_nulls): the live groups
        — or, under a TopN annotation, just the top candidate groups in
        TopN-key order (selected on-device, so the copy carries k rows
        instead of millions)."""
        if self._body is None:
            k = min(max(self.ng, 1), self._cap)
            if self._topn is not None and self.ng > self._topn[1]:
                specs, kf = self._topn
                idx = _topk_indices(self._keys, self._key_nulls,
                                    self._results, self._result_nulls,
                                    self.ng, self._cap, specs, kf)
                self._body = _fetch(tuple(
                    tuple(a[idx] for a in t)
                    for t in (self._keys, self._key_nulls,
                              self._results, self._result_nulls)))
                self.out_rows = kf
                return self._body

            def sl(t):
                return tuple(a[:k] for a in t)
            self._body = _fetch(
                (sl(self._keys), sl(self._key_nulls),
                 sl(self._results), sl(self._result_nulls)))
            self.out_rows = self.ng
        return self._body


#: top-k selectors by (cap, k, spec, dtype) signature.  Structural access
#: happens under _PIPE_LOCK, same as _PIPE_CACHE: the fence path
#: (supervisor._reinit_backend) clears this cache while executor threads
#: install into it
_TOPK_CACHE: dict = {}


def _topk_indices(keys, key_nulls, results, result_nulls, ng, cap, specs,
                  k):
    """Indices of the top-k live groups ordered by `specs` (device-side,
    ops/kernels/sort_topk.py). specs: (("key"|"res", j, desc), ...). Null
    ordering matches the host comparator (ops/host.py sort_indices: NULLs
    first ASC, last DESC); descending ints order by bitwise-not (exact,
    unlike negation at int64.min); rows past ng sort behind everything;
    ties keep slot order."""
    by = []
    for src, j, _desc in specs:
        d = keys[j] if src == "key" else results[j]
        nl = key_nulls[j] if src == "key" else result_nulls[j]
        by.append((d, nl))
    sig = (cap, k, tuple((s[0], s[2]) for s in specs),
           tuple(str(d.dtype) for d, _ in by))
    with _PIPE_LOCK:
        fn = _TOPK_CACHE.get(sig)
    if fn is None:
        t0 = _time.perf_counter()
        descs = [bool(s[2]) for s in specs]

        def run(by_arrays, ng_):
            cols = [d if d.dtype in (torch.int64, torch.float64)
                    else d.to(torch.int64) for d, _nl in by_arrays]
            nulls = [nl for _d, nl in by_arrays]
            return sort_topk.sort_indices(cols, nulls, descs,
                                          [not d for d in descs], cap,
                                          int(ng_), k)

        built = _timed_jit(run, t0)  # bumps the stats under _PIPE_LOCK
        with _PIPE_LOCK:
            # setdefault: a racing builder's selector wins once installed
            fn = _TOPK_CACHE.setdefault(sig, built)
    return fn(by, ng)


def resolve_topn(plan, slots):
    """plan.topn_fetch (agg-OUTPUT indices) → AggFetch specs over the
    device result arrays: group keys map 1:1; aggregate outputs map
    through their result slot. None when not annotated or unmappable."""
    tf = getattr(plan, "topn_fetch", None)
    if not tf or not plan.group_exprs:
        return None
    ngk = len(plan.group_exprs)
    specs = []
    for oi, desc in tf[0]:
        if oi < ngk:
            specs.append(("key", oi, desc))
        else:
            slot = slots[oi - ngk]
            if slot[0] == "avg":
                return None
            specs.append(("res", slot[1], desc))
    return tuple(specs), int(tf[1])


def _plan_agg(plan, dcols):
    """Host-side agg planning shared by the scan-agg pipeline and the join
    fragment: compile group keys and aggregate inputs against `dcols`
    (global column idx → DeviceCol). Returns
    (key_fns, key_meta, key_pack, val_plan, agg_ops, slots)."""
    key_fns = []
    key_meta = []  # (expr, decode dictionary or None)
    key_sizes = []  # dict size for string keys (packing), None otherwise
    for e in plan.group_exprs:
        k = phys_kind(e.ftype)
        if k == K_STR:
            # any string-valued expression: codes into its key dictionary
            # (ops/device.py compile_str_expr — CASE/SUBSTRING/… included)
            fn, key_dict, reps = dev.compile_str_expr(e, dcols)
            key_meta.append((e, reps))
            key_fns.append(fn)
            key_sizes.append(len(key_dict))
        elif k == K_FLOAT:
            raise DeviceUnsupported("float group keys")
        else:
            key_meta.append((e, None))
            key_fns.append(dev.compile_expr(e, dcols))
            key_sizes.append(None)
    if key_fns:
        key_pack = _key_pack(plan.group_exprs, key_sizes, dcols)
    else:
        key_pack = ((1, 0),)

    # aggregate value columns + op names; avg = sum + count pair
    val_plan, agg_ops = [], []
    slots = []  # per desc: ("plain", j) | ("avg", j_sum, j_cnt) | ("strcol", j, col)
    for desc in plan.aggs:
        if desc.distinct:
            # COUNT(DISTINCT x): the sorted kernel counts value runs per
            # group (ops/device.py cnt_dist). Other distinct aggs (and
            # multi-arg forms) stay host-side.
            if (desc.name == "count" and len(desc.args) == 1
                    and phys_kind(desc.args[0].ftype)
                    not in (K_FLOAT, K_STR)):
                val_plan.append((dev.compile_expr(desc.args[0], dcols),
                                 "int"))
                agg_ops.append("cnt_dist")
                slots.append(("plain", len(val_plan) - 1))
                continue
            if (desc.name == "count" and len(desc.args) == 1
                    and phys_kind(desc.args[0].ftype) == K_STR):
                # dict codes are value-faithful: distinct codes ==
                # distinct strings
                fn, _kd, _reps = dev.compile_str_expr(desc.args[0], dcols)
                val_plan.append((fn, "int"))
                agg_ops.append("cnt_dist")
                slots.append(("plain", len(val_plan) - 1))
                continue
            raise DeviceUnsupported("distinct agg on device")
        arg = desc.args[0] if desc.args else None
        name = desc.name
        if name == "count":
            val_plan.append((dev.compile_expr(arg, dcols), "int"))
            agg_ops.append("count")
            slots.append(("plain", len(val_plan) - 1))
            continue
        if name not in ("sum", "avg", "min", "max", "first_row"):
            raise DeviceUnsupported(f"agg {name} on device")
        k = phys_kind(arg.ftype)
        if k == K_STR and name in ("min", "max", "first_row"):
            # key dictionaries are sorted → code order == value order
            fn, _key_dict, reps = dev.compile_str_expr(arg, dcols)
            val_plan.append((fn, "int"))
            agg_ops.append({"min": "min", "max": "max",
                            "first_row": "first"}[name])
            slots.append(("strcol", len(val_plan) - 1, reps))
            continue
        if k == K_STR:
            raise DeviceUnsupported("string sum/avg")
        f = dev.compile_expr(arg, dcols)
        is_float = k == K_FLOAT
        if name in ("min", "max", "first_row"):
            val_plan.append((f, "raw"))
            agg_ops.append({"min": "min", "max": "max",
                            "first_row": "first"}[name])
            slots.append(("plain", len(val_plan) - 1))
        elif name == "sum":
            val_plan.append((f, "raw"))
            agg_ops.append("sum_f" if is_float else "sum_i")
            slots.append(("plain", len(val_plan) - 1))
        else:  # avg
            val_plan.append((f, "raw"))
            agg_ops.append("sum_f" if is_float else "sum_i")
            j_sum = len(val_plan) - 1
            val_plan.append((f, "raw" if is_float else "int"))
            agg_ops.append("count")
            slots.append(("avg", j_sum, len(val_plan) - 1))
    return key_fns, key_meta, key_pack, val_plan, agg_ops, slots


def _assemble_agg(plan, key_meta, slots, dcols, out_host, ng):
    """Device agg outputs (already copied to host) → result Chunk."""
    from .agg_cache import note_agg_pass
    note_agg_pass()
    key_out, key_null_out, results, result_nulls = out_host
    out_cols = []
    for (e, dictionary), kd, kn in zip(key_meta, key_out, key_null_out):
        kd = np.asarray(kd[:ng])
        kn = np.asarray(kn[:ng])
        if dictionary is not None:
            data = np.where(kn, b"", dictionary[np.clip(kd, 0, len(dictionary) - 1)])
            out_cols.append(Column(e.ftype, data, kn))
        else:
            dt = np_dtype_for(e.ftype)
            out_cols.append(Column(e.ftype, kd.astype(dt), kn))
    if not plan.group_exprs:
        out_cols = []
    for desc, slot in zip(plan.aggs, slots):
        ft = desc.ftype
        if slot[0] == "avg":
            _tag, j_sum, j_cnt = slot
            s = np.asarray(results[j_sum][:ng])
            c = np.asarray(results[j_cnt][:ng])
            nulls = np.asarray(result_nulls[j_sum][:ng])
            if phys_kind(ft) == K_FLOAT:
                vals = s / np.maximum(c, 1)
                out_cols.append(Column(ft, vals, nulls))
            else:
                arg = desc.args[0]
                from .agg_cache import note_avg_partial
                note_avg_partial(s.astype(object), c)
                s_arg = arg.ftype.scale if phys_kind(arg.ftype) == K_DEC else 0
                shift = POW10[ft.scale - s_arg]
                num = s.astype(object) * shift
                den = np.maximum(c, 1).astype(object)
                sign = np.where(num < 0, -1, 1)
                q = (2 * np.abs(num) + den) // (2 * den)
                vals = np.array([int(x) for x in sign * q], dtype=np.int64)
                out_cols.append(Column(ft, vals, nulls))
            continue
        if slot[0] == "strcol":
            _tag, j, dictionary = slot  # decode dict captured at plan time
            codes = np.asarray(results[j][:ng])
            nulls = np.asarray(result_nulls[j][:ng])
            data = np.where(nulls, b"", dictionary[np.clip(codes, 0, len(dictionary) - 1)])
            out_cols.append(Column(ft, data, nulls))
            continue
        _tag, j = slot
        vals = np.asarray(results[j][:ng])
        nulls = np.asarray(result_nulls[j][:ng])
        if desc.name == "count":
            nulls = np.zeros(ng, dtype=bool)
        dt = np_dtype_for(ft)
        if dt is not object and vals.dtype != dt:
            vals = vals.astype(dt)
        out_cols.append(Column(ft, vals, nulls))
    if not out_cols:
        raise DeviceUnsupported("agg with no outputs")
    return Chunk(out_cols)


_DATE_PACK = (24, 1 << 22)  # MySQL DATE days: [-354285, 2932896] + margin

_EPOCH_DATE = np.datetime64("1970-01-01")


def _expr_bounds(e, dcols):
    """Host-known (min, max) of an integer-kinded group expression, from
    the cached column min/max (utils/chunk.py Column.minmax). Bare columns
    read it directly; YEAR(col) maps bounds through the monotone
    conversion. None when unknown — the caller falls back to the generic
    (multi-sort) agg path."""
    if dcols is None:
        return None
    from ..expression.core import ScalarFunc as _SF
    if isinstance(e, ExprColumn):
        dc = dcols.get(e.idx)
        if dc is None or dc.host_col is None or dc.dictionary is not None:
            return None
        return dc.host_col.minmax()
    if (isinstance(e, _SF) and e.op == "year"
            and isinstance(e.args[0], ExprColumn)
            and phys_kind(e.args[0].ftype) == K_DATE):
        b = _expr_bounds(e.args[0], dcols)
        if b is None:
            return None

        def to_year(days):
            return int(str((_EPOCH_DATE + np.timedelta64(days, "D")
                            ).astype("datetime64[Y]")))
        return to_year(b[0]), to_year(b[1])
    return None


def _key_pack(group_exprs, key_sizes, dcols=None):
    """Static (bits, offset) per group key when every key's value range is
    known a priori — dict codes (cardinality = key dictionary size, from
    _plan_agg), host column min/max for bare keys and YEAR() (cached on
    the Column, so the bound is exact per table version), and DATE days
    (bounded by MySQL's DATE domain) as the date fallback. Enables the
    single-argsort packed path in _agg_kernel. None when any key is
    unbounded or the total exceeds 62 bits."""
    pack = []
    total = 0
    for e, size in zip(group_exprs, key_sizes):
        k = phys_kind(e.ftype)
        if k == K_STR and size is not None:
            bits = max(int(size + 1).bit_length(), 1)
            pack.append((bits, 0))
        else:
            b = _expr_bounds(e, dcols)
            if b is not None:
                mn, mx = b
                span = mx - mn + 1
                pack.append((max((span + 1).bit_length(), 1), -mn))
            elif k == K_DATE:
                pack.append(_DATE_PACK)
            else:
                return None
        total += pack[-1][0]
    if total > 62:
        return None
    return tuple(pack)


def _estimate_groups(plan, n, ctx=None):
    """Group-count bound for the agg kernel's static capacity: product of
    the group columns' ANALYZE NDVs (reference: statistics-driven agg
    cardinality, planner/core/stats.go), falling back to 64 per key, both
    capped at the input size. With a multi-key GROUP BY the NDV product
    overshoots the true joint cardinality, but overshoot only pads the
    sort — undershoot costs a recompile."""
    if not plan.group_exprs:
        return 1
    from ..planner.optimizer import _expr_ndv
    est = 1
    for e in plan.group_exprs:
        nd = None
        if ctx is not None:
            try:
                nd = _expr_ndv(plan.child, e, ctx, n)
            except Exception:
                nd = None
        est *= int(nd * 2) if nd else 64
    return min(est, n)


_MERGE_OPS = {"count": "sum_i", "sum_i": "sum_i", "sum_f": "sum_f",
              "min": "min", "max": "max", "first": "first"}


def device_agg_streaming(plan, chunk: Chunk, conds, batch_rows: int,
                         ctx=None, allow_single=False) -> Chunk:
    """Streamed fused filter+group+aggregate: the input is cut into
    `batch_rows` blocks; each block's columns go to the device through
    the page stager (ops/stream.py: pinned ring, side copy stream) and
    run the SAME pipeline (K2 + K1) while the next block's copy is
    queued (reference: the cop-iterator worker overlap,
    store/copr/coprocessor.go:399); per-block partial states stay on the
    device and fold through the partial-state merge (K8,
    ops/kernels/merge_states.py) every `_MERGE_BUDGET_ROWS // capacity`
    blocks; one fetch of the final state finishes the query.

    Device memory is bounded by 2 staged blocks + the buffered partials +
    the running state instead of the full table — the long-operand
    scaling path (SURVEY §5)."""
    n = chunk.num_rows
    if n == 0:
        raise DeviceUnsupported("empty input")
    if batch_rows <= 0 or (n <= batch_rows and not allow_single):
        # whole-input kernel is cheaper — except for paged inputs, whose
        # memmap slices must flow through here regardless of block count
        raise DeviceUnsupported("input fits one batch")
    used = _agg_used_columns(plan, conds)
    if not used:
        raise DeviceUnsupported("no columns")

    # full-column dictionaries (cached on the parent Column): batch slices
    # share codes, so group keys agree across blocks
    col_arrays = {}
    dcols = {}
    for idx in used:
        dcols[idx], col_arrays[idx] = dev.meta_device_col(chunk.columns[idx])

    cond_fns = [dev.compile_expr(c, dcols) for c in conds]
    (key_fns, key_meta, key_pack, val_plan, agg_ops,
     slots) = _plan_agg(plan, dcols)
    n_keys = max(len(key_fns), 1)
    if tuple(agg_ops) == ("cnt_dist",):
        # COUNT(DISTINCT x) streams through pair dedup: each block
        # deduplicates (group, x) PAIRS (an agg whose keys are
        # group+value), and the final cnt_dist over the concatenated
        # pair rows is exact even with cross-block duplicates (reference:
        # the two-phase distinct agg, executor/aggregate.go partial
        # dedup + final count)
        return _stream_count_distinct(plan, conds, chunk, col_arrays,
                                      dcols, cond_fns, key_fns, key_meta,
                                      key_pack, val_plan, slots,
                                      batch_rows, ctx)
    if any(op not in _MERGE_OPS for op in agg_ops):
        # other distinct/non-mergeable partial states can't merge across
        # blocks; the whole-input kernel handles them
        raise DeviceUnsupported("non-mergeable agg in streamed pipeline")
    merge_ops = tuple(_MERGE_OPS[op] for op in agg_ops)
    sig_exprs, dict_refs = _agg_sig(plan, conds, dcols)

    est = _estimate_groups(plan, n, ctx)
    capacity = dev.next_pow2(min(batch_rows, max(est, 16)))
    merge_cap = capacity  # grows to the true total on merge overflow
    stats = StreamStats("stream")
    stager = stream.PageStager(col_arrays, batch_rows, dev.device())
    try:
        for _attempt in range(8):
            key = (sig_exprs, "stream", capacity, key_pack, tuple(agg_ops))
            cap = capacity

            def build(cap=cap):
                return _build_pipeline(cond_fns, key_fns, n_keys, val_plan,
                                       tuple(agg_ops), cap, key_pack)
            fn = acquire_pipeline(key, build, dict_refs, ctx=ctx,
                                  shape="agg", sig=sig_exprs, ladder=False)
            k_flush = max(1, _MERGE_BUDGET_ROWS // capacity)
            state = None
            buffered = []
            max_ng = 0
            overflow = False
            for lo in range(0, n, batch_rows):
                hi = min(lo + batch_rows, n)
                # every block — the tail included — pads to the SAME
                # batch_rows shape (live rows masked by n_live), so one
                # pipeline serves the whole stream at any input size
                env, slot = stager.stage(lo, hi)
                buffered.append(stats.dispatch(fn, env, hi - lo))
                stager.release(slot)
                if len(buffered) >= k_flush:
                    # incremental fold: the device holds at most k_flush
                    # partials + the running state, never all
                    # n / batch_rows of them
                    max_ng = max(max_ng, *stats.read_groups(buffered))
                    if max_ng > capacity:
                        overflow = True
                        break
                    state, merge_cap = stats.merge(
                        state, buffered, merge_cap, n_keys, len(val_plan),
                        merge_ops, key_pack)
                    buffered = []
            if not overflow and buffered:
                max_ng = max(max_ng, *stats.read_groups(buffered))
                if max_ng <= capacity:
                    state, merge_cap = stats.merge(
                        state, buffered, merge_cap, n_keys, len(val_plan),
                        merge_ops, key_pack)
                    buffered = []
            if overflow or max_ng > capacity:
                capacity = dev.next_pow2(max_ng)
                continue
            break
        else:
            raise DeviceUnsupported("streamed agg capacity did not converge")
    finally:
        stats.take(stager)
    if state is None:
        raise DeviceUnsupported("empty streamed input")
    t0 = _time.perf_counter()
    key_out, key_null_out, results, result_nulls, n_groups = _fetch(
        tuple(state[:5]))
    ng = int(n_groups)
    if ng == 0 and not plan.group_exprs:
        raise DeviceUnsupported("empty global aggregate")
    out = _assemble_agg(plan, key_meta, slots, dcols,
                        (key_out, key_null_out, results, result_nulls), ng)
    stats.finish(t0, capacity, ng)
    return out


class StreamStats:
    """Stage timings of one streamed or paged run, published to the
    thread's ``device_join.LAST_PAGED_STATS`` (EXPLAIN ANALYZE, and the
    supervisor carries it across its worker thread): the stager's pages,
    bytes, slice_s (host slicing into the pinned ring) and h2d_s (device
    copy time), dispatch_s (queuing each page's kernels), sync_s (the
    host reads of the buffered partials' group counts — `syncs` of
    them), merge_s (partial-state folds, `merges` of them), fetch_s
    (final fetch + host assembly), capacity and groups."""

    def __init__(self, kind):
        self.s = {"kind": kind, "pages": 0, "h2d_bytes": 0, "slice_s": 0.0,
                  "h2d_s": 0.0, "dispatch_s": 0.0, "sync_s": 0.0,
                  "syncs": 0, "merge_s": 0.0, "merges": 0}

    def dispatch(self, fn, *args):
        t0 = _time.perf_counter()
        out = fn(*args)
        self.s["dispatch_s"] += _time.perf_counter() - t0
        return out

    def read_groups(self, buffered):
        """The buffered partials' group counts, in one device → host
        copy (the reference's device_get at each flush)."""
        t0 = _time.perf_counter()
        ngs = torch.stack([p[4].reshape(()) for p in buffered]).tolist()
        self.s["sync_s"] += _time.perf_counter() - t0
        self.s["syncs"] += 1
        return ngs

    def merge(self, state, parts, merge_cap, n_keys, nvals, merge_ops,
              key_pack):
        t0 = _time.perf_counter()
        out = merge_partial_states(state, parts, merge_cap, n_keys, nvals,
                                   merge_ops, key_pack)
        self.s["merge_s"] += _time.perf_counter() - t0
        self.s["merges"] += 1
        return out

    def take(self, stager):
        st = stager.close()
        self.s["pages"] = st["pages"]
        self.s["h2d_bytes"] = st["h2d_bytes"]
        self.s["slice_s"] = st["slice_s"]
        self.s["h2d_s"] = st["h2d_s"]

    def finish(self, t0, capacity, groups):
        from .device_join import LAST_PAGED_STATS
        self.s["fetch_s"] = _time.perf_counter() - t0
        self.s["capacity"] = capacity
        self.s["groups"] = groups
        LAST_PAGED_STATS.clear()
        LAST_PAGED_STATS.update(self.s)


#: partial-aggregate rows buffered on device before a merge flush (shared
#: by the streamed scan-agg and the paged probe join)
_MERGE_BUDGET_ROWS = 1 << 25


def _stream_count_distinct(plan, conds, chunk, col_arrays, dcols, cond_fns,
                           key_fns, key_meta, key_pack, val_plan, slots,
                           batch_rows, ctx):
    """Streamed COUNT(DISTINCT x): per-block dedup of (group, x) pairs
    (K2 + K1 `first`), then one K1 cnt_dist over the concatenated live
    pair rows."""
    n = chunk.num_rows
    val_fn = val_plan[0][0]
    # block program: group keys + value as ONE key set, dedup via 'first'
    pair_fns = list(key_fns) + [val_fn]
    n_pair_keys = len(pair_fns)
    est = _estimate_groups(plan, n, ctx)
    # distinct pairs per block bounded by the block; estimate via group
    # est * a small per-group distinct factor, discovered on overflow
    capacity = dev.next_pow2(min(batch_rows, max(est * 4, 64)))
    n_blocks = (n + batch_rows - 1) // batch_rows
    sig_exprs, dict_refs = _agg_sig(plan, conds, dcols)
    stats = StreamStats("stream")
    stager = stream.PageStager(col_arrays, batch_rows, dev.device())
    try:
        for _attempt in range(8):
            if n_blocks * capacity > 4 * _MERGE_BUDGET_ROWS:
                # unlike the mergeable path this buffers EVERY block's pair
                # state — past the budget, degrade to the fallback instead
                # of exhausting device memory
                raise DeviceUnsupported(
                    "distinct pair state exceeds the stream budget")
            key = (sig_exprs, "cntd", capacity)

            def build(cap=capacity):
                return _build_pipeline(cond_fns, pair_fns, n_pair_keys,
                                       [(val_fn, "int")], ("first",), cap,
                                       None)
            fn = acquire_pipeline(key, build, dict_refs, ctx=ctx,
                                  shape="agg", sig=sig_exprs, ladder=False)
            partials = []
            for lo in range(0, n, batch_rows):
                hi = min(lo + batch_rows, n)
                env, slot = stager.stage(lo, hi)
                partials.append(stats.dispatch(fn, env, hi - lo))
                stager.release(slot)
            counts = stats.read_groups(partials)
            if max(counts) <= capacity:
                break
            capacity = dev.next_pow2(max(counts))
        else:
            raise DeviceUnsupported("distinct pair capacity did not converge")
    finally:
        stats.take(stager)

    t0 = _time.perf_counter()
    n_keys = max(len(key_fns), 1)
    d = partials[0][4].device
    # concatenated pair rows: group keys back apart from the value key
    if key_fns:
        key_cat = tuple(torch.cat([p[0][k] for p in partials])
                        for k in range(n_keys))
        key_null_cat = tuple(torch.cat([p[1][k] for p in partials])
                             for k in range(n_keys))
    else:
        # global COUNT(DISTINCT): one group — constant key, NOT the value
        tot = sum(int(p[0][0].shape[0]) for p in partials)
        key_cat = (torch.zeros(tot, dtype=torch.int64, device=d),)
        key_null_cat = (torch.zeros(tot, dtype=torch.bool, device=d),)
    val_cat = (torch.cat([p[0][n_pair_keys - 1] for p in partials]),)
    val_null_cat = (torch.cat([p[1][n_pair_keys - 1] for p in partials]),)
    mask = torch.cat([torch.arange(capacity, device=d) < p[4]
                      for p in partials])
    total = int(mask.shape[0])
    final_cap = dev.next_pow2(max(est, 16))
    while True:
        out = dev._agg_impl(
            key_cat, key_null_cat, val_cat, val_null_cat, mask,
            n_keys=n_keys, agg_ops=("cnt_dist",),
            capacity=min(final_cap, dev.next_pow2(total)), pack=key_pack)
        key_out, key_null_out, results, result_nulls, n_groups = _fetch(
            tuple(out[:5]))
        ng = int(n_groups)
        if ng <= final_cap:
            break
        final_cap = dev.next_pow2(ng)
    if ng == 0 and not plan.group_exprs:
        raise DeviceUnsupported("empty global aggregate")
    res = _assemble_agg(plan, key_meta, slots, dcols,
                        (key_out, key_null_out, results, result_nulls), ng)
    stats.finish(t0, capacity, ng)
    return res


def merge_partial_states(state, parts, merge_cap, n_keys, nvals, merge_ops,
                         key_pack):
    """Fold buffered partial-agg states (+ the running state) into ONE
    merged state of `merge_cap` output slots through the partial-state
    merge (ops/kernels/merge_states.py); grows merge_cap on overflow
    (inputs stay alive, so the retry is exact). Returns (state,
    merge_cap) — state is an _agg_impl output tuple whose [4] is the live
    group count.  The reference's numpy fold for its XLA-CPU backend is
    not carried over: the CPU runs the merge's plain version.  Raises
    merge_states.FoldOrderError where a part was out of the fold's
    order."""
    alls = ([state] if state is not None else []) + list(parts)
    while True:
        out = merge_states.merge(alls, n_keys, merge_ops, merge_cap,
                                 key_pack)
        ng = merge_states.read_groups(out)
        if ng <= merge_cap:
            return out, merge_cap
        merge_cap = dev.next_pow2(ng)


def page_singleton_state(key_cols, key_nulls, val_cols, val_nulls, mask,
                         agg_ops):
    """Host rows (numpy) viewed as a partial-agg state of SINGLETON
    groups, mergeable by _merge_states_host: a count op's singleton value
    is its 0/1 pre-count (its merge op is sum_i, and a count result is 0,
    never NULL); every other op's singleton value is the row's own value
    + null flag.  Only the hybrid hash join's host half uses it
    (executor/hybrid_join.py), on its co-processing worker."""
    vals, vnulls = [], []
    for j, op in enumerate(agg_ops):
        v = np.asarray(val_cols[j])
        vn = np.asarray(val_nulls[j])
        if op == "count":
            vals.append((~vn).astype(np.int64))
            vnulls.append(np.zeros(vn.shape[0], dtype=bool))
        else:
            vals.append(v)
            vnulls.append(vn)
    m = np.asarray(mask)
    return (tuple(np.asarray(k) for k in key_cols),
            tuple(np.asarray(kn) for kn in key_nulls),
            tuple(vals), tuple(vnulls),
            int(np.count_nonzero(m)), m)


def _merge_states_host(alls, merge_cap, n_keys, nvals, merge_ops, key_pack):
    """numpy fold of host partial-agg states — the hybrid hash join's
    host half folds its spilled partitions with it on the co-processing
    worker, which must not touch the card.  Packs the key tuple EXACTLY
    like K1 (null -> slot 0, value+offset+1), stable argsort so the
    first-occurrence row of every group is the earliest partial's
    representative (K1's 'first'), then reduceat per aggregate.  Output
    mirrors a K1 state with numpy arrays: (keys, key_nulls, results,
    result_nulls, n_groups, valid); the caller uploads it for the final
    fold (merge_partial_states)."""
    keys = [np.concatenate([np.asarray(p[0][k]) for p in alls])
            for k in range(n_keys)]
    knulls = [np.concatenate([np.asarray(p[1][k]) for p in alls])
              for k in range(n_keys)]
    vals = [np.concatenate([np.asarray(p[2][j]) for p in alls])
            for j in range(nvals)]
    vnulls = [np.concatenate([np.asarray(p[3][j]) for p in alls])
              for j in range(nvals)]
    # p[5] is each state's validity mask: arange<ng for compact states, an
    # arbitrary row mask for raw singleton pages
    live = np.concatenate([np.asarray(p[5]) for p in alls])
    packed = np.zeros(live.shape[0], dtype=np.int64)
    for (bits, offset), k, kn in zip(key_pack, keys, knulls):
        shifted = k.astype(np.int64) + np.int64(offset + 1)
        packed = (packed << np.int64(bits)) | np.where(kn, 0, shifted)
    idx = np.nonzero(live)[0]
    order = np.argsort(packed[idx], kind="stable")
    sidx = idx[order]
    sk = packed[idx][order]
    m = sk.shape[0]
    new = np.empty(m, dtype=bool)
    if m:
        new[0] = True
        np.not_equal(sk[1:], sk[:-1], out=new[1:])
    bounds = np.nonzero(new)[0]
    ng = int(bounds.shape[0])
    cap = merge_cap
    while ng > cap:
        cap *= 2
    rep = sidx[bounds]

    def pad(a):
        out = np.zeros(cap, dtype=a.dtype)
        out[:ng] = a
        return out

    key_out = tuple(pad(k[rep]) for k in keys)
    key_null_out = tuple(pad(kn[rep]) for kn in knulls)
    results = []
    result_nulls = []
    for j, opn in enumerate(merge_ops):
        v = vals[j]
        vn = vnulls[j]
        if opn == "first":
            results.append(pad(v[rep]))
            result_nulls.append(pad(vn[rep]))
            continue
        svn = vn[sidx]
        nonnull = np.add.reduceat(
            (~svn).astype(np.int64), bounds) if ng else np.zeros(
                0, dtype=np.int64)
        if opn == "sum_i":
            sv = np.where(vn, 0, v.astype(np.int64))[sidx]
            seg = (np.add.reduceat(sv, bounds) if ng
                   else np.zeros(0, dtype=np.int64))
        elif opn == "sum_f":
            sv = np.where(vn, 0.0, v.astype(np.float64))[sidx]
            seg = (np.add.reduceat(sv, bounds) if ng
                   else np.zeros(0, dtype=np.float64))
        elif opn in ("min", "max"):
            if np.issubdtype(v.dtype, np.floating):
                sent = np.inf if opn == "min" else -np.inf
            else:
                ii = np.iinfo(v.dtype)
                sent = ii.max if opn == "min" else ii.min
            sv = np.where(vn, sent, v)[sidx]
            red = np.minimum if opn == "min" else np.maximum
            seg = (red.reduceat(sv, bounds) if ng
                   else np.zeros(0, dtype=v.dtype))
        else:
            raise ValueError(opn)
        results.append(pad(seg))
        result_nulls.append(pad(nonnull == 0) if ng
                            else np.zeros(cap, bool))
    valid = np.arange(cap) < ng
    return (key_out, key_null_out, tuple(results), tuple(result_nulls),
            ng, valid), cap


#: window functions the device kernel computes (reference:
#: executor/window.go; unistore runs window fragments storage-side)
_WIN_RANKS = {"row_number", "rank", "dense_rank", "percent_rank",
              "cume_dist"}
_WIN_AGGS = {"sum", "count", "avg", "min", "max"}

#: host seconds of the last device window: ``window_s`` (the whole call:
#: uploads, planning, kernels, fetch and assembly), ``dispatch_s`` (K2,
#: K4 and K10 enqueued), ``fetch_s`` (the one device → host copy, which
#: waits for the kernels), ``assemble_s`` (host assembly), with ``n`` and
#: ``nb``
LAST_WINDOW_STATS: dict = {}


def device_window(p, chunk: Chunk, ctx=None) -> Chunk:
    """Window functions as one device program: K2 evaluates the partition
    keys, order keys and arguments in one expression-VM pass, K4 sorts
    the rows (live first, then partition, then order keys, stable), K10
    computes every function with segmented scans and scatters them back
    to input order — no per-partition host loop (the host path iterates
    partitions in Python; reference executor/window.go processes them
    serially too).  Default frames only: with ORDER BY, RANGE UNBOUNDED
    PRECEDING..CURRENT ROW (peer-aware); without, the whole partition.
    Raises DeviceUnsupported outside that language (ntile/lead/lag,
    explicit frames, distinct args) and past K4's key limit — the host
    executor covers the rest."""
    t_call = _time.perf_counter()
    n = chunk.num_rows
    if n == 0:
        raise DeviceUnsupported("empty window input")
    for f in p.funcs:
        if f.frame is not None:
            raise DeviceUnsupported("explicit window frame")
        if f.name in _WIN_RANKS:
            continue
        if f.name not in _WIN_AGGS or len(f.args) != 1:
            raise DeviceUnsupported(f"window func {f.name}")
        if phys_kind(f.args[0].ftype) == K_STR and f.name not in ("count",):
            raise DeviceUnsupported("string window aggregate")
    n_keys = len(p.partition_exprs) + len(p.order_by)
    if n_keys > sort_topk.MAX_KEYS:
        raise DeviceUnsupported(f"{n_keys} window keys (the device sorts "
                                f"at most {sort_topk.MAX_KEYS})")

    used = set()
    for e in p.partition_exprs:
        e.columns_used(used)
    for e, _d in p.order_by:
        e.columns_used(used)
    for f in p.funcs:
        for a in f.args:
            a.columns_used(used)
    # bucketed upload: padding rows sort behind every live row (validity is
    # the most-major sort key) and form their own trailing partition, so no
    # rank/aggregate of a real partition ever sees them
    nb = dev.bucket_rows(n, dev.shape_buckets(ctx))
    dcols = {}
    env = {}
    for idx_ in used:
        dc = dev.to_device_col(chunk.columns[idx_], bucket=nb)
        dcols[idx_] = dc
        env[idx_] = (dc.data, dc.nulls)

    part_fns = [dev.compile_expr(e, dcols) for e in p.partition_exprs]
    order_fns = [(dev.compile_expr(e, dcols), d) for e, d in p.order_by]
    agg_fns = [dev.compile_expr(f.args[0], dcols)
               if f.name in _WIN_AGGS else None for f in p.funcs]
    has_order = bool(p.order_by)
    names = tuple(f.name for f in p.funcs)
    kinds = tuple(phys_kind(f.args[0].ftype) if f.name in _WIN_AGGS else None
                  for f in p.funcs)

    def build():
        t0 = _time.perf_counter()
        # one VM program for every key and argument; an argument computes
        # in its result's kind (float sums scan as doubles)
        vals = [(node, "raw") for node in part_fns]
        vals += [(node, "raw") for node, _d in order_fns]
        funcs, arg_nodes = [], []
        for name, node, k in zip(names, agg_fns, kinds):
            if node is None:
                funcs.append((name, None))
                continue
            node = expr_vm.to_f(node) if k == K_FLOAT else expr_vm.to_i(node)
            a = len(arg_nodes)
            arg_nodes.append(node)
            if name == "avg":  # host assembly divides sum by count
                funcs += [("sum", a), ("count", a)]
            else:
                funcs.append((name, a))
        vals += [(node, "raw") for node in arg_nodes]
        prog = expr_vm.Program.build([], [], vals)
        np_, no = len(part_fns), len(order_fns)
        descs = [False] * np_ + [bool(d) for _f, d in order_fns]

        def run(env, n_live):
            d = (next(iter(env.values()))[0].device if env
                 else dev.device())
            cols = []
            if prog.val_slots:
                _mask, outs = expr_vm.run(
                    prog, [env[c] for c in prog.in_cols], nb, n_live, d)
                cols = [outs[s] for s in prog.val_slots]
            keys = cols[:np_ + no]
            idx = None
            if keys:
                idx = sort_topk.window_order(
                    [k[0] for k in keys], [k[1] for k in keys], descs, nb,
                    n_live)
            return window_scan.run(nb, n_live, idx, keys[:np_],
                                   keys[np_:], cols[np_ + no:], funcs, d)

        return _timed_jit(run, t0)

    # dictionary CONTENT is the load-bearing key component: compiled
    # str-expr LUTs bake the dictionary's codes, exactly like the agg
    # pipeline cache (_agg_sig / _pipe_cache_put); the shape key is the
    # BUCKET, so a within-bucket delta re-dispatches the compiled program
    dict_refs = tuple(dc.dictionary for dc in dcols.values()
                      if dc.dictionary is not None)
    sig = (nb, names, kinds, has_order,
           tuple(_expr_sig(e) for e in p.partition_exprs),
           tuple((_expr_sig(e), d) for e, d in p.order_by),
           tuple(_expr_sig(f.args[0]) if f.name in _WIN_AGGS else None
                 for f in p.funcs),
           tuple(f"{idx_}:{_dc_sig(dc)}" for idx_, dc in sorted(dcols.items())
                 if dc.dictionary is not None))
    fn = acquire_pipeline(("win",) + sig, build, dict_refs, ctx=ctx,
                          args=(env, n), shape="window", sig=sig)
    t0 = _time.perf_counter()
    res = fn(env, n)
    t1 = _time.perf_counter()
    # outputs are padded to the bucket; positions past the live rows belong
    # to the trailing padding partition — slice them away
    outs = _fetch(tuple((d[:n], nl[:n]) for d, nl in res))
    t2 = _time.perf_counter()
    out_cols = list(chunk.columns)
    oi = 0
    for f in p.funcs:
        ft = f.ftype
        if f.name == "avg":
            s = np.asarray(outs[oi][0])
            s_null = np.asarray(outs[oi][1])
            c = np.asarray(outs[oi + 1][0])
            oi += 2
            arg = f.args[0]
            if phys_kind(ft) == K_FLOAT:
                vals = s / np.maximum(c, 1)
                if phys_kind(arg.ftype) == K_DEC:
                    # decimal args evaluate as scaled ints — unscale for
                    # the double-typed window AVG
                    vals = vals / POW10[arg.ftype.scale]
                out_cols.append(Column(ft, vals, s_null))
            else:
                s_arg = (arg.ftype.scale
                         if phys_kind(arg.ftype) == K_DEC else 0)
                shift = POW10[ft.scale - s_arg]
                num = s.astype(object) * shift
                den = np.maximum(c, 1).astype(object)
                sign = np.where(num < 0, -1, 1)
                q = (2 * np.abs(num) + den) // (2 * den)
                vals = np.array([int(x) for x in sign * q], dtype=np.int64)
                out_cols.append(Column(ft, vals, s_null))
            continue
        vals, nulls = outs[oi]
        oi += 1
        vals = np.asarray(vals)
        nulls = np.asarray(nulls)
        dt = np_dtype_for(ft)
        if dt is not object and vals.dtype != dt:
            vals = vals.astype(dt)
        out_cols.append(Column(ft, vals, nulls))
    t3 = _time.perf_counter()
    LAST_WINDOW_STATS.clear()
    LAST_WINDOW_STATS.update(n=n, nb=nb, window_s=t3 - t_call,
                             dispatch_s=t1 - t0, fetch_s=t2 - t1,
                             assemble_s=t3 - t2)
    return Chunk(out_cols)


def device_join_keys(lkeys, rkeys):
    """Combine multi-column join keys into single int64 codes host-side
    (shared factorization), then match on device. Returns (li, ri).

    Single raw-int64 keys skip the factorization pass entirely — the
    device matcher is sort-based and handles arbitrary int64 values
    (null rows are masked by the kernel / the keep filter)."""
    if (len(lkeys) == 1 and lkeys[0][0].dtype == np.int64
            and rkeys[0][0].dtype == np.int64):
        (pd, pn), = lkeys
        (bd, bn), = rkeys
        return dev.device_join_match((bd, bn), (pd, pn))
    nb = len(rkeys[0][0])
    npr = len(lkeys[0][0])
    from ..ops import host as hops
    acc_b = np.zeros(nb, dtype=np.int64)
    acc_p = np.zeros(npr, dtype=np.int64)
    b_null = np.zeros(nb, dtype=bool)
    p_null = np.zeros(npr, dtype=bool)
    for (pd, pn), (bd, bn) in zip(lkeys, rkeys):
        both = np.concatenate([bd, pd])
        codes, card = hops.factorize_column(both, np.concatenate([bn, pn]))
        acc_b = acc_b * np.int64(card + 1) + (codes[:nb] + 1)
        acc_p = acc_p * np.int64(card + 1) + (codes[nb:] + 1)
        b_null |= bn
        p_null |= pn
    return dev.device_join_match((acc_b, b_null), (acc_p, p_null))
