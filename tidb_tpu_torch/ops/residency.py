"""Device-memory residency manager: CUDA memory as a tracked, evictable,
epoch-scoped resource (the reference's HBM ledger, ported as is apart
from the auto budget, which reads ``torch.cuda.mem_get_info``).

Why this exists: the host side has a full
memory-quota tree (`utils/memory.py MemTracker` with spill actions and
`tidb_mem_oom_action`), but device memory had NOTHING — `Column._device`
uploads accumulated in HBM unaccounted and were never epoch-invalidated
after a backend fence, and an HBM ``RESOURCE_EXHAUSTED`` was merely
classified and charged to the circuit breaker with no eviction or retry.
The memory-adaptive-operator lesson of "Design Trade-offs for a Robust
Dynamic Hybrid Hash Join" (PAPERS.md) applies verbatim: an operator that
degrades gracefully under memory pressure beats one that dies.

Three jobs, one lock:

1. **Accounting + budget** — every cached device upload
   (`ops/device.to_device_col`) registers its byte size here.  The budget
   is the ``tidb_device_mem_budget`` sysvar (bytes; 0 = auto: the CUDA
   device's total memory, unlimited when the engine runs on the CPU).  Crossing the budget evicts cold entries LRU-first —
   clearing the owning ``Column._device`` slot so the arrays (and their
   HBM buffers) become collectible.  The newest entry is never evicted
   for its own arrival: a single working column larger than the budget
   must still be usable (one-pass semantics beat a livelock).

2. **Device epoch** — a monotonically increasing counter bumped by every
   backend quarantine (`executor/supervisor.fence` / the hang-abandon
   path).  Every cached value is stamped with the epoch it was uploaded
   under and checked on read, so a restarted PJRT client can never serve
   a stale pre-fence buffer (the ROADMAP "device-epoch on Column caches"
   open item).  `executor/device_join._leaf_env` stamps its ``leaf.dcols``
   caches with the same epoch; their byte accounting rides on the
   underlying Column entries (the leaf dict holds views/slices of them).

3. **OOM recovery** — `recover_oom()` is step one of the ladder
   ``evict-all → single retry → host degradation`` that
   `executor/device_exec.run_device` walks when a classified device OOM
   (`utils/backoff.is_device_oom`) surfaces: drop every cached device
   value (freeing the HBM they pin), retry the fragment once against the
   emptied device, and only then let the existing per-shape circuit
   breaker degrade to the host engine.

**Tenancy**: every entry is charged to the resource group of
the session that uploaded it (``tidb_resource_group``, bridged onto
supervisor worker threads), and ``tidb_device_mem_budget`` is enforced
as per-group SHARES under pressure: a tenant over its share evicts its
OWN cold entries before touching another tenant's (see
`_enforce_budget_locked`), so one tenant's upload storm cannot flush a
well-behaved neighbor's working set.

All ``._device`` reads/writes live in THIS module (AST-linted in
tests/test_residency.py) so HBM caching can never silently escape the
ledger.  Gauges — ``hbm_bytes_cached``, ``hbm_evictions``,
``hbm_oom_recoveries`` — surface in EXPLAIN ANALYZE, observe gauges, the
HTTP ``/status`` + ``/metrics`` endpoints, and bench.py lines.
"""

from __future__ import annotations

import collections
import itertools
import logging
import threading
import weakref

log = logging.getLogger("tidb_tpu_torch.residency")

#: one reentrant lock guards the ledger, the LRU order and the epoch —
#: reentrant because a weakref GC callback can fire while this module
#: already holds the lock on the same thread
_LOCK = threading.RLock()

#: the device epoch: bumped on every backend quarantine/fence.  Cached
#: device values are stamped with it and checked on read.
_EPOCH = [0]

#: resident bytes ledger (sum of every live entry's nbytes)
_BYTES = [0]

#: per-tenant slice of the ledger: resource group -> resident bytes.
#: Each entry is charged to the group that uploaded it (the session's
#: ``tidb_resource_group``, bridged per-dispatch via attach()), so the
#: budget can be enforced as per-group SHARES: a tenant over its share
#: evicts its OWN cold entries before touching another tenant's.
_GROUP_BYTES: "collections.Counter" = collections.Counter()

DEFAULT_GROUP = "default"

#: the uploading thread's resource group (set by attach() before each
#: dispatch; worker threads inherit "default" when nothing attached)
_TLS = threading.local()

#: configured budget in bytes (from tidb_device_mem_budget); 0 = auto
_BUDGET = [0]
#: memoized auto-derived budget (None = not yet probed)
_AUTO_BUDGET = [None]

_SEQ = itertools.count(1)

#: LRU of live cached uploads: token -> _Entry (insertion order = age;
#: move_to_end on every cache hit)
_ENTRIES: "collections.OrderedDict[int, _Entry]" = collections.OrderedDict()

STATS = {
    "uploads": 0,          # publishes that installed a new cached value
    "hits": 0,             # lookups served from cache
    "hbm_evictions": 0,    # entries evicted (budget, grow, epoch, OOM)
    "hbm_evicted_bytes": 0,
    "hbm_oom_recoveries": 0,  # evict-all passes taken for a device OOM
    "epoch_bumps": 0,
    "publish_races": 0,    # racing publish lost to an existing entry
    "gc_releases": 0,      # owners collected with their entry still live
}

#: Observability sinks (session/observe.py) mirroring the gauges —
#: registered from the contexts device dispatches run under
_SINKS: "weakref.WeakSet" = weakref.WeakSet()

#: the serving fabric's fleet hook (tidb_tpu/fabric/state.py installs a
#: _ResidencyFleet at worker boot): per-group byte DELTAS publish to the
#: coordination segment, and a group's share consumption reads
#: fleet-wide — a tenant filling worker A's HBM share is over-share on
#: worker B too, so its uploads there self-evict first instead of
#: squeezing B's light tenants.  None (all paths local) outside a fleet.
#: Lock order: the segment's flock nests inside the ledger _LOCK.
_FLEET = [None]


def set_fleet(hook):
    """Install (or clear, with None) the fleet residency hook."""
    with _LOCK:
        _FLEET[0] = hook


def _fleet_charge_locked(group: str, delta: int):
    fleet = _FLEET[0]
    if fleet is not None:
        try:
            fleet.charge(group, delta)
        except Exception as e:  # noqa: BLE001 — segment mirror only
            log.warning("fleet HBM charge failed for %r (%+d bytes; "
                        "local ledger stays exact): %s", group, delta, e)


def _fleet_remote_bytes(group: str) -> int:
    fleet = _FLEET[0]
    if fleet is None:
        return 0
    try:
        return fleet.remote_bytes(group)
    except Exception as e:  # noqa: BLE001 — degrade to local shares
        log.warning("fleet HBM read failed for %r (local share only): %s",
                    group, e)
        return 0


class _Resident:
    """The value stored on ``Column._device``: the padded device arrays
    plus the stamps the manager checks on every read."""

    __slots__ = ("data", "nulls", "rows", "epoch", "nbytes", "token")

    def __init__(self, data, nulls, rows, epoch, nbytes, token):
        self.data = data
        self.nulls = nulls
        self.rows = rows
        self.epoch = epoch
        self.nbytes = nbytes
        self.token = token


class _Entry:
    """Ledger entry for one cached upload: a weakref back to the owning
    Column (to clear its slot on eviction, and to release the bytes when
    the owner is garbage-collected) plus the byte charge and the resource
    group it is charged to."""

    __slots__ = ("ref", "nbytes", "token", "group")

    def __init__(self, ref, nbytes, token, group=DEFAULT_GROUP):
        self.ref = ref
        self.nbytes = nbytes
        self.token = token
        self.group = group


class CacheOwner:
    """Weakref-able owner object for cached device values whose natural
    owner is NOT a utils.chunk.Column — e.g. the MPP mesh placement cache
    (executor/mpp_exec.py), whose values are mesh-sharded global arrays.
    Holding the managed ``_device`` slot HERE keeps every HBM cache
    inside this module's lint boundary: lookup()/publish() work on a
    CacheOwner exactly as on a Column, so placement entries are
    byte-accounted, LRU-evictable, epoch-stamped and part of the OOM
    evict-all ladder like any other upload."""

    __slots__ = ("_device", "__weakref__")

    def __init__(self):
        self._device = None


def _nbytes(arr) -> int:
    try:
        return int(arr.nbytes)
    except Exception:
        try:
            return int(arr.size) * int(arr.dtype.itemsize)
        except Exception:
            return 0


# -- epoch -------------------------------------------------------------------

def device_epoch() -> int:
    """The current device epoch.  Caches stamped with an older epoch are
    stale (their buffers may belong to a torn-down PJRT client)."""
    return _EPOCH[0]


def bump_epoch(reason: str = "") -> int:
    """Invalidate every cached device value: bump the epoch and clear the
    ledger.  Called by the supervisor on every backend quarantine
    (fence / hang-abandon) BEFORE the reinit, so nothing uploaded against
    the suspect client can survive into the re-dialed one."""
    with _LOCK:
        _EPOCH[0] += 1
        epoch = _EPOCH[0]
        STATS["epoch_bumps"] += 1
        n = _evict_all_locked()
    if n:
        log.info("device epoch -> %d (%s): %d cached uploads invalidated",
                 epoch, reason or "fence", n)
    _publish_gauges()
    return epoch


# -- budget ------------------------------------------------------------------

def attach(ctx):
    """Per-dispatch hookup (called by run_device): resolve the budget
    from ``tidb_device_mem_budget`` and register the Domain's observe
    registry as a gauge sink.

    The budget is read from the Domain's GLOBAL variables (`SET GLOBAL
    tidb_device_mem_budget`), same discipline as the circuit-breaker
    knobs: the ledger is process-wide, so a session-scoped SET must not
    clobber the budget another session configured (last-dispatcher-wins
    on a shared resource).  Only a bare context with no Domain falls
    back to its own session view."""
    if ctx is None:
        return
    dom = getattr(ctx, "domain", None)
    try:
        if dom is not None:
            budget = max(
                int(dom.global_vars.get("tidb_device_mem_budget", 0)), 0)
        else:
            budget = max(
                int(ctx.get_sysvar("tidb_device_mem_budget")), 0)
        with _LOCK:
            _BUDGET[0] = budget
    except Exception:
        pass
    obs = getattr(dom, "observe", None)
    if obs is not None and hasattr(obs, "set_gauge"):
        with _LOCK:
            _SINKS.add(obs)
    # tenant identity for the uploads this dispatch will publish (the
    # session's tidb_resource_group, SESSION scope — tenancy is per
    # connection; the supervisor bridges it onto worker threads)
    try:
        set_group(str(ctx.get_sysvar("tidb_resource_group")).strip()
                  or DEFAULT_GROUP)
    except Exception:
        set_group(DEFAULT_GROUP)


def set_group(group: str):
    """Charge subsequent publishes on THIS thread to `group`."""
    _TLS.group = group or DEFAULT_GROUP


def current_group() -> str:
    return getattr(_TLS, "group", DEFAULT_GROUP)


def set_budget(n: int):
    """Set the budget in bytes directly (tests / embedders); 0 = auto."""
    with _LOCK:
        _BUDGET[0] = max(int(n), 0)


def _auto_budget() -> int:
    """What torch's caching allocator can hold on the CUDA device: the
    free memory at the first probe plus what the allocator has already
    reserved there (``torch.cuda.memory_reserved``), or 0 (unlimited)
    when the engine runs on the CPU (host RAM is governed by the
    MemTracker quota tree, not this manager) or no card is visible.
    This is the counterpart of the reference's ``bytes_limit``: the
    memory the allocator may actually take, never the card's total,
    which also counts the CUDA context and every other process on the
    card.  The engine's card is probed: a split mesh's placements on
    every card are charged to this one ledger under that card's budget,
    as the reference keeps one ledger under device 0's ``bytes_limit``.

    Same discipline as every config refresh: the memo check and the
    publish happen under _LOCK, the device probe runs OUTSIDE it; a
    racing double-probe is idempotent and the first publish wins.  The
    memo is dropped by set_device (bump_epoch) so a device switch
    re-probes."""
    with _LOCK:
        if _AUTO_BUDGET[0] is not None:
            return _AUTO_BUDGET[0]
    budget = 0
    try:
        import torch
        from .device import _DEVICE
        dev = torch.device(_DEVICE[0])
        if dev.type == "cuda" and torch.cuda.is_available():
            free, _total = torch.cuda.mem_get_info(dev)
            budget = int(free) + int(torch.cuda.memory_reserved(dev))
    except Exception:
        budget = 0
    with _LOCK:
        if _AUTO_BUDGET[0] is None:
            _AUTO_BUDGET[0] = budget
        return _AUTO_BUDGET[0]


def effective_budget() -> int:
    """Resolved budget in bytes (0 = unlimited)."""
    with _LOCK:
        override = _BUDGET[0]
    return override if override > 0 else _auto_budget()


# -- the cache protocol (ops/device.to_device_col) ---------------------------

def lookup(col, want_rows: int):
    """Cached ``(data, nulls)`` for `col` if present, epoch-current and at
    least `want_rows` long; else None (any stale/short entry is evicted
    so the caller rebuilds).  A hit touches the LRU."""
    with _LOCK:
        res = col._device
        if res is None:
            return None
        if res.epoch != _EPOCH[0]:
            # stale pre-fence buffer: evict eagerly — it must never be
            # served again NOR keep its bytes on the ledger
            _evict_token_locked(res.token)
            return None
        if res.rows < want_rows:
            # grow: miss WITHOUT evicting — the old entry keeps serving
            # shorter-bucket readers until publish() swaps it (the cache
            # stays write-once for concurrent consumers, and a rebuild
            # that fails mid-flight leaves the column still cached)
            return None
        ent = _ENTRIES.get(res.token)
        if ent is not None:
            _ENTRIES.move_to_end(res.token)
        STATS["hits"] += 1
        return res.data, res.nulls


def publish(col, data, nulls):
    """Install a freshly built upload as `col`'s cached device value and
    charge its bytes; returns the arrays to use.

    Compare-and-keep under the ledger lock: when a RACING builder already
    published an epoch-current entry at least as long, the existing entry
    WINS and this caller's arrays are discarded — the loser's bytes are
    counted as immediately evicted, never silently leaked outside the
    ledger (the pre-residency "last wins" publish leaked the loser's HBM
    buffer untracked until GC)."""
    nbytes = _nbytes(data) + _nbytes(nulls)
    rows = int(data.shape[0])
    budget_evicted = 0
    with _LOCK:
        cur = col._device
        if (cur is not None and cur.epoch == _EPOCH[0]
                and cur.rows >= rows and cur.token in _ENTRIES):
            # lost the publish race: keep the incumbent, account the loser
            STATS["publish_races"] += 1
            STATS["hbm_evictions"] += 1
            STATS["hbm_evicted_bytes"] += nbytes
            _ENTRIES.move_to_end(cur.token)
            out = cur.data, cur.nulls
        else:
            if cur is not None:
                _evict_token_locked(cur.token)
            token = next(_SEQ)
            group = current_group()
            res = _Resident(data, nulls, rows, _EPOCH[0], nbytes, token)
            col._device = res
            try:
                ref = weakref.ref(col, _make_gc_cb(token))
            except TypeError:
                ref = None  # owner not weakref-able: entry lives forever
            _ENTRIES[token] = _Entry(ref, nbytes, token, group)
            _BYTES[0] += nbytes
            _GROUP_BYTES[group] += nbytes
            _fleet_charge_locked(group, nbytes)
            STATS["uploads"] += 1
            ev0 = STATS["hbm_evictions"]
            _enforce_budget_locked(keep_token=token, group=group)
            budget_evicted = STATS["hbm_evictions"] - ev0
            out = data, nulls
    _publish_gauges()
    if budget_evicted:
        # span tracing (session/tracing.py): budget-pressure evictions on
        # the statement's timeline — recorded OUTSIDE the ledger lock
        from ..session.tracing import event as _trace_event
        _trace_event("residency.evict", n=budget_evicted, reason="budget")
    return out


def _make_gc_cb(token):
    def _cb(_ref, _token=token):
        with _LOCK:
            ent = _ENTRIES.pop(_token, None)
            if ent is not None:
                _BYTES[0] -= ent.nbytes
                _drop_group_bytes_locked(ent.group, ent.nbytes)
                STATS["gc_releases"] += 1
    return _cb


def _drop_group_bytes_locked(group: str, nbytes: int):
    _GROUP_BYTES[group] -= nbytes
    if _GROUP_BYTES[group] <= 0:
        del _GROUP_BYTES[group]
    _fleet_charge_locked(group, -nbytes)


# -- eviction ----------------------------------------------------------------

def _evict_token_locked(token: int):
    ent = _ENTRIES.pop(token, None)
    if ent is None:
        return
    _BYTES[0] -= ent.nbytes
    _drop_group_bytes_locked(ent.group, ent.nbytes)
    STATS["hbm_evictions"] += 1
    STATS["hbm_evicted_bytes"] += ent.nbytes
    col = ent.ref() if ent.ref is not None else None
    if col is not None:
        res = col._device
        if res is not None and res.token == token:
            col._device = None


def group_share() -> int:
    """Each active tenant's slice of the budget in bytes (0 = no budget):
    the budget divided equally among the groups that currently hold
    resident entries.  A lone tenant keeps the whole budget — shares are
    a pressure-time fairness rule, not a static partition."""
    with _LOCK:
        return _group_share_locked()


def free_share_bytes(group: str | None = None) -> int:
    """The LIVE headroom of `group`'s budget share (calling thread's
    group when None): share minus the bytes the group already holds
    resident, floored at a quarter of the share — a tenant whose cache
    is momentarily full must still be able to place a working set (the
    LRU will evict its own cold entries to make room), so the floor
    keeps memory-adaptive operators (the hybrid hash join's partition
    sizing, executor/hybrid_join.py) from collapsing to all-spill just
    because the previous query's uploads are still warm.  0 = no budget
    configured (unlimited)."""
    with _LOCK:
        share = _group_share_locked()
        if share <= 0:
            return 0
        g = group if group is not None else current_group()
        # under the serving fabric a tenant's consumption is FLEET-wide:
        # the share headroom that sizes memory-adaptive operators must
        # see the bytes this tenant holds in every sibling worker too
        held = _GROUP_BYTES.get(g, 0) + _fleet_remote_bytes(g)
        return max(share - held, share // 4)


def _group_share_locked() -> int:
    budget = effective_budget()
    if budget <= 0:
        return 0
    return budget // max(len(_GROUP_BYTES), 1)


def _enforce_budget_locked(keep_token: int, group: str = DEFAULT_GROUP):
    """Evict until under budget — SELF-FIRST, then over-share, then
    global LRU.  `keep_token` (the entry just published) is exempt: the
    working set of the CURRENT fragment must not be evicted out from
    under its own dispatch.

    Tenancy rule: one tenant's uploads evict its OWN cold
    entries before touching another tenant's — as long as the uploader
    holds more than its per-group share of the budget, its own LRU pays
    first.  Only when every group is back within its share (or the
    uploader has nothing left to give) does eviction fall back to the
    over-share groups and finally plain global LRU."""
    budget = effective_budget()
    if budget <= 0:
        return
    share = _group_share_locked()
    # phase 1 — self-first: the uploading tenant over its share evicts
    # its own cold entries (other tenants' working sets are protected).
    # Under the fabric "over its share" counts the tenant's bytes in
    # EVERY worker (one segment read per enforce, constant across the
    # loop — local evictions are what shrink the left side); phase 2's
    # per-entry checks stay local to keep eviction off the segment lock.
    remote = _fleet_remote_bytes(group)
    while (_BYTES[0] > budget
           and _GROUP_BYTES.get(group, 0) + remote > share):
        victim = None
        for token, ent in _ENTRIES.items():  # oldest first
            if token != keep_token and ent.group == group:
                victim = token
                break
        if victim is None:
            break
        _evict_token_locked(victim)
    # phase 2 — over-share tenants LRU-first, then global LRU
    while _BYTES[0] > budget:
        victim = None
        fallback = None
        for token, ent in _ENTRIES.items():  # oldest first
            if token == keep_token:
                continue
            if fallback is None:
                fallback = token
            if _GROUP_BYTES.get(ent.group, 0) > share:
                victim = token
                break
        victim = victim if victim is not None else fallback
        if victim is None:
            if _BYTES[0] > budget:
                log.warning(
                    "device upload of %d bytes exceeds "
                    "tidb_device_mem_budget=%d alone; kept (single "
                    "working column beats a livelock)", _BYTES[0], budget)
            return
        _evict_token_locked(victim)


def _evict_all_locked() -> int:
    n = len(_ENTRIES)
    for token in list(_ENTRIES):
        _evict_token_locked(token)
    return n


def evict_all(reason: str = "") -> int:
    """Drop every cached device value (ledger goes to zero).  Returns the
    number of entries evicted."""
    with _LOCK:
        n = _evict_all_locked()
    if n:
        log.info("evicted all %d cached device uploads (%s)",
                 n, reason or "explicit")
        from ..session.tracing import event as _trace_event
        _trace_event("residency.evict", n=n,
                     reason=reason or "explicit")
    _publish_gauges()
    return n


def recover_oom(err=None) -> int:
    """Step one of the OOM ladder (evict-all → retry → degrade): free
    every byte this manager pins so the retry dispatches against an
    emptied device.  The epoch is bumped TOO: a mid-flight join-leaf
    ``dcols`` dict holds references to the evicted arrays, and without an
    epoch change the retry's `_leaf_env` would hand the same dict back —
    re-pinning the very buffers this eviction freed.  The epoch mismatch
    forces every consumer to re-derive its device state from Columns."""
    with _LOCK:
        STATS["hbm_oom_recoveries"] += 1
        _EPOCH[0] += 1
        STATS["epoch_bumps"] += 1
        n = _evict_all_locked()
    log.warning("device OOM (%s): evicted %d cached uploads, retrying once "
                "before host degradation", err, n)
    _publish_gauges()
    from ..session.tracing import event as _trace_event
    _trace_event("residency.evict", n=n, reason="oom")
    return n


# -- introspection -----------------------------------------------------------

def resident_nbytes(owner) -> int:
    """Byte charge of `owner`'s cached value if it is live, epoch-current
    and still on the ledger; else 0.  Pure introspection: no LRU touch,
    no stats — gauge plumbing (e.g. the MPP placement-cache bytes gauge)
    must not look like cache traffic."""
    return resident_nbytes_total((owner,))


def resident_nbytes_total(owners) -> int:
    """Sum of resident_nbytes over `owners` under ONE ledger-lock
    acquisition — gauge plumbing runs on every query and every
    /status//metrics scrape, and must not contend the upload/evict lock
    once per cached owner."""
    total = 0
    with _LOCK:
        for owner in owners:
            res = owner._device
            if res is None or res.epoch != _EPOCH[0]:
                continue
            ent = _ENTRIES.get(res.token)
            if ent is not None:
                total += ent.nbytes
    return total


def resident_bytes() -> int:
    """The ``hbm_bytes_cached`` gauge."""
    with _LOCK:
        return _BYTES[0]


def snapshot() -> dict:
    with _LOCK:
        return {
            "epoch": _EPOCH[0],
            "hbm_bytes_cached": _BYTES[0],
            "entries": len(_ENTRIES),
            "budget_bytes": effective_budget(),
            "by_group": dict(_GROUP_BYTES),
            "group_share_bytes": _group_share_locked(),
            **STATS,
        }


def report_gauges() -> dict:
    """The surfacing policy shared by EXPLAIN ANALYZE annotations and
    bench.py lines: ``hbm_bytes_cached`` always; the eviction /
    OOM-recovery counters only once they have ever fired (pressure is
    the exception, not annotation noise on every healthy plan)."""
    s = snapshot()
    out = {"hbm_bytes_cached": s["hbm_bytes_cached"]}
    if s["hbm_evictions"]:
        out["hbm_evictions"] = s["hbm_evictions"]
    if s["hbm_oom_recoveries"]:
        out["hbm_oom_recoveries"] = s["hbm_oom_recoveries"]
    return out


def verify_ledger() -> dict:
    """Recompute the ledger from live entries (chaos-harness invariant:
    no budget-counter drift), INCLUDING the per-tenant slices: the group
    counters must sum from the live entries exactly, and their total must
    equal the global ledger.  Returns {"ok", "ledger", "recomputed",
    "by_group", "by_group_recomputed"}."""
    import collections as _c
    with _LOCK:
        recomputed = sum(e.nbytes for e in _ENTRIES.values())
        by_group_rec = _c.Counter()
        for e in _ENTRIES.values():
            by_group_rec[e.group] += e.nbytes
        groups_ok = (dict(by_group_rec) == dict(_GROUP_BYTES)
                     and sum(_GROUP_BYTES.values()) == _BYTES[0])
        return {"ok": (recomputed == _BYTES[0] and _BYTES[0] >= 0
                       and groups_ok),
                "ledger": _BYTES[0], "recomputed": recomputed,
                "by_group": dict(_GROUP_BYTES),
                "by_group_recomputed": dict(by_group_rec)}


def _publish_gauges():
    with _LOCK:
        sinks = list(_SINKS)
        vals = {"hbm_bytes_cached": _BYTES[0],
                "hbm_evictions": STATS["hbm_evictions"],
                "hbm_oom_recoveries": STATS["hbm_oom_recoveries"]}
    for obs in sinks:
        try:
            for k, v in vals.items():
                obs.set_gauge(k, v)
        except Exception:
            pass
