"""Durable, fleet-coherent MVCC store: the paper's "one storage layer
under many SQL servers", built from the embedded python engine
(kv/mvcc.py) + a shared write-ahead log (kv/wal.py) + the fabric
coordination segment (fabric/coord.py).

The pieces and who owns what:

* **WAL on the commit path** — every logical mutation (prewrite /
  commit / rollback / raw puts / raw delete-range) appends a framed
  record stamped with the origin slot.  Commit records are the
  durability point: ``commit()`` appends (and group-fsyncs under
  ``tidb_wal_fsync = commit``) BEFORE applying locally, so an acked
  commit survives SIGKILL and an un-acked one is simply absent.
* **Recovery** (:meth:`DurableMVCCStore.recover`) — Percolator
  semantics: load the checkpoint snapshot, replay the log tail in
  order, CRC-truncate the first torn record, then resolve orphaned
  prewrites via their primary's disposition (a commit record for the
  txn's start_ts means commit the leftovers; none means roll back).
  In a live fleet, leftovers owned by a LIVE sibling slot are its
  in-flight 2PC — left alone.
* **Fleet TSO** (:class:`SegmentTSOracle`) — batched leases off the
  segment's ``_tso`` cell make every worker's timestamps
  fleet-monotonic through the same ``next_ts()`` abstraction solo mode
  uses (kv/mvcc.TSOracle), closing the per-process-oracle collision.
* **Shared lock table** — prewrite/pessimistic-lock claims key hashes
  in the segment BEFORE local checks, so cross-worker write-write
  conflicts are detected synchronously (LockedError → the normal
  lock-wait ladder), not after the fact.  A full table degrades to
  local-only detection; a dead slot's claims are freed by lease
  reclaim.
* **Tailing** — each worker replays every OTHER slot's records into its
  local replica (foreign prewrites become visible locks; commits
  convert them and bump table versions so the columnar cache
  invalidates), at snapshot/txn creation (synchronous catch-up: a
  statement begun after a peer's commit returned ALWAYS sees it) and
  from a background tailer thread.
* **Schema propagation** — a commit that writes the meta
  schema-version key publishes the segment's ``_schema_ver`` cell; the
  Domain's schema lease (session/session.py) reloads on a newer cell
  and stale commits fail retriably with ErrInfoSchemaChanged.

Failure semantics: a failed commit-record append (torn injection,
fsync failure) rolls the local txn back, best-effort logs a rollback
record, and re-raises — recovery honors the LAST disposition per
start_ts, so live state and recovered state agree.

One log per package: this store reads the same environment as the JAX
package's (``TIDB_TPU_WAL_DIR`` for the log, and a fleet's
``TIDB_TPU_FABRIC_*`` for its run directory and segment), and the two
write the same record format.  A fleet of this package and a fleet of
the other must never be pointed at one log or one run directory: their
workers would tail, and truncate under, each other's commits while each
holds its own bulk-installed columnar caches.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import logging
import os
import signal
import threading
import time

from collections import deque

from ..utils import failpoint
from ..errors import WriteConflictError
from .mvcc import Lock, MVCCStore, OP_LOCK, OP_ROLLBACK, TSOracle
from . import wal as wal_mod

log = logging.getLogger("tidb_tpu_torch.kv.shared_store")

#: timestamps per segment lease (one segment round-trip per BATCH ts)
TSO_BATCH = 64

#: background tailer poll period
TAIL_INTERVAL_S = 0.01

#: wall-clock budget a snapshot may spend blocked on the fleet
#: committed frontier (fresh_read_ts) before REFUSING the read loudly
FRESHNESS_BUDGET_MS = 1000.0

#: how long a lagging origin's freshness breaker stays open after a
#: wait timeout — reads degrade to explicit stale_ok instead of
#: re-paying the budget against a wedged-but-alive worker
FRESHNESS_BREAKER_S = 5.0

#: meta key whose commit publishes the fleet schema-version cell
SCHEMA_VERSION_KEY = b"m:schema_version"

#: committed-delta ring entries kept per table — the fold source for
#: the versioned result cache (executor/agg_cache.py).  Evicting past a
#: cached page's version only downgrades its next hit to a full
#: recompute, never to a wrong answer
DELTA_RING_CAP = 512


def key_hash(key: bytes) -> bytes:
    return hashlib.blake2b(key, digest_size=16).digest()


class SegmentTSOracle:
    """The fleet timestamp oracle: batched leases off the coordination
    segment's monotonic ``_tso`` cell, wall-clock anchored so GC's
    now-based safepoint arithmetic stays meaningful.  Same ``next_ts``
    surface as kv/mvcc.TSOracle — engines cannot tell them apart."""

    def __init__(self, coordinator, batch: int = TSO_BATCH):
        self._c = coordinator
        self._batch = max(int(batch), 1)
        self._lock = threading.Lock()
        self._next = 0
        self._end = 0
        self._local = TSOracle()  # post-unlink teardown fallback

    def next_ts(self) -> int:
        with self._lock:
            if self._next < self._end:
                self._next += 1
                return self._next
            # the lease floors at BOTH wall clock (GC arithmetic) and
            # our own high-water (advance_to may have pushed _next past
            # the old lease — e.g. after tailing a peer's commit)
            floor = max(int(time.time() * 1000) << 18, self._next)
            try:
                base, end = self._c.tso_lease(self._batch, floor)
            except Exception as e:  # noqa: BLE001 — segment unlinked at
                #   teardown: stay monotonic past everything we issued
                log.debug("segment tso lease failed (%s); local fallback",
                          e)
                ts = max(self._local.next_ts(), self._next + 1)
                self._next = ts
                return ts
            self._next = base + 1
            self._end = end
            return self._next

    def advance_to(self, ts: int):
        """Never issue a timestamp <= ``ts``: a replica's clock may not
        lag a commit it has applied (read-your-peers'-committed-writes
        — batched leases otherwise leave this worker's snapshot ts
        BELOW a peer's fresher commit_ts), nor a recovery high-water.
        Local-only: the segment cell is already past any commit_ts it
        ever granted, and the lease floor covers the recovery case."""
        with self._lock:
            self._local.advance_to(ts)
            self._next = max(self._next, int(ts))


def _table_id_of(key: bytes) -> "int | None":
    """Best-effort table id from a record/index key (None for meta)."""
    if len(key) >= 9 and key[:1] == b"t":
        from .. import tablecodec
        try:
            return tablecodec._dec_i64(key[1:9])
        except Exception as e:  # noqa: BLE001 — non-table 't' key: the
            #   caller only loses a cache-invalidation bump
            log.debug("table-id decode failed for %r: %s", key[:16], e)
            return None
    return None


def _maybe_kill(payload):
    if payload == "kill":
        os.kill(os.getpid(), signal.SIGKILL)


def _record_ts(rec: tuple) -> int:
    """The timestamp a log record carries (0 when none) — the replay
    high-water the recovered oracle must resume above."""
    kind = rec[0]
    if kind == "commit":
        return max(rec[2], rec[3])
    if kind in ("prewrite", "rollback", "raw", "rawdel"):
        return rec[2]
    return 0


class DurableMVCCStore(MVCCStore):
    """kv/mvcc.MVCCStore + WAL durability + fleet coherence.

    Solo (no coordinator): WAL append/recovery only — a single durable
    process.  Fleet (coordinator + slot): adds the segment TSO, the
    shared lock table, tailing and schema publication.
    """

    def __init__(self, wal: "wal_mod.WAL", *, coordinator=None,
                 slot: int = -1, oracle=None):
        super().__init__(oracle=oracle)
        self.wal = wal
        self._coord = coordinator
        self._slot = int(slot)
        self._tail_lock = threading.RLock()
        self._applied_lsn = wal.base_lsn
        # view-anchored write-conflict detection: a peer's commit can
        # carry a commit_ts BELOW a later-minted local read ts (the
        # shared oracle hands out the cts first) while its APPLY lands
        # only after that reader's statement already ran — so
        # has_commit_after(for_update_ts) alone can never see the
        # conflict and the write becomes a cross-worker lost update.
        # Every applied foreign commit bumps this sequence and stamps
        # its keys; lock/prewrite conflict any txn whose captured read
        # view (kv/store.Snapshot.view_seq) predates a written key's
        # stamp.
        self._foreign_apply_seq = 0
        self._key_apply_seq: dict = {}
        # durable commit frontier this worker publishes: forward-only
        # maxes fed by the WAL's durable-ack hook; the worker heartbeat
        # republishes (repairs a coordinator down-window) through the
        # same publish_frontier funnel
        self._frontier_mu = threading.Lock()
        self._frontier_ts = 0
        self._frontier_lsn = 0
        # per-origin freshness breaker: slot -> monotonic expiry.  A
        # stalled-but-alive origin that blew the freshness budget stops
        # gating reads until the window closes (reads carry stale_ok)
        self._breaker: "dict[int, float]" = {}
        self._stale_reads = 0
        self._last_stale_reason = ""
        self._last_stale_warn = 0.0
        #: observation hook: wait seconds per fleet ts acquisition
        #: (the Domain wires observe_hist("freshness_wait_seconds"))
        self.on_freshness_wait = None
        if coordinator is not None and self._slot >= 0:
            wal.on_durable = self._on_durable
        #: start_ts values holding >=1 shared lock-table claim
        self._claimed: set[int] = set()
        self._claim_mu = threading.Lock()
        self._lock_degrades = 0  # lock-table-full local-only fallbacks
        # per-table committed-delta ring: tid -> deque[(commit_ts,
        # row keys)], the versioned result cache's fold source.  The
        # floor is the ts BELOW which completeness is unproven; noted
        # holds commit ts the matching bump_table_version consumes (a
        # bump the ring never saw — DDL, BR, unwind — poisons folds)
        self._delta_ring: "dict[int, deque]" = {}
        self._delta_floor: "dict[int, int]" = {}
        self._delta_noted: "dict[int, set]" = {}
        self._delta_min_after = 0  # boot-time poison: checkpoint rows
        self._delta_mu = threading.Lock()
        self._tail_stop = threading.Event()
        self._tail_thread = None
        self._recovered = False
        # replayed txn fates, stashed by recover() for deferred
        # cross-region orphan resolution (fabric/region.py)
        self._recover_lock_owner: dict[int, int] = {}
        self._recover_disposition: dict[int, tuple] = {}

    # -- lifecycle ------------------------------------------------------------

    def recover(self, *, defer_orphans: bool = False) -> dict:
        """Checkpoint + tail replay + torn-tail truncation + orphan
        resolution.  Idempotent; runs under the cross-process WAL lock
        (boot of a fresh replica into a live fleet replays the whole
        log while peers keep appending — the tailer picks up the rest).

        ``defer_orphans=True`` skips the resolution pass and stashes the
        replayed disposition/owner maps on the instance: a region-
        sharded store (fabric/region.py) recovers EVERY region first,
        merges their dispositions, and only then resolves — a
        cross-region txn's commit point may live in another region's
        log (the primary key's region), and resolving from one region's
        log alone would roll back a committed txn's secondaries.
        """
        from ..session import tracing
        t0 = time.monotonic()
        with tracing.span("store.recover"):
            torn = self.wal.truncate_torn_tail()
            start = self.wal.base_lsn
            ck = self.wal.read_checkpoint()
            if ck is not None and ck[0] >= self.wal.base_lsn:
                self.load_state(ck[1])
                start = ck[0]
            end = self.wal.scan_valid_end()
            replayed = 0
            max_ts = 0
            lock_owner: dict[int, int] = {}   # start_ts -> origin slot
            disposition: dict[int, tuple] = {}  # start_ts -> last fate
            for rec, lsn in self.wal.read_records(start, end):
                fp = failpoint.inject("store-recover-replay")
                _maybe_kill(fp)
                self._apply(rec, replay=True, lock_owner=lock_owner,
                            disposition=disposition)
                max_ts = max(max_ts, _record_ts(rec))
                replayed += 1
            self._applied_lsn = end
            if max_ts:
                # the oracle must resume ABOVE every replayed version:
                # a same-millisecond restart could otherwise mint
                # timestamps below them (invisible to new snapshots)
                self.tso.advance_to(max_ts)
            # fold completeness cannot extend below this boot: rows
            # restored from the checkpoint never passed through the
            # delta ring
            self._delta_min_after = max(self._delta_min_after, max_ts)
            self._recover_lock_owner = lock_owner
            self._recover_disposition = disposition
            resolved = 0
            if not defer_orphans:
                resolved = self.resolve_orphans(disposition, lock_owner)
            self._publish_after_recovery()
            self._recovered = True
            wal_mod._bump("wal_recoveries")
            wal_mod._bump("wal_replayed_records", replayed)
            out = {"replayed": replayed, "torn_bytes": torn,
                   "resolved_orphans": resolved,
                   "from_checkpoint": ck is not None,
                   "recover_s": round(time.monotonic() - t0, 4)}
            log.info("store recovered: %s", out)
            return out

    def resolve_orphans(self, disposition: "dict[int, tuple]",
                        lock_owner: "dict[int, int] | None" = None,
                        *, assume_fenced: bool = False) -> int:
        """Resolve orphaned prewrites via their primary: a commit record
        for the start_ts is the primary's committed proof; none means
        the txn died before its commit point.  Locks owned by a LIVE
        sibling slot are in-flight 2PC, not orphans — UNLESS
        ``assume_fenced``: a region-failover owner holds the new epoch,
        so the old owner (even one still heartbeating: a partitioned
        zombie) can never append its commit record past the fence, and
        deferring to it would leave its locks blocking reads forever.

        ``disposition`` may be wider than this store's own log: the
        region router merges every region's replayed dispositions so a
        secondary in region B finds its primary's commit from region
        A's log (Percolator's commit point is per-txn, not per-region).
        """
        lock_owner = lock_owner if lock_owner is not None else {}
        live = set()
        if self._coord is not None and not assume_fenced:
            with contextlib.suppress(Exception):
                live = set(self._coord.live_slots())
        resolved = 0
        with self._lock:
            leftovers = list(self.locks.items())
        for key, lk in leftovers:
            owner = lock_owner.get(lk.start_ts, -2)
            if owner in live and owner != self._slot:
                continue
            fate = disposition.get(lk.start_ts)
            tid = _table_id_of(key)
            if fate is not None and fate[0] == "commit":
                MVCCStore.commit(self, [key], lk.start_ts, fate[1])
                rec = ("commit", self._slot, lk.start_ts, fate[1],
                       [key], [tid] if tid is not None else [])
            else:
                MVCCStore.rollback(self, [key], lk.start_ts)
                rec = ("rollback", self._slot, lk.start_ts, [key])
            # the resolution is logged so every replica (live peers
            # tailing now, future recoveries) converges on one fate
            with contextlib.suppress(Exception):
                self.wal.append(rec)
            resolved += 1
        return resolved

    def _publish_after_recovery(self):
        if self._coord is None:
            return
        with contextlib.suppress(Exception):
            if self._slot >= 0:
                self._coord.set_wal_applied(self._slot, self._applied_lsn)
            v = self._local_schema_version()
            if v:
                self._coord.publish_schema_version(v)

    def _local_schema_version(self) -> int:
        res = self.map.read(SCHEMA_VERSION_KEY, 1 << 62)
        if res is None or res[1] is None:
            return 0
        with contextlib.suppress(Exception):
            return int(json.loads(res[1]))
        return 0

    def fleet_schema_version(self) -> int:
        """The published schema-version cell (0 solo / unreadable)."""
        if self._coord is None:
            return 0
        try:
            return self._coord.schema_version()
        except Exception as e:  # noqa: BLE001 — segment may be unlinked
            log.debug("schema cell unreadable: %s", e)
            return 0

    def start_tailer(self):
        if self._coord is None or self._tail_thread is not None:
            return

        def loop():
            while not self._tail_stop.wait(TAIL_INTERVAL_S):
                try:
                    self.catch_up()
                except Exception as e:  # noqa: BLE001 — a tail hiccup
                    #   retries next tick; persistent failure is visible
                    #   as a stuck wal_applied column
                    log.warning("wal tailer catch-up failed: %s", e)

        self._tail_thread = threading.Thread(
            target=loop, daemon=True, name="wal-tailer")
        self._tail_thread.start()

    def close(self):
        self._tail_stop.set()
        if self._tail_thread is not None:
            self._tail_thread.join(timeout=2.0)
        self.wal.close()

    # -- tailing --------------------------------------------------------------

    def catch_up(self):
        """Apply every committed record past our applied frontier.  No
        coordinator → solo: nothing ever appears we did not write."""
        if self._coord is None:
            return
        with self._tail_lock:
            # chaos door: delay tail application — the freshness wait
            # in fresh_read_ts must cover the gap, never a stale answer
            failpoint.inject("tail-lag")
            self.wal.reopen_if_truncated()
            if self._applied_lsn < self.wal.base_lsn:
                # a peer truncated past us.  Legal only when our applied
                # column said so (we had applied everything below the
                # new base) or we are a slot the fleet reclaimed as dead
                # — a zombie in that state may be missing checkpoint-
                # only records, which is worth a loud log, not silence
                log.warning(
                    "wal truncated past applied frontier (%d < %d): "
                    "records below the new base live only in the "
                    "checkpoint", self._applied_lsn, self.wal.base_lsn)
                self._applied_lsn = self.wal.base_lsn
            end = self.wal.committed_lsn()
            if end <= self._applied_lsn:
                return
            n = 0
            for rec, lsn in self.wal.read_records(self._applied_lsn, end):
                self._apply(rec)
                self._applied_lsn = lsn
                n += 1
            if n and self._slot >= 0:
                with contextlib.suppress(Exception):
                    self._coord.set_wal_applied(self._slot,
                                                self._applied_lsn)

    def _apply(self, rec: tuple, replay: bool = False,
               lock_owner: "dict | None" = None,
               disposition: "dict | None" = None):
        """Apply one log record to the local replica.  Outside replay,
        records from OUR OWN slot are skipped (already applied live)."""
        kind, origin = rec[0], rec[1]
        own = (not replay and self._slot >= 0 and origin == self._slot)
        if kind == "prewrite":
            _k, _o, start_ts, primary, muts = rec
            if lock_owner is not None:
                lock_owner[start_ts] = origin
            if own:
                return
            with self._lock:
                for key, op, value in muts:
                    cur = self.locks.get(key)
                    if cur is not None and cur.start_ts != start_ts:
                        # both sides degraded past the shared lock
                        # table (table-full) and raced: keep ours, the
                        # foreign txn's commit/rollback still applies
                        log.warning(
                            "foreign prewrite overlaps local lock "
                            "(ts %d vs %d) — shared lock table was "
                            "full", start_ts, cur.start_ts)
                        continue
                    self.locks[key] = Lock(start_ts, primary, op, value)
        elif kind == "commit":
            _k, _o, start_ts, commit_ts, keys, tids = rec
            if disposition is not None:
                disposition[start_ts] = ("commit", commit_ts)
            if own:
                return
            # the local clock must pass the applied commit BEFORE it is
            # readable, so the very next local snapshot includes it
            self.tso.advance_to(commit_ts)
            try:
                MVCCStore.commit(self, keys, start_ts, commit_ts)
            except Exception as e:  # noqa: BLE001 — a tailed commit for
                #   a txn this replica resolved differently (degraded
                #   lock-table race) must not wedge the tailer; the
                #   divergence is logged, not swallowed
                log.warning("tailed commit apply failed for ts %d: %s",
                            start_ts, e)
            # stamp the keys AFTER the values landed: any local
            # statement whose read view was captured before this point
            # computed from the pre-commit values and must conflict
            # when it tries to write these keys (see _view_conflict)
            with self._lock:
                self._foreign_apply_seq += 1
                seq = self._foreign_apply_seq
                for key in keys:
                    self._key_apply_seq[key] = seq
            self._note_delta(commit_ts, keys)
            for tid in tids:
                self.bump_table_version(tid, commit_ts)
            if not replay:
                wal_mod._bump("wal_tail_records")
        elif kind == "rollback":
            _k, _o, start_ts, keys = rec
            if disposition is not None:
                disposition[start_ts] = ("rollback",)
            if own:
                return
            # last disposition wins: a commit record followed by a
            # rollback record for the same start_ts (its fsync failed
            # and the owner rolled back) must UNWIND, not coexist
            regressed = self._unwindable(keys, start_ts)
            self.unwind_commit(keys, start_ts)
            MVCCStore.rollback(self, keys, start_ts)
            if regressed:
                # visible rows just regressed WITHOUT a commit record:
                # advance the touched tables' versions under a fresh ts
                # (never noted, so the fold ring poisons itself) so
                # every stamped cache page over them invalidates rather
                # than serving the resurrected state
                ts = 0
                with contextlib.suppress(Exception):
                    ts = self.tso.next_ts()
                for tid in sorted({t for t in (_table_id_of(k)
                                               for k in regressed)
                                   if t is not None}):
                    self.bump_table_version(tid, ts)
            if not replay:
                wal_mod._bump("wal_tail_records")
        elif kind == "raw":
            _k, _o, commit_ts, pairs, tids = rec
            if own:
                return
            self.tso.advance_to(commit_ts)
            MVCCStore.raw_batch_put(self, pairs, commit_ts)
            self._note_delta(commit_ts, [k for k, _v in pairs])
            for tid in tids:
                self.bump_table_version(tid, commit_ts)
        elif kind == "rawdel":
            _k, _o, _ts, start, end = rec
            if own:
                return
            MVCCStore.raw_delete_range(self, start, end)
            self._poison_range(start, end)
        else:
            log.warning("unknown wal record kind %r skipped", kind)

    # -- the fleet committed frontier -----------------------------------------

    def _on_durable(self, commit_ts: int, cover_lsn: int):
        """WAL durable-ack hook: ``commit_ts`` is fsync-acked and the
        sync covers through ``cover_lsn``.  Runs on whatever thread paid
        the fsync, BEFORE that commit's append returns to its caller —
        so by the time any client sees an ack, the frontier the fleet
        gates reads on already includes it (the linearizability edge)."""
        with self._frontier_mu:
            self._frontier_ts = max(self._frontier_ts, int(commit_ts))
            self._frontier_lsn = max(self._frontier_lsn, int(cover_lsn))
        self.publish_frontier()

    def publish_frontier(self):
        """Publish this worker's durable commit frontier to the segment
        (forward-only there too).  Also called each worker heartbeat so
        a publish lost to a coordinator down-window is repaired within
        a beat.  The ``frontier-stall`` failpoint freezes publication —
        the chaos shape for a worker whose fsyncs complete but whose
        frontier column wedges."""
        if self._coord is None or self._slot < 0:
            return
        if failpoint.inject("frontier-stall"):
            return
        with self._frontier_mu:
            ts, lsn = self._frontier_ts, self._frontier_lsn
        if not ts:
            return
        with contextlib.suppress(Exception):
            self._coord.set_commit_frontier(self._slot, ts, lsn)

    def _note_stale(self, reason: str):
        """A read is proceeding WITHOUT fleet-freshness proof.  Loud by
        contract: counted (``freshness_stale_ok``, surfaced in EXPLAIN
        ANALYZE via the fabric gauges and /metrics) and rate-limit
        logged — never silent."""
        self._stale_reads += 1
        self._last_stale_reason = reason
        from ..fabric import state as fabric_state
        with contextlib.suppress(Exception):
            fabric_state.bump("freshness_stale_ok")
        now = time.monotonic()
        if now - self._last_stale_warn >= 1.0:
            self._last_stale_warn = now
            log.warning("stale_ok read downgrade: %s", reason)

    def fresh_read_ts(self) -> int:
        """Fleet-linearizable timestamp acquisition: the paper's
        strong-consistency contract — a query observes every
        transaction acked before it began — enforced ACROSS workers.

        Reads every live origin's published durable frontier
        (commit_ts, covering LSN) at ts-acquisition.  The returned ts
        is fenced above every frontier commit_ts (``advance_to`` +
        ``next_ts``), then we block — targeted catch-up under the
        bounded ``freshnessWait`` budget — until the local replica has
        applied through every gating origin's frontier LSN.

        Degradations are explicit, never silent: a dead/reclaimed slot
        stops gating at lease reclaim (``commit_frontiers`` filters to
        live leases); an unreachable coordinator or a breaker-open
        origin downgrades the read to stale_ok (counted + logged); a
        stalled-but-alive origin that exhausts the budget raises
        :class:`~tidb_tpu_torch.errors.FreshnessWaitError` (9011) and trips
        its per-origin breaker for FRESHNESS_BREAKER_S."""
        if self._coord is None:
            return self.tso.next_ts()
        t0 = time.monotonic()
        waited = False
        try:
            try:
                fronts = self._coord.commit_frontiers()
            except Exception as e:  # noqa: BLE001 — coordinator gone:
                #   freshness is unprovable; degrade LOUDLY, not
                #   silently (a plain next_ts read may miss peers)
                self._note_stale(f"coordinator unreachable ({e})")
                return self.tso.next_ts()
            now = time.monotonic()
            need_ts = 0
            need_lsn = 0
            gating: "dict[int, int]" = {}
            for slot, (fts, flsn) in fronts.items():
                if slot == self._slot:
                    continue
                if self._breaker.get(slot, 0.0) > now:
                    self._note_stale(
                        f"origin slot {slot} freshness breaker open")
                    continue
                need_ts = max(need_ts, fts)
                need_lsn = max(need_lsn, flsn)
                gating[slot] = flsn
            if need_ts:
                # ts fence: never issue a snapshot ts at-or-below a
                # peer's acked durable commit
                self.tso.advance_to(need_ts)
            ts = self.tso.next_ts()
            if self._applied_lsn >= need_lsn:
                return ts
            # LSN fence: block until the tail is applied through every
            # gating origin's frontier
            from ..errors import BackoffExhaustedError, FreshnessWaitError
            from ..fabric import state as fabric_state
            from ..utils.backoff import Backoffer
            waited = True
            with contextlib.suppress(Exception):
                fabric_state.bump("freshness_waits")
            bo = Backoffer(budget_ms=FRESHNESS_BUDGET_MS, wall_clock=True)
            while True:
                try:
                    self.catch_up()
                except Exception as e:  # noqa: BLE001 — a tail hiccup
                    #   retries inside the budget like any other lag
                    log.debug("freshness catch-up failed: %s", e)
                if self._applied_lsn >= need_lsn:
                    return ts
                try:
                    bo.backoff("freshnessWait")
                except BackoffExhaustedError as e:
                    lagging = sorted(s for s, lsn in gating.items()
                                     if lsn > self._applied_lsn)
                    expiry = time.monotonic() + FRESHNESS_BREAKER_S
                    for s in lagging:
                        self._breaker[s] = expiry
                    with contextlib.suppress(Exception):
                        fabric_state.bump("freshness_timeouts")
                    raise FreshnessWaitError(
                        "snapshot freshness wait exhausted: applied "
                        f"lsn {self._applied_lsn} < fleet frontier "
                        f"{need_lsn} (lagging origin slots {lagging}); "
                        "refusing stale read") from e
        finally:
            hook = self.on_freshness_wait
            if hook is not None:
                with contextlib.suppress(Exception):
                    hook(time.monotonic() - t0 if waited else 0.0)

    # -- the shared lock table ------------------------------------------------

    def _claim_shared(self, keys, start_ts: int):
        from ..errors import LockedError
        if self._coord is None:
            return
        keys = list(keys)
        hashes = [key_hash(k) for k in keys]
        try:
            holder, idx = self._coord.lock_claim(hashes, start_ts,
                                                 max(self._slot, 0))
        except Exception as e:  # noqa: BLE001 — segment gone: local-only
            log.debug("shared lock claim failed (%s); local-only", e)
            return
        if holder == -1:
            self._lock_degrades += 1
            return
        if holder:
            raise LockedError(
                f"key locked by fleet txn {holder}",
                key=keys[idx], lock_ts=holder)
        with self._claim_mu:
            self._claimed.add(start_ts)

    def _release_shared(self, start_ts: int):
        if self._coord is None:
            return
        with self._claim_mu:
            if start_ts not in self._claimed:
                return
            self._claimed.discard(start_ts)
        with contextlib.suppress(Exception):
            self._coord.lock_release(start_ts)

    # -- transactional overrides ----------------------------------------------

    def read_view_seq(self) -> int:
        """Anchor for a new read view (captured by kv/store.Snapshot):
        the count of foreign commits this replica has applied.  A write
        conflicts when any of its keys carries a HIGHER per-key stamp —
        the statement computed from values older than an already-applied
        peer commit, the lost-update window that commit_ts comparison
        cannot close (a peer's cts may be below a later-minted local ts
        while its apply trails both)."""
        return self._foreign_apply_seq

    def _view_conflict(self, keys, view_seq, start_ts=None):
        """Raise WriteConflictError when a foreign commit touching one
        of ``keys`` was applied AFTER the writing statement's read view
        was captured.  Keys the txn already holds its OWN pessimistic
        lock on are exempt: their conflict was checked at lock time and
        the held claim has excluded foreign applies since (mirrors the
        base prewrite's DoPessimisticCheck skip)."""
        if view_seq is None:
            return
        with self._lock:
            for key in keys:
                stamp = self._key_apply_seq.get(key, 0)
                if stamp <= view_seq:
                    continue
                lk = self.locks.get(key)
                if (start_ts is not None and lk is not None
                        and lk.start_ts == start_ts
                        and lk.op == OP_LOCK):
                    continue
                raise WriteConflictError(
                    "write conflict: key rewritten by a peer commit "
                    f"applied after this statement's read view "
                    f"(view seq {view_seq} < key stamp {stamp})")

    def prewrite(self, mutations, primary: bytes, start_ts: int,
                 view_seq: "int | None" = None):
        self._claim_shared([m[0] for m in mutations], start_ts)
        try:
            self.catch_up()  # conflicts committed on peers must be seen
            self._view_conflict([m[0] for m in mutations], view_seq,
                                start_ts=start_ts)
            super().prewrite(mutations, primary, start_ts)
        except BaseException:
            self._release_shared(start_ts)
            raise
        # the prewrite record makes foreign locks visible to peers and
        # gives recovery its orphan inventory; its durability rides the
        # commit record's fsync (same file)
        self.wal.append(("prewrite", self._slot, start_ts, primary,
                         [(k, op, v) for k, op, v in mutations]))

    def commit(self, keys, start_ts: int, commit_ts: int):
        keys = list(keys)
        tids = sorted({t for t in (_table_id_of(k) for k in keys)
                       if t is not None})
        schema_ver = self._pending_schema_version(keys, start_ts)
        try:
            # WAL discipline: the commit record lands (and fsyncs under
            # policy `commit`) BEFORE the local apply — an acked commit
            # is always recoverable
            self.wal.append(("commit", self._slot, start_ts, commit_ts,
                             keys, tids), sync=True, commit_ts=commit_ts)
        except BaseException:
            # the commit never reached its durability point: roll back
            # (recovery honors the LAST disposition per start_ts, so a
            # half-appended commit record is overridden)
            with contextlib.suppress(Exception):
                super().rollback(keys, start_ts)
            with contextlib.suppress(Exception):
                self.wal.append(("rollback", self._slot, start_ts, keys))
            self._release_shared(start_ts)
            raise
        try:
            super().commit(keys, start_ts, commit_ts)
        finally:
            self._release_shared(start_ts)
        # the Transaction layer bumps table versions right after this
        # returns (kv/store.py); noting first lets those bumps consume
        # the ts instead of poisoning the fold ring
        self._note_delta(commit_ts, keys)
        if schema_ver and self._coord is not None:
            with contextlib.suppress(Exception):
                self._coord.publish_schema_version(schema_ver)

    def _pending_schema_version(self, keys, start_ts: int) -> int:
        """The schema version this commit publishes (0 = not a DDL)."""
        if self._coord is None or SCHEMA_VERSION_KEY not in keys:
            return 0
        with self._lock:
            lk = self.locks.get(SCHEMA_VERSION_KEY)
            if lk is None or lk.start_ts != start_ts or lk.value is None:
                return 0
            with contextlib.suppress(Exception):
                return int(json.loads(lk.value))
        return 0

    def rollback(self, keys, start_ts: int):
        keys = list(keys)
        try:
            super().rollback(keys, start_ts)
            self.wal.append(("rollback", self._slot, start_ts, keys))
        finally:
            self._release_shared(start_ts)

    def acquire_pessimistic_lock(self, keys, primary: bytes,
                                 start_ts: int, for_update_ts: int,
                                 view_seq: "int | None" = None):
        keys = list(keys)
        self._claim_shared(keys, start_ts)
        try:
            self.catch_up()
            self._view_conflict(keys, view_seq, start_ts=start_ts)
            super().acquire_pessimistic_lock(keys, primary, start_ts,
                                             for_update_ts)
        except BaseException:
            # free only THIS batch's claims: earlier statements of the
            # txn still hold theirs until commit/rollback
            if self._coord is not None:
                with contextlib.suppress(Exception):
                    self._coord.lock_release(
                        start_ts, [key_hash(k) for k in keys])
            raise

    def resolve_lock(self, key: bytes, committed: bool, commit_ts: int = 0):
        with self._lock:
            lk = self.locks.get(key)
        if lk is None:
            return
        super().resolve_lock(key, committed, commit_ts)
        # the resolution must be fleet-visible: peers holding the same
        # tailed lock converge on the same fate
        rec = (("commit", self._slot, lk.start_ts, commit_ts, [key],
                [t for t in (_table_id_of(key),) if t is not None])
               if committed else
               ("rollback", self._slot, lk.start_ts, [key]))
        with contextlib.suppress(Exception):
            self.wal.append(rec)

    # -- raw overrides --------------------------------------------------------

    def raw_put(self, key: bytes, value: bytes, commit_ts: int | None = None):
        ts = commit_ts if commit_ts is not None else self.tso.next_ts()
        super().raw_put(key, value, commit_ts=ts)
        self._note_delta(ts, [key])
        tid = _table_id_of(key)
        self.wal.append(("raw", self._slot, ts, [(key, value)],
                         [tid] if tid is not None else []),
                        commit_ts=ts)

    def raw_batch_put(self, pairs, commit_ts: int | None = None):
        pairs = list(pairs)
        if not pairs:
            return
        ts = commit_ts if commit_ts is not None else self.tso.next_ts()
        super().raw_batch_put(pairs, commit_ts=ts)
        self._note_delta(ts, [k for k, _v in pairs])
        tids = sorted({t for t in (_table_id_of(k) for k, _v in pairs)
                       if t is not None})
        self.wal.append(("raw", self._slot, ts, pairs, tids),
                        commit_ts=ts)

    def raw_delete_range(self, start: bytes, end: bytes):
        super().raw_delete_range(start, end)
        self._poison_range(start, end)
        # ts-stamped so BR's backup-ts tail filter excludes a delete
        # that raced PAST the backup snapshot (its rows are in the
        # backup; replaying the delete would erase backed-up data)
        self.wal.append(("rawdel", self._slot, self.tso.next_ts(),
                         start, end))

    # -- committed-delta ring (versioned result cache fold source) ------------

    def _note_delta(self, commit_ts: int, keys):
        """Record which row keys a committed mutation touched, per
        table.  Only record keys are kept (index keys re-derive from
        the row); every tid seen in ``keys`` marks ``commit_ts`` noted
        so the matching :meth:`bump_table_version` knows the ring
        covers that advance."""
        if not commit_ts:
            return
        from .. import tablecodec
        by_tid: "dict[int, list]" = {}
        for k in keys:
            tid = _table_id_of(k)
            if tid is None:
                continue
            lst = by_tid.setdefault(tid, [])
            if len(k) >= 19 and k[9:11] == tablecodec.RECORD_SEP:
                lst.append(k)
        if not by_tid:
            return
        with self._delta_mu:
            for tid, ks in by_tid.items():
                ring = self._delta_ring.get(tid)
                if ring is None:
                    ring = self._delta_ring[tid] = deque()
                    # completeness starts here: commit timestamps are
                    # unique, so (commit_ts - 1, commit_ts] holds only
                    # this commit — but never lift an earlier poison
                    self._delta_floor[tid] = max(
                        commit_ts - 1, self._delta_floor.get(tid, 0))
                ring.append((commit_ts, tuple(ks)))
                while len(ring) > DELTA_RING_CAP:
                    old_ts, _old = ring.popleft()
                    self._delta_floor[tid] = max(
                        self._delta_floor[tid], old_ts)
                noted = self._delta_noted.setdefault(tid, set())
                noted.add(commit_ts)
                if len(noted) > 1024:
                    # unconsumed ts leak only from bump-less raw writes;
                    # clearing risks one spurious poison, which merely
                    # costs a full recompute
                    noted.clear()

    def bump_table_version(self, table_id: int, commit_ts: int = 0) -> int:
        """Local watermark bump + fleet publication: every advance lands
        in the segment's table-version vector so stamped cache pages on
        EVERY worker invalidate.  An advance the delta ring never noted
        (DDL reorg, BR restore, a rollback unwind) poisons folds across
        it — the data changed through a path the ring cannot replay."""
        v = super().bump_table_version(table_id, commit_ts)
        if table_id is None or table_id <= 0:
            return v
        noted = False
        with self._delta_mu:
            s = self._delta_noted.get(table_id)
            if s is not None and commit_ts in s:
                s.discard(commit_ts)
                noted = True
        ts = commit_ts
        if not ts:
            with contextlib.suppress(Exception):
                ts = self.tso.next_ts()
        if not noted and ts:
            with self._delta_mu:
                self._delta_floor[table_id] = max(
                    self._delta_floor.get(table_id, 0), ts)
        if ts and self._coord is not None:
            with contextlib.suppress(Exception):
                self._coord.table_version_advance([(table_id, ts)])
        return v

    def _poison_range(self, start: bytes, end: bytes):
        """A range delete cannot say which committed rows it removed:
        kill fold eligibility for whatever it may cover (one ring for a
        same-table range, everything for a cross-table one)."""
        tid_a, tid_b = _table_id_of(start), _table_id_of(end)
        ts = 0
        with contextlib.suppress(Exception):
            ts = self.tso.next_ts()
        if not ts:
            return
        with self._delta_mu:
            if tid_a is not None and tid_a == tid_b:
                self._delta_floor[tid_a] = max(
                    self._delta_floor.get(tid_a, 0), ts)
            else:
                self._delta_min_after = max(self._delta_min_after, ts)

    def _unwindable(self, keys, start_ts: int) -> "list[bytes]":
        """Keys holding a COMMITTED version stamped ``start_ts`` — the
        set a commit-then-rollback unwind will actually regress."""
        out = []
        with self._lock:
            for key in keys:
                chain = self.map.vals.get(key)
                if chain and any(v[1] == start_ts and v[2] != OP_ROLLBACK
                                 for v in chain):
                    out.append(key)
        return out

    def delta_keys_since(self, table_id: int, after_ts: int,
                         upto_ts: int) -> "list[bytes] | None":
        """Row keys committed to ``table_id`` in (after_ts, upto_ts] —
        the fold set for a versioned cache hit at a newer version — or
        None when the ring cannot PROVE completeness for that range:
        entries evicted past ``after_ts``, an un-noted advance poisoned
        the table, the range predates this boot's replay, or our
        replica has not applied through ``upto_ts`` yet.  None always
        means "recompute from scratch", never "no delta rows"."""
        if after_ts >= upto_ts:
            return []
        with self._lock:
            applied_ts = self.table_version_ts.get(table_id, 0)
        if applied_ts < upto_ts:
            return None
        with self._delta_mu:
            if after_ts < self._delta_min_after:
                return None
            ring = self._delta_ring.get(table_id)
            if ring is None:
                return None
            if after_ts < self._delta_floor.get(table_id, 1 << 62):
                return None
            out: "list[bytes]" = []
            for ts, ks in ring:
                if after_ts < ts <= upto_ts:
                    out.extend(ks)
            return out

    # -- introspection --------------------------------------------------------

    def wal_status(self) -> dict:
        return {"applied_lsn": self._applied_lsn,
                "end_lsn": self.wal.end_lsn(),
                "base_lsn": self.wal.base_lsn,
                "slot": self._slot,
                "fleet": self._coord is not None,
                "lock_degrades": self._lock_degrades,
                "fsync_policy": self.wal.fsync_policy(),
                "frontier_ts": self._frontier_ts,
                "frontier_lsn": self._frontier_lsn,
                "stale_reads": self._stale_reads,
                "last_stale_reason": self._last_stale_reason}


# -- construction -------------------------------------------------------------

def open_durable_mvcc(wal_dir: str) -> DurableMVCCStore:
    """Build (and recover) the durable engine for this process.  Fleet
    context (coordinator + slot) is taken from fabric/state when a
    worker activated it; otherwise the store is solo-durable."""
    from ..fabric import state as fabric_state
    coordinator = fabric_state.coordinator()
    slot = fabric_state.slot() if coordinator is not None else -1
    w = wal_mod.WAL(wal_dir, coordinator=coordinator)
    oracle = (SegmentTSOracle(coordinator)
              if coordinator is not None else None)
    eng = DurableMVCCStore(w, coordinator=coordinator, slot=slot,
                           oracle=oracle)
    eng.recover()
    if coordinator is not None:
        eng.start_tailer()
    return eng


@contextlib.contextmanager
def store_init_lock(wal_dir: str):
    """Cross-process serialization of [open store → recover → bootstrap
    → seed]: the first worker in pays the genesis writes, later workers
    replay them from the log and skip (fabric/worker.py)."""
    os.makedirs(wal_dir, exist_ok=True)
    f = open(os.path.join(wal_dir, "init.lock"), "a+b")  # noqa: SIM115
    try:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    finally:
        f.close()
