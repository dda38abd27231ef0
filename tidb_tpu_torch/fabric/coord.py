"""The fleet coordination segment: one shared-memory block + a tiny
lease-stamped coordinator file, giving N serving processes a common view
of admission state, tenant budgets and in-flight fragment dedup.

Why shared memory and not a coordination service: the hot operations are
admission-rate (one per device fragment) — a socket round trip per
admission would put a second serving queue in front of the scheduler.
A pinned struct layout over ``multiprocessing.shared_memory`` plus an
``fcntl.flock`` critical section costs ~a syscall pair per operation and
survives any worker's death: the flock drops with the process, and the
lease stamps let survivors reclaim the dead slot's counters.

Layout (little-endian, fixed offsets — no allocation after create):

    HEADER    magic, nslots, ntenants, ndedup, created
    COUNTERS  fleet-global u64 counters (dedup hits/leads/timeouts,
              lease reclaims, respawns, prewarm dedup, result-id seq)
              plus the durable-store CELLS: the fleet TSO high-water
              (``_tso`` — batched leases make every worker's timestamps
              fleet-monotonic), the published schema version
              (``_schema_ver`` — the schema-lease propagation cell) and
              the committed WAL length (``_wal_len`` — appenders
              truncate any torn garbage a SIGKILLed writer left past it
              before writing, and tailers never read beyond it)
    SLOTS     per-worker lease: pid, lease_ts, generation, plus the
              slot's MIN READ TS (oldest live snapshot — the fleet GC
              floor) and its APPLIED WAL LSN (how far its replica
              tailed — the log-truncation floor)
    TENANTS   per-tenant row: name, WFQ virtual clock, peak running,
              running[slot] and hbm_bytes[slot] COLUMNS — per-slot
              attribution is what makes crash reclaim exact: zeroing a
              dead slot's column cannot touch a survivor's counts
    DEDUP     fragment result-cache slots: key hash, state, owner slot,
              timestamp, result page id and the VERSION-VECTOR hash the
              page was computed under (0 = unversioned in-flight dedup).
              A versioned hit requires the claimant's current version-
              vector hash to match; a mismatch invalidates the entry and
              hands the claimant the OLD page id so it can fold only the
              delta since the cached version (dedup_claim "lead_delta")
    LOCKS     the shared 2PC lock/primary table (kv/shared_store.py):
              key-HASH entries stamped (start_ts, owner slot) make
              cross-worker write-write conflict detection synchronous —
              a prewrite claims here BEFORE its local checks, so two
              workers can never prewrite the same key concurrently; a
              dead slot's claims are freed by lease reclaim (the data
              locks themselves are resolved by WAL recovery)
    REGIONS   per-region ownership rows (fabric/region.py): epoch,
              owner slot (+1; 0 = unowned), lease_ts, committed WAL
              length and applied LSN — the per-region mirror of the
              global ``_wal_len``/slot cells.  The EPOCH is the fencing
              token: it bumps on every claim, every committed-length
              write carries it, and a stale epoch's write is rejected —
              a zombie host's appender can never land bytes in a region
              that failed over behind its back
    TABLEVERS per-table fleet version cells: (table id, version ts) —
              the CURRENT fleet version of each table, advanced forward-
              only (max) on every committed write by the committing
              worker and re-published by every tailer as it applies the
              log (a coordinator down-window on the writer is repaired
              by the first survivor to tail the record).  The result
              cache stamps pages with these and a hit requires every
              referenced table's cell to still match
    FRONTIERS per-slot committed-frontier cells: (frontier_ts,
              frontier_lsn) — the max commit_ts the slot's appender has
              made durable and the log length covering it.  Snapshot
              begin waits until the local applied LSN covers every live
              origin's frontier <= its ts: the fleet-wide
              snapshot-isolation fence (kv/shared_store.py)
    DDL       the single fleet DDL owner cell (epoch, owner+1,
              lease_ts): the region-ownership shape applied to the DDL
              job queue — one epoch-fenced owner at a time, failover by
              lease expiry, a deposed owner's commit fails the fence

Every mutation happens under the sidecar lock file (``<path>.lock``,
``fcntl.flock``) plus an in-process mutex (flock is per open file
description, so two THREADS of one process sharing the fd would not
exclude each other).  Lock order: callers holding subsystem locks
(scheduler._LOCK, the residency ledger lock) may take the segment lock;
the segment layer never calls back out, so no cycle can form.

The coordinator FILE is the discovery root: it names the segment and the
result-page directory, so any process (workers, the parent, a bench
verifier) can ``attach`` by path alone.  Invariant (chaos-asserted,
:meth:`Coordinator.verify_drained`): once the fleet drains, no lease is
live, every per-tenant running count is zero and no dedup slot is stuck
``building`` — a crashed worker's contributions are reclaimed by lease
expiry, never leaked.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import logging
import os
import secrets
import struct
import threading
import time
from multiprocessing import shared_memory

log = logging.getLogger("tidb_tpu_torch.fabric.coord")

MAGIC = b"TPUFAB5\0"

#: segment geometry defaults (fixed at create; attach reads them from the
#: coordinator file)
NSLOTS_DEFAULT = 16
NTENANTS_DEFAULT = 48
NDEDUP_DEFAULT = 128
NLOCKS_DEFAULT = 256
#: regions default to 0: a single-host fleet pays nothing for the
#: section, and a region-sharded one sizes it explicitly at create
NREGIONS_DEFAULT = 0
#: per-table version cells; a fleet serving more distinct tables than
#: this simply stops version-stamping the overflow (cache-ineligible,
#: never stale)
NTABLEVERS_DEFAULT = 256
#: fragment performance-store rows: keyed
#: (fragment sig hash, row bucket, backend, duration kind); a full
#: table drops the overflow (counted fabric_perf_dropped) — the store
#: observes, it must never become a serving bottleneck or a leak
NPERF_DEFAULT = 512

#: fleet-global counter names, in segment order
COUNTER_NAMES = (
    "fabric_dedup_hits",        # follower served from a leader's page
    "fabric_dedup_leads",       # fragments that led a dedup slot
    "fabric_dedup_timeouts",    # waits that gave up and computed locally
    "fabric_lease_reclaims",    # dead-slot reclaims (leases expired)
    "fabric_respawns",          # parent worker respawns
    "fabric_prewarm_dedup",     # prewarm submissions skipped fleet-wide
    "fabric_cache_hits",        # version-stamped result-cache hits
    "fabric_cache_invalidations",  # cached pages dropped on version advance
    "fabric_cache_delta_folds",    # hits served by folding the WAL delta
    "fabric_cache_stale_reads",    # version-stale pages caught at serve
    "fabric_admissions",        # device admissions granted fleet-wide
    "fabric_perf_dropped",      # perf samples dropped (store full)
    "_result_id_seq",           # monotonic dedup result-page id
    "_tso",                     # fleet TSO high-water (batched leases)
    "_schema_ver",              # published schema version (schema lease)
    "_wal_len",                 # committed WAL length (torn-tail fence)
)

#: dedup slot states
DFREE, DBUILDING, DDONE, DFAILED = 0, 1, 2, 3

#: a building dedup entry whose leader lease is older than this is
#: considered abandoned (leader crashed mid-build) and can be taken over
BUILD_LEASE_S = 10.0

_HDR = struct.Struct("<8sIIIId")                         # + created f64
_SLOT = struct.Struct("<QdQQQ")                          # pid, lease, gen,
#                                                          min_read_ts,
#                                                          wal_applied
_DED = struct.Struct("<16sIIdQQ")                        # hash,state,owner,ts,
#                                                          rid, vv_hash
_TEN_FIXED = struct.Struct("<40sdII")                    # name,vtime,peak,pad
_LCK = struct.Struct("<16sQId")                          # hash,start_ts,slot,ts
_REG = struct.Struct("<QQdQQ")                           # epoch, owner+1,
#                                                          lease_ts,
#                                                          committed_len,
#                                                          applied_lsn
_TVER = struct.Struct("<QQ")                             # table_id, version_ts
#: per-slot committed-frontier cell: the max commit_ts this slot's WAL
#: appender has made DURABLE (fsync-acked) and the log length that
#: covers it.  Readers wait until their local applied LSN reaches every
#: live origin's frontier_lsn whose frontier_ts <= their snapshot ts —
#: the fleet-wide snapshot-isolation fence
_FRONT = struct.Struct("<QQ")                            # frontier_ts,
#                                                          frontier_lsn
#: the single fleet DDL owner cell: epoch, owner slot (+1; 0 = unowned),
#: lease_ts — the region-ownership shape applied to the DDL job queue,
#: replacing serialize-by-conflict with an epoch-fenced lease
_DDL = struct.Struct("<QQd")
#: perf-store row: sig_hash, bucket, backend, kind, count, sum_s, max_s,
#: 16-bucket log2 duration sketch.  A row is FREE iff count == 0.
#: Crash-safety is by construction, not by reclaim: every update is one
#: commutative merge under the segment lock (no per-slot intermediate
#: state a dead worker could leak — unlike running counts, a crashed
#: worker's already-merged samples are real measurements and stay)
_PERF = struct.Struct("<QIIIQdd16I")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

#: perf sketch geometry: bucket i counts durations <= PERF_BASE_S * 2**i
#: (i = 15 is the +Inf tail).  100µs .. ~3.3s in 16 power-of-two steps —
#: spans admission waits through live-TPU compiles
PERF_BASE_S = 1e-4
PERF_SKETCH_N = 16

_NAME_SZ = 40


class Coordinator:
    """One attached view of the fleet coordination segment."""

    def __init__(self, path: str, shm, meta: dict, created: bool):
        self.path = path
        self._shm = shm
        self._buf = shm.buf
        self.nslots = meta["nslots"]
        self.ntenants = meta["ntenants"]
        self.ndedup = meta["ndedup"]
        self.nlocks = meta.get("nlocks", NLOCKS_DEFAULT)
        self.nregions = meta.get("nregions", NREGIONS_DEFAULT)
        self.ntablevers = meta.get("ntablevers", NTABLEVERS_DEFAULT)
        self.nperf = meta.get("nperf", NPERF_DEFAULT)
        self.pages_dir = meta["pages_dir"]
        self._created = created
        self._tlock = threading.Lock()
        self._lockf = open(path + ".lock", "a+b")  # noqa: SIM115 (held open)
        # offsets
        self._o_counters = _HDR.size
        self._o_slots = self._o_counters + 8 * len(COUNTER_NAMES)
        self._o_tenants = self._o_slots + self.nslots * _SLOT.size
        self._ten_sz = (_TEN_FIXED.size + 4 * self.nslots
                        + 8 * self.nslots)
        self._o_dedup = self._o_tenants + self.ntenants * self._ten_sz
        self._o_locks = self._o_dedup + self.ndedup * _DED.size
        self._o_regions = self._o_locks + self.nlocks * _LCK.size
        self._o_tvers = self._o_regions + self.nregions * _REG.size
        # per-slot direct-port cells (u64): each worker publishes its
        # diagnostics door so peers can fan cluster memtables out to it
        self._o_ports = self._o_tvers + self.ntablevers * _TVER.size
        # per-slot committed-frontier cells + the fleet DDL owner cell
        self._o_front = self._o_ports + self.nslots * 8
        self._o_ddl = self._o_front + self.nslots * _FRONT.size
        self._o_perf = self._o_ddl + _DDL.size
        self.size = self._o_perf + self.nperf * _PERF.size

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, path: str, nslots: int = NSLOTS_DEFAULT,
               ntenants: int = NTENANTS_DEFAULT,
               ndedup: int = NDEDUP_DEFAULT,
               nlocks: int = NLOCKS_DEFAULT,
               nregions: int = NREGIONS_DEFAULT,
               ntablevers: int = NTABLEVERS_DEFAULT,
               nperf: int = NPERF_DEFAULT,
               pages_dir: "str | None" = None) -> "Coordinator":
        """Create the segment + coordinator file (the fleet parent)."""
        if pages_dir is None:
            pages_dir = path + ".pages"
        os.makedirs(pages_dir, exist_ok=True)
        name = f"torchfab-{os.getpid()}-{secrets.token_hex(4)}"
        meta = {"segment": name, "nslots": nslots, "ntenants": ntenants,
                "ndedup": ndedup, "nlocks": nlocks, "nregions": nregions,
                "ntablevers": ntablevers, "nperf": nperf,
                "pages_dir": pages_dir, "created": time.time()}
        size = (_HDR.size + 8 * len(COUNTER_NAMES) + nslots * _SLOT.size
                + ntenants * (_TEN_FIXED.size + 12 * nslots)
                + ndedup * _DED.size + nlocks * _LCK.size
                + nregions * _REG.size + ntablevers * _TVER.size
                + nslots * 8 + nslots * _FRONT.size + _DDL.size
                + nperf * _PERF.size)
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        _untrack(shm)
        shm.buf[:size] = b"\0" * size
        _HDR.pack_into(shm.buf, 0, MAGIC, nslots, ntenants, ndedup, 0,
                       meta["created"])
        tmp = path + f".{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)
        return cls(path, shm, meta, created=True)

    @classmethod
    def attach(cls, path: str) -> "Coordinator":
        """Attach to an existing segment by coordinator-file path."""
        with open(path) as f:
            meta = json.load(f)
        shm = shared_memory.SharedMemory(name=meta["segment"])
        _untrack(shm)
        if bytes(shm.buf[:8]) != MAGIC:
            shm.close()
            raise ValueError(f"{path}: segment {meta['segment']} has no "
                             "fabric magic (stale coordinator file?)")
        return cls(path, shm, meta, created=False)

    def close(self):
        try:
            self._buf = None
            self._shm.close()
        finally:
            with contextlib.suppress(Exception):
                self._lockf.close()

    def unlink(self):
        """Destroy the segment + coordinator file (parent, at shutdown).
        Raw shm_unlink, not SharedMemory.unlink(): every attachment was
        untracked (see _untrack), so the tracker holds no entry for its
        unregister call to find."""
        name = self._shm._name
        self.close()
        with contextlib.suppress(Exception):
            shared_memory._posixshmem.shm_unlink(name)
        for p in (self.path, self.path + ".lock"):
            with contextlib.suppress(OSError):
                os.remove(p)
        # every remaining result page goes with the segment (pages that
        # expired in place were GC'd at slot reuse; this is the tail)
        with contextlib.suppress(OSError):
            for f in os.listdir(self.pages_dir):
                if f.startswith("dedup-"):
                    with contextlib.suppress(OSError):
                        os.remove(os.path.join(self.pages_dir, f))
            os.rmdir(self.pages_dir)

    @contextlib.contextmanager
    def _locked(self):
        with self._tlock:
            fcntl.flock(self._lockf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(self._lockf, fcntl.LOCK_UN)

    # -- counters ------------------------------------------------------------

    def _ctr_off(self, name: str) -> int:
        return self._o_counters + 8 * COUNTER_NAMES.index(name)

    def bump(self, name: str, n: int = 1) -> int:
        with self._locked():
            return self._bump_locked(name, n)

    def _bump_locked(self, name: str, n: int = 1) -> int:
        off = self._ctr_off(name)
        v = _U64.unpack_from(self._buf, off)[0] + n
        _U64.pack_into(self._buf, off, v)
        return v

    def counters(self) -> dict:
        with self._locked():
            return {name: _U64.unpack_from(self._buf, self._ctr_off(name))[0]
                    for name in COUNTER_NAMES if not name.startswith("_")}

    # -- worker slots / leases -----------------------------------------------

    def _slot_off(self, slot: int) -> int:
        if not 0 <= slot < self.nslots:
            raise IndexError(f"slot {slot} out of range 0..{self.nslots - 1}")
        return self._o_slots + slot * _SLOT.size

    def claim_slot(self, slot: int, pid: "int | None" = None):
        """A worker takes its slot: stamps pid + lease, bumps the
        incarnation generation, and zeroes any leftovers from a previous
        incarnation (self-reclaim on respawn)."""
        pid = pid if pid is not None else os.getpid()
        with self._locked():
            off = self._slot_off(slot)
            _pid, _lease, gen, _mrt, _wa = _SLOT.unpack_from(self._buf, off)
            self._zero_slot_columns_locked(slot)
            self._drop_slot_published_locked(slot)
            _SLOT.pack_into(self._buf, off, pid, time.time(), gen + 1, 0, 0)

    def heartbeat(self, slot: int):
        with self._locked():
            off = self._slot_off(slot)
            pid, _lease, gen, mrt, wa = _SLOT.unpack_from(self._buf, off)
            if pid:
                _SLOT.pack_into(self._buf, off, pid, time.time(), gen,
                                mrt, wa)

    def release_slot(self, slot: int):
        """Clean worker exit: drop the lease and every per-slot count."""
        with self._locked():
            self._zero_slot_columns_locked(slot)
            self._drop_slot_published_locked(slot)
            _SLOT.pack_into(self._buf, self._slot_off(slot), 0, 0.0, 0,
                            0, 0)

    def live_slots(self, lease_timeout_s: float = 2.0) -> list:
        now = time.time()
        with self._locked():
            out = []
            for s in range(self.nslots):
                pid, lease = _SLOT.unpack_from(
                    self._buf, self._slot_off(s))[:2]
                if pid and now - lease <= lease_timeout_s:
                    out.append(s)
            return out

    def set_direct_port(self, slot: int, port: int):
        """Publish a worker's DIRECT (per-process) wire port — the
        diagnostics door cluster memtables fan out to.  Zeroed whenever
        the slot's lease drops (release/reclaim/re-claim): a dead
        worker's port must read as absent, never as a connectable peer."""
        with self._locked():
            self._slot_off(slot)  # range check
            _U64.pack_into(self._buf, self._o_ports + 8 * slot, int(port))

    def direct_ports(self, lease_timeout_s: float = 2.0) -> dict:
        """{slot: direct_port} for every LIVE slot that has published
        one (a worker between claim and publish is simply absent)."""
        now = time.time()
        with self._locked():
            out = {}
            for s in range(self.nslots):
                pid, lease = _SLOT.unpack_from(
                    self._buf, self._slot_off(s))[:2]
                if not pid or now - lease > lease_timeout_s:
                    continue
                port = _U64.unpack_from(self._buf,
                                        self._o_ports + 8 * s)[0]
                if port:
                    out[s] = port
            return out

    def reclaim_expired(self, lease_timeout_s: float = 2.0) -> int:
        """Reclaim every slot whose lease lapsed: zero its running/HBM
        columns (no orphaned WFQ weight or tenant running-cap leak), free
        its building dedup slots, drop the lease.  Any process may call
        this — the parent does on child death, workers do periodically."""
        now = time.time()
        n = 0
        with self._locked():
            for s in range(self.nslots):
                off = self._slot_off(s)
                pid, lease = _SLOT.unpack_from(self._buf, off)[:2]
                if pid and now - lease > lease_timeout_s:
                    self._zero_slot_columns_locked(s)
                    self._drop_slot_published_locked(s)
                    _SLOT.pack_into(self._buf, off, 0, 0.0, 0, 0, 0)
                    self._bump_locked("fabric_lease_reclaims")
                    n += 1
        return n

    def _zero_slot_columns_locked(self, slot: int):
        for t in range(self.ntenants):
            base = self._o_tenants + t * self._ten_sz
            name = bytes(self._buf[base:base + _NAME_SZ]).rstrip(b"\0")
            if not name:
                continue
            _U32.pack_into(self._buf, base + _TEN_FIXED.size + 4 * slot, 0)
            _U64.pack_into(self._buf, base + _TEN_FIXED.size
                           + 4 * self.nslots + 8 * slot, 0)
        for d in range(self.ndedup):
            off = self._o_dedup + d * _DED.size
            h, state, owner, ts, rid, vv = _DED.unpack_from(self._buf, off)
            if state == DBUILDING and owner == slot:
                _DED.pack_into(self._buf, off, h, DFAILED, owner, ts,
                               rid, vv)
        # free the dead slot's shared 2PC lock claims: the DATA locks
        # (the replicas' prewrite locks) are resolved by WAL recovery via
        # their primary; the claim entries only serialize live prewrites
        for i in range(self.nlocks):
            off = self._o_locks + i * _LCK.size
            h, start_ts, owner, _ts = _LCK.unpack_from(self._buf, off)
            if start_ts and owner == slot:
                _LCK.pack_into(self._buf, off, b"\0" * 16, 0, 0, 0.0)

    def _drop_slot_published_locked(self, slot: int):
        """Zero the slot's published cells on any lease transition
        (claim/release/reclaim): the direct port (a dead worker must not
        read as a connectable peer), the commit frontier (a dead origin
        must stop gating fleet reads — its durable records are already
        behind the committed WAL length), and its DDL ownership (the
        epoch stays: monotonic for the cell's lifetime, so a reclaimed
        owner's in-flight job fails the epoch fence at commit)."""
        _U64.pack_into(self._buf, self._o_ports + 8 * slot, 0)
        _FRONT.pack_into(self._buf, self._o_front + slot * _FRONT.size,
                         0, 0)
        epoch, owner_p1, _lease = _DDL.unpack_from(self._buf, self._o_ddl)
        if owner_p1 == slot + 1:
            _DDL.pack_into(self._buf, self._o_ddl, epoch, 0, 0.0)

    # -- tenants -------------------------------------------------------------

    def _ten_name(self, t: int) -> bytes:
        base = self._o_tenants + t * self._ten_sz
        return bytes(self._buf[base:base + _NAME_SZ]).rstrip(b"\0")

    def _tenant_idx_locked(self, group: str, alloc: bool) -> int:
        key = group.encode("utf-8")[:_NAME_SZ - 1]
        free = -1
        for t in range(self.ntenants):
            name = self._ten_name(t)
            if name == key:
                return t
            if not name and free < 0:
                free = t
        if not alloc:
            return -1
        if free < 0:
            return -1  # table full: callers fall back to local-only state
        base = self._o_tenants + free * self._ten_sz
        _TEN_FIXED.pack_into(self._buf, base, key, 0.0, 0, 0)
        return free

    def _run_off(self, t: int, slot: int) -> int:
        return (self._o_tenants + t * self._ten_sz + _TEN_FIXED.size
                + 4 * slot)

    def _hbm_off(self, t: int, slot: int) -> int:
        return (self._o_tenants + t * self._ten_sz + _TEN_FIXED.size
                + 4 * self.nslots + 8 * slot)

    def _running_total_locked(self, t: int) -> int:
        return sum(_U32.unpack_from(self._buf, self._run_off(t, s))[0]
                   for s in range(self.nslots))

    # admission: fleet-wide per-tenant running caps --------------------------

    def try_acquire_running(self, slot: int, group: str,
                            cap: int) -> bool:
        """Atomically check the FLEET-wide running count of `group`
        against `cap` and charge one fragment to `slot` when under it.
        cap <= 0 means unlimited (still counted, for gauges)."""
        with self._locked():
            t = self._tenant_idx_locked(group, alloc=True)
            if t < 0:
                return True  # tenant table full: degrade to local caps
            total = self._running_total_locked(t)
            if cap > 0 and total >= cap:
                return False
            off = self._run_off(t, slot)
            _U32.pack_into(self._buf, off,
                           _U32.unpack_from(self._buf, off)[0] + 1)
            base = self._o_tenants + t * self._ten_sz
            _n, vt, peak, pad = _TEN_FIXED.unpack_from(self._buf, base)
            if total + 1 > peak:
                _TEN_FIXED.pack_into(self._buf, base, _n, vt, total + 1,
                                     pad)
            return True

    def release_running(self, slot: int, group: str):
        with self._locked():
            t = self._tenant_idx_locked(group, alloc=False)
            if t < 0:
                return
            off = self._run_off(t, slot)
            cur = _U32.unpack_from(self._buf, off)[0]
            if cur > 0:
                _U32.pack_into(self._buf, off, cur - 1)

    def running_total(self, group: str) -> int:
        with self._locked():
            t = self._tenant_idx_locked(group, alloc=False)
            return self._running_total_locked(t) if t >= 0 else 0

    def peak_running(self, group: str) -> int:
        with self._locked():
            t = self._tenant_idx_locked(group, alloc=False)
            if t < 0:
                return 0
            base = self._o_tenants + t * self._ten_sz
            return _TEN_FIXED.unpack_from(self._buf, base)[2]

    # WFQ virtual clocks ------------------------------------------------------

    def vtimes(self, groups) -> dict:
        """The fleet virtual clocks for `groups` (0.0 for unknown)."""
        with self._locked():
            out = {}
            for g in groups:
                t = self._tenant_idx_locked(g, alloc=False)
                if t < 0:
                    out[g] = 0.0
                else:
                    base = self._o_tenants + t * self._ten_sz
                    out[g] = _TEN_FIXED.unpack_from(self._buf, base)[1]
            return out

    def vtime_advance(self, group: str, delta: float,
                      floor: float = 0.0) -> float:
        """One WFQ grant: the tenant's fleet clock advances by `delta`
        (1/weight) from max(current, floor) — the same floor re-entry
        rule as the in-process scheduler, but against the clock every
        process shares, so a tenant flooding process A is charged the
        virtual time its grants on A consumed when it next competes on
        process B."""
        with self._locked():
            t = self._tenant_idx_locked(group, alloc=True)
            if t < 0:
                return 0.0
            base = self._o_tenants + t * self._ten_sz
            name, vt, peak, pad = _TEN_FIXED.unpack_from(self._buf, base)
            vt = max(vt, floor) + delta
            _TEN_FIXED.pack_into(self._buf, base, name, vt, peak, pad)
            return vt

    # per-tenant HBM charges --------------------------------------------------

    def charge_hbm(self, slot: int, group: str, delta: int):
        """Publish a residency-ledger delta for (slot, group) — the
        fleet-visible mirror of the in-process per-group byte counts."""
        with self._locked():
            t = self._tenant_idx_locked(group, alloc=True)
            if t < 0:
                return
            off = self._hbm_off(t, slot)
            cur = _U64.unpack_from(self._buf, off)[0]
            _U64.pack_into(self._buf, off, max(cur + delta, 0))

    def hbm_remote_bytes(self, group: str, exclude_slot: int) -> int:
        """Bytes `group` holds resident in OTHER workers' ledgers."""
        with self._locked():
            t = self._tenant_idx_locked(group, alloc=False)
            if t < 0:
                return 0
            return sum(
                _U64.unpack_from(self._buf, self._hbm_off(t, s))[0]
                for s in range(self.nslots) if s != exclude_slot)

    # -- durable shared store (kv/wal.py + kv/shared_store.py) ----------------

    def tso_lease(self, n: int, floor: int = 0) -> tuple:
        """Allocate a batch of ``n`` fleet-monotonic timestamps: returns
        ``(base, base + n]`` — the caller hands them out locally without
        touching the segment again.  ``floor`` keeps the counter
        wall-clock anchored (the hybrid physical part), so GC's
        now-based safepoint arithmetic stays meaningful."""
        with self._locked():
            off = self._ctr_off("_tso")
            base = max(_U64.unpack_from(self._buf, off)[0], floor)
            _U64.pack_into(self._buf, off, base + n)
            return (base, base + n)

    def publish_schema_version(self, version: int) -> int:
        """Forward-only schema-version cell (the fleet schema lease):
        a DDL commit publishes here; workers whose local infoschema lags
        reload before serving, and a commit planned against an older
        version fails retriably (ErrInfoSchemaChanged)."""
        with self._locked():
            off = self._ctr_off("_schema_ver")
            cur = _U64.unpack_from(self._buf, off)[0]
            if version > cur:
                _U64.pack_into(self._buf, off, version)
                return version
            return cur

    def schema_version(self) -> int:
        with self._locked():
            return _U64.unpack_from(
                self._buf, self._ctr_off("_schema_ver"))[0]

    def wal_len(self) -> int:
        with self._locked():
            return _U64.unpack_from(self._buf, self._ctr_off("_wal_len"))[0]

    def set_wal_len(self, n: int):
        with self._locked():
            _U64.pack_into(self._buf, self._ctr_off("_wal_len"), n)

    def set_min_read_ts(self, slot: int, ts: int):
        """Publish this worker's oldest live snapshot ts (0 = none): the
        fleet GC safepoint floors at the minimum over live slots, so GC
        on any worker can never drop a version a sibling still reads."""
        with self._locked():
            off = self._slot_off(slot)
            pid, lease, gen, _mrt, wa = _SLOT.unpack_from(self._buf, off)
            if pid:
                _SLOT.pack_into(self._buf, off, pid, lease, gen,
                                max(int(ts), 0), wa)

    def fleet_min_read_ts(self, lease_timeout_s: float = 2.0) -> int:
        """min over LIVE slots' nonzero min-read-ts columns (0 = no
        reader pins the floor anywhere in the fleet)."""
        now = time.time()
        with self._locked():
            best = 0
            for s in range(self.nslots):
                pid, lease, _g, mrt, _wa = _SLOT.unpack_from(
                    self._buf, self._slot_off(s))
                if pid and now - lease <= lease_timeout_s and mrt:
                    best = mrt if not best else min(best, mrt)
            return best

    def set_wal_applied(self, slot: int, lsn: int):
        with self._locked():
            off = self._slot_off(slot)
            pid, lease, gen, mrt, _wa = _SLOT.unpack_from(self._buf, off)
            if pid:
                _SLOT.pack_into(self._buf, off, pid, lease, gen, mrt,
                                int(lsn))

    def min_wal_applied(self) -> "int | None":
        """The truncation floor: the smallest applied-LSN over every
        CLAIMED slot (pid stamped), or None when none is claimed.  A
        stalled-but-alive worker (lease momentarily old — a GIL-holding
        compile) still holds its slot, and truncating past its applied
        frontier would leave it permanently missing the records only
        the checkpoint now holds; a genuinely dead worker's slot is
        reclaimed (pid zeroed) and stops gating truncation then."""
        with self._locked():
            vals = []
            for s in range(self.nslots):
                pid, _lease, _g, _mrt, wa = _SLOT.unpack_from(
                    self._buf, self._slot_off(s))
                if pid:
                    vals.append(wa)
            return min(vals) if vals else None

    # the shared 2PC lock/primary table ---------------------------------------

    def _lck_off(self, i: int) -> int:
        return self._o_locks + i * _LCK.size

    def lock_claim(self, hashes, start_ts: int, slot: int) -> tuple:
        """All-or-nothing claim of key-hash entries for ``start_ts``.
        Returns ``(0, -1)`` on success, ``(holder_start_ts, idx)`` on a
        conflict with a foreign claim (idx = position in ``hashes``; the
        caller raises LockedError and walks the normal lock-wait
        ladder), or ``(-1, -1)`` when the table is too full to claim
        (the caller degrades to local-only conflict detection, the same
        graceful shape as a full tenant table)."""
        want = list(hashes)
        if not self.nlocks:
            return (-1, -1)
        with self._locked():
            by_hash = {}
            free = []
            for i in range(self.nlocks):
                off = self._lck_off(i)
                h, sts, owner, _ts = _LCK.unpack_from(self._buf, off)
                if sts:
                    by_hash[h] = sts
                else:
                    free.append(i)
            need = []
            for idx, h in enumerate(want):
                held = by_hash.get(h)
                if held is not None:
                    if held != start_ts:
                        return (held, idx)  # conflict: foreign claim
                    continue                # ours already (pessimistic)
                need.append(h)
            if len(need) > len(free):
                return (-1, -1)
            now = time.time()
            for h, i in zip(need, free):
                _LCK.pack_into(self._buf, self._lck_off(i), h,
                               start_ts, slot, now)
            return (0, -1)

    def lock_release(self, start_ts: int, hashes=None):
        """Free entries claimed by ``start_ts`` — all of them
        (commit/rollback), or only ``hashes`` (a failed claim batch of a
        txn that still holds earlier pessimistic claims)."""
        only = None if hashes is None else set(hashes)
        with self._locked():
            for i in range(self.nlocks):
                off = self._lck_off(i)
                h, sts, _owner, _ts = _LCK.unpack_from(self._buf, off)
                if sts == start_ts and (only is None or h in only):
                    _LCK.pack_into(self._buf, off, b"\0" * 16, 0, 0, 0.0)

    # -- per-origin committed frontiers (kv/shared_store.py reads) ------------

    def set_commit_frontier(self, slot: int, ts: int, lsn: int):
        """Publish this slot's durable commit frontier: the max commit_ts
        its appender has fsync-acked and the log length covering it.
        Forward-only and pid-guarded — a reclaimed slot's late publish
        (a zombie appender's final fsync) must not resurrect a gate the
        reclaim already dropped."""
        with self._locked():
            off = self._slot_off(slot)
            if not _SLOT.unpack_from(self._buf, off)[0]:
                return
            foff = self._o_front + slot * _FRONT.size
            cur_ts, cur_lsn = _FRONT.unpack_from(self._buf, foff)
            _FRONT.pack_into(self._buf, foff, max(int(ts), cur_ts),
                             max(int(lsn), cur_lsn))

    def commit_frontiers(self, lease_timeout_s: float = 2.0) -> dict:
        """{slot: (frontier_ts, frontier_lsn)} over LIVE slots with a
        published frontier.  A dead/reclaimed slot is absent — the
        dead-slot ungating rule: its durable records sit behind the
        committed WAL length, so the plain catch-up already covers them
        and no reader should block on a lease that cannot renew."""
        now = time.time()
        with self._locked():
            out = {}
            for s in range(self.nslots):
                pid, lease = _SLOT.unpack_from(
                    self._buf, self._slot_off(s))[:2]
                if not pid or now - lease > lease_timeout_s:
                    continue
                ts, lsn = _FRONT.unpack_from(
                    self._buf, self._o_front + s * _FRONT.size)
                if ts:
                    out[s] = (ts, lsn)
            return out

    # -- the fleet DDL owner lease (ddl.py _run_job) --------------------------

    def ddl_claim(self, slot: int, lease_timeout_s: float = 2.0) -> int:
        """Claim the single DDL owner cell for ``slot``: succeeds when
        unowned, already ours, or the owner's lease lapsed (failover —
        an owner SIGKILLed mid-CREATE).  Bumps and returns the epoch
        (the fence a deposed owner's commit fails); returns 0 while a
        foreign owner's lease is live (the caller backs off and
        retries)."""
        now = time.time()
        with self._locked():
            epoch, owner_p1, lease = _DDL.unpack_from(
                self._buf, self._o_ddl)
            if owner_p1 and owner_p1 != slot + 1 \
                    and now - lease <= lease_timeout_s:
                return 0
            epoch += 1
            _DDL.pack_into(self._buf, self._o_ddl, epoch, slot + 1, now)
            return epoch

    def ddl_heartbeat(self, slot: int, epoch: int) -> bool:
        """Refresh the DDL lease; False when ``slot`` no longer owns the
        cell at ``epoch`` (it failed over — abandon the job)."""
        with self._locked():
            cur_epoch, owner_p1, _lease = _DDL.unpack_from(
                self._buf, self._o_ddl)
            if owner_p1 != slot + 1 or cur_epoch != epoch:
                return False
            _DDL.pack_into(self._buf, self._o_ddl, cur_epoch, owner_p1,
                           time.time())
            return True

    def ddl_release(self, slot: int):
        """Clean handoff after a job: drop ownership, keep the epoch."""
        with self._locked():
            epoch, owner_p1, _lease = _DDL.unpack_from(
                self._buf, self._o_ddl)
            if owner_p1 == slot + 1:
                _DDL.pack_into(self._buf, self._o_ddl, epoch, 0, 0.0)

    def ddl_check(self, epoch: int) -> bool:
        """Is ``epoch`` still the DDL cell's current epoch?  The fence a
        deposed owner fails immediately before committing its job."""
        with self._locked():
            return _DDL.unpack_from(self._buf, self._o_ddl)[0] == epoch

    # -- region ownership / epoch fencing (fabric/region.py) ------------------

    def _reg_off(self, rid: int) -> int:
        if not 0 <= rid < self.nregions:
            raise IndexError(
                f"region {rid} out of range 0..{self.nregions - 1}")
        return self._o_regions + rid * _REG.size

    def region_claim(self, rid: int, slot: int,
                     lease_timeout_s: float = 2.0) -> int:
        """Claim region ``rid`` for ``slot``: succeeds when the region is
        unowned, already ours, or the current owner's lease has lapsed
        (the failover case).  Every successful claim BUMPS THE EPOCH and
        returns it — the fencing token the owner must present on every
        committed-length write.  Returns 0 while a foreign owner's lease
        is still live (the claimant backs off and re-scans)."""
        now = time.time()
        with self._locked():
            off = self._reg_off(rid)
            epoch, owner_p1, lease, clen, alsn = _REG.unpack_from(
                self._buf, off)
            if owner_p1 and owner_p1 != slot + 1 \
                    and now - lease <= lease_timeout_s:
                return 0
            epoch += 1
            _REG.pack_into(self._buf, off, epoch, slot + 1, now, clen,
                           alsn)
            return epoch

    def region_heartbeat(self, rid: int, slot: int, epoch: int) -> bool:
        """Refresh the region lease; False when the caller no longer owns
        the region at this epoch (it failed over — stop serving it)."""
        with self._locked():
            off = self._reg_off(rid)
            cur_epoch, owner_p1, _lease, clen, alsn = _REG.unpack_from(
                self._buf, off)
            if owner_p1 != slot + 1 or cur_epoch != epoch:
                return False
            _REG.pack_into(self._buf, off, cur_epoch, owner_p1,
                           time.time(), clen, alsn)
            return True

    def region_release(self, rid: int, slot: int):
        """Clean handoff: drop ownership (the epoch stays — it is
        monotonic for the region's lifetime, never reused)."""
        with self._locked():
            off = self._reg_off(rid)
            epoch, owner_p1, _lease, clen, alsn = _REG.unpack_from(
                self._buf, off)
            if owner_p1 == slot + 1:
                _REG.pack_into(self._buf, off, epoch, 0, 0.0, clen, alsn)

    def region_release_all(self, slot: int):
        for rid in range(self.nregions):
            self.region_release(rid, slot)

    def region_check(self, rid: int, epoch: int) -> bool:
        """Is ``epoch`` still the region's current epoch?  The fence a
        zombie appender fails after a failover bumped past it."""
        with self._locked():
            return _REG.unpack_from(
                self._buf, self._reg_off(rid))[0] == epoch

    def region_set_committed(self, rid: int, epoch: int, n: int) -> bool:
        """Epoch-fenced committed-length publish (the per-region
        ``set_wal_len``): False — and NO write — when ``epoch`` is stale,
        so a failed-over region's old owner cannot move the fence."""
        with self._locked():
            off = self._reg_off(rid)
            cur_epoch, owner_p1, lease, _clen, alsn = _REG.unpack_from(
                self._buf, off)
            if cur_epoch != epoch:
                return False
            _REG.pack_into(self._buf, off, cur_epoch, owner_p1, lease,
                           int(n), alsn)
            return True

    def region_committed_len(self, rid: int) -> int:
        with self._locked():
            return _REG.unpack_from(self._buf, self._reg_off(rid))[3]

    def region_set_applied(self, rid: int, epoch: int, lsn: int) -> bool:
        with self._locked():
            off = self._reg_off(rid)
            cur_epoch, owner_p1, lease, clen, _alsn = _REG.unpack_from(
                self._buf, off)
            if cur_epoch != epoch:
                return False
            _REG.pack_into(self._buf, off, cur_epoch, owner_p1, lease,
                           clen, int(lsn))
            return True

    def region_info(self, rid: int) -> dict:
        with self._locked():
            epoch, owner_p1, lease, clen, alsn = _REG.unpack_from(
                self._buf, self._reg_off(rid))
        return {"region": rid, "epoch": epoch, "owner": owner_p1 - 1,
                "lease_age_s": (round(time.time() - lease, 3)
                                if owner_p1 else None),
                "committed_len": clen, "applied_lsn": alsn}

    def regions_expired(self, lease_timeout_s: float = 2.0) -> list:
        """Owned regions whose lease lapsed — the failover work list."""
        now = time.time()
        with self._locked():
            out = []
            for rid in range(self.nregions):
                _e, owner_p1, lease, _c, _a = _REG.unpack_from(
                    self._buf, self._reg_off(rid))
                if owner_p1 and now - lease > lease_timeout_s:
                    out.append(rid)
            return out

    def region_owners(self) -> dict:
        """{rid: owner slot} over currently owned regions."""
        with self._locked():
            out = {}
            for rid in range(self.nregions):
                owner_p1 = _REG.unpack_from(
                    self._buf, self._reg_off(rid))[1]
                if owner_p1:
                    out[rid] = owner_p1 - 1
            return out

    # -- per-table fleet versions (the result cache's invalidation feed) -----

    def _tver_off(self, i: int) -> int:
        return self._o_tvers + i * _TVER.size

    def table_version_advance(self, pairs) -> None:
        """Advance table-version cells forward-only: for each
        ``(table_id, version_ts)`` the cell becomes ``max(cell, ts)``.
        Idempotent — the committing worker publishes at commit and every
        tailer re-publishes as it applies the log, so a down-window on
        any single worker is repaired by the next.  A full section drops
        the advance: the table simply has no fleet version (callers see
        it as cache-ineligible, never as stale)."""
        if not self.ntablevers:
            return
        with self._locked():
            for tid, ts in pairs:
                tid, ts = int(tid), int(ts)
                if tid <= 0 or ts <= 0:
                    continue
                free = -1
                for i in range(self.ntablevers):
                    off = self._tver_off(i)
                    cell_tid, cell_ts = _TVER.unpack_from(self._buf, off)
                    if cell_tid == tid:
                        if ts > cell_ts:
                            _TVER.pack_into(self._buf, off, tid, ts)
                        break
                    if not cell_tid and free < 0:
                        free = i
                else:
                    if free >= 0:
                        _TVER.pack_into(self._buf, self._tver_off(free),
                                        tid, ts)

    def table_versions(self, tids) -> dict:
        """{table_id: version_ts} for every requested table that has a
        cell (missing tables are absent — cache-ineligible)."""
        if not self.ntablevers:
            return {}
        want = {int(t) for t in tids}
        out = {}
        with self._locked():
            for i in range(self.ntablevers):
                cell_tid, cell_ts = _TVER.unpack_from(
                    self._buf, self._tver_off(i))
                if cell_tid in want:
                    out[cell_tid] = cell_ts
                    if len(out) == len(want):
                        break
        return out

    # -- fragment dedup -------------------------------------------------------

    def _ded_off(self, i: int) -> int:
        return self._o_dedup + i * _DED.size

    #: a versioned (vv_hash != 0) DDONE entry is evictable for slot reuse
    #: only after this long — a plain in-flight claimant's short ttl must
    #: not evict a live cache page (invalidation, not time, retires it)
    VERSIONED_EVICT_S = 120.0

    def dedup_claim(self, key_hash: bytes, ttl_s: float,
                    vv_hash: int = 0, check_vv: bool = True,
                    owner: "int | None" = None) -> tuple:
        """Claim or join the result-cache slot for `key_hash` (16 bytes).

        ``vv_hash`` is the claimant's version-vector hash (0 = plain
        in-flight dedup, no version stamping).  Returns one of::

            ("lead", idx, 0)            # this process computes + publishes
            ("lead_delta", idx, rid)    # version advanced: old page `rid`
                                        # is kept for a delta fold
            ("hit",  idx, result_id)    # a matching result page exists
            ("wait", idx, 0)            # another process is building: poll
            ("miss", -1, 0)             # table full — just compute locally

        A versioned entry hits only when its stored vv_hash equals the
        claimant's (``check_vv=False`` — the cache-stale-read failpoint —
        skips that check; the page-level verify downstream must catch it).
        """
        now = time.time()
        # net workers pass their slot explicitly: the server-side
        # Coordinator instance is shared by every TCP client, so
        # set_claim_owner's instance attribute cannot carry their identity
        who = self._claim_owner if owner is None else int(owner)
        with self._locked():
            free = -1
            for i in range(self.ndedup):
                off = self._ded_off(i)
                h, state, owner, ts, rid, vv = _DED.unpack_from(
                    self._buf, off)
                if h == key_hash and state != DFREE:
                    if state == DBUILDING:
                        if now - ts <= BUILD_LEASE_S:
                            return ("wait", i, 0)
                        # leader died mid-build: take the slot over (a
                        # kept old page rides along for the delta fold)
                        _DED.pack_into(self._buf, off, key_hash, DBUILDING,
                                       who, now, rid, vv)
                        self._bump_locked("fabric_dedup_leads")
                        if rid and vv and vv_hash:
                            return ("lead_delta", i, rid)
                        return ("lead", i, 0)
                    eff_ttl = self.VERSIONED_EVICT_S if vv else ttl_s
                    if state == DDONE and now - ts <= eff_ttl:
                        if vv and check_vv and vv != vv_hash:
                            # version advanced under the page: invalidate,
                            # but KEEP the page — the new leader folds the
                            # delta since the cached version through it
                            self._bump_locked("fabric_cache_invalidations")
                            self._bump_locked("fabric_dedup_leads")
                            _DED.pack_into(self._buf, off, key_hash,
                                           DBUILDING, who,
                                           now, rid, vv)
                            return ("lead_delta", i, rid)
                        self._bump_locked("fabric_dedup_hits")
                        if vv:
                            self._bump_locked("fabric_cache_hits")
                        return ("hit", i, rid)
                    # stale done / failed: re-lead (and GC the expired
                    # page — nothing can serve it again, and pages left
                    # behind are unbounded disk growth)
                    self._unlink_page(rid)
                    _DED.pack_into(self._buf, off, key_hash, DBUILDING,
                                   who, now, 0, 0)
                    self._bump_locked("fabric_dedup_leads")
                    return ("lead", i, 0)
                if free < 0 and (state == DFREE
                                 or (state == DDONE and now - ts
                                     > (self.VERSIONED_EVICT_S if vv
                                        else ttl_s))
                                 or state == DFAILED):
                    free = i
            if free < 0:
                return ("miss", -1, 0)
            off = self._ded_off(free)
            old_rid = _DED.unpack_from(self._buf, off)[4]
            self._unlink_page(old_rid)  # the reused slot's expired page
            _DED.pack_into(self._buf, off, key_hash,
                           DBUILDING, who, now, 0, 0)
            self._bump_locked("fabric_dedup_leads")
            return ("lead", free, 0)

    #: the owner id stamped on dedup claims.  Workers set their real
    #: slot via set_claim_owner (state.activate); any attachment that
    #: never does — the parent, a bench verifier, tests — claims as
    #: EXTERNAL_OWNER, a sentinel that matches no worker slot: a real
    #: slot's crash reclaim must never fail an external claimant's
    #: in-progress entry, and vice versa (an abandoned external claim is
    #: recovered by the BUILD_LEASE_S takeover, not by slot reclaim)
    EXTERNAL_OWNER = 0xFFFFFFFF
    _claim_owner = EXTERNAL_OWNER

    def set_claim_owner(self, slot: int):
        self._claim_owner = int(slot)

    def dedup_publish(self, idx: int, key_hash: bytes,
                      result_id: int, vv_hash: int = 0) -> None:
        with self._locked():
            off = self._ded_off(idx)
            h, state, owner, _ts, old_rid, _vv = _DED.unpack_from(
                self._buf, off)
            if h == key_hash and state == DBUILDING:
                if old_rid and old_rid != result_id:
                    # the delta fold's source page: superseded now
                    self._unlink_page(old_rid)
                _DED.pack_into(self._buf, off, h, DDONE, owner,
                               time.time(), result_id, vv_hash)

    def dedup_fail(self, idx: int, key_hash: bytes) -> None:
        with self._locked():
            off = self._ded_off(idx)
            h, state, owner, ts, rid, vv = _DED.unpack_from(self._buf, off)
            if h == key_hash and state == DBUILDING:
                _DED.pack_into(self._buf, off, h, DFAILED, owner, ts,
                               rid, vv)

    def dedup_poll(self, idx: int, key_hash: bytes) -> tuple:
        """-> ("building"|"done"|"gone", result_id)."""
        with self._locked():
            h, state, owner, ts, rid, _vv = _DED.unpack_from(
                self._buf, self._ded_off(idx))
            if h != key_hash or state in (DFREE, DFAILED):
                return ("gone", 0)
            if state == DDONE:
                return ("done", rid)
            if time.time() - ts > BUILD_LEASE_S:
                return ("gone", 0)  # leader presumed dead
            return ("building", 0)

    def next_result_id(self) -> int:
        with self._locked():
            return self._bump_locked("_result_id_seq")

    def result_page_path(self, result_id: int) -> str:
        return os.path.join(self.pages_dir, f"dedup-{result_id}.bin")

    def _unlink_page(self, result_id: int):
        if result_id:
            with contextlib.suppress(OSError):
                os.remove(self.result_page_path(result_id))

    def prewarm_claim(self, key_hash: bytes, ttl_s: float = 60.0) -> bool:
        """Fleet-wide prewarm dedup: True when THIS process should warm
        the signature, False when another worker claimed it within the
        window (counted ``fabric_prewarm_dedup``)."""
        kind, idx, _rid = self.dedup_claim(key_hash, ttl_s)
        if kind == "lead":
            # mark done immediately: the claim itself is the dedup —
            # prewarm needs no result page, only at-most-once submission
            self.dedup_publish(idx, key_hash, 0)
            with self._locked():
                # a claim is not a dedup LEAD in the gauge sense
                self._bump_locked("fabric_dedup_leads", -1)
            return True
        if kind in ("hit", "wait"):
            with self._locked():
                if kind == "hit":
                    self._bump_locked("fabric_dedup_hits", -1)
                self._bump_locked("fabric_prewarm_dedup")
            return False
        return True  # table full: warm locally rather than skip

    # -- fragment performance store (observe-only) -----------------------------

    def _perf_off(self, i: int) -> int:
        return self._o_perf + i * _PERF.size

    def perf_merge(self, rows) -> int:
        """Merge worker-local span-duration accumulators into the fleet
        store.  ``rows`` is a list of
        ``(sig_hash, bucket, backend, kind, count, sum_s, max_s, sketch)``
        deltas (sketch: PERF_SKETCH_N ints).  Linear probe by the 4-part
        key; a full table drops the row (counted fabric_perf_dropped).
        Returns rows merged.  Merge-only commutative math — there is no
        per-slot state here to crash-reclaim (see _PERF)."""
        if not self.nperf:
            return 0
        merged = 0
        with self._locked():
            for sig, bucket, backend, kind, cnt, s, mx, sketch in rows:
                if cnt <= 0:
                    continue
                key = (int(sig) & (2**64 - 1), int(bucket),
                       int(backend), int(kind))
                free = -1
                for i in range(self.nperf):
                    off = self._perf_off(i)
                    row = _PERF.unpack_from(self._buf, off)
                    if row[4] == 0:  # free (count == 0)
                        if free < 0:
                            free = i
                        continue
                    if row[:4] == key:
                        new_sketch = [a + b for a, b in
                                      zip(row[7:], sketch)]
                        _PERF.pack_into(
                            self._buf, off, *key, row[4] + int(cnt),
                            row[5] + float(s), max(row[6], float(mx)),
                            *new_sketch)
                        merged += 1
                        break
                else:
                    if free >= 0:
                        _PERF.pack_into(
                            self._buf, self._perf_off(free), *key,
                            int(cnt), float(s), float(mx),
                            *[int(x) for x in sketch])
                        merged += 1
                    else:
                        self._bump_locked("fabric_perf_dropped", int(cnt))
        return merged

    def perf_rows(self) -> list:
        """Every live perf row as a dict — the
        information_schema.tidb_fragment_perf / /status feed."""
        out = []
        with self._locked():
            for i in range(self.nperf):
                row = _PERF.unpack_from(self._buf, self._perf_off(i))
                if row[4] == 0:
                    continue
                out.append({"sig_hash": row[0], "bucket": row[1],
                            "backend": row[2], "kind": row[3],
                            "count": row[4], "sum_s": row[5],
                            "max_s": row[6], "sketch": list(row[7:])})
        return out

    def perf_lookup(self, sig_hash: int, bucket: int) -> list:
        """The perf rows for one (fragment sig, bucket) — what EXPLAIN
        ANALYZE renders as the fleet line."""
        want = (int(sig_hash) & (2**64 - 1), int(bucket))
        out = []
        with self._locked():
            for i in range(self.nperf):
                row = _PERF.unpack_from(self._buf, self._perf_off(i))
                if row[4] and row[0] == want[0] and row[1] == want[1]:
                    out.append({"backend": row[2], "kind": row[3],
                                "count": row[4], "sum_s": row[5],
                                "max_s": row[6], "sketch": list(row[7:])})
        return out

    # -- introspection / drain ------------------------------------------------

    def snapshot(self) -> dict:
        now = time.time()
        with self._locked():
            slots = []
            for s in range(self.nslots):
                pid, lease, gen, mrt, wa = _SLOT.unpack_from(
                    self._buf, self._slot_off(s))
                if pid:
                    fts, flsn = _FRONT.unpack_from(
                        self._buf, self._o_front + s * _FRONT.size)
                    slots.append({"slot": s, "pid": pid, "gen": gen,
                                  "lease_age_s": round(now - lease, 3),
                                  "min_read_ts": mrt, "wal_applied": wa,
                                  "frontier_ts": fts,
                                  "frontier_lsn": flsn})
            tenants = {}
            for t in range(self.ntenants):
                name = self._ten_name(t)
                if not name:
                    continue
                base = self._o_tenants + t * self._ten_sz
                _n, vt, peak, _pad = _TEN_FIXED.unpack_from(self._buf, base)
                tenants[name.decode("utf-8", "replace")] = {
                    "running": self._running_total_locked(t),
                    "peak_running": peak,
                    "vtime": round(vt, 4),
                    "hbm_bytes": sum(
                        _U64.unpack_from(self._buf, self._hbm_off(t, s))[0]
                        for s in range(self.nslots))}
            building = sum(
                1 for i in range(self.ndedup)
                if _DED.unpack_from(self._buf, self._ded_off(i))[1]
                == DBUILDING)
            held_locks = sum(
                1 for i in range(self.nlocks)
                if _LCK.unpack_from(self._buf,
                                    self._o_locks + i * _LCK.size)[1])
            ctrs = {name: _U64.unpack_from(
                self._buf, self._ctr_off(name))[0]
                for name in COUNTER_NAMES if not name.startswith("_")}
            ctrs["schema_version"] = _U64.unpack_from(
                self._buf, self._ctr_off("_schema_ver"))[0]
            regions = []
            for rid in range(self.nregions):
                epoch, owner_p1, _lease, clen, alsn = _REG.unpack_from(
                    self._buf, self._reg_off(rid))
                regions.append({"region": rid, "epoch": epoch,
                                "owner": owner_p1 - 1,
                                "committed_len": clen,
                                "applied_lsn": alsn})
            perf_rows_used = perf_samples = 0
            for i in range(self.nperf):
                row = _PERF.unpack_from(self._buf, self._perf_off(i))
                if row[4]:
                    perf_rows_used += 1
                    perf_samples += row[4]
            ddl_epoch, ddl_owner_p1, _dl = _DDL.unpack_from(
                self._buf, self._o_ddl)
        return {"slots": slots, "tenants": tenants,
                "dedup_building": building, "held_locks": held_locks,
                "regions": regions, "perf_rows_used": perf_rows_used,
                "perf_samples": perf_samples,
                "ddl_epoch": ddl_epoch, "ddl_owner": ddl_owner_p1 - 1,
                **ctrs}

    def verify_drained(self) -> dict:
        """Fleet drain invariant (the cross-process analog of
        scheduler.verify_drained): no live lease, zero running counts in
        every tenant row, no dedup slot stuck building, no shared 2PC
        lock claim held, every slot's min-read-ts column zeroed (an
        exited worker must not pin the fleet GC floor forever), and NO
        ORPHANED REGION LEASE — every region a worker owned was released
        on drain or failed over and then released; an owner entry at
        drain is a region no survivor can claim without waiting out a
        dead lease."""
        snap = self.snapshot()
        running = {g: t["running"] for g, t in snap["tenants"].items()
                   if t["running"]}
        pinned = [s["slot"] for s in snap["slots"] if s["min_read_ts"]]
        region_leases = [r["region"] for r in snap["regions"]
                         if r["owner"] >= 0]
        # the DDL cell must be unowned at drain: a held lease here is a
        # dead owner no survivor can claim without waiting out its lease
        ddl_owner = snap["ddl_owner"]
        return {"ok": not snap["slots"] and not running
                and snap["dedup_building"] == 0
                and snap["held_locks"] == 0 and not pinned
                and not region_leases and ddl_owner < 0,
                "live_slots": [s["slot"] for s in snap["slots"]],
                "running": running,
                "dedup_building": snap["dedup_building"],
                "held_locks": snap["held_locks"],
                "min_read_pinned": pinned,
                "region_leases": region_leases,
                "ddl_owner": ddl_owner,
                "lease_reclaims": snap["fabric_lease_reclaims"]}


def _untrack(shm) -> None:
    """Detach a SharedMemory from this process's resource tracker: this
    CPython registers segments on ATTACH too, and the tracker UNLINKS
    everything it tracks when its process exits — the first worker to
    die would tear the fleet's segment out from under the survivors.
    The fleet owns the lifecycle explicitly (Coordinator.unlink)."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception as e:  # noqa: BLE001 — tracker API drifts by version
        log.debug("resource-tracker unregister skipped: %s", e)
