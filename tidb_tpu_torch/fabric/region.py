"""Region-sharded keyspace: host loss becomes a region failover.

The keyspace is partitioned into N contiguous regions (reference:
TiKV regions / PD placement).  Each region has its OWN write-ahead log
directory (kv/wal.region_dir), its own lease/epoch/committed-length/
applied-LSN cells in the coordination segment (fabric/coord REGIONS
block), and replicates checkpoint + committed WAL tail to an
object-store-shaped blob API (fabric/blob) under a MANIFEST written
last.  The pieces:

- :class:`RegionMap`        — key -> region id; range -> per-region spans
- :class:`RegionCoordView`  — epoch-fenced coordinator facade one region's
                              WAL and engine talk through; a stale epoch
                              (another host failed the region over) turns
                              every durability write into a loud
                              :class:`RegionEpochError` — the zombie
                              fence.
- :class:`RegionReplicator` — ship/restore checkpoint + tail blobs with
                              rename-last MANIFEST semantics.
- :class:`RegionStore`      — the router: one DurableMVCCStore per owned
                              region behind the exact kv/store.Storage
                              engine surface, so Transaction / Snapshot /
                              executors run unchanged.  Cross-region
                              scans fan out over split_range and
                              concatenate in region order (regions are
                              ordered contiguous ranges, so concat IS the
                              merge).  2PC commits the PRIMARY key's
                              region first — the Percolator commit point
                              stays a single region-local WAL append.
- :func:`verify_region_invariants` — drain-time checks the chaos harness
                              asserts: no orphaned region lease, blob
                              MANIFESTs match their sealed segments.

Failover: leases expire after ``lease_timeout_s`` without a heartbeat.
A survivor calls :meth:`RegionStore.failover_expired`, which claims the
expired lease (bumping the epoch), restores checkpoint + tail from the
blob store, replays per Percolator semantics (deferred cross-region
orphan resolution: the merged disposition map finds a secondary's commit
point in the primary's region log), and resumes serving.  The dead
host's stale appender cannot write into the failed-over region: its
epoch no longer matches, so the fence check inside WAL.append raises.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import zlib
from bisect import bisect_right

from ..kv import wal as wal_mod
from ..kv.shared_store import DurableMVCCStore, SegmentTSOracle
from ..session import tracing
from ..utils.backoff import LeaseExpiredError

log = logging.getLogger("tidb_tpu_torch.fabric.region")

_FHDR = struct.Struct("<8sQ")  # mirrors kv/wal._FHDR (magic, lsn)


class RegionEpochError(LeaseExpiredError):
    """A region operation carried a stale epoch: the region was failed
    over (or released) since this handle claimed it.  Subclasses
    LeaseExpiredError so Backoffer classifies it "lease" and 2PC aborts
    cleanly instead of retrying into a fenced-off log."""


# ---------------------------------------------------------------------------
# keyspace partitioning


class RegionMap:
    """Static partition of the keyspace into ``n`` contiguous regions by
    the first 8 key bytes (big-endian, zero-padded).  Static split is
    the honest scope here — dynamic region splitting/merging is PD's
    job and stays on the roadmap."""

    def __init__(self, n_regions: int):
        if n_regions < 1:
            raise ValueError(f"need >=1 region, got {n_regions}")
        self.n = int(n_regions)
        #: boundary i = first 64-bit key value of region i
        self._bounds = [(i << 64) // self.n for i in range(self.n + 1)]

    def region_of(self, key: bytes) -> int:
        val = int.from_bytes(key[:8].ljust(8, b"\0"), "big")
        rid = bisect_right(self._bounds, val) - 1
        return min(max(rid, 0), self.n - 1)

    def bounds(self, rid: int) -> "tuple[bytes, bytes]":
        """(start_key, end_key) of region ``rid``; b"" means open."""
        if not 0 <= rid < self.n:
            raise IndexError(f"region {rid} out of range 0..{self.n - 1}")
        start = b"" if rid == 0 else self._bounds[rid].to_bytes(8, "big")
        end = (b"" if rid == self.n - 1
               else self._bounds[rid + 1].to_bytes(8, "big"))
        return (start, end)

    def split_range(self, start: bytes, end: bytes) -> list:
        """Intersect [start, end) (end=b"" = +inf) with the region grid:
        -> [(rid, span_start, span_end)] in region (= key) order.  The
        scan fan-out plan: each span goes to its region's store and the
        results concatenate ordered."""
        out = []
        first = self.region_of(start) if start else 0
        last = (self.n - 1 if not end
                else self.region_of(end[:8].ljust(8, b"\0")))
        for rid in range(first, last + 1):
            rs, re_ = self.bounds(rid)
            s = max(start, rs) if rs else start
            e = re_ if not end else (min(end, re_) if re_ else end)
            if e and s >= e:
                continue
            out.append((rid, s, e))
        return out


# ---------------------------------------------------------------------------
# epoch-fenced coordinator facade


class RegionCoordView:
    """What one region's WAL + engine see as "the coordinator": the
    shared cells (TSO, lock table, schema, liveness) pass through to
    the real coordinator; the WAL-frontier cells (wal_len /
    wal_applied) re-target the region's OWN segment cells, and every
    write through them is epoch-fenced.  A zombie host still holding a
    failed-over region's store finds every append rejected here."""

    def __init__(self, coord, rid: int, epoch: int):
        self._c = coord
        self.rid = int(rid)
        self.epoch = int(epoch)

    # -- region-scoped WAL frontier (epoch-fenced writes) -------------------

    def wal_len(self) -> int:
        return self._c.region_committed_len(self.rid)

    def set_wal_len(self, n: int):
        if not self._c.region_set_committed(self.rid, self.epoch, n):
            raise RegionEpochError(
                f"region {self.rid} epoch {self.epoch} fenced: "
                "committed-length write rejected (failed over?)")

    def set_wal_applied(self, slot: int, lsn: int):
        # stale epoch here is not fatal — the failover owner's applied
        # cell is authoritative; a zombie's progress report is ignored
        self._c.region_set_applied(self.rid, self.epoch, lsn)

    def min_wal_applied(self) -> "int | None":
        info = self._c.region_info(self.rid)
        lsn = info.get("applied_lsn", 0)
        return lsn if lsn else None

    def check_fence(self):
        """Raise unless our epoch is still the region's epoch — called
        by WAL.append before any byte hits the log."""
        if not self._c.region_check(self.rid, self.epoch):
            raise RegionEpochError(
                f"region {self.rid} epoch {self.epoch} is stale; "
                "append fenced")

    def set_commit_frontier(self, slot: int, ts: int, lsn: int):
        # region WALs have disjoint LSN spaces, so the slot's single
        # frontier-LSN cell is meaningless across them: publish the ts
        # fence only (lsn stays 0 → readers' LSN wait degenerates to
        # the fast path; cross-region visibility keeps the synchronous
        # catch-up contract, see RegionStore.fresh_read_ts)
        self._c.set_commit_frontier(slot, ts, 0)

    # -- everything else passes through -------------------------------------

    def __getattr__(self, name):
        return getattr(self._c, name)


# ---------------------------------------------------------------------------
# blob replication


class RegionReplicator:
    """Ship (and restore) one region's durability artifacts to/from the
    blob store.  Blob layout per region::

        region-<rid>/MANIFEST                  <- written LAST
        region-<rid>/checkpoint-<lsn>.bin      <- checkpoint.bin verbatim
        region-<rid>/wal-<start>-<end>.bin     <- committed framed tail

    The MANIFEST names exactly the blobs a restore needs plus the tail
    CRC; because blob.put is rename-last AND the MANIFEST is uploaded
    after its blobs, a reader that can fetch a MANIFEST can always fetch
    complete referenced blobs.  Superseded blobs are deleted after the
    new MANIFEST lands (crash between = harmless garbage, swept next
    replicate)."""

    def __init__(self, blob):
        self.blob = blob

    @staticmethod
    def _prefix(rid: int) -> str:
        return f"region-{rid}/"

    def manifest(self, rid: int) -> "dict | None":
        try:
            raw = self.blob.get(self._prefix(rid) + "MANIFEST")
        except Exception:  # noqa: BLE001 — absent or unreadable: no copy
            return None
        return json.loads(raw.decode("utf-8"))

    def replicate(self, rid: int, wal: "wal_mod.WAL", epoch: int) -> dict:
        """Upload checkpoint + committed tail, then the MANIFEST."""
        with tracing.span("region.replicate", region=rid, epoch=epoch):
            return self._replicate(rid, wal, epoch)

    def _replicate(self, rid: int, wal: "wal_mod.WAL", epoch: int) -> dict:
        pre = self._prefix(rid)
        ck_name = None
        ck_lsn = 0
        try:
            with open(wal.ckpt_path, "rb") as f:
                ck = f.read()
        except OSError:
            ck = None
        if ck and len(ck) >= _FHDR.size:
            _magic, ck_lsn = _FHDR.unpack_from(ck, 0)
            ck_name = pre + f"checkpoint-{ck_lsn}.bin"
            self.blob.put(ck_name, ck)
        start, tail = wal.tail_bytes()
        end = start + len(tail)
        tail_name = pre + f"wal-{start}-{end}.bin"
        self.blob.put(tail_name, tail)
        man = {"region": rid, "epoch": epoch, "committed_len": end,
               "base_lsn": start, "checkpoint": ck_name,
               "checkpoint_lsn": ck_lsn, "tail": tail_name,
               "tail_crc": zlib.crc32(tail)}
        self.blob.put(pre + "MANIFEST",
                      json.dumps(man, sort_keys=True).encode("utf-8"))
        keep = {pre + "MANIFEST", ck_name, tail_name}
        for name in self.blob.list(pre):
            if name not in keep:
                self.blob.delete(name)
        return man

    def restore(self, rid: int, dest_dir: str) -> dict:
        """Materialize a WAL directory from the region's blobs.  Raises
        (from blob.get / the CRC check) rather than restoring a torn
        copy — recovery must never replay a log it cannot trust."""
        from .blob import BlobError
        with tracing.span("region.restore", region=rid):
            man = self.manifest(rid)
            if man is None:
                raise BlobError(f"region {rid}: no MANIFEST in blob store")
            ck = (self.blob.get(man["checkpoint"])
                  if man["checkpoint"] else None)
            tail = self.blob.get(man["tail"]) if man["tail"] else b""
            if zlib.crc32(tail) != man["tail_crc"]:
                raise BlobError(
                    f"region {rid}: tail CRC mismatch "
                    f"(manifest {man['tail_crc']}, blob {zlib.crc32(tail)})")
            tracing.event("region.restore.blobs", epoch=man["epoch"],
                          bytes=len(tail) + (len(ck) if ck else 0))
            wal_mod.write_wal_files(dest_dir, man["base_lsn"], tail,
                                    checkpoint=ck)
            return man


# ---------------------------------------------------------------------------
# the router


class RegionStore:
    """One DurableMVCCStore per owned region behind the single-engine
    surface kv/store.Storage expects.  See the module docstring for the
    routing rules; every region store shares ONE SegmentTSOracle so
    commit timestamps stay fleet-monotonic across regions."""

    def __init__(self, root: str, coordinator, slot: int, *,
                 blob=None, n_regions: "int | None" = None,
                 lease_timeout_s: float = 2.0):
        n = n_regions if n_regions is not None else coordinator.nregions
        self.region_map = RegionMap(n)
        self.root = root
        self.coord = coordinator
        self.slot = int(slot)
        self.blob = blob
        self.lease_timeout_s = float(lease_timeout_s)
        self.tso = SegmentTSOracle(coordinator)
        self.stores: dict[int, DurableMVCCStore] = {}
        self.epochs: dict[int, int] = {}
        self.safe_point = 0
        self._mu = threading.RLock()
        self._replicator = RegionReplicator(blob) if blob is not None else None

    # -- lifecycle -----------------------------------------------------------

    def open_regions(self, rids=None, *, restore: bool = False) -> list:
        """Claim + open the given regions (default: all).  Returns the
        region ids actually claimed — a region whose lease another host
        holds is skipped, not fought over."""
        want = list(rids) if rids is not None else list(
            range(self.region_map.n))
        claimed = []
        with self._mu:
            for rid in want:
                if rid in self.stores:
                    claimed.append(rid)
                    continue
                if self._open_one(rid, restore=restore):
                    claimed.append(rid)
            self._resolve_cross_region()
        return claimed

    def _open_one(self, rid: int, *, restore: bool) -> bool:
        with tracing.span("region.claim", region=rid, slot=self.slot):
            epoch = self.coord.region_claim(rid, self.slot,
                                            self.lease_timeout_s)
            if not epoch:
                return False  # a live foreign lease — not ours to take
            rdir = wal_mod.region_dir(self.root, rid)
            if restore and self._replicator is not None:
                man = self._replicator.manifest(rid)
                if man is not None:
                    self._replicator.restore(rid, rdir)
            view = RegionCoordView(self.coord, rid, epoch)
            w = wal_mod.WAL(rdir, coordinator=view)
            st = DurableMVCCStore(w, coordinator=view, slot=self.slot,
                                  oracle=self.tso)
            st.recover(defer_orphans=True)
            self.stores[rid] = st
            self.epochs[rid] = epoch
            return True

    def _resolve_cross_region(self):
        """Percolator commit-point resolution across region logs: merge
        every region's replayed disposition so a secondary lock in
        region B finds its primary's commit record from region A.
        ``assume_fenced``: we hold each region's current epoch, so the
        previous owner — dead or a partitioned zombie — can never land
        its commit past the fence; its leftovers are safe to resolve
        even while its slot lease still looks live."""
        merged: dict[int, tuple] = {}
        for st in self.stores.values():
            merged.update(st._recover_disposition)
        total = 0
        for st in self.stores.values():
            total += st.resolve_orphans(merged, st._recover_lock_owner,
                                        assume_fenced=True)
        if total:
            log.info("resolved %d cross-region orphan locks", total)
        return total

    def heartbeat(self) -> list:
        """Renew every owned lease.  Returns region ids LOST (heartbeat
        rejected: failed over behind us) — those stores are closed and
        dropped, so later routing raises instead of serving stale."""
        lost = []
        with self._mu:
            for rid in list(self.stores):
                ok = False
                try:
                    ok = self.coord.region_heartbeat(rid, self.slot,
                                                     self.epochs[rid])
                except Exception as e:  # noqa: BLE001 — segment gone at
                    #   teardown: treat as lost, close locally
                    log.debug("region %d heartbeat failed: %s", rid, e)
                if not ok:
                    lost.append(rid)
                    self._drop(rid)
        if lost:
            log.warning("slot %d lost regions %s (failed over)",
                        self.slot, lost)
        return lost

    def failover_expired(self) -> list:
        """Claim + restore every region whose lease expired — the
        survivor half of host-loss recovery.  Restores from the blob
        store (checkpoint + tail), replays, resolves orphans against
        the merged disposition map, resumes serving."""
        took = []
        with tracing.span("region.failover", slot=self.slot), self._mu:
            for rid in self.coord.regions_expired(self.lease_timeout_s):
                if rid in self.stores:
                    continue
                if self._open_one(rid, restore=True):
                    took.append(rid)
            if took:
                self._resolve_cross_region()
        if took:
            log.warning("slot %d failed over regions %s", self.slot, took)
        return took

    def replicate(self, rids=None) -> dict:
        """Ship checkpoint + committed tail of the given (default: all
        owned) regions to the blob store.  -> {rid: manifest}."""
        if self._replicator is None:
            return {}
        out = {}
        with self._mu:
            targets = list(rids) if rids is not None else list(self.stores)
            for rid in targets:
                st = self.stores[rid]
                epoch = self.epochs[rid]
                try:
                    if not self.coord.region_check(rid, epoch):
                        # failed over behind us: the new owner's replica
                        # is authoritative — a zombie's close-time
                        # replicate must never clobber its MANIFEST
                        continue
                except Exception as e:  # noqa: BLE001
                    log.debug("region %d epoch check unavailable at "
                              "replicate, skipping: %s", rid, e)
                    continue
                out[rid] = self._replicator.replicate(rid, st.wal, epoch)
        return out

    def checkpoint_region(self, rid: int) -> int:
        with self._mu:
            st = self.stores[rid]
            return st.wal.checkpoint(st.dump_state())

    def close(self, *, replicate: bool = True):
        with self._mu:
            if replicate and self._replicator is not None:
                try:
                    self.replicate()
                except Exception as e:  # noqa: BLE001 — best-effort on
                    #   shutdown; the WAL itself is the durable copy
                    log.warning("close-time replicate failed: %s", e)
            for rid in list(self.stores):
                self._drop(rid, release=True)

    def _drop(self, rid: int, *, release: bool = False):
        st = self.stores.pop(rid, None)
        epoch = self.epochs.pop(rid, None)
        if st is not None:
            try:
                st.close()
            except Exception as e:  # noqa: BLE001
                log.debug("region %d close failed: %s", rid, e)
        if release and epoch is not None:
            try:
                self.coord.region_release(rid, self.slot)
            except Exception as e:  # noqa: BLE001 — segment may be gone
                log.debug("region %d release failed: %s", rid, e)

    # -- routing helpers -----------------------------------------------------

    def _store_for(self, key: bytes) -> DurableMVCCStore:
        rid = self.region_map.region_of(key)
        st = self.stores.get(rid)
        if st is None:
            raise RegionEpochError(
                f"region {rid} not owned by slot {self.slot} "
                f"(owner: {self.coord.region_owners().get(rid)})")
        return st

    def _group(self, keys) -> "dict[int, list]":
        groups: dict[int, list] = {}
        for k in keys:
            groups.setdefault(self.region_map.region_of(k), []).append(k)
        return groups

    def owned_regions(self) -> list:
        with self._mu:
            return sorted(self.stores)

    # -- engine surface (what kv/store.Storage calls) ------------------------

    def get(self, key: bytes, ts: int, own_start_ts: int = 0):
        return self._store_for(key).get(key, ts, own_start_ts=own_start_ts)

    def scan(self, start: bytes, end: bytes, ts: int, limit: int = 0,
             own_start_ts: int = 0):
        out = []
        for rid, s, e in self.region_map.split_range(start, end):
            st = self.stores.get(rid)
            if st is None:
                raise RegionEpochError(
                    f"scan spans unowned region {rid}")
            # regions are ordered contiguous ranges: concatenating the
            # per-region results in rid order IS the ordered merge
            rem = limit - len(out) if limit else 0
            out.extend(st.scan(s, e, ts, limit=rem,
                               own_start_ts=own_start_ts))
            if limit and len(out) >= limit:
                return out[:limit]
        return out

    def prewrite(self, mutations, primary: bytes, start_ts: int,
                 view_seq: "int | None" = None):
        # view_seq is accepted but not forwarded: the anchor is a
        # per-store scalar and region WALs apply independently, so a
        # single sequence cannot cover a multi-region write set.  The
        # region view (RegionStore has no read_view_seq) always hands
        # writers None — region-mode conflict detection stays on the
        # ts comparison it had before the anchor existed.
        groups: dict[int, list] = {}
        for m in mutations:
            groups.setdefault(self.region_map.region_of(m[0]),
                              []).append(m)
        done = []
        try:
            for rid in sorted(groups):
                # every group carries the same primary: orphan
                # resolution resolves secondaries via the primary's
                # region log, whatever region they live in
                self._require(rid).prewrite(groups[rid], primary, start_ts)
                done.append(rid)
        except BaseException:
            for rid in done:
                try:
                    self.stores[rid].rollback(
                        [m[0] for m in groups[rid]], start_ts)
                except Exception as e:  # noqa: BLE001 — best effort;
                    #   leftover locks resolve via the primary later
                    log.debug("prewrite unwind region %d: %s", rid, e)
            raise
        return None

    def commit(self, keys, start_ts: int, commit_ts: int):
        groups = self._group(keys)
        primary_rid = self.region_map.region_of(keys[0])
        order = [primary_rid] + [r for r in sorted(groups)
                                 if r != primary_rid]
        for rid in order:
            # the primary's region commits FIRST: its WAL append is the
            # txn's Percolator commit point; a crash after it resolves
            # every secondary as committed, a crash before rolls back
            self._require(rid).commit(groups[rid], start_ts, commit_ts)

    def rollback(self, keys, start_ts: int):
        for rid, ks in self._group(keys).items():
            self._require(rid).rollback(ks, start_ts)

    def acquire_pessimistic_lock(self, keys, primary: bytes,
                                 start_ts: int, for_update_ts: int,
                                 view_seq: "int | None" = None):
        # view_seq unused for the same reason as in prewrite
        for rid, ks in sorted(self._group(keys).items()):
            self._require(rid).acquire_pessimistic_lock(
                ks, primary, start_ts, for_update_ts)

    def resolve_lock(self, key: bytes, committed: bool, commit_ts: int = 0):
        return self._store_for(key).resolve_lock(key, committed, commit_ts)

    def clear_wait(self, start_ts: int):
        for st in self.stores.values():
            st.clear_wait(start_ts)

    def bump_table_version(self, table_id: int, commit_ts: int = 0) -> int:
        out = 0
        for st in self.stores.values():
            out = max(out, st.bump_table_version(table_id, commit_ts))
        return out

    def raw_put(self, key: bytes, value: bytes, commit_ts=None):
        return self._store_for(key).raw_put(key, value, commit_ts)

    def raw_batch_put(self, pairs, commit_ts=None):
        groups: dict[int, list] = {}
        for k, v in pairs:
            groups.setdefault(self.region_map.region_of(k),
                              []).append((k, v))
        for rid in sorted(groups):
            self._require(rid).raw_batch_put(groups[rid], commit_ts)

    def raw_delete_range(self, start: bytes, end: bytes):
        for rid, s, e in self.region_map.split_range(start, end):
            self._require(rid).raw_delete_range(s, e)

    def gc(self, safe_point: int):
        self.safe_point = safe_point
        removed = 0
        for st in self.stores.values():
            st.safe_point = safe_point
            removed += st.gc(safe_point)
        return removed

    def catch_up(self):
        for st in list(self.stores.values()):
            st.catch_up()

    def fresh_read_ts(self) -> int:
        """Region-fleet ts fence: order every new snapshot ABOVE every
        live peer's acked durable commit_ts (the frontier cells carry
        ts only here — RegionCoordView publishes lsn=0 because region
        WAL LSN spaces are disjoint).  Visibility of those commits
        rides the synchronous per-region catch_up Storage.begin already
        performs."""
        try:
            fronts = self.coord.commit_frontiers()
        except Exception as e:  # noqa: BLE001 — segment gone at
            #   teardown / coordinator down-window: plain monotonic ts
            log.debug("commit_frontiers unreadable (%s); plain ts", e)
            fronts = {}
        need = max((fts for s, (fts, _lsn) in fronts.items()
                    if s != self.slot), default=0)
        if need:
            self.tso.advance_to(need)
        return self.tso.next_ts()

    def publish_frontier(self):
        """Heartbeat republish funnel (fabric/worker.py): forward to
        every owned region's store."""
        for st in list(self.stores.values()):
            st.publish_frontier()

    def _require(self, rid: int) -> DurableMVCCStore:
        st = self.stores.get(rid)
        if st is None:
            raise RegionEpochError(
                f"region {rid} not owned by slot {self.slot}")
        return st

    def wal_status(self) -> dict:
        with self._mu:
            return {rid: st.wal_status() for rid, st in self.stores.items()}


# ---------------------------------------------------------------------------
# drain-time invariants (chaos harness, satellite 6)


def verify_region_invariants(coordinator, blob=None) -> dict:
    """Region-fleet drain checks, asserted at the end of both chaos
    modes: (a) no region lease survives a drained fleet — an orphaned
    lease means some close/release path leaked; (b) every blob MANIFEST
    names blobs that exist with exactly the sealed length + CRC it
    recorded — a mismatch means replication published a manifest its
    blobs do not back."""
    snap = coordinator.snapshot()
    region_leases = [r["region"] for r in snap.get("regions", [])
                     if r["owner"] >= 0]
    manifest_errors = []
    if blob is not None:
        for name in blob.list():
            if not name.endswith("/MANIFEST"):
                continue
            try:
                man = json.loads(blob.get(name).decode("utf-8"))
            except Exception as e:  # noqa: BLE001
                manifest_errors.append(f"{name}: unreadable ({e})")
                continue
            for ref in (man.get("checkpoint"), man.get("tail")):
                if ref and not blob.exists(ref):
                    manifest_errors.append(f"{name}: missing blob {ref}")
            if man.get("tail"):
                try:
                    tail = blob.get(man["tail"])
                except Exception as e:  # noqa: BLE001
                    if blob.exists(man["tail"]):
                        manifest_errors.append(
                            f"{name}: tail unreadable ({e})")
                    continue  # absent already reported above
                want_len = man["committed_len"] - man["base_lsn"]
                if len(tail) != want_len:
                    manifest_errors.append(
                        f"{name}: tail length {len(tail)} != sealed "
                        f"{want_len}")
                elif zlib.crc32(tail) != man["tail_crc"]:
                    manifest_errors.append(f"{name}: tail CRC mismatch")
    ok = not region_leases and not manifest_errors
    return {"ok": ok, "region_leases": region_leases,
            "manifest_errors": manifest_errors}
