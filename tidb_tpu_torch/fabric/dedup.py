"""Fleet-wide fragment dedup: identical concurrent fragments anywhere in
the fleet dispatch ONE device call.

The scheduler's batch-key coalescing already merges identical queued fragments
onto one scheduling grant INSIDE a process; this module extends the idea
across the process boundary, and further: followers do not even
dispatch.  The claim table lives in the coordination segment
(fabric/coord.py); the winning process (the LEADER) runs the dispatch
and publishes the assembled result chunk to a per-fragment page file,
which followers map back in (``mmap`` read) instead of admitting,
uploading and dispatching their own device call.

Soundness — the dedup key is ``blake2b(batch key ‖ data signature)``:

* the BATCH KEY (device_exec.agg_batch_key) pins the fragment's
  structural identity — plan/cond expression signatures and the padded
  row bucket — exactly the compiled-pipeline identity prefix;
* the DATA SIGNATURE hashes the input chunk's column contents (dtype,
  shape, value bytes, null mask, dictionary codes).  Worker Domains are
  independent stores, so structural identity alone is NOT result
  identity; hashing the content makes it so — two workers seeded with
  the same data dedup, a worker that took an INSERT diverges to a new
  key on its next dispatch and can never be served a stale page.

The claim happens BEFORE admission (device_exec.run_device), so a
follower consumes no device slot while it waits.  Every wait is bounded
and KILL-polled; a leader that dies mid-build is detected by its lease
(coord.BUILD_LEASE_S) and the waiter falls back to a local dispatch —
dedup can delay a fragment by at most the wait bound, never wedge it.

Results ship as pickled Chunks with process-local caches stripped
(utils/chunk.py ``__getstate__`` drops the device ``_device`` slot and
host-side index caches), so a page can never smuggle another process's
device handles.

On top of the in-flight coalescer sits the **version-stamped result
cache** (``claim_versioned`` / ``publish_versioned``, driven by
executor/agg_cache.py): pages whose claim carries a non-zero ``vv_hash``
are stamped with the (table → fleet version) vector they were computed
under and keep serving for as long as every referenced table's CURRENT
fleet version still matches — across statements, sessions and workers,
with the TTL demoted to a backstop (coord.VERSIONED_EVICT_S).  A version
advance (any committed write to a referenced table, tailed fleet-wide by
kv/shared_store) invalidates the entry on its next claim; the holder of
the invalidated claim receives the SUPERSEDED page back and may fold
just the WAL delta through the cached aggregate partials instead of
recomputing.  Every versioned hit re-verifies the vector INSIDE the
page against the one the claim matched — a stale page (hash collision,
or the ``cache-stale-read`` failpoint) is a loud ``cache_stale_reads``
error and a local recompute, never a wrong answer.
"""

from __future__ import annotations

import hashlib
import logging
import mmap
import os
import pickle
import time

import numpy as np

log = logging.getLogger("tidb_tpu_torch.fabric.dedup")

#: a DONE result page serves followers for this long — the
#: "concurrent identical fragments" window.  Content-hashed keys make a
#: reuse inside the window SOUND for any length, but the window is kept
#: short deliberately: this is in-flight coalescing (one device call for
#: fragments racing each other).  The RESULT CACHE with a real
#: invalidation story is the version-stamped tier (claim_versioned):
#: its pages ignore this TTL and live on version-vector match, with
#: coord.VERSIONED_EVICT_S as the backstop.  Override with
#: TIDB_TPU_FABRIC_DEDUP_TTL (seconds).
TTL_S = float(os.environ.get("TIDB_TPU_FABRIC_DEDUP_TTL", "0.2") or 0.2)
#: bound on a follower's wait for a building leader
WAIT_S = 5.0
#: poll period while waiting (KILL answers within ~a tick)
POLL_S = 0.01
#: fragments with more input bytes than this skip dedup (hashing cost
#: would rival the dispatch; big fragments rarely collide anyway)
MAX_ARG_BYTES = 64 << 20
#: result pages larger than this are not published (the follower's win
#: would not cover serializing + writing a giant result set)
MAX_PAGE_BYTES = 16 << 20


class Dedup:
    """The per-process dedup handle (fabric/state.py holds one)."""

    def __init__(self, coordinator, slot: int):
        self._c = coordinator
        self._slot = slot

    # -- keying ---------------------------------------------------------------

    def key_hash(self, batch_key, args) -> "bytes | None":
        """16-byte dedup key, or None when the dispatch carries no
        hashable input chunk (no data identity -> no dedup) or the
        inputs exceed MAX_ARG_BYTES.  The size gate runs on CHEAP
        estimates BEFORE any hashing: a paged chunk's columns are
        memmap-backed, and touching their bytes first would materialize
        the very data the paging layer exists to keep on disk."""
        from ..utils.chunk import Chunk
        chunks = [a for a in args if isinstance(a, Chunk)]
        if not chunks:
            return None
        if sum(_col_est_bytes(col) for a in chunks
               for col in a.columns) > MAX_ARG_BYTES:
            return None
        h = hashlib.blake2b(repr(batch_key).encode(), digest_size=16)
        # region-sharded stores fold the owned-region epoch vector into
        # the key: a page computed before a region failover can never
        # serve after it (defense-in-depth — the data signature below
        # already changes with the data, but an epoch bump is the
        # cheaper, earlier invalidation signal)
        from . import state
        rs = state.region_store()
        if rs is not None:
            h.update(repr(sorted(rs.epochs.items())).encode())
        for a in args:
            if isinstance(a, Chunk):
                for col in a.columns:
                    _hash_column(h, col)
            elif isinstance(a, (int, float, np.generic)):
                h.update(repr(a).encode())
        return h.digest()

    # -- the coalesce wrapper -------------------------------------------------

    def coalesce(self, ctx, shape: str, key_hash: bytes, compute):
        """Run `compute` as the fleet leader for this fragment, or serve
        the result another process computed.  `compute` is the full
        admitted dispatch (admission + supervisor + breaker + residency);
        followers never call it."""
        from ..session import tracing
        from . import state
        kind, idx, rid = self._c.dedup_claim(key_hash, TTL_S)
        if kind == "hit":
            res = self._load(rid)
            if res is not None:
                state.bump("fabric_dedup_hits")
                tracing.event("fabric.dedup", role="hit", slot=self._slot)
                return res
            kind = "miss"  # page vanished (TTL race): dispatch locally
        if kind == "wait":
            state.bump("fabric_dedup_waits")
            res = self._wait(ctx, idx, key_hash)
            if res is not None:
                state.bump("fabric_dedup_hits")
                tracing.event("fabric.dedup", role="wait_hit",
                              slot=self._slot)
                return res
            state.bump("fabric_dedup_timeouts")
            self._c.bump("fabric_dedup_timeouts")
            return compute()
        if kind != "lead":
            return compute()
        state.bump("fabric_dedup_leads")
        tracing.event("fabric.dedup", role="lead", slot=self._slot)
        try:
            res = compute()
        except BaseException:
            # degrade/KILL/fault: free the slot so waiters fall back fast
            self._c.dedup_fail(idx, key_hash)
            raise
        self._publish(idx, key_hash, res)
        return res

    # -- the version-stamped result cache ------------------------------------

    def claim_versioned(self, ctx, key_hash: bytes, vv_hash: int,
                        vv: dict):
        """Probe/claim the versioned cache for a fragment computed under
        version vector ``vv`` (whose 64-bit digest is ``vv_hash``).

        Returns one of::

            ("hit", payload)        page dict, vector verified in-page
            ("lead", idx)           caller computes, then
                                    publish_versioned(...) or fail(...)
            ("lead_delta", idx, old_payload)
                                    entry invalidated by a version
                                    advance; the superseded page is
                                    handed back for a delta fold (the
                                    caller still publishes or fails)
            ("none", None)          serve/claim nothing — run uncached

        A ``cache-stale-read`` failpoint skips the claim-time vector
        check; the in-page verify below then catches the mismatch
        loudly (cache_stale_reads) and degrades to a local compute."""
        from ..session import tracing
        from ..utils import failpoint
        from . import state
        check_vv = not failpoint.inject("cache-stale-read")
        try:
            kind, idx, rid = self._c.dedup_claim(
                key_hash, TTL_S, vv_hash=vv_hash, check_vv=check_vv)
        except Exception as e:  # noqa: BLE001 — coordinator down/unlinked:
            #   the cache degrades to "no cache", never to a failed query
            log.debug("versioned claim unavailable: %s", e)
            return ("none", None)
        if kind == "hit":
            payload = self._load(rid)
            payload = self._verify_payload(payload, vv)
            if payload is not None:
                state.bump("fabric_dedup_hits")
                state.bump("cache_hits")
                tracing.event("fabric.cache", role="hit",
                              slot=self._slot,
                              **_leader_tag(payload))
                return ("hit", payload)
            return ("none", None)
        if kind == "wait":
            state.bump("fabric_dedup_waits")
            payload = self._verify_payload(
                self._wait(ctx, idx, key_hash), vv)
            if payload is not None:
                state.bump("fabric_dedup_hits")
                state.bump("cache_hits")
                tracing.event("fabric.cache", role="wait_hit",
                              slot=self._slot,
                              **_leader_tag(payload))
                return ("hit", payload)
            state.bump("fabric_dedup_timeouts")
            return ("none", None)
        if kind == "lead_delta":
            state.bump("cache_invalidations")
            tracing.event("fabric.cache", role="invalidated",
                          slot=self._slot)
            old = self._load(rid)
            if not isinstance(old, dict):
                old = None
            return ("lead_delta", idx, old)
        if kind == "lead":
            state.bump("fabric_dedup_leads")
            return ("lead", idx)
        return ("none", None)

    def _verify_payload(self, payload, vv: dict):
        """The in-page vector must equal the one the claim matched —
        the last line of defense against a stale serve (claim-level
        hash collision, or the cache-stale-read failpoint)."""
        from . import state
        if not isinstance(payload, dict):
            return None
        if payload.get("vv") != vv:
            log.error(
                "STALE CACHE PAGE refused: page vector %s != current %s "
                "(recomputing locally)", payload.get("vv"), vv)
            state.bump("cache_stale_reads")
            try:
                self._c.bump("fabric_cache_stale_reads")
            except Exception as e:  # noqa: BLE001 — counter only
                log.debug("stale-read counter bump failed: %s", e)
            return None
        return payload

    def publish_versioned(self, idx: int, key_hash: bytes,
                          payload: dict, vv_hash: int) -> bool:
        """Publish a version-stamped page ``{"chunk":, "vv":,
        "partial":}`` under an owned claim.  False → the slot was freed
        (waiters compute locally) and nothing was cached.

        The page is stamped with the publishing statement's trace
        context (when one is active): a follower's hit on another
        worker's page names the LEADER's fleet-global trace id in its
        own timeline — the publisher→follower half of cross-process
        stitching (there is no RPC response to piggyback on here; the
        page itself is the message)."""
        from ..session import tracing
        ctx = tracing.wire_ctx()
        if ctx is not None:
            payload = {**payload, "trace": ctx}
        try:
            blob = pickle.dumps(payload, protocol=4)
        except Exception as e:  # noqa: BLE001 — unshippable payload
            log.warning("versioned page not serializable: %s", e)
            self.fail(idx, key_hash)
            return False
        if len(blob) > MAX_PAGE_BYTES:
            self.fail(idx, key_hash)
            return False
        rid = self._c.next_result_id()
        path = self._c.result_page_path(rid)
        try:
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError:
            self.fail(idx, key_hash)
            return False
        self._c.dedup_publish(idx, key_hash, rid, vv_hash=vv_hash)
        return True

    def fail(self, idx: int, key_hash: bytes):
        """Free an owned claim (compute failed / result not cacheable)
        so waiters fall back to local dispatch."""
        try:
            self._c.dedup_fail(idx, key_hash)
        except Exception as e:  # noqa: BLE001 — lease reclaim covers it
            log.debug("dedup_fail failed (lease will reclaim): %s", e)

    # -- pages ----------------------------------------------------------------

    def _publish(self, idx: int, key_hash: bytes, res):
        from ..utils.chunk import Chunk
        if not isinstance(res, Chunk):
            # only assembled result chunks ship; anything else frees the
            # slot so waiters compute locally
            self._c.dedup_fail(idx, key_hash)
            return
        try:
            blob = pickle.dumps(res, protocol=4)
        except Exception as e:  # noqa: BLE001 — unshippable result shape
            log.warning("dedup result not serializable (slot freed, "
                        "waiters compute locally): %s", e)
            self._c.dedup_fail(idx, key_hash)
            return
        if len(blob) > MAX_PAGE_BYTES:
            self._c.dedup_fail(idx, key_hash)
            return
        rid = self._c.next_result_id()
        path = self._c.result_page_path(rid)
        try:
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError:
            self._c.dedup_fail(idx, key_hash)
            return
        self._c.dedup_publish(idx, key_hash, rid)

    def _load(self, result_id: int):
        """Map a result page back in (mmap read; the page is written
        atomically via rename, so a mapped page is always complete)."""
        path = self._c.result_page_path(result_id)
        try:
            with open(path, "rb") as f:
                with mmap.mmap(f.fileno(), 0,
                               access=mmap.ACCESS_READ) as mm:
                    return pickle.loads(mm)
        except (OSError, ValueError, pickle.UnpicklingError, EOFError):
            return None

    def _wait(self, ctx, idx: int, key_hash: bytes):
        from ..session import tracing
        check = getattr(ctx, "check_killed", None)
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            st, rid = self._c.dedup_poll(idx, key_hash)
            if st == "done":
                return self._load(rid)
            if st == "gone":
                # the leader died mid-build (lease reclaim freed the
                # slot): the hop lands in the trace as a PEER-LOST
                # marker, never a hang or a silently dropped wait
                tracing.event("fabric.dedup", status="peer-lost",
                              slot=self._slot)
                return None
            if check is not None:
                check()
            time.sleep(POLL_S)
        return None


def _leader_tag(payload) -> dict:
    """Event tags naming the worker/trace that PUBLISHED a served page
    (empty when the leader ran unsampled)."""
    t = payload.get("trace") if isinstance(payload, dict) else None
    if not isinstance(t, dict) or not t.get("gid"):
        return {}
    out = {"leader_gid": t["gid"]}
    if t.get("proc"):
        out["leader"] = t["proc"]
    return out


def _col_est_bytes(col) -> int:
    """Cheap size estimate WITHOUT touching the column's bytes: len()
    and .nbytes read metadata only, so a memmap-backed paged column
    costs nothing to size (materializing it is exactly what the
    MAX_ARG_BYTES gate exists to avoid)."""
    try:
        if getattr(col, "is_object", lambda: False)():
            return len(col) * 64  # codes + dictionary ballpark
        return int(col.data.nbytes)
    except Exception as e:  # noqa: BLE001 — unsizable must mean skip
        log.debug("column unsizable for dedup gate (skipping): %s", e)
        return MAX_ARG_BYTES + 1


def _hash_column(h, col) -> int:
    """Feed one column's identity into the running hash; returns the
    approximate byte count consumed (diagnostics only — the size gate
    already ran on estimates in key_hash)."""
    # branch on the column's LAYOUT, never on a lazily-populated cache:
    # two processes holding identical data must hash identically even
    # when only one of them has warmed its dict_encode cache
    dict_pair = None
    if getattr(col, "is_object", lambda: False)():
        try:
            dict_pair = col.dict_encode()
        except Exception as e:  # noqa: BLE001 — raw-bytes path below
            log.debug("dict_encode failed for data sig (raw path): %s", e)
            dict_pair = None
    if dict_pair is not None:
        codes, uniques = dict_pair
        codes = np.asarray(codes)
        h.update(b"D")
        h.update(str(codes.dtype).encode())
        h.update(codes.tobytes())
        ub = pickle.dumps(list(np.asarray(uniques, dtype=object)),
                          protocol=4)
        h.update(ub)
        h.update(np.asarray(col.nulls).tobytes())
        return codes.nbytes + len(ub)
    data = col.data
    h.update(b"C")
    h.update(str(getattr(data, "dtype", "?")).encode())
    h.update(str(getattr(data, "shape", len(data))).encode())
    if getattr(data, "dtype", None) is not None and data.dtype != object:
        h.update(np.ascontiguousarray(data).tobytes())
        n = data.nbytes
    else:
        b = pickle.dumps(list(data), protocol=4)
        h.update(b)
        n = len(b)
    h.update(np.asarray(col.nulls).tobytes())
    return n
