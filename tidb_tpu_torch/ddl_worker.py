"""Online DDL worker — the F1 schema-state machine with an async owner
worker and checkpointed backfill.

Reference: ddl/ddl_worker.go:155,502,728 (owner loop + runDDLJob),
ddl/index.go:519-541 (none → delete-only → write-only → write-reorganization
→ public), ddl/backfilling.go:142,290 (batched snapshot backfill with the
progress handle checkpointed in the job), ddl/rollingback.go (unique-key
violation rolls the index add back), ddl/callback.go (test hooks between
states).

Single-process adaptation: the schema cache is one Domain, so a state
transition commits + reloads the domain schema instead of waiting 2×lease
for peers; everything else — job queue in the meta KV, per-transition schema
versions, batch txns that atomically advance the checkpoint, concurrent DML
maintaining the index according to its state — keeps the reference shape.
"""

from __future__ import annotations

import logging
import threading

from . import tablecodec
from .errors import DupEntryError, ErrCode, TiDBError, WriteConflictError
from .meta import Meta
from .model import Job, JobState, SchemaState
from .table import Table

MIN_HANDLE = -(1 << 63)
DEFAULT_REORG_BATCH = 256

_log = logging.getLogger("tidb_tpu_torch.ddl")


class DDLWorker:
    """The DDL owner role: drains the meta job queue in a background thread;
    sessions enqueue and block on completion (reference: doDDLJob blocks,
    the owner executes)."""

    def __init__(self, domain):
        self.domain = domain
        self.hooks = []           # [(event:str, job:Job) -> None]
        self.batch_size = DEFAULT_REORG_BATCH
        self._thread = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._done: dict[int, tuple[threading.Event, str | None]] = {}
        self._lock = threading.Lock()

    # -- hooks (reference: ddl/callback.go) ---------------------------------

    def on_event(self, fn):
        self.hooks.append(fn)

    def _fire(self, event: str, job: Job):
        for fn in list(self.hooks):
            fn(event, job)

    # -- session-facing API --------------------------------------------------

    def run_job(self, job_id: int, timeout: float = 120.0):
        """Wake the worker and block until the job finishes; re-raise its
        terminal error in the caller (reference: ddl.go:551 doDDLJob).

        The waiter registers AFTER the job is already visible in the queue,
        so the worker may finish it before _signal has anyone to notify —
        the wait loop therefore also polls the queue and falls back to the
        job's recorded history error."""
        import time as _time
        ev = threading.Event()
        with self._lock:
            self._done[job_id] = (ev, None)
        self._ensure_thread()
        self._wake.set()
        deadline = _time.monotonic() + timeout
        err = None
        while True:
            if ev.wait(timeout=0.05):
                with self._lock:
                    _ev, err = self._done.pop(job_id)
                break
            if not self._is_queued(job_id):
                with self._lock:
                    self._done.pop(job_id, None)
                err = self._job_error(job_id)
                break
            if _time.monotonic() > deadline:
                with self._lock:
                    self._done.pop(job_id, None)
                raise TiDBError(f"DDL job {job_id} timed out")
        if err:
            if "Duplicate entry" in err:
                raise DupEntryError(err)
            raise TiDBError(err)

    def _is_queued(self, job_id: int) -> bool:
        txn = self.domain.store.begin()
        try:
            return any(j.id == job_id for j in Meta(txn).queued_jobs())
        finally:
            txn.rollback()

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _ensure_thread(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, name="ddl-worker", daemon=True)
                self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            try:
                self.run_pending()
            except Exception as e:
                # job-level errors are recorded on the job itself; errors
                # escaping the queue drain are worker-health signals and
                # must not vanish (satellite: classified, logged swallows)
                from .utils.backoff import classify
                _log.warning("ddl worker queue drain failed (%s): %s",
                             classify(e), e)

    # -- queue processing ----------------------------------------------------

    def run_pending(self):
        """Drain the queue (each step is its own txn; re-entrant).
        Fleet: the drain holds the segment-leased DDL owner cell,
        renewed per job — a lost lease aborts the drain loudly (the
        new owner re-drives the queue; steps are re-entrant) instead
        of letting two owners interleave one state machine.

        An empty queue returns before the claim: the owner cell belongs
        to the process's active segment, and a worker whose own domain
        has nothing to do (an idle domain, or one outside the fleet)
        must not take it from the domain that does."""
        from .ddl import ddl_lease_heartbeat, ddl_owner_lease
        if self._peek() is None:
            return
        with self.domain.ddl_lock, ddl_owner_lease() as epoch:
            while True:
                if not ddl_lease_heartbeat(epoch):
                    from .utils.backoff import LeaseExpiredError
                    raise LeaseExpiredError(
                        "ddl owner lease lost mid-drain; remaining "
                        "jobs yield to the new owner")
                job = self._peek()
                if job is None:
                    return
                try:
                    self._run_one(job)
                except Exception as e:
                    self._fail_job(job, str(e))
                    self._signal(job.id, str(e))

    def _peek(self):
        txn = self.domain.store.begin()
        try:
            return Meta(txn).peek_job()
        finally:
            txn.rollback()

    def _run_one(self, job: Job):
        steppers = {"add_index": self.step_add_index,
                    "drop_index": self.step_drop_index,
                    "add_column": self.step_add_column}
        step = steppers.get(job.type)
        if step is None:
            raise TiDBError(f"worker cannot run job type {job.type}")
        while not step(job.id):
            pass
        self._signal(job.id, self._job_error(job.id))

    def _signal(self, job_id: int, err: str | None):
        with self._lock:
            ent = self._done.get(job_id)
            if ent is not None:
                self._done[job_id] = (ent[0], err)
                ent[0].set()

    def _job_error(self, job_id: int) -> str | None:
        txn = self.domain.store.begin()
        try:
            for j in Meta(txn).history_jobs():
                if j.id == job_id:
                    return j.error or None
        finally:
            txn.rollback()
        return None

    def _fail_job(self, job: Job, err: str):
        """Terminal failure: cancel the job AND undo any half-built schema
        object — a non-public index left behind would be unreadable yet
        maintained by every DML forever, and would block a retry by name
        (reference: ddl/rollingback.go)."""
        txn = self.domain.store.begin()
        idx_id = None
        try:
            m = Meta(txn)
            phys_ids = [job.table_id]
            if job.type == "add_index":
                t = m.get_table(job.schema_id, job.table_id)
                if t is not None:
                    from .partition import index_phys_ids
                    phys_ids = index_phys_ids(t)
                    name = job.args.get("index_name", "")
                    idx = t.find_index(name)
                    if idx is not None and idx.state != SchemaState.PUBLIC:
                        idx_id = idx.id
                        t.indexes = [i for i in t.indexes if i.id != idx.id]
                        m.update_table(job.schema_id, t)
                        m.bump_schema_version()
            elif job.type == "drop_index":
                # roll FORWARD: past write-only the entries are already
                # missing for new rows — restoring PUBLIC would serve a
                # corrupt index, so a failed drop completes the removal
                t = m.get_table(job.schema_id, job.table_id)
                if t is not None:
                    from .partition import index_phys_ids
                    phys_ids = index_phys_ids(t)
                    idx = t.find_index(job.args.get("index_name", ""))
                    if idx is not None:
                        idx_id = idx.id
                        t.indexes = [i for i in t.indexes if i.id != idx_id]
                        m.update_table(job.schema_id, t)
                        m.bump_schema_version()
            elif job.type == "add_column":
                # a half-added (non-public) column must not survive the
                # cancel — it would be maintained by DML yet unreadable
                t = m.get_table(job.schema_id, job.table_id)
                if t is not None:
                    name = (job.args.get("column") or {}).get("name", "")
                    col = t.find_column(name)
                    if col is not None and col.state != SchemaState.PUBLIC:
                        t.columns = [c for c in t.columns if c is not col]
                        for off, c in enumerate(t.columns):
                            c.offset = off
                        m.update_table(job.schema_id, t)
                        m.bump_schema_version()
            job.state = JobState.CANCELLED
            job.error = err
            m.finish_job(job)
            txn.commit()
        except Exception as e:
            txn.rollback()
            # the cancel record could not persist: the job will be
            # re-peeked and re-failed next drain — log so a cancel stuck
            # in a persist-fail loop is visible
            from .utils.backoff import classify
            _log.warning("ddl job %s cancel persist failed (%s): %s",
                         job.id, classify(e), e)
        if idx_id is not None:
            for pid in phys_ids:
                start, end = tablecodec.index_range(pid, idx_id)
                self.domain.store.mvcc.raw_delete_range(start, end)
        self.domain.reload_schema()

    # -- ADD INDEX state machine (reference: ddl/index.go:519-541) ----------

    def step_add_index(self, job_id: int) -> bool:
        """One state transition (or one backfill batch). Returns True when
        the job has reached a terminal state. Public so tests can interleave
        DML between arbitrary states and simulate crashes mid-backfill."""
        store = self.domain.store
        txn = store.begin()
        m = Meta(txn)
        job = next((j for j in m.queued_jobs() if j.id == job_id), None)
        if job is None:
            txn.rollback()
            return True  # finished (or cancelled) already
        t = m.get_table(job.schema_id, job.table_id)
        if t is None:
            self._cancel_job(m, job, "table dropped during DDL")
            txn.commit()
            self.domain.reload_schema()
            return True
        name = job.args["index_name"]
        idx = t.find_index(name)
        try:
            if idx is None:
                # none → delete-only: the index object appears; DML removes
                # stale entries but does not write new ones
                from .ddl import _build_index_info
                idx = _build_index_info(
                    t, name, [(c, l) for c, l in job.args["columns"]],
                    bool(job.args.get("unique")), m)
                idx.state = SchemaState.DELETE_ONLY
                t.indexes.append(idx)
                return self._transition(m, txn, job, t,
                                        SchemaState.DELETE_ONLY)
            if idx.state == SchemaState.DELETE_ONLY:
                idx.state = SchemaState.WRITE_ONLY
                return self._transition(m, txn, job, t,
                                        SchemaState.WRITE_ONLY)
            if idx.state == SchemaState.WRITE_ONLY:
                idx.state = SchemaState.WRITE_REORG
                job.reorg_handle = MIN_HANDLE
                return self._transition(m, txn, job, t,
                                        SchemaState.WRITE_REORG)
            if idx.state == SchemaState.WRITE_REORG:
                txn.rollback()  # backfill batches run their own txns
                return self._backfill_batch(job, t, idx)
            # unexpected state (e.g. a racing CREATE INDEX already drove an
            # index of this name to PUBLIC): the job MUST leave the queue,
            # or run_pending would peek it forever
            self._cancel_job(
                m, job, f"Duplicate key name '{name}'")
            txn.commit()
            self.domain.reload_schema()
            return True
        except Exception:
            if txn.valid:
                txn.rollback()
            raise

    # -- DROP INDEX state machine (reference: ddl/index.go onDropIndex:
    #    public → write-only → delete-only → none + delete-range) ---------

    def step_drop_index(self, job_id: int) -> bool:
        """One state transition of an online DROP INDEX. The walk DOWN the
        F1 ladder mirrors ADD INDEX's walk up: at write-only the index
        stops serving reads, at delete-only DML stops inserting entries,
        then the object disappears and the key range is purged. A drop
        past write-only only rolls FORWARD (entries are already missing
        for new rows — restoring PUBLIC would serve a corrupt index)."""
        store = self.domain.store
        txn = store.begin()
        m = Meta(txn)
        job = next((j for j in m.queued_jobs() if j.id == job_id), None)
        if job is None:
            txn.rollback()
            return True
        t = m.get_table(job.schema_id, job.table_id)
        if t is None:
            self._cancel_job(m, job, "table dropped during DDL")
            txn.commit()
            self.domain.reload_schema()
            return True
        idx = t.find_index(job.args["index_name"])
        if idx is None:  # re-entry after the final step, or never existed
            job.state = JobState.SYNCED
            job.schema_state = SchemaState.NONE
            job.schema_version = m.bump_schema_version()
            m.finish_job(job)
            txn.commit()
            self.domain.reload_schema()
            return True
        try:
            if idx.state == SchemaState.PUBLIC:
                idx.state = SchemaState.WRITE_ONLY
                return self._transition(m, txn, job, t,
                                        SchemaState.WRITE_ONLY)
            if idx.state == SchemaState.WRITE_ONLY:
                idx.state = SchemaState.DELETE_ONLY
                return self._transition(m, txn, job, t,
                                        SchemaState.DELETE_ONLY)
            # delete-only → gone: drop the object, purge the key range
            from .partition import index_phys_ids
            phys_ids = index_phys_ids(t)
            idx_id = idx.id
            t.indexes = [i for i in t.indexes if i.id != idx_id]
            m.update_table(job.schema_id, t)
            job.state = JobState.SYNCED
            job.schema_state = SchemaState.NONE
            job.schema_version = m.bump_schema_version()
            m.finish_job(job)
            txn.commit()
            for pid in phys_ids:
                start, end = tablecodec.index_range(pid, idx_id)
                store.mvcc.raw_delete_range(start, end)
            self.domain.reload_schema()
            self._fire("none", job)
            return True
        except Exception:
            if txn.valid:
                txn.rollback()
            raise

    # -- ADD COLUMN state machine (reference: ddl/column.go onAddColumn:
    #    none → delete-only → write-only → public, no backfill — defaults
    #    materialize at read) --------------------------------------------

    def step_add_column(self, job_id: int) -> bool:
        from .model import ColumnInfo
        store = self.domain.store
        txn = store.begin()
        m = Meta(txn)
        job = next((j for j in m.queued_jobs() if j.id == job_id), None)
        if job is None:
            txn.rollback()
            return True
        t = m.get_table(job.schema_id, job.table_id)
        if t is None:
            self._cancel_job(m, job, "table dropped during DDL")
            txn.commit()
            self.domain.reload_schema()
            return True
        name = job.args["column"]["name"]
        col = t.find_column(name)
        try:
            if col is None:
                ci = ColumnInfo.from_json(job.args["column"])
                t.max_col_id += 1
                ci.id = t.max_col_id
                ci.state = SchemaState.DELETE_ONLY
                pos = job.args.get("pos")
                if pos == ["first"]:
                    t.columns.insert(0, ci)
                elif pos and pos[0] == "after":
                    ref = t.find_column(pos[1])
                    t.columns.insert(t.columns.index(ref) + 1, ci)
                else:
                    t.columns.append(ci)
                for off, c in enumerate(t.columns):
                    c.offset = off
                return self._transition(m, txn, job, t,
                                        SchemaState.DELETE_ONLY)
            if col.state == SchemaState.DELETE_ONLY:
                col.state = SchemaState.WRITE_ONLY
                return self._transition(m, txn, job, t,
                                        SchemaState.WRITE_ONLY)
            if col.state == SchemaState.WRITE_ONLY:
                col.state = SchemaState.PUBLIC
                m.update_table(job.schema_id, t)
                job.state = JobState.SYNCED
                job.schema_state = SchemaState.PUBLIC
                job.schema_version = m.bump_schema_version()
                m.finish_job(job)
                txn.commit()
                store.mvcc.bump_table_version(t.id)
                self.domain.reload_schema()
                self._fire("public", job)
                return True
            # PUBLIC already (e.g. raced duplicate): leave the queue
            self._cancel_job(m, job,
                             f"Duplicate column name '{name}'")
            txn.commit()
            self.domain.reload_schema()
            return True
        except Exception:
            if txn.valid:
                txn.rollback()
            raise

    def _transition(self, m: Meta, txn, job: Job, t, new_state: int) -> bool:
        m.update_table(job.schema_id, t)
        job.state = JobState.RUNNING
        job.schema_state = new_state
        job.schema_version = m.bump_schema_version()
        m.update_job(job)
        txn.commit()
        self.domain.reload_schema()
        self._fire(SchemaState.NAMES.get(new_state, str(new_state)), job)
        return False

    def _backfill_batch(self, job: Job, t, idx) -> bool:
        """One checkpointed batch (reference: backfilling.go:290): scan
        records after the checkpoint handle, write their index KVs, and
        advance the checkpoint — all in ONE txn, so a crash between batches
        loses nothing and repeats nothing.

        Partitioned tables backfill partition-by-partition: the checkpoint is
        (args["reorg_part"], reorg_handle) and index entries are written
        under each partition's physical id."""
        from .utils import failpoint
        store = self.domain.store
        # physical scan targets: the table itself, or each partition
        if t.partition is not None:
            from .partition import partition_view
            phys = [partition_view(t, d) for d in t.partition.defs]
        else:
            phys = [t]
        from .errors import BackoffExhaustedError
        from .utils.backoff import Backoffer
        bo = Backoffer()
        while True:
            failpoint.inject("ddl-backfill-batch")
            txn = store.begin()
            try:
                m = Meta(txn)
                cur = next((j for j in m.queued_jobs() if j.id == job.id),
                           None)
                if cur is None:
                    txn.rollback()
                    return True
                job = cur
                part = int(job.args.get("reorg_part", 0))
                if part >= len(phys):
                    return self._finish_reorg(m, txn, job, t, idx)
                pt = phys[part]
                start = (tablecodec.record_prefix(pt.id)
                         if job.reorg_handle == MIN_HANDLE else
                         tablecodec.record_key(pt.id, job.reorg_handle) + b"\x00")
                end = tablecodec.record_prefix(pt.id) + b"\xff" * 9
                items = txn.snapshot.scan(start, end, limit=self.batch_size)
                if not items:
                    if part + 1 < len(phys):
                        # this partition is drained: checkpoint to the next
                        job.args["reorg_part"] = part + 1
                        job.reorg_handle = MIN_HANDLE
                        m.update_job(job)
                        txn.commit()
                        self._fire("reorg_batch", job)
                        return False
                    return self._finish_reorg(m, txn, job, t, idx)
                tbl = Table(pt, txn)
                last = job.reorg_handle
                for key, value in items:
                    _tid, handle = tablecodec.decode_record_key(key)
                    row = tablecodec.decode_row(value)
                    self._backfill_put(txn, tbl, idx, row, handle)
                    last = handle
                job.reorg_handle = last
                job.row_count += len(items)
                m.update_job(job)
                txn.commit()
                self._fire("reorg_batch", job)
                return False
            except WriteConflictError as e:
                txn.rollback()
                try:  # concurrent DML touched a scanned row: retry batch
                    bo.backoff("ddlBackfill", e)
                except BackoffExhaustedError as be:
                    raise TiDBError(
                        "backfill batch: too many write conflicts",
                        code=ErrCode.BackoffExhausted) from be
            except DupEntryError as e:
                txn.rollback()
                self._rollback_index(job, t, idx, str(e))
                return True
            except Exception:
                if txn.valid:
                    txn.rollback()
                raise

    @staticmethod
    def _backfill_put(txn, tbl: Table, idx, row, handle):
        """Write one backfilled index entry. Concurrent DML (the index is
        write-only+) may have written this row's entry already — same handle
        is fine (idempotent), a different handle is a real uniqueness
        violation (reference: index backfill's mergeDupKey handling)."""
        vals = tbl._index_values(idx, row)
        if idx.unique and not any(v is None for v in vals):
            key = tablecodec.index_key(tbl.info.id, idx.id, vals)
            existing = txn.get(key)
            if existing is not None:
                if tablecodec.decode_index_handle(existing) != handle:
                    raise DupEntryError(
                        "Duplicate entry '%s' for key '%s'" % (
                            "-".join(str(v) for v in vals), idx.name))
                return
            txn.put(key, tablecodec.encode_index_handle(handle))
        else:
            key = tablecodec.index_key(tbl.info.id, idx.id, vals,
                                       handle=handle)
            txn.put(key, tablecodec.INDEX_VALUE_MARKER)

    def _finish_reorg(self, m: Meta, txn, job: Job, t, idx) -> bool:
        idx.state = SchemaState.PUBLIC
        m.update_table(job.schema_id, t)
        job.state = JobState.SYNCED
        job.schema_state = SchemaState.PUBLIC
        job.schema_version = m.bump_schema_version()
        m.finish_job(job)
        txn.commit()
        self.domain.reload_schema()
        self._fire("public", job)
        return True

    def _rollback_index(self, job: Job, t, idx, err: str):
        """Unique violation during backfill: remove the half-built index
        (reference: ddl/rollingback.go convertAddIdxJob2RollbackJob)."""
        store = self.domain.store
        txn = store.begin()
        try:
            m = Meta(txn)
            cur_t = m.get_table(job.schema_id, job.table_id)
            if cur_t is not None:
                cur_t.indexes = [i for i in cur_t.indexes if i.id != idx.id]
                m.update_table(job.schema_id, cur_t)
            job.state = JobState.ROLLBACK_DONE
            job.error = err
            job.schema_state = SchemaState.NONE
            job.schema_version = m.bump_schema_version()
            m.finish_job(job)
            txn.commit()
        except Exception:
            txn.rollback()
            raise
        from .partition import index_phys_ids
        for pid in index_phys_ids(t):
            start, end = tablecodec.index_range(pid, idx.id)
            store.mvcc.raw_delete_range(start, end)
        self.domain.reload_schema()
        self._fire("rollback_done", job)

    def _cancel_job(self, m: Meta, job: Job, err: str):
        """Cancel under the caller's open meta TXN (which the caller
        commits).  Formerly `_cancel_locked` — renamed because the
        `_locked` suffix is reserved for "caller holds the threading
        guard" (lint: locked-suffix-contract); the exclusivity here is
        txn ownership, not a mutex."""
        job.state = JobState.CANCELLED
        job.error = err
        m.finish_job(job)
