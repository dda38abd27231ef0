"""Backup / restore + logical dump + checkpointed import — the BR,
Dumpling and Lightning roles (reference: br/pkg/task/backup.go:221,
restore.go:216, dumpling/export/dump.go, br/pkg/lightning/checkpoints/,
br/pkg/lightning/errormanager/ duplicate detection).

All file IO routes through the external-storage abstraction
(br_storage.py — the br/pkg/storage role): a backup written to
``local://`` restores from ``memory://`` and vice versa, and a cloud
backend is one ExternalStorage subclass away.

Backup format (one prefix per run):
    backupmeta.json                 run metadata + per-table stats
    {db}.{table}.schema.json       TableInfo (exact catalog state)
    {db}.{table}.data.jsonl        rows as {"h": handle, "v": hex(rowcodec)}
Row payloads reuse the engine's row codec, so restore is bit-exact —
decimals, dates and binary collations round-trip without re-parsing.

Dump format (mydumper-style, reference dumpling/export):
    {db}.{table}-schema.sql        CREATE TABLE
    {db}.{table}.sql | .csv        INSERT statements / CSV rows

Import reads a dump with a progress checkpoint (_import_checkpoint.json)
updated after every committed batch: a crashed import resumes at the
first unfinished table/offset instead of redoing or duplicating work
(reference: lightning checkpoints). `workers` > 1 imports tables in
parallel on their own sessions (lightning's table-concurrency);
`on_duplicate="record"` logs conflicting rows to _import_conflicts.jsonl
and continues (lightning's errormanager) instead of failing the run.
"""

from __future__ import annotations

import io
import json
import threading
import time

from . import tablecodec
from .br_storage import open_storage
from .errors import TiDBError
from .model import TableInfo
from .table import Table

BATCH = 2048


# -- backup (reference: br/pkg/task/backup.go) -------------------------------

def backup_database(session, db_name: str, dest: str) -> dict:
    infos = session.infoschema()
    if infos.schema_by_name(db_name) is None:
        raise TiDBError(f"Unknown database '{db_name}'")
    st = open_storage(dest)
    txn = session.store.begin()  # one snapshot: a consistent backup
    coord = getattr(session.domain, "coordinator", None)
    # one pin PER RUN (keyed by snapshot ts): concurrent backups must not
    # raise or clear each other's GC floor — set_safepoint only moves
    # forward and clear would drop a foreign pin (reference: BR registers
    # a unique service safepoint id per task, br/pkg/task/backup.go)
    pin_key = f"br-{txn.start_ts}"
    if coord is not None:
        coord.set_safepoint(pin_key, txn.start_ts)
    meta = {"db": db_name, "ts": txn.start_ts,
            "created": time.strftime("%Y-%m-%d %H:%M:%S"), "tables": []}
    try:
        for info in infos.tables_in_schema(db_name):
            base = f"{db_name}.{info.name}"
            payload = info.to_json()
            st.write_text(base + ".schema.json",
                          payload if isinstance(payload, str)
                          else json.dumps(payload))
            n = 0
            phys_ids = [info.id]
            if info.partition is not None:
                # rows live under partition physical ids; restore re-routes
                # by value so the dump is just (handle, row) pairs
                phys_ids = [d.id for d in info.partition.defs]
            with st.open_write(base + ".data.jsonl") as f:
                for pid in phys_ids:
                    rec_end = tablecodec.record_prefix(pid) + b"\xff" * 9
                    for key, value in txn.scan(
                            tablecodec.record_prefix(pid), rec_end):
                        _tid, h = tablecodec.decode_record_key(key)
                        f.write(json.dumps(
                            {"h": h, "v": value.hex()}) + "\n")
                        n += 1
            meta["tables"].append({"name": info.name, "rows": n})
        meta["wal"] = _backup_wal_tail(session, st, txn.start_ts)
    finally:
        txn.rollback()
        if coord is not None:
            coord.clear_safepoint(pin_key)
    st.write_text("backupmeta.json", json.dumps(meta, indent=1))
    return meta


def _backup_wal_tail(session, st, backup_ts: int) -> "dict | None":
    """Durable-store half of the backup (kv/wal.py): ship the LAST
    checkpoint (when one exists) plus the log tail since it, filtered
    to records at or below the backup snapshot ts — so a physical
    restore replays to EXACTLY the backup point, commits that raced
    past the snapshot excluded the same way the scan excluded them.
    THEN checkpoint (bounding future recovery; the truncation must not
    eat the tail we just shipped, so ship-first).  None when the store
    is not durable (in-memory deployments carry no wal)."""
    eng = session.store.mvcc
    wal = getattr(eng, "wal", None)
    if wal is None or not hasattr(eng, "dump_state"):
        return None
    import pickle
    from .kv.shared_store import _record_ts
    ck = wal.read_checkpoint()
    from_lsn = wal.base_lsn
    if ck is not None and ck[0] >= wal.base_lsn:
        st.write_file("wal.ckpt.bin", ck[1])
        from_lsn = ck[0]
    tail = [rec for rec, _lsn in wal.read_records(from_lsn)
            if _record_ts(rec) <= backup_ts]
    st.write_file("wal.tail.bin", pickle.dumps(tail, protocol=4))
    ck_lsn = wal.checkpoint(eng.dump_state())
    return {"checkpoint_lsn": ck_lsn, "tail_records": len(tail),
            "has_checkpoint": ck is not None, "backup_ts": backup_ts}


def restore_wal_tail(storage, src: str) -> int:
    """Replay a backup's WAL tail into a DURABLE ``storage``
    (kv.Storage over kv/shared_store.DurableMVCCStore): the
    physical-restore path to the exact backup ts.  Records walk the
    engine's own journal-apply path (prewrite → locks, commit →
    conversion, last-disposition-wins), and the oracle advances past
    the replayed high-water so post-restore snapshots see everything.
    Returns the number of records applied (0 when the backup carried
    no tail or the target store is not durable)."""
    import pickle
    from .kv.shared_store import _record_ts
    st = open_storage(src)
    if not st.exists("wal.tail.bin"):
        return 0
    eng = storage.mvcc
    apply_rec = getattr(eng, "_apply", None)
    if apply_rec is None:
        return 0
    if st.exists("wal.ckpt.bin"):
        eng.load_state(st.read_file("wal.ckpt.bin"))
    records = pickle.loads(st.read_file("wal.tail.bin"))
    max_ts = 0
    for rec in records:
        apply_rec(rec, replay=True)
        max_ts = max(max_ts, _record_ts(rec))
    if max_ts:
        eng.tso.advance_to(max_ts)
    # locks left over are txns that had not committed at backup_ts
    # (their commit record was filtered out): not part of the backup
    with eng._lock:
        leftovers = list(eng.locks.items())
    for key, lk in leftovers:
        from .kv.mvcc import MVCCStore
        MVCCStore.rollback(eng, [key], lk.start_ts)
    # the journal-apply path writes replica state, not the target's own
    # log — checkpoint so the restored state is durable in ONE step
    eng.wal.checkpoint(eng.dump_state())
    return len(records)


# -- physical backup / restore (reference: br/pkg/backup's SST export +
#    br/pkg/lightning/backend/local pebble-SST build-and-ingest). The
#    engine's native on-disk unit is the MVCC KV snapshot itself: backup
#    streams every committed (key, value) under the table prefix —
#    records AND index entries — as length-prefixed binary with a
#    per-file sha256; restore rewrites the 8-byte table/partition id in
#    each key (BR's rewrite rules, br/pkg/restore/util.go) and ingests
#    via raw_batch_put, bypassing SQL, rowcodec decode and index
#    rebuild entirely. ----------------------------------------------------

def physical_backup_database(session, db_name: str, dest: str) -> dict:
    import hashlib
    import struct
    infos = session.infoschema()
    if infos.schema_by_name(db_name) is None:
        raise TiDBError(f"Unknown database '{db_name}'")
    st = open_storage(dest)
    txn = session.store.begin()
    coord = getattr(session.domain, "coordinator", None)
    pin_key = f"br-{txn.start_ts}"
    if coord is not None:
        coord.set_safepoint(pin_key, txn.start_ts)
    meta = {"db": db_name, "ts": txn.start_ts, "mode": "physical",
            "created": time.strftime("%Y-%m-%d %H:%M:%S"), "tables": []}
    try:
        for info in infos.tables_in_schema(db_name):
            base = f"{db_name}.{info.name}"
            payload = info.to_json()
            st.write_text(base + ".schema.json",
                          payload if isinstance(payload, str)
                          else json.dumps(payload))
            ids = [info.id]
            if info.partition is not None:
                ids += [d.id for d in info.partition.defs]
            n = 0
            n_rows = 0
            sha = hashlib.sha256()
            nbytes = 0
            with st.open_write_bytes(base + ".kv.bin") as f:
                for pid in sorted(set(ids)):
                    # the full physical-id prefix covers record AND index
                    # keyspaces in one ordered scan
                    p = tablecodec.TABLE_PREFIX + tablecodec._enc_i64(pid)
                    for key, value in txn.scan(p, p + b"\xff" * 24):
                        rec = struct.pack("<II", len(key), len(value))
                        f.write(rec)
                        f.write(key)
                        f.write(value)
                        sha.update(rec)
                        sha.update(key)
                        sha.update(value)
                        nbytes += 8 + len(key) + len(value)
                        n += 1
                        if key[9:11] == tablecodec.RECORD_SEP:
                            n_rows += 1
            meta["tables"].append({"name": info.name, "rows": n_rows,
                                   "kv": n, "bytes": nbytes,
                                   "sha256": sha.hexdigest(),
                                   "ids": sorted(set(ids))})
    finally:
        txn.rollback()
        if coord is not None:
            coord.clear_safepoint(pin_key)
    st.write_text("backupmeta.json", json.dumps(meta, indent=1))
    return meta


#: keys ingested per raw_batch_put call (bounds peak batch memory)
_INGEST_BATCH = 4096


def physical_restore_database(session, src: str,
                              db_name: str | None = None,
                              meta: dict | None = None) -> dict:
    import hashlib
    import struct
    st = open_storage(src)
    if meta is None:  # the session layer passes its already-parsed copy
        meta = json.loads(st.read_text("backupmeta.json"))
    if meta.get("mode") != "physical":
        raise TiDBError("backup at this path is not a physical backup")
    target_db = db_name or meta["db"]
    if session.infoschema().schema_by_name(target_db) is None:
        session.execute(f"create database `{target_db}`")
    mvcc = session.store.mvcc
    restored = []
    for t in meta["tables"]:
        base = f"{meta['db']}.{t['name']}"
        raw = st.read_text(base + ".schema.json")
        info = TableInfo.from_json(json.loads(raw)
                                   if raw.lstrip().startswith("{")
                                   else raw)
        if session.infoschema().has_table(target_db, info.name):
            raise TiDBError(f"table '{target_db}.{info.name}' already "
                            f"exists; drop it before RESTORE")
        # pass 1 — verify the stream checksum BEFORE any ingest: corrupt
        # data must never become readable, even transiently (reference:
        # BR validates SST checksums before ingest)
        sha = hashlib.sha256()
        with st.open_read_bytes(base + ".kv.bin") as f:
            while True:
                blk = f.read(1 << 20)
                if not blk:
                    break
                sha.update(blk)
        if sha.hexdigest() != t["sha256"]:
            raise TiDBError(f"checksum mismatch restoring {base}: "
                            f"backup is corrupt")
        _create_from_info(session, target_db, info)
        new_info = session.infoschema().table_by_name(target_db, info.name)
        # rewrite rules: source physical id -> restored physical id
        # (partition defs keep their order through the catalog round-trip)
        id_map = {info.id: new_info.id}
        if info.partition is not None:
            for od, nd in zip(info.partition.defs,
                              new_info.partition.defs):
                id_map[od.id] = nd.id
        commit_ts = session.store.next_ts()
        n = 0
        top = 0
        batch = []
        try:
            with st.open_read_bytes(base + ".kv.bin") as f:
                while True:
                    hdr = f.read(8)
                    if not hdr:
                        break
                    klen, vlen = struct.unpack("<II", hdr)
                    key = f.read(klen)
                    value = f.read(vlen)
                    if len(key) != klen or len(value) != vlen:
                        raise TiDBError(
                            f"truncated kv stream in {base}.kv.bin")
                    old_id = tablecodec._dec_i64(key[1:9])
                    new_id = id_map.get(old_id)
                    if new_id is None:
                        raise TiDBError(f"kv key for unknown physical id "
                                        f"{old_id} in {base}.kv.bin")
                    batch.append((tablecodec.TABLE_PREFIX
                                  + tablecodec._enc_i64(new_id) + key[9:],
                                  value))
                    if key[9:11] == tablecodec.RECORD_SEP:
                        n += 1
                        top = max(top, tablecodec._dec_i64(key[11:19]))
                    if len(batch) >= _INGEST_BATCH:
                        mvcc.raw_batch_put(batch, commit_ts)
                        batch = []
            if batch:
                mvcc.raw_batch_put(batch, commit_ts)
        except Exception:
            # sweep ingested versions AND the table the failed restore
            # itself created, so a retry isn't blocked by 'already
            # exists' (reference: restore rolls back downloaded-SST
            # state)
            for nid in id_map.values():
                p = tablecodec.TABLE_PREFIX + tablecodec._enc_i64(nid)
                mvcc.raw_delete_range(p, p + b"\xff" * 24)
            try:
                session.execute(
                    f"drop table `{target_db}`.`{info.name}`")
            except Exception:
                pass  # surfacing the original failure matters more
            raise
        mvcc.bump_table_version(new_info.id, commit_ts)
        _rebase_row_ids(session, new_info, top)
        restored.append({"name": info.name, "rows": n})
    return {"db": target_db, "tables": restored, "mode": "physical"}


def _rebase_row_ids(session, info: TableInfo, top_handle: int):
    """Move the restored table's row-id allocator past its largest
    restored handle (over every partition of a partitioned table), so
    the first INSERT after a RESTORE takes a fresh handle instead of
    overwriting a restored row.  The reference leaves the allocator at
    its start (ROADMAP, queue 3)."""
    if top_handle > 0:
        session.rebase_autoid(info.id, top_handle + 1)


# -- restore (reference: br/pkg/task/restore.go) -----------------------------

def restore_database(session, src: str, db_name: str | None = None,
                     meta: dict | None = None) -> dict:
    # restore into a running FLEET propagates by construction: every
    # _create_from_info commit bumps the meta schema version, which the
    # durable store publishes to the segment's schema-version cell —
    # sibling workers' schema leases reload and their replicas tail the
    # restored rows (kv/shared_store.py)
    st = open_storage(src)
    if meta is None:  # the session layer passes its already-parsed copy
        meta = json.loads(st.read_text("backupmeta.json"))
    target_db = db_name or meta["db"]
    if session.infoschema().schema_by_name(target_db) is None:
        session.execute(f"create database `{target_db}`")
    restored = []
    for t in meta["tables"]:
        base = f"{meta['db']}.{t['name']}"
        raw = st.read_text(base + ".schema.json")
        info = TableInfo.from_json(json.loads(raw)
                                   if raw.lstrip().startswith("{")
                                   else raw)
        if session.infoschema().has_table(target_db, info.name):
            raise TiDBError(f"table '{target_db}.{info.name}' already "
                            f"exists; drop it before RESTORE")
        _create_from_info(session, target_db, info)
        new_info = session.infoschema().table_by_name(target_db, info.name)
        with st.open_read(base + ".data.jsonl") as f:
            n, top = _restore_rows(session, new_info, f)
        _rebase_row_ids(session, new_info, top)
        restored.append({"name": info.name, "rows": n})
    return {"db": target_db, "tables": restored}


def _create_from_info(session, db_name: str, info: TableInfo):
    """Recreate the table from the backed-up TableInfo via the catalog
    (new table id; column/index ids preserved from the source)."""
    from .meta import Meta
    with session.domain.ddl_lock:
        txn = session.store.begin()
        try:
            m = Meta(txn)
            db = next(d for d in m.list_databases()
                      if d.name.lower() == db_name.lower())
            clone = TableInfo.from_json(info.to_json())
            clone.id = m.gen_global_id()
            if clone.partition is not None:
                # fresh physical ids: the source table may still exist
                for d in clone.partition.defs:
                    d.id = m.gen_global_id()
            m.create_table(db.id, clone)
            m.bump_schema_version()
            txn.commit()
        except Exception:
            txn.rollback()
            raise
    session.domain.reload_schema()


def _restore_rows(session, info: TableInfo, lines) -> tuple:
    """-> (rows restored, largest handle among them)."""
    n = 0
    top = 0
    batch = []
    for line in lines:
        if not line.strip():
            continue
        rec = json.loads(line)
        top = max(top, int(rec["h"]))
        batch.append((rec["h"], bytes.fromhex(rec["v"])))
        if len(batch) >= BATCH:
            _write_batch(session, info, batch)
            n += len(batch)
            batch = []
    if batch:
        _write_batch(session, info, batch)
        n += len(batch)
    return n, top


def _write_batch(session, info, batch):
    txn = session.store.begin()
    try:
        tbl = Table(info, txn)
        for handle, value in batch:
            row = tablecodec.decode_row(value)
            tbl.add_record(row, handle, check_dup=False)
        txn.commit()
    except Exception:
        txn.rollback()
        raise
    session.domain.columnar_cache.invalidate(info.id)


# -- logical dump (reference: dumpling/export/dump.go) ------------------------

def dump_database(session, db_name: str, dest: str, fmt: str = "sql",
                  consistency: str = "snapshot") -> dict:
    """Logical dump (the dumpling role). consistency modes (reference:
    dumpling/export/consistency.go):
    - 'snapshot' (default): every table's data SELECT runs at ONE
      historical read ts (the engine's tidb_snapshot stale-read view) —
      writes landing mid-dump are invisible, the dump is transactionally
      consistent across tables;
    - 'none': each table reads at its own statement snapshot (fastest,
      per-table consistent only)."""
    if fmt not in ("sql", "csv"):
        raise TiDBError("dump format must be 'sql' or 'csv'")
    if consistency not in ("snapshot", "none"):
        raise TiDBError("dump consistency must be 'snapshot' or 'none'")
    infos = session.infoschema()
    if infos.schema_by_name(db_name) is None:
        raise TiDBError(f"Unknown database '{db_name}'")
    st = open_storage(dest)
    snap_ts = None
    prev_snap = None
    pin_key = None
    if consistency == "snapshot":
        snap_ts = session.execute("select now(6)")[-1].rows[0][0]
        prev_snap = session.get_sysvar("tidb_snapshot")
        session.execute(f"set tidb_snapshot = '{snap_ts}'")
        # pin the GC safepoint like backup_database: the stale read holds
        # no live txn, so without the pin GC could prune the dump's read
        # view mid-run (error 9006 partway through)
        read_ts = session.stale_read_ts()
        coord = session.domain.coordinator
        pin_key = f"dump-{read_ts}"
        coord.set_safepoint(pin_key, read_ts)
    out = {"db": db_name, "tables": [], "consistency": consistency,
           "snapshot": snap_ts}
    # base tables first, then views in dependency order, so view DDL
    # (which plans its select) can resolve its sources on import; views
    # carry schema only, never INSERT data
    all_infos = _dump_order(infos.tables_in_schema(db_name))
    try:
        _dump_tables(session, st, db_name, all_infos, fmt, out)
    finally:
        if snap_ts is not None:
            # restore the CALLER's view, not '' — the session may itself
            # be inside an explicit stale-read window
            session.set_sysvar("tidb_snapshot", prev_snap or "")
        if pin_key is not None:
            session.domain.coordinator.clear_safepoint(pin_key)
    st.write_text("metadata.json", json.dumps(out, indent=1))
    return out


def _dump_tables(session, st, db_name, all_infos, fmt, out):
    for info in all_infos:
        base = f"{db_name}.{info.name}"
        create = session.execute(
            f"show create table `{db_name}`.`{info.name}`")[-1].rows[0][1]
        st.write_text(base + "-schema.sql", create + ";\n")
        if info.is_view:
            out["tables"].append({"name": info.name, "rows": 0,
                                  "is_view": True})
            continue
        res = session.execute(
            f"select * from `{db_name}`.`{info.name}`")[-1]
        rows = res.rows  # display strings (None = NULL)
        if fmt == "sql":
            with st.open_write(base + ".sql") as f:
                for i in range(0, len(rows), 256):
                    chunk = rows[i:i + 256]
                    vals = ",\n".join(
                        "(" + ", ".join(_sql_lit(v) for v in r) + ")"
                        for r in chunk)
                    f.write(f"INSERT INTO `{info.name}` VALUES\n{vals};\n")
        else:
            import csv
            with st.open_write(base + ".csv") as f:
                w = csv.writer(f)
                w.writerow(res.names)
                for r in rows:
                    # NULL sentinel is \N; a LITERAL leading backslash is
                    # escaped by doubling so the reader can tell them
                    # apart (mydumper-style)
                    w.writerow([
                        "\\N" if v is None
                        else ("\\" + v if isinstance(v, str)
                              and v.startswith("\\") else v)
                        for v in r])
        out["tables"].append({"name": info.name, "rows": len(rows)})


def _dump_order(tables):
    """Base tables (by name), then views topologically sorted so every view
    precedes views defined over it (cycles fall back to name order)."""
    base = sorted((t for t in tables if not t.is_view), key=lambda t: t.name)
    views = sorted((t for t in tables if t.is_view), key=lambda t: t.name)
    by_name = {v.name.lower(): v for v in views}
    deps = {}
    for v in views:
        names = set()
        try:
            from .parser import parse
            from .priv_check import _collect_tables
            tabs = []
            _collect_tables(parse(v.view["select"])[0], tabs)
            names = {tn.name.lower() for tn in tabs if tn.name.lower()
                     in by_name and tn.name.lower() != v.name.lower()}
        except Exception:
            pass
        deps[v.name.lower()] = names
    ordered, done = [], set()

    def visit(name, seen):
        if name in done or name in seen:
            return
        seen.add(name)
        for d in sorted(deps.get(name, ())):
            visit(d, seen)
        done.add(name)
        ordered.append(by_name[name])
    for v in views:
        visit(v.name.lower(), set())
    return base + ordered


_NUMERIC_RE = None


def _sql_lit(v) -> str:
    if v is None:
        return "NULL"
    global _NUMERIC_RE
    if _NUMERIC_RE is None:
        import re
        # canonical numerics only: a float() probe would unquote 'nan',
        # '12_3' (python underscore literals) and strip '0010' — display
        # values of NUMERIC columns always match this shape, so anything
        # else is string data and must be quoted
        _NUMERIC_RE = re.compile(r"-?(0|[1-9]\d*)(\.\d+)?([eE][+-]?\d+)?$")
    s = str(v)
    if _NUMERIC_RE.fullmatch(s):
        return s
    # newlines must be escaped or the ';\n' statement splitter would break
    s = (s.replace("\\", "\\\\").replace("'", "\\'")
         .replace("\n", "\\n").replace("\r", "\\r"))
    return "'" + s + "'"


def _str_lit(s: str) -> str:
    """Always-quoted literal: CSV fields are untyped strings; the INSERT
    cast converts them into numeric/date columns, so quoting everything is
    both safe and type-faithful."""
    s = (s.replace("\\", "\\\\").replace("'", "\\'")
         .replace("\n", "\\n").replace("\r", "\\r"))
    return "'" + s + "'"


# -- import with checkpoint/resume (reference: lightning checkpoints) ---------

class _ImportState:
    """Shared, locked import progress: checkpoint + conflict log."""

    def __init__(self, st):
        self.st = st
        self.mu = threading.Lock()
        self.ckpt = {"done_tables": [], "progress": {}}
        if st.exists("_import_checkpoint.json"):
            old = json.loads(st.read_text("_import_checkpoint.json"))
            self.ckpt["done_tables"] = old.get("done_tables", [])
            if "progress" in old:
                self.ckpt["progress"] = old["progress"]
            elif old.get("table"):  # pre-parallel single-cursor format
                self.ckpt["progress"] = {old["table"]: old["stmts_done"]}
        self.batches = 0
        self.conflicts = 0
        self._conflict_lines = []
        st.delete("_import_conflicts.jsonl")  # per-run log

    def write(self):
        self.st.write_text("_import_checkpoint.json",
                           json.dumps(self.ckpt))

    def advance(self, name, done):
        with self.mu:
            self.ckpt["progress"][name] = done
            self.batches += 1
            self.write()
            return self.batches

    def finish_table(self, name):
        with self.mu:
            self.ckpt["done_tables"].append(name)
            self.ckpt["progress"].pop(name, None)
            self.write()

    def record_conflict(self, name, row_sql, err):
        with self.mu:
            self.conflicts += 1
            self._conflict_lines.append(json.dumps(
                {"table": name, "row": row_sql, "error": str(err)}))

    def flush_conflicts(self):
        with self.mu:
            if self._conflict_lines:
                self.st.write_text("_import_conflicts.jsonl",
                                   "\n".join(self._conflict_lines) + "\n")


def _exec_with_dup_handling(session, state, name, stmt, on_duplicate):
    """Run one INSERT batch; on a duplicate-key error under
    on_duplicate='record', retry row-by-row, logging each conflicting row
    (reference: lightning/errormanager — conflicts are data, not crashes)."""
    from .errors import ErrCode
    try:
        session.execute(stmt)
        return
    except TiDBError as e:
        if on_duplicate != "record" or getattr(
                e, "code", None) != ErrCode.DupEntry:
            raise
    from .parser import ast, parse
    parsed = parse(stmt)[0]
    if not isinstance(parsed, ast.InsertStmt):
        raise TiDBError("duplicate in a non-INSERT import statement")
    for row in parsed.values:
        single = ast.InsertStmt(table=parsed.table,
                                columns=list(parsed.columns), values=[row])
        sql = single.restore()
        try:
            session.execute(sql)
        except TiDBError as e2:
            if getattr(e2, "code", None) != ErrCode.DupEntry:
                raise
            state.record_conflict(name, sql, e2)


def _import_one_table(session, st, state, meta, target_db, t, on_duplicate,
                      crash_after_batches):
    name = t["name"]
    session.execute(f"use `{target_db}`")
    with state.mu:
        skip = state.ckpt["progress"].get(name, 0)
    if skip == 0 and not session.infoschema().has_table(target_db, name):
        session.execute(st.read_text(f"{meta['db']}.{name}-schema.sql"))
    if t.get("is_view"):
        state.finish_table(name)
        return
    data_name = f"{meta['db']}.{name}.sql"
    csv_name = f"{meta['db']}.{name}.csv"
    if not st.exists(data_name) and st.exists(csv_name):
        stmts = _csv_to_inserts(st.read_text(csv_name), name)
    else:
        stmts = _split_sql(st.read_text(data_name))
    done = 0
    for stmt in stmts:
        done += 1
        if done <= skip:
            continue
        _exec_with_dup_handling(session, state, name, stmt, on_duplicate)
        batches = state.advance(name, done)
        if (crash_after_batches is not None
                and batches >= crash_after_batches):
            raise TiDBError("import aborted (injected crash)")
    state.finish_table(name)


def import_dump(session, src: str, db_name: str | None = None,
                crash_after_batches: int | None = None, workers: int = 1,
                on_duplicate: str = "error") -> dict:
    """Load a dump produced by dump_database (sql or csv format).

    workers: table-level parallelism — each worker drives its own session
    over the shared domain (reference: lightning's table/index
    concurrency); the checkpoint file is shared and locked.
    on_duplicate: 'error' fails the run on a duplicate key (default);
    'record' logs conflicting rows to _import_conflicts.jsonl and keeps
    going (reference: lightning/errormanager). Known limit: a crash in
    the middle of a row-by-row conflict retry makes the RESUMED run see
    its own previously-inserted rows as conflicts (the checkpoint is
    per-statement); the log may then over-report — it never loses real
    conflicts."""
    if on_duplicate not in ("error", "record"):
        raise TiDBError("on_duplicate must be 'error' or 'record'")
    st = open_storage(src)
    meta = json.loads(st.read_text("metadata.json"))
    target_db = db_name or meta["db"]
    if session.infoschema().schema_by_name(target_db) is None:
        session.execute(f"create database `{target_db}`")
    state = _ImportState(st)
    pending = [t for t in meta["tables"]
               if t["name"] not in state.ckpt["done_tables"]]
    # views depend on base tables: create them LAST, serially
    views = [t for t in pending if t.get("is_view")]
    tables = [t for t in pending if not t.get("is_view")]

    if workers <= 1 or len(tables) <= 1:
        for t in tables + views:
            _import_one_table(session, st, state, meta, target_db, t,
                              on_duplicate, crash_after_batches)
    else:
        from .session import new_session
        errs = []
        emu = threading.Lock()
        it = iter(tables)
        imu = threading.Lock()

        def worker():
            ws = new_session(session.domain)
            while True:
                with imu:
                    t = next(it, None)
                if t is None:
                    return
                try:
                    _import_one_table(ws, st, state, meta, target_db, t,
                                      on_duplicate, crash_after_batches)
                except Exception as e:
                    with emu:
                        errs.append(e)
                    return

        threads = [threading.Thread(target=worker)
                   for _ in range(min(workers, len(tables)))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errs:
            # conflicts recorded before the failure must survive it: the
            # log is the operator's record of what on_duplicate='record'
            # skipped (the checkpoint makes the import resumable, the
            # conflict log is not rebuilt on resume)
            state.flush_conflicts()
            raise errs[0]
        for t in views:
            _import_one_table(session, st, state, meta, target_db, t,
                              on_duplicate, crash_after_batches)
    state.flush_conflicts()
    st.delete("_import_checkpoint.json")
    return {"db": target_db,
            "tables": [t["name"] for t in meta["tables"]],
            "conflicts": state.conflicts}


def _csv_to_inserts(text: str, table: str, batch: int = 256):
    """CSV dump (header row; \\N = NULL) → INSERT statement batches — the
    csv-format twin of the sql loader (reference: lightning/mydump csv
    parser)."""
    import csv
    rdr = csv.reader(io.StringIO(text))
    try:
        next(rdr)  # header
    except StopIteration:
        return

    def lit(v: str) -> str:
        if v == "\\N":
            return "NULL"
        if v.startswith("\\\\"):
            v = v[1:]  # un-escape the doubled leading backslash
        return _str_lit(v)

    rows = []
    for r in rdr:
        rows.append("(" + ", ".join(lit(v) for v in r) + ")")
        if len(rows) >= batch:
            yield f"INSERT INTO `{table}` VALUES " + ",".join(rows)
            rows = []
    if rows:
        yield f"INSERT INTO `{table}` VALUES " + ",".join(rows)


def _split_sql(text: str):
    """Split dump files on ';\n' statement boundaries (values never contain
    that sequence: _sql_lit escapes newlines are impossible in display
    strings, and the writer ends every statement with ';\\n')."""
    for part in text.split(";\n"):
        if part.strip():
            yield part
