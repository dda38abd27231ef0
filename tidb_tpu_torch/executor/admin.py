"""ADMIN CHECK TABLE / CHECK INDEX (reference: executor/admin.go — verifies
index KVs are consistent with row data)."""

from __future__ import annotations

from ..errors import TiDBError
from ..model import SchemaState
from ..table import Table
from .. import tablecodec


def check_index(session, info, index_name: str):
    """ADMIN CHECK INDEX t idx (reference: executor/admin.go
    CheckIndexExec): row↔index consistency for one index."""
    idx = info.find_index(index_name)
    if idx is None:
        raise TiDBError(f"index '{index_name}' does not exist on "
                        f"'{info.name}'")
    if idx.state != SchemaState.PUBLIC:
        raise TiDBError(f"index '{index_name}' is not public "
                        f"(state: {SchemaState.NAMES.get(idx.state, '?')})")
    txn = session.store.begin()
    try:
        tbl = Table(info, txn)
        rows = dict(tbl.iter_rows())
        _check_one_index(txn, info, idx, rows)
    finally:
        txn.rollback()


def _check_one_index(txn, info, idx, rows):
    """Scan the index range; every entry must point at a live row, and the
    entry count must equal the row count (each row yields exactly one entry
    per index — null-unique entries carry a handle suffix)."""
    seen = 0
    start, end = tablecodec.index_range(info.id, idx.id)
    for key, value in txn.scan(start, end):
        handle = tablecodec.decode_index_handle(value)
        if handle is None:
            handle = tablecodec.decode_index_values(key)[-1]
        if handle not in rows:
            raise TiDBError(
                f"index '{idx.name}' has orphan entry for handle {handle}")
        seen += 1
    if seen != len(rows):
        raise TiDBError(
            f"index '{idx.name}' count {seen} != row count {len(rows)}")


def check_table(session, info):
    """Every PUBLIC index is checked; in-flight online-DDL indexes are
    legitimately incomplete and skipped (the reference checks via the
    schema the statement resolved, which only has public indexes)."""
    txn = session.store.begin()
    try:
        tbl = Table(info, txn)
        rows = dict(tbl.iter_rows())
        for idx in info.indexes:
            if idx.state != SchemaState.PUBLIC:
                continue
            _check_one_index(txn, info, idx, rows)
    finally:
        txn.rollback()
