"""Partitioned tables: routing, views, and pruning (reference:
table/tables/partition.go PartitionedTable + locatePartition, and the planner
rule planner/core/rule_partition_processor.go).

Design: each partition is a physical table id; a row's partition is a pure
function of one column's internal value (bare column or YEAR/MONTH/TO_DAYS of
a date column).  The row/index codec, the MVCC store, the columnar cache, and
the delta machinery all operate on physical ids and stay partition-oblivious;
everything partition-aware lives here plus thin dispatch in table.Table.
"""

from __future__ import annotations

from .errors import TiDBError, ErrCode
from .model import PartitionDef, PartitionInfo, TableInfo
from .sqltypes import (
    TYPE_DATE, TYPE_DATETIME, TYPE_NEWDATE, TYPE_TIMESTAMP,
    days_to_date, micros_to_datetime,
)

MAXVALUE = "MAXVALUE"

_PART_FUNCS = ("year", "month", "to_days")

# TO_DAYS('1970-01-01') in MySQL — internal dates count from the unix epoch
_TO_DAYS_EPOCH = 719528


class NoPartitionError(TiDBError):
    def __init__(self, value):
        super().__init__(f"Table has no partition for value {value}",
                         code=ErrCode.NoPartitionForGivenValue)


def build_partition_info(popt, tbl: TableInfo, gen_id) -> PartitionInfo:
    """AST PartitionOpt → PartitionInfo with physical ids allocated via
    gen_id() (reference: ddl/partition.go buildTablePartitionInfo)."""
    from .parser import ast

    expr_node = popt.expr
    func = ""
    if isinstance(expr_node, ast.FuncCall) and expr_node.name in _PART_FUNCS:
        func = expr_node.name
        if len(expr_node.args) != 1 or not isinstance(expr_node.args[0],
                                                      ast.ColumnName):
            raise TiDBError("partition function must take a single column",
                            code=ErrCode.PartitionFunctionIsNotAllowed)
        col_node = expr_node.args[0]
    elif isinstance(expr_node, ast.ColumnName):
        col_node = expr_node
    else:
        raise TiDBError(
            "unsupported partition expression (use a column or "
            "YEAR/MONTH/TO_DAYS of a column)",
            code=ErrCode.PartitionFunctionIsNotAllowed)
    col = tbl.find_column(col_node.name)
    if col is None:
        raise TiDBError(f"Unknown column '{col_node.name}' in partition "
                        "function", code=ErrCode.BadField)

    pinfo = PartitionInfo(type=popt.type, expr=expr_node.restore(),
                          col_name=col.name, func=func, num=popt.num)

    if popt.type == "hash":
        n = popt.num or len(popt.defs)
        if n <= 0:
            raise TiDBError("wrong number of HASH partitions",
                            code=ErrCode.PartitionsMustBeDefined)
        pinfo.num = n
        names = [d[0] for d in popt.defs] if popt.defs else \
            [f"p{i}" for i in range(n)]
        for name in names:
            pinfo.defs.append(PartitionDef(id=gen_id(), name=name))
        return pinfo

    if not popt.defs:
        raise TiDBError("For RANGE/LIST partitions each partition must be "
                        "defined", code=ErrCode.PartitionsMustBeDefined)
    for name, kind, values in popt.defs:
        append_partition_def(pinfo, col, name, kind, values, gen_id)
    return pinfo


def append_partition_def(pinfo: PartitionInfo, col, name, kind, values,
                         gen_id):
    """Validate and append one RANGE/LIST partition definition — shared by
    CREATE TABLE and ALTER TABLE ADD PARTITION (reference: ddl/partition.go
    checkAddPartitionValue)."""
    if pinfo.find_def(name) is not None:
        raise TiDBError(f"Duplicate partition name {name}",
                        code=ErrCode.SameNamePartition)
    if pinfo.type == "range":
        if kind != "less_than" or len(values) != 1:
            raise TiDBError("RANGE partitions require VALUES LESS THAN",
                            code=ErrCode.PartitionRequiresValues)
        prev = pinfo.defs[-1].less_than if pinfo.defs else None
        bound = _cast_bound(values[0], col, pinfo.func)
        if prev == MAXVALUE or (prev is not None and bound != MAXVALUE
                                and bound <= prev):
            raise TiDBError(
                "VALUES LESS THAN value must be strictly increasing for "
                "each partition", code=ErrCode.RangeNotIncreasing)
        pinfo.defs.append(PartitionDef(id=gen_id(), name=name,
                                       less_than=bound))
    else:  # list
        if kind != "in":
            raise TiDBError("LIST partitions require VALUES IN",
                            code=ErrCode.PartitionRequiresValues)
        vals = [_cast_bound(v, col, pinfo.func) if v is not None else None
                for v in values]
        pinfo.defs.append(PartitionDef(id=gen_id(), name=name,
                                       in_values=vals))


def _cast_bound(node_or_value, col, func):
    """Evaluate/cast a partition bound literal into the comparison domain:
    the column's internal representation for bare-column partitioning, a
    plain int for YEAR/MONTH/TO_DAYS."""
    from .parser import ast
    v = node_or_value
    if isinstance(v, str) and v == MAXVALUE:
        return MAXVALUE
    if isinstance(v, ast.ExprNode):
        from .expression import ExprBuilder, Schema
        v = ExprBuilder(Schema([])).build(v).eval_scalar()
    if func:
        return int(v)
    from .table import cast_value
    return cast_value(v, col.ftype)


def check_partition_keys(tbl: TableInfo):
    """MySQL rule: every unique key (incl. the PK) on a partitioned table
    must include the partitioning column (reference: ddl/partition.go
    checkPartitionKeysConstraint)."""
    p = tbl.partition
    if p is None:
        return
    pcol = p.col_name.lower()
    if tbl.pk_is_handle:
        pk = next((c for c in tbl.columns if c.id == tbl.pk_col_id), None)
        if pk is not None and pk.name.lower() != pcol:
            raise TiDBError(
                "A PRIMARY KEY must include all columns in the table's "
                "partitioning function", code=ErrCode.UniqueKeyNeedAllFieldsInPf)
    for idx in tbl.indexes:
        if not idx.unique:
            continue
        if pcol not in {ic.name.lower() for ic in idx.columns}:
            raise TiDBError(
                f"A {'PRIMARY KEY' if idx.primary else 'UNIQUE INDEX'} must "
                "include all columns in the table's partitioning function",
                code=ErrCode.UniqueKeyNeedAllFieldsInPf)


# -- row routing -------------------------------------------------------------

def make_part_fn(info: TableInfo):
    """-> fn(row_dict) -> partition value (int/bytes/None).  Row dicts hold
    internal representations ({col_id: value})."""
    p = info.partition
    col = info.find_column(p.col_name)
    cid = col.id
    func = p.func
    if not func:
        return lambda row: row.get(cid)
    is_dt = col.ftype.tp in (TYPE_DATETIME, TYPE_TIMESTAMP)

    def _to_date(v):
        if is_dt:
            return micros_to_datetime(int(v)).date()
        return days_to_date(int(v))

    if func == "year":
        return lambda row: (None if row.get(cid) is None
                            else _to_date(row[cid]).year)
    if func == "month":
        return lambda row: (None if row.get(cid) is None
                            else _to_date(row[cid]).month)
    # to_days
    if is_dt:
        return lambda row: (None if row.get(cid) is None
                            else int(row[cid]) // 86_400_000_000
                            + _TO_DAYS_EPOCH)
    return lambda row: (None if row.get(cid) is None
                        else int(row[cid]) + _TO_DAYS_EPOCH)


def locate_partition(pinfo: PartitionInfo, pval) -> PartitionDef:
    """Partition value → PartitionDef (reference: partition.go
    locatePartition). NULL routes to the first range partition (MySQL
    semantics), hashes as 0, and must be listed for LIST."""
    if pinfo.type == "hash":
        h = 0 if pval is None else _hash_val(pval)
        return pinfo.defs[h % pinfo.num]
    if pinfo.type == "range":
        if pval is None:
            return pinfo.defs[0]
        for d in pinfo.defs:
            if d.less_than == MAXVALUE or _lt(pval, d.less_than):
                return d
        raise NoPartitionError(_fmt(pval))
    # list
    for d in pinfo.defs:
        for v in d.in_values:
            if (v is None and pval is None) or (v is not None and v == pval):
                return d
    raise NoPartitionError(_fmt(pval))


def _hash_val(v):
    if isinstance(v, (bytes, bytearray)):
        # stable across processes (python str hash is seeded)
        import zlib
        return zlib.crc32(bytes(v))
    return abs(int(v))


def _lt(a, b):
    if isinstance(a, (bytes, bytearray)) != isinstance(b, (bytes, bytearray)):
        return False
    return a < b


def _fmt(v):
    return v.decode("utf-8", "replace") if isinstance(v, bytes) else v


# -- physical partition views -------------------------------------------------

def partition_view(info: TableInfo, pdef: PartitionDef) -> TableInfo:
    """A TableInfo clone whose id is the partition's physical id; the codec
    and store layers see a plain table.  Cached per (info, partition)."""
    cache = getattr(info, "_pviews", None)
    if cache is None:
        cache = {}
        object.__setattr__(info, "_pviews", cache)
    view = cache.get(pdef.id)
    if view is None:
        view = TableInfo.from_json(info.to_json())
        view.id = pdef.id
        view.partition = None
        cache[pdef.id] = view
    return view


def index_phys_ids(info: TableInfo) -> list:
    """Physical ids whose key ranges carry this table's index entries: the
    table itself, plus every partition for a partitioned table."""
    ids = [info.id]
    if info.partition is not None:
        ids += [d.id for d in info.partition.defs]
    return ids


# -- planner pruning ----------------------------------------------------------

def prune_partitions(info: TableInfo, defs, conds):
    """Filter candidate PartitionDefs with scan predicates (reference:
    rule_partition_processor.go). Handles cmp(col, const) on the partition
    column: equality prunes every type; ranges prune RANGE tables on a
    bare column, and, as bounds on the function's value, on YEAR or
    TO_DAYS of a column (the reference prunes no range there)."""
    p = info.partition
    if not conds:
        return defs
    from .statistics.selectivity import _col_const
    pcol = p.col_name.lower()
    fn = make_part_fn(info)
    col_id = info.find_column(p.col_name).id
    from .table import cast_value
    col = info.find_column(p.col_name)
    out = list(defs)
    for cond in conds:
        cc = _col_const(cond)
        if cc is None:
            continue
        ecol, v, op = cc
        if ecol.name.lower() != pcol:
            continue
        const = cond.args[1] if cond.args[0] is ecol else cond.args[0]
        if _time_units(const.ftype) != _time_units(col.ftype) and \
                None not in (_time_units(const.ftype), _time_units(col.ftype)):
            # a DATETIME bound (micros) on a DATE column (days), as
            # DATE_ADD gives one: its value is not in the column's units,
            # so it prunes nothing (the reference casts it unchanged and
            # fails or prunes wrongly)
            continue
        try:
            iv = cast_value(v, col.ftype)
        except Exception:
            continue
        pv = fn({col_id: iv})
        if op == "eq":
            try:
                target = locate_partition(p, pv)
            except NoPartitionError:
                return []
            out = [d for d in out if d.id == target.id]
        elif p.type == "range" and op in ("lt", "le", "gt", "ge"):
            if p.func in ("year", "to_days"):
                if pv is None:
                    continue
                op = _monotone_op(op, pv, fn({col_id: iv - 1}))
            elif p.func:
                continue
            out = [d for d in out if _range_may_match(p, d, pv, op)]
    return out


def _monotone_op(op, pv, pv_before):
    """`col OP v` as a bound on f(col) for a non-decreasing f (YEAR,
    TO_DAYS) with pv = f(v): col >= v or col > v gives f(col) >= pv, col
    <= v gives f(col) <= pv, and col < v gives f(col) < pv where v is the
    first value of its f (f one unit below v is smaller), else <= pv."""
    if op in ("gt", "ge"):
        return "ge"
    if op == "lt" and pv_before is not None and pv_before < pv:
        return "lt"
    return "le"


def _time_units(ft):
    """"days" for a DATE, "micros" for a DATETIME / TIMESTAMP, else None."""
    if ft.tp in (TYPE_DATE, TYPE_NEWDATE):
        return "days"
    if ft.tp in (TYPE_DATETIME, TYPE_TIMESTAMP):
        return "micros"
    return None


def _range_may_match(pinfo, pdef, v, op):
    """Could any row in range-partition pdef satisfy `col OP v`?"""
    idx = next(i for i, d in enumerate(pinfo.defs) if d.id == pdef.id)
    lo = None if idx == 0 else pinfo.defs[idx - 1].less_than  # inclusive-from
    hi = pdef.less_than                                       # exclusive
    if lo == MAXVALUE:
        return False  # unreachable layout, defensive
    if op in ("lt", "le"):
        # need a row with col < v (or <=): partition start must be below v
        if lo is None:
            return True
        return _lt(lo, v) or (op == "le" and lo == v)
    # gt / ge: need a row with col > v (or >=): partition end must be above v
    if hi == MAXVALUE:
        return True
    return _lt(v, hi)
