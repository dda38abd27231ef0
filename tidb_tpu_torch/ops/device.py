"""Device kernels of the port: the column layer, the expression compiler
(K2) and the group-by aggregate (K1) on PyTorch tensors.

Design (mirrors ``tidb_tpu/ops/device.py`` contract for contract):

- **Device**: every upload goes to :func:`device` — ``cuda`` unless the
  caller asked for the CPU with :func:`set_device`.  With no card and no
  such call the first upload raises :class:`DeviceNotAvailable`, which
  reaches the caller (it is not a :class:`DeviceUnsupported`, so the
  executor does not quietly fall back to the host engine).
- **Shapes**: arrays are padded to geometric row buckets (`bucket_rows`)
  and the live row count masks the padding, as in the reference, so the
  fragment's programs and scratch sizes stay stable across deltas.
- **Expressions**: `compile_expr` compiles an expression tree into a DAG
  of VM nodes (ops/kernels/expr_vm.py) instead of a traced closure.  All
  host-side precomputation — dictionary remaps, string LUTs, sorted
  IN-lists, decimal scales — happens here and lands in the program's
  constant tables.  DeviceUnsupported is raised exactly where the
  reference raises it.
- **Exactness**: decimals stay scaled int64 end to end; sums of them are
  exact; decimal division rounds half away from zero.
- **Aggregation**: `_agg_impl` is ops/kernels/groupby_agg.py, which keeps
  the reference's slot order and overflow contract.

reference parity: executor/aggregate.go (hash agg) → direct-bucket or
hash aggregation with atomics; expression/*_vec.go → the expression VM.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from ..errors import TiDBError
from ..expression.core import (
    Column as ExprColumn, Constant, ScalarFunc, phys_kind,
    K_DATE, K_DEC, K_FLOAT, K_INT, K_STR,
)
from ..sqltypes import POW10, TYPE_DATETIME, TYPE_TIMESTAMP
from .kernels import expr_vm as vm


class DeviceUnsupported(TiDBError):
    """Raised during compilation when an expression/type can't run on
    device; the executor falls back to the host kernels."""


class DeviceNotAvailable(TiDBError):
    """The configured device does not exist (no CUDA card, and the caller
    did not ask for the CPU)."""


# ---------------------------------------------------------------------------
# device selection
# ---------------------------------------------------------------------------

_DEVICE = ["cuda"]


def set_device(dev) -> torch.device:
    """Run the device engine on `dev` ("cuda", "cuda:1", "cpu", or a
    torch.device).  The CPU runs every kernel's plain PyTorch version.
    Every kernel launches on its tensors' card whatever the launching
    thread's current device is (``ops/kernels/build.py launch``), so
    "cuda:k" runs the engine on card k from any thread."""
    d = torch.device(dev)
    _DEVICE[0] = str(d)
    from . import residency
    # uploads and the auto budget belong to the previous device
    residency.bump_epoch(f"device set to {d}")
    with residency._LOCK:
        residency._AUTO_BUDGET[0] = None
    return d


def device() -> torch.device:
    """The device every upload targets; raises DeviceNotAvailable when it
    is a CUDA device and no card is visible."""
    d = torch.device(_DEVICE[0])
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceNotAvailable(
                "no CUDA device is available for the device engine; call "
                "tidb_tpu_torch.ops.device.set_device('cpu') to run its "
                "kernels' plain versions on the CPU")
        if d.index is None:  # tensors report an explicit index
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return max(p, 8)


# ---------------------------------------------------------------------------
# shape canonicalization: geometric row buckets
# ---------------------------------------------------------------------------


def bucket_rows(n: int, per_double: int = 2) -> int:
    """Smallest geometric bucket >= n: `per_double` buckets per doubling
    (2 = powers of sqrt(2): 8, 12, 16, 23, 32, 46, 64, ...). per_double <= 0
    disables bucketing (exact shapes). Worst-case padding overhead is
    2^(1/per_double) - 1 (~41% at 1, ~19% at 2)."""
    if per_double <= 0 or n <= 0:
        return n
    b, k = 8, 0
    while b < n:
        k += 1
        b = _math.ceil(2 ** (3 + k / per_double))
    return b


def shape_buckets(ctx) -> int:
    """The session's bucket granularity (sysvar tidb_device_shape_buckets;
    default 2 buckets per doubling, 0 = exact shapes)."""
    try:
        return int(ctx.get_sysvar("tidb_device_shape_buckets"))
    except Exception:
        return 2


def pad_host(arr, n_to: int, null_pad: bool = False):
    """Pad a host array to `n_to` rows. Data pads with zeros (any value is
    fine — padding is masked), null masks pad with True (`null_pad`) so a
    padding row reads as NULL even before the n_live mask applies."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n_to <= n:
        return arr
    if null_pad:
        out = np.ones(n_to, dtype=arr.dtype)
    else:
        out = np.zeros(n_to, dtype=arr.dtype)
    out[:n] = arr
    return out


def upload(arr, dev=None) -> torch.Tensor:
    """numpy → tensor on the device (through pinned memory for a card)."""
    dev = device() if dev is None else dev
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        arr = np.array(arr, copy=True, order="C")
    t = torch.from_numpy(arr)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


# ---------------------------------------------------------------------------
# column transfer
# ---------------------------------------------------------------------------

class DeviceCol:
    """Device representation of one column: data + null mask (+ dictionary
    for strings; data holds int32 codes)."""

    __slots__ = ("data", "nulls", "dictionary", "reps", "ftype", "host_col")

    def __init__(self, data, nulls, ftype, dictionary=None, reps=None,
                 host_col=None):
        self.data = data
        self.nulls = nulls
        self.ftype = ftype
        # For _ci columns the dictionary holds the sorted collation sort
        # keys (constants are transformed before lookup) and reps holds a
        # representative original value per class for output decode.
        self.dictionary = dictionary
        self.reps = reps
        # backing utils.chunk.Column (when known): host min/max feed static
        # key-range packing in the agg planner (device_exec._key_pack)
        self.host_col = host_col

    def decode_dict(self):
        """The dictionary that maps codes back to OUTPUT strings."""
        return self.reps if self.reps is not None else self.dictionary


def to_device_col(col, bucket: int | None = None) -> DeviceCol:
    """utils.chunk.Column → DeviceCol. Strings are dict-encoded host-side.

    The device tensors are cached on the Column THROUGH the residency
    manager (ops/residency.py): a table's working set is uploaded once per
    columnar-cache version and reused across queries, with every cached
    upload byte-accounted against `tidb_device_mem_budget`, LRU-evictable
    under pressure, and stamped with the device epoch.

    `bucket` (> len) pads the uploaded arrays to that static row count:
    padding rows carry null=True and zeroed data, and the consuming
    pipeline masks them via its live-row count. One padded length is
    cached per column: a LONGER cached upload serves shorter requests as a
    device-side slice; only a grow evicts and re-uploads."""
    from . import residency
    want = bucket if bucket is not None and bucket > len(col) else len(col)
    cached = residency.lookup(col, want)
    if cached is None:
        dev = device()
        # chaos hook: a synthetic RESOURCE_EXHAUSTED at the upload
        # boundary (classified device OOM → run_device's evict-all →
        # retry → host-degradation ladder)
        from ..utils import failpoint
        failpoint.inject("device-upload-oom")
        if col.is_object():
            from ..sqltypes import TYPE_NEWDECIMAL
            if col.ftype.tp == TYPE_NEWDECIMAL:
                # wide decimals (precision > 18) are exact host bigints;
                # dict-encoding them as strings would break arithmetic
                raise DeviceUnsupported("wide-decimal column")
            from ..utils.collate import is_ci
            if is_ci(col.ftype.collate):
                # _ci columns encode as collation-class codes: ranks in
                # sort-key order, so code equality/ordering IS collation
                # semantics (utils/chunk.py dict_encode_ci)
                ci_codes, _kd, _reps = col.dict_encode_ci(col.ftype.collate)
                host = pad_host(np.asarray(ci_codes), want)
            else:
                codes, _uniq = col.dict_encode()
                host = pad_host(codes, want)
        else:
            host = pad_host(col.data, want)
        built = (upload(host, dev),
                 upload(pad_host(np.asarray(col.nulls, dtype=bool), want,
                                 True), dev))
        # compare-and-keep publish under the residency lock: a racing
        # builder's loser tensors are accounted as immediately evicted,
        # never leaked outside the ledger
        cached = residency.publish(col, *built)
    data, nulls = cached
    if int(data.shape[0]) > want:
        # cached at a larger bucket: on-device slice (no host transfer)
        data, nulls = data[:want], nulls[:want]
    if col.is_object():
        from ..utils.collate import is_ci
        if is_ci(col.ftype.collate):
            _cc, key_dict, reps = col.dict_encode_ci(col.ftype.collate)
            return DeviceCol(data, nulls, col.ftype, dictionary=key_dict,
                             reps=reps, host_col=col)
        _codes, uniq = col.dict_encode()
        return DeviceCol(data, nulls, col.ftype, dictionary=uniq,
                         host_col=col)
    return DeviceCol(data, nulls, col.ftype, host_col=col)


def meta_device_col(col):
    """(DeviceCol with data=None, (host_data, host_nulls)) — the streamed/
    paged protocol: the DeviceCol carries only what the expression compiler
    reads (ftype, dictionaries, host_col for min/max packing); the host
    arrays are sliced into pages and uploaded per block by the caller.
    Never touches device memory."""
    if col.is_object():
        from ..sqltypes import TYPE_NEWDECIMAL
        if col.ftype.tp == TYPE_NEWDECIMAL:
            raise DeviceUnsupported("wide-decimal column")
        from ..utils.collate import is_ci
        if is_ci(col.ftype.collate):
            ci_codes, key_dict, reps = col.dict_encode_ci(col.ftype.collate)
            return (DeviceCol(None, None, col.ftype, dictionary=key_dict,
                              reps=reps, host_col=col),
                    (ci_codes, col.nulls))
        codes, uniq = col.dict_encode()
        return (DeviceCol(None, None, col.ftype, dictionary=uniq,
                          host_col=col),
                (codes, col.nulls))
    return (DeviceCol(None, None, col.ftype, host_col=col),
            (col.data, col.nulls))


def broadcast_1d(d, nl, n):
    """Expand 0-d (constant) results to length n where a full array is
    structurally required."""
    if d.ndim == 0:
        d = d.expand(n)
    if nl.ndim == 0:
        nl = nl.expand(n)
    return d, nl


# ---------------------------------------------------------------------------
# expression → VM program compiler
# ---------------------------------------------------------------------------

def _kind(ft) -> str:
    return "f" if phys_kind(ft) == K_FLOAT else "i"


def compile_expr(expr, cols: dict):
    """Compile `expr` into a VM node: the program computes (data, nulls)
    per row from the env columns.  `cols` maps idx → DeviceCol (for
    dictionaries at compile time). Raises DeviceUnsupported when out of
    scope."""
    if isinstance(expr, ExprColumn):
        return vm.load(expr.idx, _kind(expr.ftype))
    if isinstance(expr, Constant):
        return _compile_const(expr, cols)
    if isinstance(expr, ScalarFunc):
        return _compile_func(expr, cols)
    raise DeviceUnsupported(f"cannot compile {type(expr).__name__} for device")


def _compile_const(expr: Constant, cols):
    v = expr.value
    if v is None:
        return vm.null_const("i")
    k = phys_kind(expr.ftype)
    if k == K_STR:
        raise DeviceUnsupported("bare string constants only valid in eq/in")
    if k == K_FLOAT:
        return vm.const(float(v), "f")
    return vm.const(int(v), "i")


def _dec_scale(e):
    return e.ftype.scale if phys_kind(e.ftype) == K_DEC else 0


def _to_common_numeric(sf, cols):
    """Compile both args of a binary numeric op to a common kind.
    Returns (kind, na, nb, scale)."""
    a, b = sf.args
    ka, kb = phys_kind(a.ftype), phys_kind(b.ftype)
    fa = compile_expr(a, cols)
    fb = compile_expr(b, cols)
    # string equality via dictionary codes
    if ka == K_STR or kb == K_STR:
        raise DeviceUnsupported("string args only supported in eq/in paths")
    if K_FLOAT in (ka, kb):
        def wrap(f, e):
            sc = _dec_scale(e)
            g = vm.to_f(f)
            return vm.divkf(g, POW10[sc]) if sc else g
        return K_FLOAT, wrap(fa, a), wrap(fb, b), 0
    if K_DEC in (ka, kb):
        s = max(_dec_scale(a), _dec_scale(b))

        def wrap(f, e):
            sc = _dec_scale(e)
            g = vm.to_i(f)
            return vm.mulk(g, POW10[s - sc]) if s > sc else g
        return K_DEC, wrap(fa, a), wrap(fb, b), s
    # ints / dates / datetimes
    promote_a = ka == K_DATE and b.ftype.tp in (TYPE_DATETIME, TYPE_TIMESTAMP)
    promote_b = kb == K_DATE and a.ftype.tp in (TYPE_DATETIME, TYPE_TIMESTAMP)

    def wrap(f, promote):
        g = vm.to_i(f)
        return vm.mulk(g, 86_400_000_000) if promote else g
    return K_INT, wrap(fa, promote_a), wrap(fb, promote_b), 0


_CMP_OPS = ("eq", "ne", "lt", "le", "gt", "ge")


def _compile_func(sf: ScalarFunc, cols):
    """Dispatch with a dictionary-pushdown fallback: a numeric function
    of one dict-encoded string column that the direct compiler declines
    (LENGTH, casts, string arithmetic coercions, …) host-evaluates over
    the dictionary into a LUT instead of falling back to the host path."""
    try:
        return _compile_func_direct(sf, cols)
    except DeviceUnsupported:
        f = _try_str_numeric_lut(sf, cols)
        if f is not None:
            return f
        raise


def _compile_func_direct(sf: ScalarFunc, cols):
    op = sf.op
    if op in _CMP_OPS:
        # string vs constant → dictionary code comparison
        a, b = sf.args
        if phys_kind(a.ftype) == K_STR or phys_kind(b.ftype) == K_STR:
            return _compile_str_cmp(sf, cols)
        _kind_, fa, fb, _s = _to_common_numeric(sf, cols)
        return vm.cmp(op, fa, fb)
    if op in ("add", "sub", "mul"):
        out_k = phys_kind(sf.ftype)
        if out_k == K_DEC and op == "mul":
            fa = _compile_scaled(sf.args[0], cols, _dec_scale(sf.args[0]))
            fb = _compile_scaled(sf.args[1], cols, _dec_scale(sf.args[1]))
            return vm.arith("mul", fa, fb)
        if out_k == K_DEC:
            s = sf.ftype.scale
            fa = _compile_scaled(sf.args[0], cols, s)
            fb = _compile_scaled(sf.args[1], cols, s)
            return vm.arith(op, fa, fb)
        _kind_, fa, fb, _s = _to_common_numeric(sf, cols)
        return vm.arith(op, fa, fb)
    if op == "div":
        out_k = phys_kind(sf.ftype)
        if out_k == K_FLOAT:
            _k, fa, fb, _s = _to_common_numeric(sf, cols)
            return vm.binary("DIV_F", fa, fb, kind="f")
        s1 = _dec_scale(sf.args[0])
        s2 = _dec_scale(sf.args[1])
        sr = sf.ftype.scale
        fa = _compile_scaled(sf.args[0], cols, s1)
        fb = _compile_scaled(sf.args[1], cols, s2)
        return vm.binary("DIV_DEC", fa, fb, imm=int(POW10[sr + s2 - s1]))
    if op in ("and", "or"):
        fa = _truth_arg(compile_expr(sf.args[0], cols))
        fb = _truth_arg(compile_expr(sf.args[1], cols))
        return vm.binary("AND" if op == "and" else "OR", fa, fb)
    if op == "not":
        return vm.unary("NOT", _truth_arg(compile_expr(sf.args[0], cols)))
    if op == "isnull":
        return vm.unary("ISNULL", compile_expr(sf.args[0], cols), "i")
    if op == "neg":
        fa = compile_expr(sf.args[0], cols)
        return vm.unary("NEG_F" if fa.kind == "f" else "NEG_I", fa)
    if op == "in_set":
        target = sf.args[0]
        values, has_null = sf.extra
        if phys_kind(target.ftype) == K_STR:
            return _compile_str_in(sf, cols)
        fa = compile_expr(target, cols)
        if len(values) == 0:
            # empty IN list (e.g. a HAVING-filtered subquery with no
            # qualifying rows): constant FALSE, NULL if the list's only
            # content was NULL
            return vm.in_table(fa, np.zeros(0, dtype=np.int64), has_null)
        arr = np.sort(np.asarray(values))
        if arr.dtype.kind not in "biuf":
            raise DeviceUnsupported("non-numeric IN list on device")
        return vm.in_table(fa, arr, has_null)
    if op == "case":
        return _compile_case(sf, cols)
    if op == "if":
        return _compile_case(ScalarFunc("case", sf.args, sf.ftype), cols)
    if op == "cast":
        return _compile_cast(sf, cols)
    if op == "coalesce":
        fs = [compile_expr(a, cols) for a in sf.args]
        tk = phys_kind(sf.ftype)
        if tk == K_STR:
            raise DeviceUnsupported("string coalesce")
        out = _coerce_kind(fs[0], sf.args[0], sf.ftype)
        for fx, ax in zip(fs[1:], sf.args[1:]):
            out = vm.binary("COALESCE", out, _coerce_kind(fx, ax, sf.ftype),
                            kind=out.kind)
        return out
    if op in ("year", "month", "dayofmonth", "day"):
        arg = sf.args[0]
        fa = compile_expr(arg, cols)
        ak = phys_kind(arg.ftype)
        is_dt = arg.ftype.tp in (TYPE_DATETIME, TYPE_TIMESTAMP)
        if ak != K_DATE and not is_dt:
            raise DeviceUnsupported(f"{op}() on non-temporal for device")
        part = {"year": 0, "month": 1, "dayofmonth": 2, "day": 2}[op]
        days = vm.to_i(fa)
        if is_dt:
            days = vm.Node("FLOORDIVK", (days,), 86_400_000_000, "i")
        return vm.Node("CIVIL", (days,), part, "i")
    if op == "abs":
        fa = compile_expr(sf.args[0], cols)
        return vm.unary("ABS_F" if fa.kind == "f" else "ABS_I", fa)
    if op in ("like", "regexp"):
        return _compile_str_pattern(sf, cols)
    raise DeviceUnsupported(f"scalar op {op} not available on device")


def _truth_arg(node):
    """The reference tests `d != 0` on the raw value; a float operand is
    turned into an int 0/1 truth value first (NULL preserved)."""
    return vm.unary("NZ_F", node, "i") if node.kind == "f" else node


# ---------------------------------------------------------------------------
# string-VALUED expressions: everything compiles to CODES into a sorted key
# dictionary (dictionary pushdown, generalized). A derived string expression
# — CASE over strings, SUBSTRING, UPPER, CONCAT with constants — either
# merges its arms' dictionaries (branches) or is evaluated host-side ONCE
# per distinct dictionary entry and becomes a device code-LUT.
# ---------------------------------------------------------------------------

_IMPURE_OPS = frozenset({"rand", "uuid", "sleep"})


def compile_str_expr(expr, cols):
    """Compile a string-valued expression → (node, key_dict, reps): node
    yields codes into the sorted `key_dict`; `reps` decodes codes back to
    output strings. Raises DeviceUnsupported outside the language."""
    if isinstance(expr, ExprColumn):
        dc = cols.get(expr.idx)
        if dc is None or dc.dictionary is None:
            raise DeviceUnsupported("no dictionary for string column")
        return vm.load(expr.idx, "i"), dc.dictionary, dc.decode_dict()
    if isinstance(expr, Constant):
        if expr.value is None:
            e = np.array([b""], dtype=object)
            return vm.null_const("i"), e, e
        v = (expr.value if isinstance(expr.value, bytes)
             else str(expr.value).encode())
        from ..utils.collate import is_ci, sort_key
        key = (sort_key(v, expr.ftype.collate)
               if is_ci(expr.ftype.collate) else v)
        return (vm.const(0, "i"), np.array([key], dtype=object),
                np.array([v], dtype=object))
    if isinstance(expr, ScalarFunc) and expr.op in ("case", "if",
                                                    "coalesce"):
        return _compile_str_branch(expr, cols)
    if isinstance(expr, ScalarFunc):
        return _compile_str_dict_pushdown(expr, cols)
    raise DeviceUnsupported(
        f"{type(expr).__name__} string expression on device")


def _case_chain(conds, arm_nodes, kind, else_node=None):
    """CASE semantics as VM nodes: the first condition that is true and
    non-NULL picks its arm; no match and no ELSE gives NULL."""
    out = vm.null_const(kind)
    decided = vm.const(0, "i")
    for cd, rd in zip(conds, arm_nodes):
        cond = vm.binary("BAND", vm.unary("TRUTHY", _truth_arg(cd), "i"),
                         vm.unary("BNOT", decided, "i"))
        out = vm.sel(cond, rd, out, kind)
        decided = vm.binary("BOR", decided, cond)
    if else_node is not None:
        out = vm.sel(decided, out, else_node, kind)
    return out


def _compile_str_branch(sf, cols):
    """String-valued CASE/IF/COALESCE: arms compile to their own code
    spaces, merged into one union dictionary via static remap tables."""
    from ..utils.collate import is_ci
    args = sf.args
    if is_ci(sf.ftype.collate) or any(
            is_ci(a.ftype.collate) for a in args
            if phys_kind(a.ftype) == K_STR):
        # arm key spaces would mix raw bytes with per-collation sort keys
        raise DeviceUnsupported("_ci string branches on device")
    if sf.op == "coalesce":
        conds = None
        arms = list(args)
    else:
        has_else = len(args) % 2 == 1
        pairs = (len(args) - (1 if has_else else 0)) // 2
        conds = [compile_expr(args[2 * p], cols) for p in range(pairs)]
        arms = [args[2 * p + 1] for p in range(pairs)]
        if has_else:
            arms.append(args[-1])
    compiled = [compile_str_expr(a, cols) for a in arms]
    all_keys = np.concatenate([kd for _f, kd, _r in compiled])
    all_reps = np.concatenate([r for _f, _kd, r in compiled])
    key_dict, first = np.unique(all_keys, return_index=True)
    reps = all_reps[first]
    arm_nodes = [vm.lut(vm.to_i(f), np.searchsorted(key_dict, kd)
                        .astype(np.int64))
                 for f, kd, _r in compiled]
    if sf.op == "coalesce":
        out = arm_nodes[0]
        for node in arm_nodes[1:]:
            out = vm.binary("COALESCE", out, node)
        return out, key_dict, reps
    n_conds = len(conds)
    else_node = arm_nodes[-1] if len(arm_nodes) > n_conds else None
    return (_case_chain(conds, arm_nodes[:n_conds], "i", else_node),
            key_dict, reps)


def _single_str_col(expr, cols):
    """The one dict-encoded string column an expression reads, or raise."""
    used: set = set()
    expr.columns_used(used)
    if len(used) != 1:
        raise DeviceUnsupported(
            "dictionary pushdown needs exactly one column input")
    idx = next(iter(used))
    dc = cols.get(idx)
    if dc is None or dc.dictionary is None or phys_kind(dc.ftype) != K_STR:
        raise DeviceUnsupported("dictionary pushdown needs a string column")
    return idx, dc


def _host_eval_over_dict(expr, dc):
    """Evaluate `expr` host-side once per distinct dictionary entry PLUS
    one NULL input row → (values, nulls) of length len(dict)+1, where the
    last slot is the expression's output FOR NULL INPUT."""
    def check(e):
        if isinstance(e, ScalarFunc):
            if e.op in _IMPURE_OPS:
                raise DeviceUnsupported(f"impure {e.op} on device")
            for a in e.args:
                check(a)
    check(expr)
    from ..utils.chunk import Chunk as HChunk, Column as HColumn
    src = dc.decode_dict()
    n = len(src)
    data = np.empty(n + 1, dtype=object)
    data[:n] = np.asarray(src, dtype=object)
    data[n] = b""
    nulls = np.zeros(n + 1, dtype=bool)
    nulls[n] = True
    col = HColumn(dc.ftype, data, nulls)
    local = expr.transform_columns(lambda c: ExprColumn(0, c.ftype))
    return local.eval(HChunk([col]))


def _compile_str_dict_pushdown(sf, cols):
    """String→string function of one dict column: host-evaluate over the
    dictionary, build the output dictionary, device op = code LUT."""
    from ..utils.collate import is_ci
    if is_ci(sf.ftype.collate):
        raise DeviceUnsupported("_ci derived string on device")
    idx, dc = _single_str_col(sf, cols)
    data, nulls = _host_eval_over_dict(sf, dc)
    vals = np.array([v if isinstance(v, bytes) else str(v).encode()
                     for v in data], dtype=object)
    key_dict, inv = np.unique(vals, return_inverse=True)
    # NULL input rows read the null slot — the expression may map NULL to
    # a value (COALESCE etc.)
    node = vm.lutn(vm.load(idx, "i"), inv.astype(np.int64),
                   np.asarray(nulls, dtype=bool))
    return node, key_dict, key_dict


def _try_str_numeric_lut(sf, cols):
    """Numeric-valued function of one dict string column (LENGTH, casts,
    string→number …): host-evaluate over the dictionary → numeric LUT.
    Returns None when the shape doesn't apply."""
    k = phys_kind(sf.ftype)
    if k == K_STR:
        return None
    try:
        idx, dc = _single_str_col(sf, cols)
    except DeviceUnsupported:
        return None
    data, nulls = _host_eval_over_dict(sf, dc)
    if k == K_FLOAT:
        arr = np.asarray(data, dtype=np.float64)
    else:
        arr = np.asarray(data).astype(np.int64)
    return vm.lutn(vm.load(idx, "i"), arr, np.asarray(nulls, dtype=bool))


def _compile_str_pattern(sf, cols):
    """LIKE / REGEXP on a dict-encoded string column against a constant
    pattern: evaluate the predicate HOST-SIDE over the (small, distinct)
    dictionary once; the device op is a 0/1 table lookup by code."""
    from ..expression.core import like_to_regex
    import re as _re
    target, pat = sf.args[0], sf.args[1]
    if phys_kind(target.ftype) != K_STR:
        raise DeviceUnsupported(f"{sf.op} target must be a string value")
    if not isinstance(pat, Constant):
        raise DeviceUnsupported(f"{sf.op} pattern must be a constant")
    ft, key_dict, _reps = compile_str_expr(target, cols)
    if pat.value is None:
        return vm.null_const("i")
    from ..utils.collate import is_ci
    ci = is_ci(target.ftype.collate)
    pv = (pat.value if isinstance(pat.value, bytes)
          else str(pat.value).encode())
    if sf.op == "like":
        if ci:
            # _ci dictionary holds sort keys: match the sort-keyed pattern
            rx = like_to_regex(_expr_const_key(target, pv))
        else:
            # sf.extra carries the escape-aware regex the builder compiled
            rx = sf.extra if sf.extra is not None else like_to_regex(pv)
        match = rx.match
    else:
        if ci:
            raise DeviceUnsupported("regexp on _ci column")
        rx = _re.compile(pv)
        match = rx.search
    nd = len(key_dict)
    bits = np.zeros(nd, dtype=np.int64)
    for i, v in enumerate(key_dict):
        b = v if isinstance(v, bytes) else str(v).encode()
        bits[i] = match(b) is not None
    return vm.lut(vm.to_i(ft), bits)


def _compile_scaled(e, cols, target_scale):
    f = compile_expr(e, cols)
    sc = _dec_scale(e)
    k = phys_kind(e.ftype)
    if k in (K_FLOAT, K_STR):
        raise DeviceUnsupported("float→decimal on device")
    g = vm.to_i(f)
    return vm.mulk(g, POW10[target_scale - sc]) if target_scale > sc else g


def _coerce_kind(node, e, out_ft):
    k, ok = phys_kind(e.ftype), phys_kind(out_ft)
    if ok == K_FLOAT:
        d = vm.to_f(node)
        if k == K_DEC:
            d = vm.divkf(d, POW10[e.ftype.scale])
        return d
    if ok == K_DEC:
        d = vm.to_i(node)
        sc = _dec_scale(e)
        if out_ft.scale > sc:
            d = vm.mulk(d, POW10[out_ft.scale - sc])
        return d
    return vm.to_i(node)


def _compile_case(sf, cols):
    args = sf.args
    has_else = len(args) % 2 == 1
    pairs = (len(args) - (1 if has_else else 0)) // 2
    if phys_kind(sf.ftype) == K_STR:
        raise DeviceUnsupported("string CASE on device")
    fs = [compile_expr(a, cols) for a in args]
    kind = _kind(sf.ftype)
    conds = [fs[2 * p] for p in range(pairs)]
    arms = [_coerce_kind(fs[2 * p + 1], args[2 * p + 1], sf.ftype)
            for p in range(pairs)]
    else_node = (_coerce_kind(fs[-1], args[-1], sf.ftype) if has_else
                 else None)
    return _case_chain(conds, arms, kind, else_node)


def _compile_cast(sf, cols):
    src = sf.args[0]
    f = compile_expr(src, cols)
    sk, tk = phys_kind(src.ftype), phys_kind(sf.ftype)
    if K_STR in (sk, tk):
        raise DeviceUnsupported("string casts on device")
    if tk == K_FLOAT:
        d = vm.to_f(f)
        if sk == K_DEC:
            d = vm.divkf(d, POW10[src.ftype.scale])
        return d
    if tk == K_DEC:
        if sk == K_DEC:
            diff = sf.ftype.scale - src.ftype.scale
            if diff >= 0:
                return vm.mulk(vm.to_i(f), POW10[diff])
            return vm.Node("ROUNDDIVK", (f,), int(POW10[-diff]), "i")
        if sk == K_FLOAT:
            scaled = vm.arith("mul", f,
                              vm.const(float(POW10[sf.ftype.scale]), "f"))
            return vm.unary("RINT", scaled, "i")
        return vm.mulk(vm.to_i(f), POW10[sf.ftype.scale])
    # int target
    if sk == K_DEC:
        return vm.Node("ROUNDDIVK", (f,), int(POW10[src.ftype.scale]), "i")
    if sk == K_FLOAT:
        return vm.unary("RINT", f, "i")
    return vm.to_i(f)


def _compile_str_cmp(sf, cols):
    a, b = sf.args
    # ordering comparisons on dictionary codes are valid because every key
    # dictionary is sorted (np.unique bytes / sort-key classes for _ci)
    if isinstance(b, Constant) and not isinstance(a, Constant):
        lhs, const = a, b
    elif isinstance(a, Constant) and not isinstance(b, Constant):
        lhs, const = b, a
        # flip comparison direction
        sf = ScalarFunc({"lt": "gt", "gt": "lt", "le": "ge", "ge": "le"}.get(
            sf.op, sf.op), [b, a], sf.ftype)
    else:
        return _compile_str_cmp_exprs(sf, cols)
    fl, key_dict, _reps = compile_str_expr(lhs, cols)
    if const.value is None:
        return vm.null_const("i")
    v = _expr_const_key(lhs, const.value)
    code = _key_code_for(key_dict, v)
    exact = code >= 0
    pos = code if exact else int(np.searchsorted(key_dict, v))
    if exact:
        return vm.cmp(sf.op, vm.to_i(fl), vm.const(pos, "i"))
    # between codes for range compares
    return vm.cmp(sf.op, vm.to_f(fl), vm.const(pos - 0.5, "f"))


def _expr_const_key(expr, const_val):
    """A bytes constant in a string EXPRESSION's key space (its collation
    decides whether the key is the raw bytes or the sort key)."""
    from ..utils.collate import is_ci, sort_key
    v = const_val if isinstance(const_val, bytes) else str(const_val).encode()
    if is_ci(expr.ftype.collate):
        v = sort_key(v, expr.ftype.collate)
    return v


def _key_code_for(key_dict, key):
    """Exact code of `key` in a sorted key dictionary, or -2 (never
    matches: codes are >= 0)."""
    pos = int(np.searchsorted(key_dict, key))
    if pos < len(key_dict) and key_dict[pos] == key:
        return pos
    return -2


def _compile_str_cmp_exprs(sf, cols):
    """expr-vs-expr string comparison (col=col included): both sides map
    into the UNION of their key dictionaries, where code order is value
    order for both — then it's an int compare."""
    from ..utils.collate import is_ci
    a, b = sf.args
    ca, cb = a.ftype.collate, b.ftype.collate
    if (is_ci(ca) or is_ci(cb)) and ca != cb:
        # different sort-key spaces cannot union consistently
        raise DeviceUnsupported("mixed-collation string compare on device")
    fa, kda, _ra = compile_str_expr(a, cols)
    fb, kdb, _rb = compile_str_expr(b, cols)
    union = np.unique(np.concatenate([kda, kdb]))
    ua = vm.lut(vm.to_i(fa), np.searchsorted(union, kda).astype(np.int64))
    ub = vm.lut(vm.to_i(fb), np.searchsorted(union, kdb).astype(np.int64))
    return vm.cmp(sf.op, ua, ub)


def _compile_str_in(sf, cols):
    target = sf.args[0]
    values, has_null = sf.extra
    ft, key_dict, _reps = compile_str_expr(target, cols)
    codes = sorted(set(
        c for c in (_key_code_for(key_dict, _expr_const_key(target, v))
                    for v in values) if c >= 0))
    return vm.in_table(vm.to_i(ft), np.asarray(codes, dtype=np.int64),
                       has_null)


# ---------------------------------------------------------------------------
# fused aggregation
# ---------------------------------------------------------------------------

def _agg_impl(key_cols, key_nulls, val_cols, val_nulls, mask,
              n_keys, agg_ops, capacity, pack=None):
    """Filter mask + group-by + aggregate over `capacity` output slots.

    key_cols: tuple of int64 tensors (dict codes / ints). agg_ops: tuple of
    ("sum_i"|"sum_f"|"count"|"min"|"max"|"first"|"cnt_dist") aligned with
    val_cols. pack: optional static tuple of (bits, offset) per key when
    every key's value range is known; groups then come out in packed-key
    order (NULL packs as 0, its own group, first). Groups beyond
    `capacity` are counted (n_groups > capacity) and the caller retries
    with a bigger capacity.  Returns (key_out, key_null_out, results,
    result_nulls, n_groups, valid)."""
    from .kernels import groupby_agg
    return groupby_agg.groupby_agg(key_cols, key_nulls, val_cols, val_nulls,
                                   mask, n_keys, agg_ops, capacity, pack)


def _agg_entry(key_cols, key_nulls, val_cols, val_nulls, mask,
               n_keys, agg_ops, capacity, pack=None):
    return _agg_impl(key_cols, key_nulls, val_cols, val_nulls, mask,
                     n_keys=n_keys, agg_ops=agg_ops, capacity=capacity,
                     pack=pack)


#: standalone entry (direct kernel callers and tests); the SQL executor
#: calls _agg_impl from its fused pipeline
_agg_kernel = _agg_entry

# ---------------------------------------------------------------------------
# the standalone join match (K7, ops/kernels/join_match.py)
# ---------------------------------------------------------------------------

def device_join_match(build_keys, probe_keys):
    """Mirror of ops.host.join_match with device kernels. build_keys /
    probe_keys: (np data int64, np nulls) — pre-combined single key column
    (the caller combines multi-column keys via host factorization).
    Returns numpy (probe_idx, build_idx): probe-major, each probe row's
    build rows in (key, row) order, NULL keys on either side matching
    nothing — the reference's pairs (``tidb_tpu/ops/device.py:1506``).
    The keys go up, K7 matches them on the device, and the pairs come
    back."""
    from .kernels import join_match
    bk, bn = build_keys
    pk, pn = probe_keys
    if len(bk) == 0 or len(pk) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    d = device()
    pi, bi = join_match.match(
        upload(np.asarray(bk, dtype=np.int64), d),
        upload(np.asarray(bn, dtype=bool), d),
        upload(np.asarray(pk, dtype=np.int64), d),
        upload(~np.asarray(pn, dtype=bool), d))
    return pi.cpu().numpy(), bi.cpu().numpy()
