"""K2/K3: the expression VM — filter mask, group keys and aggregate inputs
of a scan-aggregate fragment, evaluated in one pass over the rows.

``ops/device.compile_expr`` compiles each SQL expression into a small DAG
of :class:`Node` s.  :meth:`Program.build` flattens the fragment's
conditions, keys and values into ONE register program: instructions of
8 int32 (opcode, dst, a, b, c, i0, i1, i2) over registers that each hold
an int64 or float64 value and a null bit, plus two constant tables
(int64 and float64) that carry every host-side precomputation — decimal
scales, dictionary remaps, string LUTs, sorted IN-lists.

Two executors run the same program:

* ``csrc/expr_vm.cu`` (CUDA tensors): persistent blocks walk tiles of
  rows; each thread decodes an instruction once per tile and applies it
  to several rows, over a register file sized to the program in shared
  memory (:func:`launch_plan`), its arguments by value
  (:func:`pack_args`); an output that is an input column unchanged is
  handed on as that column, not copied (:func:`handed_on`);
* :func:`interpret` (CPU tensors, and the reference the card's kernel is
  held to): the program run instruction by instruction on whole columns.

With ``finish=(pvalid, kind)`` the mask is a join's match flag (an ON
clause's residuals refining a probe's) and the same launch also writes
K5a's finish of it — the join kind's valid rows, the no-match map and
their count (``join_probe.finish_plain``; the reference's
``tidb_tpu/executor/device_join.py:779-807``).

An input slot is ``(data, nulls)`` over the program's rows, or ``(data,
nulls, idx, ext)``: a column of another relation read through the int64
row-index tensor ``idx`` (None: the row itself) with the bool mask ``ext``
(None: none) ORed into its nulls.  Such a slot loads with ``LOADG`` —
``data[idx[r]]``, ``nulls[idx[r]] | ext[r]`` — so the join fragment
evaluates its expressions over the joined row space without gathered
copies of the columns (``tidb_tpu/executor/device_join.py:704
gather_env``).

Replaces the traced ``compile_expr`` closures of
``tidb_tpu/ops/device.py:235-1040`` and the prologue of
``tidb_tpu/executor/device_exec.py:480 _build_pipeline.pipeline``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# -- opcodes (csrc/expr_vm.cu keeps the same numbers) -------------------------
OPCODES = (
    "LOAD", "CONST", "I2F", "F2I", "MULK", "DIVKF",
    "ADD_I", "SUB_I", "MUL_I", "ADD_F", "SUB_F", "MUL_F",
    "CMP_I", "CMP_F", "DIV_F", "DIV_DEC",
    "AND", "OR", "NOT", "ISNULL", "NEG_I", "NEG_F", "ABS_I", "ABS_F",
    "IN_I", "IN_F", "NZ_F", "TRUTHY", "BAND", "BOR", "BNOT",
    "SEL", "COALESCE", "CIVIL", "FLOORDIVK",
    "LUT_I", "LUT_F", "LUTN_I", "LUTN_F", "ROUNDDIVK", "RINT",
    "STORE", "MASK", "LOADG",
)
OP = {name: i for i, name in enumerate(OPCODES)}
CMP_CODES = {"eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5}

#: registers per thread in the CUDA VM (csrc/expr_vm.cu MAX_REGS)
MAX_REGS = 64
INSTR_W = 8
#: csrc/expr_vm.cu VM_THREADS, VM_MAX_IN, VM_MAX_OUT: threads per block,
#: and the input and output slots the by-value arguments hold
VM_THREADS = 256
MAX_IN = 64
MAX_OUT = 64
#: dynamic shared memory one block may use on Hopper
SHARED_LIMIT = 232_448
#: rows per thread, most first; a tile takes the most whose registers
#: (8 value bytes and a null byte per register and row) fit REG_BUDGET,
#: so four blocks share an SM's 228 KB
ROWS_PER_THREAD = (4, 2, 1)
REG_BUDGET = 56 * 1024
#: csrc/expr_vm.cu expr_vm_kernel's STAGE: what a block stages in shared
#: memory beside the register file — nothing (the instruction stream, 32
#: bytes an instruction, and the constant tables are read from device
#: memory), the stream, or the stream and the constant tables
STAGE_NONE, STAGE_PROG, STAGE_ALL = 0, 1, 2
#: the constant tables are staged up to this size
STAGE_CONST_MAX = 16 * 1024
#: csrc/expr_vm.cu make_args: the header's layout (int64 words), the join
#: finish epilogue's seven words last
HDR_IN = 16
HDR_OUT = HDR_IN + 5 * MAX_IN
HDR_FIN = HDR_OUT + 2 * MAX_OUT
HDR_LEN = HDR_FIN + 7
#: the finish epilogue's count slots a multiprocessor: one a resident
#: block of the persistent grid (2048 threads a multiprocessor)
FIN_SLOTS_PER_SM = 2048 // VM_THREADS
#: csrc/expr_vm.cu F_*: flag bits above the opcode in the kernel's stream
F_A, F_B, F_C, F_WB = 1, 2, 4, 8
#: operand count of each opcode (STORE and MASK read one, make none)
_ARITY = dict.fromkeys(OPCODES, 1)
_ARITY.update(dict.fromkeys(("LOAD", "LOADG", "CONST"), 0))
_ARITY.update(dict.fromkeys((
    "ADD_I", "SUB_I", "MUL_I", "ADD_F", "SUB_F", "MUL_F", "CMP_I", "CMP_F",
    "DIV_F", "DIV_DEC", "AND", "OR", "BAND", "BOR", "COALESCE"), 2))
_ARITY["SEL"] = 3
_SINKS = ("STORE", "MASK")
#: ops whose rows the kernel runs one at a time on the register file (they
#: call the device's division routines): their operands and result never
#: pass through the forwarded last result
_SERIAL = ("DIVKF", "DIV_F", "DIV_DEC", "FLOORDIVK", "ROUNDDIVK")

#: input dtype codes (csrc/expr_vm.cu load_in)
DTYPE_CODES = {torch.int64: 0, torch.int32: 1, torch.float64: 2,
               torch.float32: 3, torch.bool: 4, torch.uint8: 4,
               torch.int16: 5, torch.int8: 6}

#: launches of the CUDA kernel, and of those with the join finish
#: epilogue (chip_smoke.py reads them to prove the path)
LAUNCHES = [0]
FINISH_LAUNCHES = [0]


class Node:
    """One value of an expression DAG: an (int64 | float64, null) pair per
    row.  `kind` is "i" or "f"; `imm` holds the op's static payload."""

    __slots__ = ("op", "args", "imm", "kind")

    def __init__(self, op, args=(), imm=None, kind="i"):
        self.op = op
        self.args = tuple(args)
        self.imm = imm
        self.kind = kind


# -- node constructors (used by ops/device.py's compiler) ---------------------

def load(idx, kind):
    return Node("LOAD", (), idx, kind)


def const(value, kind, null=False):
    return Node("CONST", (), (value, bool(null)), kind)


def null_const(kind="i"):
    return const(0 if kind == "i" else 0.0, kind, null=True)


def to_f(a):
    return a if a.kind == "f" else Node("I2F", (a,), None, "f")


def to_i(a):
    return a if a.kind == "i" else Node("F2I", (a,), None, "i")


def mulk(a, k):
    """int64 multiply by a host constant (two's-complement wrap)."""
    return Node("MULK", (a,), int(k), "i")


def divkf(a, k):
    return Node("DIVKF", (a,), float(k), "f")


def arith(op, a, b):
    """op in add/sub/mul over two nodes of one kind."""
    return Node(f"{op.upper()}_{a.kind.upper()}", (a, b), None, a.kind)


def cmp(op, a, b):
    return Node("CMP_F" if a.kind == "f" else "CMP_I", (a, b),
                CMP_CODES[op], "i")


def unary(op, a, kind=None):
    return Node(op, (a,), None, a.kind if kind is None else kind)


def binary(op, a, b, kind="i", imm=None):
    return Node(op, (a, b), imm, kind)


def in_table(a, values: np.ndarray, has_null: bool):
    """Membership of `a` in the sorted host array `values`."""
    fl = a.kind == "f" or values.dtype.kind == "f"
    if fl:
        return Node("IN_F", (to_f(a),),
                    (np.asarray(values, dtype=np.float64), bool(has_null)))
    return Node("IN_I", (a,),
                (np.asarray(values, dtype=np.int64), bool(has_null)))


def sel(c, x, y, kind):
    return Node("SEL", (c, x, y), None, kind)


def lut(a, table: np.ndarray):
    """table[clip(a, 0, len-1)], null from `a`."""
    if table.dtype.kind == "f":
        return Node("LUT_F", (a,), np.asarray(table, np.float64), "f")
    return Node("LUT_I", (a,), np.asarray(table, np.int64), "i")


def lutn(a, table: np.ndarray, null_table: np.ndarray):
    """c = NULL ? len : clip(a); (table[c], null_table[c]) — tables of
    len+1 entries whose last slot is the value FOR a NULL input."""
    nt = np.asarray(null_table, dtype=np.int64)
    if table.dtype.kind == "f":
        return Node("LUTN_F", (a,), (np.asarray(table, np.float64), nt), "f")
    return Node("LUTN_I", (a,), (np.asarray(table, np.int64), nt), "i")


# -- the flat program ---------------------------------------------------------

def _imm_key(imm):
    """A hashable, exact key for a node's static payload."""
    if isinstance(imm, np.ndarray):
        return (imm.dtype.str, imm.shape, imm.tobytes())
    if isinstance(imm, tuple):
        return tuple(_imm_key(x) for x in imm)
    return (type(imm).__name__, repr(imm))


class Program:
    """A fragment's conditions, keys and values as one register program.

    ``in_cols``: env column indices in input-slot order.  Outputs: slot s
    holds an int64 ("i") or float64 ("f") column plus its nulls;
    ``key_slots`` / ``val_slots`` map the fragment's keys and values to
    output slots (AVG's shared sum/count argument shares one slot).
    ``pass_in`` maps each output slot that is an input column unchanged to
    that input slot (see :meth:`without_stores`)."""

    def __init__(self, instrs, ci, cf, n_regs, in_cols, out_kinds,
                 key_slots, val_slots, graph, pass_in):
        self.instrs = instrs
        self.ci = ci
        self.cf = cf
        self.n_regs = n_regs
        self.in_cols = in_cols
        self.out_kinds = out_kinds
        self.key_slots = key_slots
        self.val_slots = val_slots
        self.pass_in = pass_in
        self._graph = graph
        self._dev = {}
        self._variants = {}
        self._gathered = {}

    @classmethod
    def build(cls, conds, keys, vals):
        """conds: nodes ANDed into the mask; keys: nodes stored as int64;
        vals: (node, conv) with conv "int" (stored as int64) or "raw"."""
        order, sinks = [], []
        seen = {}
        canon = {}  # structural key -> the one node that computes it
        out_kinds, out_of = [], {}

        def visit(node):
            # hash-consing: a subexpression the fragment repeats (a column
            # read by several aggregates, Q1's discounted price) is
            # computed once
            if id(node) in seen:
                return seen[id(node)]
            args = tuple(visit(a) for a in node.args)
            key = (node.op, node.kind, tuple(id(a) for a in args),
                   _imm_key(node.imm))
            hit = canon.get(key)
            if hit is None:
                node.args = args
                canon[key] = hit = node
                order.append(node)
            seen[id(node)] = hit
            return hit

        def out_slot(node, kind):
            k = (id(node), kind)
            if k not in out_of:
                out_of[k] = len(out_kinds)
                out_kinds.append(kind)
                sinks.append((len(order), "STORE", node, out_of[k]))
            return out_of[k]

        for c in conds:
            if c.kind == "f":
                c = Node("NZ_F", (c,), None, "i")
            c = visit(c)
            sinks.append((len(order), "MASK", c, 0))
        key_slots = []
        for k in keys:
            k = visit(to_i(k))
            key_slots.append(out_slot(k, "i"))
        val_slots = []
        for node, conv in vals:
            if conv == "int":
                node = to_i(node)
            node = visit(node)
            val_slots.append(out_slot(node, node.kind))
        return cls._assemble(order, sinks, out_kinds, key_slots, val_slots)

    def without_stores(self, skip: frozenset) -> "Program":
        """This program less the STOREs of the output slots in `skip` (all
        in ``pass_in``) and the instructions only they needed: the caller
        hands those outputs on as the input columns they would copy.
        Input slots keep their numbers."""
        if not skip:
            return self
        v = self._variants.get(skip)
        if v is None:
            order, sinks = self._graph
            sinks = [s for s in sinks
                     if not (s[1] == "STORE" and s[3] in skip)]
            live, stack = set(), [s[2] for s in sinks]
            while stack:
                node = stack.pop()
                if id(node) not in live:
                    live.add(id(node))
                    stack.extend(node.args)
            # sink positions count nodes of `order`: recount the kept ones
            kept_before = [0]
            for node in order:
                kept_before.append(kept_before[-1] + (id(node) in live))
            v = self._variants[skip] = self._assemble(
                [nd for nd in order if id(nd) in live],
                [(kept_before[s[0]],) + s[1:] for s in sinks],
                self.out_kinds, self.key_slots, self.val_slots,
                in_cols=self.in_cols)
        return v

    def gathered(self, slots: frozenset) -> "Program":
        """This program with the LOADs of the input slots in `slots`
        turned into LOADGs (reads through a row index and an extra null
        mask).  Slot numbers, registers and tables are unchanged."""
        if not slots:
            return self
        v = self._gathered.get(slots)
        if v is None:
            instrs = self.instrs.copy()
            for ins in instrs:
                if ins[0] == OP["LOAD"] and int(ins[5]) in slots:
                    ins[0] = OP["LOADG"]
            v = Program(instrs, self.ci, self.cf, self.n_regs, self.in_cols,
                        self.out_kinds, self.key_slots, self.val_slots,
                        self._graph, self.pass_in)
            self._gathered[slots] = v
        return v

    def loaded_slots(self) -> list:
        """The input slots the program reads (one LOAD each)."""
        return sorted({int(i[5]) for i in self.instrs
                       if i[0] in (OP["LOAD"], OP["LOADG"])})

    @classmethod
    def _assemble(cls, order, sinks, out_kinds, key_slots, val_slots,
                  in_cols=None):
        # the instruction stream: every node in topological order, each
        # sink right after the node count it was registered at
        stream = []
        si = 0
        sinks = sorted(sinks, key=lambda s: s[0])
        for pos, node in enumerate(order):
            stream.append(("node", node))
            while si < len(sinks) and sinks[si][0] <= pos + 1:
                stream.append(("sink",) + sinks[si][1:])
                si += 1
        while si < len(sinks):
            stream.append(("sink",) + sinks[si][1:])
            si += 1
        # liveness: the last stream position reading each node
        last = {}
        for p, ent in enumerate(stream):
            srcs = ent[1].args if ent[0] == "node" else (ent[2],)
            for a in srcs:
                last[id(a)] = p
        ci, cf = [], []

        def add_table(dst_list, arr):
            off = len(dst_list)
            dst_list.extend(arr.tolist())
            return off

        reg_of, free, n_regs = {}, [], 0
        in_cols = list(in_cols or ())
        in_slot = {col: slot for slot, col in enumerate(in_cols)}
        instrs = []
        for p, ent in enumerate(stream):
            if ent[0] == "sink":
                _s, what, node, slot = ent
                instrs.append([OP[what], 0, reg_of[id(node)], 0, 0, slot,
                               0, 0])
                if last.get(id(node)) == p:
                    free.append(reg_of[id(node)])
                continue
            node = ent[1]
            srcs = [reg_of[id(a)] for a in node.args]
            for a in node.args:  # operands are read before dst is written
                if last.get(id(a)) == p and reg_of[id(a)] not in free:
                    free.append(reg_of[id(a)])
            if free:
                dst = free.pop()
            else:
                dst = n_regs
                n_regs += 1
            reg_of[id(node)] = dst
            if id(node) not in last:  # dead value: its register is free
                free.append(dst)
            srcs += [0] * (3 - len(srcs))
            i0 = i1 = i2 = 0
            op = node.op
            imm = node.imm
            if op == "LOAD":
                if imm not in in_slot:
                    in_slot[imm] = len(in_cols)
                    in_cols.append(imm)
                i0 = in_slot[imm]
            elif op == "CONST":
                val, isnull = imm
                if node.kind == "f":
                    i0 = add_table(cf, np.array([float(val)]))
                else:
                    i0 = add_table(ci, np.array([int(val)], dtype=np.int64))
                i1, i2 = int(isnull), int(node.kind == "f")
            elif op in ("MULK", "ROUNDDIVK", "FLOORDIVK", "DIV_DEC"):
                i0 = add_table(ci, np.array([imm], dtype=np.int64))
            elif op == "DIVKF":
                i0 = add_table(cf, np.array([imm]))
            elif op in ("CMP_I", "CMP_F", "CIVIL"):
                i0 = imm
            elif op in ("IN_I", "IN_F"):
                table, has_null = imm
                i0 = add_table(ci if op == "IN_I" else cf, table)
                i1, i2 = len(table), int(has_null)
            elif op in ("LUT_I", "LUT_F"):
                i0 = add_table(ci if op == "LUT_I" else cf, imm)
                i1 = len(imm)
            elif op in ("LUTN_I", "LUTN_F"):
                table, nt = imm
                i0 = add_table(ci if op == "LUTN_I" else cf, table)
                i1 = len(table) - 1
                i2 = add_table(ci, nt)
            instrs.append([OP[op], dst] + srcs + [i0, i1, i2])
        if n_regs > MAX_REGS:
            from ..device import DeviceUnsupported
            raise DeviceUnsupported(
                f"expression program needs {n_regs} registers "
                f"(VM holds {MAX_REGS})")
        pass_in = {slot: in_slot[node.imm]
                   for _p, what, node, slot in sinks
                   if what == "STORE" and node.op == "LOAD"}
        return cls(np.asarray(instrs, dtype=np.int32).reshape(-1, INSTR_W),
                   np.asarray(ci, dtype=np.int64),
                   np.asarray(cf, dtype=np.float64), max(n_regs, 1),
                   in_cols, out_kinds, key_slots, val_slots,
                   (order, sinks), pass_in)

    def tables(self, device):
        """(the kernel's instruction stream (:func:`kernel_stream`), ci, cf)
        as tensors on `device`, uploaded once."""
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = (
                torch.from_numpy(kernel_stream(self.instrs)).to(device),
                torch.from_numpy(
                    self.ci if len(self.ci) else np.zeros(1, np.int64)
                ).to(device),
                torch.from_numpy(
                    self.cf if len(self.cf) else np.zeros(1)).to(device))
        return t


def kernel_stream(instrs: np.ndarray) -> np.ndarray:
    """The program as csrc/expr_vm.cu runs it: each opcode with flag bits
    above it (``op | flags << 8``).  The kernel keeps the last result of
    a non-sink instruction in registers: F_A / F_B / F_C mark an operand
    that is that result, F_WB a result some later instruction reads from
    the register file instead (a value only the next instruction, or the
    sinks before it, read never touches shared memory).  An op of
    _SERIAL reads its operands from, and writes its result to, the
    register file, and leaves no last result."""
    out = np.array(instrs, dtype=np.int32).reshape(-1, INSTR_W)
    flags = np.zeros(len(out), dtype=np.int32)
    producer = {}   # register -> position of the instruction it holds
    last = None     # the register whose value is the last result
    for q, ins in enumerate(out.tolist()):
        name = OPCODES[ins[0]]
        for j in range(_ARITY[name]):
            reg = ins[2 + j]
            if reg == last and name not in _SERIAL:
                flags[q] |= (F_A, F_B, F_C)[j]
            else:
                flags[producer[reg]] |= F_WB
        if name in _SINKS:
            continue
        producer[ins[1]] = q
        last = None if name in _SERIAL else ins[1]
        if name in _SERIAL:
            flags[q] |= F_WB
    out[:, 0] |= flags << 8
    return out


# -- the plain version --------------------------------------------------------

def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _civil(z, part):
    """days since epoch → year / month / day (Howard Hinnant's
    civil_from_days, floor division throughout)."""
    z = z + 719468
    era = _floordiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return (y, m, d)[part]


_CMP_FNS = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)


def gathered_slots(inputs) -> frozenset:
    """The input slots read through a row index or an extra null mask."""
    return frozenset(s for s, inp in enumerate(inputs)
                     if len(inp) > 2 and (inp[2] is not None
                                          or inp[3] is not None))


def interpret(prog: Program, inputs, n: int, n_live: int, dev=None,
              finish=None):
    """Run `prog` on whole columns with torch ops.  `inputs`: (data,
    nulls) or (data, nulls, idx, ext) per input slot (see the module
    note).  Returns (mask, [(data, nulls)] per output), and with `finish`
    a third item: :func:`run`'s join finish."""
    if dev is None:
        dev = inputs[0][0].device if inputs else torch.device("cpu")
    prog = prog.gathered(gathered_slots(inputs))
    _instrs, ci_t, cf_t = prog.tables(dev)
    i64, f64 = torch.int64, torch.float64
    R = [None] * prog.n_regs
    mask = torch.arange(n, device=dev) < n_live
    outs = [None] * len(prog.out_kinds)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    for ins in prog.instrs.tolist():
        op, dst, a, b, c, i0, i1, i2 = ins
        name = OPCODES[op]
        if name == "LOAD":
            d, nl = inputs[i0][:2]
            d = d.to(f64) if d.is_floating_point() else d.to(i64)
            R[dst] = (d, nl.to(torch.bool))
        elif name == "LOADG":
            d, nl, idx, ext = inputs[i0]
            if idx is not None:
                d, nl = d[idx], nl[idx]
            d = d.to(f64) if d.is_floating_point() else d.to(i64)
            nl = nl.to(torch.bool)
            R[dst] = (d, nl | ext if ext is not None else nl)
        elif name == "CONST":
            t = cf_t[i0] if i2 else ci_t[i0]
            R[dst] = (t, torch.full((), bool(i1), device=dev))
        elif name == "I2F":
            R[dst] = (R[a][0].to(f64), R[a][1])
        elif name == "F2I":
            R[dst] = (R[a][0].to(i64), R[a][1])
        elif name == "MULK":
            R[dst] = (R[a][0] * ci_t[i0], R[a][1])
        elif name == "DIVKF":
            R[dst] = (R[a][0] / cf_t[i0], R[a][1])
        elif name in ("ADD_I", "ADD_F"):
            R[dst] = (R[a][0] + R[b][0], R[a][1] | R[b][1])
        elif name in ("SUB_I", "SUB_F"):
            R[dst] = (R[a][0] - R[b][0], R[a][1] | R[b][1])
        elif name in ("MUL_I", "MUL_F"):
            R[dst] = (R[a][0] * R[b][0], R[a][1] | R[b][1])
        elif name in ("CMP_I", "CMP_F"):
            R[dst] = (_CMP_FNS[i0](R[a][0], R[b][0]).to(i64),
                      R[a][1] | R[b][1])
        elif name == "DIV_F":
            (da, na), (db, nb) = R[a], R[b]
            zero = db == 0
            R[dst] = (da / torch.where(zero, 1.0, db), na | nb | zero)
        elif name == "DIV_DEC":
            (da, na), (db, nb) = R[a], R[b]
            zero = db == 0
            num = da * ci_t[i0]
            den = torch.where(zero, 1, db)
            sign = torch.where((num < 0) != (den < 0), -1, 1)
            q = _floordiv(2 * num.abs() + den.abs(), 2 * den.abs())
            R[dst] = (sign * q, na | nb | zero)
        elif name in ("AND", "OR"):
            (da, na), (db, nb) = R[a], R[b]
            ta = (da != 0) & ~na
            tb = (db != 0) & ~nb
            if name == "AND":
                res = ta & tb
                nulls = ~(((da == 0) & ~na) | ((db == 0) & ~nb)) & (na | nb)
            else:
                res = ta | tb
                nulls = ~res & (na | nb)
            R[dst] = (res.to(i64), nulls)
        elif name == "NOT":
            R[dst] = ((R[a][0] == 0).to(i64), R[a][1])
        elif name == "ISNULL":
            R[dst] = (R[a][1].to(i64), false)
        elif name in ("NEG_I", "NEG_F"):
            R[dst] = (-R[a][0], R[a][1])
        elif name in ("ABS_I", "ABS_F"):
            R[dst] = (R[a][0].abs(), R[a][1])
        elif name in ("IN_I", "IN_F"):
            d, nl = R[a]
            if i1 == 0:
                hit = torch.zeros_like(d, dtype=torch.bool)
            else:
                table = (ci_t if name == "IN_I" else cf_t)[i0:i0 + i1]
                pos = torch.searchsorted(table, d.contiguous()).clamp(
                    0, i1 - 1)
                hit = table[pos] == d
            R[dst] = (hit.to(i64), nl | (~hit & bool(i2)))
        elif name == "NZ_F":
            R[dst] = ((R[a][0] != 0).to(i64), R[a][1])
        elif name == "TRUTHY":
            R[dst] = (((R[a][0] != 0) & ~R[a][1]).to(i64), false)
        elif name == "BAND":
            R[dst] = (R[a][0] & R[b][0], false)
        elif name == "BOR":
            R[dst] = (R[a][0] | R[b][0], false)
        elif name == "BNOT":
            R[dst] = (1 - R[a][0], false)
        elif name == "SEL":
            cond = R[a][0] != 0
            R[dst] = (torch.where(cond, R[b][0], R[c][0]),
                      torch.where(cond, R[b][1], R[c][1]))
        elif name == "COALESCE":
            (da, na), (db, nb) = R[a], R[b]
            R[dst] = (torch.where(na, db, da), na & nb)
        elif name == "CIVIL":
            R[dst] = (_civil(R[a][0], i0), R[a][1])
        elif name == "FLOORDIVK":
            R[dst] = (_floordiv(R[a][0], ci_t[i0]), R[a][1])
        elif name in ("LUT_I", "LUT_F"):
            table = (ci_t if name == "LUT_I" else cf_t)[i0:i0 + i1]
            R[dst] = (table[R[a][0].clamp(0, i1 - 1)], R[a][1])
        elif name in ("LUTN_I", "LUTN_F"):
            table = (ci_t if name == "LUTN_I" else cf_t)[i0:i0 + i1 + 1]
            nt = ci_t[i2:i2 + i1 + 1]
            d, nl = R[a]
            code = torch.where(nl, i1, d.clamp(0, max(i1 - 1, 0)))
            R[dst] = (table[code], nt[code] != 0)
        elif name == "ROUNDDIVK":
            d = R[a][0]
            den = ci_t[i0]
            sign = torch.where(d < 0, -1, 1)
            R[dst] = (sign * _floordiv(2 * d.abs() + den, 2 * den),
                      R[a][1])
        elif name == "RINT":
            R[dst] = (torch.round(R[a][0]).to(i64), R[a][1])
        elif name == "STORE":
            d, nl = R[a]
            want = f64 if prog.out_kinds[i0] == "f" else i64
            outs[i0] = (d.to(want).expand(n).contiguous(),
                        nl.expand(n).contiguous())
        elif name == "MASK":
            d, nl = R[a]
            mask = mask & (d != 0) & ~nl
        else:
            raise AssertionError(name)
    if finish is not None:
        from .join_probe import finish_plain
        return mask, outs, finish_plain(finish[0], mask, finish[1])
    return mask, outs


# -- the kernel wrapper -------------------------------------------------------

_FN = [None]


def _kernel():
    if _FN[0] is None:
        from . import build
        _FN[0] = build.declare("expr_vm_run", 2)
    return _FN[0]


def launch_plan(n_regs: int, n_instr: int, n_ci: int, n_cf: int,
                rpt: int = None):
    """How csrc/expr_vm.cu runs a program: (rows per thread, stage,
    dynamic shared bytes per block).  The register file takes ``n_regs *
    VM_THREADS * rpt * 9`` bytes; `rpt` is given, or the most of
    ROWS_PER_THREAD within REG_BUDGET.  The instruction stream (32 bytes an
    instruction) is staged where it fits beside the register file within
    SHARED_LIMIT, and the constant tables after it where they are at most
    STAGE_CONST_MAX and fit too; a stream that does not fit is read from
    device memory, so a program of any length runs."""
    if rpt is None:
        rpt = next((r for r in ROWS_PER_THREAD
                    if n_regs * VM_THREADS * r * 9 <= REG_BUDGET), 1)
    regs = n_regs * VM_THREADS * rpt * 9
    prog = regs + n_instr * INSTR_W * 4
    const_b = 8 * (n_ci + n_cf)
    if prog > SHARED_LIMIT:
        return rpt, STAGE_NONE, regs
    if const_b <= STAGE_CONST_MAX and prog + const_b <= SHARED_LIMIT:
        return rpt, STAGE_ALL, prog + const_b
    return rpt, STAGE_PROG, prog


def pack_args(n, n_live, counts, plan, tables, mask, ins, outs, fin=None):
    """The int64 header csrc/expr_vm.cu ``make_args`` turns into the
    kernel's by-value arguments.  counts: (n_instr, n_regs, n_ci, n_cf);
    plan: :func:`launch_plan`'s; tables: the pointers of the instruction
    stream and the two constant tables; mask: the mask's pointer; ins: per
    input slot (data, nulls, dtype code, row index, null mask), pointers
    0 where absent; outs: per output slot (data, nulls); fin: the join
    finish epilogue's (kind code, validity, valid, no-match, count,
    status, slots), pointers 0 where absent, or None for none."""
    if len(ins) > MAX_IN or len(outs) > MAX_OUT:
        from ..device import DeviceUnsupported
        raise DeviceUnsupported(
            f"expression program of {len(ins)} inputs and {len(outs)} "
            f"outputs (the VM takes {MAX_IN} and {MAX_OUT})")
    rpt, stage, shared = plan
    hdr = np.zeros(HDR_LEN, dtype=np.int64)
    hdr[:HDR_IN - 1] = ((n, n_live) + tuple(counts)
                        + (rpt, stage, shared, len(ins), len(outs))
                        + tuple(tables) + (mask,))
    hdr[HDR_IN:HDR_IN + 5 * len(ins)] = [w for e in ins for w in e]
    hdr[HDR_OUT:HDR_OUT + 2 * len(outs)] = [w for e in outs for w in e]
    hdr[HDR_FIN:HDR_LEN] = fin if fin is not None else (-1, 0, 0, 0, 0, 0,
                                                        0)
    return hdr


def handed_on(prog: Program, inputs) -> frozenset:
    """The output slots that are input columns already in the output's
    dtype (int64 or float64 data, bool nulls), read directly (not through
    a row index or null mask): the kernel hands those on as they are
    instead of copying them, as :func:`interpret` does."""
    gathered = gathered_slots(inputs)
    return frozenset(
        s for s, j in prog.pass_in.items()
        if j not in gathered
        and inputs[j][0].dtype == (torch.float64 if prog.out_kinds[s] == "f"
                                   else torch.int64)
        and inputs[j][1].dtype == torch.bool)


#: the finish epilogue's count words per (device, stream): a ticket and
#: a count a block the grid can hold, zeroed once (each launch leaves them
#: at 0)
_FIN_STATUS: dict = {}


def _fin_status(dev, stream: int) -> torch.Tensor:
    st = _FIN_STATUS.get((dev, stream))
    if st is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        st = _FIN_STATUS.setdefault(
            (dev, stream), torch.zeros(1 + FIN_SLOTS_PER_SM * sms,
                                       dtype=torch.int64, device=dev))
    return st


def run(prog: Program, inputs, n: int, n_live: int, dev: torch.device,
        finish=None):
    """Evaluate `prog` over `inputs` (per input slot (data, nulls) tensors
    of length n, or (data, nulls, idx, ext) with idx / ext of length n) on
    `dev`: the CUDA kernel on a card, :func:`interpret` on the CPU.
    Returns (mask, [(data, nulls)] per output slot).

    `finish`, a (pvalid, kind) pair: the mask is a join's match flag
    ``hit`` (an ON clause's residuals refining it), and the launch also
    writes the join kind's ``(valid, nohit, count)`` — K5a's finish,
    ``join_probe.finish_plain(pvalid, hit, kind)`` — as a third item:
    pvalid a bool tensor of length n or None (every row valid)."""
    if dev.type == "cpu":
        return interpret(prog, inputs, n, n_live, dev, finish)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gathered = gathered_slots(inputs)
    ins = []
    for s, inp in enumerate(inputs):
        d, nl = inp[:2]
        idx, ext = inp[2:] if len(inp) > 2 else (None, None)
        for t in (d, nl, idx, ext):
            if t is None:
                continue
            if t.device != dev:
                raise ValueError("expr_vm: inputs on different devices")
            if not t.is_contiguous():
                raise ValueError("expr_vm: inputs must be contiguous")
        if d.dtype not in DTYPE_CODES or nl.dtype not in (torch.bool,
                                                          torch.uint8):
            raise TypeError(f"expr_vm: unsupported input dtype {d.dtype}")
        if idx is not None and idx.dtype != torch.int64:
            raise TypeError("expr_vm: row indices must be int64")
        if ext is not None and ext.dtype != torch.bool:
            raise TypeError("expr_vm: extra null masks must be bool")
        if d.shape[0] != nl.shape[0]:
            raise ValueError("expr_vm: data and nulls differ in length")
        if idx is None and d.shape[0] != n:
            raise ValueError("expr_vm: input length differs from n")
        for t in (idx, ext):
            if t is not None and t.shape[0] != n:
                raise ValueError("expr_vm: row index or null mask length "
                                 "differs from n")
        ins.append((d.data_ptr(), nl.data_ptr(), DTYPE_CODES[d.dtype],
                    0 if idx is None else idx.data_ptr(),
                    0 if ext is None else ext.data_ptr()))
    skip = handed_on(prog, inputs)
    vprog = prog.without_stores(skip).gathered(gathered)
    instrs, ci, cf = vprog.tables(dev)
    # the computed outputs' data in one buffer, their nulls and the mask
    # (and the finish's valid and no-match flags and its count) in another
    made = [s for s in range(len(prog.out_kinds)) if s not in skip]
    data = torch.empty((len(made), n), dtype=torch.int64,
                       device=dev).unbind(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fin, fin_out = None, None
    if finish is None:
        flags = torch.empty((len(made) + 1, n), dtype=torch.bool,
                            device=dev).unbind(0)
    else:
        n_flags = len(made) + 3
        at = -(-n_flags * n // 8) * 8
        buf = torch.empty(at + 8, dtype=torch.uint8, device=dev)
        flags = buf[:n_flags * n].view(torch.bool).view(n_flags,
                                                        n).unbind(0)
        pvalid, kind = finish
        from .join_probe import KINDS
        if pvalid is not None and (pvalid.device != dev
                                   or pvalid.dtype != torch.bool
                                   or pvalid.shape != (n,)
                                   or not pvalid.is_contiguous()):
            raise ValueError("expr_vm: the finish's validity must be a "
                             "contiguous bool tensor of n rows on the "
                             "program's device")
        count = buf[at:].view(torch.int64)[0]
        fin_out = (flags[-3], flags[-2], count)
        status = _fin_status(dev, stream)
        fin = (KINDS[kind], 0 if pvalid is None else pvalid.data_ptr(),
               flags[-3].data_ptr(), flags[-2].data_ptr(), count.data_ptr(),
               status.data_ptr(), status.shape[0] - 1)
    mask = flags[-1]
    outs = [tuple(inputs[prog.pass_in[s]][:2]) if s in skip else None
            for s in range(len(prog.out_kinds))]
    for d, nl, s in zip(data, flags, made):
        outs[s] = (d.view(torch.float64) if prog.out_kinds[s] == "f" else d,
                   nl)
    counts = (len(vprog.instrs), vprog.n_regs, len(vprog.ci), len(vprog.cf))
    plan = launch_plan(vprog.n_regs, len(vprog.instrs), len(vprog.ci),
                       len(vprog.cf))
    hdr = pack_args(n, n_live, counts, plan,
                    (instrs.data_ptr(), ci.data_ptr(), cf.data_ptr()),
                    mask.data_ptr(), ins,
                    [(0, 0) if s in skip else (d.data_ptr(), nl.data_ptr())
                     for s, (d, nl) in enumerate(outs)], fin)
    from . import build
    build.check(build.launch(dev, _kernel(), hdr.ctypes.data,
                             ctypes.c_void_p(stream)), "expr_vm_run")
    LAUNCHES[0] += 1
    if fin_out is not None:
        FINISH_LAUNCHES[0] += 1
        return mask, outs, fin_out
    return mask, outs
