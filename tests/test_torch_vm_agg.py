"""K2 (the expression VM) and K1 (the group-by aggregate) at the edges of
their Hopper designs, on the CPU:

* the host-side launch planning as pure functions — K2's tile shape and
  shared memory per block for every register count, its by-value
  argument header round-tripped through a mirror of ``make_args``; K1's
  slot layout, accumulate mode and workspace regions;
* the shapes the card tests (tests/test_torch_cuda.py) hold the kernels
  to, through the plain versions against the JAX reference: expression
  programs of 1, 8 and 64 registers over 7 rows (under a warp) and 3,000
  (no whole number of tiles), n_live of 0 and n; K1's one-group, 32-rows-
  a-bucket, NaN / ±inf / -0.0, int64-wrap and count-distinct cases on
  every path; a fold of many small partial states.

Tolerances: the VM's outputs exact; the aggregate's keys, NULL flags,
integers and group counts exact, doubles within rtol 1e-9 / atol 1e-12
(the reference sums in sorted order, the port in index order), NaN equal
to NaN.
"""

import numpy as np
import pytest
import torch

from test_torch_cuda import (K1_OPS, K1_PATHS, LONG_TERMS,
                             PAST_SHARED_TERMS, k1_edge_case, vm_chain,
                             vm_chain_with_regs, vm_every_op,
                             vm_every_op_inputs, vm_long_program)
from test_torch_kernels import (_assert_same_columns, _assert_same_slots,
                                _capture_fragment, _port_program, _ref_eval,
                                _run_both)
from test_torch_stream import MERGE_OPS, _states, _to_port, _to_ref
from tidb_tpu.executor import device_exec as jexec
from tidb_tpu_torch import carry
from tidb_tpu_torch.executor import device_exec as texec
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops.kernels import expr_vm, groupby_agg

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


# -- K2: launch planning -------------------------------------------------------

@pytest.mark.parametrize("n_regs", range(1, expr_vm.MAX_REGS + 1))
def test_vm_plan_fits_a_block(n_regs):
    """Every register count up to MAX_REGS fits one block's shared memory,
    with the most rows per thread that keeps the registers in budget, for
    small and the largest programs, small and large constant tables."""
    for n_instr, n_ci, n_cf in ((1, 0, 0), (190, 40, 3), (1024, 1024, 1024),
                                (1024, 9000, 9000), (1100, 275, 0),
                                (2700, 0, 0), (7000, 1700, 0),
                                (100_000, 10, 10)):
        rpt, stage, shared = expr_vm.launch_plan(n_regs, n_instr, n_ci, n_cf)
        regs = n_regs * expr_vm.VM_THREADS * rpt * 9
        prog = regs + n_instr * 32
        const_b = 8 * (n_ci + n_cf)
        assert rpt in expr_vm.ROWS_PER_THREAD
        assert shared <= expr_vm.SHARED_LIMIT == 232_448
        assert regs <= expr_vm.REG_BUDGET or rpt == 1
        if rpt < max(expr_vm.ROWS_PER_THREAD):
            assert n_regs * expr_vm.VM_THREADS * rpt * 2 * 9 > \
                expr_vm.REG_BUDGET
        # the stream is staged wherever it fits, the constants after it
        # where they are small and fit too
        if prog > expr_vm.SHARED_LIMIT:
            assert (stage, shared) == (expr_vm.STAGE_NONE, regs)
        elif (const_b <= expr_vm.STAGE_CONST_MAX
              and prog + const_b <= expr_vm.SHARED_LIMIT):
            assert (stage, shared) == (expr_vm.STAGE_ALL, prog + const_b)
        else:
            assert (stage, shared) == (expr_vm.STAGE_PROG, prog)


@pytest.mark.parametrize("n_terms,stage", [
    (LONG_TERMS, expr_vm.STAGE_ALL), (PAST_SHARED_TERMS, expr_vm.STAGE_NONE)])
def test_vm_long_program_plan_and_values(n_terms, stage):
    """The card tests' long programs: about 1,100 instructions staged in
    shared memory, and one read from device memory; the interpreter gives
    the sum numpy computes."""
    prog = vm_long_program(n_terms)
    assert len(prog.instrs) > 1_024
    assert expr_vm.launch_plan(prog.n_regs, len(prog.instrs), len(prog.ci),
                               len(prog.cf))[1] == stage
    rng = np.random.default_rng(n_terms)
    n = 1_000
    x, xn = rng.integers(-1000, 1000, n), rng.random(n) < 0.1
    mask, outs = expr_vm.interpret(
        prog, [(torch.from_numpy(x), torch.from_numpy(xn))], n, n, CPU)
    i = np.arange(n_terms)
    want = x * int((i + 2).sum()) + int(i.sum())
    (got, got_n), = outs
    assert np.array_equal(got_n.numpy(), xn)
    assert np.array_equal(got.numpy()[~xn], want[~xn])


def _unpack(hdr):
    """csrc/expr_vm.cu make_args, in Python: the header back into its
    fields."""
    h = [int(x) for x in hdr]
    n_in, n_out = h[9], h[10]
    ins = [tuple(h[expr_vm.HDR_IN + 5 * i:expr_vm.HDR_IN + 5 * i + 5])
           for i in range(n_in)]
    outs = [tuple(h[expr_vm.HDR_OUT + 2 * s:expr_vm.HDR_OUT + 2 * s + 2])
            for s in range(n_out)]
    return (h[0], h[1], tuple(h[2:6]), tuple(h[6:9]), tuple(h[11:14]),
            h[14], ins, outs)


@pytest.mark.parametrize("n_in,n_out", [(0, 1), (7, 11), (64, 64)])
def test_vm_args_round_trip(n_in, n_out):
    rng = np.random.default_rng(n_in + n_out)

    def ptr():
        return int(rng.integers(1, 2**47)) * 256
    ins = [(ptr(), ptr(), int(rng.integers(0, 7)),
            ptr() if i % 2 else 0, ptr() if i % 3 else 0)
           for i in range(n_in)]
    outs = [(ptr(), ptr()) if s % 4 else (0, 0) for s in range(n_out)]
    counts = (23, 4, 9, 2)
    plan = expr_vm.launch_plan(4, 23, 9, 2)
    tables = (ptr(), ptr(), ptr())
    hdr = expr_vm.pack_args(8_388_608, 6_001_215, counts, plan, tables,
                            ptr() + 1, ins, outs)
    assert hdr.dtype == np.int64 and hdr.shape == (expr_vm.HDR_LEN,)
    n, n_live, c, p, t, mask, gi, go = _unpack(hdr)
    assert (n, n_live, c, t, gi, go) == (8_388_608, 6_001_215, counts,
                                         tables, ins, outs)
    assert p == tuple(int(x) for x in plan) and mask % 256 == 1


def test_vm_args_refuse_past_the_limits():
    plan = expr_vm.launch_plan(1, 1, 0, 0)
    with pytest.raises(tdev.DeviceUnsupported):
        expr_vm.pack_args(1, 1, (1, 1, 0, 0), plan, (0, 0, 0), 0,
                          [(0, 0, 0, 0, 0)] * (expr_vm.MAX_IN + 1), [])
    with pytest.raises(tdev.DeviceUnsupported):
        expr_vm.pack_args(1, 1, (1, 1, 0, 0), plan, (0, 0, 0), 0, [],
                          [(0, 0)] * (expr_vm.MAX_OUT + 1))
    # no limit on the program's length: a stream past shared memory is
    # read from device memory
    long_plan = expr_vm.launch_plan(1, 20_000, 0, 0)
    assert long_plan[1] == expr_vm.STAGE_NONE
    hdr = expr_vm.pack_args(1, 1, (20_000, 1, 0, 0), long_plan, (0, 0, 0),
                            0, [], [])
    assert int(hdr[2]) == 20_000


def _run_stream(stream):
    """csrc/expr_vm.cu's data flow over the flagged stream, on symbols: a
    register file written only where F_WB says, the last result in acc,
    operands from acc where flagged.  Returns the symbol each operand
    read, in order, and the same with every value written and read
    through the register file (the program's meaning)."""
    got, want = [], []
    regs, plain, acc = {}, {}, None
    for q, ins in enumerate(stream.tolist()):
        op, fl = ins[0] & 0xFF, ins[0] >> 8
        name = expr_vm.OPCODES[op]
        for j in range(expr_vm._ARITY[name]):
            reg = ins[2 + j]
            got.append(acc if fl & (expr_vm.F_A, expr_vm.F_B,
                                    expr_vm.F_C)[j] else regs.get(reg))
            want.append(plain[reg])
        if name in ("STORE", "MASK"):
            continue
        plain[ins[1]] = q
        acc = None if name in expr_vm._SERIAL else q
        if fl & expr_vm.F_WB:
            regs[ins[1]] = q
    return got, want


@pytest.mark.parametrize("which", ["every_op", "chain_1", "chain_8",
                                   "chain_64"])
def test_vm_kernel_stream_reads_every_value_it_needs(which):
    """Every operand the kernel reads — from the forwarded last result or
    from the register file — is the value the program means; a result is
    written back exactly where a later read needs it from the file."""
    prog = (vm_every_op() if which == "every_op"
            else vm_chain_with_regs(int(which.split("_")[1])))
    stream = expr_vm.kernel_stream(prog.instrs)
    assert np.array_equal(stream[:, 0] & 0xFF, prog.instrs[:, 0])
    assert np.array_equal(stream[:, 1:], prog.instrs[:, 1:])
    got, want = _run_stream(stream)
    assert got == want
    fl = stream[:, 0] >> 8
    forwarded = sum(bin(int(f) & 7).count("1") for f in fl)
    assert forwarded > 0 and ((fl & expr_vm.F_WB) != 0).sum() < len(fl)




# -- K2: the card tests' programs on the CPU -------------------------------------

@pytest.mark.parametrize("n_regs", [1, 8, 64])
def test_vm_chain_takes_its_registers(n_regs):
    prog = vm_chain_with_regs(n_regs)
    assert prog.n_regs == n_regs
    # one past 64 is refused, as the VM holds 64
    if n_regs == 64:
        depth = next(d for d in range(200) if vm_chain(d).n_regs == 64)
        with pytest.raises(tdev.DeviceUnsupported):
            vm_chain(depth + 1)


def test_vm_every_op_program_covers_every_opcode():
    n = 50
    prog = vm_every_op()
    ins = [tuple(None if x is None else torch.from_numpy(x) for x in inp)
           for inp in vm_every_op_inputs(prog, np.random.default_rng(0), n)]
    used = {expr_vm.OPCODES[i[0]] for i in
            prog.gathered(expr_vm.gathered_slots(ins)).instrs}
    assert used == set(expr_vm.OPCODES)
    mask, outs = expr_vm.interpret(prog, ins, n, n, CPU)
    assert mask.shape == (n,) and len(outs) == len(prog.out_kinds)
    # n_live 0: no row kept, every output unchanged
    mask0, outs0 = expr_vm.interpret(prog, ins, n, 0, CPU)
    assert not bool(mask0.any())
    for (a, an), (b, bn) in zip(outs, outs0):
        assert torch.equal(an, bn)
        assert torch.equal(a.view(torch.int64) if a.is_floating_point()
                           else a, b.view(torch.int64)
                           if b.is_floating_point() else b)


def _chain_sql(depth):
    """SUM over a right-nested sum of depth + 1 distinct terms of
    l_partkey and l_suppkey: depth + 2 registers in the port's program
    (-l_partkey, one register, for depth -1)."""
    if depth < 0:
        return "select sum(-l_partkey) from lineitem"
    e = f"l_partkey * {depth + 2} + l_suppkey"
    for i in reversed(range(depth)):
        e = f"l_partkey * {i + 2} + ({e})"
    return f"select l_returnflag, sum({e}) from lineitem " \
           "group by l_returnflag"


@pytest.fixture(scope="module", params=[7, 3000], ids=["7_rows", "3000_rows"])
def chain_kits(request):
    """lineitem of 7 rows (fewer than a warp) or 3,000 (no whole number
    of tiles), in both packages."""
    from tidb_tpu.testkit import TestKit as RefKit
    from tidb_tpu_torch.testkit import TestKit as PortKit
    data, n = carry.gen_lineitem(request.param / 6_001_215 + 1e-9, seed=3)
    assert n == request.param
    kits = (RefKit(), PortKit())
    for tk in kits:
        tk.must_exec(carry.LINEITEM_DDL)
        carry.install_bulk_numpy(tk.domain, "test", "lineitem", data, n)
    return kits


@pytest.mark.parametrize("n_regs", [1, 8, 64])
def test_vm_register_chain_matches_reference(chain_kits, monkeypatch,
                                             n_regs):
    sql = _chain_sql(n_regs - 2 if n_regs > 1 else -1)
    ref_kit, port_kit = chain_kits
    frag = _capture_fragment(monkeypatch, texec, port_kit, sql)
    prog, inputs, n = _port_program(*frag)
    assert prog.n_regs == n_regs
    ref = _ref_eval(*_capture_fragment(monkeypatch, jexec, ref_kit, sql))
    for n_live in (n, 0):
        mask, outs = expr_vm.interpret(prog, inputs, n, n_live, CPU)
        keys = [(outs[s][0].numpy(), outs[s][1].numpy())
                for s in prog.key_slots]
        vals = [(outs[s][0].numpy(), outs[s][1].numpy())
                for s in prog.val_slots]
        want = ref if n_live else (np.zeros(n, bool),) + ref[1:]
        _assert_same_columns(want, (mask.numpy(), keys, vals))


def test_vm_past_64_registers_runs_on_the_host(chain_kits, monkeypatch):
    """A program of 65 registers is refused on the device (the VM holds
    64): the query runs on the host engine with the reference's rows."""
    sql = _chain_sql(63)
    ref_kit, port_kit = chain_kits
    with pytest.raises(tdev.DeviceUnsupported):
        _port_program(*_capture_fragment(monkeypatch, texec, port_kit, sql))
    for tk in chain_kits:
        tk.must_exec("set @@tidb_executor_engine = 'tpu'")
    assert port_kit.must_query(sql).rows == ref_kit.must_query(sql).rows


# -- K1: launch planning ---------------------------------------------------------

@pytest.mark.parametrize("ops,stride,acc,nn", [
    (("count",), 2, [-1], [1]),
    (("first",), 1, [-1], [-1]),
    (("sum_f",), 4, [1], [2]),
    (("cnt_dist", "count"), 4, [1, -1], [-1, 2]),
    (K1_OPS, 20, [-1, 2, 4, 6, 8, 10, 12, -1, 14, 15],
     [1, 3, 5, 7, 9, 11, 13, -1, -1, 16]),
    (("sum_i",) * 32, 68, list(range(1, 64, 2)), list(range(2, 65, 2))),
])
def test_k1_slot_layout(ops, stride, acc, nn):
    got = groupby_agg.slot_layout(ops)
    assert got == (stride, tuple(acc), tuple(nn))
    words = [w for w in list(acc) + list(nn) if w >= 0]
    assert len(set(words)) == len(words) and 0 not in words
    assert max(words + [0]) < stride
    assert stride <= 2 or stride % 4 == 0


def test_k1_accumulate_mode():
    M = groupby_agg
    assert M.accumulate_mode(1 << 20, 4, True) == (M.MODE_GLOBAL, 0)
    # Q1: 32 buckets of 20 words, a copy per warp
    assert M.accumulate_mode(32, 20, False) == (M.MODE_WARP, 8 * 32 * 20 * 8)
    assert M.accumulate_mode(256, 20, False) == (M.MODE_BLOCK, 256 * 20 * 8)
    assert M.accumulate_mode(1 << 21, 4, False) == (M.MODE_GLOBAL, 0)
    for S in (1, 32, 256, 1 << 10, 1 << 14):
        for stride in (1, 2, 4, 20, 68):
            mode, smem = M.accumulate_mode(S, stride, False)
            assert smem <= max(M.WARP_COPIES_BYTES, M.BLOCK_COPY_BYTES)
            assert (mode == M.MODE_GLOBAL) == (smem == 0)


@pytest.mark.parametrize("S,P,stride,hashed,n_gslot", [
    (32, 0, 20, False, 32), (1 << 21, 0, 4, False, 1 << 21),
    (1 << 11, 1 << 13, 16, True, 1000), (1024, 0, 1, True, 1)])
def test_k1_workspace_regions(S, P, stride, hashed, n_gslot):
    regions, total = groupby_agg.workspace_layout(S, P, stride, hashed,
                                                  n_gslot)
    n_tiles = -(-S // groupby_agg.SCAN_TILE)
    want = {"slots": S * stride * 8, "live": S,
            "tbl": S * 8 if hashed else 0, "pst": 4 * P, "pg": 8 * P,
            "pv": 8 * P, "pj": 4 * P, "tile_cnt": 8 * n_tiles,
            "tile_off": 8 * n_tiles, "gslot": 8 * n_gslot}
    assert {k: v[1] for k, v in regions.items()} == want
    spans = sorted(v for v in regions.values())
    for (o1, s1), (o2, _s2) in zip(spans, spans[1:]):
        assert o1 % 256 == 0 and o1 + s1 <= o2
    last = spans[-1]
    assert last[0] + last[1] <= total < last[0] + last[1] + 256


# -- K1: the card tests' cases against the reference -------------------------------

@pytest.mark.parametrize("path", list(K1_PATHS))
@pytest.mark.parametrize("case", ["one_group", "warp_bucket", "nan_inf_zero",
                                  "wrap", "distinct"])
def test_k1_edge_cases_match_reference(path, case):
    keys, kn, vals, vn, mask = k1_edge_case(
        case, 3000, np.random.default_rng(len(case) * 31 + len(path)))
    cap = 64
    ref, port = _run_both(list(keys), list(kn), list(vals), list(vn), mask,
                          K1_OPS, cap, K1_PATHS[path])
    if case == "one_group":
        assert int(port[4]) == 1
    _assert_same_slots(ref, port, K1_OPS, cap)


@pytest.mark.parametrize("pack", [((7, 0), (3, 0)), None],
                         ids=["key_pack", "no_pack"])
def test_merge_of_many_small_parts_matches_reference(pack):
    """40 partial states of a few slots each, folded at once."""
    parts = _states(91, 40, pack, null_keys=True)
    want, want_cap = jexec.merge_partial_states(
        None, [_to_ref(p) for p in parts], 512, 2, len(MERGE_OPS),
        MERGE_OPS, pack)
    got, got_cap = texec.merge_partial_states(
        None, [_to_port(p) for p in parts], 512, 2, len(MERGE_OPS),
        MERGE_OPS, pack)
    assert got_cap == want_cap
    _assert_same_slots(want, got, MERGE_OPS, got_cap)
