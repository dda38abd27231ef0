"""The port's kernels (tidb_tpu_torch/ops/kernels) against the JAX
reference on the CPU, on the same seeded numpy inputs:

* K1 — the plain group-by aggregate against ``tidb_tpu.ops.device.
  _agg_kernel``, slot for slot;
* K2/K3 — the expression compiler + VM interpreter against the
  reference's ``compile_expr`` closures, on the expressions of the
  device-ops parity queries, TPC-H Q1 and Q6;
* K4 — the plain top-k against ``tidb_tpu.executor.device_exec.
  _topk_indices``.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tidb_tpu.ops import device as jdev
from tidb_tpu.executor import device_exec as jexec
from tidb_tpu_torch import carry
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.executor import device_exec as texec
from tidb_tpu_torch.ops.kernels import expr_vm
from tidb_tpu_torch.utils import failpoint as tfailpoint
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


@pytest.fixture(autouse=True)
def _no_port_failpoint_leaks():
    """The port keeps its own failpoint registry (tests/conftest.py
    watches only the reference's)."""
    yield
    leaked = tfailpoint.list_active()
    if leaked:
        tfailpoint.disable_all()
        pytest.fail(f"test leaked active port failpoints: {leaked}")


# -- K1 -------------------------------------------------------------------------

#: Float tolerance of the aggregate: rtol 1e-9 / atol 1e-12, because the
#: reference sums each group's doubles in sorted (or scatter) order and
#: the port in index_add order — IEEE addition is order-sensitive.  The
#: same bound as tests/test_device_ops.py _rows_equal.  Integers, keys,
#: NULL flags and n_groups compare exactly.
RTOL, ATOL = 1e-9, 1e-12


def _agg_inputs(rng, n, n_keys, key_hi, null_p, mask_p, ops):
    keys = [rng.integers(0, key_hi, n).astype(np.int64)
            for _ in range(n_keys)]
    knulls = [rng.random(n) < null_p for _ in range(n_keys)]
    vals, vnulls = [], []
    for op in ops:
        if op in ("sum_f",) or (op in ("min", "max", "first")
                                and len(vals) % 2):
            vals.append(np.round(rng.standard_normal(n) * 100, 3))
        elif op == "cnt_dist":
            vals.append(rng.integers(0, 7, n).astype(np.int64))
        else:
            vals.append(rng.integers(-1000, 1000, n).astype(np.int64))
        vnulls.append(rng.random(n) < 0.1)
    mask = rng.random(n) < mask_p
    return keys, knulls, vals, vnulls, mask


def _run_both(keys, knulls, vals, vnulls, mask, ops, capacity, pack):
    n_keys = len(keys)
    ref = jdev._agg_kernel(
        tuple(jnp.asarray(k) for k in keys),
        tuple(jnp.asarray(k) for k in knulls),
        tuple(jnp.asarray(v) for v in vals),
        tuple(jnp.asarray(v) for v in vnulls), jnp.asarray(mask),
        n_keys=n_keys, agg_ops=tuple(ops), capacity=capacity, pack=pack)
    t = carry.to_torch((tuple(keys), tuple(knulls), tuple(vals),
                        tuple(vnulls), mask), "cpu")
    port = tdev._agg_kernel(*t, n_keys=n_keys, agg_ops=tuple(ops),
                            capacity=capacity, pack=pack)
    return ref, port


def _assert_same_slots(ref, port, ops, capacity):
    rk, rkn, rr, rrn, rng_, _rv = ref
    pk, pkn, pr, prn, png, pv = port
    ng = int(rng_)
    assert int(png) == ng
    lim = min(ng, capacity)
    if ng > capacity:
        # on overflow the reference's sort path folds every group past
        # the capacity into its last slot (that slot's span runs to the
        # kept-row count); callers retry with a bigger capacity and never
        # read an overflowed body, so that slot carries no contract
        lim -= 1
    np.testing.assert_array_equal(pv.numpy(), np.arange(capacity) < ng)
    for a, b, an, bn in zip(rk, pk, rkn, pkn):
        an = np.asarray(an)[:lim]
        np.testing.assert_array_equal(an, bn.numpy()[:lim])
        np.testing.assert_array_equal(np.asarray(a)[:lim][~an],
                                      b.numpy()[:lim][~an])
    for j, op in enumerate(ops):
        an = np.asarray(rrn[j])[:lim]
        np.testing.assert_array_equal(an, prn[j].numpy()[:lim],
                                      err_msg=f"{op} nulls")
        a = np.asarray(rr[j])[:lim][~an]
        b = pr[j].numpy()[:lim][~an]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=op)
        else:
            np.testing.assert_array_equal(b, a, err_msg=op)


OP_SETS = {
    "sums": ("count", "sum_i", "sum_f"),
    "extremes": ("min", "max", "min", "max"),
    "first": ("first", "first", "count"),
    "distinct": ("cnt_dist", "count", "sum_i"),
}


@pytest.mark.parametrize("ops", list(OP_SETS), ids=list(OP_SETS))
@pytest.mark.parametrize("packed", [True, False], ids=["pack", "nopack"])
@pytest.mark.parametrize("null_keys", [0.0, 0.15], ids=["nonull", "nulls"])
@pytest.mark.parametrize("case", ["fits", "overflow", "nomask"])
def test_agg_matches_reference(ops, packed, null_keys, case):
    rng = np.random.default_rng(
        zlib.crc32(repr((ops, packed, null_keys, case)).encode()))
    ops = OP_SETS[ops]
    n = 600
    keys, knulls, vals, vnulls, mask = _agg_inputs(
        rng, n, 2, 9, null_keys, 0.0 if case == "nomask" else 0.8, ops)
    pack = ((4, 0), (4, 0)) if packed else None
    capacity = 16 if case == "overflow" else 128
    ref, port = _run_both(keys, knulls, vals, vnulls, mask, ops, capacity,
                          pack)
    if case == "overflow":
        assert int(port[4]) > capacity
    _assert_same_slots(ref, port, ops, capacity)


def test_agg_wide_key_offsets_match_reference():
    """Negative keys with a min/max offset pack, the planner's bare-column
    shape (offset = -min)."""
    rng = np.random.default_rng(7)
    n = 900
    keys = [rng.integers(-300, 300, n).astype(np.int64)]
    knulls = [rng.random(n) < 0.05]
    ops = ("sum_i", "count", "max")
    vals = [rng.integers(-50, 50, n).astype(np.int64) for _ in ops]
    vnulls = [rng.random(n) < 0.1 for _ in ops]
    mask = rng.random(n) < 0.9
    pack = ((10, 300),)
    ref, port = _run_both(keys, knulls, vals, vnulls, mask, ops, 1024, pack)
    _assert_same_slots(ref, port, ops, 1024)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 200),
       n_keys=st.integers(1, 3), key_hi=st.integers(1, 12),
       packed=st.booleans(), cap_pow=st.integers(3, 8),
       ops=st.lists(st.sampled_from(["count", "sum_i", "sum_f", "min",
                                     "max", "first", "cnt_dist"]),
                    min_size=1, max_size=5))
def test_agg_property(seed, n, n_keys, key_hi, packed, cap_pow, ops):
    rng = np.random.default_rng(seed)
    keys, knulls, vals, vnulls, mask = _agg_inputs(
        rng, n, n_keys, key_hi, 0.2, 0.75, ops)
    bits = max(int(key_hi + 1).bit_length(), 1)
    pack = tuple((bits, 0) for _ in range(n_keys)) if packed else None
    capacity = 1 << cap_pow
    ref, port = _run_both(keys, knulls, vals, vnulls, mask, ops, capacity,
                          pack)
    _assert_same_slots(ref, port, ops, capacity)


# -- K2/K3 ------------------------------------------------------------------------

def _capture_fragment(monkeypatch, module, tk, sql):
    """(plan, chunk, conds) of the scan-aggregate fragment `sql` hands
    `module.device_agg`."""
    seen = []
    orig = module.device_agg

    def spy(plan, chunk, conds, ctx=None):
        seen.append((plan, chunk, conds))
        return orig(plan, chunk, conds, ctx=ctx)

    monkeypatch.setattr(module, "device_agg", spy)
    tk.must_exec("set @@tidb_executor_engine = 'tpu'")
    tk.must_query(sql)
    monkeypatch.setattr(module, "device_agg", orig)
    assert seen, f"no device fragment for {sql}"
    return seen[-1]


def _ref_eval(plan, chunk, conds):
    """Mask, keys and values through the reference's traced closures."""
    used = jexec._agg_used_columns(plan, conds)
    dcols = {i: jdev.to_device_col(chunk.columns[i]) for i in used}
    env = {i: (dc.data, dc.nulls) for i, dc in dcols.items()}
    n = chunk.num_rows
    mask = np.ones(n, dtype=bool)
    for c in conds:
        d, nl = jdev.compile_expr(c, dcols)(env)
        mask &= np.broadcast_to(np.asarray((d != 0) & ~nl), (n,))
    key_fns, _km, _kp, val_plan, _ops, _slots = jexec._plan_agg(plan, dcols)
    keys = [tuple(np.asarray(x) for x in jdev.broadcast_1d(*f(env), n))
            for f in key_fns]
    vals = []
    for f, conv in val_plan:
        d, nl = (np.asarray(x) for x in jdev.broadcast_1d(*f(env), n))
        vals.append((d.astype(np.int64) if conv == "int" else d, nl))
    return mask, [(d.astype(np.int64), nl) for d, nl in keys], vals


def _port_program(plan, chunk, conds):
    """(program, its input columns, n) of the fragment in the port."""
    used = texec._agg_used_columns(plan, conds)
    dcols = {i: tdev.to_device_col(chunk.columns[i]) for i in used}
    env = {i: (dc.data, dc.nulls) for i, dc in dcols.items()}
    cond_nodes = [tdev.compile_expr(c, dcols) for c in conds]
    key_nodes, _km, _kp, val_plan, _ops, _slots = texec._plan_agg(plan,
                                                                  dcols)
    prog = expr_vm.Program.build(cond_nodes, key_nodes, val_plan)
    return prog, [env[i] for i in prog.in_cols], chunk.num_rows


def _port_eval(plan, chunk, conds):
    """The same through the port's compiler and the VM interpreter."""
    prog, inputs, n = _port_program(plan, chunk, conds)
    mask, outs = expr_vm.interpret(prog, inputs, n, n, torch.device("cpu"))
    keys = [(outs[s][0].numpy(), outs[s][1].numpy()) for s in prog.key_slots]
    vals = [(outs[s][0].numpy(), outs[s][1].numpy()) for s in prog.val_slots]
    return mask.numpy(), keys, vals


def _assert_same_columns(ref, port):
    """Exact: the VM repeats the reference's integer and IEEE float64
    operations one for one (no fused multiply-add on either side at these
    shapes), so values agree bit for bit where they are not NULL."""
    (rm, rk, rv), (pm, pk, pv) = ref, port
    np.testing.assert_array_equal(rm, pm)
    assert len(rk) == len(pk) and len(rv) == len(pv)
    for (rd, rn), (pd, pn) in list(zip(rk, pk)) + list(zip(rv, pv)):
        np.testing.assert_array_equal(rn, pn)
        np.testing.assert_array_equal(
            np.asarray(rd)[~rn].astype(pd.dtype), pd[~rn])


from test_device_ops import QUERIES as DEVICE_OPS_QUERIES  # noqa: E402
from test_torch_slice import (AGG_PATH_QUERIES,  # noqa: E402
                              EXPR_SHAPE_QUERIES, STRING_QUERIES,
                              setup_tables)


@pytest.fixture(scope="module")
def expr_kits():
    from tidb_tpu.testkit import TestKit as RefKit
    from tidb_tpu_torch.testkit import TestKit as PortKit
    kits = (RefKit(), PortKit())
    data, n = carry.gen_lineitem(0.0005, seed=11)
    for tk in kits:
        setup_tables(tk, data, n)
    return kits


Q1_SQL = """select l_returnflag, l_linestatus, sum(l_quantity),
    sum(l_extendedprice), sum(l_extendedprice * (1 - l_discount)),
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)), avg(l_quantity),
    avg(l_extendedprice), avg(l_discount), count(*) from lineitem
    where l_shipdate <= date_sub('1998-12-01', interval 90 day)
    group by l_returnflag, l_linestatus"""
Q6_SQL = """select sum(l_extendedprice * l_discount) from lineitem
    where l_shipdate >= '1994-01-01'
      and l_shipdate < date_add('1994-01-01', interval 1 year)
      and l_discount between 0.02 and 0.08 and l_quantity < 24"""
EXPR_QUERIES = (list(DEVICE_OPS_QUERIES) + [Q1_SQL, Q6_SQL]
                + STRING_QUERIES + AGG_PATH_QUERIES + EXPR_SHAPE_QUERIES)


@pytest.mark.parametrize("qi", range(len(EXPR_QUERIES)))
def test_expr_program_matches_compile_expr(expr_kits, monkeypatch, qi):
    sql = EXPR_QUERIES[qi]
    ref_kit, port_kit = expr_kits
    ref = _ref_eval(*_capture_fragment(monkeypatch, jexec, ref_kit, sql))
    port = _port_eval(*_capture_fragment(monkeypatch, texec, port_kit, sql))
    _assert_same_columns(ref, port)


def test_expr_program_shares_repeated_subexpressions(expr_kits, monkeypatch):
    """Q1 computes l_extendedprice * (1 - l_discount) once and reads each
    column once, though four aggregates name them."""
    prog, _inputs, _n = _port_program(*_capture_fragment(
        monkeypatch, texec, expr_kits[1], Q1_SQL))
    loads = [i for i in prog.instrs if expr_vm.OPCODES[i[0]] == "LOAD"]
    assert len(loads) == len(prog.in_cols) == 7
    muls = [i for i in prog.instrs if expr_vm.OPCODES[i[0]] == "MUL_I"]
    assert len(muls) == 2  # price*(1-disc) and its *(1+tax)



@pytest.mark.parametrize("qi", range(len(EXPR_QUERIES)))
def test_expr_program_hands_on_input_columns(expr_kits, monkeypatch, qi):
    """The program the CUDA wrapper launches leaves out the STOREs of the
    outputs that are input columns unchanged, and what only they read.
    It must give the same mask and other outputs, exactly, and each
    output it leaves out must equal the input column handed on."""
    prog, inputs, n = _port_program(*_capture_fragment(
        monkeypatch, texec, expr_kits[1], EXPR_QUERIES[qi]))
    skip = expr_vm.handed_on(prog, inputs)
    assert skip <= set(prog.pass_in)
    cpu = torch.device("cpu")
    mask, outs = expr_vm.interpret(prog, inputs, n, n, cpu)
    vmask, vouts = expr_vm.interpret(prog.without_stores(skip), inputs, n,
                                     n, cpu)
    np.testing.assert_array_equal(mask.numpy(), vmask.numpy())
    for s, (d, nl) in enumerate(outs):
        if s in skip:
            assert vouts[s] is None
            got = inputs[prog.pass_in[s]]
        else:
            got = vouts[s]
        np.testing.assert_array_equal(d.numpy(), got[0].numpy())
        np.testing.assert_array_equal(nl.numpy(), got[1].numpy())


def test_q1_program_reads_only_what_it_computes_on(expr_kits, monkeypatch):
    """Q1 hands l_quantity (SUM and AVG), l_extendedprice and l_discount
    on as the input columns; the program then no longer reads
    l_quantity, which nothing else uses."""
    prog, inputs, _n = _port_program(*_capture_fragment(
        monkeypatch, texec, expr_kits[1], Q1_SQL))
    skip = expr_vm.handed_on(prog, inputs)
    assert len(skip) == 3
    assert len(prog.without_stores(skip).loaded_slots()) == \
        len(prog.in_cols) - 1


# -- K4 -----------------------------------------------------------------------------

@pytest.mark.parametrize("specs", [
    (("res", 0, True), ("key", 0, False)),
    (("res", 1, False),),
    (("key", 1, True), ("res", 0, False), ("res", 1, True)),
], ids=["desc-float-then-key", "asc-int", "three-keys"])
@pytest.mark.parametrize("k", [1, 5, 40])
def test_topk_matches_reference(specs, k):
    rng = np.random.default_rng(len(specs) * 100 + k)
    cap, ng = 256, 200
    keys = (rng.integers(0, 30, cap).astype(np.int64),
            rng.integers(-5, 5, cap).astype(np.int64))
    key_nulls = (rng.random(cap) < 0.1, rng.random(cap) < 0.2)
    results = (np.round(rng.standard_normal(cap), 1),    # float ties
               rng.integers(0, 4, cap).astype(np.int64))  # int ties
    result_nulls = (rng.random(cap) < 0.1, rng.random(cap) < 0.1)
    ref = jexec._topk_indices(
        *(tuple(jnp.asarray(a) for a in t)
          for t in (keys, key_nulls, results, result_nulls)),
        ng, cap, specs, k)
    port = texec._topk_indices(
        *carry.to_torch((keys, key_nulls, results, result_nulls), "cpu"),
        ng, cap, specs, k)
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())
