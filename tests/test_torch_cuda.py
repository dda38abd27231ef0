"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels build
with nvcc on first use) and skip elsewhere:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports JAX for the
reference's tests; the card's machine need not have it.)

Tolerances: the expression VM and the top-k sort (and the window's
order) must match exactly; the aggregate's, the partial-state merge's
and the window scan's integers, keys and NULL flags exactly, their float
results within rtol 1e-9 / atol 1e-12 (atomics and scans add in a
different order).
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.ops.kernels import expr_vm, groupby_agg, sort_topk

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain versions "
                    "(tests/test_torch_kernels.py)")
    return torch.device("cuda")


def _up(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def test_expr_vm_matches_interpreter(dev):
    rng = np.random.default_rng(1)
    n = 100_003
    price = _up(rng.integers(90000, 10_500_000, n), dev)
    disc = _up(rng.integers(0, 11, n), dev)
    f = _up(rng.standard_normal(n), dev)
    nul = _up(rng.random(n) < 0.1, dev)
    p, d, x = (expr_vm.load(0, "i"), expr_vm.load(1, "i"),
               expr_vm.load(2, "f"))
    rev = expr_vm.arith("mul", p, expr_vm.arith(
        "sub", expr_vm.const(100, "i"), d))
    cond = expr_vm.cmp("lt", expr_vm.to_f(d), expr_vm.const(7.5, "f"))
    ratio = expr_vm.binary("DIV_F", x, expr_vm.to_f(d), kind="f")
    year = expr_vm.Node("CIVIL", (expr_vm.Node(
        "FLOORDIVK", (p,), 7, "i"),), 0, "i")
    prog = expr_vm.Program.build([cond], [year], [(rev, "raw"),
                                                  (ratio, "raw"), (x, "raw")])
    inputs = [(price, nul), (disc, nul), (f, nul)]
    mk, ok = expr_vm.run(prog, inputs, n, n - 5, dev)
    mp, op = expr_vm.interpret(prog, inputs, n, n - 5, dev)
    assert torch.equal(mk, mp)
    # the float input, a value unchanged, is handed on and not copied
    assert ok[prog.val_slots[2]][0].data_ptr() == f.data_ptr()
    for (a, an), (b, bn) in zip(ok, op):
        assert torch.equal(an, bn)
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.mark.parametrize("pack", [((3, 0), (2, 0)), ((16, 0), (16, 0)),
                                  None], ids=["buckets", "wide", "hash"])
def test_groupby_matches_plain(dev, pack):
    rng = np.random.default_rng(2)
    n = 200_000
    hi = 3 if pack == ((3, 0), (2, 0)) else 40_000
    keys = (_up(rng.integers(0, hi, n), dev),
            _up(rng.integers(0, 2, n), dev))
    knulls = tuple(_up(rng.random(n) < 0.02, dev) for _ in range(2))
    vi = _up(rng.integers(-10**6, 10**6, n), dev)
    vf = _up(rng.standard_normal(n), dev)
    vs = _up(rng.integers(0, 50, n), dev)
    vn = _up(rng.random(n) < 0.05, dev)
    ops = ("count", "sum_i", "sum_f", "min", "max", "first", "cnt_dist")
    vals = (vi, vi, vf, vi, vf, vf, vs)
    mask = _up(rng.random(n) < 0.8, dev)
    cap = 1 << 18
    args = (keys, knulls, vals, (vn,) * 7, mask, 2, ops, cap, pack)
    k = groupby_agg.groupby_agg(*args)
    p = groupby_agg.groupby_plain(*args)
    ng = int(k[4])
    assert ng == int(p[4])
    lim = min(ng, cap)
    for a, b in zip(k[0] + k[1], p[0] + p[1]):
        assert torch.equal(a[:lim], b[:lim])
    for j, op in enumerate(ops):
        assert torch.equal(k[3][j][:lim], p[3][j][:lim]), op
        live = ~k[3][j][:lim]
        a, b = k[2][j][:lim][live], p[2][j][:lim][live]
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
        else:
            assert torch.equal(a, b), op


def test_topk_matches_plain(dev):
    rng = np.random.default_rng(3)
    cap = 1 << 16
    cols = [_up(rng.integers(0, 100, cap), dev),
            _up(rng.standard_normal(cap).round(1), dev)]
    nulls = [_up(rng.random(cap) < 0.05, dev) for _ in cols]
    spec = (cols, nulls, [True, False], [False, True], cap, cap - 77)
    assert torch.equal(sort_topk.sort_indices(*spec, 25),
                       sort_topk.sort_plain(*spec)[:25])
    assert torch.equal(sort_topk._sort_cuda(*spec)[:cap],
                       sort_topk.sort_plain(*spec))


# -- the join kernels (K5a join_probe, K5b join_expand, K2's LOADG, K7) ------

def _index(keys_np, nulls_np=None, sorted_layout=False):
    """A host join index over int64 key columns (executor/join_index.py)."""
    from tidb_tpu_torch.executor.join_index import build_join_index
    from tidb_tpu_torch.sqltypes import TYPE_LONGLONG, FieldType
    from tidb_tpu_torch.utils.chunk import Column
    cols = [Column(FieldType(tp=TYPE_LONGLONG), np.asarray(k, np.int64),
                   np.zeros(len(k), bool) if nulls_np is None
                   else nulls_np) for k in keys_np]
    return build_join_index(cols, force_sorted=sorted_layout)


def _same(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
        return
    if isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
        return
    assert torch.equal(a.cpu(), b.cpu()), what


@pytest.mark.parametrize("layout,mode,kind", [
    ("dense", "uniq", "inner"), ("dense", "uniq", "left"),
    ("dense", "count", "inner"), ("dense", "exists", "anti"),
    ("sorted", "uniq", "semi"), ("sorted", "count", "inner"),
    ("sorted", "exists", "semi")])
def test_join_probe_matches_plain(dev, layout, mode, kind):
    from tidb_tpu_torch.ops.kernels import join_probe
    rng = np.random.default_rng(4)
    nb, n = 50_000, 300_007
    minor = (rng.integers(0, 4, nb) if layout == "sorted"
             else np.zeros(nb, np.int64))
    if mode == "uniq":
        bkeys = [rng.permutation(nb) * 3 + 5, minor]
    else:
        bkeys = [rng.integers(0, nb // 2, nb), minor]
    if layout == "dense":
        bkeys[0] = bkeys[0] // 3  # a span within 4x the rows
    idx = _index(bkeys, sorted_layout=layout == "sorted")
    assert idx.kind == layout
    a0 = _up(idx.starts if layout == "dense" else idx.sorted_keys, dev)
    a1, nv = _up(idx.rows, dev), idx.n_valid
    keys = [_up(rng.integers(-10, 3 * nb + 10, n), dev),
            _up(rng.integers(-1, 5, n), dev)]
    knulls = [_up(rng.random(n) < 0.05, dev), None]
    pvalid = _up(rng.random(n) < 0.9, dev)
    bvalid = _up(rng.random(nb) < 0.95, dev)
    args = (keys, knulls, pvalid, idx.packs, a0, a1, nv)
    kw = dict(layout=layout, mode=mode, kind=kind, bvalid=bvalid,
              dense_span=idx.span)
    got = join_probe.probe(*args, **kw)
    want = join_probe.probe_plain(*args, layout, mode, kind, bvalid, None,
                                  idx.span)
    _same(got, want, f"{layout}/{mode}/{kind}")
    if mode != "count":
        flag = got.get("hit", got["valid"])
        _same(list(join_probe.finish(pvalid, flag, kind)),
              list(join_probe.finish_plain(pvalid, flag.cpu().to(dev),
                                           kind)), "finish")


def test_key_range_matches_plain(dev):
    from tidb_tpu_torch.ops.kernels import join_probe
    rng = np.random.default_rng(5)
    n, m = 100_000, 40_000
    lk = [_up(rng.integers(-5, 900, n), dev),
          _up(rng.integers(10, 20, n), dev)]
    rk = [_up(rng.integers(0, 1000, m), dev),
          _up(rng.integers(0, 15, m), dev)]
    ln = [_up(rng.random(n) < 0.03, dev) for _ in lk]
    rn = [_up(rng.random(m) < 0.03, dev) for _ in rk]
    lv, rv = _up(rng.random(n) < 0.9, dev), _up(rng.random(m) < 0.9, dev)
    for k in (1, 2):
        got = join_probe.key_range(lk[:k], ln[:k], lv, rk[:k], rn[:k], rv)
        want = join_probe.key_range_plain(lk[:k], ln[:k], lv, rk[:k], rn[:k],
                                          rv)
        _same(list(got), list(want), f"{k} keys")
    big = [_up(np.array([-(1 << 62), 1 << 62] * 50), dev)] * 2
    z = _up(np.zeros(100, bool), dev)
    o = _up(np.ones(100, bool), dev)
    got = join_probe.key_range(big, [z, z], o, big, [z, z], o)
    assert bool(got[4]) and bool(join_probe.key_range_plain(
        big, [z, z], o, big, [z, z], o)[4])


@pytest.mark.parametrize("case", ["inner", "left", "total_over_cap"])
def test_join_expand_matches_plain(dev, case):
    from tidb_tpu_torch.ops.kernels import join_expand
    rng = np.random.default_rng(6)
    n, nb = 200_003, 90_000
    cnt = rng.integers(0, 5, n)
    cnt[7] = 3000  # a hot key
    pos0 = rng.integers(0, nb - 3100, n)
    a1 = _up(rng.permutation(nb).astype(np.int32), dev)
    pvalid = _up(rng.random(n) < 0.9, dev)
    bvalid = _up(rng.random(nb) < 0.9, dev)
    total = int(cnt.sum())
    cap = total // 2 if case == "total_over_cap" else total + 4096
    pm = [_up(rng.integers(0, 10**6, n), dev), _up(rng.random(n) < 0.1, dev)]
    bm = [_up(rng.integers(0, 10**6, nb), dev)]
    args = (_up(cnt, dev), _up(pos0, dev), pvalid, a1, nb, bvalid, cap)
    kw = dict(left=case == "left", probe_maps=pm, build_maps=bm)
    got = join_expand.expand(*args, **kw)
    want = join_expand.expand_plain(*args, kw["left"], pm, bm)
    _same(got, want, case)
    if case == "total_over_cap":
        assert int(got["total"]) == total > cap
    mask = _up(rng.random(n) < 0.3, dev)
    _same(join_expand.compact(mask, 1 << 17, pm),
          join_expand.expand_plain(None, None, None, None, 0, None, 1 << 17,
                                   probe_maps=pm, cmask=mask), "compact")
    assert int(join_expand.count(mask)) == int(mask.sum())


def test_expr_vm_loadg_matches_interpreter(dev):
    rng = np.random.default_rng(7)
    n, m = 150_001, 40_000
    price = _up(rng.integers(90000, 10_500_000, n), dev)
    disc = _up(rng.integers(0, 11, n), dev)
    date = _up(rng.integers(8000, 10000, m).astype(np.int32), dev)
    nul_n, nul_m = (_up(rng.random(n) < 0.05, dev),
                    _up(rng.random(m) < 0.05, dev))
    bi = _up(rng.integers(0, m, n), dev)
    ext = _up(rng.random(n) < 0.1, dev)
    valid = _up(rng.random(n) < 0.8, dev)
    p, d, dt, v = (expr_vm.load(0, "i"), expr_vm.load(1, "i"),
                   expr_vm.load(2, "i"), expr_vm.load(3, "i"))
    rev = expr_vm.arith("mul", p, expr_vm.arith(
        "sub", expr_vm.const(100, "i"), d))
    cond = expr_vm.cmp("lt", dt, expr_vm.const(9000, "i"))
    prog = expr_vm.Program.build([v, cond], [dt], [(rev, "raw"), (p, "raw")])
    zeros = torch.zeros(n, dtype=torch.bool, device=dev)
    inputs = [(price, nul_n), (disc, nul_n), (date, nul_m, bi, ext),
              (valid, zeros)]
    mk, ok = expr_vm.run(prog, inputs, n, n, dev)
    mp, op = expr_vm.interpret(prog, inputs, n, n, dev)
    assert torch.equal(mk, mp)
    for (a, an), (b, bn) in zip(ok, op):
        assert torch.equal(an, bn)
        assert torch.equal(a, b)
    # a gathered input is never handed on
    assert ok[prog.key_slots[0]][0].data_ptr() != date.data_ptr()


def test_device_join_match_matches_plain(dev):
    from tidb_tpu_torch.ops import device as pdev
    rng = np.random.default_rng(8)
    bk = rng.integers(0, 5000, 30_000)
    bn = rng.random(30_000) < 0.02
    pk = rng.integers(-100, 5100, 70_000)
    pn = rng.random(70_000) < 0.02
    try:
        pdev.set_device("cuda")
        got = pdev.device_join_match((bk, bn), (pk, pn))
        pdev.set_device("cpu")
        want = pdev.device_join_match((bk, bn), (pk, pn))
    finally:
        pdev.set_device("cuda")
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert len(got[0]) > 0


def test_join_kernels_edge_cases(dev):
    """Empty indexes, no matches, one probe row, all rows invalid: the
    kernels launch (or return) cleanly and equal their plain versions."""
    from tidb_tpu_torch.ops.kernels import join_expand, join_probe
    i64max = np.iinfo(np.int64).max
    pad = _up(np.full(8, i64max), dev)          # a sorted index, n_valid 0
    rows = _up(np.zeros(8, np.int32), dev)
    key = [_up(np.array([i64max, 0, 5]), dev)]
    for mode in ("uniq", "count", "exists"):
        args = (key, None, None, None, pad, rows, 0)
        got = join_probe.probe(*args, layout="sorted", mode=mode,
                               kind="anti")
        want = join_probe.probe_plain(*args, "sorted", mode, "anti")
        _same(got, want, f"empty index {mode}")
    one = _up(np.array([3]), dev)
    zero = _up(np.array([0]), dev)
    a1 = _up(np.arange(8, dtype=np.int64), dev)
    for cnt, cap, left in ((zero, 16, False), (zero, 16, True),
                           (one, 2, False), (one, 0, True)):
        args = (cnt, zero, None, a1, 8, None, cap)
        _same(join_expand.expand(*args, left=left),
              join_expand.expand_plain(*args, left), f"expand {cap}")
    none = _up(np.zeros(5, bool), dev)
    _same(join_expand.compact(none, 8),
          join_expand.expand_plain(None, None, None, None, 0, None, 8,
                                   cmask=none), "compact none")
    assert int(join_expand.count(none)) == 0
    k2 = [_up(np.array([1, 2, 3, 4, 5]), dev)] * 2
    got = join_probe.key_range(k2, [none, none], none, k2, [none, none],
                               none)
    want = join_probe.key_range_plain(k2, [none, none], none, k2,
                                      [none, none], none)
    _same(list(got), list(want), "range, nothing valid")


# -- the partial-state merge (K8/K9 merge_states) ------------------------------

def _k1_states(dev, rng, n_parts, pack, n=50_000):
    """Partial states as the streamed path makes them: K1 (CUDA) over
    seeded blocks of rows with two keys (some NULL) and every merge
    op's input."""
    ops = ("sum_i", "sum_f", "min", "max", "first", "count")
    parts = []
    for _p in range(n_parts):
        keys = (_up(rng.integers(0, 100, n), dev), _up(rng.integers(0, 3, n),
                                                       dev))
        knulls = (_up(rng.random(n) < 0.02, dev), _up(np.zeros(n, bool), dev))
        vi = _up(rng.integers(-10**9, 10**9, n), dev)
        vf = _up(rng.standard_normal(n), dev)
        vn = _up(rng.random(n) < 0.1, dev)
        mask = _up(rng.random(n) < 0.9, dev)
        parts.append(groupby_agg.groupby_agg(
            keys, knulls, (vi, vf, vi, vf, vi, vi), (vn,) * 6, mask, 2, ops,
            1 << 9, pack))
    merge_ops = ("sum_i", "sum_f", "min", "max", "first", "sum_i")
    return parts, merge_ops


@pytest.mark.parametrize("pack", [((7, 0), (2, 0)), None],
                         ids=["pack", "hash"])
@pytest.mark.parametrize("merge_cap", [16, 1 << 9], ids=["growth", "fits"])
def test_merge_states_matches_plain(dev, pack, merge_cap):
    from tidb_tpu_torch.ops.kernels import merge_states
    rng = np.random.default_rng(4)
    parts, merge_ops = _k1_states(dev, rng, 6, pack)
    before = merge_states.LAUNCHES[0]
    k = merge_states.merge(parts, 2, merge_ops, merge_cap, pack)
    p = merge_states.merge_plain(parts, 2, merge_ops, merge_cap, pack)
    torch.cuda.synchronize()
    assert merge_states.LAUNCHES[0] == before + 1
    ng = int(k[4])
    assert ng == int(p[4]) and ng > 16
    lim = min(ng, merge_cap)
    assert torch.equal(k[5], p[5])
    for a, b in zip(k[0] + k[1], p[0] + p[1]):
        assert torch.equal(a[:lim], b[:lim])
    for j, op in enumerate(merge_ops):
        assert torch.equal(k[3][j][:lim], p[3][j][:lim]), op
        live = ~k[3][j][:lim]
        a, b = k[2][j][:lim][live], p[2][j][:lim][live]
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
        else:
            assert torch.equal(a, b), op


@pytest.mark.parametrize("pack", [((7, 0), (2, 0)), None],
                         ids=["pack", "hash"])
def test_merge_states_of_empty_parts(dev, pack):
    """Parts whose n_groups is 0 (a block the filter emptied) merge to no
    group; one live part among empty ones merges to its own groups."""
    from tidb_tpu_torch.ops.kernels import merge_states
    rng = np.random.default_rng(6)
    parts, merge_ops = _k1_states(dev, rng, 3, pack)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    empty = [p[:4] + (zero,) + p[5:] for p in parts]
    for case in (empty, empty[:1] + parts[1:2] + empty[2:]):
        k = merge_states.merge(case, 2, merge_ops, 1 << 9, pack)
        p = merge_states.merge_plain(case, 2, merge_ops, 1 << 9, pack)
        torch.cuda.synchronize()
        ng = int(k[4])
        assert ng == int(p[4]) == (0 if case is empty
                                   else int(parts[1][4]))
        for a, b in zip(k[0] + k[1] + k[3], p[0] + p[1] + p[3]):
            assert torch.equal(a[:ng], b[:ng])


# -- the window kernel (K10 window_scan) and K4's window order --------------

def _window_case(dev, seed, nb, n_live):
    """Two partition keys (int, double with -0.0 / 0.0), two order keys
    (int, double; ties), NULLs everywhere, three argument columns (huge
    ints that wrap, doubles, all NULL), sorted by K4's window order."""
    rng = np.random.default_rng(seed)

    def col(vals, p_null):
        return (_up(vals, dev), _up(rng.random(nb) < p_null, dev))

    part = [col(rng.integers(0, 40, nb), 0.05),
            col(rng.choice([-0.0, 0.0, 1.5], nb), 0.05)]
    order = [col(rng.integers(-3, 4, nb), 0.1),
             col(rng.choice([-2.5, 0.0, 1.0, 7.25], nb), 0.1)]
    args = [col(rng.integers(-2**62, 2**62, nb), 0.2),
            col(rng.standard_normal(nb) * 1e6, 0.2),
            col(np.zeros(nb, np.int64), 1.0)]
    keys = part + order
    descs = [False, False, True, False]
    idx = sort_topk.window_order([k[0] for k in keys],
                                 [k[1] for k in keys], descs, nb, n_live)
    return part, order, args, idx


@pytest.mark.parametrize("ordered", [True, False], ids=["order", "no_order"])
def test_window_scan_matches_plain(dev, ordered):
    """K10 against its plain version: NULL flags and integers exact,
    doubles within rtol 1e-9 / atol 1e-12 (float sums scan in another
    order)."""
    from tidb_tpu_torch.ops.kernels import window_scan
    nb, n_live = 300_007, 287_001
    part, order, args, idx = _window_case(dev, 11, nb, n_live)
    if not ordered:
        order = []
    funcs = [("row_number", None), ("rank", None), ("dense_rank", None),
             ("percent_rank", None), ("cume_dist", None), ("count", 0),
             ("sum", 0), ("min", 0), ("max", 0), ("sum", 1), ("min", 1),
             ("max", 1), ("count", 2), ("sum", 2), ("max", 2)]
    k = window_scan.run(nb, n_live, idx, part, order, args, funcs, dev)
    p = window_scan.window_plain(nb, n_live, idx, part, order, args, funcs,
                                 dev)
    for (name, _a), (kd, kn), (pd, pn) in zip(funcs, k, p):
        assert torch.equal(kn, pn), name
        a, b = kd[~kn], pd[~pn]
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
        else:
            assert torch.equal(a, b), name
    # input order (no sort): a window without keys
    k = window_scan.run(nb, n_live, None, [], [], args, funcs[:3], dev)
    p = window_scan.window_plain(nb, n_live, None, [], [], args, funcs[:3],
                                 dev)
    for (kd, kn), (pd, pn) in zip(k, p):
        assert torch.equal(kd, pd) and torch.equal(kn, pn)


def test_window_order_matches_torch_sort(dev):
    """K4's window order over two int64 keys without NULLs equals
    torch.sort(stable=True) of the one int64 that packs them, with the
    rows past n_live last (and among themselves in key order, as the
    reference's lexsort has them)."""
    rng = np.random.default_rng(12)
    nb, n_live = 1 << 18, (1 << 18) - 999
    a = _up(rng.integers(0, 1000, nb), dev)
    b = _up(rng.integers(0, 3000, nb), dev)
    z = _up(np.zeros(nb, bool), dev)
    got = sort_topk.window_order([a, b], [z, z], [False, False], nb, n_live)
    live = torch.arange(nb, device=dev) < n_live
    packed = a * 3000 + b + torch.where(
        live, 0, torch.full((), 1 << 62, device=dev))
    assert torch.equal(got, torch.sort(packed, stable=True).indices)


# -- the hybrid hash join on the card ----------------------------------------

def test_hybrid_mixed_split_matches_cpu(dev):
    """tests/test_hybrid_join.py's mixed split (a wide build side under a
    120,000-byte budget: some partitions probe on the card, the rest
    spill to the host worker) on the card against the same query on the
    CPU's plain kernels: the same rows and the same split, with K5a, K1
    and the partial-state merge launched on the card."""
    from tidb_tpu_torch.executor import hybrid_join
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops import residency
    from tidb_tpu_torch.ops.kernels import join_probe, merge_states
    from tidb_tpu_torch.storage.paged import spill_outstanding
    from tidb_tpu_torch.testkit import TestKit
    tk = TestKit()
    tk.must_exec("create table fact (fk bigint, v bigint)")
    tk.must_exec("create table big (id bigint primary key, w1 bigint, "
                 "w2 bigint, w3 bigint, w4 bigint)")
    rng = np.random.default_rng(3)
    nb, nf = 6000, 8000
    tk.must_exec("insert into big values " + ",".join(
        f"({i},{i % 7},{i % 11},{i % 13},{i % 17})" for i in range(nb)))
    fk, v = rng.integers(0, nb, nf), rng.integers(1, 50, nf)
    tk.must_exec("insert into fact values " + ",".join(
        f"({int(fk[i])},{int(v[i])})" for i in range(nf)))
    sql = ("select w1, sum(v*w2) s, sum(w3+w4) t, count(*) c "
           "from fact, big where fk = id group by w1 order by w1")
    counters = (join_probe.LAUNCHES, groupby_agg.LAUNCHES,
                merge_states.LAUNCHES)
    out = {}
    try:
        for d in ("cpu", "cuda"):
            pdev.set_device(d)
            residency.evict_all("hybrid card test")
            hybrid_join._THROUGHPUT.clear()
            tk.must_exec("set global tidb_device_mem_budget = 120000")
            tk.must_exec("set tidb_executor_engine = 'tpu'")
            before = [c[0] for c in counters]
            runs0 = hybrid_join.STATS["hj_runs"]
            rows = tk.must_query(sql).rows
            torch.cuda.synchronize()
            out[d] = (rows, hybrid_join.STATS["hj_runs"] - runs0,
                      hybrid_join.STATS["hj_partitions"],
                      hybrid_join.STATS["hj_spilled_partitions"],
                      [c[0] - b for c, b in zip(counters, before)])
            assert spill_outstanding()["open_sets"] == 0
            assert residency.verify_ledger()["ok"]
    finally:
        tk.must_exec("set global tidb_device_mem_budget = 0")
        pdev.set_device("cuda")
    assert out["cuda"][:4] == out["cpu"][:4]
    _rows, ran, parts, spilled, launched = out["cuda"]
    assert ran == 1 and 0 < spilled < parts
    assert all(n > 0 for n in launched), launched
