"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels build
with nvcc on first use) and skip elsewhere:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports JAX for the
reference's tests; the card's machine need not have it.)

The cases at the end need two or more cards and skip with fewer: each
kernel on the last card from a thread whose current device is card 0,
the wrappers' refusal of tensors on two cards, and K11's steps on a split
mesh of one shard a card.

Tolerances: the expression VM and the top-k sort (and the window's
order) must match exactly; the aggregate's, the partial-state merge's
and the window scan's integers, keys and NULL flags exactly, their float
results within rtol 1e-9 / atol 1e-12 (atomics and scans add in a
different order).
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.ops.kernels import (expr_vm, groupby_agg, sort_topk,
                                        window_scan)

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


_I64 = np.iinfo(np.int64)
_SPECIALS = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5,
                      -2.25, 5e-324, -1e308, 1e308])


def _topk_case(name, cap, rng):
    """(cols, nulls, descs, nulls_first) of one K4 case, numpy."""
    def nul(p):
        return rng.random(cap) < p

    if name == "two-keys":  # the original case: int desc, float asc, NULLs
        return ([rng.integers(0, 100, cap), rng.standard_normal(cap).round(1)],
                [nul(0.05), nul(0.05)], [True, False], [False, True])
    if name == "int64-extremes":
        vals = np.array([_I64.min, _I64.max, _I64.min + 1, 0, -1, 1])
        return ([rng.choice(vals, cap), rng.integers(0, 3, cap)],
                [nul(0.1), nul(0.1)], [True, False], [False, True])
    if name == "float-specials":
        return ([rng.choice(_SPECIALS, cap), rng.choice(_SPECIALS, cap)],
                [nul(0.1), nul(0.3)], [False, True], [True, False])
    if name == "one-distinct-value":
        return ([np.full(cap, 42), rng.integers(0, 5, cap)],
                [nul(0.0), nul(0.1)], [False, True], [False, False])
    if name == "multi-word":  # two full-range int64 keys: 129+ bits
        return ([rng.integers(_I64.min, _I64.max, cap),
                 rng.integers(_I64.min, _I64.max, cap)],
                [nul(0.1), nul(0.0)], [False, True], [True, True])
    if name == "sixteen-keys":
        return ([rng.integers(-(1 << s), 1 << s, cap) for s in range(8)]
                + [rng.standard_normal(cap).round(1) for _ in range(8)],
                [nul(0.05 * (j % 3)) for j in range(16)],
                [bool(j % 2) for j in range(16)],
                [bool(j % 3) for j in range(16)])
    raise AssertionError(name)


@pytest.mark.parametrize("cap", [1, 2, 1023, 1025, (1 << 16), (1 << 20) + 7])
@pytest.mark.parametrize("case", ["two-keys", "int64-extremes",
                                  "float-specials", "one-distinct-value",
                                  "multi-word", "sixteen-keys"])
def test_topk_matches_plain(dev, case, cap):
    """K4's full order and its top-k (k = 1, 25 and every slot) equal
    sort_plain's exactly, with no slot live, some and all.  sort_plain
    runs on CPU copies of the keys: torch's sort of CUDA tensors orders
    -0.0 and the NaNs otherwise than its CPU sort and the reference."""
    rng = np.random.default_rng(3)
    cols, nulls, descs, nfs = _topk_case(case, cap, rng)
    host = ([torch.from_numpy(np.ascontiguousarray(c)) for c in cols],
            [torch.from_numpy(m) for m in nulls])
    cols = [_up(c, dev) for c in cols]
    nulls = [_up(m, dev) for m in nulls]
    for ng in sorted({0, cap - min(77, cap // 2), cap}):
        spec = (cols, nulls, descs, nfs, cap, ng)
        full = sort_topk.sort_plain(*host, descs, nfs, cap, ng).to(dev)
        got = sort_topk._sort_cuda(*spec)
        torch.cuda.synchronize()
        assert got.shape[0] >= cap
        assert torch.equal(got[:cap], full), (case, cap, ng)
        for k in sorted({1, min(25, cap), cap}):
            assert torch.equal(sort_topk.sort_indices(*spec, k), full[:k])


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
        _same(list(_vm_finish(flag, pvalid, kind)),
              list(join_probe.finish_plain(pvalid, flag.cpu().to(dev),
                                           kind)), "finish")


def _vm_finish(flag, pvalid, kind):
    """K5a's finish of a match flag as the expression VM's epilogue
    gives it: a program whose mask is the flag itself."""
    n = flag.shape[0]
    prog = expr_vm.Program.build([expr_vm.load(0, "i")], [], [])
    none = torch.zeros(n, dtype=torch.bool, device=flag.device)
    return expr_vm.run(prog, [(flag, none)], n, n, flag.device,
                       finish=(pvalid, kind))[2]


@pytest.mark.parametrize("with_pvalid", [True, False],
                         ids=["pvalid", "no-pvalid"])
@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_vm_finish_matches_plain(dev, kind, with_pvalid):
    """An ON residual's program with the finish epilogue: one launch,
    its mask and the kind's valid rows, no-match map and count equal to
    the interpreter's and finish_plain's; no rows give a count of 0."""
    from tidb_tpu_torch.ops.kernels import join_probe
    rng = np.random.default_rng(9)
    n = (1 << 21) + 7
    hit0 = _up(rng.random(n) < 0.7, dev)
    price = _up(rng.integers(0, 10 ** 6, n), dev)
    nation = _up(rng.integers(0, 25, n), dev)
    nnul = _up(rng.random(n) < 0.1, dev)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    pvalid = _up(rng.random(n) < 0.9, dev) if with_pvalid else None
    p, c = expr_vm.load(1, "i"), expr_vm.load(2, "i")
    prog = expr_vm.Program.build([expr_vm.load(0, "i"), expr_vm.cmp(
        "gt", p, expr_vm.arith("mul", c, expr_vm.const(10000, "i")))],
        [], [])
    ins = [(hit0, none), (price, none), (nation, nnul)]
    before = (expr_vm.LAUNCHES[0], expr_vm.FINISH_LAUNCHES[0])
    hit, _o, fin = expr_vm.run(prog, ins, n, n, dev, finish=(pvalid, kind))
    torch.cuda.synchronize()
    assert (expr_vm.LAUNCHES[0], expr_vm.FINISH_LAUNCHES[0]) == (
        before[0] + 1, before[1] + 1)
    mask, _op = expr_vm.interpret(prog, ins, n, n, dev)
    assert torch.equal(hit, mask)
    _same(list(fin), list(join_probe.finish_plain(pvalid, mask, kind)),
          f"finish {kind}")
    for _ in range(3):  # the count's status words are left at 0
        again = expr_vm.run(prog, ins, n, n, dev, finish=(pvalid, kind))[2]
        assert int(again[2]) == int(fin[2])
    empty = torch.zeros(0, dtype=torch.bool, device=dev)
    got = expr_vm.run(prog, [(empty, empty)] * 3, 0, 0, dev,
                      finish=(None, kind))[2]
    assert int(got[2]) == 0 and got[0].shape == (0,)


def _k7_inputs(case, rng):
    """Seeded (bk, bn, pk, pv) of one K7 layout at a size where each
    stage fills the card, and the path its summary must pick."""
    nb, n = 1 << 20, 3 << 20
    none_b = np.zeros(nb, bool)
    all_p = np.ones(n, bool)
    if case == "unique-dense":
        bk = rng.permutation(nb) * 4 + 1
        return bk, none_b, rng.integers(0, 4 * nb + 8, n), all_p, "uniq"
    if case == "unique-top":
        bk = np.iinfo(np.int64).max - rng.permutation(nb)
        pk = np.iinfo(np.int64).max - rng.integers(0, nb + 99, n)
        pk[:5] = np.iinfo(np.int64).min
        return bk, none_b, pk, all_p, "uniq"
    if case == "dup-dense":
        return (rng.integers(0, nb // 4, nb), none_b,
                rng.integers(-2, nb // 4 + 2, n), all_p, "rank")
    if case == "sparse":
        bk = rng.integers(-(1 << 60), 1 << 60, nb)
        pk = rng.choice(bk, n)
        pk[::3] = rng.integers(-(1 << 60), 1 << 60, len(pk[::3]))
        return bk, none_b, pk, all_p, "sorted"
    if case == "nulls":
        return (rng.integers(0, nb // 2, nb), rng.random(nb) < 0.2,
                rng.integers(0, nb // 2, n), rng.random(n) < 0.8, "rank")
    if case == "dup-runs":
        # lineitem's shape: each key's 1-7 rows adjacent, so a warp's
        # rows share keys
        bk = np.repeat(np.arange(nb), rng.integers(1, 8, nb))[:nb]
        return bk, none_b, rng.integers(-2, nb // 4, n), all_p, "rank"
    if case == "hot-run":
        bk = np.sort(rng.integers(0, nb, nb))
        bk[1000:70000] = 77
        return bk, none_b, rng.integers(0, 4096, n), all_p, "sorted"
    assert case == "hot-key"
    bk = rng.integers(0, nb, nb)
    bk[rng.random(nb) < 0.05] = 77
    return bk, none_b, rng.integers(0, 4096, n), all_p, "sorted"


@pytest.mark.parametrize("case", ["unique-dense", "unique-top", "dup-dense",
                                  "sparse", "nulls", "hot-key", "dup-runs",
                                  "hot-run"])
def test_join_match_matches_plain(dev, case):
    """K7 on the card against its plain version on the CPU: the same
    path, the same pairs in the same order; the index stage launches
    every time, the uniq or order stage where the path runs it."""
    from tidb_tpu_torch.ops.kernels import join_match
    rng = np.random.default_rng(10)
    bk, bn, pk, pv, path = _k7_inputs(case, rng)
    ins = [np.asarray(bk, np.int64), bn, np.asarray(pk, np.int64), pv]
    before = {k: c[0] for k, c in join_match.STAGE_LAUNCHES.items()}
    info = {}
    got = join_match.match(*[_up(a, dev) for a in ins], info=info)
    torch.cuda.synchronize()
    moved = {k: c[0] - before[k]
             for k, c in join_match.STAGE_LAUNCHES.items()}
    plain_info = {}
    want = join_match.match(*[torch.from_numpy(a) for a in ins],
                            info=plain_info)
    assert info["path"] == plain_info["path"] == path
    for k in ("min", "max", "nvalid", "maxmult"):
        assert info[k] == plain_info[k], k
    assert moved == {"index": 1, "uniq": int(path == "uniq"),
                     "order": int(path == "rank")}
    assert got[0].shape[0] > 0
    _same(list(got), list(want), f"K7 {case}")


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


# -- the fold as one merge of sorted runs: orders, edges, sizes ----------------

_FOLD_OPS = ("sum_i", "sum_f", "min", "max", "first", "sum_i", "min", "max")


def _plain_parts(dev, rng, n_parts, pack, n=2_000, key_hi=300, spans=None,
                 nan=False, wrap=False, cap=1 << 12):
    """Partial states made by K1's plain version on the CPU (the fold's
    order by contract) from seeded rows, then moved to the card; part p
    draws its first key from spans[p] (a (lo, hi) range) where given.
    Each row feeds every merge op: an int64, a float64 (NaN where `nan`),
    and int64 values near 2^62 where `wrap` (their sums wrap)."""
    ops = ("sum_i", "sum_f", "min", "max", "first", "count", "min", "max")
    parts = []
    for p in range(n_parts):
        lo, hi = spans[p] if spans else (0, key_hi)
        keys = (torch.from_numpy(rng.integers(lo, hi, n)),
                torch.from_numpy(rng.integers(0, 3, n)))
        knulls = (torch.from_numpy(rng.random(n) < 0.02),
                  torch.from_numpy(rng.random(n) < 0.02))
        big = (1 << 62) if wrap else 10**9
        vi = torch.from_numpy(rng.integers(-big, big, n))
        vf = rng.standard_normal(n)
        if nan:
            vf[rng.random(n) < 0.05] = np.nan
        vf = torch.from_numpy(vf)
        vn = torch.from_numpy(rng.random(n) < 0.1)
        mask = torch.from_numpy(rng.random(n) < 0.9)
        st = groupby_agg.groupby_plain(
            keys, knulls, (vi, vf, vf, vf, vi, vi, vi, vi), (vn,) * 8, mask,
            2, ops, cap, pack)
        parts.append(tuple(tuple(t.to(dev) for t in x)
                           if isinstance(x, tuple) else x.to(dev)
                           for x in st))
    return parts


def _fold_same(got, want, ops, cap):
    """The fold's contract: K1's (k1_same), its fault word clear, and
    every slot past n_groups zero and not valid."""
    from tidb_tpu_torch.ops.kernels import merge_states
    ng = merge_states.read_groups(got)
    assert ng == int(want[4])
    k1_same(got, want, ops, cap)
    lim = min(ng, cap)
    for t in got[0] + got[1] + got[2] + got[3] + (got[5],):
        assert not t[lim:].cpu().view(torch.uint8).any()


def _fold_case(dev, rng, case, pack):
    """(parts, merge_cap) of one edge of the merge of sorted runs."""
    if case == "random":
        return _plain_parts(dev, rng, 9, pack), 1 << 12
    if case == "one_part_all_keys":  # part 0 holds every key
        parts = _plain_parts(dev, rng, 1, pack, n=20_000, key_hi=100)
        return parts + _plain_parts(dev, rng, 4, pack, n=30, key_hi=100), 512
    if case == "disjoint":  # parts with disjoint key ranges
        spans = [(1000 * p, 1000 * p + 400) for p in (3, 0, 2, 1, 4)]
        return _plain_parts(dev, rng, 5, pack, spans=spans), 1 << 12
    if case == "same_keys":  # every part holds every key: P copies a key
        return _plain_parts(dev, rng, 12, pack, n=5_000, key_hi=60), 512
    if case == "clamped":  # a part of more groups than its capacity: its
        # slots hold its first groups, and only those fold
        parts = _plain_parts(dev, rng, 4, pack, n=2_000, key_hi=120)
        over = _plain_parts(dev, rng, 1, pack, n=2_000, key_hi=120, cap=64)
        assert int(over[0][4]) > 64
        return parts[:2] + over + parts[2:], 1 << 12
    if case == "all_empty":
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return [p[:4] + (zero,) + p[5:]
                for p in _plain_parts(dev, rng, 5, pack)], 64
    if case == "nan_wrap":  # NaN in min / max, int64 sums that wrap
        return _plain_parts(dev, rng, 7, pack, nan=True, wrap=True), 1 << 12
    raise ValueError(case)


@pytest.mark.parametrize("pack", [((22, 0), (2, 0)), None],
                         ids=["pack", "hash"])
@pytest.mark.parametrize("case", ["random", "one_part_all_keys", "disjoint",
                                  "same_keys", "clamped", "all_empty",
                                  "nan_wrap"])
def test_fold_edges_match_plain(dev, case, pack):
    """Both orders (NULL packed first; NULL after every value without a
    pack) and the edges of the merge of sorted runs."""
    from tidb_tpu_torch.ops.kernels import merge_states
    rng = np.random.default_rng(40)
    parts, cap = _fold_case(dev, rng, case, pack)
    got = merge_states.merge(parts, 2, _FOLD_OPS, cap, pack)
    want = merge_states.merge_plain(parts, 2, _FOLD_OPS, cap, pack)
    torch.cuda.synchronize()
    _fold_same(got, want, _FOLD_OPS, cap)


def test_fold_first_from_the_earliest_part(dev):
    """Every part holds the same keys: `first` and the key's own slot come
    from part 0, sums add in part order."""
    from tidb_tpu_torch.ops.kernels import merge_states
    n = 64
    parts = []
    for p in range(5):
        keys = torch.arange(n, dtype=torch.int64, device=dev)
        nl = torch.zeros(n, dtype=torch.bool, device=dev)
        v = torch.full((n,), 100 + p, dtype=torch.int64, device=dev)
        parts.append(((keys,), (nl,), (v, v), (nl, nl),
                      torch.tensor(n, device=dev), ~nl))
    got = merge_states.merge(parts, 1, ("first", "sum_i"), n, ((7, 0),))
    assert merge_states.read_groups(got) == n
    assert bool((got[2][0] == 100).all())
    assert bool((got[2][1] == sum(100 + p for p in range(5))).all())


@pytest.mark.parametrize("merge_cap", [16, 100])
def test_fold_growth_keeps_n_groups_exact(dev, merge_cap):
    """Past merge_cap n_groups counts every group, the slots below it hold
    the first groups, and a fold at next_pow2(n_groups) equals the plain
    version's."""
    from tidb_tpu_torch.ops.kernels import merge_states
    rng = np.random.default_rng(41)
    parts = _plain_parts(dev, rng, 9, None, n=3_000, key_hi=5_000)
    got = merge_states.merge(parts, 2, _FOLD_OPS, merge_cap)
    want = merge_states.merge_plain(parts, 2, _FOLD_OPS, merge_cap)
    torch.cuda.synchronize()
    ng = merge_states.read_groups(got)
    assert ng > merge_cap
    _fold_same(got, want, _FOLD_OPS, merge_cap)
    cap = 1 << (ng - 1).bit_length()
    _fold_same(merge_states.merge(parts, 2, _FOLD_OPS, cap),
               merge_states.merge_plain(parts, 2, _FOLD_OPS, cap),
               _FOLD_OPS, cap)


@pytest.mark.parametrize("n_parts", [1, 9, 40, 70])
def test_fold_part_counts(dev, n_parts):
    """1, 9 and 40 parts, and 70 of the widest state (8 keys, 32 results:
    more parts than the launch's parameter space holds), each folded in
    groups of at most merge_states.MAX_PARTS."""
    from tidb_tpu_torch.ops.kernels import merge_states
    rng = np.random.default_rng(42 + n_parts)
    nk, m = (8, 32) if n_parts == 70 else (2, len(_FOLD_OPS))
    ops = (_FOLD_OPS * 4)[:m]
    parts = []
    for _p in range(n_parts):
        n = int(rng.integers(0, 400))
        keys = tuple(torch.from_numpy(rng.integers(0, 3 if i else 200, n))
                     for i in range(nk))
        knulls = tuple(torch.from_numpy(rng.random(n) < 0.03)
                       for _i in range(nk))
        vals = tuple(torch.from_numpy(rng.standard_normal(n))
                     if op in ("sum_f",) or (j % 3 == 2 and op != "sum_i")
                     else torch.from_numpy(rng.integers(-99, 99, n))
                     for j, op in enumerate(ops))
        vnulls = tuple(torch.from_numpy(rng.random(n) < 0.1) for _ in ops)
        st = groupby_agg.groupby_plain(keys, knulls, vals, vnulls,
                                       torch.ones(n, dtype=torch.bool), nk,
                                       ops, 512)
        parts.append(tuple(tuple(t.to(dev) for t in x)
                           if isinstance(x, tuple) else x.to(dev)
                           for x in st))
    before = merge_states.LAUNCHES[0]
    got = merge_states.merge(parts, nk, ops, 1 << 13)
    want = merge_states.merge_plain(parts, nk, ops, 1 << 13)
    torch.cuda.synchronize()
    _fold_same(got, want, ops, 1 << 13)
    # one kernel fold a group and one over the groups' states
    groups = merge_states.fold_groups(n_parts)
    assert merge_states.LAUNCHES[0] - before == (
        1 if len(groups) == 1 else len(groups) + 1)


def test_fold_of_mesh_states(dev):
    """The mesh's fold: 8 shard states of one key without a pack
    (parallel/mpp.py dist_agg_step's K1 states)."""
    from tidb_tpu_torch.ops.kernels import merge_states
    from tidb_tpu_torch.parallel import mpp
    rng = np.random.default_rng(43)
    states = []
    for _s in range(8):
        n = 50_000
        keys = _up(rng.integers(-5_000, 5_000, n), dev)
        valid = _up(rng.random(n) < 0.9, dev)
        vals = [_up(rng.integers(-10**6, 10**6, n), dev),
                _up(rng.standard_normal(n), dev)]
        states.append(mpp._local_state(keys, valid, vals, ("sum", "max"),
                                       1 << 14))
    ops = ("sum_i", "max")
    got = merge_states.merge(states, 1, ops, 1 << 14)
    want = merge_states.merge_plain(states, 1, ops, 1 << 14)
    torch.cuda.synchronize()
    _fold_same(got, want, ops, 1 << 14)


def test_fold_q18_sized(dev):
    """Q18's SF10 fold: eight parts of 2^22 slots and a running state of
    2^24, one packed key (orderkeys drawn at random over 60M), a sum."""
    from tidb_tpu_torch.ops.kernels import merge_states
    rng = np.random.default_rng(44)
    parts = []
    for cap in [1 << 24] + [1 << 22] * 8:
        keys = np.unique(rng.integers(1, 60_000_001, cap * 7 // 8))
        n = len(keys)
        pad = np.zeros(cap, dtype=np.int64)
        pad[:n] = keys
        k = _up(pad, dev)
        v = _up(rng.integers(1, 51, cap), dev)
        nl = torch.zeros(cap, dtype=torch.bool, device=dev)
        parts.append(((k,), (nl,), (v,), (nl,),
                      torch.tensor(n, dtype=torch.int64, device=dev),
                      torch.arange(cap, device=dev) < n))
    pack = ((26, -1),)
    got = merge_states.merge(parts, 1, ("sum_i",), 1 << 26, pack)
    want = merge_states.merge_plain(parts, 1, ("sum_i",), 1 << 26, pack)
    torch.cuda.synchronize()
    _fold_same(got, want, ("sum_i",), 1 << 26)


@pytest.mark.parametrize("where", ["swap", "duplicate", "tile_edge"])
@pytest.mark.parametrize("pack", [((22, 0), (2, 0)), None],
                         ids=["pack", "hash"])
def test_fold_refuses_a_part_out_of_order(dev, where, pack):
    """A part whose live keys are not distinct and ascending raises on the
    read of n_groups; no rows are returned."""
    from tidb_tpu_torch.ops.kernels import merge_states
    rng = np.random.default_rng(45)
    n = 200_000 if where == "tile_edge" else 2_000
    parts = _plain_parts(dev, rng, 3, pack, n=n, key_hi=10 * n, cap=1 << 18)
    k0 = parts[1][0][0]
    ng = int(parts[1][4])
    # tile_edge: a swap deep in a part that spans many tiles
    i = {"swap": 5, "duplicate": 7, "tile_edge": ng // 2}[where]
    if where == "duplicate":
        for col in parts[1][0] + parts[1][1]:
            col[i + 1] = col[i]
    else:
        for col in parts[1][0] + parts[1][1]:
            a, b = col[i].clone(), col[i + 1].clone()
            col[i], col[i + 1] = b, a
    got = merge_states.merge(parts, 2, _FOLD_OPS, 1 << 20, pack)
    with pytest.raises(merge_states.FoldOrderError):
        merge_states.read_groups(got)
    assert k0.shape[0] > 0
    # the next fold on the stream is clear
    good = _plain_parts(dev, rng, 2, pack)
    _fold_same(merge_states.merge(good, 2, _FOLD_OPS, 1 << 12, pack),
               merge_states.merge_plain(good, 2, _FOLD_OPS, 1 << 12, pack),
               _FOLD_OPS, 1 << 12)


@pytest.mark.parametrize("pack", [((22, 0), (2, 0)), None],
                         ids=["pack", "hash"])
def test_fold_of_groups_refuses_a_part_out_of_order(dev, pack):
    """45 parts fold in two groups and then over the groups' states; a
    part out of order in the second group raises, on a stream whose
    status block is new, so it grows between the group launches and the
    last one (which spans more tiles than any group)."""
    from tidb_tpu_torch.ops.kernels import merge_states
    rng = np.random.default_rng(46)
    parts = _plain_parts(dev, rng, 45, pack, n=600, key_hi=3_000)
    assert len(merge_states.fold_groups(45)) == 2
    bad = parts[40]
    assert int(bad[4]) > 10
    for col in bad[0] + bad[1]:
        a, b = col[5].clone(), col[6].clone()
        col[5], col[6] = b, a
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with merge_states._STATUS_LOCK:
        merge_states._STATUS.pop((bad[4].device, stream.cuda_stream), None)
    with torch.cuda.stream(stream):
        got = merge_states.merge(parts, 2, _FOLD_OPS, 1 << 14, pack)
        with pytest.raises(merge_states.FoldOrderError):
            merge_states.read_groups(got)
        st = merge_states._STATUS[(bad[4].device, stream.cuda_stream)]
    tile = merge_states.tile_rows(merge_states.n_words(2, pack))
    # the block grew for the last launch, past the first group's tiles
    assert st.tiles >= -(-45 * (1 << 12) // tile) > -(-32 * (1 << 12)
                                                        // tile)


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


#: every window function over four arguments: huge ints that wrap,
#: doubles, all NULL, and doubles among NaN, +-inf and -0.0
K10_FUNCS = [("row_number", None), ("rank", None), ("dense_rank", None),
             ("percent_rank", None), ("cume_dist", None), ("count", 0),
             ("sum", 0), ("min", 0), ("max", 0), ("sum", 1), ("min", 1),
             ("max", 1), ("count", 2), ("sum", 2), ("max", 2), ("count", 3),
             ("sum", 3), ("min", 3), ("max", 3)]


def _k10_inputs(dev, seed, nb, n_live, part_hi=(40, 3), order_hi=(7, 4),
                key_null=(0.05, 0.1), sort=True):
    """Keys and arguments for K10 (see K10_FUNCS); part_hi / order_hi:
    the distinct values of each partition / order key (0 drops the key;
    an int key takes values below its bound, a double key as many of
    -0.0, 0.0, 1.5, NaN, inf, -inf, -2.5, 7.25); key_null: the share of
    NULL partition and order keys.  Sorted by K4's window order, or in
    input order (idx None) without `sort`."""
    rng = np.random.default_rng(seed)
    floats = np.array([-0.0, 0.0, 1.5, np.nan, np.inf, -np.inf, -2.5, 7.25])

    def col(vals, p_null):
        return (_up(vals, dev), _up(rng.random(nb) < p_null, dev))

    def keys(his, p_null):
        out = []
        for k, hi in enumerate(his):
            if not hi:
                continue
            vals = (rng.integers(0, hi, nb) if k % 2 == 0
                    else rng.choice(floats[:hi], nb))
            out.append(col(vals, p_null))
        return out

    part, order = keys(part_hi, key_null[0]), keys(order_hi, key_null[1])
    args = [col(rng.integers(-2**62, 2**62, nb), 0.2),
            col(rng.standard_normal(nb) * 1e6, 0.2),
            col(np.zeros(nb, np.int64), 1.0),
            col(rng.choice(floats, nb), 0.3)]
    ks = part + order
    idx = None
    if sort and ks:
        idx = sort_topk.window_order(
            [k[0] for k in ks], [k[1] for k in ks],
            [False] * len(part) + [k % 2 == 1 for k in range(len(order))],
            nb, n_live)
    return part, order, args, idx


def _k10_check(dev, nb, n_live, idx, part, order, args, funcs=K10_FUNCS):
    """K10 against its plain version on the card: NULL flags and integers
    exact, doubles within rtol 1e-9 / atol 1e-12 (float sums scan in
    another order), NaN where the plain version has NaN."""
    from tidb_tpu_torch.ops.kernels import window_scan
    before = window_scan.LAUNCHES[0]
    k = window_scan.run(nb, n_live, idx, part, order, args, funcs, dev)
    p = window_scan.window_plain(nb, n_live, idx, part, order, args, funcs,
                                 dev)
    torch.cuda.synchronize()
    assert window_scan.LAUNCHES[0] == before + 1
    for (name, a), (kd, kn), (pd, pn) in zip(funcs, k, p):
        assert kd.dtype == pd.dtype and kd.shape == pd.shape == (nb,)
        assert torch.equal(kn, pn), (name, a)
        x, y = kd[~kn], pd[~pn]
        if x.is_floating_point():
            torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-12,
                                       equal_nan=True, msg=f"{name} {a}")
        else:
            assert torch.equal(x, y), (name, a)


#: K10's tile: the sorted rows one block of its scan takes
T = window_scan.TILE


@pytest.mark.parametrize("nb", [T - 1, T, T + 1, 3 * T + 77],
                         ids=["below", "at", "above", "ragged"])
def test_window_scan_tile_edges(dev, nb):
    """One tile less a row, one tile, one tile and a row, and a ragged
    multiple of K10's tile."""
    part, order, args, idx = _k10_inputs(dev, 21, nb, nb - 13)
    _k10_check(dev, nb, nb - 13, idx, part, order, args)


@pytest.mark.parametrize("case", ["no_keys", "constant_key",
                                  "constant_key_ordered"])
def test_window_scan_one_partition(dev, case):
    """count(*) over (): one partition of nb rows (n_live == nb), whose
    frame ends in the last tile for every row; with one constant key, and
    with an order key of few values (peer groups over many tiles)."""
    nb = 40 * T + 5
    part_hi = (0, 0) if case == "no_keys" else (1, 0)
    order_hi = (3, 0) if case == "constant_key_ordered" else (0, 0)
    part, order, args, idx = _k10_inputs(dev, 22, nb, nb, part_hi, order_hi,
                                         key_null=(0.0, 0.0))
    _k10_check(dev, nb, nb, idx, part, order, args)


@pytest.mark.parametrize("part_hi, order_hi", [
    ((3, 0), (5, 0)), ((2, 2), (0, 3)), ((7, 0), (0, 0)), ((1, 0), (2, 0)),
], ids=["big_parts", "float_keys", "no_order", "few_peers"])
def test_window_scan_segments_straddle_tiles(dev, part_hi, order_hi):
    """Partitions and peer groups of thousands of rows, across many tile
    edges, NULL and NaN keys among them."""
    nb, n_live = 25 * T + 999, 25 * T + 500
    part, order, args, idx = _k10_inputs(dev, 23, nb, n_live, part_hi,
                                         order_hi)
    _k10_check(dev, nb, n_live, idx, part, order, args)


@pytest.mark.parametrize("n_live", [T, 4 * T, 4 * T + 1, 5 * T],
                         ids=["first_edge", "edge", "edge_plus_1", "nb"])
def test_window_scan_n_live_at_tile_edges(dev, n_live):
    nb = 5 * T
    part, order, args, idx = _k10_inputs(dev, 24, nb, n_live, (4, 0), (3, 0))
    _k10_check(dev, nb, n_live, idx, part, order, args)


def test_window_scan_all_null_keys_and_arguments(dev):
    """Every key NULL (one partition, one peer group), every argument
    NULL: counts 0, sums, MIN and MAX NULL."""
    nb = 9 * T + 3
    part, order, args, idx = _k10_inputs(dev, 25, nb, nb - 2,
                                         key_null=(1.0, 1.0))
    args = [(d, torch.ones_like(nl)) for d, nl in args]
    _k10_check(dev, nb, nb - 2, idx, part, order, args)


def test_window_scan_int_sums_wrap(dev):
    """Running int64 sums of values near 2^62 wrap, as int64 does."""
    nb = 6 * T + 1
    part, order, args, idx = _k10_inputs(dev, 26, nb, nb, (2, 0), (0, 0))
    big = torch.full((nb,), 2**62 + 12345, dtype=torch.int64, device=dev)
    args[0] = (big, torch.zeros(nb, dtype=torch.bool, device=dev))
    _k10_check(dev, nb, nb, idx, part, order, args)


def test_window_scan_lane_groups(dev):
    """A window whose lanes pass one block's shared memory runs in lane
    groups, one pass a group, with the same results."""
    nb, n_live = 11 * T + 17, 11 * T
    part, order, args, idx = _k10_inputs(dev, 27, nb, n_live, (30, 0),
                                         (5, 0))
    args = args * 3
    funcs = [("percent_rank", None), ("dense_rank", None)] + [
        (f, a) for a in range(len(args)) for f in ("sum", "min", "max")]
    groups = window_scan.lane_groups(
        funcs, [d.is_floating_point() for d, _n in args])
    assert len(groups) > 1
    _k10_check(dev, nb, n_live, idx, part, order, args, funcs)


@pytest.mark.parametrize("funcs", [
    [("row_number", None)], [("sum", 1)], [("cume_dist", None)],
    [("sum", 0), ("count", 0)], [("percent_rank", None), ("max", 3)],
], ids=["row_number", "sum", "cume_dist", "sum_count", "pct_max"])
def test_window_scan_narrow_windows(dev, funcs):
    """A window of one or two functions: rows of only those columns (no
    padding), frames ending past their tile among them."""
    nb, n_live = 13 * T + 5, 13 * T - 2
    part, order, args, idx = _k10_inputs(dev, 29, nb, n_live, (3, 0),
                                         (4, 0))
    lay = window_scan.output_layout(window_scan.lane_groups(
        funcs, [d.is_floating_point() for d, _n in args]))
    assert lay["n_data"] == len(funcs)
    _k10_check(dev, nb, n_live, idx, part, order, args, funcs)


@pytest.mark.parametrize("keys", [False, True], ids=["no_keys", "keys"])
def test_window_scan_input_order(dev, keys):
    """idx = None: the rows in input order, with and without keys."""
    nb = 7 * T + 11
    hi = ((5, 0), (3, 0)) if keys else ((0, 0), (0, 0))
    part, order, args, idx = _k10_inputs(dev, 28, nb, nb - 7, *hi,
                                         sort=False)
    assert idx is None
    _k10_check(dev, nb, nb - 7, idx, part, order, args)


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


# -- kernel A (MPP exchange) and kernel B (shuffle join sum) ------------------

def _exchange_case(seed, n, hot=False):
    rng = np.random.default_rng(seed)
    i64 = np.iinfo(np.int64)
    keys = rng.integers(i64.min, i64.max, n, dtype=np.int64)
    keys[:6] = [i64.min, i64.max, 0, -1, i64.min + 1, i64.max - 1]
    if hot:
        keys[rng.random(n) < 0.6] = 12345  # one hot bucket: stability
    k2 = rng.integers(-5, 5, n)
    valid = rng.random(n) < 0.9
    nulls = rng.random(n) < 0.05
    f = rng.standard_normal(n)
    codes = rng.integers(0, 1000, n).astype(np.int32)
    return keys, k2, valid, nulls, f, codes


@pytest.mark.parametrize("n_dest,cap,hot", [
    (1, 1 << 20, False), (3, 1 << 17, False), (8, 1 << 16, False),
    (8, 1 << 10, False), (8, 1 << 17, True)],
    ids=["1-dest", "3-dest", "8-dest", "cap-overflow", "hot-key-stable"])
def test_radix_exchange_matches_plain(dev, n_dest, cap, hot):
    from tidb_tpu_torch.ops.kernels import radix_exchange as rx
    n = 700_001
    keys, k2, valid, nulls, f, codes = _exchange_case(n_dest + cap, n, hot)
    cuda_in = [_up(a, dev) for a in (keys, k2, valid, nulls, f, codes)]
    cpu_in = [torch.from_numpy(np.ascontiguousarray(a))
              for a in (keys, k2, valid, nulls, f, codes)]
    outs = []
    for ck, c2, cv, cn, cf, cc in (cuda_in, cpu_in):
        h1, ok1 = rx.dest_hash([ck], "single", valid=cv)
        h2, ok2 = rx.dest_hash([ck, c2], "fold", [cn, None], cv)
        part = rx.partition(h2, ok2, n_dest, 4, cap, [ck, cf, cc, cn])
        outs.append((h1, ok1, h2, ok2, part))
    torch.cuda.synchronize()
    (h1, ok1, h2, ok2, pk), (g1, gk1, g2, gk2, pp) = outs
    assert torch.equal(h1.cpu(), g1) and torch.equal(ok1.cpu(), gk1)
    assert torch.equal(h2.cpu(), g2) and torch.equal(ok2.cpu(), gk2)
    for key in ("rows", "valid"):
        assert torch.equal(pk[key].cpu(), pp[key]), key
    for a, b in zip(pk["cols"], pp["cols"]):
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))
    assert int(pk["need"]) == int(pp["need"])
    assert int(pk["dropped"]) == int(pp["dropped"])
    assert (int(pk["dropped"]) > 0) == (cap == 1 << 10)


@pytest.mark.parametrize("case", ["int64", "float64", "empty-build"])
def test_shuffle_join_matches_plain(dev, case):
    from tidb_tpu_torch.ops.kernels import (join_probe, shuffle_join,
                                            sort_topk)
    rng = np.random.default_rng(3)
    nb, npr = 1_500_000, 6_000_000
    bk = rng.integers(0, 1_000_000, nb)
    pk = rng.integers(0, 1_200_000, npr)
    if case == "float64":
        bv, pv = rng.standard_normal(nb) * 100, rng.random(npr)
    else:
        bv, pv = rng.integers(-10**6, 10**6, nb), rng.integers(1, 50, npr)
    bvalid = rng.random(nb) < (0.0 if case == "empty-build" else 0.8)
    pvalid = rng.random(npr) < 0.9
    t = [_up(a, dev) for a in (bk, bv, bvalid, pk, pv, pvalid)]
    zb = torch.zeros(nb, dtype=torch.bool, device=dev)
    zp = torch.zeros(npr, dtype=torch.bool, device=dev)
    pk2, ok, bk2, _b, _o, nbv, binv = join_probe.key_range(
        [t[3]], [zp], t[5], [t[0]], [zb], t[2])
    o = sort_topk.valid_first_order(bk2, binv)
    pr = join_probe.probe([pk2], [None], ok, None, bk2, None, nbv,
                          layout="sorted", mode="count", order=o)
    # the kernel and its plain version on the same match ranges
    p0, c, b, v = pr["pos0"], pr["cnt"], t[1], t[4]
    total, pairs = shuffle_join.join_sum(b, o, p0, c, v, ok)
    want_t, want_p = shuffle_join.join_sum_plain(
        b.cpu(), o.cpu(), p0.cpu(), c.cpu(), v.cpu(), ok.cpu())
    torch.cuda.synchronize()
    assert int(pairs) == int(want_p)
    if case == "float64":
        assert np.isclose(float(total), float(want_t), rtol=1e-9, atol=1e-12)
    else:
        assert int(total) == int(want_t)
    if case == "empty-build":
        assert int(pairs) == 0 and int(total) == 0


def test_dist_steps_on_the_card_match_the_cpu(dev):
    """K11's dist_agg_step and dist_join_agg_step on an 8-shard mesh on
    the card against the same steps on the CPU."""
    from tidb_tpu_torch.parallel import mpp
    rng = np.random.default_rng(4)
    n = 200_000
    keys, vals = rng.integers(0, 5000, n), rng.integers(-99, 99, n)
    valid = rng.random(n) < 0.9
    got = []
    for d in (dev, torch.device("cpu")):
        m = mpp.make_mesh(8, device=d)
        (k, v, s), pad = mpp.shard_batch(m, keys, valid, vals)
        agg = mpp.dist_agg_step(m, ("sum", "min"), 8192)(k, v & pad, s, s)
        join = mpp.dist_join_agg_step(m, 4096)(k, s, v & pad, k, s, v & pad)
        got.append([a.cpu() if isinstance(a, torch.Tensor) else
                    tuple(x.cpu() for x in a) for a in agg]
                   + [x.cpu() for x in join])
    torch.cuda.synchronize()
    (a, b) = got
    ng = int(a[3])
    assert ng == int(b[3]) and not bool(a[4])
    assert torch.equal(a[0][:ng], b[0][:ng])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x[:ng], y[:ng])
    assert [int(x) for x in a[5:]] == [int(x) for x in b[5:]]


# -- kernels A and B at the edges of their Hopper designs ---------------------
# (tests/test_torch_exchange_plan.py mirrors both plans in numpy against
# the reference on the CPU)

def _partition_both(dev, h, valid, n_dest, n_sub, cap, cols=()):
    """Kernel A on the card against partition_plain on the CPU: every
    buffer bit for bit, need and dropped included.  Inputs are numpy."""
    from tidb_tpu_torch.ops.kernels import radix_exchange as rx

    def t(a, d):
        return None if a is None else _up(a, d)
    cpu = torch.device("cpu")
    got = rx.partition(t(h, dev), t(valid, dev), n_dest, n_sub, cap,
                       [t(c, dev) for c in cols])
    want = rx.partition_plain(t(h, cpu), t(valid, cpu), n_dest, n_sub, cap,
                              [t(c, cpu) for c in cols])
    torch.cuda.synchronize()
    for key in ("rows", "valid"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert len(got["cols"]) == len(cols)
    for a, b in zip(got["cols"], want["cols"]):
        assert a.dtype == b.dtype
        assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))
    assert int(got["need"]) == int(want["need"])
    assert int(got["dropped"]) == int(want["dropped"])
    return got


def _hashes(rng, m):
    return rng.integers(-(1 << 63), (1 << 63) - 1, m, dtype=np.int64)


@pytest.mark.parametrize("m_off", ["0", "1", "tile-1", "tile", "tile+1",
                                   "5 tiles+3"])
def test_radix_exchange_tile_edges(dev, m_off):
    from tidb_tpu_torch.ops.kernels import radix_exchange as rx
    T = rx.TILE
    m = {"0": 0, "1": 1, "tile-1": T - 1, "tile": T, "tile+1": T + 1,
         "5 tiles+3": 5 * T + 3}[m_off]
    rng = np.random.default_rng(m)
    cols = [rng.integers(-9, 9, m), rng.random(m) < 0.5]
    _partition_both(dev, _hashes(rng, m), rng.random(m) < 0.8, 8, 4, 64,
                    cols)


def test_radix_exchange_all_rows_invalid(dev):
    rng = np.random.default_rng(1)
    m = 10_000
    got = _partition_both(dev, _hashes(rng, m), np.zeros(m, bool), 8, 4, 512,
                          [rng.integers(0, 9, m)])
    assert int(got["need"]) == 0 and not got["valid"].any()


def test_radix_exchange_one_bucket_across_tiles(dev):
    """Every row in one bucket, over many tiles: the look-back carries
    the bucket's prefix from tile to tile, in row order; rows past cap
    are dropped and counted."""
    from tidb_tpu_torch.ops.kernels import radix_exchange as rx
    m = 40 * rx.TILE + 77
    h = np.full(m, 0x0000000500000002, dtype=np.int64)
    rng = np.random.default_rng(2)
    got = _partition_both(dev, h, rng.random(m) < 0.9, 8, 4, 1 << 16,
                          [np.arange(m)])
    assert int(got["dropped"]) > 0
    _partition_both(dev, h, None, 8, 4, 1 << 17, [np.arange(m)])


@pytest.mark.parametrize("n_dest,n_sub", [(1023, 1), (3, 1), (1, 1)])
def test_radix_exchange_bucket_counts(dev, n_dest, n_sub):
    rng = np.random.default_rng(n_dest)
    m = 200_003
    _partition_both(dev, _hashes(rng, m), rng.random(m) < 0.7, n_dest, n_sub,
                    max(8, 2 * m // (n_dest * n_sub)),
                    [rng.integers(-5, 5, m), rng.random(m)])


def test_radix_exchange_cap_one(dev):
    rng = np.random.default_rng(3)
    m = 30_000
    got = _partition_both(dev, _hashes(rng, m), rng.random(m) < 0.9, 8, 4, 1,
                          [rng.integers(0, 100, m)])
    assert int(got["dropped"]) > 0


def test_radix_exchange_64_mixed_columns(dev):
    """The most columns, of 1-, 2-, 4- and 8-byte elements; the grid not
    a multiple of 16 bytes a bucket, so the fill's 16-byte stores meet
    ragged edges."""
    rng = np.random.default_rng(4)
    m = 3 * 2048 + 5
    types = [np.int8, np.int16, np.int32, np.int64, np.float32, np.float64,
             np.bool_, np.uint8]
    cols = []
    for c in range(64):
        dt = types[c % len(types)]
        if dt is np.bool_:
            cols.append(rng.random(m) < 0.5)
        elif np.issubdtype(dt, np.floating):
            cols.append(rng.standard_normal(m).astype(dt))
        else:
            info = np.iinfo(dt)
            cols.append(rng.integers(info.min, info.max, m, dtype=dt,
                                     endpoint=True))
    _partition_both(dev, _hashes(rng, m), rng.random(m) < 0.9, 3, 2, 333,
                    cols)


def test_radix_exchange_workspace_reused(dev):
    """Calls in a row on one stream share the workspace: each takes a new
    epoch, so the last call's status words never stand for this one's,
    including across a larger call, a smaller one and the epochs'
    restart."""
    from tidb_tpu_torch.ops.kernels import radix_exchange as rx
    rng = np.random.default_rng(5)
    shapes = [(50_000, 8, 4, 4096), (50_000, 8, 4, 4096),
              (300_000, 1023, 1, 512), (7, 2, 2, 8)]
    for m, n_dest, n_sub, cap in shapes:
        _partition_both(dev, _hashes(rng, m), rng.random(m) < 0.8, n_dest,
                        n_sub, cap, [rng.integers(0, 9, m)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = rx._WS[(dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device()), stream)]
    assert ws.epoch >= len(shapes)
    ws.epoch = rx.EPOCH_LIMIT  # the next call clears the words, epoch 1
    for m, n_dest, n_sub, cap in shapes[:2]:
        _partition_both(dev, _hashes(rng, m), rng.random(m) < 0.8, n_dest,
                        n_sub, cap, [rng.integers(0, 9, m)])
    assert ws.epoch == 2


def _join_sum_both(dev, bv, order, pos0, cnt, pv, pvalid):
    from tidb_tpu_torch.ops.kernels import shuffle_join as sj
    args = [None if a is None else _up(a, dev)
            for a in (bv, order, pos0, cnt, pv, pvalid)]
    total, pairs = sj.join_sum(*args)
    want_t, want_p = sj.join_sum_plain(*[
        None if a is None else torch.from_numpy(np.ascontiguousarray(a))
        for a in (bv, order, pos0, cnt, pv, pvalid)])
    torch.cuda.synchronize()
    assert int(pairs) == int(want_p)
    if total.is_floating_point():
        assert np.isclose(float(total), float(want_t), rtol=1e-9, atol=1e-12)
    else:
        assert int(total) == int(want_t)
    return total, pairs


def _join_sum_inputs(rng, n, np_, floats):
    nbv = max(1, n * 3 // 4)
    bv = rng.standard_normal(n) * 100 if floats else rng.integers(
        -10**9, 10**9, n)
    pv = rng.random(np_) if floats else rng.integers(1, 50, np_)
    pos0 = rng.integers(0, nbv, np_)
    cnt = np.minimum(rng.integers(0, 5, np_), nbv - pos0)
    return bv, rng.permutation(n), pos0, cnt, pv, rng.random(np_) < 0.9


@pytest.mark.parametrize("n_off", ["tile-1", "tile", "tile+1", "1"])
@pytest.mark.parametrize("floats", [False, True], ids=["int64", "float64"])
def test_shuffle_join_tile_edges(dev, n_off, floats):
    from tidb_tpu_torch.ops.kernels import shuffle_join as sj
    T = sj.TILE
    n = {"tile-1": T - 1, "tile": T, "tile+1": T + 1, "1": 1}[n_off]
    rng = np.random.default_rng(n)
    _join_sum_both(dev, *_join_sum_inputs(rng, n, 5000, floats))


@pytest.mark.parametrize("np_", [0, 1, 700])
def test_shuffle_join_empty_probe(dev, np_):
    """No probe row, or none valid: the total and pairs are 0."""
    rng = np.random.default_rng(np_)
    bv, order, pos0, cnt, pv, pvalid = _join_sum_inputs(rng, 9000, np_,
                                                        False)
    total, pairs = _join_sum_both(dev, bv, order, pos0, cnt, pv,
                                  np.zeros(np_, bool))
    assert int(total) == 0 and int(pairs) == 0


@pytest.mark.parametrize("floats", [False, True], ids=["int64", "float64"])
def test_shuffle_join_without_order(dev, floats):
    """order None: the build values are in key order already."""
    rng = np.random.default_rng(8)
    bv, _o, pos0, cnt, pv, pvalid = _join_sum_inputs(rng, 100_000, 300_000,
                                                     floats)
    _join_sum_both(dev, bv, None, pos0, cnt, pv, pvalid)
    _join_sum_both(dev, bv, None, pos0, cnt, pv, None)


def test_shuffle_join_float_total_repeats_bit_for_bit(dev):
    """A float64 total is the same bits over three calls: the look-back
    adds the tiles' sums in tile order, the probe blocks' partials add in
    block order."""
    from tidb_tpu_torch.ops.kernels import shuffle_join as sj
    rng = np.random.default_rng(9)
    ins = _join_sum_inputs(rng, 1 << 21, 1 << 21, True)
    args = [_up(a, dev) for a in ins]
    bits = set()
    for _ in range(3):
        total, _pairs = sj.join_sum(*args)
        bits.add(int(total.view(torch.int64)))
    assert len(bits) == 1
    _join_sum_both(dev, *ins)


# -- K2 and K1 at the edges of their Hopper designs ---------------------------
# (the helpers below take no card: tests/test_torch_vm_agg.py runs the same
# shapes through the plain versions against the reference on the CPU)

def vm_chain(depth):
    """A program whose evaluation keeps about `depth` values live: the
    right-nested product t_0 * (t_1 * (... t_depth)), each t_i a distinct
    term (slot 0 times i + 2, plus i), NEG of slot 0 for depth 0."""
    ev = expr_vm
    a = ev.load(0, "i")
    if depth == 0:
        return ev.Program.build([], [], [(ev.unary("NEG_I", a), "raw")])
    terms = [ev.arith("add", ev.mulk(a, i + 2), ev.const(i, "i"))
             for i in range(depth + 1)]
    e = terms[-1]
    for t in reversed(terms[:-1]):
        e = ev.arith("mul", t, e)
    return ev.Program.build([], [], [(e, "raw")])


def vm_chain_with_regs(n_regs):
    """The chain of :func:`vm_chain` that takes exactly `n_regs`
    registers."""
    for depth in range(0, 2 * n_regs + 2):
        prog = vm_chain(depth)
        if prog.n_regs == n_regs:
            return prog
    raise AssertionError(f"no chain takes {n_regs} registers")


#: the every-opcode program's input dtypes, slot by slot; slot 7 is read
#: through a row index (LOADG)
EVERY_OP_DTYPES = (np.int64, np.int32, np.float64, np.float32, np.bool_,
                   np.int16, np.int8, np.int64)


def vm_every_op():
    """A program that runs every opcode of the VM at least once: a load of
    each input dtype, constants (one NULL), every ALU op, two mask
    conditions, a key and values."""
    ev, Node = expr_vm, expr_vm.Node
    a, b, f, g, u, h, c, j = (ev.load(s, "f" if dt in (np.float64, np.float32)
                                      else "i")
                              for s, dt in enumerate(EVERY_OP_DTYPES))
    lt = ev.cmp("lt", a, b)
    gt = ev.cmp("gt", f, g)
    tr = ev.unary("TRUTHY", u, kind="i")
    vals = [
        ev.to_f(a), ev.to_i(f), ev.mulk(a, 3), ev.divkf(f, 4.0),
        ev.arith("add", a, b), ev.arith("sub", a, j), ev.arith("mul", b, h),
        ev.arith("add", f, g), ev.arith("sub", f, ev.const(0.5, "f")),
        ev.arith("mul", g, f), lt, gt,
        ev.binary("DIV_F", f, g, kind="f"),
        ev.binary("DIV_DEC", a, h, imm=100),
        ev.binary("AND", lt, gt), ev.binary("OR", lt, gt),
        ev.unary("NOT", lt), ev.unary("ISNULL", a, kind="i"),
        ev.unary("NEG_I", a), ev.unary("NEG_F", f), ev.unary("ABS_I", b),
        ev.unary("ABS_F", g),
        ev.in_table(c, np.array([-3, 0, 5], dtype=np.int64), True),
        ev.in_table(f, np.array([0.0, 1.5]), False),
        Node("NZ_F", (g,), None, "i"),
        ev.binary("BAND", tr, lt), ev.binary("BOR", tr, gt),
        ev.unary("BNOT", tr), ev.sel(gt, a, j, "i"),
        ev.binary("COALESCE", a, ev.const(7, "i"), kind="i"),
        Node("CIVIL", (h,), 1, "i"), Node("FLOORDIVK", (a,), 7, "i"),
        ev.lut(u, np.array([10, 20], dtype=np.int64)),
        ev.lut(c, np.array([0.5, 1.5, 2.5])),
        ev.lutn(c, np.array([1, 2, 3, 4], dtype=np.int64),
                np.array([0, 0, 1, 0])),
        ev.lutn(u, np.array([0.25, 0.75, 9.0]), np.array([0, 1, 1])),
        Node("ROUNDDIVK", (a,), 100, "i"), Node("RINT", (f,), None, "i"),
        ev.arith("add", a, ev.null_const("i")),
    ]
    return ev.Program.build([lt, tr], [ev.to_i(g)],
                            [(v, "raw") for v in vals])


def vm_every_op_inputs(prog, rng, n, gather=("idx", "ext")):
    """Seeded numpy inputs of :func:`vm_every_op` in the program's input
    slot order: (data, nulls) per column, column 7 (data, nulls, idx, ext)
    over a relation of n // 3 + 1 rows."""
    ins = []
    for s, dt in enumerate(EVERY_OP_DTYPES):
        rows = n // 3 + 1 if s == 7 else n
        if dt in (np.float64, np.float32):
            d = np.round(rng.standard_normal(rows) * 100, 1).astype(dt)
            d[rng.random(rows) < 0.05] = 0.0
        elif dt is np.bool_:
            d = rng.random(rows) < 0.5
        else:
            lo, hi = {np.int8: (-5, 6), np.int16: (-2000, 20000)}.get(
                dt, (-10**6, 10**6))
            d = rng.integers(lo, hi, rows).astype(dt)
        ins.append([d, rng.random(rows) < 0.1])
    ins[7] += [rng.integers(0, n // 3 + 1, n) if "idx" in gather else None,
               rng.random(n) < 0.1 if "ext" in gather else None]
    if ins[7][2] is None:  # no row index: the relation is the row space
        ins[7][:2] = [rng.integers(-10**6, 10**6, n), rng.random(n) < 0.1]
    return [tuple(ins[col]) for col in prog.in_cols]


def _vm_same(got, want):
    (mk, ok), (mp, op) = got, want
    assert torch.equal(mk.cpu(), mp.cpu())
    for s, ((a, an), (b, bn)) in enumerate(zip(ok, op)):
        assert torch.equal(an.cpu(), bn.cpu()), s
        a, b = a.cpu(), b.cpu()
        if a.is_floating_point():
            a, b = a.view(torch.int64), b.view(torch.int64)
        assert torch.equal(a, b), s


def _vm_on(dev, ins):
    return [tuple(None if x is None else _up(x, dev) for x in inp)
            for inp in ins]


@pytest.mark.parametrize("n_regs", [1, 8, 64])
@pytest.mark.parametrize("n,live", [(100_003, "all"), (100_003, "none"),
                                    (100_003, "half"), (7, "all"),
                                    (2048 * 5, "half")])
def test_expr_vm_register_chain_matches_interpreter(dev, n_regs, n, live):
    """Programs of 1, 8 and 64 registers (the register file sized to the
    program, rows per thread from 4 down to 1), n below a warp, not a
    multiple of a tile and a whole number of tiles, n_live 0, n / 2, n."""
    prog = vm_chain_with_regs(n_regs)
    rng = np.random.default_rng(n_regs * 7 + n)
    ins = _vm_on(dev, [(rng.integers(-1000, 1000, n), rng.random(n) < 0.1)])
    n_live = {"all": n, "none": 0, "half": n // 2}[live]
    got = expr_vm.run(prog, ins, n, n_live, dev)
    want = expr_vm.interpret(prog, ins, n, n_live, dev)
    torch.cuda.synchronize()
    _vm_same(got, want)
    assert not bool(got[0][n_live:].any())


@pytest.mark.parametrize("gather", [("idx", "ext"), ("idx",), ("ext",)],
                         ids=["idx+ext", "idx", "ext"])
@pytest.mark.parametrize("n", [5, 65_537])
def test_expr_vm_every_opcode_matches_interpreter(dev, gather, n):
    prog = vm_every_op()
    rng = np.random.default_rng(n + len(gather))
    ins = _vm_on(dev, vm_every_op_inputs(prog, rng, n, gather))
    before = expr_vm.LAUNCHES[0]
    for n_live in (n, n - 2, 0):
        _vm_same(expr_vm.run(prog, ins, n, n_live, dev),
                 expr_vm.interpret(prog, ins, n, n_live, dev))
    torch.cuda.synchronize()
    assert expr_vm.LAUNCHES[0] == before + 3


@pytest.mark.parametrize("rpt", [1, 2, 4])
def test_expr_vm_rows_per_thread_agree(dev, rpt, monkeypatch):
    """Every tile shape gives the interpreter's bits (the plan forced to
    `rpt` rows per thread)."""
    plan = expr_vm.launch_plan
    monkeypatch.setattr(expr_vm, "launch_plan",
                        lambda *a, **k: plan(*a, rpt=rpt))
    prog = vm_every_op()
    n = 30_001
    ins = _vm_on(dev, vm_every_op_inputs(prog, np.random.default_rng(rpt),
                                         n))
    _vm_same(expr_vm.run(prog, ins, n, n - 5, dev),
             expr_vm.interpret(prog, ins, n, n - 5, dev))


def vm_long_program(n_terms):
    """A program of about 4 * n_terms instructions in few registers: the
    balanced sum of n_terms distinct terms (slot 0 * (i + 2) + i)."""
    ev = expr_vm
    a = ev.load(0, "i")
    terms = [ev.arith("add", ev.mulk(a, i + 2), ev.const(i, "i"))
             for i in range(n_terms)]
    while len(terms) > 1:
        terms = [ev.arith("add", *terms[i:i + 2]) if i + 1 < len(terms)
                 else terms[i] for i in range(0, len(terms), 2)]
    return ev.Program.build([], [], [(terms[0], "raw")])


#: a program of about 1,100 instructions (staged in shared memory) and one
#: too long for shared memory beside its register file
LONG_TERMS, PAST_SHARED_TERMS = 275, 1_700


def _vm_long_run(dev, prog, n):
    rng = np.random.default_rng(len(prog.instrs))
    ins = _vm_on(dev, [(rng.integers(-1000, 1000, n), rng.random(n) < 0.1)])
    _vm_same(expr_vm.run(prog, ins, n, n - 3, dev),
             expr_vm.interpret(prog, ins, n, n - 3, dev))


@pytest.mark.parametrize("stage", [expr_vm.STAGE_NONE, expr_vm.STAGE_PROG,
                                   expr_vm.STAGE_ALL])
def test_expr_vm_long_program_matches_interpreter(dev, stage, monkeypatch):
    """A program of about 1,100 instructions gives the interpreter's bits
    with the stream and the constants in shared memory or read from
    device memory (the plan forced to each stage)."""
    prog = vm_long_program(LONG_TERMS)
    assert 1_050 <= len(prog.instrs) <= 1_150
    plan = expr_vm.launch_plan

    def forced(n_regs, n_instr, n_ci, n_cf, rpt=None):
        rpt = plan(n_regs, n_instr, n_ci, n_cf, rpt)[0]
        shared = (n_regs * expr_vm.VM_THREADS * rpt * 9
                  + (stage > 0) * n_instr * 32
                  + (stage > 1) * 8 * (n_ci + n_cf))
        return rpt, stage, shared
    monkeypatch.setattr(expr_vm, "launch_plan", forced)
    _vm_long_run(dev, prog, 100_003)


def test_expr_vm_program_past_shared_memory_matches_interpreter(dev):
    """A stream too long for shared memory is read from device memory."""
    prog = vm_long_program(PAST_SHARED_TERMS)
    assert expr_vm.launch_plan(prog.n_regs, len(prog.instrs), len(prog.ci),
                               len(prog.cf))[1] == expr_vm.STAGE_NONE
    _vm_long_run(dev, prog, 30_001)


#: the accumulate's modes (groupby_agg.accumulate_mode) and a pack that
#: takes each with the edge cases' aggregates
K1_PATHS = {"warp": ((3, 0), (2, 0)), "block": ((6, 0), (2, 0)),
            "global": ((12, 0), (2, 0)), "hash": None}
K1_OPS = ("count", "sum_i", "sum_f", "min", "max", "min", "max", "first",
          "cnt_dist", "sum_i")
_SPECIAL_F = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, -2.5])


def k1_edge_case(case, n, rng):
    """(keys, knulls, vals, vnulls, mask) numpy inputs of one K1 edge case
    for K1_OPS over two keys (key 0 below 7, key 1 below 3): "one_group"
    (every kept row in one group), "warp_bucket" (each aligned run of 32
    rows in one group), "nan_inf_zero" (NaN, +-inf, +-0.0 under min and
    max), "wrap" (int64 sums past 2^63), "distinct" (count distinct over
    few values beside the other aggregates)."""
    k0, k1 = rng.integers(0, 7, n), rng.integers(0, 3, n)
    kn = [rng.random(n) < 0.02, np.zeros(n, bool)]
    vi = rng.integers(-10**6, 10**6, n)
    vf = rng.standard_normal(n)
    vd = rng.integers(0, 1000, n)
    mask = rng.random(n) < 0.9
    if case == "one_group":
        k0, k1 = np.full(n, 4), np.full(n, 1)
        kn = [np.zeros(n, bool)] * 2
        mask = np.ones(n, bool)
    elif case == "warp_bucket":
        run = np.arange(n) // 32
        k0, k1 = run % 7, (run // 7) % 3
        mask = np.ones(n, bool)
    elif case == "nan_inf_zero":
        vf = rng.choice(_SPECIAL_F, n, p=[.02, .1, .1, .29, .29, .1, .1])
    elif case == "wrap":
        vi = rng.integers(2**62, 2**63 - 1, n, dtype=np.int64)
        vi[rng.random(n) < 0.3] *= -1
    elif case == "distinct":
        vd = rng.integers(0, 5, n)
    vals = (vi, vi, vf, vi, vi, vf, vf, vi, vd, vi)
    vnulls = tuple(rng.random(n) < 0.05 for _ in K1_OPS)
    return (k0, k1), tuple(kn), vals, vnulls, mask


def k1_same(got, want, ops, cap):
    """K1's contract: n_groups, valid, keys, NULL flags and integers
    exact, floats within rtol 1e-9 / atol 1e-12 (NaN equal to NaN)."""
    ng = int(got[4])
    assert ng == int(want[4])
    lim = min(ng, cap)
    assert torch.equal(got[5].cpu(), want[5].cpu())
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a[:lim].cpu(), b[:lim].cpu())
    for j, op in enumerate(ops):
        assert torch.equal(got[3][j][:lim].cpu(), want[3][j][:lim].cpu()), op
        live = ~got[3][j][:lim].cpu()
        a, b = got[2][j][:lim].cpu()[live], want[2][j][:lim].cpu()[live]
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12,
                                       equal_nan=True)
        else:
            assert torch.equal(a, b), op


@pytest.mark.parametrize("path", list(K1_PATHS))
@pytest.mark.parametrize("case", ["one_group", "warp_bucket", "nan_inf_zero",
                                  "wrap", "distinct"])
def test_groupby_edges_match_plain(dev, path, case):
    pack = K1_PATHS[path]
    if pack is not None:
        stride = groupby_agg.slot_layout(K1_OPS)[0]
        mode = groupby_agg.accumulate_mode(1 << sum(b for b, _ in pack),
                                           stride, False)[0]
        assert mode == {"warp": groupby_agg.MODE_WARP,
                        "block": groupby_agg.MODE_BLOCK,
                        "global": groupby_agg.MODE_GLOBAL}[path]
    n = 70_001
    keys, kn, vals, vn, mask = k1_edge_case(
        case, n, np.random.default_rng(len(case) * 31 + len(path)))
    up = [tuple(_up(a, dev) for a in grp) for grp in (keys, kn, vals, vn)]
    cap = 64
    args = (*up, _up(mask, dev), 2, K1_OPS, cap, pack)
    before = groupby_agg.LAUNCHES[0]
    got = groupby_agg.groupby_agg(*args)
    want = groupby_agg.groupby_plain(*args)
    torch.cuda.synchronize()
    assert groupby_agg.LAUNCHES[0] == before + 1
    if case == "one_group":
        assert int(got[4]) == 1
    k1_same(got, want, K1_OPS, cap)
    # every slot past n_groups is zero and not valid
    ng = min(int(got[4]), cap)
    for t in got[0] + got[1] + got[2] + got[3]:
        assert not t[ng:].cpu().view(torch.uint8).any()


@pytest.mark.parametrize("pack", [((7, 0), (2, 0)), None],
                         ids=["pack", "hash"])
def test_merge_states_of_many_small_parts(dev, pack):
    """A fold of 40 parts of a few hundred rows each (the streamed Q1's
    shape, many parts with few live slots)."""
    from tidb_tpu_torch.ops.kernels import merge_states
    rng = np.random.default_rng(12)
    parts, merge_ops = _k1_states(dev, rng, 40, pack, n=300)
    k = merge_states.merge(parts, 2, merge_ops, 1 << 9, pack)
    p = merge_states.merge_plain(parts, 2, merge_ops, 1 << 9, pack)
    torch.cuda.synchronize()
    k1_same(k, p, merge_ops, 1 << 9)


# -- K5a's sampled sorted probe and K5b's slot-tiled expansion ----------------

_I64_MAX = np.iinfo(np.int64).max
_PROBE_MODES = [("uniq", "inner"), ("uniq", "left"), ("uniq", "semi"),
                ("uniq", "anti"), ("count", "inner"), ("exists", "semi"),
                ("exists", "anti")]


def _sorted_probe_case(case, rng):
    """(build keys in sorted order, padded with int64.max; n_valid; probe
    keys; a sort order or None) for one edge of the sampled search."""
    order = None
    if case == "nv0":
        sk, nv = np.full(8, _I64_MAX), 0
    elif case == "nv1":
        sk, nv = np.array([42, _I64_MAX, _I64_MAX]), 1
    elif case == "ragged":  # n_valid no multiple of any sample stride
        sk = np.sort(rng.integers(0, 30_000, 10_007))
        nv = len(sk)
    elif case == "straddle":  # runs of 7 equal keys across sample points
        sk, nv = np.repeat(np.arange(0, 9_000, 3), 7), 3_000 * 7
    elif case == "hot":  # one key over most of the index
        sk = np.sort(np.concatenate([np.full(50_000, 500),
                                     rng.integers(0, 1_000, 3_001)]))
        nv = len(sk)
    elif case == "i64max":  # real int64.max keys, then the padding
        sk = np.concatenate([np.sort(rng.integers(-50, 50, 999)),
                             np.full(3, _I64_MAX), np.full(13, _I64_MAX)])
        nv = 1_002
    else:  # "order": unsorted keys read through a sort order
        keys = rng.integers(-100, 4_000, 20_011)
        order = np.argsort(keys, kind="stable")
        sk, nv = keys, len(keys)
    valid = sk[:nv] if order is None else sk[order]
    lo = int(valid.min()) if nv else 0
    hi = int(valid.max()) if nv else 0
    probe = np.concatenate([
        rng.choice(valid, 5_000) if nv else np.zeros(0, np.int64),
        lo - rng.integers(1, 1_000, 500),  # below the first key
        min(hi, _I64_MAX - 1_000) + rng.integers(1, 1_000, 500),  # above
        np.array([_I64_MAX, np.iinfo(np.int64).min, lo, hi])])
    return sk, nv, probe, order


@pytest.mark.parametrize("sample", [1, 3, 1024, 4096])
@pytest.mark.parametrize("case", ["nv0", "nv1", "ragged", "straddle", "hot",
                                  "i64max", "order"])
def test_sorted_probe_edges_match_plain(dev, case, sample, monkeypatch):
    """The sorted probe bit for bit against its plain version at every
    mode and kind, with invalid and NULL probe rows, n_valid on the host
    and on the device, a sample of one key (the whole search in device
    memory), of three, and the default."""
    from tidb_tpu_torch.ops.kernels import join_probe
    monkeypatch.setattr(join_probe, "SAMPLE", sample)
    rng = np.random.default_rng(31)
    sk, nv, probe, order = _sorted_probe_case(case, rng)
    n = len(probe)
    rows = _up(rng.permutation(max(len(sk), 1)).astype(np.int32), dev)
    bvalid = _up(rng.random(max(len(sk), 1)) < 0.9, dev)
    pvalid = _up(rng.random(n) < 0.9, dev)
    a0 = _up(sk, dev)
    o = None if order is None else _up(order, dev)
    # the packed path (keys as they are) and the range-packed path (one
    # column with NULLs, packed as key - 0 within [0, span): the keys
    # outside the span cannot match)
    clipped = np.clip(probe, -(1 << 40), 1 << 40)
    inputs = [([_up(probe, dev)], None, None),
              ([_up(clipped, dev)], [_up(rng.random(n) < 0.05, dev)],
               [(0, int(clipped.max()) + 1)])]
    for keys, knulls, packs in inputs:
        for nv_arg in (nv, torch.tensor(nv, device=dev)):
            for mode, kind in _PROBE_MODES:
                args = (keys, knulls, pvalid, packs, a0, rows, nv_arg)
                kw = dict(layout="sorted", mode=mode, kind=kind,
                          bvalid=bvalid, order=o)
                got = join_probe.probe(*args, **kw)
                want = join_probe.probe_plain(*args, "sorted", mode, kind,
                                              bvalid, o, None)
                _same(got, want, f"{case}/{sample}/{mode}/{kind}")
                if mode == "count":
                    miss = want["cnt"] == 0
                    assert not want["pos0"][miss].any()


def test_dense_probe_skips_rows_that_cannot_match(dev):
    """The dense probe's rows that are invalid, NULL or out of range read
    no CSR start: pos0 = bi = 0, like a key without build rows."""
    from tidb_tpu_torch.ops.kernels import join_probe
    from tidb_tpu_torch.executor.join_index import build_join_index
    from tidb_tpu_torch.sqltypes import TYPE_LONGLONG, FieldType
    from tidb_tpu_torch.utils.chunk import Column
    rng = np.random.default_rng(32)
    nb, n = 20_000, 100_003
    bk = rng.integers(0, 15_000, nb)
    idx = build_join_index([Column(FieldType(tp=TYPE_LONGLONG), bk,
                                   np.zeros(nb, bool))])
    assert idx.kind == "dense"
    a0, a1 = _up(idx.starts, dev), _up(idx.rows, dev)
    keys = [_up(rng.integers(-500, 16_000, n), dev)]
    knulls = [_up(rng.random(n) < 0.05, dev)]
    pvalid = _up(rng.random(n) < 0.9, dev)
    for mode, kind in _PROBE_MODES:
        args = (keys, knulls, pvalid, idx.packs, a0, a1, idx.n_valid)
        got = join_probe.probe(*args, layout="dense", mode=mode, kind=kind,
                               dense_span=idx.span)
        want = join_probe.probe_plain(*args, "dense", mode, kind, None,
                                      None, idx.span)
        _same(got, want, f"dense {mode}/{kind}")
        if mode == "uniq":
            assert not got["bi"][~got["hit"]].any()


def _expand_case(case, rng):
    """(cnt, pos0, n_valid, cap, left) for one edge of the expansion."""
    nb = 60_000
    left = case == "hot_key_left"
    if case in ("hot_key", "hot_key_left"):
        cnt = rng.integers(0, 3, 20_001)
        cnt[9_000] = 5_000  # over several 1024-slot tiles
        cnt[9_001] = 1_500
    elif case == "tile_edge":  # runs of 3 across every slot tile's edge,
        cnt = np.full(8_192 * 2 + 5, 3)  # rows over two scan tiles' edges
    elif case == "total0":
        cnt = np.zeros(5_000, np.int64)
    elif case == "n0":
        cnt = np.zeros(0, np.int64)
    else:
        cnt = rng.integers(0, 6, 50_007)
    pos0 = (rng.integers(0, nb - 5_001, len(cnt)) if len(cnt)
            else np.zeros(0, np.int64))
    total = int(cnt.sum())
    cap = {"over_cap": total // 3, "cap_exact": total}.get(
        case, total + 1_027)
    return cnt, pos0, nb, max(cap, 0 if case == "n0" else 1), left


@pytest.mark.parametrize("ids", ["int32", "int64"])
@pytest.mark.parametrize("case", ["hot_key", "hot_key_left", "tile_edge",
                                  "total0", "n0", "over_cap", "cap_exact",
                                  "maps16"])
def test_join_expand_edges_match_plain(dev, case, ids):
    """K5b bit for bit against its plain version: a hot key over several
    slot tiles, runs across tile edges, no slots filled, no probe rows,
    the total over the capacity and equal to it, both row-id types, and
    16 maps (int64 and bool, probe and build side)."""
    from tidb_tpu_torch.ops.kernels import join_expand
    rng = np.random.default_rng(34)
    cnt, pos0, nb, cap, left = _expand_case(case, rng)
    n = len(cnt)
    a1 = _up(rng.permutation(nb).astype(ids), dev)
    pvalid = _up(rng.random(n) < 0.9, dev)
    bvalid = _up(rng.random(nb) < 0.9, dev)
    pm, bm = [], []
    if case == "maps16":
        pm = [_up(rng.integers(0, 10**9, n), dev) for _ in range(5)]
        pm += [_up(rng.random(n) < 0.3, dev) for _ in range(4)]
        bm = [_up(rng.integers(0, 10**9, nb), dev) for _ in range(4)]
        bm += [_up(rng.random(nb) < 0.3, dev) for _ in range(3)]
    elif n:
        pm = [_up(rng.integers(0, 10**6, n), dev)]
        bm = [_up(rng.random(nb) < 0.5, dev)]
    args = (_up(cnt, dev), _up(pos0, dev), pvalid, a1, nb, bvalid, cap)
    got = join_expand.expand(*args, left=left, probe_maps=pm, build_maps=bm)
    want = join_expand.expand_plain(*args, left, pm, bm)
    _same(got, want, case)
    if case == "over_cap":
        assert int(got["total"]) > cap
    if case == "cap_exact":
        assert int(got["total"]) == cap


@pytest.mark.parametrize("density", [0.0, 0.003, 0.5, 1.0])
def test_compact_and_count_match_plain(dev, density):
    """compact over sparse masks (a slot tile then covers more rows than
    it stages: the offsets are searched in device memory), a dense one,
    none and all kept; count in one launch."""
    from tidb_tpu_torch.ops.kernels import join_expand
    rng = np.random.default_rng(35)
    n = 700_001
    mask = _up(rng.random(n) < density, dev)
    maps = [_up(rng.integers(0, 10**6, n), dev), _up(rng.random(n) < 0.5,
                                                     dev)]
    kept = int(mask.sum())
    for cap in (max(kept, 1), kept + 3, 1 << 20):
        got = join_expand.compact(mask, cap, maps)
        want = join_expand.expand_plain(None, None, None, None, 0, None,
                                        cap, probe_maps=maps, cmask=mask)
        _same(got, want, f"compact {density} {cap}")
    assert int(join_expand.count(mask)) == kept


def test_expand_and_count_launch_counts(dev):
    """An expansion launches 2 kernels, a count 1 (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from tidb_tpu_torch.ops.kernels import join_expand
    rng = np.random.default_rng(36)
    n, nb = 100_000, 50_000
    cnt = _up(rng.integers(0, 4, n), dev)
    pos0 = _up(rng.integers(0, nb - 4, n), dev)
    a1 = _up(np.arange(nb), dev)
    mask = _up(rng.random(n) < 0.5, dev)
    for call, want in ((lambda: join_expand.expand(
            cnt, pos0, None, a1, nb, None, 1 << 18), 2),
            (lambda: join_expand.count(mask), 1)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.name.startswith("je_")]
        assert len(kernels) == want, [e.name for e in kernels]


# -- another card: each kernel from a thread whose device is card 0 ----------
# (these need two or more cards and skip with fewer)

@pytest.fixture()
def last_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    torch.cuda.set_device(0)
    yield torch.device("cuda", torch.cuda.device_count() - 1)
    # a launch on another card sets the thread's device back
    assert torch.cuda.current_device() == 0


ON_LAST_CARD = {
    "expr_vm": (test_expr_vm_matches_interpreter, {}),
    "groupby_hash": (test_groupby_matches_plain, {"pack": None}),
    "groupby_buckets": (test_groupby_matches_plain,
                        {"pack": ((3, 0), (2, 0))}),
    "sort_topk": (test_topk_matches_plain,
                  {"case": "two-keys", "cap": (1 << 16)}),
    "join_probe_sorted": (test_join_probe_matches_plain,
                          {"layout": "sorted", "mode": "count",
                           "kind": "inner"}),
    "join_probe_dense": (test_join_probe_matches_plain,
                         {"layout": "dense", "mode": "uniq",
                          "kind": "left"}),
    "key_range": (test_key_range_matches_plain, {}),
    "vm_finish": (test_vm_finish_matches_plain,
                  {"kind": "left", "with_pvalid": True}),
    "join_match_uniq": (test_join_match_matches_plain,
                        {"case": "unique-dense"}),
    "join_match_rank": (test_join_match_matches_plain, {"case": "nulls"}),
    "join_expand": (test_join_expand_matches_plain, {"case": "inner"}),
    "merge_states": (test_merge_states_matches_plain,
                     {"pack": None, "merge_cap": 1 << 9}),
    "window_scan": (test_window_scan_matches_plain, {"ordered": True}),
    "radix_exchange": (test_radix_exchange_matches_plain,
                       {"n_dest": 8, "cap": 1 << 16, "hot": False}),
    "shuffle_join": (test_shuffle_join_matches_plain, {"case": "float64"}),
    "dist_steps": (test_dist_steps_on_the_card_match_the_cpu, {}),
}


@pytest.mark.parametrize("case", list(ON_LAST_CARD))
def test_kernel_on_the_last_card_matches_plain(last_card, case):
    """The case's kernel on tensors of the last card, called from a
    thread whose device is card 0, equals its plain version (the
    tolerances of the case itself)."""
    fn, kw = ON_LAST_CARD[case]
    fn(last_card, **kw)


def test_wrappers_refuse_tensors_on_two_cards(last_card):
    from tidb_tpu_torch.ops.kernels import (join_expand, join_match,
                                            radix_exchange, shuffle_join)
    a = torch.arange(8, device="cuda:0")
    b = torch.arange(8, device=last_card)
    m = torch.ones(8, dtype=torch.bool, device=last_card)
    with pytest.raises(ValueError):
        groupby_agg.groupby_agg((a,), (m.to("cuda:0"),), (b,), (m,), m, 1,
                                ("sum_i",), 8)
    with pytest.raises(ValueError):
        sort_topk.sort_indices([a, b], [m, m], [False] * 2, [False] * 2,
                               8, 8, 8)
    prog = expr_vm.Program.build([expr_vm.load(0, "i")], [], [])
    with pytest.raises(ValueError):
        expr_vm.run(prog, [(m, m)], 8, 8, last_card,
                    finish=(m.to("cuda:0"), "inner"))
    with pytest.raises(ValueError):
        join_match.match(a, m.to("cuda:0"), b, m)
    with pytest.raises(ValueError):
        join_expand.compact(m, 8, maps=[a])
    h, ok = radix_exchange.dest_hash([b], "single")
    with pytest.raises(ValueError):
        radix_exchange.partition(h, ok, 2, 4, 8, [a])
    with pytest.raises(ValueError):
        shuffle_join.join_sum(b, None, a, b, b)


def test_split_mesh_across_cards_matches_the_cpu():
    """K11's steps on a split mesh of every card (one shard a card,
    exchanges between cards) equal the local mesh's on the CPU (the plain
    versions), with launches on each card: integers exact, doubles within
    rtol 1e-9 / atol 1e-12 (K1's float sums add in another order)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from tidb_tpu_torch.ops.kernels import build
    from tidb_tpu_torch.parallel import mpp
    n = torch.cuda.device_count()
    rng = np.random.default_rng(4)
    rows = 200_000
    keys, vals = rng.integers(0, 5000, rows), rng.integers(-99, 99, rows)
    fvals = rng.standard_normal(rows)
    valid = rng.random(rows) < 0.9
    got = []
    build.CARD_LAUNCHES.clear()
    for m in (mpp.make_mesh(devices=[f"cuda:{i}" for i in range(n)]),
              mpp.make_mesh(n, device="cpu")):
        (k, v, s, f), _pad = mpp.shard_batch(m, keys, valid, vals, fvals)
        agg = mpp.dist_agg_step(m, ("sum", "min", "sum"), 8192)(k, v, s, s,
                                                                f)
        join = mpp.dist_join_agg_step(m, 4096)(k, f, v, k, s, v)
        got.append([a.cpu() if isinstance(a, torch.Tensor) else
                    tuple(x.cpu() for x in a) for a in agg]
                   + [x.cpu() for x in join])
    assert {c for (_f, c) in build.CARD_LAUNCHES} == set(range(n))
    (a, b) = got
    ng = int(a[3])
    assert ng == int(b[3]) and not bool(a[4])
    assert torch.equal(a[0][:ng], b[0][:ng])
    for x, y in list(zip(a[1], b[1])) + list(zip(a[5:], b[5:])):
        x, y = x.reshape(-1)[:ng], y.reshape(-1)[:ng]
        assert x.dtype == y.dtype
        if x.dtype == torch.float64:
            assert torch.allclose(x, y, rtol=1e-9, atol=1e-12)
        else:
            assert torch.equal(x, y)


# -- the device-failure path: a hang and a sticky error, each in a child ----

@pytest.mark.parametrize("case", ["hang", "sticky"])
def test_device_fault_in_a_child_process(dev, case):
    """``chip_smoke.py --fault-child``: the TPC-H tables at
    ``FAULT_CHILD_SF`` in a child process, Q1 on the card, then
    ``hang`` — a kernel that never ends, Q1 under a 1 s deadline fails
    9008, and the next two statements each return the host engine's rows
    within the fence's bound plus 5 s, with the device lost — or
    ``sticky`` — a device-side assert, then Q1, Q3 and a LEFT JOIN with
    an ON residual each return the host engine's rows, with the device
    lost and no card launch after the loss.  The child's hung card or
    broken context dies with it."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen(
        [sys.executable, os.path.join(root, "chip_smoke.py"),
         "--fault-child", case], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out = p.communicate(timeout=120)[0]
    except subprocess.TimeoutExpired:
        p.kill()
        out = p.communicate()[0]
        pytest.fail(f"the child ran past 120 s:\n{out[-6000:]}")
    assert p.returncode == 0, out[-6000:]
    assert f"[faults] case {case} ok" in out, out[-6000:]
    assert "device lost (" in out
