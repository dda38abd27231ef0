"""The port's window path (``device_window``: K2 → K4 → K10) against the
JAX reference on the CPU, and the host window shuffle.

SQL, in both packages on the device engine (the port on its kernels'
plain versions, the reference on JAX's CPU backend):

* every case of tests/test_device_window.py on its table (seed 31),
  including the two that must still decline (ntile, an explicit frame);
* seeded random tables (numpy seeds) with NULL partition and order keys,
  DESC int / decimal / double keys with ties, ``-0.0`` and ``0.0`` as
  peers, string partition keys, a row count that is not a bucket size,
  ``COUNT(*) OVER ()``, an all-NULL partition under SUM/MIN/MAX, DATE
  MIN/MAX, DECIMAL AVG rounding and float sums across partitions of very
  different magnitude.

Rows compare by tests/test_device_ops.py's ``_rows_equal``: ints,
decimals, dates and strings exact, doubles within rtol 1e-9 / atol 1e-12
(float running sums add in another order on each side).  Every case
shows that the port's device window ran: a spy saw ``device_window``
return and EXPLAIN ANALYZE shows ``engine:tpu`` on every Window.

Beside SQL: ``device_window``'s output columns on one chunk against the
reference's on the same chunk; K10's plain version against a numpy loop
over partitions (ints exact, floats rtol 1e-9); K4's window order
against the reference's ``np.lexsort`` key list (exact); and the host
shuffle (``executor/shuffle.py``) against the reference.
"""

import numpy as np
import pytest
import torch

from test_device_ops import _rows_equal
from tidb_tpu.executor import device_exec as rexec
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch.executor import device_exec as pexec
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops.kernels import sort_topk, window_scan
from tidb_tpu_torch.testkit import TestKit as PortKit


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _w_rows():
    """tests/test_device_window.py's table `w`, drawn as it draws it."""
    rng = np.random.default_rng(31)
    rows = []
    for i in range(4000):
        null_v = rng.random() < 0.05
        rows.append(
            f"({int(rng.integers(0, 23))}, 'c{i % 5}', "
            f"{'null' if null_v else int(rng.integers(-50, 500))}, "
            f"{int(rng.integers(0, 90000)) / 100:.2f}, "
            f"{float(rng.uniform(-5, 5)):.4f})")
    return rows


#: rows of the random tables (not a bucket size: buckets go 724, 1024)
N_RANDOM = 1000
SEEDS = (3, 17, 29)


def _random_rows(seed):
    """Table `r<seed>`: id, int partition key g (NULLs; g = 7 has only NULL
    v), string s (NULLs), int order key k with ties (NULLs), decimal p
    with ties and negatives (NULLs), double f with ties and zeros (NULLs),
    date d (NULLs), bigint v (NULLs), double w of very different magnitude
    per partition."""
    rng = np.random.default_rng(seed)
    n = N_RANDOM

    def maybe(vals, p):
        return [("null" if rng.random() < p else x) for x in vals]

    g = maybe([str(x) for x in rng.integers(0, 9, n)], 0.1)
    s = maybe([f"'{c}'" for c in rng.choice(list("abcd"), n)], 0.05)
    k = maybe([str(x) for x in rng.integers(-5, 6, n)], 0.1)
    p = maybe([f"{x / 100:.2f}" for x in rng.integers(-300, 300, n) // 7 * 7],
              0.05)
    f = maybe([repr(float(x)) for x in rng.choice(
        [-1.5, 0.0, 0.0, 2.25, 3.0, 1e-3], n)], 0.05)
    d = maybe([f"'19{90 + x // 12:02d}-{x % 12 + 1:02d}-15'"
               for x in rng.integers(0, 96, n)], 0.1)
    v = maybe([str(x) for x in rng.integers(-1000, 1000, n)], 0.1)
    w = [repr(float(1e15 + x) if gi == "0" else float(x) * 1e-3)
         for gi, x in zip(g, rng.integers(-10**6, 10**6, n))]
    v = ["null" if gi == "7" else vi for gi, vi in zip(g, v)]
    return [f"({i}, {g[i]}, {s[i]}, {k[i]}, {p[i]}, {f[i]}, {d[i]}, "
            f"{v[i]}, {w[i]})" for i in range(n)]


@pytest.fixture(scope="module")
def kits():
    """The same tables in the reference's TestKit and the port's."""
    w_rows = _w_rows()
    kits = (RefKit(), PortKit())
    for tk in kits:
        tk.must_exec("use test")
        tk.must_exec("create table w (g bigint, s varchar(8), v bigint, "
                     "p decimal(10,2), f double)")
        for lo in range(0, len(w_rows), 2000):
            tk.must_exec("insert into w values "
                         + ",".join(w_rows[lo:lo + 2000]))
        tk.must_exec("create table wp (g bigint, k bigint, v bigint)")
        tk.must_exec("insert into wp values (1,1,10),(1,1,20),(1,2,30),"
                     "(1,2,40),(1,3,50)")
        tk.must_exec("create table wd (g bigint, d date)")
        tk.must_exec("insert into wd values (1, '2024-01-01'),(1, null),"
                     "(1, '2024-03-05'),(2, null),(2, '1999-09-09')")
        tk.must_exec("create table wn (a bigint, b bigint, v bigint)")
        tk.must_exec("insert into wn values (null, 1, 10),(null, 2, 20),"
                     "(null, 3, 30),(1, 1, 40),(1, 2, 50)")
        for seed in SEEDS:
            tk.must_exec(f"create table r{seed} (id int, g int, "
                         "s varchar(4), k bigint, p decimal(10,2), "
                         "f double, d date, v bigint, w double)")
            tk.must_exec(f"insert into r{seed} values "
                         + ",".join(_random_rows(seed)))
    return kits


class _Spy:
    """Counts the calls of a package's ``device_window`` that returned."""

    def __init__(self, mod):
        self.mod, self.calls, self.io = mod, 0, []

    def __enter__(self):
        orig = self.orig = self.mod.device_window

        def spy(p, chunk, ctx=None):
            out = orig(p, chunk, ctx)
            self.calls += 1
            self.io.append((chunk, out))
            return out
        self.mod.device_window = spy
        return self

    def __exit__(self, *exc):
        self.mod.device_window = self.orig


def _windows_on_device(tk, sql):
    rows = tk.must_query("explain analyze " + sql).rows
    lines = [" ".join(map(str, r)) for r in rows
             if "Window" in str(r[0])]
    assert lines, rows
    return all("engine:tpu" in ln for ln in lines)


def _both(kits, sql, expect_device=True):
    """`sql` on both device engines: equal rows; the port's device window
    ran (or, where the reference declines too, did not)."""
    ref, port = kits
    for tk in kits:
        tk.must_exec("set tidb_executor_engine = 'tpu'")
    with _Spy(rexec) as rspy:
        want = ref.must_query(sql).rows
    with _Spy(pexec) as pspy:
        got = port.must_query(sql).rows
    assert _rows_equal(got, want), f"port != reference: {sql}"
    if expect_device:
        assert rspy.calls and pspy.calls, "device window did not run"
        assert _windows_on_device(port, sql)
    else:
        assert not rspy.calls and not pspy.calls
        assert not _windows_on_device(port, sql)
    return got


# -- tests/test_device_window.py's cases --------------------------------------

REF_CASES = [
    ("row_number_rank_dense",
     "select g, v, row_number() over (partition by g order by v), "
     "rank() over (partition by g order by v), "
     "dense_rank() over (partition by g order by v) "
     "from w order by g, v, 1, 3"),
    ("desc_order_and_string_partition",
     "select s, v, row_number() over (partition by s order by "
     "v desc, g) from w order by s, v desc, g, 3"),
    ("running_sum_count_avg",
     "select g, v, sum(v) over (partition by g order by v), "
     "count(v) over (partition by g order by v), "
     "avg(p) over (partition by g order by v) "
     "from w order by g, v, 3"),
    ("partition_total_no_order",
     "select g, sum(p) over (partition by g), "
     "min(v) over (partition by g), max(f) over (partition by g), "
     "count(*) over (partition by g) from w order by g, 2, 3, 4"),
    ("percent_rank_cume_dist",
     "select g, v, percent_rank() over (partition by g order by v), "
     "cume_dist() over (partition by g order by v) "
     "from w order by g, v, 3"),
    ("global_window_no_partition",
     "select v, row_number() over (order by v, g) from w "
     "order by v, g"),
    ("null_computed_partition_key",
     "select v, count(*) over (partition by a + b) from wn order by v"),
]


@pytest.mark.parametrize("sql", [c[1] for c in REF_CASES],
                         ids=[c[0] for c in REF_CASES])
def test_reference_cases(kits, sql):
    _both(kits, sql)


def test_peer_aware_running_frame(kits):
    rows = _both(kits, "select k, sum(v) over (partition by g order by k) "
                       "from wp order by k, 2")
    assert rows == [("1", "30"), ("1", "30"), ("2", "100"), ("2", "100"),
                    ("3", "150")]


def test_min_max_date_with_nulls(kits):
    rows = _both(kits, "select g, min(d) over (partition by g), "
                       "max(d) over (partition by g) from wd order by g, 2")
    assert rows[0][1] == "2024-01-01" and rows[0][2] == "2024-03-05"
    assert rows[-1][1] == "1999-09-09"


def test_null_partition_is_one_group(kits):
    rows = _both(kits, "select v, count(*) over (partition by a + b) "
                       "from wn order by v")
    assert rows[0][1] == rows[1][1] == rows[2][1] == "3"


@pytest.mark.parametrize("sql", [
    "select g, ntile(3) over (partition by g order by v) from w "
    "order by g, v, 2",
    "select g, sum(v) over (partition by g order by v rows between 1 "
    "preceding and current row) from w order by g, v, 2",
], ids=["ntile", "explicit_frame"])
def test_declined_on_both(kits, sql):
    _both(kits, sql, expect_device=False)


def test_more_keys_than_the_sort_takes_runs_on_host(kits):
    """17 partition + order keys: past K4's limit the port declines (the
    host engine runs the query); the reference runs it on its device."""
    keys = ", ".join(["g"] * 9)
    order = ", ".join(["v"] * 8)
    sql = (f"select g, v, rank() over (partition by {keys} order by "
           f"{order}) from w order by g, v, 3")
    ref, port = kits
    for tk in kits:
        tk.must_exec("set tidb_executor_engine = 'tpu'")
    with _Spy(pexec) as pspy:
        got = port.must_query(sql).rows
    assert _rows_equal(got, ref.must_query(sql).rows)
    assert not pspy.calls and not _windows_on_device(port, sql)


# -- seeded random cases --------------------------------------------------------

RANDOM_CASES = [
    ("null_keys_running",
     "select id, row_number() over (partition by g order by k), "
     "rank() over (partition by g order by k), "
     "dense_rank() over (partition by g order by k), "
     "sum(v) over (partition by g order by k), "
     "count(v) over (partition by g order by k) from {t} order by id"),
    ("desc_int_decimal_double_ties",
     "select id, rank() over (partition by s order by k desc, p desc), "
     "dense_rank() over (order by f desc), "
     "percent_rank() over (partition by g order by p desc), "
     "cume_dist() over (partition by g order by f desc, k) "
     "from {t} order by id"),
    ("signed_zero_peers",
     "select id, rank() over (partition by g order by f * k), "
     "sum(v) over (partition by g order by f * k), "
     "count(*) over (partition by g order by f * k desc) "
     "from {t} order by id"),
    ("string_partition_keys",
     "select id, row_number() over (partition by s, g order by id), "
     "max(p) over (partition by s), "
     "min(k) over (partition by s order by id desc) from {t} order by id"),
    ("count_star_over_all",
     "select id, count(*) over (), sum(p) over (), max(f) over () "
     "from {t} order by id"),
    ("all_null_partition",
     "select id, sum(v) over (partition by g), min(v) over (partition by g), "
     "max(v) over (partition by g order by k), avg(v) over (partition by g) "
     "from {t} order by id"),
    ("date_min_max",
     "select id, min(d) over (partition by g), "
     "max(d) over (partition by s order by k) from {t} order by id"),
    ("decimal_avg_rounding",
     "select id, avg(p) over (partition by g order by k), "
     "avg(p) over (partition by s), avg(k) over (partition by g) "
     "from {t} order by id"),
    ("float_sum_per_partition",
     "select id, sum(w) over (partition by g order by id), "
     "avg(w) over (partition by g), min(w) over (partition by g order by k) "
     "from {t} order by id"),
]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sql", [c[1] for c in RANDOM_CASES],
                         ids=[c[0] for c in RANDOM_CASES])
def test_random_cases(kits, sql, seed):
    assert tdev.bucket_rows(N_RANDOM) != N_RANDOM
    rows = _both(kits, sql.format(t=f"r{seed}"))
    assert len(rows) == N_RANDOM


def test_all_null_partition_is_null(kits):
    rows = _both(kits, f"select g, sum(v) over (partition by g), "
                       f"min(v) over (partition by g), max(v) over "
                       f"(partition by g) from r{SEEDS[0]} where g = 7 "
                       f"limit 1")
    assert rows and rows[0][1:] == (None, None, None)


def test_device_window_outputs_match_reference(kits):
    """``device_window``'s output columns on one chunk equal the
    reference's on the same chunk: NULL flags exact, values exact where
    not NULL (doubles within rtol 1e-9 / atol 1e-12)."""
    sql = ("select id, g, rank() over (partition by g order by p desc, k), "
           "percent_rank() over (partition by g order by p desc, k), "
           "sum(w) over (partition by g order by p desc, k), "
           "min(d) over (partition by g order by p desc, k), "
           "avg(p) over (partition by g order by p desc, k) "
           f"from r{SEEDS[1]}")
    ref, port = kits
    for tk in kits:
        tk.must_exec("set tidb_executor_engine = 'tpu'")
    with _Spy(rexec) as rspy:
        ref.must_query(sql)
    with _Spy(pexec) as pspy:
        port.must_query(sql)
    assert len(rspy.io) == len(pspy.io) == 1
    (rin, rout), = rspy.io
    (pin, pout), = pspy.io
    assert rin.num_rows == pin.num_rows == N_RANDOM
    for rc, pc in zip(rin.columns, pin.columns):
        assert np.array_equal(rc.nulls, pc.nulls)
        live = ~np.asarray(rc.nulls)
        assert np.array_equal(np.asarray(rc.data)[live],
                              np.asarray(pc.data)[live])
    assert len(rout.columns) == len(pout.columns) == len(rin.columns) + 5
    for rc, pc in zip(rout.columns[len(rin.columns):],
                      pout.columns[len(pin.columns):]):
        rn, pn = np.asarray(rc.nulls), np.asarray(pc.nulls)
        assert np.array_equal(rn, pn)
        rd, pd = np.asarray(rc.data)[~rn], np.asarray(pc.data)[~pn]
        assert rd.dtype == pd.dtype
        if rd.dtype.kind == "f":
            np.testing.assert_allclose(pd, rd, rtol=1e-9, atol=1e-12)
        else:
            assert np.array_equal(pd, rd)


# -- K10 and K4 units -----------------------------------------------------------

def _lexsort_order(keys, descs, nb, n_live):
    """The reference's window order (tidb_tpu/executor/device_exec.py:1569
    lexsort key list), in numpy."""
    lex = []
    for (d, nl), desc in reversed(list(zip(keys, descs))):
        if d.dtype.kind == "f":
            v = -d if desc else d
        else:
            v = ~d if desc else d
        lex.append(np.where(nl, 0, v))
        lex.append(np.where(nl, 1 if desc else 0, 0 if desc else 1))
    lex.append(~(np.arange(nb) < n_live))
    return np.lexsort(lex)


def _rand_case(seed, nb, n_live):
    rng = np.random.default_rng(seed)

    def col(kind, lo, hi, p_null):
        if kind == "f":
            d = rng.choice([-2.5, -0.0, 0.0, 1.0, 7.25], nb) * rng.integers(
                lo, hi, nb)
        else:
            d = rng.integers(lo, hi, nb).astype(np.int64)
        return d, rng.random(nb) < p_null

    part = [col("i", 0, 6, 0.1), col("f", 0, 2, 0.05)]
    order = [col("i", -3, 4, 0.1), col("f", 1, 3, 0.1)]
    descs = [False, False, True, False]
    args = [col("i", -10**15, 10**15, 0.2), col("f", -1000, 1000, 0.2),
            (np.full(nb, 5, np.int64), np.ones(nb, bool))]
    idx = _lexsort_order(part + order, descs, nb, n_live)
    return part, order, descs, args, idx


def _numpy_window(nb, n_live, idx, part, order, args, funcs):
    """K10's contract by a loop over partitions in sorted order: the
    frame of sorted row j is [partition start, end of j's peer group]."""
    def masked(cols, j):
        return tuple((bool(nl[idx[j]]),
                      0 if nl[idx[j]] else d[idx[j]]) for d, nl in cols)

    starts = [j for j in range(nb) if j == 0 or j == n_live
              or masked(part, j) != masked(part, j - 1)]
    bounds = starts + [nb]
    outs = [(np.zeros(nb, dtype=np.float64 if name in (
        "percent_rank", "cume_dist") or (a is not None and name != "count"
                                         and args[a][0].dtype.kind == "f")
        else np.int64), np.zeros(nb, bool)) for name, a in funcs]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        m = hi - lo
        peer_start = [j for j in range(lo, hi) if j == lo or (
            order and masked(order, j) != masked(order, j - 1))]
        pstarts = peer_start + [hi]
        for ps, pe_ in zip(pstarts[:-1], pstarts[1:]):
            for j in range(ps, pe_):
                end = pe_ - 1 if order else hi - 1
                r = idx[j]
                for (name, a), (od, on) in zip(funcs, outs):
                    if name == "row_number":
                        od[r] = j - lo + 1
                    elif name == "rank":
                        od[r] = ps - lo + 1
                    elif name == "dense_rank":
                        od[r] = peer_start.index(ps) + 1
                    elif name == "percent_rank":
                        od[r] = (ps - lo) / (m - 1) if m > 1 else 0.0
                    elif name == "cume_dist":
                        od[r] = (end - lo + 1) / m
                    else:
                        d, nl = args[a]
                        rows = idx[lo:end + 1]
                        vals = d[rows][~nl[rows]]
                        if name == "count":
                            od[r] = len(vals)
                        elif len(vals) == 0:
                            on[r] = True
                        elif name == "sum":
                            od[r] = (vals.sum() if vals.dtype.kind == "f"
                                     else int(sum(int(x) for x in vals)))
                        else:
                            od[r] = vals.min() if name == "min" else vals.max()
    return outs


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_k10_plain_matches_a_loop_over_partitions(seed):
    """K10's plain version against a numpy loop: ints exact, floats
    within rtol 1e-9 / atol 1e-12 (sums in another order); padding rows
    (at and past n_live) form their own partition."""
    nb, n_live = 300, 271
    part, order, descs, args, idx = _rand_case(seed, nb, n_live)
    funcs = [("row_number", None), ("rank", None), ("dense_rank", None),
             ("percent_rank", None), ("cume_dist", None), ("count", 0),
             ("sum", 0), ("min", 0), ("max", 0), ("sum", 1), ("min", 1),
             ("max", 1), ("count", 2), ("sum", 2), ("min", 2)]

    def t(cols):
        return [(torch.from_numpy(d.copy()), torch.from_numpy(nl.copy()))
                for d, nl in cols]

    cpu = torch.device("cpu")
    got = window_scan.run(nb, n_live, torch.from_numpy(idx), t(part),
                          t(order), t(args), funcs, cpu)
    want = _numpy_window(nb, n_live, idx, part, order, args, funcs)
    for (name, a), (gd, gn), (wd, wn) in zip(funcs, got, want):
        gd, gn = gd.numpy(), gn.numpy()
        assert np.array_equal(gn, wn), name
        if gd.dtype.kind == "f":
            np.testing.assert_allclose(gd[~gn], wd[~wn], rtol=1e-9,
                                       atol=1e-12, err_msg=name)
        else:
            assert np.array_equal(gd[~gn], wd[~wn]), name
    # no ORDER BY: the frame is the whole partition
    funcs = [("row_number", None), ("cume_dist", None), ("sum", 1),
             ("max", 0)]
    idx = _lexsort_order(part, descs[:2], nb, n_live)
    got = window_scan.run(nb, n_live, torch.from_numpy(idx), t(part), [],
                          t(args), funcs, cpu)
    want = _numpy_window(nb, n_live, idx, part, [], args, funcs)
    for (gd, gn), (wd, wn) in zip(got, want):
        assert np.array_equal(gn.numpy(), wn)
        np.testing.assert_allclose(gd.numpy()[~wn], wd[~wn], rtol=1e-9,
                                   atol=1e-12)


def test_k10_float_sum_is_segmented():
    """A float SUM is a segmented scan: a partition of 1e15-sized values
    before a partition of small ones leaves no rounding error in the
    second (a difference of global prefix sums would)."""
    nb = 64
    d = np.where(np.arange(nb) < 32, 1e15 + 0.5, 0.1)
    g = (np.arange(nb) >= 32).astype(np.int64)
    z = np.zeros(nb, bool)
    out, = window_scan.run(
        nb, nb, None, [(torch.from_numpy(g), torch.from_numpy(z))], [],
        [(torch.from_numpy(d), torch.from_numpy(z))], [("sum", 0)],
        torch.device("cpu"))
    total = 0.0
    for _ in range(32):
        total += 0.1
    assert abs(out[0][40].item() - total) <= 1e-12


def test_k4_window_order_is_the_reference_lexsort():
    nb, n_live = 500, 433
    part, order, descs, _args, want = _rand_case(9, nb, n_live)
    keys = part + order
    got = sort_topk.window_order(
        [torch.from_numpy(d) for d, _ in keys],
        [torch.from_numpy(nl) for _, nl in keys], descs, nb, n_live)
    assert np.array_equal(got.numpy(), want)


# -- the host window shuffle ---------------------------------------------------

SHUFFLE_N = 12_000
SHUFFLE_QUERY = ("select dep, emp, sal, "
                 "rank() over (partition by dep order by sal desc), "
                 "sum(sal) over (partition by dep), "
                 "row_number() over (partition by dep order by emp) "
                 "from sw order by dep, emp")


@pytest.fixture(scope="module")
def shuffle_kits():
    """tests/test_shuffle.py's table, and the 20,000-row t(a, b, c)."""
    kits = (RefKit(), PortKit())
    for tk in kits:
        tk.must_exec("use test")
        tk.must_exec("create table sw (dep int, emp int, sal int)")
        rows = [f"({i % 17}, {i}, {(i * 37) % 1000})"
                for i in range(SHUFFLE_N)]
        for lo in range(0, len(rows), 2000):
            tk.must_exec("insert into sw values "
                         + ",".join(rows[lo:lo + 2000]))
        tk.must_exec("create table t (a int, b int, c int)")
        rows = [f"({i % 7}, {i}, {(i * 13) % 101})" for i in range(20_000)]
        for lo in range(0, len(rows), 2000):
            tk.must_exec("insert into t values "
                         + ",".join(rows[lo:lo + 2000]))
        tk.must_exec("set tidb_executor_engine = 'host'")
    return kits


def _explain(tk, sql):
    return "\n".join(" ".join(map(str, r)) for r in
                     tk.must_query("explain analyze " + sql).rows)


def test_shuffle_window_concurrency_four(shuffle_kits):
    sql = ("select a, b, row_number() over (partition by a order by b) "
           "from t order by b limit 3")
    ref, port = shuffle_kits
    for tk in shuffle_kits:
        tk.must_exec("set tidb_window_concurrency = 4")
        tk.must_exec("set tidb_shuffle_min_rows = 8192")
    want = ref.must_query(sql).rows
    assert want == [("0", "0", "1"), ("1", "1", "1"), ("2", "2", "1")]
    assert port.must_query(sql).rows == want
    assert "shuffle:4 workers" in _explain(port, sql)
    assert "shuffle:4 workers" in _explain(ref, sql)


def test_shuffle_parallel_matches_serial(shuffle_kits):
    ref, port = shuffle_kits
    for tk in shuffle_kits:
        tk.must_exec("set tidb_shuffle_min_rows = 0")
        tk.must_exec("set tidb_window_concurrency = 4")
    par = port.must_query(SHUFFLE_QUERY).rows
    assert par == ref.must_query(SHUFFLE_QUERY).rows
    port.must_exec("set tidb_window_concurrency = 1")
    assert port.must_query(SHUFFLE_QUERY).rows == par
    assert len(par) == SHUFFLE_N


def test_shuffle_explain_analyze_annotates_workers(shuffle_kits):
    for tk in shuffle_kits:
        tk.must_exec("set tidb_shuffle_min_rows = 0")
        tk.must_exec("set tidb_window_concurrency = 3")
        assert "3 workers" in _explain(tk, SHUFFLE_QUERY)


def test_shuffle_small_inputs_skip(shuffle_kits):
    for tk in shuffle_kits:
        tk.must_exec("set tidb_shuffle_min_rows = 8192")
        tk.must_exec("set tidb_window_concurrency = 4")
        tk.must_exec("create table if not exists small (dep int, v int)")
        tk.must_exec("delete from small")
        tk.must_exec("insert into small values (1,1),(1,2),(2,3)")
        assert "workers" not in _explain(
            tk, "select dep, sum(v) over (partition by dep) from small")


def test_shuffle_rows_reassembled_in_input_order():
    from tidb_tpu.executor import shuffle as rshuffle
    from tidb_tpu_torch.executor.shuffle import (shard_by_groups,
                                                 shuffle_execute)
    from tidb_tpu_torch.sqltypes import FieldType, TYPE_LONGLONG
    from tidb_tpu_torch.utils.chunk import Chunk, Column
    ft = FieldType(tp=TYPE_LONGLONG)
    data = np.arange(1000, dtype=np.int64)
    gids = data % 7
    chunk = Chunk([Column(ft, data, np.zeros(1000, dtype=bool))])

    def double(sub):
        return Chunk([Column(ft, sub.columns[0].data * 2,
                             sub.columns[0].nulls)])
    out = shuffle_execute(chunk, gids, 4, double)
    assert (out.columns[0].data == data * 2).all()
    assert np.array_equal(shard_by_groups(gids, 4),
                          rshuffle.shard_by_groups(gids, 4))


def test_shuffle_group_never_splits_across_shards():
    from tidb_tpu.executor.shuffle import shard_by_groups as ref_shards
    from tidb_tpu_torch.executor.shuffle import shard_by_groups
    gids = np.repeat(np.arange(50, dtype=np.int64), 20)
    shards = shard_by_groups(gids, 4)
    assert np.array_equal(shards, ref_shards(gids, 4))
    for g in range(50):
        assert len(set(shards[gids == g])) == 1
