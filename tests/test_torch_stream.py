"""The port's streamed scan-aggregate (K8) against the JAX reference on
the CPU, and its partial-state merge against the reference's
``merge_partial_states``.

SQL (tests/test_device_stream.py's table and cases, in both packages):
20,000 rows streamed in blocks of 3,000 (a 2,000-row tail block), with
grouped and global aggregates, NULLs ignored, a date group key, streamed
COUNT(DISTINCT), and a high-cardinality key whose first capacity is too
small and whose folds grow the merge capacity (the merge budget cut so
that blocks fold every few blocks).  Rows compare by
tests/test_device_ops.py's ``_rows_equal`` (doubles within rtol 1e-9 /
atol 1e-12, everything else exact); every query asserts that the port's
streamed path ran (``LAST_PAGED_STATS`` of kind "stream", at least two
pages), and one EXPLAIN ANALYZE shows ``tpu-stream``.

The merge (ops/kernels/merge_states.py ``merge_plain``, through the
port's ``merge_partial_states``) on seeded partial states against the
reference's: ``key_pack`` set and None, NULL keys, ``first`` across
parts, a group NULL in every part, and ``merge_cap`` growth.  Keys,
NULL flags, integer results and group counts exact; float sums within
rtol 1e-9.
"""

import random
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_device_ops import _rows_equal
from tidb_tpu.executor import device_exec as rexec
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch.executor import device_exec as pexec
from tidb_tpu_torch.executor import device_join as pdj
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops.kernels import merge_states
from tidb_tpu_torch.testkit import TestKit as PortKit

N_ROWS = 20_000
BATCH = 3_000  # forces 7 blocks, the last one 2,000 rows


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


@pytest.fixture(scope="module")
def kits():
    """tests/test_device_stream.py's table `s`, a NULL-bearing table and a
    table with a unique key, in both packages."""
    random.seed(7)
    rows = [f"({i % 13}, 'c{i % 5}', {i % 97}, "
            f"{round(random.random() * 10, 3)}, "
            f"'202{i % 3}-0{i % 9 + 1}-15')" for i in range(N_ROWS)]
    rng = np.random.default_rng(5)
    ids = rng.permutation(N_ROWS)
    vals = rng.integers(-1000, 1000, N_ROWS)
    kits = (RefKit(), PortKit())
    for tk in kits:
        tk.must_exec("use test")
        tk.must_exec("create table s (grp int, cat varchar(8), amount int, "
                     "price double, d date)")
        for lo in range(0, N_ROWS, 2000):
            tk.must_exec("insert into s values "
                         + ",".join(rows[lo:lo + 2000]))
        tk.must_exec("create table cdn (g bigint, v bigint)")
        tk.must_exec("insert into cdn values (1,1),(1,null),(1,1),(1,2),"
                     "(2,null),(2,null)")
        tk.must_exec("create table u (id bigint, v bigint)")
        for lo in range(0, N_ROWS, 4000):
            tk.must_exec("insert into u values " + ",".join(
                f"({ids[i]}, {vals[i]})" for i in range(lo, lo + 4000)))
    return kits


def _stream(kits, sql, batch=BATCH):
    """`sql` on both device engines streamed in `batch`-row blocks: equal
    rows, and the port's streamed path ran."""
    ref, port = kits
    for tk in kits:
        tk.must_exec("set tidb_executor_engine = 'tpu'")
        tk.must_exec(f"set tidb_device_stream_rows = {batch}")
    try:
        want = ref.must_query(sql).rows
        got = port.must_query(sql).rows
        stats = dict(pdj.LAST_PAGED_STATS.items())
    finally:
        for tk in kits:
            tk.must_exec("set tidb_device_stream_rows = 0")
    assert _rows_equal(got, want), f"port != reference:\n{got}\n{want}"
    assert stats.get("kind") == "stream" and stats["pages"] >= 2, stats
    return got, stats


QUERY = ("select grp, cat, count(*), sum(amount), min(amount), max(amount), "
         "avg(price) from s where amount > 10 group by grp, cat "
         "order by grp, cat")

SQL_CASES = [
    ("grouped", QUERY),
    ("global", "select count(*), sum(amount), min(price), max(d) from s"),
    ("date_key", "select d, count(*) from s group by d order by d"),
    ("tail_block", "select grp, count(*), sum(price) from s group by grp "
     "order by grp"),
    ("count_distinct_grouped", "select grp, count(distinct amount) from s "
     "group by grp order by grp"),
    ("count_distinct_global", "select count(distinct amount) from s"),
    ("first_row", "select cat, amount from s where grp = 3 group by cat "
     "order by cat"),
]


@pytest.mark.parametrize("sql", [c[1] for c in SQL_CASES],
                         ids=[c[0] for c in SQL_CASES])
def test_streamed_agg_matches_reference(kits, sql):
    assert N_ROWS % BATCH != 0  # the tail block is shorter
    got, _st = _stream(kits, sql)
    assert len(got) > 0


@pytest.mark.parametrize("sql,want", [
    ("select g, count(distinct v) from cdn group by g order by g",
     [("1", "2"), ("2", "0")]),
    ("select g, count(v), sum(v), min(v) from cdn group by g order by g",
     [("1", "3", "4", "1"), ("2", "0", None, None)]),
], ids=["count_distinct", "count_sum_min"])
def test_streamed_agg_ignores_nulls(kits, sql, want):
    got, _st = _stream(kits, sql, batch=2)
    assert got == want


def test_stream_fragment_annotated(kits):
    port = kits[1]
    port.must_exec("set tidb_executor_engine = 'tpu'")
    port.must_exec(f"set tidb_device_stream_rows = {BATCH}")
    try:
        txt = "\n".join(" ".join(map(str, r)) for r in
                        port.must_query("explain analyze " + QUERY).rows)
    finally:
        port.must_exec("set tidb_device_stream_rows = 0")
    assert "tpu-stream" in txt


def test_capacity_restart_and_merge_growth(kits, monkeypatch):
    """A unique key: each block's groups overflow the estimated capacity
    (the pass restarts at the observed size), and with the merge budget
    cut to two blocks the folds grow the merge capacity past the
    capacity — in both packages."""
    monkeypatch.setattr(rexec, "_MERGE_BUDGET_ROWS", 8192)
    monkeypatch.setattr(pexec, "_MERGE_BUDGET_ROWS", 8192)
    got, st = _stream(kits, "select id, sum(v), count(*) from u group by id "
                            "order by sum(v) desc, id limit 20")
    assert len(got) == 20
    assert st["groups"] == N_ROWS and st["capacity"] == 4096
    assert st["merges"] >= 3 and st["pages"] > N_ROWS // BATCH + 1


# -- the merge on seeded partial states ----------------------------------------

MERGE_OPS = ("sum_i", "sum_f", "min", "max", "first", "sum_i")


def _states(seed, n_parts, pack, null_keys):
    """Seeded partial states in K1's layout, as numpy: every part holds a
    run of distinct group keys (two key columns, some NULL), results of
    each merge op with NULL flags, and garbage past its n_groups."""
    rng = np.random.default_rng(seed)
    parts = []
    for p in range(n_parts):
        cap = int(2 ** rng.integers(4, 8))
        ng = int(rng.integers(0, cap + 1)) if p else cap // 2
        # keys 0-38; 39 is the all-NULL group's below
        k0 = rng.choice(39, ng, replace=False) if ng <= 39 else \
            rng.integers(0, 39, ng)
        k1 = rng.integers(0, 3, ng)
        kn0 = rng.random(ng) < (0.1 if null_keys else 0.0)
        kn1 = np.zeros(ng, dtype=bool)
        # distinct (k0, k1) per part, NULL keys collapsed to one group
        key = np.where(kn0, -1, k0) * 4 + k1
        _u, first = np.unique(key, return_index=True)
        keep = np.sort(first)
        ng = len(keep)
        k0, k1, kn0, kn1 = k0[keep], k1[keep], kn0[keep], kn1[keep]
        k0 = np.where(kn0, 0, k0)
        res = [rng.integers(-10**12, 10**12, ng),
               rng.standard_normal(ng) * 1e6,
               rng.integers(-10**6, 10**6, ng),
               rng.standard_normal(ng),
               rng.integers(0, 10**9, ng),
               rng.integers(1, 100, ng)]
        rnul = [rng.random(ng) < 0.3 for _ in MERGE_OPS]
        rnul[-1][:] = False  # a count's partials are never NULL
        # one group NULL in every part that holds it: key (39, 2)
        if p % 2 == 0:
            k0 = np.append(k0, 39)
            k1 = np.append(k1, 2)
            kn0 = np.append(kn0, False)
            kn1 = np.append(kn1, False)
            res = [np.append(r, r[:1] if len(r) else [0]).astype(r.dtype)
                   for r in res]
            rnul = [np.append(r, True) for r in rnul]
            rnul[-1][-1] = False
            ng += 1
            cap = max(cap, ng)

        def pad(a, fill):
            out = np.full(cap, fill, dtype=a.dtype)
            out[:len(a)] = a
            return out
        parts.append((
            (pad(k0.astype(np.int64), 7), pad(k1.astype(np.int64), 7)),
            (pad(kn0, True), pad(kn1, False)),
            tuple(pad(r, r.dtype.type(5)) for r in res),
            tuple(pad(r, False) for r in rnul),
            ng, np.arange(cap) < ng))
    return parts


def _to_ref(part):
    keys, knulls, res, rnul, ng, valid = part
    return (tuple(jnp.asarray(a) for a in keys),
            tuple(jnp.asarray(a) for a in knulls),
            tuple(jnp.asarray(a) for a in res),
            tuple(jnp.asarray(a) for a in rnul),
            jnp.asarray(np.int64(ng)), jnp.asarray(valid))


def _to_port(part):
    keys, knulls, res, rnul, ng, valid = part
    t = torch.from_numpy
    return (tuple(t(a) for a in keys), tuple(t(a) for a in knulls),
            tuple(t(a) for a in res), tuple(t(a) for a in rnul),
            torch.tensor(ng, dtype=torch.int64), t(valid))


@pytest.mark.parametrize("pack", [((7, 0), (3, 0)), None],
                         ids=["key_pack", "no_pack"])
@pytest.mark.parametrize("merge_cap", [16, 256], ids=["growth", "fits"])
@pytest.mark.parametrize("running", [False, True],
                         ids=["blocks", "running_state"])
def test_merge_matches_reference(pack, merge_cap, running):
    parts = _states(11 + merge_cap, 6, pack, null_keys=True)
    state = parts[0] if running else None
    rest = parts[1:] if running else parts
    want, want_cap = rexec.merge_partial_states(
        _to_ref(state) if running else None, [_to_ref(p) for p in rest],
        merge_cap, 2, len(MERGE_OPS), MERGE_OPS, pack)
    got, got_cap = pexec.merge_partial_states(
        _to_port(state) if running else None, [_to_port(p) for p in rest],
        merge_cap, 2, len(MERGE_OPS), MERGE_OPS, pack)
    ng = int(want[4])
    assert int(got[4]) == ng and got_cap == want_cap
    if merge_cap == 16:
        assert got_cap > 16  # the fold grew its capacity
    assert got[0][0].shape[0] == got_cap
    kn = [np.asarray(a)[:ng] for a in want[1]]
    for i in range(2):
        assert np.array_equal(got[1][i][:ng].numpy(), kn[i])
        live = ~kn[i]
        assert np.array_equal(got[0][i][:ng].numpy()[live],
                              np.asarray(want[0][i])[:ng][live])
    for j, op in enumerate(MERGE_OPS):
        wn = np.asarray(want[3][j])[:ng]
        assert np.array_equal(got[3][j][:ng].numpy(), wn), op
        a = got[2][j][:ng].numpy()[~wn]
        b = np.asarray(want[2][j])[:ng][~wn]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
        else:
            assert np.array_equal(a, b), op
    # the group NULL in every part is a NULL result, not a zero
    if pack is not None:
        g = np.nonzero((got[0][0][:ng].numpy() == 39)
                       & (got[0][1][:ng].numpy() == 2)
                       & ~got[1][0][:ng].numpy())[0]
        assert len(g) == 1 and all(bool(got[3][j][g[0]])
                                   for j in range(len(MERGE_OPS) - 1))


@pytest.mark.parametrize("all_empty", [False, True],
                         ids=["an_empty_part", "all_parts_empty"])
def test_merge_plain_is_k1_over_the_live_slots(all_empty):
    """merge_plain = K1's plain version over the concatenated live slots
    (the running state first): the definition, on a case with NULL keys
    and an empty part, and on parts that are all empty (no group)."""
    from tidb_tpu_torch.ops.kernels import groupby_agg
    parts = [_to_port(p) for p in _states(3, 4, None, null_keys=True)]
    parts.append(_to_port(_states(4, 1, None, False)[0]))
    for i in range(len(parts)) if all_empty else [len(parts) - 1]:
        parts[i] = parts[i][:4] + (torch.tensor(0),) + parts[i][5:]
    got = merge_states.merge_plain(parts, 2, MERGE_OPS, 64, None)
    cat = [torch.cat([p[k][i] for p in parts])
           for k in range(4) for i in range(len(parts[0][k]))]
    mask = torch.cat([torch.arange(p[0][0].shape[0]) < p[4] for p in parts])
    want = groupby_agg.groupby_plain(
        tuple(cat[0:2]), tuple(cat[2:4]), tuple(cat[4:10]),
        tuple(cat[10:16]), mask, 2, MERGE_OPS, 64, None)
    assert int(got[4]) == int(want[4]) and (int(got[4]) == 0) == all_empty
    for a, b in zip(got[:4], want[:4]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("rows,engine", [(0, r"engine:tpu-stream"),
                                         (-1, r"engine:tpu(?![-\w])")],
                         ids=["auto_streams", "minus_one_stays_resident"])
def test_auto_stream_gate(kits, monkeypatch, rows, engine):
    """At the default 0 an input over 4 default pages streams; -1 keeps a
    RAM-resident input on the whole-input path (the escape hatch the
    executor reads: the port's SET keeps -1, which the reference's clamps
    to 0).  The default page is cut to 1,000 rows so that the 20,000-row
    table is over the gate."""
    from tidb_tpu_torch.storage import paged
    monkeypatch.setattr(paged, "DEFAULT_PAGE_ROWS", 1000)
    ref, port = kits
    port.must_exec("set tidb_executor_engine = 'tpu'")
    port.must_exec(f"set tidb_device_stream_rows = {rows}")
    try:
        assert int(port.session.get_sysvar("tidb_device_stream_rows")) == rows
        txt = "\n".join(" ".join(map(str, r)) for r in
                        port.must_query("explain analyze " + QUERY).rows)
        got = port.must_query(QUERY).rows
    finally:
        port.must_exec("set tidb_device_stream_rows = 0")
    agg = [ln for ln in txt.splitlines() if "HashAgg" in ln]
    assert agg and re.search(engine, agg[0]), agg
    ref.must_exec("set tidb_executor_engine = 'host'")
    assert _rows_equal(got, ref.must_query(QUERY).rows)
