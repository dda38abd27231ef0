"""The port's MPP mesh in its SPLIT layout (one tensor a shard, shard i's
on ``devices[i]``: the layout of a mesh across cards) against the JAX
reference and against the port's LOCAL layout, on the CPU.

A split mesh over CPU devices (``Mesh(["cpu"] * n)``) runs the code a
mesh across cards runs, every copy between devices a CPU copy; the
reference runs on the 8 virtual devices tests/conftest.py forces.  Inputs
are made from a seed with numpy and handed to every side.

* the collectives (``all_to_all``, ``psum``, ``pmax``): split and local
  layouts give the same values, bit for bit;
* K11's ``dist_agg_step`` / ``dist_join_agg_step`` on the split mesh
  against the reference's (ints exact, DOUBLE within rtol 1e-9 / atol
  1e-12: the reference sums in another order) and against the local
  layout bit for bit;
* the SQL path (``tidb_executor_engine = 'tpu-mpp'``) with the split mesh
  standing for eight cards (``mpp_exec.set_mesh_devices``): Q1, Q3, Q5,
  Q18, the orders ⋈ lineitem shuffle and a hot key give the reference's
  rows in its order, the host engine's, and the local mesh's bit for bit;
* ``mpp_mesh``'s rule with ``torch.cuda`` monkeypatched to 1 and 4
  visible cards, against the reference's ``mpp_mesh`` over 1 and 4 of its
  virtual devices;
* the placement: shard i's rows uploaded to ``devices[i]``, a replicated
  leaf to every card, every copy charged on the residency ledger.

Each case shows the split path ran: the mesh's ``stats``, a spy on
``Mesh.gather_states`` or ``MPP_STATS``.
"""

import numpy as np
import pytest
import torch

from test_device_ops import _rows_equal
from test_torch_mpp_sql import (JOIN_AGG_Q, PSTATS, Kits, _check,
                                _cold_capacity_stores, _make_fact_dim,
                                _run_both)
from tidb_tpu.executor import mpp_exec as rexec
from tidb_tpu.parallel import mpp as rmpp
from tidb_tpu_torch.executor import mpp_exec as pexec
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops import residency
from tidb_tpu_torch.ops.kernels import merge_states
from tidb_tpu_torch.parallel import mpp as pmpp
from torch_dual import isolated  # noqa: F401

# each case starts from empty learned-capacity stores in both packages
# (test_torch_mpp_sql.py's fixture), so both pay the same retries
pytestmark = pytest.mark.usefixtures("isolated", "_cold_capacity_stores")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _split(n):
    return pmpp.Mesh(["cpu"] * n)


# -- the collectives ----------------------------------------------------------

@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("dtype", ["int64", "float64", "bool"])
def test_collectives_split_equal_local(n, dtype):
    rng = np.random.default_rng(n)
    blk = 5
    if dtype == "int64":
        grids = [rng.integers(-10**12, 10**12, n * blk) for _ in range(n)]
    elif dtype == "float64":
        grids = [rng.standard_normal(n * blk) * 1e6 for _ in range(n)]
    else:
        grids = [rng.random(n * blk) < 0.5 for _ in range(n)]
    loc, spl = pmpp.Mesh(n, device="cpu"), _split(n)
    want = loc.all_to_all([torch.from_numpy(g) for g in grids])
    got = spl.all_to_all([torch.from_numpy(g) for g in grids])
    assert spl.stats["all_to_all"] == 1
    assert len(got) == n
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.is_contiguous()
        assert np.array_equal(_np(a), _np(b))
    # block i of shard j's received grid is block j of grids[i]
    for j in range(n):
        for i in range(n):
            assert np.array_equal(_np(got[j])[i * blk:(i + 1) * blk],
                                  grids[i][j * blk:(j + 1) * blk])
    if dtype != "bool":
        scalars = [torch.from_numpy(g[:1]).reshape(()) for g in grids]
        for op in ("psum", "pmax"):
            a, b = getattr(spl, op)(scalars), getattr(loc, op)(scalars)
            assert a.dtype == b.dtype
            assert _np(a).tobytes() == _np(b).tobytes(), op


def test_split_arrays_and_placement_on_one_device():
    """shard / replica / place on a split mesh whose shards share the
    CPU: shard i's rows, and one replicated copy every shard reads."""
    m = _split(4)
    a = np.arange(12, dtype=np.int64)
    sh = m.place(a, True)
    rep = m.place(a, False)
    assert isinstance(sh, pmpp.Split) and not sh.replicated
    assert [m.shard(sh, i).tolist() for i in range(4)] == [
        [0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    assert sh.shape == (12,) and sh.nbytes == 96
    assert rep.replicated and rep.shape == (12,)
    assert all(m.replica(rep, i) is rep[0] for i in range(4))
    assert rep.nbytes == 96  # the shards share the one device's copy
    loc = pmpp.Mesh(4, device="cpu")
    assert loc.shard(torch.from_numpy(a), 2).tolist() == [6, 7, 8]
    assert m.key == ("split", ("cpu",) * 4)
    assert loc.key == ("local", ("cpu",) * 4)


# -- K11's dist steps ---------------------------------------------------------

def _batches(n, *arrays):
    rmesh = rmpp.make_mesh(n)
    ra, rpad = rmpp.shard_batch(rmesh, *arrays)
    lmesh = pmpp.make_mesh(n, device="cpu")
    smesh = pmpp.make_mesh(devices=["cpu"] * n)
    return ((rmesh, ra, rpad), (lmesh,) + pmpp.shard_batch(lmesh, *arrays),
            (smesh,) + pmpp.shard_batch(smesh, *arrays))


def _agg_out(p):
    return ([_np(p[0])] + [_np(x) for x in p[1]]
            + [_np(p[2]), _np(p[3]), _np(p[4])])


@pytest.mark.parametrize("floats", [False, True], ids=["int64", "float64"])
def test_dist_agg_step_split_matches_reference(floats):
    rng = np.random.default_rng(17)
    n = 10_000
    keys = rng.integers(0, 37, n)
    valid = rng.random(n) < 0.8
    sums = (rng.standard_normal(n) * 100 if floats
            else rng.integers(-100, 100, n))
    ones = np.ones(n, dtype=np.int64)
    mins = rng.integers(0, 10**6, n)
    kinds = ("sum", "count", "min", "max")
    (rm, ra, rpad), (lm, la, _lp), (sm, sa, _sp) = _batches(
        8, keys, valid, sums, ones, mins, mins)
    assert isinstance(sa[0], pmpp.Split) and len(sa[0]) == 8
    r = rmpp.dist_agg_step(rm, kinds, capacity=64)(
        ra[0], ra[1] & rpad, *ra[2:])
    # padding rows pad `valid` with False, so it masks them already
    loc = pmpp.dist_agg_step(lm, kinds, capacity=64)(la[0], la[1], *la[2:])
    calls = []
    gather = sm.gather_states
    sm.gather_states = lambda states: calls.append(len(states)) or \
        gather(states)
    spl = pmpp.dist_agg_step(sm, kinds, capacity=64)(sa[0], sa[1], *sa[2:])
    assert calls == [8], "the split step never gathered its 8 states"
    merge_states.check_fault(spl[5])
    assert not bool(spl[4]) and int(spl[3]) == int(r[3]) == 37
    # split and local: the same bits
    for a, b in zip(_agg_out(spl), _agg_out(loc)):
        assert a.tobytes() == b.tobytes()
    ng = 37
    assert np.array_equal(_np(spl[0])[:ng], np.asarray(r[0])[:ng])
    for a, b in zip(spl[1], r[1]):
        a, b = _np(a)[:ng], np.asarray(b)[:ng]
        if a.dtype == np.float64:
            assert np.allclose(a, b, rtol=1e-9, atol=1e-12)
        else:
            assert np.array_equal(a, b)


def test_dist_agg_step_split_overflow_flag():
    n = 1024
    keys = np.arange(n, dtype=np.int64)  # 1024 groups > capacity 8
    (rm, ra, rpad), _l, (sm, sa, _sp) = _batches(
        8, keys, np.ones(n, bool), np.ones(n, dtype=np.int64))
    r = rmpp.dist_agg_step(rm, ("sum",), capacity=8)(ra[0], ra[1] & rpad,
                                                     ra[2])
    p = pmpp.dist_agg_step(sm, ("sum",), capacity=8)(sa[0], sa[1], sa[2])
    assert bool(r[4]) and bool(p[4])


def _join_inputs(seed, floats=False, build_valid=0.7):
    rng = np.random.default_rng(seed)
    nb, npr = 3000, 9000
    bk = rng.integers(0, 500, nb)
    bv = rng.random(nb) * 100 if floats else rng.integers(1, 50, nb)
    bvalid = rng.random(nb) < build_valid
    pk = rng.integers(0, 700, npr)
    pv = rng.random(npr) * 10 if floats else rng.integers(1, 50, npr)
    pvalid = rng.random(npr) < 0.9
    return bk, bv, bvalid, pk, pv, pvalid


@pytest.mark.parametrize("n,case", [(8, "int64"), (8, "float64"),
                                    (8, "empty-build"), (3, "int64"),
                                    (8, "overflow")])
def test_dist_join_agg_step_split_matches_reference(n, case):
    """Kernel A's exchange between the split shards, each shard's sort
    join and kernel B's sum, psum'd on shard 0's device."""
    if case == "overflow":  # every row hashes to one bucket of cap 2
        keys = np.zeros(512, dtype=np.int64)
        ones = np.ones(512, dtype=np.int64)
        valid = np.ones(512, bool)
        bk, bv, bvalid, pk, pv, pvalid = keys, ones, valid, keys, ones, valid
        cap = 2
    else:
        bk, bv, bvalid, pk, pv, pvalid = _join_inputs(
            11, floats=case == "float64",
            build_valid=0.0 if case == "empty-build" else 0.7)
        cap = 4096
    (rm, rb, rbpad), (lm, lb, _), (sm, sb, _) = _batches(n, bk, bvalid, bv)
    (_, rp, rppad), (_, lp, _), (_, sp, _) = _batches(n, pk, pvalid, pv)
    r = rmpp.dist_join_agg_step(rm, cap)(rb[0], rb[2], rb[1] & rbpad,
                                         rp[0], rp[2], rp[1] & rppad)
    loc = pmpp.dist_join_agg_step(lm, cap)(lb[0], lb[2], lb[1],
                                           lp[0], lp[2], lp[1])
    spl = pmpp.dist_join_agg_step(sm, cap)(sb[0], sb[2], sb[1],
                                           sp[0], sp[2], sp[1])
    # two exchanges of three columns each
    assert sm.stats["all_to_all"] == 6
    for a, b in zip(spl, loc):
        assert a.dtype == b.dtype and _np(a).tobytes() == _np(b).tobytes()
    assert int(spl[2]) == int(r[2])
    assert (int(spl[2]) > 0) == (case == "overflow")
    assert int(spl[1]) == int(r[1])
    if case == "float64":
        assert np.isclose(float(spl[0]), float(r[0]), rtol=1e-9, atol=1e-12)
    else:
        assert int(spl[0]) == int(r[0])


# -- mpp_mesh's rule ----------------------------------------------------------

class _Ctx:
    def __init__(self, n):
        self.n = n

    def get_sysvar(self, name, *a, **kw):
        if name == "tidb_executor_engine":
            return "tpu-mpp"
        if name == "tidb_mpp_devices":
            return self.n
        raise KeyError(name)


@pytest.mark.parametrize("cards", [1, 4])
@pytest.mark.parametrize("n", [0, 2, 4, 9])
def test_mpp_mesh_rule_against_reference(monkeypatch, cards, n):
    """With 4 visible cards the port's n is the reference's over 4
    devices (0: every one; capped at 4), one shard a card, shard 0 the
    session's; with one card the reference gives no mesh and the port
    keeps its stated divergence: n >= 2 logical shards on the card."""
    virtual = rexec.jax.devices()
    monkeypatch.setattr(rexec.jax, "devices", lambda *a: virtual[:cards])
    monkeypatch.setattr(rexec, "_MESH_CACHE", {})
    rmesh = rexec.mpp_mesh(_Ctx(n))
    want = None if rmesh is None else rmesh.shape[rexec.AXIS]
    monkeypatch.setattr(pexec.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pexec.torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(tdev, "_DEVICE", ["cuda:0"])
    monkeypatch.setattr(pexec, "_MESH_CACHE", {})
    pmesh = pexec.mpp_mesh(_Ctx(n))
    got = None if pmesh is None else pmesh.shape[pexec.AXIS]
    if cards > 1:
        assert got == want == (min(n, cards) if n else cards)
        assert pmesh.split
        assert [str(d) for d in pmesh.devices] == [
            f"cuda:{i}" for i in range(got)]
    else:
        assert want is None
        if n >= 2:
            assert got == n and not pmesh.split
            assert set(map(str, pmesh.devices)) == {"cuda:0"}
        else:
            assert got is None


def test_mpp_mesh_starts_at_the_session_card(monkeypatch):
    """A session on card 2 of 4: its mesh's shard 0 is card 2 (where the
    states fold), then the cards after it."""
    monkeypatch.setattr(pexec.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pexec.torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(tdev, "_DEVICE", ["cuda:2"])
    monkeypatch.setattr(pexec, "_MESH_CACHE", {})
    m = pexec.mpp_mesh(_Ctx(3))
    assert [str(d) for d in m.devices] == ["cuda:2", "cuda:3", "cuda:0"]
    assert pexec.mpp_mesh(_Ctx(3)) is m
    assert pexec.mpp_mesh(_Ctx(0)).n == 4


def test_set_mesh_devices_stands_for_the_cards(monkeypatch):
    monkeypatch.setattr(pexec, "_MESH_CACHE", {})
    prev = pexec.set_mesh_devices(["cpu"] * 4)
    try:
        m = pexec.mpp_mesh(_Ctx(0))
        assert m.split and m.n == 4
        assert pexec.mpp_mesh(_Ctx(9)) is m
        assert pexec.mpp_mesh(_Ctx(1)) is None
        pexec.set_mesh_devices(["cpu"])
        assert pexec.mpp_mesh(_Ctx(0)) is None
        loc = pexec.mpp_mesh(_Ctx(3))
        assert not loc.split and loc.n == 3
    finally:
        pexec.set_mesh_devices(prev)


# -- placement ----------------------------------------------------------------

def test_placement_uploads_shard_i_to_card_i(monkeypatch):
    """A spy on the upload: on a split mesh of four cards a sharded
    column's shard i goes to cuda:i, a replicated one to every card, and
    the ledger charges every copy."""
    calls = []

    def upload(arr, d):
        calls.append((str(d), np.array(arr)))
        return torch.from_numpy(np.array(arr))

    monkeypatch.setattr(tdev, "upload", upload)
    mesh = pmpp.Mesh([f"cuda:{i}" for i in range(4)])

    class Col:
        pass

    rng = np.random.default_rng(3)
    data = rng.integers(-99, 99, 30)
    nulls = rng.random(30) < 0.2
    col = Col()
    d, nl = pexec._place_col(col, data, nulls, mesh, True, 32)
    assert [c[0] for c in calls] == [f"cuda:{i}" for i in range(4)] * 2
    padded = np.concatenate([data, np.zeros(2, data.dtype)])
    for i in range(4):
        assert np.array_equal(calls[i][1], padded[i * 8:(i + 1) * 8])
        assert np.array_equal(_np(mesh.shard(d, i)), padded[i * 8:(i + 1) * 8])
    assert _np(mesh.shard(nl, 3))[-2:].all()  # padding reads as NULL
    owner = pexec._MPP_PLACE_CACHE[(id(col), id(mesh), True, 32)][0]
    assert residency.resident_nbytes(owner) == 32 * 8 + 32
    calls.clear()
    col2 = Col()
    d2, _n2 = pexec._place_col(col2, data, nulls, mesh, False, 32)
    assert [c[0] for c in calls] == [f"cuda:{i}" for i in range(4)] * 2
    assert all(np.array_equal(c[1], padded) for c in calls[:4])
    owner2 = pexec._MPP_PLACE_CACHE[(id(col2), id(mesh), False, 32)][0]
    assert residency.resident_nbytes(owner2) == 4 * (32 * 8 + 32)
    # a hit uploads nothing
    calls.clear()
    pexec._place_col(col2, data, nulls, mesh, False, 32)
    assert calls == []
    with pexec._PLACE_LOCK:
        for k in [k for k in pexec._MPP_PLACE_CACHE if k[1] == id(mesh)]:
            del pexec._MPP_PLACE_CACHE[k]
    assert residency.verify_ledger()["ok"]


# -- the SQL path -------------------------------------------------------------

Q1 = """
    select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
           sum(l_extendedprice) as sum_base_price,
           sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
           avg(l_quantity) as avg_qty, count(1) as count_order
    from lineitem where l_shipdate <= '1998-09-02'
    group by l_returnflag, l_linestatus
    order by l_returnflag, l_linestatus"""
Q3 = """
    select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as rev,
           o_orderdate, o_shippriority
    from customer, orders, lineitem
    where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
      and l_orderkey = o_orderkey and o_orderdate < '1995-03-15'
      and l_shipdate > '1995-03-15'
    group by l_orderkey, o_orderdate, o_shippriority
    order by rev desc, o_orderdate limit 10"""
Q5 = """
    select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
    from customer, orders, lineitem, supplier, nation, region
    where c_custkey = o_custkey and l_orderkey = o_orderkey
      and l_suppkey = s_suppkey and c_nationkey = s_nationkey
      and s_nationkey = n_nationkey and n_regionkey = r_regionkey
      and r_name = 'ASIA' and o_orderdate >= '1994-01-01'
      and o_orderdate < date_add('1994-01-01', interval 1 year)
    group by n_name order by revenue desc"""
Q18 = """
    select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
           sum(l_quantity)
    from customer, orders, lineitem
    where o_orderkey in (select l_orderkey from lineitem
                         group by l_orderkey
                         having sum(l_quantity) > 60)
      and c_custkey = o_custkey and o_orderkey = l_orderkey
    group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
    order by o_totalprice desc, o_orderdate limit 20"""
SHUFFLE_Q = """
    select o_orderstatus, count(1), sum(l_quantity)
    from orders, lineitem where o_orderkey = l_orderkey
    group by o_orderstatus order by o_orderstatus"""
HOT_Q = ("select count(1), sum(fact.v + dim.w) from fact, dim "
         "where fact.k = dim.k")


@pytest.fixture()
def split_gathers(monkeypatch):
    """The split mesh standing for eight cards, and the folds it ran:
    each split gather of the shards' states, by shard count."""
    calls = []
    gather = pmpp.Mesh.gather_states

    def spy(self, states):
        if self.split:
            calls.append(len(states))
        return gather(self, states)

    monkeypatch.setattr(pmpp.Mesh, "gather_states", spy)
    prev = pexec.set_mesh_devices(["cpu"] * 8)
    yield calls
    pexec.set_mesh_devices(prev)


@pytest.fixture(scope="module")
def tpch():
    import test_tpch
    tdev.set_device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_tpch, "TestKit", Kits)
        kits = test_tpch.make_tpch_tk(db="tpch_mpp_split")
    # 0: every device, eight in both packages
    kits.must_exec("set tidb_mpp_devices = 0")
    return kits


def _local_rows(kits, sql, setup=(), reset=()):
    """The port's rows on its local mesh of eight shards (the one-card
    layout), under `setup`."""
    prev = pexec.set_mesh_devices(None)
    tk = kits.port
    try:
        for s in setup:
            tk.must_exec(s)
        tk.must_exec("set tidb_mpp_devices = 8")
        tk.must_exec("set tidb_executor_engine = 'tpu-mpp'")
        before = PSTATS["fragments"]
        rows = tk.must_query(sql).rows
        assert PSTATS["fragments"] > before
        return rows
    finally:
        tk.must_exec("set tidb_executor_engine = 'auto'")
        tk.must_exec("set tidb_mpp_devices = 0")
        for s in reset:
            tk.must_exec(s)
        pexec.set_mesh_devices(prev)


def _split_case(kits, gathers, sql, setup=(), reset=(),
                keys=("fragments", "shuffle_joins", "skew_broadcasts")):
    out = _run_both(kits, sql, setup=setup, reset=reset)
    rows = _check(out, keys=keys)
    assert gathers and all(n == 8 for n in gathers), \
        "the port's fragment never folded on the split mesh"
    assert rows == _local_rows(kits, sql, setup, reset), \
        "split and local layouts differ"
    return out["port"][2]


@pytest.mark.parametrize("name", ["q1", "q3", "q5", "q18"])
def test_sql_on_split_mesh(tpch, split_gathers, name):
    sql = {"q1": Q1, "q3": Q3, "q5": Q5, "q18": Q18}[name]
    _split_case(tpch, split_gathers, sql)


def test_sql_shuffle_on_split_mesh(tpch, split_gathers):
    """orders ⋈ lineitem past the broadcast threshold: kernel A's
    exchange between the split shards."""
    th = ("set tidb_broadcast_join_threshold_count = 50",)
    d = _split_case(tpch, split_gathers, SHUFFLE_Q, setup=th,
                    reset=("set tidb_broadcast_join_threshold_count = "
                           "10240",),
                    keys=("fragments", "shuffle_joins", "retries",
                          "exchange_overflow_retries"))
    assert d["shuffle_joins"] > 0


def test_sql_hot_key_on_split_mesh(split_gathers):
    """70% of the fact rows on one key: the exchange overflows, retries
    at the exact need and drops nothing, as in the reference."""
    kits = Kits()
    kits.must_exec("set tidb_mpp_devices = 0")
    _make_fact_dim(kits, n_fact=320, n_dim=64, hot_frac=0.7)
    th = ("set tidb_broadcast_join_threshold_count = 30",)
    d = _split_case(kits, split_gathers, HOT_Q, setup=th,
                    keys=("fragments", "shuffle_joins",
                          "exchange_overflow_retries"))
    assert d["shuffle_joins"] > 0 and d["exchange_overflow_retries"] > 0


def test_sql_split_placements_on_the_ledger(split_gathers):
    """The split placements are on the ledger (one copy of a replicated
    leaf a device; the eight CPU shards share one), a warm run builds
    nothing, and a fence drops every placement."""
    from tidb_tpu_torch.executor import supervisor
    from tidb_tpu_torch.executor.device_exec import pipe_cache_stats
    kits = Kits()
    kits.must_exec("set tidb_mpp_devices = 0")
    _make_fact_dim(kits)
    kits.must_exec("set tidb_executor_engine = 'host'")
    host = kits.port.must_query(JOIN_AGG_Q).rows
    kits.port.must_exec("set tidb_executor_engine = 'tpu-mpp'")
    assert _rows_equal(kits.port.must_query(JOIN_AGG_Q).rows, host)
    runs = len(split_gathers)
    assert runs and set(split_gathers) == {8}
    assert pexec.place_cache_bytes() > 0
    assert residency.verify_ledger()["ok"]
    s0 = pipe_cache_stats()
    assert kits.port.must_query(JOIN_AGG_Q).rows == host
    s1 = pipe_cache_stats()
    assert (s1["traces"], s1["misses"]) == (s0["traces"], s0["misses"])
    assert len(split_gathers) == runs + 1  # one dispatch, no retry
    supervisor.fence("test: split mesh fence")
    assert pexec.place_cache_bytes() == 0
    assert kits.port.must_query(JOIN_AGG_Q).rows == host
    assert pexec.place_cache_bytes() > 0
    assert len(split_gathers) > runs + 1 and set(split_gathers) == {8}
