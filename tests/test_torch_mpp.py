"""The port's MPP operators (K11) and the exchange kernels against the JAX
reference on the CPU.

The reference runs on the 8 virtual devices tests/conftest.py forces; the
port on its local mesh of 8 (or 3) logical shards on the CPU, where every
kernel wrapper runs its plain version (tests/test_torch_cuda.py and
chip_smoke.py hold the CUDA kernels to those plain versions on a card).
Inputs are made from a seed with numpy and handed to both.

* kernel A (``ops/kernels/radix_exchange.py``): mix64 bit for bit against
  ``tidb_tpu/parallel/mpp.py _mix64`` on int64 min/max, 0, -1 and FK-stride
  keys; the whole slot buffers of ``partition`` against ``_bucketize`` at
  8 and 3 destinations, ``dropped`` at an overflowing cap; the fold hash
  and the exchange against ``executor/mpp_exec.py _dest_hash`` +
  ``_exchange_leaf`` (valid slots, ``slot_valid`` and ``need``; slots past
  a bucket's count are arbitrary in the reference);
* kernel B (``ops/kernels/shuffle_join.py``) through both packages'
  ``dist_join_agg_step``: int64 exact, float64 within rtol 1e-9 / atol
  1e-12 (the sums run in another order), an empty build side;
* one shard's partial (``_local_agg`` on K1) against the reference's;
* tests/test_mpp.py's six cases through both packages on the same arrays.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tidb_tpu.executor import mpp_exec as rexec
from tidb_tpu.parallel import mpp as rmpp
from tidb_tpu.utils.jaxcompat import shard_map
from tidb_tpu_torch.executor import mpp_exec as pexec
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops.kernels import merge_states
from tidb_tpu_torch.ops.kernels import radix_exchange as rx
from tidb_tpu_torch.parallel import mpp as pmpp

I64 = np.iinfo(np.int64)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# -- kernel A -----------------------------------------------------------------

def _extreme_keys():
    rng = np.random.default_rng(5)
    return np.concatenate([
        np.array([0, -1, I64.min, I64.max, I64.min + 1, I64.max - 1, 1],
                 dtype=np.int64),
        np.arange(0, 6_000_000, 4_000, dtype=np.int64) * 7,  # FK strides
        rng.integers(I64.min, I64.max, 3000, dtype=np.int64),
        rng.integers(-1000, 1000, 1000)])


def test_mix64_matches_reference():
    keys = _extreme_keys()
    want = np.asarray(rmpp._mix64(jnp.asarray(keys))).view(np.int64)
    h, ok = rx.dest_hash([_t(keys)], "single")
    assert np.array_equal(_np(h), want)
    assert _np(ok).all()


def test_fold_hash_matches_reference():
    rng = np.random.default_rng(9)
    keys = _extreme_keys()
    k2 = rng.integers(I64.min, I64.max, len(keys), dtype=np.int64)
    want = np.asarray(rexec._dest_hash(
        [jnp.asarray(keys), jnp.asarray(k2)])).view(np.int64)
    nulls = rng.random(len(keys)) < 0.1
    valid = rng.random(len(keys)) < 0.8
    h, ok = pexec._dest_hash([_t(keys), _t(k2)], [_t(nulls), None],
                             _t(valid))
    assert np.array_equal(_np(h), want)
    assert np.array_equal(_np(ok), valid & ~nulls)


@pytest.mark.parametrize("n_dest", [8, 3])
@pytest.mark.parametrize("cap", [512, 16])
def test_partition_matches_bucketize(n_dest, cap):
    """The whole slot buffers equal the reference's (zero fill included),
    and the dropped count at an overflowing cap."""
    rng = np.random.default_rng(n_dest * 100 + cap)
    n = 6000
    keys = np.concatenate([_extreme_keys()[:2000],
                           rng.integers(-10**9, 10**9, n - 2000)])
    vals = rng.integers(-50, 50, n)
    fvals = rng.random(n)
    valid = rng.random(n) < 0.85
    bk, (bv, bf), bvalid, dropped = rmpp._bucketize(
        jnp.asarray(keys), (jnp.asarray(vals), jnp.asarray(fvals)),
        jnp.asarray(valid), n_dest, cap)
    h, ok = rx.dest_hash([_t(keys)], "single", valid=_t(valid))
    out = rx.partition(h, ok, n_dest, rmpp.RADIX_SUB, cap,
                       [_t(keys), _t(vals), _t(fvals)])
    assert np.array_equal(_np(out["cols"][0]), np.asarray(bk))
    assert np.array_equal(_np(out["cols"][1]), np.asarray(bv))
    assert np.array_equal(_np(out["cols"][2]), np.asarray(bf))
    assert np.array_equal(_np(out["valid"]), np.asarray(bvalid))
    assert int(out["dropped"]) == int(dropped)
    assert (int(dropped) > 0) == (cap == 16)
    # the source row of every filled slot, in row order inside a bucket
    rows = _np(out["rows"])[_np(out["valid"])]
    assert np.array_equal(keys[rows], np.asarray(bk)[np.asarray(bvalid)])


def test_partition_refuses_too_many_buckets():
    h = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        rx.partition(h, None, 256, 4, 8)


@pytest.mark.parametrize("cap", [256, 8])
def test_exchange_leaf_matches_reference(cap):
    """Fold hash + radix partition + all_to_all of one leaf on 8 shards:
    per shard the valid slots, slot_valid and the exact need equal the
    reference's."""
    rng = np.random.default_rng(cap)
    n_shards, psb = 8, 300
    n = n_shards * psb
    k1 = rng.integers(0, 500, n)
    k2 = rng.integers(-3, 3, n)
    d = rng.integers(-10**6, 10**6, n)
    nl = rng.random(n) < 0.2
    valid = rng.random(n) < 0.9
    mesh = rmpp.make_mesh(n_shards)

    def body(a, b, dd, nn, v):
        h = rexec._dest_hash([a, b])
        cols, ov, need = rexec._exchange_leaf([(dd, nn)], h, v, n_shards,
                                              rmpp.RADIX_SUB, cap)
        return cols[0][0], cols[0][1], ov, jax.lax.pmax(need, rexec.AXIS)

    f = shard_map(body, mesh=mesh, in_specs=(P(rexec.AXIS),) * 5,
                  out_specs=(P(rexec.AXIS),) * 3 + (P(),), check_vma=False)
    rd, rn, rv, rneed = (np.asarray(x) for x in f(
        jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(d), jnp.asarray(nl),
        jnp.asarray(valid)))
    pm = pmpp.Mesh(n_shards, device="cpu")
    hashes, cols = [], []
    for i in range(n_shards):
        s = slice(i * psb, (i + 1) * psb)
        hashes.append(pexec._dest_hash([_t(k1[s]), _t(k2[s])], [None, None],
                                       _t(valid[s])))
        cols.append([_t(d[s]), _t(nl[s])])
    recv, pv, need = pexec._exchange_leaf(pm, cols, hashes, rmpp.RADIX_SUB,
                                          cap)
    got_v = np.concatenate([_np(v) for v in pv])
    assert np.array_equal(got_v, rv)
    got_d = np.concatenate([_np(x) for x in recv[0]])
    got_n = np.concatenate([_np(x) for x in recv[1]])
    assert np.array_equal(got_d[rv], rd[rv])
    assert np.array_equal(got_n[rv], rn[rv])
    assert int(need) == int(rneed)
    assert (int(need) > cap) == (cap == 8)


# -- K11: the dist_* steps in both packages -----------------------------------

def _both_batches(n_shards, *arrays):
    rmesh = rmpp.make_mesh(n_shards)
    pmesh = pmpp.make_mesh(n_shards)
    ra, rpad = rmpp.shard_batch(rmesh, *arrays)
    pa, ppad = pmpp.shard_batch(pmesh, *arrays)
    return (rmesh, ra, rpad), (pmesh, pa, ppad)


def _numpy_groupby(keys, valid, vals, kinds):
    out = {}
    for k in np.unique(keys[valid]):
        m = valid & (keys == k)
        row = []
        for v, kind in zip(vals, kinds):
            if kind in ("sum", "count"):
                row.append(v[m].sum())
            elif kind == "min":
                row.append(v[m].min())
            elif kind == "max":
                row.append(v[m].max())
        out[int(k)] = row
    return out


def _groups(fk, fouts, n_groups):
    fk = _np(fk)
    return {int(fk[i]): [int(_np(f)[i]) for f in fouts]
            for i in range(int(n_groups))}


def test_dist_agg_matches_numpy_and_reference():
    rng = np.random.default_rng(7)
    n = 10_000
    keys = rng.integers(0, 37, n)
    valid = rng.random(n) < 0.8
    sums = rng.integers(-100, 100, n)
    ones = np.ones(n, dtype=np.int64)
    mins = rng.integers(0, 10**6, n)
    kinds = ("sum", "count", "min", "max")
    (rm, ra, rpad), (pm, pa, ppad) = _both_batches(
        8, keys, valid, sums, ones, mins, mins)
    r = rmpp.dist_agg_step(rm, kinds, capacity=64)(
        ra[0], ra[1] & rpad, *ra[2:])
    p = pmpp.dist_agg_step(pm, kinds, capacity=64)(
        pa[0], pa[1] & ppad, *pa[2:])
    assert not bool(r[4]) and not bool(p[4])
    assert int(p[3]) == int(r[3]) == 37
    merge_states.check_fault(p[5])  # the port's fold fault word: clear
    assert _np(p[2])[:37].all()
    want = _numpy_groupby(keys, valid, [sums, ones, mins, mins], kinds)
    assert _groups(p[0], p[1], p[3]) == want == _groups(r[0], r[1], r[3])
    # the slots themselves, in the reference's ascending key order
    assert np.array_equal(_np(p[0])[:37], np.asarray(r[0])[:37])


@pytest.mark.parametrize("floats", [False, True])
def test_local_agg_matches_reference(floats):
    """One shard's partial (K1's plain version) against the reference's
    sort-based ``_local_agg``: groups in ascending key order, int64 keys
    at the extremes, sums (float within rtol 1e-9 / atol 1e-12), counts,
    min and max."""
    rng = np.random.default_rng(21)
    n = 5000
    keys = rng.choice(np.array([I64.min, -7, 0, 3, 99, I64.max]), n)
    valid = rng.random(n) < 0.8
    v = rng.random(n) * 100 if floats else rng.integers(-99, 99, n)
    ones = np.ones(n, dtype=np.int64)
    mm = rng.integers(-10**6, 10**6, n)
    kinds = ("sum", "count", "min", "max")
    rk, routs, rvalid, rng_ = rmpp._local_agg(
        jnp.asarray(keys), jnp.asarray(valid),
        tuple(jnp.asarray(a) for a in (v, ones, mm, mm)), kinds, 16)
    pk, pouts, pvalid, png = pmpp._local_agg(
        _t(keys), _t(valid), [_t(a) for a in (v, ones, mm, mm)], kinds, 16)
    ng = int(rng_)
    assert int(png) == ng == 6
    assert np.array_equal(_np(pvalid), np.asarray(rvalid))
    assert np.array_equal(_np(pk)[:ng], np.asarray(rk)[:ng])
    for a, b in zip(pouts, routs):
        a, b = _np(a)[:ng], np.asarray(b)[:ng]
        if floats and a.dtype == np.float64:
            assert np.allclose(a, b, rtol=1e-9, atol=1e-12)
        else:
            assert np.array_equal(a, b)


def test_dist_agg_overflow_flag():
    n = 1024
    keys = np.arange(n, dtype=np.int64)  # 1024 groups > capacity 8
    (rm, ra, rpad), (pm, pa, ppad) = _both_batches(
        8, keys, np.ones(n, bool), np.ones(n, dtype=np.int64))
    r = rmpp.dist_agg_step(rm, ("sum",), capacity=8)(
        ra[0], ra[1] & rpad, ra[2])
    p = pmpp.dist_agg_step(pm, ("sum",), capacity=8)(
        pa[0], pa[1] & ppad, pa[2])
    assert bool(r[4]) and bool(p[4])


def _join_inputs(seed, nb=3000, npr=9000, floats=False, build_valid=0.7):
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, 500, nb)
    bv = rng.random(nb) * 100 if floats else rng.integers(1, 50, nb)
    bvalid = rng.random(nb) < build_valid
    pk = rng.integers(0, 700, npr)
    pv = rng.random(npr) * 10 if floats else rng.integers(1, 50, npr)
    pvalid = rng.random(npr) < 0.9
    return bk, bv, bvalid, pk, pv, pvalid


def _numpy_join(bk, bv, bvalid, pk, pv, pvalid):
    bsum, bcnt = {}, {}
    for k, v, ok in zip(bk, bv, bvalid):
        if ok:
            bsum[k] = bsum.get(k, 0) + v
            bcnt[k] = bcnt.get(k, 0) + 1
    total, pairs = 0, 0
    for k, v, ok in zip(pk, pv, pvalid):
        if ok and k in bsum:
            total += v * bsum[k]
            pairs += bcnt[k]
    return total, pairs


def _run_join(n_shards, cap, bk, bv, bvalid, pk, pv, pvalid):
    (rm, rb, rbpad), (pm, pb, pbpad) = _both_batches(n_shards, bk, bvalid,
                                                     bv)
    (_, rp, rppad), (_, pp, pppad) = _both_batches(n_shards, pk, pvalid, pv)
    r = rmpp.dist_join_agg_step(rm, cap)(rb[0], rb[2], rb[1] & rbpad,
                                         rp[0], rp[2], rp[1] & rppad)
    p = pmpp.dist_join_agg_step(pm, cap)(pb[0], pb[2], pb[1] & pbpad,
                                         pp[0], pp[2], pp[1] & pppad)
    return r, p


@pytest.mark.parametrize("case", ["int64", "float64", "empty-build"])
def test_dist_join_agg_matches_reference(case):
    """Kernel B's sum (with K4's order and K5a's ranges) through both
    packages' dist_join_agg_step, against numpy too."""
    bk, bv, bvalid, pk, pv, pvalid = _join_inputs(
        11, floats=case == "float64",
        build_valid=0.0 if case == "empty-build" else 0.7)
    r, p = _run_join(8, 4096, bk, bv, bvalid, pk, pv, pvalid)
    want_total, want_pairs = _numpy_join(bk, bv, bvalid, pk, pv, pvalid)
    assert int(p[2]) == int(r[2]) == 0
    assert int(p[1]) == int(r[1]) == want_pairs
    if case == "float64":
        assert p[0].dtype == torch.float64
        assert np.isclose(float(p[0]), float(r[0]), rtol=1e-9, atol=1e-12)
        assert np.isclose(float(p[0]), want_total, rtol=1e-9, atol=1e-12)
    else:
        assert int(p[0]) == int(r[0]) == want_total
    if case == "empty-build":
        assert int(p[0]) == 0


def test_dist_join_three_shards_matches_reference():
    """n_dest = 3: the destination fold's ``% n_dest`` off a power of
    two."""
    r, p = _run_join(3, 4096, *_join_inputs(13))
    assert [int(x) for x in p] == [int(x) for x in r]


def test_join_agg_bucket_overflow_reported():
    n = 512
    keys = np.zeros(n, dtype=np.int64)  # all rows hash to one bucket
    ones = np.ones(n, dtype=np.int64)
    valid = np.ones(n, bool)
    r, p = _run_join(8, 2, keys, ones, valid, keys, ones, valid)
    assert int(p[2]) > 0
    assert int(p[2]) == int(r[2])


class _SupCtx:
    """Minimal embedder context for the dist_* ctx= hook: just the
    sysvars effective_deadline reads (no Domain, no session)."""

    def __init__(self, timeout_s):
        self._t = timeout_s

    def get_sysvar(self, name, *a, **kw):
        if name == "tidb_device_call_timeout":
            return self._t
        if name == "max_execution_time":
            return 0
        raise KeyError(name)


def test_dist_agg_step_supervised_ctx_matches_inline():
    """ctx= routes the step through the device-runtime supervisor (worker
    thread + deadline) with identical results, in both packages."""
    rng = np.random.default_rng(11)
    n = 4096
    keys = rng.integers(0, 17, n)
    vals = rng.integers(-50, 50, n)
    (rm, ra, rpad), (pm, pa, ppad) = _both_batches(8, keys, np.ones(n, bool),
                                                   vals)
    ref = rmpp.dist_agg_step(rm, ("sum",), capacity=32)(
        ra[0], ra[1] & rpad, ra[2])
    plain = pmpp.dist_agg_step(pm, ("sum",), capacity=32)
    sup = pmpp.dist_agg_step(pm, ("sum",), capacity=32,
                             ctx=_SupCtx(timeout_s=30.0))
    a = plain(pa[0], pa[1] & ppad, pa[2])
    b = sup(pa[0], pa[1] & ppad, pa[2])
    assert _np(a[0]).tolist() == _np(b[0]).tolist()
    assert _np(a[1][0]).tolist() == _np(b[1][0]).tolist()
    assert int(a[3]) == int(b[3]) == int(ref[3])
    ng = int(ref[3])
    assert _np(a[0])[:ng].tolist() == np.asarray(ref[0])[:ng].tolist()
    assert _np(a[1][0])[:ng].tolist() == np.asarray(ref[1][0])[:ng].tolist()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_dist_agg_step_supervised_ctx_hang_deadline(pkg):
    """A stalled supervised dispatch raises DeviceHangError instead of
    blocking the embedder forever, in both packages."""
    if pkg == "ref":
        from tidb_tpu.errors import DeviceHangError
        sup = rmpp._supervised_step
    else:
        from tidb_tpu_torch.errors import DeviceHangError
        sup = pmpp._supervised_step

    def stalls(*_a):
        time.sleep(0.5)
        return "never used"

    wrapped = sup(stalls, _SupCtx(timeout_s=0.05))
    t0 = time.monotonic()
    with pytest.raises(DeviceHangError):
        wrapped()
    assert time.monotonic() - t0 < 0.4


def test_mesh_collectives():
    """The local mesh's all_to_all is the tiled transpose of equal blocks,
    psum/pmax reductions."""
    m = pmpp.Mesh(3, device="cpu")
    grids = [torch.arange(6) + 10 * i for i in range(3)]
    got = m.all_to_all(grids)
    assert [g.tolist() for g in got] == [[0, 1, 10, 11, 20, 21],
                                         [2, 3, 12, 13, 22, 23],
                                         [4, 5, 14, 15, 24, 25]]
    assert all(g.is_contiguous() for g in got)
    s = [torch.tensor(4), torch.tensor(9), torch.tensor(2)]
    assert int(m.psum(s)) == 15 and int(m.pmax(s)) == 9
    assert m.shard(torch.arange(9), 1).tolist() == [3, 4, 5]
