"""The port's join slice against the JAX reference on the CPU.

Kernel functions, on the same seeded numpy inputs (each wrapper runs its
plain PyTorch version on CPU tensors; tests/test_torch_cuda.py and
chip_smoke.py hold the CUDA kernels to those plain versions on a card):

* K5a ``join_probe`` against ``_pack_probe`` + the probe block of
  ``tidb_tpu/executor/device_join.py compile_fragment.run`` and against
  ``_combined_join_keys``;
* K5b ``join_expand`` (with K4's whole order and K5a's count) against
  ``_join_expand`` and the CSR block of ``compile_fragment.run``;
* K7 ``device_join_match`` against ``tidb_tpu/ops/device.py``'s, and
  the plain K7 (``join_match``) in each layout and path its summary
  picks (unique dense, duplicates, sparse, int64's ends, NULLs, empty
  sides, a hot key, a key of RANK_MAX rows and one of a row more)
  against it, order included;
* K5a's finish fused into the ON residual's VM launch against ``run_vm``
  plus ``finish_plain`` and the reference's ON-residual match;
* K6 ``build_join_index`` against the reference's arrays;
* K2's ``LOADG`` against an explicit gather.

Slot arrays compare on the slots the reference marks valid (past them
both sides hold arbitrary in-bounds indices); totals, validity and
counts compare everywhere.

SQL, on the same data in the reference's ``TestKit`` and the port's:
every ``tests/test_tpch.py`` query that reaches the reference's
``compile_fragment``, every case of ``tests/test_device_outer_join.py``,
a capacity retry, a HashJoin without an aggregate, and the paged gate.
Rows compare by tests/test_device_ops.py's ``_rows_equal`` (doubles
within rtol 1e-9 / atol 1e-12, everything else exact), and a spy on
``compile_fragment`` in both packages must see the same join kinds — a
row compare alone would pass if the port fell back to its host engine.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import test_tpch
from test_device_ops import _rows_equal
from tidb_tpu.executor import device_join as rdj
from tidb_tpu.executor import join_index as rji
from tidb_tpu.ops import device as rdev
from tidb_tpu.testkit import TestKit as RefKit
from tidb_tpu_torch import carry
from tidb_tpu_torch.executor import device_exec as texec
from tidb_tpu_torch.executor import device_join as pdj
from tidb_tpu_torch.executor import join_index as pji
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops.kernels import expr_vm, join_expand, join_probe
from tidb_tpu_torch.sqltypes import TYPE_LONGLONG, FieldType
from tidb_tpu_torch.testkit import TestKit as PortKit
from tidb_tpu_torch.utils import failpoint as tfailpoint
from tidb_tpu_torch.utils.chunk import Column as PCol
from torch_dual import isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")

I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


@pytest.fixture(autouse=True)
def _no_port_failpoint_leaks():
    yield
    leaked = tfailpoint.list_active()
    if leaked:
        tfailpoint.disable_all()
        pytest.fail(f"test leaked active port failpoints: {leaked}")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# -- K6: the host join index --------------------------------------------------

def _cols(mod_col, keys, nulls=None):
    from tidb_tpu.sqltypes import FieldType as RFT, TYPE_LONGLONG as RLL
    ft = (FieldType(tp=TYPE_LONGLONG) if mod_col is PCol
          else RFT(tp=RLL))
    return [mod_col(ft, np.asarray(k, np.int64),
                    np.zeros(len(k), bool) if nulls is None else nulls)
            for k in keys]


def _index_pair(keys, nulls=None, mask=None, **kw):
    from tidb_tpu.utils.chunk import Column as RCol
    fn = (lambda: mask) if mask is not None else None
    ref = rji.build_join_index(_cols(RCol, keys, nulls), mask_fn=fn,
                               cache_tag="m" if fn else "", **kw)
    port = pji.build_join_index(_cols(PCol, keys, nulls), mask_fn=fn,
                                cache_tag="m" if fn else "", **kw)
    return ref, port


_RNG_IDX = np.random.default_rng(11)
INDEX_CASES = {
    "dense-unique": ([_RNG_IDX.permutation(3000) + 7], None, None, {}),
    "dense-dup-filtered": ([_RNG_IDX.integers(0, 900, 3000)],
                           _RNG_IDX.random(3000) < 0.05,
                           _RNG_IDX.random(3000) < 0.7, {}),
    "sorted-composite": ([_RNG_IDX.integers(0, 10**6, 2000),
                          _RNG_IDX.integers(0, 10**5, 2000)], None, None,
                         {}),
    "forced-sorted": ([_RNG_IDX.integers(-50, 50, 500)], None, None,
                      {"force_sorted": True}),
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_build_join_index_matches_reference(case):
    keys, nulls, mask, kw = INDEX_CASES[case]
    ref, port = _index_pair(keys, nulls, mask, **kw)
    for a in ("kind", "packs", "unique", "n_rows", "n_valid", "span",
              "avg_cnt", "max_cnt", "rows_len"):
        assert getattr(port, a) == getattr(ref, a), a
    for a in ("starts", "rows", "sorted_keys"):
        r, p = getattr(ref, a), getattr(port, a)
        assert (r is None) == (p is None), a
        if r is not None:
            assert r.dtype == p.dtype and np.array_equal(r, p), a
    ra0, ra1, rnv = ref.device_arrays()
    pa0, pa1, pnv = port.device_arrays()
    assert pnv == int(rnv)
    assert np.array_equal(_np(pa0), np.asarray(ra0))
    assert np.array_equal(_np(pa1), np.asarray(ra1))


def test_index_upload_is_keyed_by_device():
    """A set_device call (which bumps the residency epoch) never hands a
    kernel a tensor uploaded for the earlier device."""
    _ref, port = _index_pair([np.arange(100)])
    first = port.device_arrays()
    assert port.device_arrays()[0] is first[0]
    tdev.set_device("cpu")
    again = port.device_arrays()
    assert again[0] is not first[0]
    assert torch.equal(again[0], first[0])


# -- K5a: pack and probe ------------------------------------------------------

def _ref_probe(kds, knulls, pvalid, packs, a0, a1, nv, layout, uniq, span):
    """The reference's _pack_probe and probe block (device_join.py:748-777),
    as JAX computes them."""
    key, ok = rdj._pack_probe([jnp.asarray(k) for k in kds],
                              [jnp.asarray(n) for n in knulls],
                              jnp.asarray(pvalid), packs)
    a0, a1 = jnp.asarray(a0), jnp.asarray(a1)
    safe_hi = max(nv - 1, 0)
    if layout == "dense":
        k_c = jnp.clip(key, 0, span - 1)
        pos0 = a0[k_c].astype(jnp.int64)
        cnt = jnp.where(ok, (a0[k_c + 1] - a0[k_c]).astype(jnp.int64), 0)
    else:
        lo = jnp.searchsorted(a0, key, side="left")
        lo_c = jnp.clip(lo, 0, a0.shape[0] - 1)
        pos0 = jnp.minimum(lo, nv).astype(jnp.int64)
        if uniq:
            cnt = jnp.where(ok & (lo < nv) & (a0[lo_c] == key), 1, 0)
        else:
            hi = jnp.searchsorted(a0, key, side="right")
            cnt = jnp.where(ok, jnp.minimum(hi, nv) - jnp.minimum(lo, nv),
                            0)
    bi = a1[jnp.clip(pos0, 0, safe_hi)].astype(jnp.int64)
    return np.asarray(pos0), np.asarray(cnt), np.asarray(bi)


@pytest.mark.parametrize("layout,mode", [("dense", "uniq"),
                                         ("dense", "count"),
                                         ("sorted", "uniq"),
                                         ("sorted", "count")])
def test_probe_matches_reference(layout, mode):
    """NULL keys, keys outside the pack range, a filtered build side
    (n_valid well under rows_len) and invalid probe rows."""
    rng = np.random.default_rng(21)
    nb, n = 1500, 4001
    if mode == "uniq":
        k0 = rng.permutation(nb) + 100
    else:
        k0 = rng.integers(100, 100 + nb // 3, nb)
    k1 = (rng.integers(0, 3, nb) if layout == "sorted"
          else np.zeros(nb, np.int64))
    build_mask = rng.random(nb) < 0.6
    if mode == "uniq":
        build_mask[:] = True
    ref, port = _index_pair([k0, k1], mask=build_mask,
                            force_sorted=layout == "sorted")
    assert port.kind == layout and port.n_valid < port.rows_len
    kds = [rng.integers(50, 200 + nb, n), rng.integers(-1, 4, n)]
    knulls = [rng.random(n) < 0.05, rng.random(n) < 0.05]
    pvalid = rng.random(n) < 0.9
    bvalid = rng.random(nb) < 0.9
    a0 = port.starts if layout == "dense" else port.sorted_keys
    pos0, cnt, bi = _ref_probe(kds, knulls, pvalid, port.packs, a0,
                               port.rows, port.n_valid, layout,
                               mode == "uniq", port.span)
    got = join_probe.probe([_t(k) for k in kds], [_t(x) for x in knulls],
                           _t(pvalid), port.packs, _t(a0), _t(port.rows),
                           port.n_valid, layout=layout, mode=mode,
                           bvalid=_t(bvalid), dense_span=port.span)
    assert cnt.sum() > 0 and (cnt == 0).any()
    # a row without a match has pos0 = bi = 0; the reference leaves both
    # at an arbitrary position
    matched = cnt > 0
    if mode == "count":
        assert np.array_equal(_np(got["pos0"]), np.where(matched, pos0, 0))
        assert np.array_equal(_np(got["cnt"]), cnt)
        assert int(got["count"]) == int(cnt.sum())
    else:
        hit = matched & bvalid[bi]
        assert np.array_equal(_np(got["bi"]), np.where(matched, bi, 0))
        assert np.array_equal(_np(got["hit"]), hit)
        assert np.array_equal(_np(got["valid"]), pvalid & hit)
        assert int(got["count"]) == int((pvalid & hit).sum())


def test_probe_sorted_keys_with_a_real_int64_max():
    """A sorted index whose last real key is int64.max, padded with
    int64.max: bounds are clamped to n_valid, so the padding is never
    counted as a match."""
    sk = np.array([-5, 3, 3, 9, I64_MAX, I64_MAX, I64_MAX, I64_MAX])
    rows = np.array([4, 0, 2, 1, 3, 0, 0, 0], dtype=np.int32)
    nv = 5
    key = np.array([I64_MAX, 3, 9, -5, 4, I64_MAX, -6])
    ok = np.array([True, True, True, True, True, False, True])
    for uniq in (True, False):
        a0 = jnp.asarray(sk)
        lo = jnp.searchsorted(a0, key, side="left")
        lo_c = jnp.clip(lo, 0, len(sk) - 1)
        if uniq:
            cnt = np.asarray(jnp.where(ok & (lo < nv) & (a0[lo_c] == key),
                                       1, 0))
        else:
            hi = jnp.searchsorted(a0, key, side="right")
            cnt = np.asarray(jnp.where(
                ok, jnp.minimum(hi, nv) - jnp.minimum(lo, nv), 0))
        pos0 = np.asarray(jnp.minimum(lo, nv))
        got = join_probe.probe([_t(key)], None, _t(ok), None, _t(sk),
                               _t(rows), nv, layout="sorted",
                               mode="uniq" if uniq else "count")
        # rows without a match: pos0 = bi = 0
        if uniq:
            assert np.array_equal(_np(got["hit"]), cnt > 0)
            assert np.array_equal(_np(got["bi"]), np.where(
                cnt > 0, rows[np.clip(pos0, 0, nv - 1)], 0))
        else:
            assert np.array_equal(_np(got["cnt"]), cnt)
            assert np.array_equal(_np(got["pos0"]),
                                  np.where(cnt > 0, pos0, 0))
    assert cnt[0] == 1  # the real int64.max key matches once, not 4 times


@pytest.mark.parametrize("n_keys,overflow", [(1, False), (2, False),
                                             (3, False), (2, True)])
def test_key_range_matches_combined_join_keys(n_keys, overflow):
    rng = np.random.default_rng(22)
    n, m = 3000, 1200
    if overflow:
        lk = [np.array([-(1 << 62), 1 << 62] * (n // 2))] * 2
        rk = [np.array([0, 1 << 61] * (m // 2))] * 2
        n, m = len(lk[0]), len(rk[0])
    else:
        lk = [rng.integers(-20, 500, n) for _ in range(n_keys)]
        rk = [rng.integers(0, 600, m) for _ in range(n_keys)]
    ln = [rng.random(n) < 0.05 for _ in lk]
    rn = [rng.random(m) < 0.05 for _ in rk]
    lv, rv = rng.random(n) < 0.9, rng.random(m) < 0.9
    want = rdj._combined_join_keys(
        [jnp.asarray(x) for x in lk], [jnp.asarray(x) for x in ln],
        jnp.asarray(lv), [jnp.asarray(x) for x in rk],
        [jnp.asarray(x) for x in rn], jnp.asarray(rv))
    got = pdj._combined_join_keys([_t(x) for x in lk], [_t(x) for x in ln],
                                  _t(lv), [_t(x) for x in rk],
                                  [_t(x) for x in rn], _t(rv))
    for w, g in zip(want, got[:5]):
        assert np.array_equal(np.asarray(w), _np(g))
    assert bool(got[4]) is overflow
    assert int(got[5]) == int(np.asarray(want[3]).sum())
    assert np.array_equal(_np(got[6]), ~np.asarray(want[3]))


# -- K5b: expansion -----------------------------------------------------------

def _expand_cases():
    rng = np.random.default_rng(23)
    nb, npr = 700, 900
    bk = rng.integers(0, 60, nb)
    bk[:5] = I64_MAX  # real int64.max keys
    pk = rng.integers(-3, 65, npr)
    pk[:7] = I64_MAX
    bv, pv = rng.random(nb) < 0.85, rng.random(npr) < 0.85
    return {
        "fits": (bk, bv, pk, pv, 1 << 15),
        "total-over-cap": (bk, bv, pk, pv, 2048),
        "all-probe-invalid": (bk, bv, pk, np.zeros(npr, bool), 1024),
        "all-build-invalid": (bk, np.zeros(nb, bool), pk, pv, 1024),
    }


EXPAND_CASES = _expand_cases()


@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_sort_join_expand_matches_reference(case):
    """The device-sort fallback (K4 order + K5a count + K5b expansion)
    against the reference's _join_expand."""
    bk, bv, pk, pv, cap = EXPAND_CASES[case]
    pi, bi, valid, total = (np.asarray(x) for x in rdj._join_expand(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), jnp.asarray(pv),
        cap))
    got = pdj._join_expand(_t(bk), _t(bv), _t(pk), _t(pv), cap, _t(~bv),
                           int(bv.sum()))
    assert int(got["total"]) == int(total)
    if case == "total-over-cap":
        assert int(total) > cap
    assert np.array_equal(_np(got["valid"]), valid)
    assert np.array_equal(_np(got["pi"])[valid], pi[valid])
    assert np.array_equal(_np(got["bi"])[valid], bi[valid])


def _ref_csr(cnt, pos0, pvalid, a1, nv, bvalid, cap, left):
    """The reference's CSR block (device_join.py:810-842), in JAX."""
    cnt, pos0 = jnp.asarray(cnt), jnp.asarray(pos0)
    pvalid, a1, bvalid = (jnp.asarray(pvalid), jnp.asarray(a1),
                          jnp.asarray(bvalid))
    n_probe = cnt.shape[0]
    safe_hi = max(nv - 1, 0)
    if left:
        cnt_eff = jnp.where(pvalid, jnp.maximum(cnt, 1), 0)
    else:
        cnt_eff = cnt
    cum = jnp.concatenate([jnp.zeros(1, dtype=jnp.int64),
                           jnp.cumsum(cnt_eff)])
    total = cum[-1]
    posn = jnp.arange(cap)
    pi = jnp.clip(jnp.searchsorted(cum, posn, side="right") - 1, 0,
                  n_probe - 1)
    within = posn - cum[pi]
    real = within < cnt[pi]
    bpos = pos0[pi] + jnp.minimum(within, jnp.maximum(cnt[pi] - 1, 0))
    bi = a1[jnp.clip(bpos, 0, safe_hi)].astype(jnp.int64)
    hit = real & bvalid[bi]
    if left:
        valid = (posn < total) & pvalid[pi]
    else:
        valid = (posn < total) & hit & pvalid[pi]
    return tuple(np.asarray(x) for x in (pi, bi, valid, ~hit, total))


@pytest.mark.parametrize("left,cap", [(False, 1 << 13), (True, 1 << 13),
                                      (False, 1000), (True, 1000)],
                         ids=["inner", "left", "inner-over-cap",
                              "left-over-cap"])
def test_csr_expand_matches_reference(left, cap):
    """The CSR expansion of a non-unique index, a left join's null
    emission (one row per unmatched probe row) and its no-match map."""
    rng = np.random.default_rng(24)
    n, nb = 1500, 2000
    cnt = np.where(rng.random(n) < 0.3, 0, rng.integers(1, 6, n))
    pvalid = rng.random(n) < 0.9
    cnt = np.where(pvalid, cnt, 0)
    pos0 = rng.integers(0, nb - 6, n)
    a1 = rng.permutation(nb).astype(np.int32)
    bvalid = rng.random(nb) < 0.9
    nv = nb - 3
    pi, bi, valid, nohit, total = _ref_csr(cnt, pos0, pvalid, a1, nv,
                                           bvalid, cap, left)
    pmap = rng.integers(0, 10**6, n)
    got = join_expand.expand(_t(cnt), _t(pos0), _t(pvalid), _t(a1), nv,
                             _t(bvalid), cap, left=left,
                             probe_maps=[_t(pmap)])
    assert int(got["total"]) == int(total)
    assert np.array_equal(_np(got["valid"]), valid)
    assert np.array_equal(_np(got["pi"])[valid], pi[valid])
    assert np.array_equal(_np(got["bi"])[valid], bi[valid])
    assert np.array_equal(_np(got["nohit"])[valid], nohit[valid])
    assert np.array_equal(_np(got["maps"][0])[valid], pmap[pi[valid]])
    if left:
        assert nohit[valid].any()  # null-extended rows were emitted


@pytest.mark.parametrize("layout", ["dense", "sorted"])
def test_left_join_probe_and_expand_match_reference(layout):
    """K5a's count probe into K5b's left expansion against the
    reference's probe and CSR blocks on the same inputs: rows with NULL,
    out-of-range and unmatched keys now carry pos0 = 0 (the reference an
    arbitrary start), and the null-extended slots they emit, like every
    matched slot, are the reference's."""
    rng = np.random.default_rng(27)
    nb, n = 1200, 3001
    k0 = rng.integers(100, 500, nb)
    ref, port = _index_pair([k0], mask=rng.random(nb) < 0.7,
                            force_sorted=layout == "sorted")
    assert port.kind == layout
    kds = [rng.integers(50, 560, n)]
    knulls = [rng.random(n) < 0.05]
    pvalid = rng.random(n) < 0.9
    bvalid = rng.random(nb) < 0.9
    a0 = port.starts if layout == "dense" else port.sorted_keys
    pos0, cnt, _bi = _ref_probe(kds, knulls, pvalid, port.packs, a0,
                                port.rows, port.n_valid, layout, False,
                                port.span)
    assert (pvalid & (cnt == 0)).any() and (pos0[cnt == 0] != 0).any()
    cap = 1 << 14
    pi, bi, valid, nohit, total = _ref_csr(cnt, pos0, pvalid, port.rows,
                                           port.n_valid, bvalid, cap, True)
    pr = join_probe.probe([_t(k) for k in kds], [_t(x) for x in knulls],
                          _t(pvalid), port.packs, _t(a0), _t(port.rows),
                          port.n_valid, layout=layout,
                          mode="count", dense_span=port.span)
    assert np.array_equal(_np(pr["cnt"]), cnt)
    assert not _np(pr["pos0"])[cnt == 0].any()
    got = join_expand.expand(pr["cnt"], pr["pos0"], _t(pvalid),
                             _t(port.rows), port.n_valid, _t(bvalid), cap,
                             left=True)
    assert int(got["total"]) == int(total)
    assert np.array_equal(_np(got["valid"]), valid)
    assert np.array_equal(_np(got["pi"])[valid], pi[valid])
    assert np.array_equal(_np(got["nohit"])[valid], nohit[valid])
    hit = valid & ~nohit
    assert np.array_equal(_np(got["bi"])[hit], bi[hit])
    assert nohit[valid].any()


@pytest.mark.parametrize("nv,sample", [(0, 4096), (1, 4096), (4096, 4096),
                                       (4097, 4096), (10_007, 3),
                                       (800_000, 4096), (800_000, 1),
                                       (6_001_215, 16_384)])
def test_sample_stride_plan(nv, sample):
    """The sorted probe's sample: at most `sample` keys, every stride-th,
    covering [0, nv) with the last segment ragged; a row then searches
    the sample and one segment of at most stride - 1 keys."""
    stride, entries = join_probe.sample_stride(nv, sample)
    assert entries <= sample and stride >= 1
    if nv:
        assert (entries - 1) * stride < nv <= entries * stride
    else:
        assert entries == 0
    if nv <= sample:
        assert stride == 1  # the whole index sits in shared memory


@pytest.mark.parametrize("n,cap,count_only,launches", [
    (0, 0, True, 1), (0, 16, False, 2), (5, 0, False, 1),
    (8192, 1024, False, 2), (8193, 1025, False, 2),
    (1_500_000, 1 << 23, False, 2), (8_388_608, 0, True, 1)])
def test_expand_launch_plan(n, cap, count_only, launches):
    """K5b's launches: the scan alone for a count (one block at least,
    which writes a total of 0 for no rows), the scan and the expansion
    for an expansion with slots; the expansion's grid-stride loop caps
    its blocks."""
    plan = join_expand.launch_plan(n, cap, count_only)
    assert plan["launches"] == launches
    assert plan["scan_blocks"] == max(-(-n // join_expand.TILE), 1)
    if launches == 2:
        assert plan["slot_tiles"] * join_expand.SLOT_TILE >= cap
        assert 1 <= plan["expand_blocks"] <= join_expand.EXPAND_BLOCKS
    else:
        assert plan["expand_blocks"] == 0


def test_compact_keeps_row_order():
    """Post-join compaction (K5b over a 0/1 mask): the kept rows in row
    order, then invalid slots, as the reference's cumsum scatter."""
    rng = np.random.default_rng(25)
    mask = rng.random(5000) < 0.3
    got = join_expand.compact(_t(mask), 2048)
    kept = np.flatnonzero(mask)
    total = len(kept)
    assert int(got["total"]) == total
    assert np.array_equal(_np(got["pi"])[:total], kept)
    assert np.array_equal(_np(got["valid"]), np.arange(2048) < total)
    assert int(join_expand.count(_t(mask))) == total


# -- K7: the standalone join match --------------------------------------------

@pytest.mark.parametrize("nulls", [False, True])
def test_device_join_match_matches_reference(nulls):
    rng = np.random.default_rng(26)
    bk = rng.integers(0, 300, 2000)
    pk = rng.integers(-10, 310, 3000)
    bk[:3] = pk[:3] = I64_MAX
    bn = (rng.random(2000) < 0.1) if nulls else np.zeros(2000, bool)
    pn = (rng.random(3000) < 0.1) if nulls else np.zeros(3000, bool)
    want = rdev.device_join_match((bk, bn), (pk, pn))
    got = tdev.device_join_match((bk, bn), (pk, pn))
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[1], np.asarray(want[1]))


def _k7_case(name):
    """Seeded (bk, bn, pk, pn) of one K7 layout case and the path the
    summary must send it down."""
    rng = np.random.default_rng(40)
    nb, np_ = 3000, 7000
    none_b, none_p = np.zeros(nb, bool), np.zeros(np_, bool)
    if name == "unique-dense":
        return (rng.permutation(nb) * 3 + 11, none_b,
                rng.integers(0, 3 * nb + 20, np_), none_p, "uniq")
    if name == "dup-dense":
        # rows of a key spread over the whole build, so any order but the
        # rows' own shows
        return (rng.integers(0, 700, nb), none_b,
                rng.integers(-3, 705, np_), none_p, "rank")
    if name == "sparse":
        bk = rng.integers(-(1 << 50), 1 << 50, nb)
        bk[::5] = bk[1::5]  # some keys twice
        pk = np.concatenate([rng.choice(bk, np_ - 500),
                             rng.integers(-(1 << 50), 1 << 50, 500)])
        return bk, none_b, pk, none_p, "sorted"
    if name == "extremes":
        ends = np.array([I64_MIN, I64_MAX, I64_MIN + 1, I64_MAX - 1, 0])
        bk = rng.choice(ends, nb)
        pk = np.concatenate([rng.choice(ends, np_ - 2), [-1, 1]])
        return bk, none_b, pk, none_p, "sorted"
    if name == "extremes-dense":
        # a span at the top of the int64 range: max - min + 1 stays exact
        bk = I64_MAX - rng.permutation(nb)
        pk = np.concatenate([I64_MAX - rng.integers(0, nb + 9, np_ - 3),
                             [I64_MIN, I64_MIN + 1, -1]])
        return bk, none_b, pk, none_p, "uniq"
    if name == "nulls":
        return (rng.integers(0, 500, nb), rng.random(nb) < 0.2,
                rng.integers(0, 500, np_), rng.random(np_) < 0.2, "rank")
    if name == "all-null-build":
        return (rng.integers(0, 500, nb), np.ones(nb, bool),
                rng.integers(0, 500, np_), none_p, "empty")
    if name == "all-null-probe":
        return (rng.integers(0, 500, nb), none_b,
                rng.integers(0, 500, np_), np.ones(np_, bool), "rank")
    if name == "empty-build":
        return (np.zeros(0, np.int64), np.zeros(0, bool),
                rng.integers(0, 500, np_), none_p, None)
    if name == "empty-probe":
        return (rng.integers(0, 500, nb), none_b, np.zeros(0, np.int64),
                np.zeros(0, bool), None)
    if name in ("rank-limit", "past-rank-limit"):
        # every key under RANK_MAX rows (the dense rank's last count), or
        # one key under one row more (the sorted layout), rows shuffled
        from tidb_tpu_torch.ops.kernels.join_match import RANK_MAX
        bk = np.repeat(np.arange(-(-nb // RANK_MAX)), RANK_MAX)[:nb]
        if name == "past-rank-limit":
            bk[-1] = bk[0]
        return (rng.permutation(bk), none_b,
                rng.integers(-2, nb // RANK_MAX + 2, np_), none_p,
                "rank" if name == "rank-limit" else "sorted")
    assert name == "hot-key"
    bk = rng.integers(0, 900, nb)
    bk[rng.random(nb) < 0.3] = 321  # ~900 rows under one key
    return bk, none_b, rng.integers(0, 900, np_), none_p, "sorted"


K7_CASES = ("unique-dense", "dup-dense", "sparse", "extremes",
            "extremes-dense", "nulls", "all-null-build", "all-null-probe",
            "empty-build", "empty-probe", "hot-key", "rank-limit",
            "past-rank-limit")


@pytest.mark.parametrize("name", K7_CASES)
def test_join_match_layouts_match_reference(name):
    """The plain K7, in each layout and path its summary picks, against
    the reference's ``device_join_match``: the same pairs in the same
    order (probe-major, each probe row's build rows in row order)."""
    from tidb_tpu_torch.ops.kernels import join_match
    bk, bn, pk, pn, path = _k7_case(name)
    bk, pk = np.asarray(bk, np.int64), np.asarray(pk, np.int64)
    want = rdev.device_join_match((bk, bn), (pk, pn)) if len(bk) and len(
        pk) else (np.zeros(0, np.int64), np.zeros(0, np.int64))
    got = tdev.device_join_match((bk, bn), (pk, pn))
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[1], np.asarray(want[1]))
    info = {}
    pi, bi = join_match.match(_t(bk), _t(bn), _t(pk), _t(~pn), info)
    assert np.array_equal(_np(pi), got[0]) and np.array_equal(_np(bi),
                                                              got[1])
    if path is not None:
        assert info["path"] == path
    if name == "all-null-probe":
        assert len(got[0]) == 0
    elif path not in ("empty", None):
        assert len(got[0]) > 0
    if path in ("rank", "sorted") and len(got[0]):
        # every probe row's build rows ascend: row order within a key
        same = got[0][1:] == got[0][:-1]
        assert same.any()
        assert np.all(got[1][1:][same] > got[1][:-1][same])


def test_join_match_plain_summary():
    """The plain summary's fields, as the card's index stage leaves them:
    min, max and count of the valid build keys, the largest count under
    one key on a dense layout (capped at RANK_MAX + 1), and K6's dense
    rule on the span."""
    from tidb_tpu_torch.ops.kernels import join_match
    bk = _t(np.array([5, 9, 5, I64_MAX, 7, 5]))
    bn = _t(np.array([False, False, False, True, False, False]))
    s = join_match.summary_plain(bk, bn, join_match.dense_limit(6))
    assert s == dict(min=5, max=9, nvalid=5, maxmult=3, dense=1)
    wide = join_match.summary_plain(_t(np.array([0, 1 << 20])),
                                    _t(np.zeros(2, bool)),
                                    join_match.dense_limit(2))
    assert wide["dense"] == 0 and wide["maxmult"] == 0
    hot = np.full(join_match.RANK_MAX + 9, 4)
    capped = join_match.summary_plain(_t(hot), _t(np.zeros(len(hot), bool)),
                                      join_match.dense_limit(len(hot)))
    assert capped["maxmult"] == join_match.RANK_MAX + 1
    assert join_match.dense_limit(2) == pji._DENSE_FLOOR
    assert join_match.dense_limit(10 ** 6) == pji._DENSE_SLACK * 10 ** 6


# -- K5a's finish, fused into the ON residual's VM launch ---------------------

def _ref_on_residual(pvalid, hit, kind):
    """The reference's ON-residual match after the residuals refined
    ``hit`` (``tidb_tpu/executor/device_join.py:791-807``): the kind's
    valid rows, the left join's null extension (no match) and the count
    it hands the capacity check."""
    pv, h = jnp.asarray(pvalid), jnp.asarray(hit)
    if kind == "semi":
        valid = pv & h
    elif kind == "anti":
        valid = pv & ~h
    else:
        valid = pv if kind == "left" else (pv & h)
    return np.asarray(valid), np.asarray(~h), int(jnp.sum(valid))


@pytest.mark.parametrize("with_pvalid", [True, False],
                         ids=["pvalid", "no-pvalid"])
@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
def test_vm_finish_matches_run_vm_and_reference(kind, with_pvalid):
    """The VM run with the finish epilogue (an ON residual's program
    refining a probe's match) against ``run_vm`` plus ``finish_plain``,
    and against the reference's ON-residual match."""
    rng = np.random.default_rng(41)
    n = 5000
    price = rng.integers(0, 10 ** 6, n)
    nation = rng.integers(0, 25, n)
    nnul = rng.random(n) < 0.1
    hit0 = rng.random(n) < 0.7
    pvalid = rng.random(n) < 0.9
    p, c = expr_vm.load(1, "i"), expr_vm.load(2, "i")
    resid = expr_vm.cmp("gt", p, expr_vm.arith(
        "mul", c, expr_vm.const(10000, "i")))
    prog = expr_vm.Program.build([expr_vm.load(0, "i"), resid], [], [])
    ins = [(_t(hit0), _t(np.zeros(n, bool))),
           (_t(price), _t(np.zeros(n, bool))), (_t(nation), _t(nnul))]
    pv = _t(pvalid) if with_pvalid else None
    cpu = torch.device("cpu")
    hit, _o, fin = expr_vm.run(prog, ins, n, n, cpu, finish=(pv, kind))
    mask, _o2 = expr_vm.run(prog, ins, n, n, cpu)
    want = join_probe.finish_plain(pv, mask, kind)
    assert torch.equal(hit, mask)
    for a, b in zip(fin, want):
        assert torch.equal(a, b)
    ref_hit = hit0 & (price > nation * 10000) & ~nnul
    assert np.array_equal(_np(hit), ref_hit)
    rv, rn, rc = _ref_on_residual(pvalid if with_pvalid else
                                  np.ones(n, bool), ref_hit, kind)
    assert np.array_equal(_np(fin[0]), rv)
    assert np.array_equal(_np(fin[1]), rn)
    assert int(fin[2]) == rc


# -- K2: LOADG ----------------------------------------------------------------

def test_loadg_matches_explicit_gather():
    rng = np.random.default_rng(27)
    n, m = 3000, 700
    price = _t(rng.integers(90000, 10_500_000, m))
    pnul = _t(rng.random(m) < 0.1)
    days = _t(rng.integers(8000, 10000, m).astype(np.int32))
    disc = _t(rng.integers(0, 11, n))
    dnul = _t(rng.random(n) < 0.1)
    idx = _t(rng.integers(0, m, n))
    ext = _t(rng.random(n) < 0.2)
    p, d, dt = (expr_vm.load(0, "i"), expr_vm.load(1, "i"),
                expr_vm.load(2, "i"))
    rev = expr_vm.arith("mul", p, expr_vm.arith(
        "sub", expr_vm.const(100, "i"), d))
    prog = expr_vm.Program.build(
        [expr_vm.cmp("lt", dt, expr_vm.const(9000, "i"))], [dt],
        [(rev, "raw"), (p, "raw")])
    gathered = [(price, pnul, idx, ext), (disc, dnul, None, None),
                (days, pnul, idx, None)]
    copies = [(price[idx], pnul[idx] | ext), (disc, dnul),
              (days[idx], pnul[idx])]
    mg, og = expr_vm.interpret(prog, gathered, n, n - 3)
    mc, oc = expr_vm.interpret(prog, copies, n, n - 3)
    assert torch.equal(mg, mc)
    for (a, an), (b, bn) in zip(og, oc):
        assert torch.equal(a, b) and torch.equal(an, bn)
    assert expr_vm.gathered_slots(gathered) == {0, 2}
    assert not expr_vm.handed_on(prog, gathered) & set(prog.key_slots)


# -- SQL: both packages on the same data --------------------------------------

class _FanOut:
    """A TestKit for test_tpch.make_tpch_tk that runs every statement in
    the reference's kit and in the port's."""

    def __init__(self):
        self.kits = (RefKit(), PortKit())

    def must_exec(self, sql):
        for tk in self.kits:
            tk.must_exec(sql)


class _Spy:
    """Records the join kinds and capacities each package's
    compile_fragment is built with."""

    def __init__(self, monkeypatch):
        self.runs = {"ref": [], "port": []}
        for mod, key in ((rdj, "ref"), (pdj, "port")):
            orig = mod.compile_fragment

            def spy(root, leaves, joins, agg_plan, agg_conds, caps, *a,
                    _o=orig, _k=key, **kw):
                self.runs[_k].append(([jn.kind for jn in joins],
                                      list(caps)))
                return _o(root, leaves, joins, agg_plan, agg_conds, caps,
                          *a, **kw)
            monkeypatch.setattr(mod, "compile_fragment", spy)

    def kinds(self, key):
        return [k for k, _c in self.runs[key]]


def _both(kits, sql, spy):
    ref, port = kits
    for tk in kits:
        tk.must_exec("set tidb_executor_engine = 'tpu'")
    want = ref.must_query(sql).rows
    got = port.must_query(sql).rows
    assert _rows_equal(got, want), f"port != reference:\n{got}\n{want}"
    assert spy.runs["port"], "the port's join fragment never ran"
    assert spy.kinds("port") == spy.kinds("ref")
    return got


@pytest.fixture(scope="module")
def tpch_kits():
    tdev.set_device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_tpch, "TestKit", _FanOut)
        fan = test_tpch.make_tpch_tk(db="tpch_join")
    return fan.kits


def _tpch_sql(name):
    src = inspect.getsource(getattr(test_tpch, name))
    return re.search(r'both\(tk, """(.*?)"""\)', src, re.S).group(1)


#: tests/test_tpch.py's queries whose plan reaches the reference's
#: compile_fragment (Q1/Q6/Q15/Q17/Q19-Q21 run no join fragment there)
TPCH_FRAGMENT_QUERIES = ["test_q02", "test_q03", "test_q04", "test_q05",
                         "test_q07", "test_q08", "test_q09", "test_q10",
                         "test_q11", "test_q12", "test_q13", "test_q14",
                         "test_q16", "test_q18", "test_q22"]


@pytest.mark.parametrize("name", TPCH_FRAGMENT_QUERIES)
def test_tpch_join_fragment_matches_reference(tpch_kits, monkeypatch, name):
    spy = _Spy(monkeypatch)
    _both(tpch_kits, _tpch_sql(name), spy)


@pytest.fixture(scope="module")
def outer_kits():
    """tests/test_device_outer_join.py's tables in both packages."""
    tdev.set_device("cpu")
    fan = _FanOut()
    fan.must_exec("use test")
    fan.must_exec("create table cust (ck bigint, cname varchar(16), "
                  "seg varchar(8))")
    fan.must_exec("create table ords (ok bigint, ck bigint, "
                  "amt decimal(10,2), cmt varchar(16))")
    rng = np.random.default_rng(21)
    fan.must_exec("insert into cust values " + ",".join(
        f"({i}, 'c{i}', 's{i % 4}')" for i in range(1, 401)))
    fan.must_exec("insert into ords values " + ",".join(
        f"({i}, {int(rng.integers(1, 260))}, "
        f"{int(rng.integers(1, 9000)) / 100:.2f}, 'm{i % 7}')"
        for i in range(1, 3001)))
    fan.must_exec("analyze table cust")
    fan.must_exec("analyze table ords")
    return fan.kits


#: tests/test_device_outer_join.py's cases: (id, SQL, kinds the fragment
#: must compile)
OUTER_CASES = [
    ("q13_shape", "select c_count, count(*) from (select cust.ck, "
     "count(ok) as c_count from cust left join ords on cust.ck = ords.ck "
     "group by cust.ck) t group by c_count order by c_count", "left"),
    ("left_on_residual", "select seg, count(ok), sum(amt) from cust left "
     "join ords on cust.ck = ords.ck and cmt like '%m2%' group by seg "
     "order by seg", "left"),
    ("left_unique_build", "select cmt, count(cname) from ords left join "
     "cust on ords.ck = cust.ck and cust.ck <= 200 group by cmt order by "
     "cmt", "left"),
    ("semi", "select cmt, count(*) from ords where exists (select 1 from "
     "cust where cust.ck = ords.ck and seg = 's1') group by cmt order by "
     "cmt", "semi"),
    ("anti", "select cmt, count(*), sum(amt) from ords where not exists "
     "(select 1 from cust where cust.ck = ords.ck) group by cmt order by "
     "cmt", "anti"),
    ("in_subquery_over_left_probe", "select seg, count(*), count(ok) from "
     "cust left join ords on cust.ck = ords.ck where cust.ck in (select "
     "ords.ck from ords group by ords.ck having sum(amt) > 50) group by "
     "seg order by seg", None),
    ("q18_shape", "select seg, count(*), sum(amt) from cust, ords where "
     "cust.ck = ords.ck and ords.ck in (select ords.ck from ords group by "
     "ords.ck having sum(amt) > 50) group by seg order by seg", "inner"),
    ("semi_over_inner_chain", "select seg, count(*) from cust, ords o1 "
     "where cust.ck = o1.ck and exists (select 1 from ords o2 where o2.ck "
     "= cust.ck and o2.cmt = 'm1') group by seg order by seg", "semi"),
]


@pytest.mark.parametrize("case", OUTER_CASES, ids=[c[0] for c in OUTER_CASES])
def test_outer_semi_anti_match_reference(outer_kits, monkeypatch, case):
    _id, sql, kind = case
    spy = _Spy(monkeypatch)
    ref, port = outer_kits
    for tk in outer_kits:
        tk.must_exec("set tidb_executor_engine = 'tpu'")
    want = ref.must_query(sql).rows
    got = port.must_query(sql).rows
    assert _rows_equal(got, want)
    assert spy.kinds("port") == spy.kinds("ref")
    if kind is None:
        # the reference declines this shape (a membership over a
        # non-inner probe): the port must decline it the same way
        assert not spy.runs["port"] and len(got) > 0
    else:
        assert any(kind in k for k in spy.kinds("port"))


def test_expansion_capacity_retry_matches_reference(outer_kits,
                                                    monkeypatch):
    """A non-unique expansion whose first capacity (probe bucket x average
    matches x 1.5) is far too small — every probe row hits the one hot
    key: the retry reruns at the exact total, with the same capacities as
    the reference, and the learned total is the reference's."""
    fan = _FanOut()
    fan.kits = outer_kits
    fan.must_exec("create table hot_b (k bigint, v bigint)")
    fan.must_exec("create table hot_p (k bigint, g bigint)")
    fan.must_exec("insert into hot_b values " + ",".join(
        f"({7 if i < 3000 else 10 + i}, {i})" for i in range(6000)))
    fan.must_exec("insert into hot_p values " + ",".join(
        f"(7, {i % 5})" for i in range(300)))
    spy = _Spy(monkeypatch)
    sql = ("select g, count(*), sum(v) from hot_p join hot_b on "
           "hot_p.k = hot_b.k group by g order by g")
    got = _both(outer_kits, sql, spy)
    assert got[0][1] == str(60 * 3000)
    caps = [c for _k, c in spy.runs["port"]]
    assert caps == [c for _k, c in spy.runs["ref"]]
    assert len(caps) >= 2 and caps[-1][0] >= 300 * 3000 > caps[0][0]
    learned = {k: v for k, v in pdj._CAP_STORE.items()
               if isinstance(k[1], int)}
    assert 300 * 3000 in learned.values()


def test_hash_join_without_aggregate_runs_device_match(outer_kits,
                                                       monkeypatch):
    """A HashJoin with no aggregate over it matches through
    device_join_keys (K7) in the port, with the reference's rows."""
    calls = []
    orig = texec.device_join_keys

    def spy(lkeys, rkeys):
        calls.append(len(lkeys))
        return orig(lkeys, rkeys)
    monkeypatch.setattr(texec, "device_join_keys", spy)
    sql = ("select cust.ck, cname, ok, amt from cust join ords on "
           "cust.ck = ords.ck where amt > 80 order by ok")
    ref, port = outer_kits
    for tk in outer_kits:
        tk.must_exec("set tidb_executor_engine = 'tpu'")
    want = ref.must_query(sql).rows
    got = port.must_query(sql).rows
    assert got == want and len(got) > 0
    assert calls


@pytest.fixture(scope="module")
def bench_kits():
    """bench.py gen_all's eight tables at SF 0.001 in the reference, and
    carry.gen_tpch's in the port."""
    tdev.set_device("cpu")
    ref = RefKit()
    bench.gen_all(ref, 0.001)
    port = PortKit()
    carry.install_tpch(port.must_exec, port.domain, "tpch",
                       carry.gen_tpch(0.001))
    return ref, port


@pytest.mark.parametrize("table", carry.TPCH_TABLES)
def test_gen_tpch_matches_bench_gen_all(bench_kits, table):
    ref, port = bench_kits
    sql = f"select * from {table}"
    want = ref.must_query(sql).rows
    got = port.must_query(sql).rows
    assert len(got) > 0 and got == want


@pytest.mark.parametrize("paged", [False, True])
def test_paged_gate_matches_reference(bench_kits, monkeypatch, paged):
    """The reference pages a probe longer than max(_PAGED_MIN_ROWS,
    4 x tidb_device_stream_rows); the port pages exactly there (its paged
    probe, tests/test_torch_paged.py) and runs the resident fragment
    below it."""
    ref, port = bench_kits
    n_line = 6001
    monkeypatch.setattr(rdj, "_PAGED_MIN_ROWS", n_line - 1 if paged
                        else n_line)
    monkeypatch.setattr(pdj, "_PAGED_MIN_ROWS", n_line - 1 if paged
                        else n_line)
    paged_runs = {"ref": [], "port": []}
    for mod, key in ((rdj, "ref"), (pdj, "port")):
        orig = mod._paged_join_agg

        def paged_spy(*a, _o=orig, _k=key, **kw):
            paged_runs[_k].append(1)
            return _o(*a, **kw)
        monkeypatch.setattr(mod, "_paged_join_agg", paged_spy)
    spy = _Spy(monkeypatch)
    for tk in (ref, port):
        tk.must_exec("set tidb_executor_engine = 'tpu'")
        tk.must_exec("set tidb_device_stream_rows = 1000")
    try:
        sql = bench.QUERIES["q3"]
        want = ref.must_query(sql).rows
        got = port.must_query(sql).rows
    finally:
        for tk in (ref, port):
            tk.must_exec("set tidb_device_stream_rows = 0")
    assert _rows_equal(got, want)
    assert bool(paged_runs["ref"]) is paged
    assert bool(paged_runs["port"]) is paged
    assert spy.runs["port"]


def test_post_join_compaction_matches_reference(monkeypatch):
    """A fragment longer than 65536 rows whose kept rows are few: the
    second attempt compacts them (K5b over the 0/1 mask) before the
    aggregate, in both packages, with the same capacities and rows."""
    ref, port = RefKit(), PortKit()
    bench.gen_all(ref, 0.012)
    carry.install_tpch(port.must_exec, port.domain, "tpch",
                       carry.gen_tpch(0.012))
    compacted = {"ref": [], "port": []}
    for mod, key in ((rdj, "ref"), (pdj, "port")):
        orig = mod.compile_fragment

        def spy(*a, _o=orig, _k=key, **kw):
            compacted[_k].append(kw.get("compact_cap"))
            return _o(*a, **kw)
        monkeypatch.setattr(mod, "compile_fragment", spy)
    for tk in (ref, port):
        tk.must_exec("set tidb_executor_engine = 'tpu'")
    sql = bench.QUERIES["q3"]
    want = ref.must_query(sql).rows
    got = port.must_query(sql).rows
    assert _rows_equal(got, want) and len(got) == 10
    assert compacted["port"] == compacted["ref"]
    assert any(c is not None for c in compacted["port"])


def test_host_index_join_reads_bulk_inner_rows():
    """bench.py's Q9 on bulk-loaded ``gen_tpch(0.05)`` tables, the port's
    HOST engine, no hint: the plan's index joins (``inner:handle`` on
    orders and part) read the inner rows where the bulk loader put them,
    so the rows equal the ``HASH_JOIN``-hinted rows — 175.  The reference
    seeks its KV store there and returns none (a stated divergence,
    ROADMAP queue 3)."""
    tdev.set_device("cpu")
    port = PortKit()
    carry.install_tpch(port.must_exec, port.domain, "tpch",
                       carry.gen_tpch(0.05))
    port.must_exec("set tidb_executor_engine = 'host'")
    q9 = bench.QUERIES["q9"]
    hinted = q9.replace("from (select n_name",
                        "from (select /*+ HASH_JOIN(part, orders) */ n_name")
    assert hinted != q9
    plan = port.must_query("explain " + q9).rows
    assert any("IndexJoin" in str(c) for r in plan for c in r), plan
    want = port.must_query(hinted).rows
    assert len(want) == 175
    assert port.must_query(q9).rows == want
