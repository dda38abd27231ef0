"""K4's packed composite key (tidb_tpu_torch/ops/kernels/sort_topk.py) on
the CPU: the layout of ``pack_layout`` over the key statistics, packed by
``pack_words_plain`` and sorted one word at a time, least significant
first, with a stable ``torch.sort`` (``_lsd_order``), must give
exactly the order of ``sort_plain`` and of the reference: ``tidb_tpu.
executor.device_exec._topk_indices`` (jnp.lexsort) on JAX's CPU, and the
window's ``np.lexsort`` key list (tests/test_torch_window.py
``_lexsort_order``) with each key's null rank.  One stated divergence:
XLA's CPU backend flushes subnormal doubles to zero when it sorts, so
there the reference is held to the packed order of the flushed keys.

The CUDA radix sort packs the same words from the same layout and runs
the same passes; tests/test_torch_cuda.py holds it to ``sort_plain`` on a
card.  Every comparison is exact (an order has no tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tidb_tpu.executor import device_exec as jexec
from tidb_tpu_torch.ops.kernels import sort_topk

I64 = np.iinfo(np.int64)
FLOAT_SPECIALS = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5,
                           -2.25, 5e-324, -1e308, 1e308])


def _lsd_order(words, n):
    """Slot indices in the order of the composite key: one stable sort per
    word (as unsigned), least significant word first."""
    order = torch.arange(n)
    for w in words:
        key = (w ^ (-1 << 63))[order]
        order = order[torch.sort(key, stable=True).indices]
    return order


def _packed(cols, nulls, descs, nfs, n, ng):
    """The layout, and the order of its words sorted minor word first."""
    tc = [torch.from_numpy(np.ascontiguousarray(c)) for c in cols]
    tn = [torch.from_numpy(np.ascontiguousarray(m)) for m in nulls]
    layout = sort_topk.pack_layout(
        *sort_topk.key_stats_plain(tc, tn, descs, n), n, ng)
    words = sort_topk.pack_words_plain(tc, tn, descs, nfs, n, ng, layout)
    assert len(words) == layout.words
    return layout, _lsd_order(words, n).numpy(), (tc, tn)


def _np_lexsort(cols, nulls, descs, nfs, n, ng):
    """tests/test_torch_window.py's lexsort key list, with each key's null
    rank taken from its nulls_first flag."""
    lex = []
    for d, nl, desc, nf in reversed(list(zip(cols, nulls, descs, nfs))):
        if d.dtype.kind == "f":
            v = -d if desc else d
        else:
            v = ~d if desc else d
        lex.append(np.where(nl, 0, v))
        lex.append(np.where(nl, 0 if nf else 1, 1 if nf else 0))
    lex.append(~(np.arange(n) < ng))
    return np.lexsort(lex)


def _jax_topk(cols, nulls, descs, n, ng):
    """The reference's top-k over every slot (its null rank: NULLs first
    ascending, last descending)."""
    specs = tuple(("key", j, d) for j, d in enumerate(descs))
    return np.asarray(jexec._topk_indices(
        tuple(jnp.asarray(c) for c in cols),
        tuple(jnp.asarray(m) for m in nulls), (), (), ng, n, specs, n))


# -- the listed edge cases ------------------------------------------------------

def _case(name, rng):
    """(cols, nulls, descs, n) of one edge case; numpy, seeded."""
    def nul(n, p=0.1):
        return rng.random(n) < p

    if name == "int64-extremes":
        n = 1000
        vals = np.array([I64.min, I64.max, I64.min + 1, I64.max - 1, 0, -1,
                         1], dtype=np.int64)
        cols = [rng.choice(vals, n), rng.integers(0, 3, n)]
        return cols, [nul(n), nul(n)], [True, False], n
    if name == "float-specials-asc":
        n = 777
        cols = [rng.choice(FLOAT_SPECIALS, n), rng.integers(-2, 2, n)]
        return cols, [nul(n), nul(n, 0.0)], [False, True], n
    if name == "float-specials-desc":
        n = 777
        cols = [rng.choice(FLOAT_SPECIALS, n), rng.choice(FLOAT_SPECIALS, n)]
        return cols, [nul(n), nul(n, 0.3)], [True, True], n
    if name == "one-distinct-value":
        n = 513
        cols = [np.full(n, 42, dtype=np.int64), rng.integers(0, 5, n),
                np.full(n, -3.5)]
        return cols, [nul(n, 0.0), nul(n), nul(n, 0.0)], [False, True,
                                                          True], n
    if name == "all-null-key":
        n = 300
        cols = [rng.integers(0, 9, n), rng.standard_normal(n)]
        return cols, [nul(n, 1.0), nul(n)], [False, False], n
    if name == "composite-64-bits":
        # one int key over the whole int64 range, no NULLs: 64 bits
        n = 1000
        c = rng.integers(I64.min, I64.max, n, endpoint=True)
        c[:2] = I64.min, I64.max
        return [c], [nul(n, 0.0)], [False], n
    if name == "composite-65-bits":
        n = 1000
        c = rng.integers(I64.min, I64.max, n, endpoint=True)
        c[:2] = I64.min, I64.max
        return [c], [nul(n, 0.2)], [True], n
    if name == "sixteen-keys":
        n = 999
        cols = [rng.integers(-(1 << s), 1 << s, n) for s in range(8)] + \
            [np.round(rng.standard_normal(n), 1) for _ in range(8)]
        return (cols, [nul(n, 0.05 * (j % 3)) for j in range(16)],
                [bool(j % 2) for j in range(16)], n)
    raise AssertionError(name)


CASES = ["int64-extremes", "float-specials-asc", "float-specials-desc",
         "one-distinct-value", "all-null-key", "composite-64-bits",
         "composite-65-bits", "sixteen-keys"]


@pytest.mark.parametrize("nulls_rule", ["reference", "flipped"])
@pytest.mark.parametrize("ng_at", ["zero", "mid", "all"])
@pytest.mark.parametrize("case", CASES)
def test_packed_order_is_the_reference(case, ng_at, nulls_rule):
    """Each edge case, with no slot live, some and all, under the
    reference's null rank (NULLs first ascending, last descending: the
    top-k's and the window's) and under the other (the join's and the
    group order's NULLs-last ascending)."""
    rng = np.random.default_rng(CASES.index(case))
    cols, nulls, descs, n = _case(case, rng)
    ng = {"zero": 0, "mid": n // 3, "all": n}[ng_at]
    nfs = [(not d) if nulls_rule == "reference" else d for d in descs]
    layout, got, (tc, tn) = _packed(cols, nulls, descs, nfs, n, ng)
    want = sort_topk.sort_plain(tc, tn, descs, nfs, n, ng).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _np_lexsort(cols, nulls, descs, nfs,
                                                   n, ng))
    if nulls_rule == "reference":
        # XLA's CPU backend flushes subnormal doubles to zero when it
        # compares, so the reference's order is the packed order of the
        # same keys with subnormals flushed (equal to `got` where the keys
        # hold none); the port orders subnormals by value, as torch.sort
        # and np.lexsort do (ROADMAP queue 3)
        flushed = [np.where(np.abs(c) < np.finfo(np.float64).tiny, 0.0, c)
                   if c.dtype.kind == "f" else c for c in cols]
        _l, want_ref, _t = _packed(flushed, nulls, descs, nfs, n, ng)
        np.testing.assert_array_equal(want_ref, _jax_topk(cols, nulls,
                                                          descs, n, ng))
        if all(np.array_equal(a, b, equal_nan=True) for a, b in zip(
                cols, flushed)):
            np.testing.assert_array_equal(got, want_ref)
    major = 1 if 0 < ng < n else 0
    assert layout.major[1] == major
    if case == "composite-64-bits":
        assert layout.bits == 64 + major and layout.words == 1 + major
    if case == "composite-65-bits":
        assert layout.bits == 65 + major and layout.words == 2
    if case == "one-distinct-value":
        assert layout.keys[0][1] == layout.keys[0][3] == 0
        assert layout.keys[2][1] == layout.keys[2][3] == 0
    if case == "all-null-key":
        assert layout.keys[0][1] == layout.keys[0][3] == 0


def test_layout_fields_most_significant_first():
    """The major rank sits above key 0's null rank, which sits above key
    0's value, and so on down to the last key's value at bit 0; a field
    may straddle two words."""
    layout = sort_topk.pack_layout([0, 5], [(1 << 60) - 1, 5 + 1000],
                                   [3, 0], 100, 50)
    (n0, nb0, v0, vb0, lo0), (n1, nb1, v1, vb1, lo1) = layout.keys
    assert (v1, vb1, nb1, lo1) == (0, 10, 0, 5)
    assert (v0, vb0, n0, nb0) == (10, 60, 70, 1)
    assert layout.major == (71, 1)
    assert (layout.bits, layout.words, layout.digits) == (72, 2, (8, 1))
    assert layout.word_bits() == (64, 8)


def test_pack_words_places_straddling_field():
    """A 60-bit value at bit 10 puts its low 54 bits in word 0 and its
    high 6 bits at the bottom of word 1."""
    v = (1 << 59) + (1 << 53) + 7
    # the least order key is 2^63, int 0's: each value's offset is itself
    layout = sort_topk.Layout(((10, 0, 10, 60, 1 << 63),), (70, 0), 70, 2,
                              (8, 1))
    col = torch.tensor([v], dtype=torch.int64)
    words = sort_topk.pack_words_plain([col], [torch.tensor([False])],
                                       [False], [False], 1, 1, layout)
    low = (v << 10) & ((1 << 64) - 1)
    assert int(words[0][0]) == sort_topk._i64(low)
    assert int(words[1][0]) == v >> 54


# -- drawn cases -----------------------------------------------------------------

@st.composite
def _drawn(draw):
    n = draw(st.integers(1, 200))
    ng = draw(st.integers(0, n))
    s = draw(st.integers(1, 5))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    kinds = draw(st.lists(st.sampled_from(["small", "wide", "float",
                                           "specials", "const"]),
                          min_size=s, max_size=s))
    p_null = draw(st.lists(st.sampled_from([0.0, 0.2, 1.0]), min_size=s,
                           max_size=s))
    descs = draw(st.lists(st.booleans(), min_size=s, max_size=s))
    nfs = draw(st.lists(st.booleans(), min_size=s, max_size=s))
    return n, ng, seed, kinds, p_null, descs, nfs


@settings(max_examples=80, deadline=None)
@given(_drawn())
def test_packed_order_drawn(spec):
    """Drawn mixes of key kinds, NULL shares, directions and null ranks:
    the packed order equals sort_plain's and the lexsort key list's."""
    n, ng, seed, kinds, p_null, descs, nfs = spec
    rng = np.random.default_rng(seed)
    make = {"small": lambda: rng.integers(-4, 4, n),
            "wide": lambda: rng.integers(I64.min, I64.max, n),
            "float": lambda: np.round(rng.standard_normal(n), 1),
            "specials": lambda: rng.choice(FLOAT_SPECIALS, n),
            "const": lambda: np.full(n, 7, dtype=np.int64)}
    cols = [make[k]() for k in kinds]
    nulls = [rng.random(n) < p for p in p_null]
    _layout, got, (tc, tn) = _packed(cols, nulls, descs, nfs, n, ng)
    np.testing.assert_array_equal(
        got, sort_topk.sort_plain(tc, tn, descs, nfs, n, ng).numpy())
    np.testing.assert_array_equal(got, _np_lexsort(cols, nulls, descs, nfs,
                                                   n, ng))
