"""The K8/K9 fold's plan on the CPU (tidb_tpu_torch/ops/kernels/
merge_states.py): the tile plan of csrc/merge_states.cu ``ms_bounds``
mirrored in numpy against a brute-force rank, the launches a fold makes,
the header and part table the kernel reads, and the invariant the merge
of sorted runs rests on, held to the JAX reference.  The kernel itself
runs only on a card (tests/test_torch_cuda.py, chip_smoke.py); its plain
version is held to the reference in tests/test_torch_stream.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.ops import device as jdev
from tidb_tpu_torch.executor import device_exec as pexec
from tidb_tpu_torch.ops.kernels import groupby_agg
from tidb_tpu_torch.ops.kernels import merge_states as ms

PACK = ((7, 0), (3, 0))
OPS = ("sum_i", "sum_f", "min", "max", "first", "count")
MERGE_OPS = ("sum_i", "sum_f", "min", "max", "first", "sum_i")


def _rows(rng, n, key_hi=60, null_p=0.1):
    """Seeded rows of two keys (the first sometimes NULL) and a value per
    op, as numpy."""
    keys = (rng.integers(0, key_hi, n), rng.integers(0, 3, n))
    knulls = (rng.random(n) < null_p, np.zeros(n, bool))
    vi = rng.integers(-10**6, 10**6, n)
    vf = rng.standard_normal(n)
    vals = (vi, vf, vi, vf, vi, vi)
    vnulls = (rng.random(n) < 0.1,) * len(OPS)
    return keys, knulls, vals, vnulls, rng.random(n) < 0.9


def _t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _k1_plain(rows, pack, cap=256):
    keys, knulls, vals, vnulls, mask = rows
    return groupby_agg.groupby_plain(_t(keys), _t(knulls), _t(vals),
                                     _t(vnulls), torch.from_numpy(mask), 2,
                                     OPS, cap, pack)


def _live_words(state, pack):
    """The order words of a state's live slots."""
    n = min(int(state[4]), int(state[0][0].shape[0]))
    return ms.order_words([np.asarray(k)[:n] for k in state[0]],
                          [np.asarray(k)[:n] for k in state[1]], pack)


def _ascending(words):
    """Rows strictly ascending in word order (distinct keys)."""
    rows = [tuple(int(x) for x in r) for r in words]
    return all(a < b for a, b in zip(rows, rows[1:]))


# -- the tile plan ---------------------------------------------------------------

def _parts(shape, rng):
    """Each part's order words (sorted, distinct within the part) for one
    shape of fold; W is 1 or 4 words a row."""
    def part(vals):
        v = np.asarray(vals, dtype=np.uint64)
        if not v.size:
            return np.zeros((0, 1), np.uint64)
        return np.unique(v.reshape(len(v), -1), axis=0)

    if shape == "random":
        return [part(rng.integers(0, 500, rng.integers(0, 200)))
                for _ in range(9)]
    if shape == "skewed":  # one part holds nearly every row
        return ([part(rng.integers(0, 5000, 3000))]
                + [part(rng.integers(0, 5000, 3)) for _ in range(7)])
    if shape == "disjoint":
        return [part(rng.integers(1000 * p, 1000 * p + 600, 300))
                for p in (4, 0, 3, 1, 2)]
    if shape == "same_keys":  # every part holds the same keys: P copies
        keys = rng.choice(10_000, 400, replace=False)
        return [part(keys) for _ in range(12)]
    if shape == "hot_and_empty":  # empty parts and one key everywhere
        return [part([7]) if p % 2 else part([]) for p in range(20)]
    if shape == "full_range":  # words across the whole 64-bit range
        return [part(rng.integers(0, 2**64 - 1, 100, dtype=np.uint64))
                for _ in range(6)]
    if shape == "tuples":  # four words a row: two keys' NULL flags, values
        out = []
        for _p in range(7):
            n = int(rng.integers(0, 150))
            nl = rng.random((n, 2)) < 0.2
            v = np.where(nl, 0, rng.integers(0, 4, (n, 2)))
            w = np.stack([nl[:, 0], v[:, 0], nl[:, 1], v[:, 1]], 1)
            out.append(np.unique(w.astype(np.uint64), axis=0) if n else
                       np.zeros((0, 4), np.uint64))
        return out
    if shape == "thirty_two":  # a launch's most parts
        return [part(rng.integers(0, 3000, rng.integers(0, 120)))
                for _ in range(32)]
    raise ValueError(shape)


def _brute_order(words):
    """(key, part, row) of every live row in the stable merge's order."""
    rows = [(tuple(int(x) for x in wd[i]), p, i)
            for p, wd in enumerate(words) for i in range(len(wd))]
    return sorted(rows)


SHAPES = ["random", "skewed", "disjoint", "same_keys", "hot_and_empty",
          "full_range", "tuples", "thirty_two"]


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_plan_against_brute_force_rank(shape, tile):
    """Tiles cut at key boundaries: each key's copies fall in one tile, no
    tile passes T + P - 1 rows, each boundary lies within P - 1 rows below
    its rank t T, and the tiles cover every live row once (T >= P, as
    every tile size merge_states.tile_rows gives is)."""
    rng = np.random.default_rng(len(shape) * 7 + tile)
    words = _parts(shape, rng)
    P = len(words)
    live = np.array([len(w) for w in words])
    n = int(live.sum())
    bounds = ms.tile_bounds(words, tile)
    order = _brute_order(words)
    assert (bounds[0] == 0).all() and (bounds[-1] == live).all()
    tile_of = {}
    for t in range(len(bounds) - 1):
        lo, hi = bounds[t], bounds[t + 1]
        assert (hi >= lo).all()
        assert int((hi - lo).sum()) <= tile + P - 1
        r = t * tile
        if 0 < r < n:
            assert r - (P - 1) <= int(lo.sum()) <= r
        for p in range(P):
            for i in range(lo[p], hi[p]):
                assert (p, i) not in tile_of
                tile_of[(p, i)] = t
    assert len(tile_of) == n
    # the boundary is the brute-force rank of the key it cuts at
    for t in range(1, len(bounds) - 1):
        cut = int(bounds[t].sum())
        if 0 < cut < n:
            assert order[cut - 1][0] < order[cut][0]
    for key_rows in _group_by_key(order):
        assert len({tile_of[(p, i)] for p, i in key_rows}) == 1


def _group_by_key(order):
    out, cur, last = [], [], None
    for key, p, i in order:
        if key != last and cur:
            out.append(cur)
            cur = []
        cur.append((p, i))
        last = key
    if cur:
        out.append(cur)
    return out


@pytest.mark.parametrize("pack", [PACK, None], ids=["pack", "no_pack"])
@pytest.mark.parametrize("n_parts", [1, 9, 40])
def test_tile_plan_of_k1_states(pack, n_parts):
    """The plan over K1 states' own order words (both orders): boundaries
    at key boundaries, tiles within T + P - 1 rows."""
    rng = np.random.default_rng(n_parts)
    words = [_live_words(_k1_plain(_rows(rng, 300), pack), pack)
             for _ in range(min(n_parts, ms.MAX_PARTS))]
    bounds = ms.tile_bounds(words, 32)
    P = len(words)
    for t in range(len(bounds) - 1):
        assert int((bounds[t + 1] - bounds[t]).sum()) <= 32 + P - 1
        left = [tuple(words[p][bounds[t + 1][p] - 1]) for p in range(P)
                if bounds[t + 1][p] > 0]
        right = [tuple(words[p][bounds[t + 1][p]]) for p in range(P)
                 if bounds[t + 1][p] < len(words[p])]
        if left and right:
            assert max(left) < min(right)


# -- the launch plan, the tile size, the header ---------------------------------

@pytest.mark.parametrize("w", range(1, 2 * ms.MAX_KEYS + 1))
def test_tile_rows_fit_shared_memory(w):
    t = ms.tile_rows(w)
    assert t & (t - 1) == 0 and t >= 256
    assert w * (t + 32) <= ms.TILE_WORDS
    assert t == ms.MAX_TILE or w * (2 * t + 32) > ms.TILE_WORDS


@pytest.mark.parametrize("caps, n_keys, pack, want", [
    # Q1 at SF10: 15 block states of 4,096 slots, 30 tiles searched in
    # the merge's blocks
    ([4096] * 15, 2, PACK, 1),
    # Q18's subquery fold: the running state and 8 blocks, many tiles
    ([1 << 24] + [1 << 22] * 8, 1, ((26, -1),), 2),
    # one part, one tile
    ([64], 1, None, 1),
    # 40 small parts: groups of 32 and 8, then the fold of the two
    ([16] * 40, 2, PACK, 3),
    # 70 parts of 2,000 slots (8 keys, no pack: tiles of 512 rows): groups
    # of 32, 32 and 6 parts (125, 125 and 24 tiles), then their fold (274)
    ([2000] * 70, 8, None, 2 + 2 + 1 + 2),
])
def test_launch_plan(caps, n_keys, pack, want):
    assert ms.launch_plan(caps, 1 << 10, n_keys, pack) == want


def test_fold_groups_cover_parts_in_order():
    for n in (1, 31, 32, 33, 64, 65, 1000):
        groups = ms.fold_groups(n)
        assert [i for g in groups for i in g] == list(range(n))
        assert all(1 <= len(g) <= ms.MAX_PARTS for g in groups)


def test_part_table_and_header():
    """The table's rows and the header's words as ms_fold_run reads them;
    the widest 32 parts fill the large parameter block exactly."""
    parts = [_k1_plain(_rows(np.random.default_rng(p), 50), PACK)
             for p in range(3)]
    parts = [(*st[:4], st[4], st[5]) for st in parts]
    tab = ms.pack_table(parts, 2, MERGE_OPS)
    m = len(OPS)
    assert tab.shape == (3, 2 + 2 * 2 + 2 * m)
    for row, st in zip(tab, parts):
        assert row[0] == st[4].data_ptr() and row[1] == 256
        assert row[2] == st[0][0].data_ptr() and row[4] == st[1][0].data_ptr()
        assert row[6] == st[2][0].data_ptr()
        assert row[6 + m] == st[3][0].data_ptr()
    hdr = ms.pack_header(3, 2, MERGE_OPS, [0, 1, 0, 1, 0, 0], 512, PACK, 4,
                         1000, 2000, 3000, [1, 2, 3, 4, 5], 9, 7)
    w = ms.n_words(2, PACK)
    tile = ms.tile_rows(w)
    assert list(hdr[:10]) == [3, 2, 6, 1, 1, 18, tile, tile + 32, 512, 4]
    assert list(hdr[10:19]) == [1000, 2000, 3000, 1, 2, 3, 4, 5, 9]
    assert hdr[21] == 7
    tab_bytes = -(-3 * 18 * 8 // 16) * 16
    assert hdr[19] == (tab_bytes + max(w * (tile + 32) * 8, 6 * ms.SPAN)
                       + (tile + 32) * 8)
    assert list(hdr[24:26]) == [7, 3] and list(hdr[40:46]) == [1, 2, 3, 4,
                                                                 5, 1]
    assert list(hdr[72:78]) == [0, 1, 0, 1, 0, 0]
    # the parameter block: the 488-byte header and TABLE_WORDS, 4 KB; Q18's
    # and Q1's tables fit it, 32 parts of the widest state are staged
    assert 488 + 8 * ms.TABLE_WORDS <= 4096
    assert 9 * (2 + 2 + 2) <= ms.TABLE_WORDS
    assert 15 * (2 + 2 * 2 + 2 * 8) <= ms.TABLE_WORDS
    assert ms.MAX_PARTS * (2 + 2 * ms.MAX_KEYS + 2 * ms.MAX_AGGS) == \
        ms.MAX_TABLE_WORDS > ms.TABLE_WORDS


def test_read_groups_raises_on_the_fault_word():
    st = _k1_plain(_rows(np.random.default_rng(3), 40), PACK)
    assert ms.read_groups(st) == int(st[4])
    for fault, raises in ((0, False), (1, True)):
        status = torch.tensor([5, fault], dtype=torch.int64)
        out = ms.FoldState((*st[:4], status[0], st[5]))
        out.status = status
        assert int(ms.fault_word(out)) == fault
        if raises:
            with pytest.raises(ms.FoldOrderError):
                ms.read_groups(out)
        else:
            assert ms.read_groups(out) == 5


def test_unsupported_ops_are_refused_on_the_device():
    from tidb_tpu_torch.ops.device import DeviceUnsupported
    st = _k1_plain(_rows(np.random.default_rng(4), 40), PACK)
    with pytest.raises(DeviceUnsupported):
        ms.pack_table([st], 2, ("count",) * len(OPS))


# -- the invariant: every part is already in the fold's order ------------------

def test_order_words_match_the_packed_key():
    """With a pack the one word is K1's packed key, biased: its order is
    the packed key's signed order, NULL packed to 0."""
    rng = np.random.default_rng(5)
    keys, knulls = (rng.integers(-3, 100, 500), rng.integers(0, 5, 500)), \
        (rng.random(500) < 0.2, rng.random(500) < 0.2)
    pack = ((8, 3), (3, 0))
    words = ms.order_words(keys, knulls, pack)[:, 0]
    packed = groupby_agg._packed(_t(keys), _t(knulls), pack).numpy()
    np.testing.assert_array_equal(words ^ np.uint64(1 << 63),
                                  packed.view(np.uint64))
    np.testing.assert_array_equal(np.argsort(words, kind="stable"),
                                  np.argsort(packed, kind="stable"))


@pytest.mark.parametrize("pack", [PACK, None], ids=["pack", "no_pack"])
def test_k1_states_are_in_the_fold_order(pack):
    """K1's plain output lists its groups in the fold's order, and that
    order is the JAX reference's (_agg_impl) on the same rows: keys, NULL
    flags and group counts slot for slot."""
    rng = np.random.default_rng(6)
    for _ in range(5):
        rows = _rows(rng, 400)
        port = _k1_plain(rows, pack)
        assert _ascending(_live_words(port, pack))
        keys, knulls, vals, vnulls, mask = rows
        ref = jdev._agg_kernel(
            tuple(jnp.asarray(k) for k in keys),
            tuple(jnp.asarray(k) for k in knulls),
            tuple(jnp.asarray(v) for v in vals),
            tuple(jnp.asarray(v) for v in vnulls), jnp.asarray(mask),
            n_keys=2, agg_ops=OPS, capacity=256, pack=pack)
        ng = int(ref[4])
        assert int(port[4]) == ng
        for a, b, an, bn in zip(ref[0], port[0], ref[1], port[1]):
            an = np.asarray(an)[:ng]
            np.testing.assert_array_equal(an, bn.numpy()[:ng])
            np.testing.assert_array_equal(np.asarray(a)[:ng][~an],
                                          b.numpy()[:ng][~an])


@pytest.mark.parametrize("pack", [PACK, None], ids=["pack", "no_pack"])
def test_folds_are_in_the_fold_order(pack):
    """A fold's own output (merge_plain) is in the order it reads, so a
    running state folds again; the merged order is the stable merge of
    the parts' runs."""
    rng = np.random.default_rng(7)
    parts = [_k1_plain(_rows(rng, 300), pack) for _ in range(6)]
    out = ms.merge_plain(parts, 2, MERGE_OPS, 512, pack)
    words = _live_words(out, pack)
    assert _ascending(words)
    merged = sorted({tuple(int(x) for x in r) for st in parts
                     for r in _live_words(st, pack)})
    assert [tuple(int(x) for x in r) for r in words] == merged
    again = ms.merge_plain([out] + parts[:2], 2, MERGE_OPS, 512, pack)
    assert _ascending(_live_words(again, pack))


def test_host_fold_upload_is_in_the_fold_order():
    """The hybrid join's host half (_merge_states_host) packs and sorts
    exactly like K1, so its upload is a part in the fold's order."""
    rng = np.random.default_rng(8)
    pages = []
    for _ in range(4):
        keys, knulls, vals, vnulls, mask = _rows(rng, 200)
        pages.append(pexec.page_singleton_state(
            keys, knulls, vals[:5], vnulls[:5], mask,
            ("sum_i", "sum_f", "min", "max", "first")))
    st, _cap = pexec._merge_states_host(pages, 16, 2, 5,
                                        ("sum_i", "sum_f", "min", "max",
                                         "first"), PACK)
    words = _live_words(st, PACK)
    assert len(words) > 16 and _ascending(words)
