"""The plans of kernels A and B on the CPU (tidb_tpu_torch/ops/kernels/
radix_exchange.py and shuffle_join.py): each kernel's arithmetic
mirrored in numpy and held to the JAX reference, the launch each wrapper
plans, the shared memory and workspace it lays out, and the header it
packs.  The kernels themselves run only on a card
(tests/test_torch_cuda.py, chip_smoke.py); their plain versions are held
to the reference here at the edge shapes of the new tiles.

Kernel A (csrc/radix_exchange.cu): a tile of ``TILE`` rows ranks its rows
stably by bucket (a warp multisplit into per-warp counts), finds each
bucket's prefix over the earlier tiles by look-back, and writes row r at
slot ``b * cap + prefix + rank`` unless that passes ``cap``; fill blocks
zero each bucket's empty tail.  Kernel B (csrc/shuffle_join.cu): a tile
of ``TILE`` sorted positions scans its build values in a fixed shape and
takes its prefix from the nearest earlier inclusive prefix plus the
aggregates after it, in tile order, so float prefixes are the same bits
whichever tiles had published.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.parallel import mpp as rmpp
from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops.kernels import build
from tidb_tpu_torch.ops.kernels import radix_exchange as rx
from tidb_tpu_torch.ops.kernels import shuffle_join as sj
from tidb_tpu_torch.parallel import mpp as pmpp

T = rx.TILE
#: shared memory a block can use on the H100 (bytes)
SMEM_LIMIT = 232_448


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _defines(name):
    """The integer #defines of a kernel source, their expressions
    evaluated in order."""
    with open(f"{build.CSRC}/{name}") as f:
        text = f.read()
    out = {}
    for key, expr in re.findall(r"^#define (\w+) (.+?)\s*(?://.*)?$", text,
                                re.M):
        try:
            out[key] = eval(expr, {}, dict(out))  # noqa: S307 - our source
        except Exception:
            pass
    return out


# -- kernel A: the plan mirrored in numpy --------------------------------------

def _buckets(h, valid, n_dest, n_sub):
    hu = h.view(np.uint64)
    b = ((hu >> np.uint64(32)) % np.uint64(n_dest)) * np.uint64(n_sub) + (
        hu & np.uint64(n_sub - 1))
    return np.where(valid, b.astype(np.int64), n_dest * n_sub)


def _mirror_partition(h, valid, n_dest, n_sub, cap, rng):
    """Kernel A's placement in numpy: each tile's per-warp counts and
    ranks (a warp's rows in row order), its bucket starts, the look-back
    prefix over the earlier tiles' status words (each earlier tile found
    with only its own count or already its inclusive prefix, at random;
    tile 0 always inclusive), the kept slots, then the fill items.
    Returns (source row per slot, slot_valid, need, dropped, the slots
    the fill zeroes)."""
    m, nb = len(h), n_dest * n_sub
    plan = rx.launch_plan(m, nb, cap)
    per_warp = T // rx.WARPS
    bk = _buckets(h, valid, n_dest, n_sub)
    n_tiles = plan["n_tiles"]
    counts = np.zeros((n_tiles, nb), np.int64)
    tiles = []
    for t in range(n_tiles):
        bt = bk[t * T:(t + 1) * T]
        wh = np.zeros((rx.WARPS, nb), np.int64)
        rank = np.zeros(len(bt), np.int64)
        for r, b in enumerate(bt):
            if b < nb:
                rank[r] = wh[r // per_warp, b]
                wh[r // per_warp, b] += 1
        counts[t] = wh.sum(0)
        tiles.append((bt, rank, np.cumsum(wh, 0) - wh,
                      np.cumsum(counts[t]) - counts[t]))
    incl = np.cumsum(counts, 0)
    rows = np.zeros(nb * cap, np.int64)
    slot_valid = np.zeros(nb * cap, bool)
    for t, (bt, rank, wpre, s_off) in enumerate(tiles):
        published = rng.random(t) < 0.5
        if t:
            published[0] = True
        excl = np.zeros(nb, np.int64)
        for b in range(nb):
            j = t - 1
            while j >= 0:  # the look-back: counts until an inclusive prefix
                if published[j]:
                    excl[b] += incl[j, b]
                    break
                excl[b] += counts[j, b]
                j -= 1
        assert np.array_equal(excl, incl[t] - counts[t])
        kept = np.clip(cap - excl, 0, counts[t])
        s_glob = np.arange(nb) * cap + excl - s_off
        for r, b in enumerate(bt):
            if b == nb:
                continue
            p = s_off[b] + wpre[r // per_warp, b] + rank[r]
            if p < s_off[b] + kept[b]:
                s = s_glob[b] + p
                assert not slot_valid[s]
                rows[s], slot_valid[s] = t * T + r, True
    cnt = incl[-1]
    zeroed = np.zeros(nb * cap, bool)
    chunks = -(-cap // rx.FILL_CHUNK)
    for f in range(plan["n_fill"]):
        for it in range(f, plan["items"], plan["n_fill"]):
            b, ch = divmod(it, chunks)
            lo = max(ch * rx.FILL_CHUNK, min(cnt[b], cap))
            hi = min((ch + 1) * rx.FILL_CHUNK, cap)
            if lo < hi:
                zeroed[b * cap + lo:b * cap + hi] = True
    return (rows, slot_valid, int(cnt.max()) if nb else 0,
            int(np.maximum(cnt - cap, 0).sum()), zeroed)


def _exchange_rows(m, n_dest, n_sub, hot, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-10**12, 10**12, m)
    if hot:
        keys[rng.random(m) < 0.5] = 4242  # one hot bucket across tiles
    valid = rng.random(m) < 0.85
    h, _ok = rx.dest_hash([torch.from_numpy(keys)], "single")
    return keys, h.numpy(), valid


@pytest.mark.parametrize("m", [T - 1, T, T + 1, 3 * T + 17])
@pytest.mark.parametrize("n_dest,n_sub,cap", [(8, 4, 64), (1023, 1, 4)],
                         ids=["nb32", "nb1023"])
@pytest.mark.parametrize("hot", [False, True], ids=["uniform", "hot"])
def test_partition_plan_matches_bucketize(m, n_dest, n_sub, cap, hot):
    """The mirrored tiles place every row where the reference's stable
    argsort does (``tidb_tpu/parallel/mpp.py:250 _bucketize``, through
    JAX): the grid of source rows, slot_valid, dropped and need; the
    fill zeroes exactly the slots no tile wrote."""
    keys, h, valid = _exchange_rows(m, n_dest, n_sub, hot, m + n_dest)
    rows, slot_valid, need, dropped, zeroed = _mirror_partition(
        h, valid, n_dest, n_sub, cap, np.random.default_rng(m))
    _bk, (ref_rows,), ref_valid, ref_dropped = rmpp._bucketize(
        jnp.asarray(keys), (jnp.arange(m, dtype=jnp.int64),),
        jnp.asarray(valid), n_dest, cap, n_sub=n_sub)
    assert np.array_equal(rows, np.asarray(ref_rows))
    assert np.array_equal(slot_valid, np.asarray(ref_valid))
    assert dropped == int(ref_dropped)
    plain = rx.partition_plain(torch.from_numpy(h), torch.from_numpy(valid),
                               n_dest, n_sub, cap)
    assert need == int(plain["need"])
    assert not (zeroed & slot_valid).any() and (zeroed | slot_valid).all()
    if hot:
        assert dropped > 0


def test_defines_match_the_wrappers():
    """The constants the wrappers plan with are the kernels' own."""
    a = _defines("radix_exchange.cu")
    assert (a["RX_MAX_BUCKETS"], a["RX_MAX_COLS"], a["RX_MAX_KEYS"]) == (
        rx.MAX_BUCKETS, rx.MAX_COLS, rx.MAX_KEYS)
    assert (a["RX_THREADS"], a["RX_WARPS"], a["RX_TILE"]) == (
        rx.THREADS, rx.WARPS, rx.TILE)
    assert a["RX_FILL_CHUNK"] == rx.FILL_CHUNK
    assert a["RX_WS_STATUS"] == rx.WS_STATUS
    # u16 local rows and buckets in shared memory
    assert rx.TILE <= 1 << 16 and rx.MAX_BUCKETS <= 1 << 16
    b = _defines("shuffle_join.cu")
    assert (b["SJ_TILE"], b["SJ_THREADS"], b["SJ_MAX_BLOCKS"]) == (
        sj.TILE, sj.THREADS, sj.MAX_BLOCKS)


@pytest.mark.parametrize("nb", [1, 32, 33, 256, 1023])
def test_partition_shared_memory_fits(nb):
    """A tile block's shared memory at every bucket count the wrapper
    takes fits the H100's 227 KB, laid out as csrc rx_smem_bytes."""
    glob = (rx.WARPS + 2) * nb * 4
    glob += -glob % 16
    perm = glob + nb * 8
    perm += -perm % 16
    assert rx.smem_bytes(nb) == perm + rx.TILE * 2 * 2 + rx.TILE * 8
    assert rx.smem_bytes(nb) + 16 * 4 + 64 <= SMEM_LIMIT
    assert rx.smem_bytes(rx.MAX_BUCKETS - 1) == 73_696


@pytest.mark.parametrize("m,nb,cap,want", [
    (0, 32, 64, (1, 32, 32)), (1, 32, 64, (1, 32, 32)),
    (T - 1, 32, 1 << 15, (1, 256, 256)), (T, 32, 1 << 15, (1, 256, 256)),
    (T + 1, 32, 4096, (2, 32, 32)),
    (750_152, 32, 1 << 15, (367, 256, 256)),
    (750_152, 1023, 1024, (367, 264, 1023))])
def test_partition_launch_plan(m, nb, cap, want):
    """One launch: at least one tile (it writes the counts of an empty
    call), fill blocks over (bucket, chunk) items, at most two an SM."""
    plan = rx.launch_plan(m, nb, cap)
    assert (plan["n_tiles"], plan["n_fill"], plan["items"]) == want
    assert plan["launches"] == 1
    assert plan["blocks"] == plan["n_tiles"] + plan["n_fill"]
    assert plan["ws_words"] == rx.WS_STATUS + plan["n_tiles"] * nb


def test_partition_header():
    plan = rx.launch_plan(5000, 32, 256)
    hdr = rx.pack_header(5000, 8, 4, 256, 11, 0, plan, 7, 13, 17, 19, 23,
                         [(29, 31, 8), (37, 41, 1)])
    assert hdr.dtype == np.int64
    assert hdr.tolist() == [5000, 8, 4, 256, 11, 0, 3, 32, 7, 13, 17, 19,
                            23, 2, 29, 31, 8, 37, 41, 1]


def test_partition_workspace_epochs():
    """The workspace is zeroed when allocated, grown to the largest call,
    keeps its words across calls (each call a new epoch), and is cleared
    once before the epochs would pass the kernel's 32-bit tags."""
    ws = rx._Workspace()
    p1, e1 = ws.take(100, "cpu")
    p2, e2 = ws.take(80, "cpu")
    assert (e1, e2) == (1, 2) and p1 == p2
    assert not ws.words.any()
    ws.words[5] = 99
    p3, e3 = ws.take(500, "cpu")
    assert e3 == 3 and ws.words.numel() >= 500 and not ws.words.any()
    ws.words[5] = 99
    ws.epoch = rx.EPOCH_LIMIT
    _p, e4 = ws.take(10, "cpu")
    assert e4 == 1 and not ws.words.any()
    assert 2 * rx.EPOCH_LIMIT + 2 < 1 << 32


# -- partition_plain against the reference at the new edge shapes -------------

@pytest.mark.parametrize("case", ["m0", "all-invalid", "n_sub1", "nb1023",
                                  "tile-1", "tile+1"])
def test_partition_plain_edges_match_bucketize(case):
    rng = np.random.default_rng(len(case))
    m = {"m0": 0, "tile-1": T - 1, "tile+1": T + 1}.get(case, 3000)
    n_dest, n_sub = {"n_sub1": (5, 1), "nb1023": (1023, 1)}.get(case, (8, 4))
    cap = 8 if case == "nb1023" else 96
    keys = rng.integers(-10**9, 10**9, m)
    vals = rng.integers(-50, 50, m)
    valid = (np.zeros(m, bool) if case == "all-invalid"
             else rng.random(m) < 0.9)
    bk, (bv,), bvalid, dropped = rmpp._bucketize(
        jnp.asarray(keys), (jnp.asarray(vals),), jnp.asarray(valid), n_dest,
        cap, n_sub=n_sub)
    h, ok = rx.dest_hash([torch.from_numpy(keys)], "single",
                         valid=torch.from_numpy(valid))
    out = rx.partition(h, ok, n_dest, n_sub, cap,
                       [torch.from_numpy(keys), torch.from_numpy(vals)])
    assert np.array_equal(out["cols"][0].numpy(), np.asarray(bk))
    assert np.array_equal(out["cols"][1].numpy(), np.asarray(bv))
    assert np.array_equal(out["valid"].numpy(), np.asarray(bvalid))
    assert int(out["dropped"]) == int(dropped)
    if case in ("m0", "all-invalid"):
        assert int(out["need"]) == 0 and not out["valid"].any()


# -- kernel B: the plan mirrored in numpy --------------------------------------

def _hs_scan(x, width):
    """Inclusive Hillis-Steele scan along the last axis in groups of
    `width` lanes, as the kernel's shuffles add: own value + lane - o."""
    x = x.copy()
    lanes = np.arange(x.shape[-1]) % width
    for o in (1, 2, 4, 8, 16):
        if o >= width:
            break
        up = np.concatenate([np.zeros_like(x[..., :o]), x[..., :-o]], -1)
        x = np.where(lanes >= o, x + up, x)
    return x


def _mirror_tile(v):
    """One scan tile of kernel B (v: its SJ_TILE values in rows of
    THREADS positions, over every step of the tile): per row j a warp
    scan of each warp's 32 lanes, the row's warp totals scanned, each
    position's local inclusive prefix ((rows before j) + (warps before) +
    own), and the tile's total (the rows' totals in row order)."""
    rows = v.reshape(-1, sj.THREADS)
    x = _hs_scan(rows, 32)
    tot = x[:, 31::32]
    w = _hs_scan(tot, tot.shape[1])
    wex = np.concatenate([np.zeros_like(w[:, :1]), w[:, :-1]], 1)
    run = np.zeros((), v.dtype)
    loc = np.empty_like(rows)
    for j in range(rows.shape[0]):
        loc[j] = (run + np.repeat(wex[j], 32)) + x[j]
        run = run + w[j, -1]
    return loc.reshape(-1), run


def _mirror_csum(vals, rng):
    """csum as the kernel writes it: each tile's prefix from the look-back
    (the nearest earlier tile found with its inclusive prefix, at
    random, then the aggregates after it in tile order), plus its local
    prefixes."""
    n = len(vals)
    n_tiles = sj.launch_plan(n, 1)["n_tiles"]
    padded = np.zeros(n_tiles * sj.TILE, vals.dtype)
    padded[:n] = vals
    aggs, locs = [], []
    for t in range(n_tiles):
        loc, agg = _mirror_tile(padded[t * sj.TILE:(t + 1) * sj.TILE])
        aggs.append(agg)
        locs.append(loc)
    incl = []
    csum = [np.zeros((), vals.dtype)]
    for t in range(n_tiles):
        if t == 0:
            pre = np.zeros((), vals.dtype)
        else:
            window = range(t - 1, max(t - 33, -1), -1)
            found = [q for q in window if q == 0 or rng.random() < 0.3]
            stop = found[0]
            pre = incl[stop]
            for q in range(stop + 1, t):
                pre = pre + aggs[q]
        incl.append(pre + aggs[t])
        csum.append(pre + locs[t])
    return np.concatenate([np.atleast_1d(c) for c in csum])[:n + 1]


@pytest.mark.parametrize("n", [1, sj.TILE - 1, sj.TILE, sj.TILE + 1,
                               40 * sj.TILE + 3])
def test_join_sum_scan_plan(n):
    """The mirrored scan gives the exact int64 prefix sums, float64
    prefix sums within rtol 1e-9 of a sequential cumsum, and the same
    float bits whichever tiles the look-back found published."""
    rng = np.random.default_rng(n)
    iv = rng.integers(-10**15, 10**15, n)
    with np.errstate(over="ignore"):
        want = np.concatenate([[0], np.cumsum(iv)])
    assert np.array_equal(_mirror_csum(iv, rng), want)
    fv = rng.standard_normal(n) * 1e3
    runs = [_mirror_csum(fv, np.random.default_rng(s)) for s in range(3)]
    assert all(np.array_equal(r.view(np.int64), runs[0].view(np.int64))
               for r in runs)
    np.testing.assert_allclose(runs[0], np.concatenate([[0.0],
                                                        np.cumsum(fv)]),
                               rtol=1e-9, atol=1e-9)


def _mirror_total(csum, pos0, cnt, pv, pvalid):
    """Kernel B's probe blocks: each thread's rows in grid-stride order,
    a fixed tree a block, then the partials in block order."""
    np_ = len(pos0)
    nb = sj.launch_plan(1, np_)["n_probe"]
    stride = nb * sj.THREADS
    ok = (cnt > 0) & (pvalid if pvalid is not None else True)
    ms = np.where(ok, csum[np.where(ok, pos0 + cnt, 0)]
                  - csum[np.where(ok, pos0, 0)], 0)
    prod = np.where(ok, pv * ms, 0)
    per_thread = np.zeros(stride, prod.dtype)
    for k in range(0, np_, stride):
        part = prod[k:k + stride]
        per_thread[:len(part)] = per_thread[:len(part)] + part

    def block_tree(v):  # 256 lanes: warps by shuffle-down, then 8 warps
        v = v.reshape(-1, 32).copy()
        for o in (16, 8, 4, 2, 1):
            v[:, :o] = v[:, :o] + v[:, o:2 * o]
        w = np.zeros(32, v.dtype)
        w[:v.shape[0]] = v[:, 0]
        for o in (16, 8, 4, 2, 1):
            w[:o] = w[:o] + w[o:2 * o]
        return w[0]

    parts = np.array([block_tree(per_thread[b * sj.THREADS:
                                            (b + 1) * sj.THREADS])
                      for b in range(nb)])
    lanes = np.zeros(sj.THREADS, prod.dtype)
    for k in range(nb):
        lanes[k % sj.THREADS] = lanes[k % sj.THREADS] + parts[k]
    return block_tree(lanes), int(np.where(ok, cnt, 0).sum())


@pytest.mark.parametrize("np_", [0, 1, 1000, 300_000])
@pytest.mark.parametrize("kind", ["int64", "float64"])
def test_join_sum_plan_matches_plain(np_, kind):
    """The mirrored kernel (scan, probe blocks, partials) against
    join_sum_plain: int64 exact, float64 within rtol 1e-9 / atol 1e-12."""
    rng = np.random.default_rng(np_ + len(kind))
    n, nbv = 5000, 3000
    order = rng.permutation(n)
    if kind == "int64":
        bv, pv = rng.integers(-10**6, 10**6, n), rng.integers(1, 50, np_)
    else:
        bv, pv = rng.standard_normal(n) * 100, rng.random(np_)
    pos0 = rng.integers(0, nbv, np_)
    cnt = np.minimum(rng.integers(0, 4, np_), nbv - pos0)
    pvalid = rng.random(np_) < 0.8
    csum = _mirror_csum(bv[order], rng)
    total, pairs = _mirror_total(csum, pos0, cnt, pv, pvalid)
    t = torch.from_numpy
    want_t, want_p = sj.join_sum_plain(t(bv), t(order), t(pos0), t(cnt),
                                       t(pv), t(pvalid))
    assert pairs == int(want_p)
    if kind == "int64":
        assert int(total) == int(want_t)
    else:
        assert np.isclose(float(total), float(want_t), rtol=1e-9,
                          atol=1e-12)


@pytest.mark.parametrize("n,np_,want", [
    (0, 0, (0, 1)), (1, 1, (1, 1)), (sj.TILE, 256, (1, 1)),
    (sj.TILE + 1, 257, (2, 2)), (1 << 21, 1 << 21, (512, 1056))])
def test_join_sum_launch_plan(n, np_, want):
    """One launch: a scan block a tile of sorted positions, then probe
    blocks (at least one, which writes the total of an empty probe)."""
    plan = sj.launch_plan(n, np_)
    assert (plan["n_tiles"], plan["n_probe"]) == want
    assert plan["launches"] == 1 and plan["blocks"] == sum(want)


@pytest.mark.parametrize("n", [0, 1, sj.TILE, 1 << 21])
def test_join_sum_workspace_layout(n):
    """Counters, per tile a flag, an aggregate and an inclusive prefix,
    the partials of the most probe blocks, and csum: disjoint, in order,
    each as long as the kernel indexes it."""
    lay = sj.workspace_layout(n)
    tiles = sj.launch_plan(n, 1)["n_tiles"]
    spans = [("ctr", 3), ("flag", tiles), ("agg", tiles), ("incl", tiles),
             ("part_total", sj.MAX_BLOCKS), ("part_pairs", sj.MAX_BLOCKS),
             ("csum", n + 1)]
    end = 0
    for name, size in spans:
        assert lay[name] >= end
        end = lay[name] + size
    assert lay["words"] == end


def test_join_sum_header_and_workspace():
    plan = sj.launch_plan(5000, 9000)
    ws = sj._Workspace()
    ptrs, e1 = ws.take(5000, "cpu")
    _p, e2 = ws.take(100, "cpu")
    assert (e1, e2) == (1, 2) and not ws.words.any()
    assert ptrs["csum"] - ptrs["ctr"] == 8 * sj.workspace_layout(
        ws.n)["csum"]
    hdr = sj.pack_header(5000, 1, 0, 2, 9000, 3, 4, 5, 0, 6, 0, plan, e1,
                         ptrs, 7)
    assert hdr.tolist()[:14] == [5000, 1, 0, 2, 9000, 3, 4, 5, 0, 6, 0,
                                 plan["n_tiles"], plan["n_probe"], 1]
    assert (plan["n_tiles"], plan["n_probe"]) == (-(-5000 // sj.TILE), 36)
    assert hdr.tolist()[14:] == [ptrs[k] for k in (
        "ctr", "flag", "agg", "incl", "part_total", "part_pairs",
        "csum")] + [7]


# -- join_sum_plain against the reference at the new edge shapes -------------

@pytest.mark.parametrize("case", ["below-tile", "empty-probe", "int64",
                                  "float64"])
def test_join_sum_plain_edges_match_reference(case):
    """One shard (no exchange): the port's dist_join_agg_step, whose
    local sum is join_sum_plain on the CPU, against the reference's
    (``tidb_tpu/parallel/mpp.py:296 dist_join_agg_step``) with fewer
    sorted positions than a tile (4 x 256 slots) and with no valid probe
    row."""
    rng = np.random.default_rng(len(case))
    nb_, npr = 600, 700
    bk = rng.integers(0, 300, nb_)
    pk = rng.integers(0, 400, npr)
    floats = case == "float64"
    bv = rng.random(nb_) * 100 if floats else rng.integers(1, 50, nb_)
    pv = rng.random(npr) * 10 if floats else rng.integers(1, 50, npr)
    bvalid = rng.random(nb_) < 0.8
    pvalid = (np.zeros(npr, bool) if case == "empty-probe"
              else rng.random(npr) < 0.9)
    cap = 256
    assert pmpp.RADIX_SUB * cap < sj.TILE
    rmesh, pmesh = rmpp.make_mesh(1), pmpp.make_mesh(1)
    (rb, rbpad), (pb, pbpad) = (rmpp.shard_batch(rmesh, bk, bvalid, bv),
                                pmpp.shard_batch(pmesh, bk, bvalid, bv))
    (rp, rppad), (pp, pppad) = (rmpp.shard_batch(rmesh, pk, pvalid, pv),
                                pmpp.shard_batch(pmesh, pk, pvalid, pv))
    r = rmpp.dist_join_agg_step(rmesh, cap)(rb[0], rb[2], rb[1] & rbpad,
                                            rp[0], rp[2], rp[1] & rppad)
    p = pmpp.dist_join_agg_step(pmesh, cap)(pb[0], pb[2], pb[1] & pbpad,
                                            pp[0], pp[2], pp[1] & pppad)
    assert int(p[2]) == int(r[2]) == 0
    assert int(p[1]) == int(r[1])
    if floats:
        assert np.isclose(float(p[0]), float(r[0]), rtol=1e-9, atol=1e-12)
    else:
        assert int(p[0]) == int(r[0])
    if case == "empty-probe":
        assert int(p[1]) == 0 and float(p[0]) == 0
