"""MPP SQL execution (reference K12: ``tidb_tpu/executor/mpp_exec.py``):
fused scan/join/agg fragments run SPMD over a local device mesh — the
reference's MPP fragment execution wired into the SQL path
(planner/core/fragment.go cuts plans at exchange boundaries;
store/copr/mpp.go:65 constructs per-node tasks; executor/mpp_gather.go
streams fragments back; unistore/cophandler/mpp_exec.go runs them).

The mesh (parallel/mpp.py) follows the reference's rule where two or
more cards are visible: ``tidb_mpp_devices`` shards, ``0`` meaning every
card, capped at the card count, one shard a card (the SPLIT layout), all
driven from the session's thread; shard 0 is the session's card, where
the shards' states are folded.  With one card (or on the CPU) it departs
from the reference, which would give no mesh: ``tidb_mpp_devices`` = n
>= 2 gives n logical shards on the session's device (the LOCAL layout),
so one card runs the whole SPMD program; ``0`` gives no mesh there.  On
one card the local mesh is a bring-up and test mesh, slower than the
single-device engine.

- The probe-spine fact table is row-sharded over the mesh; every other
  table is replicated (broadcast join), except the build-key leaf of a
  fact-fact join, which a Hash exchange repartitions with the probe fact
  (kernel A, ops/kernels/radix_exchange.py, then the mesh's
  ``all_to_all``).
- Each shard runs the SAME scan → filter → join → partial-agg body the
  single-device fragment compiles (device_join.compile_fragment: K2's
  programs, K5a's range pass and sorted probe, K4's order, K5b's
  expansion, K1), on its shard's rows and every replicated table.
- The exchange of the partial states and the final merge are ONE fold of
  the n shards' states in shard order (ops/kernels/merge_states.py) on
  shard 0's device, so ``first`` keeps the reference's row; the overflow
  flags are reduced over the shards there and read by the host once per
  dispatch.

The single-device amortization stack carries across the mesh, as in the
reference: per-shard bucket shapes with the live row counts as run-time
inputs (a within-bucket INSERT re-dispatches the cached pipeline, with
no new build); pipelines keyed by (fragment signature, capacities) in
the shared pipeline cache; converged capacities learned per signature
(device_join._CAP_STORE); every mesh placement on the residency ledger
through a CacheOwner and stamped with the device epoch.

Static shapes throughout: join expansions, exchange buckets and agg
states are capacity-bounded with exact overflow counts; the host retries
with grown capacities — one more pipeline build, never wrong results.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from ..ops import device as dev
from ..ops.device import DeviceUnsupported
from ..ops.kernels import expr_vm as vm
from ..ops.kernels import merge_states, radix_exchange
from ..parallel.mpp import RADIX_SUB
from .device_exec import (
    _assemble_agg, _estimate_groups, _plan_agg, acquire_pipeline,
    engine_mode)
from .device_join import (
    _CAP_STORE, _JoinNode, _Leaf, _cap_store_put, _leaf_meta, _shift_expr,
    collect_tree, compile_fragment, fragment_sig)

AXIS = "part"

#: merge op per partial op for the final stage: partial counts re-sum,
#: partial sums re-sum, min/max merge with themselves, first takes any
_MERGE_OP = {"count": "sum_i", "sum_i": "sum_i", "sum_f": "sum_f",
             "min": "min", "max": "max", "first": "first"}

#: observability: fragments actually executed through the mesh path.
#: exchange_retries = transport faults re-dispatched on the same shapes;
#: exchange_overflow_retries = radix sub-bucket overflow rebuilds at a
#: larger exchange capacity (the hot-key convergence counter);
#: retries = all capacity-growth rebuilds (joins, agg, exchange).
MPP_STATS = {"fragments": 0, "retries": 0, "shuffle_joins": 0,
             "skew_broadcasts": 0, "exchange_retries": 0,
             "exchange_overflow_retries": 0}

_MESH_CACHE: dict = {}
#: the devices that stand for the visible cards in mpp_mesh's rule, where
#: set (set_mesh_devices); None: the cards torch sees
_MESH_DEVICES = [None]


def set_mesh_devices(devices):
    """Let the list `devices` stand for the visible cards in
    :func:`mpp_mesh`'s rule (a device a shard slot; one may repeat), or
    None for the cards torch sees; returns the previous setting.  Two or
    more give the split layout over them (``["cpu"] * 4`` runs it on the
    CPU, ``["cuda:0"] * 4`` on one card); one gives the one-card rule on
    it."""
    prev = _MESH_DEVICES[0]
    _MESH_DEVICES[0] = (None if devices is None
                        else [torch.device(d) for d in devices])
    return prev


def mesh_devices() -> list:
    """The devices :func:`mpp_mesh` counts, shard 0's first: the list
    set_mesh_devices gave; else, on a card, every visible card from the
    session's on (as many as the reference's ``jax.devices()``); else the
    session's one device."""
    if _MESH_DEVICES[0] is not None:
        return list(_MESH_DEVICES[0])
    d = dev.device()
    if d.type != "cuda":
        return [d]
    n = torch.cuda.device_count()
    return [torch.device("cuda", (d.index + i) % n) for i in range(n)]


def mpp_mesh(ctx):
    """The session's mesh, or None when the MPP engine isn't selected.
    With two or more devices (:func:`mesh_devices`), the reference's
    rule: ``tidb_mpp_devices`` = 0 means every device, n is capped at the
    device count and n < 2 gives no mesh; the mesh is split, shard i on
    the i-th device.  With one, n >= 2 gives n logical shards on it (the
    local layout) and anything else no mesh."""
    if engine_mode(ctx) != "tpu-mpp":
        return None
    try:
        n = int(ctx.get_sysvar("tidb_mpp_devices"))
    except Exception:
        n = 0
    devs = mesh_devices()
    if len(devs) >= 2:
        n = min(n if n > 0 else len(devs), len(devs))
        devs = devs[:n]
    if n < 2:
        return None  # nothing to distribute over
    from ..parallel import Mesh
    split = len(devs) >= 2
    key = (n, tuple(str(d) for d in devs), split)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = _MESH_CACHE[key] = (Mesh(devs, AXIS) if split
                                   else Mesh(n, AXIS, devs[0]))
    return mesh


# ---------------------------------------------------------------------------
# mesh placement cache — every entry's bytes live on the ops/residency.py
# ledger through a CacheOwner: per-tenant charging, LRU eviction under
# budget pressure, the OOM evict-all ladder, and the device epoch apply
# to mesh placements exactly as to single-device Column uploads.  An epoch
# bump (backend fence, OOM recovery) invalidates every placement.
# ---------------------------------------------------------------------------

#: (id(col), id(mesh), sharded, total_rows) → (CacheOwner, pinned col).
#: The pinned Column keeps the id() key sound (a live object never shares
#: its id with a new allocation).  The tensors live on the owner via the
#: residency manager, NOT here, so eviction works owner by owner.
_MPP_PLACE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_PLACE_CACHE_MAX = 128
_PLACE_LOCK = threading.Lock()


def _place_col(col, data, nulls, mesh, sharded, total):
    """Pad `col`'s host arrays to `total` rows and put them on the mesh
    (``Mesh.place``: sharded as ``total // n`` rows per shard, or
    replicated; on a split mesh shard i's rows on its device and a
    replicated array on every device), cached through the residency
    ledger, which charges every device's bytes.  `total` is a bucket
    shape (a multiple of the mesh size when sharded): a within-bucket
    delta re-places (new column identity) but re-dispatches the same
    pipeline."""
    from ..ops import residency
    key = (id(col), id(mesh), sharded, total)
    with _PLACE_LOCK:
        hit = _MPP_PLACE_CACHE.get(key)
        if hit is not None:
            _MPP_PLACE_CACHE.move_to_end(key)
            owner = hit[0]
        else:
            owner = residency.CacheOwner()
            _MPP_PLACE_CACHE[key] = (owner, col)
            while len(_MPP_PLACE_CACHE) > _PLACE_CACHE_MAX:
                _MPP_PLACE_CACHE.popitem(last=False)
    cached = residency.lookup(owner, total)
    if cached is None:
        d = mesh.place(dev.pad_host(np.asarray(data), total), sharded)
        nl = mesh.place(dev.pad_host(np.asarray(nulls, dtype=bool), total,
                                     True), sharded)
        # compare-and-keep publish: a racing placement's loser tensors are
        # accounted as immediately evicted, never leaked off-ledger
        cached = residency.publish(owner, d, nl)
    return cached


def place_cache_bytes() -> int:
    """Bytes of mesh placements currently live on the residency ledger
    (the ``mpp_place_bytes`` gauge), read through the ledger."""
    return _place_cache_view()[1]


def _place_cache_view():
    """(entry count, ledger bytes) from ONE placement-lock acquisition."""
    from ..ops import residency
    with _PLACE_LOCK:
        owners = [ent[0] for ent in _MPP_PLACE_CACHE.values()]
    return len(owners), residency.resident_nbytes_total(owners)


def snapshot() -> dict:
    """MPP observability snapshot for /status and bench lines."""
    entries, nbytes = _place_cache_view()
    return {**MPP_STATS, "place_entries": entries,
            "mpp_place_bytes": nbytes}


def report_gauges() -> dict:
    """Surfacing policy shared by EXPLAIN ANALYZE / bench lines (mirrors
    residency.report_gauges): placement bytes always once the mesh path
    has run, counters only when they have ever fired."""
    s = snapshot()
    if not s["fragments"] and not s["mpp_place_bytes"]:
        return {}
    out = {"mpp_place_bytes": s["mpp_place_bytes"],
           "mpp_fragments": s["fragments"]}
    for k in ("retries", "exchange_retries", "exchange_overflow_retries",
              "shuffle_joins", "skew_broadcasts"):
        if s[k]:
            out["mpp_" + k] = s[k]
    return out


def _publish_gauges(ctx):
    obs = getattr(getattr(ctx, "domain", None), "observe", None)
    if obs is not None and hasattr(obs, "set_gauge"):
        try:
            for k, v in report_gauges().items():
                obs.set_gauge(k, v)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# radix hash-shuffle exchange (the Hash exchange type — reference:
# planner/core/fragment.go:37,64 ExchangeSender{HashPartition}; here:
# kernel A's two-level radix partition + the mesh's all_to_all)
# ---------------------------------------------------------------------------

def _dest_hash(key_ds, key_nulls, valid):
    """mix64 fold of the (multi-)column join key on kernel A, and the
    rows the exchange sends: valid, with no NULL key (NULL keys never
    match).  Both join sides use the same fold, so equal keys land on the
    same shard; the HIGH bits pick the destination and the LOW bits the
    radix sub-bucket."""
    return radix_exchange.dest_hash(list(key_ds), "fold", list(key_nulls),
                                    valid)


def _exchange_leaf(mesh, shard_cols, hashes, n_sub, cap):
    """Repartition one leaf's per-shard rows by their key hashes: kernel
    A's stable radix partition of each shard's rows into its ``[n_dest,
    n_sub, cap]`` grid (high bits → destination shard, low bits → one of
    `n_sub` sub-buckets), then one all_to_all per column, so each shard
    ends up holding exactly the rows hashed to it.

    shard_cols[i]: shard i's column tensors; hashes[i]: its (h, ok).
    Returns (cols, valid, need): per shard the received column grids and
    slot validity, and the EXACT worst sub-bucket count over the shards
    (when it exceeds `cap` rows were dropped, and the host retries with
    capacity next_pow2(need) — one jump, not a blind doubling ladder)."""
    grids, needs = [], []
    for cols, (h, ok) in zip(shard_cols, hashes):
        part = radix_exchange.partition(h, ok, mesh.n, n_sub, cap, cols)
        grids.append([part["valid"]] + part["cols"])
        needs.append(part["need"])
    recv = [mesh.all_to_all([g[c] for g in grids])
            for c in range(len(grids[0]))]
    return recv[1:], recv[0], mesh.pmax(needs)


# ---------------------------------------------------------------------------
# the SPMD fragment program
# ---------------------------------------------------------------------------

def _build_mpp_pipeline(mesh, root, leaves, joins, plan, agg_conds,
                        sharded_ids, caps, capacity, key_pack, agg_meta,
                        shuffle=None):
    """The whole fragment over the mesh: (A) before the exchange, per
    shard, each exchanged leaf's live mask, filters and join keys (one K2
    program) and kernel A; the all_to_all; (B) per shard the fused body
    (device_join.compile_fragment: joins, residuals, keys and values,
    the partial K1); then the fold of the shards' partial states and the
    shards' flags.

    The pipeline takes (env, n_lives): env {global col: (data, nulls)}
    with sharded leaves as psb * n rows, n_lives the per-leaf live row
    counts in leaf_id order — padding past them never survives a filter,
    an exchange, a join probe or the aggregate.

    shuffle: None (broadcast joins) or (node, left_leaf, right_leaf,
    cap_l, cap_r) — radix-repartition BOTH sides of `node` over the mesh
    before the local joins (the Hash exchange type); cap_* bound each
    radix SUB-bucket."""
    key_fns, val_plan, agg_ops, slots = agg_meta
    merge_ops = tuple(_MERGE_OP[o] for o in agg_ops)
    n_keys = max(len(key_fns), 1)
    n_joins = len(joins)
    n_shards = mesh.shape[AXIS]
    sharded = frozenset(sharded_ids)
    body = compile_fragment(root, leaves, joins, plan, agg_conds, list(caps),
                            capacity, key_pack, agg_meta,
                            strategies=(None,) * n_joins)
    xplan = []
    if shuffle is not None:
        node, llid, rlid, cap_l, cap_r = shuffle
        dcols = {leaf.offset + i: dc for leaf in leaves
                 for i, dc in _leaf_meta(leaf).items()}
        for leaf_id, keys, koff, xcap in (
                (llid, node.left_keys, node.left.offset, cap_l),
                (rlid, node.right_keys, node.right.offset, cap_r)):
            leaf = leaves[leaf_id]
            # pre-exchange filter: leaf conds cut the exchange's volume
            conds = [dev.compile_expr(_shift_expr(c, leaf.offset), dcols)
                     for c in leaf.conds]
            kfns = [dev.compile_expr(_shift_expr(k, koff), dcols)
                    for k in keys]
            xplan.append((leaf, vm.Program.build(conds, kfns, []), xcap))
    cols_of = {leaf.leaf_id: [leaf.offset + i for i in range(leaf.ncols)]
               for leaf in leaves}

    def pipeline(env, n_lives):
        n = n_shards
        envs = [{} for _ in range(n)]
        lives = [list(n_lives) for _ in range(n)]
        for leaf in leaves:
            lid = leaf.leaf_id
            part = mesh.shard if lid in sharded else mesh.replica
            for c in cols_of[lid]:
                d, nl = env[c]
                for i in range(n):
                    envs[i][c] = (part(d, i), part(nl, i))
            if lid in sharded:
                psb = mesh.shard(env[cols_of[lid][0]][0], 0).shape[0]
                for i in range(n):
                    lives[i][lid] = max(0, min(psb, int(n_lives[lid])
                                               - i * psb))
        masks = [{} for _ in range(n)]
        xneeds = []
        for leaf, prog, xcap in xplan:
            lid = leaf.leaf_id
            shard_cols, hashes = [], []
            for i in range(n):
                e = envs[i]
                rows = e[cols_of[lid][0]][0].shape[0]
                mask, outs = vm.run(prog, [e[c] for c in prog.in_cols],
                                    rows, lives[i][lid], mesh.devices[i])
                kds = [outs[s][0] for s in prog.key_slots]
                knl = [outs[s][1] for s in prog.key_slots]
                hashes.append(_dest_hash(kds, knl, mask))
                shard_cols.append([t for c in cols_of[lid] for t in e[c]])
            recv, valid, need = _exchange_leaf(mesh, shard_cols, hashes,
                                               RADIX_SUB, xcap)
            for i in range(n):
                for k, c in enumerate(cols_of[lid]):
                    envs[i][c] = (recv[2 * k][i], recv[2 * k + 1][i])
                masks[i][lid] = valid[i]
            xneeds.append(need)
        states, ovfs, sovfs = [], [], []
        for i in range(n):
            agg_out, ovf, sovf, _kept = body(envs[i], (), lives[i],
                                             leaf_masks=masks[i])
            states.append(agg_out)
            ovfs.append(ovf)
            sovfs.append(sovf)
        # the all_gather of the bounded partial states + the replicated
        # final merge: one fold on shard 0's device, in shard order
        states = mesh.gather_states(states)
        merged = merge_states.merge(states, n_keys, merge_ops, capacity,
                                    key_pack)
        png = mesh.pmax([s[4] for s in states])
        # exact per-join required totals (pmax: the worst shard governs
        # the static capacity)
        ovfs_out = tuple(mesh.pmax([o[j].to(torch.int64) for o in ovfs])
                         for j in range(n_joins))
        sovfs_out = tuple(mesh.pmax([s[j].to(torch.int64) for s in sovfs])
                          for j in range(len(sovfs[0])))
        return (merged, png, ovfs_out, sovfs_out, tuple(xneeds),
                merge_states.fault_word(merged))

    return pipeline


# ---------------------------------------------------------------------------
# host entry points
# ---------------------------------------------------------------------------

def mpp_agg(plan, chunk, conds, ctx, mesh):
    """scan→filter→group-by fragment over the mesh (partition-parallel
    partial agg + collective merge — the shuffle-agg MPP fragment)."""
    if chunk.num_rows == 0:
        raise DeviceUnsupported("empty input")
    leaf = _Leaf(0, chunk, list(conds), 0)
    return _run_mpp(plan, [], leaf, [leaf], [], ctx, mesh)


def mpp_join_agg(agg_plan, agg_conds, child_exec, ctx, mesh):
    """join-tree→group-by fragment over the mesh: probe spine sharded,
    build sides broadcast (or a fact-fact join shuffled)."""
    root, leaves, joins = collect_tree(child_exec)
    if any(jn.kind != "inner" for jn in joins):
        # the mesh fragment shards/broadcasts inner joins only
        raise DeviceUnsupported("non-inner join in MPP fragment")
    from ..storage.paged import chunk_is_paged
    from .device_join import _col_row_bytes
    paged_est = 0
    for leaf in leaves:
        if not chunk_is_paged(leaf.chunk):
            continue
        paged_est += sum(_col_row_bytes(c)
                         for c in leaf.chunk.columns) * leaf.chunk.num_rows
    if paged_est:
        # paged leaves are legal on the mesh: placement materializes their
        # pages, so the whole placed footprint must fit the residency
        # budget (the single-device resident-build threshold); a bigger
        # disk table streams through the single-device paged pipeline or
        # the hybrid partitioned join instead
        from .device_join import _dim_resident_budget
        if paged_est > _dim_resident_budget():
            raise DeviceUnsupported(
                "paged leaves exceed the mesh residency budget")
    return _run_mpp(agg_plan, agg_conds, root, leaves, joins, ctx, mesh)


def _build_key_leaf(node, leaves):
    """The leaf inside `node`'s build (right) subtree holding ALL of the
    right-key columns — the one a Hash exchange must repartition; None
    when the keys span leaves (or reference none)."""
    used = set()
    for k in node.right_keys:
        k.columns_used(used)
    if not used:
        return None
    gls = {node.right.offset + u for u in used}
    for leaf in leaves:
        if (leaf.offset >= node.right.offset
                and leaf.offset + leaf.ncols
                <= node.right.offset + node.right.ncols
                and all(leaf.offset <= g < leaf.offset + leaf.ncols
                        for g in gls)):
            return leaf
    return None


def _run_mpp(plan, agg_conds, root, leaves, joins, ctx, mesh):
    # span tracing (session/tracing.py): one span per MPP fragment
    # dispatch, tagged with the mesh width — placement, the radix exchange
    # and the per-shard bodies all happen inside it
    from ..session import tracing
    with tracing.span("mpp.fragment", shards=mesh.shape[AXIS],
                      leaves=len(leaves), joins=len(joins)):
        return _run_mpp_impl(plan, agg_conds, root, leaves, joins, ctx,
                             mesh)


def _run_mpp_impl(plan, agg_conds, root, leaves, joins, ctx, mesh):
    from ..utils import failpoint
    # chaos/supervisor hook: a `sleep(...)` here models a hung exchange at
    # the MPP fragment boundary (the analog of device-agg-exec /
    # device-join-exec)
    failpoint.inject("device-mpp-exec")
    n_shards = mesh.shape[AXIS]

    # The shard leaf must sit on the probe (left) spine: every join's
    # build side must be complete on every shard. Orient the tree so the
    # LARGEST table is that leaf — inner-join probe/build sides are a
    # physical choice, and the global column offsets are untouched. This
    # also minimizes broadcast volume: big table sharded, dimensions
    # replicated.
    bottom = None
    if joins:
        target = max(leaves, key=lambda lf: lf.chunk.num_rows).leaf_id
        node = root
        prev = None
        while isinstance(node, _JoinNode):
            if target in node.right.leaf_ids:
                node.left, node.right = node.right, node.left
                node.left_keys, node.right_keys = (
                    node.right_keys, node.left_keys)
            prev = node
            node = node.left
        shard_leaf = node.leaf_id
        bottom = prev  # the spine join directly over the sharded leaf
    else:
        shard_leaf = root.leaf_id
    shard_rows = leaves[shard_leaf].chunk.num_rows
    if shard_rows < n_shards:
        raise DeviceUnsupported("too few rows to shard over the mesh")

    # broadcast-vs-shuffle for the bottom join (reference: the planner
    # picks Broadcast vs HashPartition exchange by build-side size): when
    # the build-key leaf is itself fact-sized, hash-repartition it (and
    # the probe fact) over the mesh instead of replicating it. The other
    # build-subtree leaves stay replicated, so the subtree's local joins
    # remain co-partitioned by the exchanged key.
    shuffle_build = None
    if bottom is not None:
        bleaf = _build_key_leaf(bottom, leaves)
        if bleaf is not None:
            try:
                bc_rows = int(ctx.get_sysvar(
                    "tidb_broadcast_join_threshold_count"))
            except Exception:
                bc_rows = 10 * 1024
            build_rows = bleaf.chunk.num_rows
            if (bc_rows > 0 and build_rows > bc_rows
                    and build_rows >= n_shards):
                shuffle_build = bleaf.leaf_id
                # skew guard: a Hash exchange sends every row of a key to
                # ONE shard, so a hot build key overflows one bucket while
                # the other shards idle. The host knows the hottest key's
                # row count from the build side's join index (numpy,
                # cached per table version); when it dwarfs the uniform
                # share, take the Broadcast exchange instead
                from .device_join import _leaf_index
                # right_keys are subtree-relative; rebase to bleaf-local
                local = [_shift_expr(k, bottom.right.offset - bleaf.offset)
                         for k in bottom.right_keys]
                bidx = _leaf_index(bleaf, local)
                if bidx is not None:
                    even_share = max(build_rows // n_shards, 1)
                    if bidx.max_cnt > 4 * even_share:
                        shuffle_build = None
                        MPP_STATS["skew_broadcasts"] = (
                            MPP_STATS.get("skew_broadcasts", 0) + 1)
    sharded_ids = [shard_leaf] + (
        [shuffle_build] if shuffle_build is not None else [])

    # canonical BUCKET shapes per leaf: a sharded leaf buckets its
    # PER-SHARD row count (total = psb * n_shards keeps the shard split
    # exact); a replicated leaf buckets its whole length. Placements pad
    # to the bucket and each shard masks at its live count, so a
    # within-bucket INSERT re-dispatches the cached pipeline.
    per_double = dev.shape_buckets(ctx)
    leaf_total = {}
    leaf_psb = {}
    for leaf in leaves:
        rows = leaf.chunk.num_rows
        if leaf.leaf_id in sharded_ids:
            per_shard = -(-rows // n_shards)
            psb = dev.bucket_rows(per_shard, per_double)
            leaf_psb[leaf.leaf_id] = psb
            leaf_total[leaf.leaf_id] = psb * n_shards
        else:
            leaf_total[leaf.leaf_id] = dev.bucket_rows(rows, per_double)

    # metadata-only planning view (no uploads — placement happens once,
    # below): the expression compiler and agg planner read only
    # ftype/dictionary/host_col
    host_cols = {}
    dcols = {}
    for leaf in leaves:
        for i, c in enumerate(leaf.chunk.columns):
            dc, (hd, hn) = dev.meta_device_col(c)
            dcols[leaf.offset + i] = dc
            host_cols[leaf.offset + i] = (c, hd, hn)

    key_fns, key_meta, key_pack, val_plan, agg_ops, slots = _plan_agg(
        plan, dcols)
    if any(op not in _MERGE_OP for op in agg_ops):
        # cnt_dist partial states don't merge across shards (counts, not
        # sets) — the single-device kernel handles distinct
        raise DeviceUnsupported("non-mergeable agg on the mesh path")
    agg_meta = (key_fns, val_plan, agg_ops, slots)

    # mesh placement: sharded fact (and shuffled build) columns +
    # replicated dimensions, bucket-padded, residency-ledgered
    env = {}
    for leaf in leaves:
        sharded = leaf.leaf_id in sharded_ids
        for i in range(leaf.ncols):
            c, hd, hn = host_cols[leaf.offset + i]
            env[leaf.offset + i] = _place_col(
                c, hd, hn, mesh, sharded, leaf_total[leaf.leaf_id])
    # per-leaf LIVE row counts (leaf_id order), run-time inputs of the
    # pipeline: a row-count change inside the bucket is a re-dispatch
    n_lives = tuple(int(leaf.chunk.num_rows) for leaf in leaves)

    # the cache signature carries the mesh shape, its layout and devices,
    # the per-leaf bucket tuple and (inside fragment_sig) every dictionary
    # CONTENT sig
    sig = ("mpp", n_shards, mesh.key,
           fragment_sig(leaves, joins, agg_conds, plan),
           tuple(sharded_ids),
           tuple(leaf_total[leaf.leaf_id] for leaf in leaves))
    dict_refs = tuple(dc.dictionary for dc in dcols.values()
                      if dc.dictionary is not None)
    bottom_idx = joins.index(bottom) if bottom is not None else -1

    # static capacities: per-shard bucketed probe rows bound the bottom
    # join; each join's output bounds the next (FK heuristic, grown on
    # overflow). With shuffle, each exchanged side gets a per-SUB-bucket
    # capacity (~2x the uniform share), and the bottom join's probe side
    # becomes the post-exchange n_shards*RADIX_SUB*cap_l rows. All start
    # from the LEARNED converged values when this signature has run before.
    per_shard_b = leaf_psb[shard_leaf]  # always sharded: filled above
    xcaps = None
    if shuffle_build is not None:
        learned_x = _CAP_STORE.get((sig, "xcaps"))
        if learned_x is not None:
            xcaps = list(learned_x)
        else:
            nb = n_shards * RADIX_SUB
            build_psb = leaf_psb[shuffle_build]
            xcaps = [dev.next_pow2(max(2 * (-(-per_shard_b // nb)), 8)),
                     dev.next_pow2(max(2 * (-(-build_psb // nb)), 8))]

    def leaf_rows(nd):
        if xcaps is not None and nd.leaf_id == shard_leaf:
            return n_shards * RADIX_SUB * xcaps[0]
        if nd.leaf_id == shard_leaf:
            return per_shard_b
        return leaf_total[nd.leaf_id]

    def est_rows(nd):
        # FK-join heuristic: output ≈ larger input, composed over the
        # subtree
        if isinstance(nd, _Leaf):
            return max(leaf_rows(nd), 8)
        return max(est_rows(nd.left), est_rows(nd.right))

    learned_caps = _CAP_STORE.get((sig, "caps"))
    if learned_caps is not None and len(learned_caps) == len(joins):
        caps = list(learned_caps)
    else:
        caps = [dev.next_pow2(est_rows(jn)) for jn in joins]
    n_frag = caps[-1] if caps else per_shard_b
    learned_cap = _CAP_STORE.get((sig, "agg"))
    if learned_cap is not None:
        capacity = learned_cap
    else:
        est = _estimate_groups(plan, n_frag, ctx)
        capacity = dev.next_pow2(min(max(n_frag, 16), max(est, 16)))

    # retry discipline (reference: the Backoffer every coprocessor/MPP
    # dispatch carries): exchange transport faults back off and retry on
    # the SAME capacities; bucket/group overflow "retries" are rebuilds at
    # larger capacity and draw from a separate attempt budget. Exhausting
    # the transport budget surfaces a classified BackoffExhaustedError
    # (and trips the device breaker); exhausting the growth budget
    # degrades to the host engine.
    from ..errors import BackoffExhaustedError
    from ..utils.backoff import Backoffer, ExchangeError
    from ..utils.failpoint import FailpointError
    from .device_exec import AggFetch
    bo = Backoffer.for_session(ctx)
    while True:
        shuffle = None
        if shuffle_build is not None:
            shuffle = (bottom, shard_leaf, shuffle_build,
                       xcaps[0], xcaps[1])
        key = (sig, tuple(caps), tuple(xcaps or ()), capacity, key_pack,
               tuple(agg_ops))

        def build(shuffle=shuffle, caps=tuple(caps), cap=capacity):
            return _build_mpp_pipeline(
                mesh, root, leaves, joins, plan, agg_conds, sharded_ids,
                caps, cap, key_pack, agg_meta, shuffle=shuffle)
        fn = acquire_pipeline(key, build, dict_refs, ctx=ctx,
                              shape="mpp", sig=sig)
        try:
            failpoint.inject("mpp-exchange-send")
            agg_out, png_d, ovfs_d, sovfs_d, xneeds_d, fault_d = fn(
                env, n_lives)
            f = AggFetch(agg_out, extras=(png_d, ovfs_d, sovfs_d, xneeds_d,
                                          fault_d))
            failpoint.inject("mpp-exchange-recv")
        except (FailpointError, ExchangeError, ConnectionError,
                TimeoutError) as e:
            # narrow on purpose: FileNotFoundError-class OSErrors are
            # bugs, not transient exchange weather — they must surface
            exc = (e if isinstance(e, ExchangeError)
                   else ExchangeError(f"mpp exchange failed: {e}"))
            try:
                bo.backoff("exchangeRetry", exc)
            except BackoffExhaustedError:
                from .circuit import get_breaker
                # the same SESSION owner token AND fragment shape
                # run_device's allow() used (join trees dispatch under
                # shape="join")
                get_breaker(ctx,
                            shape="join" if joins else "agg").record_failure(
                    exc, session=getattr(ctx, "conn_id", None))
                raise
            MPP_STATS["exchange_retries"] += 1
            continue
        png, ovfs, sovfs, xneeds, fault = f.extras
        # the fold's fault word, fetched with n_groups: a shard state out
        # of the fold's order raises
        merge_states.check_fault(fault)
        fng = f.ng
        if any(int(s) for s in sovfs):
            raise DeviceUnsupported(
                "multi-key join value ranges exceed int64 packing")
        retry = False
        x_grew = False
        for i, need in enumerate(xneeds):
            if int(need) > xcaps[i]:
                # jump straight to the worst sub-bucket's exact
                # requirement: one retry converges even under a dominant
                # hot key
                xcaps[i] = dev.next_pow2(int(need))
                retry = True
                x_grew = True
                MPP_STATS["exchange_overflow_retries"] += 1
        if x_grew:
            # the bottom join's probe side grew with the exchange bucket
            caps[bottom_idx] = max(
                caps[bottom_idx],
                dev.next_pow2(max(n_shards * RADIX_SUB * xcaps[0], 8)))
        for i, o in enumerate(ovfs):
            if int(o) > caps[i]:
                # jump to the worst shard's exact requirement in one step
                caps[i] = dev.next_pow2(int(o))
                retry = True
        max_ng = max(int(png), int(fng))
        if max_ng > capacity:
            capacity = dev.next_pow2(max_ng)
            retry = True
        if not retry:
            break
        MPP_STATS["retries"] += 1
        try:
            bo.backoff("exchangeGrow")
        except BackoffExhaustedError as e:
            raise DeviceUnsupported(
                "mpp fragment capacities did not converge") from e
    # remember the converged shapes per signature: the next execution
    # starts at these exact capacities and hits the cached pipeline
    _cap_store_put((sig, "caps"), tuple(caps))
    if xcaps is not None:
        _cap_store_put((sig, "xcaps"), tuple(xcaps))
    _cap_store_put((sig, "agg"), capacity)
    ng = int(fng)
    if ng == 0 and not plan.group_exprs:
        raise DeviceUnsupported("empty global aggregate")
    MPP_STATS["fragments"] += 1
    if shuffle_build is not None:
        MPP_STATS["shuffle_joins"] += 1
    _publish_gauges(ctx)
    body = f.body()
    return _assemble_agg(plan, key_meta, slots, dcols, body, f.out_rows)
