"""MPP distributed operators over a device mesh (reference K11:
``tidb_tpu/parallel/mpp.py``).

Reference mapping (as in the reference): fragment exchanges become
collectives — hash exchange = ``all_to_all``, broadcast = ``all_gather``,
final merge = ``psum`` / ``pmax`` (here a broadcast side is a replicated
array and the gather + final merge one fold of the shards' states on
shard 0's device); parallel partial/final hash aggregation is a per-shard
partial group-by, a gather of the bounded partial states and one final
merge; the shuffled hash join hash-partitions both sides by key, joins
each shard locally and sums.

A :class:`Mesh` holds one device a shard, as the reference's ``Mesh(
np.asarray(devs))`` does, in one of two layouts:

* **local** — every shard on one device (the reference tests its mesh on
  8 virtual host devices; one card holds the same SPMD program as n
  shards).  A SHARDED array is one padded tensor of ``psb * n`` rows
  whose shard i is the view ``[i*psb, (i+1)*psb)`` (the reference's
  row-slice layout); a REPLICATED array is one tensor every shard reads.
* **split** — one shard a device (a card each, or several shards on
  one).  A sharded array is a :class:`Split` of n tensors, shard i's on
  ``devices[i]``; a replicated array a :class:`Split` of one copy a
  device.

One process drives every shard, as the reference's session thread does:
each shard's kernels launch on its own card (``ops/kernels/build.py
launch``), issued one shard after another from the calling thread, so
the cards overlap wherever nothing synchronises between shards.  The
collectives are tensor copies (between cards, ``cudaMemcpyPeerAsync``
through torch's ``copy_``) and reductions between kernel launches, and
the host reads a step's flags once.  The kernels: K1
(``ops/kernels/groupby_agg.py``) for each shard's partial, the
partial-state fold (``merge_states.py``) as the gather + final merge,
kernel A (``radix_exchange.py``) for the hash partition, K5a's range
pass, K4's order and K5a's sorted probe for the local join, and kernel B
(``shuffle_join.py``) for its sum.

Everything is static-shape: partial states are ``capacity``-bounded,
exchange buckets ``cap``-bounded with overflow counted and reported, so
the host can retry with a larger capacity (never silently wrong).
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

#: sub-buckets per destination shard in the two-level radix partition
#: (power of two: the sub index is a low-bit mask of the mixed hash)
RADIX_SUB = 4


class Split(tuple):
    """An array of a split mesh: a tensor a shard, shard i's on the
    mesh's ``devices[i]``.  Sharded, tensor i holds shard i's rows;
    replicated, every tensor is the whole array (shards on one device
    share its one copy).  ``shape`` and ``nbytes`` are the array's, over
    every device, so the residency ledger charges each card's bytes."""

    replicated = False

    def __new__(cls, parts, replicated=False):
        self = super().__new__(cls, parts)
        self.replicated = replicated
        return self

    @property
    def shape(self):
        if self.replicated:
            return self[0].shape
        return (sum(int(t.shape[0]) for t in self),) + tuple(
            self[0].shape[1:])

    @property
    def nbytes(self) -> int:
        seen = {id(t): t for t in self}
        return sum(int(t.nbytes) for t in seen.values())


class Mesh:
    """A 1-D mesh of ``n`` shards: ``devices[i]`` is shard i's device.

    ``Mesh(n, device=d)`` is the LOCAL layout (n shards on `d`);
    ``Mesh(devices)`` (a sequence of devices) the SPLIT layout, one
    tensor a shard.  ``shape[axis]`` is the shard count, as on a jax
    Mesh; ``device`` is shard 0's, where the collectives' results land.

    * :meth:`all_to_all` — per-shard grids of ``n`` equal blocks in, per
      shard the blocks addressed to it out, in source order (a tiled
      ``lax.all_to_all`` with split and concat axis 0);
    * :meth:`psum` / :meth:`pmax` — one reduction over the shards' 0-d
      tensors, on shard 0's device;
    * :meth:`gather` — tensors brought to shard 0's device (the
      all_gather before a replicated final merge)."""

    def __init__(self, n, axis: str = "part", device=None):
        if isinstance(n, int):
            if n < 1:
                raise ValueError("a mesh needs at least one shard")
            self.split = False
            d = torch.device(device) if device is not None else None
            self.devices = (d,) * n
        else:
            if device is not None:
                raise ValueError("a split mesh takes its devices alone")
            self.devices = tuple(torch.device(d) for d in n)
            if not self.devices:
                raise ValueError("a mesh needs at least one shard")
            self.split = True
        self.axis = axis
        self.n = len(self.devices)
        self.device = self.devices[0]
        self.shape = {axis: self.n}
        #: what :meth:`all_to_all` moved: calls, and bytes copied from
        #: one device to another (0 on the local layout)
        self.stats = {"all_to_all": 0, "bytes_between_devices": 0}

    @property
    def key(self) -> tuple:
        """The layout and the devices: what a pipeline built for this
        mesh depends on."""
        return ("split" if self.split else "local",
                tuple(str(d) for d in self.devices))

    def __repr__(self):
        if self.split:
            return (f"Mesh({self.n} shards on "
                    f"{[str(d) for d in self.devices]}, axis={self.axis!r})")
        return f"Mesh({self.n} shards on {self.device}, axis={self.axis!r})"

    def shard(self, t, i: int):
        """Shard i's rows of the sharded array `t` (a view locally)."""
        if isinstance(t, Split):
            return t[i]
        psb = t.shape[0] // self.n
        return t[i * psb:(i + 1) * psb]

    def replica(self, t, i: int):
        """Shard i's copy of the replicated array `t`."""
        return t[i] if isinstance(t, Split) else t

    def place(self, arr, sharded: bool):
        """The host array `arr` (its length a multiple of the shard count
        when sharded) on the mesh (``ops/device.upload``): one upload
        locally; split, shard i's rows to ``devices[i]``, or the whole
        array once to every distinct device."""
        from ..ops.device import upload
        if not self.split:
            return upload(arr, self.device)
        if sharded:
            psb = arr.shape[0] // self.n
            return Split([upload(arr[i * psb:(i + 1) * psb], d)
                          for i, d in enumerate(self.devices)])
        copies = {}
        for d in self.devices:
            if str(d) not in copies:
                copies[str(d)] = upload(arr, d)
        return Split([copies[str(d)] for d in self.devices],
                     replicated=True)

    def all_to_all(self, grids):
        """grids[i]: shard i's send grid, ``n`` equal blocks by
        destination.  Returns the received grid of every shard: block i of
        shard j's is block j of grids[i].  Locally one copy
        (``torch.stack`` along the source axis), the results views of it;
        split, one grid a destination on its device, each block copied
        there (asynchronous between cards)."""
        n = self.n
        blk = grids[0].shape[0] // n
        self.stats["all_to_all"] += 1
        if not self.split:
            x = torch.stack([g.view(n, blk) for g in grids], dim=1)
            return list(x.view(n, n * blk).unbind(0))
        out = []
        for j, d in enumerate(self.devices):
            recv = torch.empty((n, blk), dtype=grids[0].dtype, device=d)
            for i, g in enumerate(grids):
                recv[i].copy_(g.view(n, blk)[j], non_blocking=True)
                if g.device != d:
                    self.stats["bytes_between_devices"] += (
                        blk * g.element_size())
            out.append(recv.view(n * blk))
        return out

    def gather(self, tensors):
        """`tensors` on shard 0's device, in order; a tensor there already
        (every tensor of a local mesh) is returned as it is."""
        if not self.split:
            return list(tensors)
        return [t if t.device == self.device
                else t.to(self.device, non_blocking=True) for t in tensors]

    def gather_states(self, states):
        """K1 partial states (keys, key NULL flags, results, result NULL
        flags, n_groups, valid) on shard 0's device, for the fold there."""
        if not self.split:
            return list(states)

        def move(part):
            if isinstance(part, tuple):
                return tuple(self.gather(part))
            return self.gather([part])[0]
        return [s if s[4].device == self.device
                else tuple(move(p) for p in s) for s in states]

    def psum(self, scalars):
        return torch.stack(self.gather(list(scalars))).sum()

    def pmax(self, scalars):
        return torch.stack(self.gather(list(scalars))).max()


def make_mesh(n_devices: int | None = None, axis: str = "part",
              device=None, devices=None) -> Mesh:
    """`devices` given: a split mesh, shard i on ``devices[i]``.  Else a
    local mesh of `n_devices` shards (default: one per visible CUDA card,
    as many as the reference's ``jax.devices()``) on `device` (default:
    the port's device, ``ops/device.device()`` — CUDA unless the caller
    asked for the CPU)."""
    if devices is not None:
        return Mesh(list(devices), axis)
    if device is None:
        from ..ops import device as dev
        device = dev.device()
    if n_devices is None:
        n_devices = max(torch.cuda.device_count(), 1)
    return Mesh(int(n_devices), axis, device)


def shard_batch(mesh: Mesh, *arrays, axis: str = "part"):
    """Pad each 1-D array to a multiple of the mesh size and put it on the
    mesh sharded (:meth:`Mesh.place`).  Returns (padded_arrays,
    valid_mask), as the reference's ``shard_batch``."""
    n_shards = mesh.shape[axis]
    n = np.asarray(arrays[0]).shape[0]
    pad = (-n) % n_shards
    out = []
    for a in arrays:
        a = np.asarray(a)
        if pad:
            a = np.concatenate([a, np.zeros(pad, dtype=a.dtype)])
        out.append(mesh.place(a, True))
    valid = np.ones(n + pad, dtype=bool)
    if pad:
        valid[n:] = False
    return out, mesh.place(valid, True)


# ---------------------------------------------------------------------------
# local bounded aggregation (shared by partial and final stages)
# ---------------------------------------------------------------------------

def _agg_ops(vals, kinds):
    ops = []
    for v, kind in zip(vals, kinds):
        if kind == "sum":
            ops.append("sum_f" if v.is_floating_point() else "sum_i")
        elif kind == "count":
            ops.append("sum_i")  # 0/1 int64 values: the count is their sum
        elif kind in ("min", "max"):
            ops.append(kind)
        else:
            raise ValueError(kind)
    return tuple(ops)


def _local_state(keys, valid, vals, kinds, capacity):
    """K1 over one shard: the full partial state (keys, key_nulls,
    results, result_nulls, n_groups, valid)."""
    from ..ops.kernels import groupby_agg
    z = torch.zeros(keys.shape[0], dtype=torch.bool, device=keys.device)
    return groupby_agg.groupby_agg(
        (keys.to(torch.int64),), (z,), tuple(vals), tuple(z for _ in vals),
        valid, 1, _agg_ops(vals, kinds), capacity)


def _local_agg(keys, valid, vals, kinds, capacity):
    """Group `vals` by int64 `keys` (invalid rows ignored) into at most
    `capacity` groups on K1.  Returns (group_keys[cap], outs tuple[cap],
    out_valid[cap], n_groups) with the groups in ascending key order, as
    the reference's ``_local_agg``."""
    st = _local_state(keys, valid, vals, kinds, capacity)
    return st[0][0], tuple(st[2]), st[5], st[4]


def _supervised_step(step, ctx):
    """Route an exchange-dispatch step through the device-runtime
    supervisor (executor/supervisor.py) when the caller's context carries
    a deadline (``tidb_device_call_timeout`` / ``max_execution_time``): a
    step hung on the device raises a classified DeviceHangError instead
    of freezing the caller.  With no context (or no deadline) the step
    dispatches inline, unchanged.

    The SQL path's fragments (executor/mpp_exec.py) are admitted and
    supervised one level up, inside run_device; this hook serves direct
    library embedders of dist_agg_step / dist_join_agg_step, and holds an
    admission ticket too (executor/scheduler.py): a refusal surfaces as
    the classified DeviceAdmissionError (9009)."""
    if ctx is None:
        return step

    def call(*args, **kw):
        from ..executor import scheduler
        from ..executor.supervisor import call_supervised, deadline_for
        ticket = scheduler.admit(ctx, shape="mpp")
        try:
            # deadline AFTER the admission wait (run_device's ordering)
            deadline_s, fence = deadline_for(ctx)
            return call_supervised(step, args, kw, deadline_s=deadline_s,
                                   ctx=ctx, shape="mpp",
                                   label="mpp exchange",
                                   fence_on_expiry=fence)
        finally:
            scheduler.release(ticket)

    return call


def _built(step, t0):
    """Count the step's build in the shared pipeline stats (the
    reference's compile accounting of its jitted dist_* steps)."""
    from ..executor.device_exec import _timed_jit
    return _timed_jit(step, t0)


def dist_agg_step(mesh: Mesh, kinds: tuple, capacity: int,
                  axis: str = "part", ctx=None):
    """The distributed group-by step (partial → gather → final).  Inputs
    are sharded over `axis`:
        keys  int64[N]      group key codes
        valid bool[N]       row mask (filter result & padding)
        *vals               one tensor per aggregate, aligned with `kinds`
    `kinds`: "sum" | "count" | "min" | "max" ("count" vals 0/1 int64).
    Returns (group_keys[cap], outs, out_valid[cap], n_groups, overflowed,
    fault): each shard's partial on K1, then ONE partial-state fold of the
    n states in shard order (the all_gather and the final merge); overflow
    is ``max(pmax(partial n_groups), final n_groups) > capacity``.  All
    stay on the device; `fault` is the fold's fault word (the reference
    has no such output), which the caller hands to
    ``merge_states.check_fault`` where it reads n_groups: a shard state
    out of the fold's order raises ``FoldOrderError``."""
    t0 = _time.perf_counter()
    n = mesh.shape[axis]
    kinds = tuple(kinds)

    def step(keys, valid, *vals):
        states = [_local_state(mesh.shard(keys, i), mesh.shard(valid, i),
                               [mesh.shard(v, i) for v in vals], kinds,
                               capacity) for i in range(n)]
        from ..ops.kernels import merge_states
        ops = _agg_ops([mesh.shard(v, 0) for v in vals], kinds)
        states = mesh.gather_states(states)
        out = merge_states.merge(states, 1, ops, capacity)
        png = mesh.pmax([s[4] for s in states])
        overflow = torch.maximum(png, out[4]) > capacity
        return (out[0][0], tuple(out[2]), out[5], out[4], overflow,
                merge_states.fault_word(out))

    return _supervised_step(_built(step, t0), ctx)


# ---------------------------------------------------------------------------
# hash-partition shuffle join (+ aggregate) over the mesh
# ---------------------------------------------------------------------------

def _exchange_hash(mesh, keys, vals, valid, n_dest, cap):
    """Radix-partition exchange of sharded `keys` / `vals` / `valid`:
    kernel A hashes and partitions each shard's rows into its
    ``[n_dest, RADIX_SUB, cap]`` grid, and one ``all_to_all`` moves the
    grids.  After it every row on shard j satisfies mix64(key) high bits
    mod n_dest == j.  Returns (keys, vals, valid, dropped): per shard
    lists of the received grids, and the per-source dropped counts."""
    from ..ops.kernels import radix_exchange as rx
    grids, dropped = [], []
    for i in range(mesh.n):
        k = mesh.shard(keys, i)
        h, ok = rx.dest_hash([k], "single", valid=mesh.shard(valid, i))
        part = rx.partition(h, ok, n_dest, RADIX_SUB, cap,
                            [k] + [mesh.shard(v, i) for v in vals])
        grids.append([part["valid"]] + part["cols"])
        dropped.append(part["dropped"])
    recv = [mesh.all_to_all([g[c] for g in grids])
            for c in range(len(grids[0]))]
    return recv[1], recv[2:], recv[0], dropped


def _local_join_sum(bk, bv, bvalid, pk, pv, pvalid):
    """One shard's sort join and sum: K5a's range pass (the valid build
    count and its invalid flags), K4's valid-first order of the build
    keys, K5a's sorted probe in count mode, kernel B's sum."""
    from ..ops.kernels import join_probe, shuffle_join, sort_topk
    zp = torch.zeros(pk.shape[0], dtype=torch.bool, device=pk.device)
    zb = torch.zeros(bk.shape[0], dtype=torch.bool, device=bk.device)
    pk2, pok, bk2, _bok, _ovf, nbv, binv = join_probe.key_range(
        [pk], [zp], pvalid, [bk], [zb], bvalid)
    order = sort_topk.valid_first_order(bk2, binv)
    pr = join_probe.probe([pk2], [None], pok, None, bk2, None, nbv,
                          layout="sorted", mode="count", order=order)
    return shuffle_join.join_sum(bv, order, pr["pos0"], pr["cnt"], pv, pok)


def dist_join_agg_step(mesh: Mesh, cap: int, axis: str = "part", ctx=None):
    """The distributed shuffled-hash-join + aggregate step (the MPP
    shuffle join fragment: Q3-shaped ``SUM(probe_val *
    matched_build_sum)``).

    Inputs sharded over `axis`:
        bk int64[Nb], bv [Nb], bvalid bool[Nb]   build side
        pk int64[Np], pv [Np], pvalid bool[Np]   probe side
    Returns (total, n_pairs, dropped): total = Σ over join pairs of
    pv * bv, n_pairs = the join's cardinality, dropped = rows lost to
    bucket overflow (retry with a bigger cap if > 0), each a 0-d tensor.
    `cap` bounds each radix SUB-bucket of the exchange (``[n_shards,
    RADIX_SUB, cap]`` slots per side and shard)."""
    t0 = _time.perf_counter()
    n = mesh.shape[axis]

    def step(bk, bv, bvalid, pk, pv, pvalid):
        bk2, (bv2,), bvalid2, bdrop = _exchange_hash(mesh, bk, (bv,), bvalid,
                                                     n, cap)
        pk2, (pv2,), pvalid2, pdrop = _exchange_hash(mesh, pk, (pv,), pvalid,
                                                     n, cap)
        sums = [_local_join_sum(bk2[j], bv2[j], bvalid2[j], pk2[j], pv2[j],
                                pvalid2[j]) for j in range(n)]
        total = mesh.psum([s[0] for s in sums])
        pairs = mesh.psum([s[1] for s in sums])
        dropped = mesh.psum(bdrop + pdrop)
        return total, pairs, dropped

    return _supervised_step(_built(step, t0), ctx)
