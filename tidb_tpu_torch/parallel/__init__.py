"""Parallel execution: a device mesh + MPP-style distributed operators
(reference: ``tidb_tpu/parallel``; planner/core/fragment.go exchange
fragments, store/copr/mpp.go task dispatch).

The port's mesh holds n shards, all on one device (local) or each on its
own (split), driven from one process: hash-partition shuffles are a
radix partition kernel and an all_to_all of equal slot blocks, broadcast
joins read a replicated array, and final aggregation merges are one fold
of the shards' partial states on shard 0's device (parallel/mpp.py)."""

from .mpp import (
    Mesh,
    make_mesh,
    dist_agg_step,
    dist_join_agg_step,
    shard_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "dist_agg_step",
    "dist_join_agg_step",
    "shard_batch",
]
