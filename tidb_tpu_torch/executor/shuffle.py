"""Host shuffle repartitioner (reference: executor/shuffle.go:77
ShuffleExec): hash-split rows into N worker shards keyed on partition
columns — every row of one partition group lands in exactly one shard —
then run a per-shard pipeline on a thread pool and scatter the results
back to the input row order.

The reference uses this to parallelize window / stream-agg / merge-join
over goroutine pipelines; here the shard workers are threads over
vectorized numpy kernels (which release the GIL in their hot loops), and
the device path remains the preferred engine for large inputs.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.chunk import Chunk, Column


def shard_by_groups(gids: np.ndarray, n_shards: int) -> np.ndarray:
    """Group id per row → shard id per row (splitByItems hashing)."""
    return (gids % np.int64(n_shards)).astype(np.int64)


def shuffle_execute(chunk: Chunk, gids: np.ndarray, n_shards: int,
                    worker_fn) -> Chunk:
    """Partition `chunk` into shards by group id, run `worker_fn(sub_chunk)`
    per shard concurrently, and reassemble outputs into the original row
    order. worker_fn must return a Chunk whose rows parallel its input."""
    n = chunk.num_rows
    shard_ids = shard_by_groups(gids, n_shards)
    row_sets = [np.nonzero(shard_ids == s)[0] for s in range(n_shards)]
    row_sets = [rs for rs in row_sets if len(rs)]
    if len(row_sets) <= 1:
        return worker_fn(chunk)

    def run(rs):
        return rs, worker_fn(chunk.take(rs))

    with ThreadPoolExecutor(max_workers=len(row_sets),
                            thread_name_prefix="shuffle") as pool:
        parts = list(pool.map(run, row_sets))

    # scatter each shard's rows back to their original positions
    first = parts[0][1]
    out_cols = []
    for ci, proto in enumerate(first.columns):
        if proto.data.dtype == object:
            data = np.empty(n, dtype=object)
            data[:] = b""
        else:
            data = np.zeros(n, dtype=proto.data.dtype)
        nulls = np.zeros(n, dtype=bool)
        for rs, sub in parts:
            data[rs] = sub.columns[ci].data
            nulls[rs] = sub.columns[ci].nulls
        out_cols.append(Column(proto.ftype, data, nulls))
    return Chunk(out_cols)
