"""Cross-process serving fabric: an N-process fleet over shared devices.

Why this exists: without the fleet the engine
serves from ONE Python process, so the GIL — not the device — is the
ceiling on concurrent sessions.  The paper's reference architecture runs
many tidb-server instances over one store (PAPER.md layer map); this
package is that layer for the reproduction: a parent supervisor forks N
worker processes, each with its own Domain and MySQL wire listener
behind one advertised port (``SO_REUSEPORT``), in front of the shared
device and the shared compile artifacts.

The pieces:

* :mod:`~tidb_tpu_torch.fabric.fleet` — the parent supervisor: spawn N
  workers, restart-on-crash with backoff, drain-on-shutdown.
* :mod:`~tidb_tpu_torch.fabric.worker` — one serving process: Domain + wire
  listener + fleet-unique connection ids + lease heartbeat.
* :mod:`~tidb_tpu_torch.fabric.coord` — the shared-memory coordination
  segment (``multiprocessing.shared_memory`` + a lease-stamped
  coordinator file): fleet-wide WFQ virtual clocks, per-tenant running
  caps and HBM charges, fragment-dedup slots, crash-lease reclaim.
* :mod:`~tidb_tpu_torch.fabric.dedup` — result-identical fragment dedup:
  identical concurrent ``(plan sig, data sig, bucket shape)`` fragments
  anywhere in the fleet dispatch ONE device call; the result ships back
  through a per-fragment mmap page.
* :mod:`~tidb_tpu_torch.fabric.compile_server` / ``compile_client`` — the
  separated compile service: one server process builds the kernel
  library once per source digest for every worker and records the
  fleet's fragment signatures.
* :mod:`~tidb_tpu_torch.fabric.state` — this process's fabric identity (slot,
  coordinator handle, compile-server address) + the ``fabric_*`` gauges.
* :mod:`~tidb_tpu_torch.fabric.region` / :mod:`~tidb_tpu_torch.fabric.blob` /
  :mod:`~tidb_tpu_torch.fabric.coord_net` — the multi-host region layer:
  the keyspace sharded into N regions, each with its own
  WAL, epoch-fenced lease cells, and blob-store replication so a HOST
  loss is a region failover (a survivor restores checkpoint + tail and
  replays) instead of data loss; ``coord_net`` puts the segment's
  lease/epoch/claim/TSO surface behind a TCP service for cross-host
  callers.

The seven-layer resilience stack a fragment now passes: REGION (epoch-
fenced keyspace shards + blob failover) → FABRIC (process fleet +
dedup) → ADMISSION (fleet-coordinated WFQ) → COMPILE SERVICE →
SUPERVISOR deadline → BREAKER → RESIDENCY (fleet-aware tenant shares).

Confinement: direct ``multiprocessing.shared_memory`` use belongs to
this package, and so does raw ``socket`` use for coordination (the
MySQL wire protocol in ``server/`` is the one other legitimate socket
owner) — every other layer coordinates through :mod:`state`'s typed
hooks.  ``python -m tidb_tpu_torch.lint`` enforces both
(``shared-memory-confinement``, ``socket-confinement``); neither rule
takes an allowlist entry.
"""

from __future__ import annotations

#: fleet-unique connection ids: worker slot k mints ids with this base —
#: ``conn_id = ((slot + 1) << CONN_SLOT_SHIFT) + seq`` — so two workers
#: can never allocate the same id (KILL and slow-log attribution resolve
#: by conn id), and the slot is recoverable from any id for per-process
#: latency attribution in bench_serve's fleet mode.  24 bits keeps the
#: full id inside the MySQL handshake's u32 connection-id field (255
#: slots x 16M connections per incarnation).
CONN_SLOT_SHIFT = 24


def conn_id_base(slot: int) -> int:
    """The conn-id allocation base for worker ``slot`` (0-based)."""
    return (int(slot) + 1) << CONN_SLOT_SHIFT


def slot_of_conn_id(conn_id: int) -> "int | None":
    """The worker slot that minted ``conn_id``, or None for a
    non-fabric (single-process) id."""
    hi = int(conn_id) >> CONN_SLOT_SHIFT
    return hi - 1 if hi > 0 else None
