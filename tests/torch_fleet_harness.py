"""Shared pieces of the port's durable-store and fleet tests
(tests/test_torch_{consistency,fabric}.py).

* :class:`PkgReplicas` — two replicas of one durable store over one
  shared log and one coordination segment, built from either package
  (``tidb_tpu`` or ``tidb_tpu_torch``), as tests/test_consistency.py's
  ``_Replicas`` builds them.
* :func:`transfer_schedule` — a seeded schedule of balance transfers on
  such replicas, some of them overlapping across the two, returning each
  transfer's outcome and the final rows.
* :data:`CPU_ENV` — a fleet's ``env_extra`` for port workers on the CPU.
"""

import importlib
import random
import threading

#: a port fleet's workers on the CPU (their kernels' plain versions)
CPU_ENV = {"TIDB_TPU_TORCH_DEVICE": "cpu"}


class PkgReplicas:
    """Slots 0 and 1 of package `pkg` over ``root/wal`` and
    ``root/coord.json``."""

    def __init__(self, pkg: str, root):
        coord = importlib.import_module(f"{pkg}.fabric.coord")
        self.wal = importlib.import_module(f"{pkg}.kv.wal")
        self.shared = importlib.import_module(f"{pkg}.kv.shared_store")
        self.store = importlib.import_module(f"{pkg}.kv.store")
        self.c0 = coord.Coordinator.create(str(root / "coord.json"),
                                           nslots=4)
        self.c1 = coord.Coordinator.attach(str(root / "coord.json"))
        self.c0.claim_slot(0)
        self.c1.claim_slot(1)
        self.wal_dir = str(root / "wal")
        self.s0 = self._mk(self.c0, 0)
        self.s1 = self._mk(self.c1, 1)

    def _mk(self, coord, slot):
        w = self.wal.WAL(self.wal_dir, coordinator=coord)
        eng = self.shared.DurableMVCCStore(
            w, coordinator=coord, slot=slot,
            oracle=self.shared.SegmentTSOracle(coord))
        eng.recover()
        s = self.store.Storage.__new__(self.store.Storage)
        s.mvcc = eng
        s.backend = type(eng).__name__
        s._lock = threading.Lock()
        return s

    def close(self):
        self.s0.close()
        self.s1.close()
        self.c1.close()
        self.c0.unlink()


def _acct(a: int) -> bytes:
    return b"acct%03d" % a


def _transfer(txn, src: int, dst: int, amt: int) -> bool:
    """Move `amt` from `src` to `dst` in `txn`; False (nothing written)
    when `src` holds less."""
    bs, bd = int(txn.get(_acct(src))), int(txn.get(_acct(dst)))
    if bs < amt:
        return False
    txn.put(_acct(src), str(bs - amt).encode())
    txn.put(_acct(dst), str(bd + amt).encode())
    return True


def _commit(txn, moved: bool) -> str:
    if not moved:
        txn.rollback()
        return "skip"
    try:
        txn.commit()
        return "ok"
    except Exception as e:  # noqa: BLE001 — the outcome is the result
        return str(getattr(e, "code", type(e).__name__))


def transfer_schedule(reps: PkgReplicas, seed: int = 15, accts: int = 6,
                      steps: int = 40, seed_bal: int = 100):
    """Run the seeded schedule; returns (outcomes, rows on slot 0, rows
    on slot 1).  A step is one transfer on one replica, or (three steps
    in ten) two transfers begun on both replicas before either commits,
    committed in the schedule's order."""
    t = reps.s0.begin()
    for a in range(accts):
        t.put(_acct(a), str(seed_bal).encode())
    t.commit()
    rng = random.Random(seed)
    sides = (reps.s0, reps.s1)
    out = []
    for _ in range(steps):
        first = rng.randrange(2)
        if rng.random() < 0.3:
            pair = [(sides[first], rng.sample(range(accts), 2)),
                    (sides[1 - first], rng.sample(range(accts), 2))]
            txns = [(side.begin(), keys) for side, keys in pair]
            moved = [_transfer(txn, *keys, rng.randint(1, 60))
                     for txn, keys in txns]
            out.append(tuple(_commit(txn, m)
                             for (txn, _k), m in zip(txns, moved)))
        else:
            src, dst = rng.sample(range(accts), 2)
            txn = sides[first].begin()
            out.append(_commit(txn, _transfer(txn, src, dst,
                                              rng.randint(1, 60))))
    rows = [dict(side.get_snapshot().scan(b"acct", b"acct~"))
            for side in sides]
    return out, rows[0], rows[1]


#: where :func:`probe_seed` writes each worker's module report
PROBE_DIR_ENV = "TORCH_FLEET_PROBE_DIR"


def probe_seed(domain, seeded: bool = False):
    """A fleet init hook: ``carry.fleet_seed``, and at the worker's exit
    a report of its command line and of any JAX or reference module it
    imported, written to ``$TORCH_FLEET_PROBE_DIR/<pid>.json``."""
    import atexit
    import json
    import os
    import sys
    from tidb_tpu_torch import carry
    carry.fleet_seed(domain, seeded=seeded)

    def report():
        path = os.path.join(os.environ[PROBE_DIR_ENV], f"{os.getpid()}.json")
        with open(path, "w") as f:
            json.dump({"argv": sys.argv, "seeded": seeded,
                       "forbidden": sorted(
                           m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib",
                                                  "tidb_tpu"))}, f)
    atexit.register(report)
