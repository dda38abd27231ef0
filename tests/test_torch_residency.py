"""The port's auto device-memory budget (tidb_tpu_torch/ops/residency.py
``_auto_budget``), with ``torch.cuda`` monkeypatched so that it runs on
the CPU.

With ``tidb_device_mem_budget = 0`` the ledger's budget is what torch's
caching allocator can hold on the card: the free memory at the first
probe plus what the allocator has already reserved there.  It is never
the card's total, which also counts the CUDA context and other
processes, and which would let the ledger admit uploads the card cannot
hold.  The reference reads the allocator's ``bytes_limit`` for the same
rule (tidb_tpu/ops/residency.py ``_auto_budget``).

Below those, every case of tests/test_residency.py runs in both packages
through ``torch_dual.dual`` — the reference body on the reference's
fixtures, then the body retargeted to ``tidb_tpu_torch`` on the port's
(device uploads on the CPU), each with the reference test's assertions
— and the ledger's record of the two runs must be equal: how far each
counter of ``residency.snapshot()`` moved from an empty ledger, resident
bytes included (in
the concurrent case, without the split between evictions and the
collector's releases, which timing decides).  One
edit on the port's side: ``test_publish_race_compare_and_keep`` races a
publish of torch tensors where the reference's are ``jax.numpy`` arrays.
``TestDeviceCacheLint`` runs the ``._device`` containment rule over each
package's own tree with its own lint (``tidb_tpu_torch/lint`` on the
port's side).
"""

import pytest
import torch

from tidb_tpu_torch.ops import device as tdev
from tidb_tpu_torch.ops import residency
from torch_dual import dual

GIB = 1 << 30


@pytest.fixture
def fake_card(monkeypatch):
    """Point the engine at "cuda" with a card whose memory the test sets;
    restores the device, the override and the memo after."""
    probes = {"free": 60 * GIB, "total": 80 * GIB, "reserved": 4 * GIB,
              "n": 0}

    def mem_get_info(dev=None):
        probes["n"] += 1
        return probes["free"], probes["total"]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda dev=None: probes["reserved"])
    saved = tdev._DEVICE[0], residency._BUDGET[0], residency._AUTO_BUDGET[0]
    tdev._DEVICE[0] = "cuda"
    residency._BUDGET[0] = 0
    residency._AUTO_BUDGET[0] = None
    yield probes
    tdev._DEVICE[0], residency._BUDGET[0], residency._AUTO_BUDGET[0] = saved


def test_auto_budget_is_free_plus_reserved(fake_card):
    got = residency._auto_budget()
    assert got == 64 * GIB
    assert got != fake_card["total"]
    assert residency.effective_budget() == 64 * GIB


def test_auto_budget_is_memoised(fake_card):
    assert residency._auto_budget() == 64 * GIB
    fake_card["free"], fake_card["reserved"] = 1 * GIB, 0
    assert residency._auto_budget() == 64 * GIB
    assert fake_card["n"] == 1


def test_override_wins_over_auto_budget(fake_card):
    residency.set_budget(5 * GIB)
    assert residency.effective_budget() == 5 * GIB
    assert fake_card["n"] == 0


def test_auto_budget_reprobes_after_set_device(fake_card):
    assert residency._auto_budget() == 64 * GIB
    fake_card["free"] = 10 * GIB
    tdev.set_device("cuda")
    assert residency._auto_budget() == 14 * GIB
    assert fake_card["n"] == 2


@pytest.mark.parametrize("dev, card", [("cpu", True), ("cuda", False)])
def test_auto_budget_unlimited_without_card(fake_card, monkeypatch, dev,
                                            card):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    tdev._DEVICE[0] = dev
    assert residency._auto_budget() == 0
    assert fake_card["n"] == 0


def test_ledger_evicts_under_auto_budget(fake_card):
    """An upload past the auto budget evicts the oldest entry before the
    card runs out, not after an OOM."""
    fake_card["free"], fake_card["reserved"] = 600, 400
    residency.evict_all("test start")
    try:
        owners = [residency.CacheOwner() for _ in range(2)]
        for o in owners:
            residency.publish(o, torch.zeros(75, dtype=torch.int64),
                              torch.zeros(0, dtype=torch.bool))
        assert owners[0]._device is None
        assert owners[1]._device is not None
        assert residency.resident_bytes() == 600
    finally:
        residency.evict_all("test end")


# -- tests/test_residency.py in both packages ---------------------------------

@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _record(m):
    snap = m.residency.snapshot()
    return {k: v for k, v in snap.items()
            if isinstance(v, int) and not isinstance(v, bool)}


globals().update(dual(
    "test_residency.py", record=_record,
    # both packages' ledgers start empty (the bodies' own isolation
    # evicts what earlier tests of the process left resident)
    reset=lambda m: m.residency.evict_all("dual test reset"),
    # four threads upload against one budget: which entries the LRU
    # evicts and which the collector releases first is timing
    unsteady={"TestTenantResidency.test_concurrent_multitenant_ledger_"
              "invariant": ("hbm_evictions", "hbm_evicted_bytes",
                            "gc_releases")},
    patches=[("""        import jax.numpy as jnp
        loser = (jnp.zeros(64, dtype=jnp.int64), jnp.zeros(64, dtype=bool))""",
              """        import torch
        loser = (torch.zeros(64, dtype=torch.int64),
                 torch.zeros(64, dtype=torch.bool))""")]))
