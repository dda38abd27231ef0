"""The device circuit breaker (``executor/circuit.py``, a copy of the
reference's) against the reference: the breaker cases of
tests/test_resilience.py (``TestCircuitBreakerUnit`` and
``TestCircuitBreakerEndToEnd``) run in both packages through
``torch_dual.dual`` — the reference body on the reference's ``tk``, then
the body retargeted to ``tidb_tpu_torch`` on the port's (device engine
on the CPU's plain kernels), each with the reference test's assertions
— and the breakers' record of the two runs must be equal: every breaker
the body made, in the order it made them, with its shape, state,
failure count, threshold and counters (not its last error's text).
"""

import importlib
import weakref

import pytest

from tidb_tpu_torch.ops import device as tdev
from torch_dual import dual

#: the breakers each package made since the current test began
_MADE = {}


def _track(pkg):
    cls = importlib.import_module(f"{pkg}.executor.circuit").CircuitBreaker
    made = _MADE[pkg] = []
    init = cls.__init__

    def tracked(self, *a, **kw):
        init(self, *a, **kw)
        made.append(weakref.ref(self))
    return cls, init, tracked


@pytest.fixture(autouse=True)
def _breakers_made(monkeypatch):
    for pkg in ("tidb_tpu", "tidb_tpu_torch"):
        cls, _init, tracked = _track(pkg)
        monkeypatch.setattr(cls, "__init__", tracked)
    yield


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _record(m):
    pkg = m.CircuitBreaker.__module__.split(".")[0]
    out = []
    for ref in _MADE.get(pkg, ()):
        br = ref()
        if br is None:
            continue
        snap = br.snapshot()
        out.append((snap["shape"], snap["state"], snap["failures"],
                    snap["threshold"],
                    tuple(sorted((k, v) for k, v in snap.items()
                                 if k not in ("state", "shape", "failures",
                                              "threshold", "cooldown_s",
                                              "last_error", "by_group")))))
    return out


globals().update(dual(
    "test_resilience.py", record=_record,
    classes=("TestCircuitBreakerUnit", "TestCircuitBreakerEndToEnd")))
