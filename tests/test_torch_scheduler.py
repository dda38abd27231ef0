"""The serving front end (``executor/scheduler.py``, a copy of the
reference's) against the reference: every case of tests/test_scheduler.py
runs in both packages through ``torch_dual.dual`` — the reference body on
the reference's fixtures, then the same body retargeted to
``tidb_tpu_torch`` on the port's (device engine on the CPU's plain
kernels), each with the reference test's assertions — and the scheduler's
record of the two runs must be equal: how far each counter of
``scheduler.snapshot()`` moved (but the split of grants between the fast
path and the queue, which thread timing decides, and the wait times).

``TestNoDirectDispatchLint`` runs the supervised-dispatch confinement
rule over each package's own tree with its own lint
(``tidb_tpu_torch/lint`` on the port's side).
"""

import pytest

from tidb_tpu_torch.ops import device as tdev
from torch_dual import dual


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _record(m):
    snap = m.scheduler.snapshot()
    return {k: v for k, v in snap.items()
            if isinstance(v, (int, float)) and not k.endswith("_ms")
            and k not in ("fast_grants", "queued")}


globals().update(dual("test_scheduler.py", record=_record))
