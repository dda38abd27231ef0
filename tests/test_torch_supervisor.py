"""Device-runtime supervision (``executor/supervisor.py``) against the
reference: every case of tests/test_supervisor.py runs in both packages
through ``torch_dual.dual`` — the reference body on the reference's
fixtures, then the body retargeted to ``tidb_tpu_torch`` on the port's
(device engine on the CPU's plain kernels), each with the reference
test's assertions — and the supervisor's record of the two runs must be
equal: how far each counter of ``supervisor.snapshot()`` moved (hangs,
fences, reinits; not the worker pool's size, which the earlier tests of
a process decide).

One edit on the port's side: ``test_mpp_fragment_hang`` sets
``tidb_mpp_devices = 8`` first, since the port's mesh takes its shard
count from that sysvar alone and the default 0 gives no mesh (ROADMAP
queue 3, the mesh divergence).  Not here:
``TestRunDeviceShapeLint`` (the run_device ``shape=`` rule) waits for
the port's ``lint/`` (ROADMAP queue 1 item 4).
"""

import pytest

from tidb_tpu_torch.ops import device as tdev
from torch_dual import dual


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _record(m):
    snap = m.supervisor.snapshot()
    return {k: v for k, v in snap.items()
            if isinstance(v, int) and not isinstance(v, bool)
            and "worker" not in k}


globals().update(dual(
    "test_supervisor.py", record=_record,
    exclude=("TestRunDeviceShapeLint",),
    patches=[('''    def test_mpp_fragment_hang(self, tk):
        tk.must_exec("set tidb_executor_engine = 'tpu-mpp'")''',
              '''    def test_mpp_fragment_hang(self, tk):
        tk.must_exec("set tidb_mpp_devices = 8")
        tk.must_exec("set tidb_executor_engine = 'tpu-mpp'")''')]))
