"""Device-runtime supervision (``executor/supervisor.py``) against the
reference: every case of tests/test_supervisor.py runs in both packages
through ``torch_dual.dual`` — the reference body on the reference's
fixtures, then the body retargeted to ``tidb_tpu_torch`` on the port's
(device engine on the CPU's plain kernels), each with the reference
test's assertions — and the supervisor's record of the two runs must be
equal: how far each counter of ``supervisor.snapshot()`` moved (hangs,
fences, reinits; not the worker pool's size, which the earlier tests of
a process decide).  Before each body the package's calls abandoned by
earlier tests of the process (another file's hang cases leave one
sleeping) are waited for, so none is reclaimed inside a body's record,
and the DDL workers the module's domains start are stopped after it
(``torch_dual.isolated``).

One edit on the port's side: ``test_mpp_fragment_hang`` sets
``tidb_mpp_devices = 8`` first, since on one device (here the CPU) the
port's mesh takes its shard count from that sysvar and the default 0
gives no mesh (ROADMAP queue 3, the mesh divergence).
``TestRunDeviceShapeLint`` runs the run_device ``shape=`` rule over each
package's own tree with its own lint (``tidb_tpu_torch/lint`` on the
port's side).
"""

import time

import pytest

from tidb_tpu_torch.ops import device as tdev
from torch_dual import dual, isolated  # noqa: F401

pytestmark = pytest.mark.usefixtures("isolated")


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _record(m):
    snap = m.supervisor.snapshot()
    return {k: v for k, v in snap.items()
            if isinstance(v, int) and not isinstance(v, bool)
            and "worker" not in k}


def _settle(m):
    """Wait (up to 5 s, as the reference's ``tk`` fixture does) for the
    package's abandoned calls to complete and be reclaimed."""
    deadline = time.monotonic() + 5.0
    while m.supervisor.abandoned_calls() and time.monotonic() < deadline:
        time.sleep(0.01)


globals().update(dual(
    "test_supervisor.py", record=_record, reset=_settle,
    patches=[('''    def test_mpp_fragment_hang(self, tk):
        tk.must_exec("set tidb_executor_engine = 'tpu-mpp'")''',
              '''    def test_mpp_fragment_hang(self, tk):
        tk.must_exec("set tidb_mpp_devices = 8")
        tk.must_exec("set tidb_executor_engine = 'tpu-mpp'")''')]))
