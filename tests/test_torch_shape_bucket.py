"""Bucketed shapes and the compiled-fragment cache against the
reference: every case of tests/test_shape_bucket.py runs in both packages
through ``torch_dual.dual`` — the reference body on the reference's
fixtures, then the body retargeted to ``tidb_tpu_torch`` on the port's
(device engine on the CPU's plain kernels), each with the reference
test's assertions — and the two runs' records must be equal: how many
pipelines each traced (``pipe_cache_stats()["traces"]``).

In the port a trace is a pipeline's first call at an argument shape
(``device_exec._Pipeline``): the first launches at a new row bucket,
where the reference retraces and recompiles.  So a delta inside a bucket
traces nothing in either package, and a table that grows past a bucket
traces its pipeline once more in both
(``test_agg_one_recompile_per_bucket_crossing``) — the case the compile
layer's ladder warms ahead.
"""

import pytest

from tidb_tpu_torch.ops import device as tdev
from torch_dual import dual


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    tdev.set_device("cpu")
    yield


def _record(m):
    return {"traces": m.pipe_cache_stats()["traces"]}


globals().update(dual("test_shape_bucket.py", record=_record))
