"""Rule registry population: importing this package registers every rule
with the engine (tidb_tpu_torch.lint.engine.RULES)."""

from . import confinement  # noqa: F401
from . import exceptions  # noqa: F401
from . import failpoints  # noqa: F401
from . import gauges  # noqa: F401
from . import guards  # noqa: F401
from . import locks  # noqa: F401
from . import sysvar_scope  # noqa: F401
from . import taxonomy  # noqa: F401
from . import trace_cov  # noqa: F401
from . import traced  # noqa: F401
