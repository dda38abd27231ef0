"""Project static analysis of the H100 port: ``python -m
tidb_tpu_torch.lint`` (see engine.py).

The engine and the rules are the reference's (``tidb_tpu/lint``), run
over ``tidb_tpu_torch/`` with an allowlist of their own.  Two rules are
retargeted to what the port runs, under new names:

* ``jit-confinement`` becomes ``launch-confinement``: the kernel library
  is loaded and its launchers declared only in ``ops/kernels/``, and
  every launcher call goes through ``ops/kernels/build.py launch``;
* ``traced-value-hazard`` becomes ``pipeline-host-sync``: a Python
  branch, ``int()`` or ``.item()`` on a pipeline body's argument, or
  on a local computed from one, is a host synchronisation, and each one
  is inventoried.
"""

from .engine import (Allowlist, Context, Finding, Report, Rule, RULES,  # noqa: F401
                     collect, default_allowlist_path, register, run_repo,
                     run_rule, run_rules, write_baseline)
