"""Host time the port's queries spend dispatching pipelines, to compare
two checkouts of ``tidb_tpu_torch`` on one card.

    python3 pipeline_dispatch_cost.py [--tree DIR] [--sf 1] [--reps 5]

Imports ``tidb_tpu_torch`` and ``chip_smoke`` (for its query texts) from
DIR (default: this script's folder), installs TPC-H at scale ``--sf``
with ``lineitem`` and ``orders`` paged (memmap, as chip_smoke's
``[paged-sf1]``: many pipeline calls a query), runs Q1, Q3 and Q5 on the
device engine in pages of ``PAGED_SF1_ROWS`` rows, once to warm and
``--reps`` times timed, and prints one JSON line: the card's name and
power limit, each query's wall ms per run and its row count.  Where the
tree's pipelines count a trace at each new argument shape
(``device_exec._Pipeline``), one more run of each query counts its
pipeline calls and times the shape walk each call makes.  To compare two
trees, run parent, change, change, parent in one call to the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NAMES = ("q1", "q3", "q5")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from tidb_tpu_torch import carry
    from tidb_tpu_torch.executor import device_exec
    from tidb_tpu_torch.ops import device
    from tidb_tpu_torch.session import bootstrap_domain, new_session
    device.set_device("cuda")
    device.device()
    sqls = dict(chip_smoke.QUERIES)
    root = tempfile.mkdtemp(prefix="tidb-dispatch-")
    out = {"tree": tree, "card": card(), "sf": args.sf, "reps": args.reps}
    try:
        dom = bootstrap_domain()
        s = new_session(dom)
        carry.install_tpch(s.execute, dom, "tpch", carry.gen_tpch(
            args.sf, seed=args.seed), paged_root=root)
        s.execute("use tpch")
        s.execute("set @@tidb_executor_engine = 'tpu'")
        s.execute(f"set tidb_device_stream_rows = "
                  f"{chip_smoke.PAGED_SF1_ROWS}")

        def run(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = s.execute(sqls[name])[-1]
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, len(res.rows)

        for name in NAMES:
            run(name)
        out["ms"] = {n: [] for n in NAMES}
        out["rows"] = {}
        for _ in range(args.reps):
            for name in NAMES:
                ms, n = run(name)
                out["ms"][name].append(ms)
                out["rows"][name] = n
        pipe = getattr(device_exec, "_Pipeline", None)
        if pipe is not None:
            call = pipe.__call__
            tally = {"calls": 0, "walk_s": 0.0}

            def counted(self, *a, **kw):
                t = time.perf_counter()
                device_exec._shape_sig(kw, device_exec._shape_sig(a, []))
                tally["walk_s"] += time.perf_counter() - t
                tally["calls"] += 1
                return call(self, *a, **kw)
            pipe.__call__ = counted
            out["walk"] = {}
            try:
                for name in NAMES:
                    tally.update(calls=0, walk_s=0.0)
                    run(name)
                    out["walk"][name] = {
                        "calls": tally["calls"],
                        "walk_us_per_call": (tally["walk_s"] * 1e6
                                             / max(tally["calls"], 1)),
                        "walk_ms_per_query": tally["walk_s"] * 1e3}
            finally:
                pipe.__call__ = call
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
