#!/usr/bin/env python3
"""Smoke run of the H100 port (``tidb_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 42]

Phases, each fatal on failure:

1. build — the CUDA kernels under tidb_tpu_torch/ops/kernels/csrc, with
   nvcc for sm_90a (one process per source, started together);
2. SQL set-up — ``bootstrap_domain()`` / ``new_session()``, the eight
   TPC-H-shaped tables at scale factor 1 (``carry.gen_tpch``: lineitem
   from --seed, the rest from the reference benchmark's second stream)
   with ANALYZE, one warm-up run of each query (which records the
   programs and inputs the main path hands the kernels) and EXPLAIN
   ANALYZE, which must show ``engine:tpu`` on every HashAgg;
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: K2/K3 the expression VM on the Q1, Q6 and top-N
   programs and (K2's LOADG) on Q3's post-join program (exact), K1 the
   group-by aggregate on the Q1 and top-N inputs and on seeded cases
   covering every aggregate, NULL keys, the pack and hash paths and
   capacity overflow (integers exact, floats rtol 1e-9 / atol 1e-12:
   atomics sum in another order), K4 the top-k sort at cap = 2^21,
   k = 10, with descending keys, NULLs and ties (exact), K5a the join
   probe on Q3's dense unique probes and Q9's sorted partsupp probe
   (exact), K5b the CSR expansion of orders into lineitem at SF1 —
   inner, left, and with the total over the capacity (exact), K5b's count
   of each join query's final row mask (exact, against ``mask.sum()``),
   K7 the standalone join match of orders and lineitem keys (exact); each
   timed with CUDA events beside its bound;
4. the main path — every launch counter set to 0, then Q1, Q6, the
   top-N, Q3, Q5, Q9, Q18 and a join without an aggregate (K7) under
   ``tidb_executor_engine = 'tpu'``; each query must launch its kernels
   (K1 and K2; the top-N, Q3 and Q18 also K4; the join queries K5a and
   K5b, and K5b's count of the final mask; the join without an aggregate
   K7, whose every call launches K4, K5a and K5b); the rows must
   equal the host engine's, with the same result types (every cell exact
   but in DOUBLE or FLOAT columns, which compare within rtol 1e-9 /
   atol 1e-12);
5. ``[window]`` — on the same SF1 tables, the window shapes W1 (a share
   of the whole partition over aggregated groups), W2 (running ranks, sum
   and count over the raw rows, ~10,000 partitions), W3 (a rank over
   aggregated groups, filtered) and W4 (four huge partitions, a DESC
   decimal order key with peers, ranks, cume_dist, AVG, MIN, MAX and a
   DOUBLE sum), and a 1.5M-partition window: K10 against its plain
   version on each one's full captured inputs (W2, W4, 1.5M partitions;
   integers exact, floats rtol 1e-9 / atol 1e-12), K4's window order on
   W2 against torch.sort(stable=True) of the packed key; then, every
   launch counter set to 0, W1-W4 on the device engine, each launching
   K2, K4 and K10, ``engine:tpu`` on every Window in EXPLAIN ANALYZE, W2's
   count, sum of row numbers and largest count equal to the generated
   partition sizes, the rows equal to the host engine's; ``[window]``
   lines with the device time, the K2 / K4 / K10 and device → host copy
   times and the host assembly;
6. ``[paged-sf1]`` — the same SF1 ``lineitem`` and ``orders`` a second
   time, as paged (memmap) tables in a temporary directory removed at
   exit (``carry.install_tpch``'s paged option, db ``tpch_paged``, the
   other six tables bulk, ANALYZE), ``tidb_device_stream_rows`` =
   1,048,576 (lineitem in 6 pages): Q1, Q6, the top-N, Q3, Q5, Q9 and Q18
   on the device engine, every launch counter set to 0 before; each scan
   aggregate must run streamed (``engine:tpu-stream`` in EXPLAIN
   ANALYZE), each join paged (``LAST_PAGED_STATS`` of kind "paged", at
   least 2 pages), the partial-state merge must launch, and the rows must
   equal the host engine's rows of phase 4; then a streamed
   COUNT(DISTINCT) against the host engine on the bulk tables;
7. ``[sf10]`` — ``carry.gen_tpch(10)`` into ``tpch10`` as bulk (RAM)
   tables with ANALYZE; at the default ``tidb_device_stream_rows`` the
   reference's own gates stream the 60,012,150-row lineitem (scan
   aggregates) and page it (joins) in 15 pages of 4,194,304 rows.  The
   seven queries twice each (warm-up, then timed with the launch
   counters set to 0 before), each required to run streamed or paged;
   the partial-state merge against its plain version on Q1's and Q18's
   folds (integers exact, floats rtol 1e-9), timed beside its bound;
   then each query twice on the resident whole-input path
   (``tidb_device_stream_rows = -1``), whose rows the streamed rows must
   equal exactly (a query the resident path cannot run is compared with
   the host engine instead), and Q6 and Q3 against the host engine.  One
   ``[stream]`` line per streamed or paged run: pages, bytes host →
   device, the copies' device time, the host slicing, sync and merge
   times, and the H2D bound at the pinned rate this run measures (one
   256 MiB copy); last W2 over the SF10 lineitem on the device (bucket
   2^26), K10 against its plain version on its inputs, its count, sum of
   row numbers and largest count against the generated partition sizes;
8. ``[hybrid]`` — on the same ``tpch10`` tables, ``tidb_device_mem_budget``
   at 300,000,000 and then 120,000,000 bytes (``bench.py --mem-budget``'s
   budgets, ``BENCH_SPILL_r01.json``), each from an empty residency
   ledger: Q5 twice (warm-up, then timed with the launch counters set to
   0 before), both required to run the hybrid hash join
   (``executor/hybrid_join.py``); at 300 MB at least one device
   partition must launch K2, K5a, K1 and the merge, at 120 MB at least
   one partition must spill and be joined on the host; the rows must
   equal ``[sf10]``'s resident rows exactly.  Q3 and Q9 once each at
   both budgets, their path logged (hybrid, paged or resident) and their
   rows held to ``[sf10]``'s whatever the path.  K5a's sorted probe of a
   partition index against its plain version on a captured page (exact)
   and the merge against its plain version on the largest hybrid fold,
   each timed beside its bound.  One ``[hybrid]`` line per hybrid run:
   partitions, spilled partitions, spill bytes, rows joined on the host,
   the host's ``join.partition`` seconds, the device pass's seconds,
   pages, H2D bytes and copy time, its bound (its bytes at the HBM rate
   plus at the measured pinned rate), the host pass's seconds and the
   host wait.  The budget goes back to 0 at the end;
9. report — the card's name and power limit, a ``kernels`` JSON line,
   and as the last line ``{"ok": true, "device": {...}}``.

Without a CUDA card, or without the ``tidb_tpu_torch`` package beside it,
the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peak device-memory rate (NVIDIA data sheet), bytes / s
HBM_BYTES_PER_S = 3.35e12

#: TPC-H scale factor of lineitem: SF1, 6,001,215 rows
SF = 1
#: the out-of-core phase's scale factor: lineitem 60,012,150 rows
SF_BIG = 10
#: rows per page of the paged SF1 tables: lineitem in 6 pages
PAGED_SF1_ROWS = 1 << 20

Q1 = """
select l_returnflag, l_linestatus,
       sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty,
       avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc,
       count(1) as count_order
from lineitem
where l_shipdate <= '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus"""

Q6 = """
select sum(l_extendedprice * l_discount) as revenue from lineitem
where l_shipdate >= '1994-01-01'
  and l_shipdate < date_add('1994-01-01', interval 1 year)
  and l_discount between 0.02 and 0.08 and l_quantity < 24"""

TOPN = ("select l_orderkey, sum(l_extendedprice*(1-l_discount)) as rev "
        "from lineitem group by l_orderkey order by rev desc, l_orderkey "
        "limit 10")

# TPC-H Q3, Q5, Q9 and Q18 as the reference benchmark runs them (bench.py)
Q3 = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < '1995-03-15'
  and l_shipdate > '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10"""

Q5 = """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = 'ASIA' and o_orderdate >= '1994-01-01'
  and o_orderdate < '1995-01-01'
group by n_name order by revenue desc"""

Q9 = """
select nationx, o_year, sum(amount) as sum_profit
from (select n_name as nationx, year(o_orderdate) as o_year,
             l_extendedprice * (1 - l_discount)
             - ps_supplycost * l_quantity as amount
      from part, supplier, lineitem, partsupp, orders, nation
      where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
        and ps_partkey = l_partkey and p_partkey = l_partkey
        and o_orderkey = l_orderkey and s_nationkey = n_nationkey
        and p_name like '%green%'
     ) as profit
group by nationx, o_year order by nationx, o_year desc"""

Q18 = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey
                     having sum(l_quantity) > 300)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate limit 100"""

#: a join with no aggregate over it: the executor's HashJoin matches its
#: keys through the standalone join match (K7)
JOIN_NO_AGG = """
select o_orderkey, o_orderdate, l_extendedprice, l_discount
from orders, lineitem
where o_orderkey = l_orderkey and o_orderdate = '1995-03-15'
order by o_orderkey, l_extendedprice, l_discount"""

QUERIES = (("q1", Q1), ("q6", Q6), ("topn", TOPN), ("q3", Q3), ("q5", Q5),
           ("q9", Q9), ("q18", Q18), ("join_no_agg", JOIN_NO_AGG))
JOIN_FRAGMENTS = ("q3", "q5", "q9", "q18")

#: the host engine's text of a query, where it differs: on bulk-loaded
#: tables (columnar only) the host planner's index join on part and
#: orders seeks the key-value store, finds no rows and returns none (a
#: fault the port shares with the reference, ROADMAP queue 3); the hint
#: keeps the host engine on hash joins, whose rows are the answer
HOST_TEXT = {"q9": Q9.replace(
    "from (select n_name",
    "from (select /*+ HASH_JOIN(part, orders) */ n_name")}


#: window shapes of TPC-DS over lineitem (the ``[window]`` phase)
#: W1, Q98/Q12's share of its partition (no ORDER BY: the whole
#: partition) over aggregated groups
W1 = """
select l_suppkey, l_partkey, s, s * 100 / sum(s) over (partition by l_suppkey)
from (select l_suppkey, l_partkey, sum(l_extendedprice) s from lineitem
      group by l_suppkey, l_partkey) t
order by l_suppkey, l_partkey limit 100"""

#: the running-total shape over the raw rows (~10,000 partitions), every
#: window output folded into a small result
_W2_OVER = "over (partition by l_suppkey order by l_shipdate)"
W2 = f"""
select count(*), sum(rn), sum(rk), sum(rq), max(c)
from (select row_number() {_W2_OVER} rn, rank() {_W2_OVER} rk,
             sum(l_quantity) {_W2_OVER} rq,
             count(l_orderkey) {_W2_OVER} c
      from lineitem) t"""

#: Q67's shape: a rank over aggregated groups, then a filter on it
W3 = """
select * from (
  select l_returnflag, l_suppkey,
         sum(l_extendedprice * (1 - l_discount)) rev,
         rank() over (partition by l_returnflag
                      order by sum(l_extendedprice * (1 - l_discount)) desc)
           rk
  from lineitem group by l_returnflag, l_suppkey) t
where rk <= 100 order by l_returnflag, rk, l_suppkey"""

#: few huge partitions (two string keys), a DESC decimal order key with
#: peers, and a DOUBLE argument: the float segmented scan at scale
_W4_OVER = ("over (partition by l_returnflag, l_linestatus "
            "order by l_extendedprice desc)")
W4 = f"""
select l_returnflag, l_linestatus, count(*), sum(dr), sum(pr), sum(cd),
       sum(av), min(mi), max(ma), sum(se)
from (select l_returnflag, l_linestatus, dense_rank() {_W4_OVER} dr,
             percent_rank() {_W4_OVER} pr, cume_dist() {_W4_OVER} cd,
             avg(l_discount) {_W4_OVER} av, min(l_shipdate) {_W4_OVER} mi,
             max(l_quantity) {_W4_OVER} ma,
             sum(l_extendedprice * 1e0) {_W4_OVER} se
      from lineitem) t
group by l_returnflag, l_linestatus order by 1, 2"""

#: 1.5M partitions of ~4 rows: K10's inputs for the kernel check (its
#: rows are not compared with the host engine)
_WO_OVER = "over (partition by l_orderkey order by l_shipdate)"
W_ORDERS = f"""
select count(*), sum(rn), sum(rk), sum(s)
from (select row_number() {_WO_OVER} rn, rank() {_WO_OVER} rk,
             sum(l_quantity) {_WO_OVER} s from lineitem) t"""

WINDOW_QUERIES = (("w1", W1), ("w2", W2), ("w3", W3), ("w4", W4))


class SmokeFailure(Exception):
    pass


def fail(msg):
    raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def rows_equal(a, b):
    """Two results (session ``Result`` s) hold the same rows: the same
    result types, and every cell equal as displayed, but in DOUBLE and
    FLOAT columns, whose cells compare within rtol 1e-9 / atol 1e-12 (the
    engines sum doubles in different orders).  Ints, decimals, dates and
    strings are exact."""
    import numpy as np
    from tidb_tpu_torch.sqltypes import FLOAT_TYPES
    if [f.tp for f in a.ftypes] != [f.tp for f in b.ftypes]:
        return False
    approx = [f.tp in FLOAT_TYPES for f in a.ftypes]
    ra_all, rb_all = a.rows, b.rows
    if len(ra_all) != len(rb_all):
        return False
    for ra, rb in zip(ra_all, rb_all):
        for va, vb, fl in zip(ra, rb, approx):
            if va == vb:
                continue
            if not fl or va is None or vb is None:
                return False
            if not np.isclose(float(va), float(vb), rtol=1e-9, atol=1e-12):
                return False
    return True


def cuda_ms(fn, reps=5):
    """Median milliseconds of `fn` over `reps` runs (CUDA events), after
    one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(tensors):
    """Bytes of the distinct tensors (one read or write each)."""
    seen, total = set(), 0
    for t in tensors:
        if t.data_ptr() in seen:
            continue
        seen.add(t.data_ptr())
        total += t.numel() * t.element_size()
    return total


# -- comparisons --------------------------------------------------------------

def compare_vm(out_k, out_p, what):
    """The expression VM against its interpreter: bit for bit."""
    import torch
    mask_k, outs_k = out_k
    mask_p, outs_p = out_p
    if not torch.equal(mask_k, mask_p):
        fail(f"K2 {what}: mask differs from the plain version")
    err = 0.0
    for s, ((dk, nk), (dp, np_)) in enumerate(zip(outs_k, outs_p)):
        if not torch.equal(nk, np_):
            fail(f"K2 {what}: nulls of output {s} differ")
        if dk.is_floating_point():
            same = torch.equal(dk.view(torch.int64), dp.view(torch.int64))
        else:
            same = torch.equal(dk, dp)
        if not same:
            diff = (dk.double() - dp.double()).abs().max().item()
            fail(f"K2 {what}: output {s} differs (max abs {diff})")
    return err


def compare_agg(out_k, out_p, agg_ops, capacity, what):
    """K1 against its plain version: n_groups, keys, nulls and integer
    results exact; float results within rtol 1e-9 / atol 1e-12."""
    import torch
    ko, kno, rk, rnk, ngk, vk = out_k
    po, pno, rp, rnp, ngp, vp = out_p
    ng = int(ngk)
    if ng != int(ngp):
        fail(f"K1 {what}: n_groups {ng} != plain {int(ngp)}")
    lim = min(ng, capacity)
    if not torch.equal(vk, vp):
        fail(f"K1 {what}: valid flags differ")
    for i, (a, b, na, nb) in enumerate(zip(ko, po, kno, pno)):
        if not (torch.equal(a[:lim], b[:lim]) and torch.equal(na[:lim],
                                                              nb[:lim])):
            fail(f"K1 {what}: key {i} differs")
    err = 0.0
    for j, op in enumerate(agg_ops):
        a, b = rk[j][:lim], rp[j][:lim]
        na, nb = rnk[j][:lim], rnp[j][:lim]
        if not torch.equal(na, nb):
            fail(f"K1 {what}: nulls of {op} #{j} differ")
        live = ~na
        a, b = a[live], b[live]
        if a.is_floating_point():
            if a.numel():
                d = (a - b).abs()
                err = max(err, float(d.max()))
                if not bool((d <= 1e-12 + 1e-9 * b.abs()).all()):
                    fail(f"K1 {what}: {op} #{j} outside rtol 1e-9 "
                         f"(max abs {float(d.max())})")
        elif not torch.equal(a, b):
            fail(f"K1 {what}: {op} #{j} differs")
    return err


# -- phases -------------------------------------------------------------------

def phase_build():
    from tidb_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    path = build.build()
    build.lib()
    log(f"[build] {os.path.relpath(path, HERE)} in "
        f"{time.perf_counter() - t0:.1f}s")
    for src in build.sources():
        name = os.path.splitext(os.path.basename(src))[0]
        logp = os.path.join(build.BUILD_DIR, name + ".log")
        if os.path.exists(logp):
            with open(logp) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        log(f"[build] {name}: {line.strip()}")


def phase_sql_setup(args, captured, joins):
    import numpy as np
    import torch
    from tidb_tpu_torch import carry
    from tidb_tpu_torch.executor import device_exec, device_join
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.session import bootstrap_domain, new_session
    t0 = time.perf_counter()
    tables = carry.gen_tpch(SF, seed=args.seed)
    n = tables["lineitem"][1]
    log(f"[sql] generated the eight TPC-H tables: lineitem {n} rows, "
        f"orders {tables['orders'][1]} (sf {SF}, seed {args.seed}) in "
        f"{time.perf_counter() - t0:.1f}s")
    dom = bootstrap_domain()
    s = new_session(dom)
    t0 = time.perf_counter()
    carry.install_tpch(s.execute, dom, "tpch", tables)
    log(f"[sql] installed and analyzed in {time.perf_counter() - t0:.1f}s")
    keys = {"l_orderkey": tables["lineitem"][0]["l_orderkey"],
            "o_orderkey": tables["orders"][0]["o_orderkey"],
            # W2's partition sizes, for its check
            "supp_counts": np.bincount(tables["lineitem"][0]["l_suppkey"])}
    del tables
    s.execute("set @@tidb_executor_engine = 'tpu'")

    def observe(prog, inputs, n_rows, n_live, n_keys, agg_ops, capacity,
                pack):
        captured[current[0]] = dict(
            prog=prog, inputs=inputs, n=n_rows, n_live=n_live,
            n_keys=n_keys, agg_ops=agg_ops, capacity=capacity, pack=pack)

    def observe_join(event, **kw):
        # the last run of the query (after any capacity retry) wins
        key = (event, kw.get("what"), kw.get("pos"), kw.get("mode"))
        joins.setdefault(current[0], {})[key] = kw

    match_fn = pdev.device_join_match

    def observe_match(build_keys, probe_keys):
        joins.setdefault(current[0], {})[("match",)] = dict(
            build=build_keys, probe=probe_keys)
        return match_fn(build_keys, probe_keys)

    current = [None]
    device_exec.PIPELINE_OBSERVER[0] = observe
    device_join.FRAGMENT_OBSERVER[0] = observe_join
    pdev.device_join_match = observe_match
    try:
        for name, sql in QUERIES:
            current[0] = name
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            log(f"[sql] warm-up {name}: "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms "
                "(upload + index and pipeline builds + run)")
    finally:
        device_exec.PIPELINE_OBSERVER[0] = None
        device_join.FRAGMENT_OBSERVER[0] = None
        pdev.device_join_match = match_fn
    for name, sql in QUERIES:
        if name == "join_no_agg":
            if ("match",) not in joins.get(name, {}):
                fail(f"{name}: the device join match never ran")
            continue
        if name in JOIN_FRAGMENTS:
            if ("agg", None, None, None) not in joins.get(name, {}):
                fail(f"{name}: the device join fragment never ran")
        elif name not in captured:
            fail(f"{name}: the device pipeline never ran")
        res = s.execute("explain analyze " + sql)[-1]
        agg_lines = [r for r in res.rows if "HashAgg" in str(r[0])]
        if not agg_lines or not all(any("engine:tpu" in str(c) for c in r)
                                    for r in agg_lines):
            for r in res.rows:
                log(f"    {r}")
            fail(f"{name}: EXPLAIN ANALYZE shows a HashAgg without "
                 "engine:tpu")
        log(f"[sql] {name}: {len(agg_lines)} HashAgg, engine:tpu")
    return dom, s, n, keys


def phase_kernels(args, captured, report):
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops.kernels import expr_vm, groupby_agg, sort_topk
    dev = pdev.device()

    # -- K2/K3: the expression VM on the main path's programs ---------------
    vm_row = None
    for name in ("q1", "q6", "topn"):
        c = captured[name]
        prog, inputs, n, n_live = c["prog"], c["inputs"], c["n"], c["n_live"]

        def run_k(c=c):
            return expr_vm.run(c["prog"], c["inputs"], c["n"], c["n_live"],
                               dev)

        def run_p(c=c):
            return expr_vm.interpret(c["prog"], c["inputs"], c["n"],
                                     c["n_live"], dev)

        out_k, out_p = run_k(), run_p()
        torch.cuda.synchronize()
        err = compare_vm(out_k, out_p, name)
        ms, plain_ms = cuda_ms(run_k), cuda_ms(run_p)
        # the bytes the function must move: the input columns it computes
        # on, read once, and the mask and the outputs it computes, written
        # once; an output that is an input column unchanged is handed on
        # and moves nothing
        handed = expr_vm.handed_on(prog, inputs)
        launched = prog.without_stores(handed)
        read = [t for s in launched.loaded_slots() for t in inputs[s]]
        written = [out_k[0]] + [t for s, pair in enumerate(out_k[1])
                                if s not in handed for t in pair]
        bound = (nbytes(read) + nbytes(written)) / HBM_BYTES_PER_S * 1e3
        log(f"[K2] {name}: {len(launched.instrs)} instructions, "
            f"{launched.n_regs} registers, reads {len(read) // 2} of "
            f"{len(inputs)} input columns, hands on {len(handed)}, "
            f"n={n}: exact; {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
            f"{bound:.4f} ms)")
        c["vm_out"] = out_k
        if name == "q1":
            vm_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound)
    report["expr_vm"].update(vm_row)

    # -- K1 on the main path's inputs ----------------------------------------
    k1_row = None
    for name in ("q1", "topn"):
        c = captured[name]
        mask, outs = c["vm_out"]
        prog = c["prog"]
        keys = [outs[s][0] for s in prog.key_slots]
        knulls = [outs[s][1] for s in prog.key_slots]
        vals = [outs[s][0] for s in prog.val_slots]
        vnulls = [outs[s][1] for s in prog.val_slots]
        argv = (tuple(keys), tuple(knulls), tuple(vals), tuple(vnulls), mask,
                c["n_keys"], c["agg_ops"], c["capacity"], c["pack"])
        # the capacity the main path converged on
        cap = c["capacity"]
        out_k = groupby_agg.groupby_agg(*argv)
        out_p = groupby_agg.groupby_plain(*argv)
        torch.cuda.synchronize()
        err = compare_agg(out_k, out_p, c["agg_ops"], cap, name)
        ms = cuda_ms(lambda: groupby_agg.groupby_agg(*argv))
        plain_ms = cuda_ms(lambda: groupby_agg.groupby_plain(*argv))
        moved = nbytes(list(keys) + list(knulls) + list(vals) + list(vnulls)
                       + [mask]) + nbytes(
            [t for grp in out_k[:4] for t in grp])
        bound = moved / HBM_BYTES_PER_S * 1e3
        log(f"[K1] {name}: n={c['n']}, {len(c['agg_ops'])} aggregates, "
            f"capacity {cap}, pack {c['pack']}, n_groups {int(out_k[4])}: "
            f"max abs err {err:.3g}; {ms:.3f} ms (plain {plain_ms:.3f} ms, "
            f"bound {bound:.4f} ms)")
        if name == "q1":
            k1_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound)

    # -- K1 on seeded cases covering the contract -----------------------------
    rng = np.random.default_rng(args.seed)
    n = captured["q1"]["n"]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def nulls(p):
        return up(rng.random(n) < p)

    mask = up(rng.random(n) < 0.7)
    v_int = up(rng.integers(-1_000_000, 1_000_000, n))
    v_flt = up(rng.standard_normal(n) * 1e3)
    v_small = up(rng.integers(0, 1000, n))
    vn_int, vn_flt, vn_small = nulls(0.05), nulls(0.05), nulls(0.02)
    all_ops = (("count", v_int, vn_int), ("sum_i", v_int, vn_int),
               ("sum_f", v_flt, vn_flt), ("min", v_int, vn_int),
               ("max", v_flt, vn_flt), ("min", v_flt, vn_flt),
               ("max", v_int, vn_int), ("first", v_int, vn_int),
               ("first", v_flt, vn_flt), ("cnt_dist", v_small, vn_small))
    ops = tuple(o for o, _v, _n in all_ops)
    vals = tuple(v for _o, v, _n in all_ops)
    vnul = tuple(nn for _o, _v, nn in all_ops)
    small_keys = (up(rng.integers(0, 3, n)), up(rng.integers(0, 2, n)))
    small_nulls = (nulls(0.01), nulls(0.01))
    wide = (up(rng.integers(0, 1 << 15, n)), up(rng.integers(0, 1 << 15, n)))
    wide_nulls = (nulls(0.001), nulls(0.001))
    hk = (up(rng.integers(-50, 51, n)), up(rng.integers(0, 1000, n)))
    hk_nulls = (nulls(0.02), nulls(0.02))
    orderkey = (up(rng.integers(1, 1_500_001, n)),)
    no_nulls = (up(np.zeros(n, dtype=bool)),)
    cases = (
        ("pack, shared-memory buckets, NULL keys, every aggregate",
         small_keys, small_nulls, mask, ops, vals, vnul, 16,
         ((3, 0), (2, 0))),
        ("pack, 21-bit direct buckets", orderkey, no_nulls, mask,
         ("sum_i", "count", "cnt_dist"), (v_int, v_int, v_small),
         (vn_int, vn_int, vn_small), 1 << 21, ((21, -1),)),
        ("pack too wide for buckets (hash + packed order)", wide,
         wide_nulls, mask, ops, vals, vnul, 1 << 23, ((16, 0), (16, 0))),
        ("no pack (hash + key order, NULL groups last)", hk, hk_nulls, mask,
         ops, vals, vnul, 1 << 17, None),
        ("no pack, n_groups > capacity", hk, hk_nulls, mask, ops, vals,
         vnul, 64, None),
        ("all-false mask", small_keys, small_nulls,
         up(np.zeros(n, dtype=bool)), ops, vals, vnul, 16,
         ((3, 0), (2, 0))),
    )
    for what, keys, knulls, m, o, v, vn, cap, pack in cases:
        argv = (keys, knulls, v, vn, m, len(keys), o, cap, pack)
        out_k = groupby_agg.groupby_agg(*argv)
        out_p = groupby_agg.groupby_plain(*argv)
        torch.cuda.synchronize()
        err = compare_agg(out_k, out_p, o, cap, what)
        if "capacity" in what and int(out_k[4]) <= cap:
            fail("K1 overflow case did not overflow")
        log(f"[K1] {what}: n_groups {int(out_k[4])}, capacity {cap}: "
            f"max abs err {err:.3g}")
        k1_row["max_abs_err"] = max(k1_row["max_abs_err"], err)
    report["groupby_agg"].update(k1_row)

    # -- K4: top-k at the top-N's shape ---------------------------------------
    cap, k = 1 << 21, 10
    ng = cap - 4321
    key0 = up(rng.integers(0, 1000, cap))            # ties
    key1 = up(rng.standard_normal(cap).round(2))     # ties too
    n0, n1 = up(rng.random(cap) < 0.05), up(rng.random(cap) < 0.05)
    spec = ([key0, key1], [n0, n1], [True, False], [False, True])
    idx_k = sort_topk.sort_indices(*spec, cap, ng, k)
    idx_p = sort_topk.sort_plain(*spec, cap, ng)[:k]
    full_k = sort_topk._sort_cuda(*spec, cap, ng)[:cap]
    full_p = sort_topk.sort_plain(*spec, cap, ng)
    torch.cuda.synchronize()
    if not torch.equal(idx_k, idx_p) or not torch.equal(full_k, full_p):
        fail("K4: sort order differs from the plain version")
    ms = cuda_ms(lambda: sort_topk.sort_indices(*spec, cap, ng, k))
    plain_ms = cuda_ms(lambda: sort_topk.sort_plain(*spec, cap, ng)[:k])
    bound = (nbytes([key0, key1, n0, n1]) + k * 8) / HBM_BYTES_PER_S * 1e3
    log(f"[K4] cap={cap}, k={k}, desc int key + asc float key, NULLs, "
        f"ties: exact (top-k and full order); {ms:.3f} ms (plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms)")
    # one key: torch.sort computes the same order
    one = ([key1], [up(np.zeros(cap, dtype=bool))], [True], [False])
    got = sort_topk.sort_indices(*one, cap, cap, k)
    ref = torch.sort(key1, descending=True, stable=True)[1][:k]
    if not torch.equal(got, ref):
        fail("K4: single-key order differs from torch.sort")
    one_ms = cuda_ms(lambda: sort_topk.sort_indices(*one, cap, cap, k))
    lib_ms = cuda_ms(lambda: torch.sort(key1, descending=True,
                                        stable=True)[1][:k])
    log(f"[K4] single float key desc, cap={cap}: {one_ms:.3f} ms "
        f"(torch.sort {lib_ms:.3f} ms)")
    report["sort_topk"].update(dict(max_abs_err=0.0, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound))


#: one random read of an index array, counted as one 32-byte sector
SECTOR = 32


def same_outputs(got, want, what):
    """Kernel and plain outputs (nested dicts / lists of tensors) equal
    element for element."""
    import torch
    if isinstance(got, dict):
        if set(got) != set(want):
            fail(f"{what}: outputs {sorted(got)} != {sorted(want)}")
        for k in got:
            same_outputs(got[k], want[k], f"{what}.{k}")
    elif isinstance(got, (list, tuple)):
        for i, (a, b) in enumerate(zip(got, want)):
            same_outputs(a, b, f"{what}[{i}]")
    elif not torch.equal(got, want):
        fail(f"{what} differs from the plain version")


def probe_bound_ms(ev, out):
    """Least time of a K5a probe: keys, NULL flags and validity read
    once, outputs written once, and per valid probe row one sector for
    its key's lookup in the index (whatever search finds it: a hash or
    dense index needs one read) and, in unique mode, one each for the row
    id and the build validity."""
    n = ev["keys"][0].shape[0]
    stream = nbytes([t for t in list(ev["keys"]) + list(ev["knulls"])
                     + [ev["pvalid"]] if t is not None])
    stream += nbytes([t for t in out.values() if t.dim() == 1])
    n_valid = int(ev["pvalid"].sum()) if ev["pvalid"] is not None else n
    look = 1
    if ev["mode"] == "uniq":
        look += 2
    return (stream + n_valid * look * SECTOR) / HBM_BYTES_PER_S * 1e3


def vm_bound_ms(prog, inputs, out, valid_rows):
    """Least time of a VM program over a joined row space: direct columns
    read once, each row index and null mask read once, one sector per
    valid row for each column read through a row index, the mask and the
    computed outputs written once."""
    from tidb_tpu_torch.ops.kernels import expr_vm
    handed = expr_vm.handed_on(prog, inputs)
    launched = prog.without_stores(handed)
    direct, index, gathered = [], [], 0
    for slot in launched.loaded_slots():
        inp = inputs[slot]
        if len(inp) > 2 and (inp[2] is not None or inp[3] is not None):
            index += [t for t in inp[2:] if t is not None]
            gathered += 2 if inp[2] is not None else 0
            if inp[2] is None:
                direct += list(inp[:2])
        else:
            direct += list(inp[:2])
    written = [out[0]] + [t for s, pair in enumerate(out[1])
                          if s not in handed for t in pair]
    moved = nbytes(direct) + nbytes(index) + nbytes(written)
    return (moved + valid_rows * gathered * SECTOR) / HBM_BYTES_PER_S * 1e3


def expand_bound_ms(cnt, pos0, pvalid, cap, total, out):
    """Least time of a K5b expansion: counts, starts and validity read
    once, every output slot written once, and per filled slot one sector
    for the build validity plus one per matched probe row for its run of
    row ids."""
    filled = min(int(total), cap)
    rows_hit = int((cnt > 0).sum())
    moved = nbytes([t for t in (cnt, pos0, pvalid) if t is not None])
    moved += nbytes([t for k, t in out.items() if k != "maps"
                     and t.dim() == 1])
    moved += nbytes(list(out.get("maps", ())))
    return (moved + (filled + rows_hit) * SECTOR) / HBM_BYTES_PER_S * 1e3


def check_probe(ev, what):
    """K5a on a captured probe call against its plain version (exact),
    timed beside its bound.  Returns (ms, plain_ms, bound_ms)."""
    import torch
    from tidb_tpu_torch.ops.kernels import join_probe
    kw = dict(layout=ev["layout"], mode=ev["mode"], kind=ev["kind"],
              bvalid=ev["bvalid"], dense_span=ev["dense_span"])
    argv = (ev["keys"], ev["knulls"], ev["pvalid"], ev["packs"], ev["a0"],
            ev["a1"], ev["nv"])

    def run_k():
        return join_probe.probe(*argv, **kw)

    def run_p():
        return join_probe.probe_plain(*argv, kw["layout"], kw["mode"],
                                      kw["kind"], kw["bvalid"], None,
                                      kw["dense_span"])
    out_k, out_p = run_k(), run_p()
    torch.cuda.synchronize()
    same_outputs(out_k, out_p, what)
    return cuda_ms(run_k), cuda_ms(run_p), probe_bound_ms(ev, out_k)


def phase_join_kernels(args, joins, keys, report):
    import numpy as np
    import torch
    from tidb_tpu_torch.executor.join_index import build_join_index
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops.kernels import (expr_vm, join_expand,
                                            join_probe, sort_topk)
    from tidb_tpu_torch.sqltypes import TYPE_LONGLONG, FieldType
    from tidb_tpu_torch.utils.chunk import Column
    dev = pdev.device()

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # -- K5a: the main path's probes -----------------------------------------
    probe_row = None
    for name, want_layout in (("q3", "dense"), ("q9", "sorted")):
        evs = [ev for k, ev in sorted(joins[name].items(),
                                      key=lambda kv: str(kv[0]))
               if k[0] == "probe" and ev["layout"] == want_layout]
        if not evs:
            fail(f"K5a: {name} ran no {want_layout} probe")
        for ev in evs:
            ms, plain_ms, bound = check_probe(
                ev, f"K5a {name} J{ev['pos']} {ev['layout']}/{ev['mode']}")
            n = ev["keys"][0].shape[0]
            extra = ""
            if ev["layout"] == "sorted":
                # one PyTorch call for the lookup alone: searchsorted of
                # the packed keys (packed here, outside the timing)
                key = torch.zeros(n, dtype=torch.int64, device=dev)
                for d, (mn, span) in zip(ev["keys"], ev["packs"]):
                    key = key * span + (d - mn).clamp(0, span - 1)
                sk = ev["a0"][:int(ev["nv"])]
                lib_ms = cuda_ms(lambda: torch.searchsorted(sk, key))
                extra = (f"; torch.searchsorted of the packed keys alone "
                         f"{lib_ms:.3f} ms")
            log(f"[K5a] {name} J{ev['pos']}: {ev['layout']} {ev['mode']} "
                f"probe, {len(ev['keys'])} key column(s), n={n}, "
                f"n_valid={int(ev['nv'])}: exact; {ms:.3f} ms (plain "
                f"{plain_ms:.3f} ms, bound {bound:.4f} ms){extra}")
            if name == "q3" and (probe_row is None
                                 or ms > probe_row["ms"]):
                probe_row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound)
    report["join_probe"].update(probe_row)

    # -- K2's LOADG on Q3's post-join program --------------------------------
    ev = joins["q3"][("vm", "final", None, None)]
    prog, inputs, n = ev["prog"], ev["inputs"], ev["n"]
    if not expr_vm.gathered_slots(inputs):
        fail("K2: Q3's post-join program reads no column through a row "
             "index")

    def vm_k():
        return expr_vm.run(prog, inputs, n, n, dev)

    def vm_p():
        return expr_vm.interpret(prog, inputs, n, n, dev)

    out_k, out_p = vm_k(), vm_p()
    torch.cuda.synchronize()
    compare_vm(out_k, out_p, "q3 post-join (LOADG)")
    ms, plain_ms = cuda_ms(vm_k), cuda_ms(vm_p)
    from tidb_tpu_torch.executor.device_join import _VALID
    valid_rows = int(inputs[prog.in_cols.index(_VALID)][0].sum())
    bound = vm_bound_ms(prog, inputs, out_k, valid_rows)
    log(f"[K2] q3 post-join: {len(prog.instrs)} instructions, reads "
        f"{len(expr_vm.gathered_slots(inputs))} of {len(inputs)} inputs "
        f"through a row index, n={n}, {valid_rows} valid rows: exact; "
        f"{ms:.3f} ms (plain {plain_ms:.3f} ms, bound {bound:.4f} ms)")
    report["expr_vm_loadg"].update(dict(max_abs_err=0.0, ms=ms,
                                        plain_ms=plain_ms, bound_ms=bound))

    # -- K5b: orders expanded into lineitem at SF1 ----------------------------
    rng = np.random.default_rng(args.seed)
    ft = FieldType(tp=TYPE_LONGLONG)
    lk, ok = keys["l_orderkey"], keys["o_orderkey"]
    idx = build_join_index([Column(ft, lk, np.zeros(len(lk), bool))])
    a0, a1, nv = idx.device_arrays()
    okeys = up(ok)
    no = len(ok)
    pvalid = up(rng.random(no) < 0.9)
    bvalid = up(rng.random(len(lk)) < 0.9)
    pmap = up(rng.integers(0, 1 << 40, no))
    log(f"[K5b] lineitem index on l_orderkey: {idx.kind}, "
        f"{idx.n_valid} rows, max_cnt {idx.max_cnt}, avg_cnt "
        f"{idx.avg_cnt:.2f}, upload {idx.upload_bytes()} bytes")
    exp_row = None
    for case in ("inner", "left", "total over cap"):
        pv = None if case == "inner" else pvalid
        bv = None if case == "inner" else bvalid
        pr = join_probe.probe([okeys], [None], pv, idx.packs, a0, a1, nv,
                              layout=idx.kind, mode="count",
                              dense_span=idx.span)
        cnt, pos0 = pr["cnt"], pr["pos0"]
        if case == "left":
            total = int(torch.where(pv, cnt.clamp(min=1), 0).sum())
        else:
            total = int(pr["count"])
        cap = pdev.next_pow2(total)
        if case == "total over cap":
            cap //= 2
        left = case == "left"
        maps = [pmap] if case != "inner" else []

        def ex_k(cnt=cnt, pos0=pos0, pv=pv, bv=bv, cap=cap, left=left,
                 maps=maps):
            return join_expand.expand(cnt, pos0, pv, a1, nv, bv, cap,
                                      left=left, probe_maps=maps)

        def ex_p(cnt=cnt, pos0=pos0, pv=pv, bv=bv, cap=cap, left=left,
                 maps=maps):
            return join_expand.expand_plain(cnt, pos0, pv, a1, nv, bv, cap,
                                            left, maps)

        out_k, out_p = ex_k(), ex_p()
        torch.cuda.synchronize()
        same_outputs(out_k, out_p, f"K5b {case}")
        if int(out_k["total"]) != total:
            fail(f"K5b {case}: total {int(out_k['total'])} != {total}")
        if case == "total over cap" and not total > cap:
            fail("K5b: the over-capacity case fits its capacity")
        ms, plain_ms = cuda_ms(ex_k), cuda_ms(ex_p)
        bound = expand_bound_ms(cnt, pos0, pv, cap, total, out_k)
        extra = ""
        if case == "inner":
            ar = torch.arange(no, device=dev)
            lib_ms = cuda_ms(lambda: torch.repeat_interleave(ar, cnt))
            extra = (f"; torch.repeat_interleave (probe rows of the slots "
                     f"alone) {lib_ms:.3f} ms")
            exp_row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound)
        log(f"[K5b] {case}: {no} orders -> total {total} pairs, cap {cap}, "
            f"max_cnt {idx.max_cnt}: exact; {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms){extra}")
    report["join_expand"].update(exp_row)

    # -- K5b's count of the final row mask, on each join query ---------------
    cnt_row = None
    for name in JOIN_FRAGMENTS:
        ev = joins[name].get(("count", None, None, None))
        if ev is None:
            fail(f"K5b count: {name} counted no final mask")
        mask = ev["mask"]

        def c_k(mask=mask):
            return join_expand.count(mask)

        def c_p(mask=mask):
            # the plain version, which is also one library call
            return mask.sum()

        got, want = c_k(), c_p()
        torch.cuda.synchronize()
        if got.dtype != torch.int64 or int(got) != int(want):
            fail(f"K5b count {name}: {int(got)} kept rows, mask.sum() "
                 f"{int(want)}")
        ms, plain_ms = cuda_ms(c_k), cuda_ms(c_p)
        bound = (nbytes([mask]) + 8) / HBM_BYTES_PER_S * 1e3
        log(f"[K5b] count of {name}'s final mask: n={mask.shape[0]}, "
            f"{int(got)} kept: exact; {ms:.3f} ms (plain = mask.sum() "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms)")
        if cnt_row is None or mask.shape[0] > cnt_row["n"]:
            cnt_row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, library_ms=plain_ms,
                           n=mask.shape[0])
    del cnt_row["n"]
    report["join_expand_count"].update(cnt_row)

    # -- K7: the standalone join match of orders and lineitem keys ------------
    bk, pk = up(ok), up(lk)
    bn = up(np.zeros(no, bool))
    pvk = up(np.ones(len(lk), bool))

    def k7_k():
        order, pos0, cnt, total = pdev._join_count_impl(bk, pk, bn, pvk, no)
        return (order, pos0, cnt) + tuple(pdev._join_expand_impl(
            order, pos0, cnt, int(total)))

    def k7_p():
        order = sort_topk.sort_plain([bk], [bn], [False], [False], no, no)
        pr = join_probe.probe_plain([pk], [None], pvk, None, bk, None, no,
                                    "sorted", "count", order=order)
        out = join_expand.expand_plain(pr["cnt"], pr["pos0"], None, order,
                                       no, None, int(pr["count"]))
        return (order, pr["pos0"], pr["cnt"], out["pi"], out["bi"],
                out["valid"])

    out_k, out_p = k7_k(), k7_p()
    torch.cuda.synchronize()
    same_outputs(list(out_k), list(out_p), "K7 orders x lineitem")
    total = int(out_k[3].shape[0])
    got = pdev.device_join_match((ok, np.zeros(no, bool)),
                                 (lk, np.zeros(len(lk), bool)))
    if len(got[0]) != total or total != len(lk):
        fail(f"K7: {len(got[0])} pairs, expected {len(lk)}")
    ms, plain_ms = cuda_ms(k7_k), cuda_ms(k7_p)
    # the bytes the match must move: both sides' keys and flags read once,
    # the build order and the pairs written once, and one sector per probe
    # row for its key's lookup (the counts and starts between the passes
    # are this design's own, not the function's)
    order, _pos0, _cnt, pi, bi, keep = out_k
    moved = nbytes([bk, bn, pk, pvk]) + nbytes([order, pi, bi, keep])
    bound = (moved + len(lk) * SECTOR) / HBM_BYTES_PER_S * 1e3
    log(f"[K7] orders ({no}) x lineitem ({len(lk)}) keys: {total} pairs, "
        f"exact (order, counts and pairs); {ms:.3f} ms on the card (plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms)")
    report["join_match"].update(dict(max_abs_err=0.0, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound))


def phase_main_path(dom, s, n_rows, report):
    import torch
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops.kernels import (expr_vm, groupby_agg,
                                            join_expand, join_probe,
                                            sort_topk)
    # K5b's count and K7 are entries over the kernels' own counters: a
    # call of either counts once where the counters of the kernels it
    # runs moved (K5b's by one; K7's K4, K5a and K5b each)
    composite = {"join_expand_count": [0], "join_match": [0]}
    counters = {"expr_vm": expr_vm.LAUNCHES, "groupby_agg":
                groupby_agg.LAUNCHES, "sort_topk": sort_topk.LAUNCHES,
                "join_probe": join_probe.LAUNCHES,
                "join_expand": join_expand.LAUNCHES, **composite}
    agg = ["expr_vm", "groupby_agg"]
    frag = agg + ["join_probe", "join_expand", "join_expand_count"]
    need = {"q1": agg, "q6": agg, "topn": agg + ["sort_topk"],
            "q3": frag + ["sort_topk"], "q5": frag, "q9": frag,
            "q18": frag + ["sort_topk"],
            "join_no_agg": ["join_match", "sort_topk", "join_probe",
                            "join_expand"]}
    count_fn, match_fn = join_expand.count, pdev.device_join_match

    def counted_count(mask):
        before = join_expand.LAUNCHES[0]
        out = count_fn(mask)
        if join_expand.LAUNCHES[0] == before + 1:
            composite["join_expand_count"][0] += 1
        return out

    def counted_match(build_keys, probe_keys):
        runs = (sort_topk.LAUNCHES, join_probe.LAUNCHES,
                join_expand.LAUNCHES)
        before = [c[0] for c in runs]
        out = match_fn(build_keys, probe_keys)
        if all(c[0] > b for c, b in zip(runs, before)):
            composite["join_match"][0] += 1
        return out

    from tidb_tpu_torch.executor import device_join
    # host time in the join indexes' (re)builds (K6, numpy), per query
    index_builds = []
    build_index = device_join.build_join_index

    def timed_build(*a, **kw):
        t = time.perf_counter()
        try:
            return build_index(*a, **kw)
        finally:
            index_builds.append(time.perf_counter() - t)

    for c in counters.values():
        c[0] = 0
    dev_res = {}
    loadg = 0
    device_join.build_join_index = timed_build
    join_expand.count, pdev.device_join_match = counted_count, counted_match
    try:
        for name, sql in QUERIES:
            dev_res[name] = run_counted(s, name, sql, counters, need,
                                        n_rows, index_builds)
            if name in JOIN_FRAGMENTS:
                loadg += dev_res[name][1]["expr_vm"]
    finally:
        device_join.build_join_index = build_index
        join_expand.count, pdev.device_join_match = count_fn, match_fn
    dev_res = {k: v[0] for k, v in dev_res.items()}
    log("[main] launch counts above; the timing below is not counted")
    for k, c in counters.items():
        report[k]["launches"] = c[0]
    report["expr_vm_loadg"]["launches"] = loadg
    # the same query twice in a row: its join indexes stay cached on the
    # build tables' columns (one index per column, as in the reference),
    # where the mixed sequence above rebuilds them when the filters change
    for name in JOIN_FRAGMENTS:
        sql = dict(QUERIES)[name]
        s.execute(sql)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.execute(sql)
        torch.cuda.synchronize()
        log(f"[main] {name} repeated at once: "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms on the device "
            "engine (join indexes cached)")
    s.execute("set @@tidb_executor_engine = 'host'")
    host_res = {}
    for name, sql in QUERIES:
        t0 = time.perf_counter()
        host = s.execute(HOST_TEXT.get(name, sql))[-1]
        dt = time.perf_counter() - t0
        if not host.rows:
            fail(f"{name}: the host engine returned no rows")
        if not rows_equal(dev_res[name], host):
            fail(f"{name}: device rows differ from the host engine:\n"
                 f"device {dev_res[name].rows[:5]}\nhost   {host.rows[:5]}")
        log(f"[main] {name}: {len(host.rows)} rows equal the host "
            f"engine's (host {dt:.3f}s); first {host.rows[:2]}")
        host_res[name] = host
    return host_res


def run_counted(s, name, sql, counters, need, n_rows, index_builds):
    """One main-path query on the device engine: (result, launches)."""
    import torch
    before = {k: c[0] for k, c in counters.items()}
    del index_builds[:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = s.execute(sql)[-1]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moved = {k: c[0] - before[k] for k, c in counters.items()}
    for k in need[name]:
        if moved[k] <= 0:
            fail(f"{name}: kernel {k} was not launched on the main path "
                 "(degraded to host?)")
    note = ""
    if index_builds:
        note = (f"; build_join_index (host numpy, a build on a cache "
                 f"miss) took {sum(index_builds) * 1e3:.3f} ms of it in "
                 f"{len(index_builds)} calls")
    log(f"[main] {name}: {dt * 1e3:.3f} ms on the device engine, "
        f"{n_rows / dt:,.0f} lineitem rows/s, launches {moved}{note}")
    return res, moved


# -- window functions: K2 -> K4 -> K10 ----------------------------------------

class WindowCapture:
    """While installed, wraps K2's ``expr_vm.run``, K4's
    ``sort_topk.window_order`` and K10's ``window_scan.run`` and keeps the
    last device window's inputs of the three and K10's outputs.  The
    window's K2 program is the last one run before its K4 whose outputs
    hold the window's keys."""

    def __init__(self):
        self.last = None

    def __enter__(self):
        from tidb_tpu_torch.ops.kernels import expr_vm, sort_topk, window_scan
        self.fns = (expr_vm.run, sort_topk.window_order, window_scan.run)
        vm_fn, order_fn, scan_fn = self.fns
        seen = {}

        def vm(prog, inputs, *rest):
            out = vm_fn(prog, inputs, *rest)
            seen["vm"] = dict(prog=prog, inputs=inputs, vm_outs=out[1])
            return out

        def order(cols, nulls, descs, *rest):
            seen["order"] = dict(cols=cols, descs=descs, vm=seen.get("vm"))
            return order_fn(cols, nulls, descs, *rest)

        def scan(nb, n_live, idx, part_keys, order_keys, args, funcs, dev):
            outs = scan_fn(nb, n_live, idx, part_keys, order_keys, args,
                           funcs, dev)
            keys = list(part_keys) + list(order_keys)
            o = seen.pop("order", None)
            if (o is None or len(o["cols"]) != len(keys)
                    or any(c is not k[0] for c, k in zip(o["cols"], keys))
                    or o["vm"] is None
                    or not any(d is keys[0][0]
                               for d, _n in o["vm"]["vm_outs"])):
                fail("window capture: K10's keys are not K4's and K2's "
                     "outputs of the same window")
            self.last = dict(prog=o["vm"]["prog"], inputs=o["vm"]["inputs"],
                             nb=nb, n_live=n_live, keys=keys,
                             descs=o["descs"], idx=idx,
                             n_part=len(part_keys), args=list(args),
                             funcs=funcs, outs=outs)
            return outs

        expr_vm.run, sort_topk.window_order, window_scan.run = vm, order, scan
        return self

    def __exit__(self, *exc):
        from tidb_tpu_torch.ops.kernels import expr_vm, sort_topk, window_scan
        expr_vm.run, sort_topk.window_order, window_scan.run = self.fns


def window_counters():
    from tidb_tpu_torch.ops.kernels import window_scan
    return {**stream_counters(), "window_scan": window_scan.LAUNCHES}


#: kernels every window query launches: K2 (keys and arguments), K4 (the
#: window's order), K10
WINDOW_NEED = ["expr_vm", "sort_topk", "window_scan"]


def k10_call(ev, plain=False):
    from tidb_tpu_torch.ops.kernels import window_scan
    n_part = ev["n_part"]
    argv = (ev["nb"], ev["n_live"], ev["idx"], ev["keys"][:n_part],
            ev["keys"][n_part:], ev["args"], ev["funcs"],
            ev["keys"][0][0].device)
    return (window_scan.window_plain if plain else window_scan.run)(*argv)


def compare_window(out_k, out_p, funcs, what):
    """K10 against its plain version: NULL flags exact everywhere; integer
    outputs exact and float outputs within rtol 1e-9 / atol 1e-12 where
    not NULL (float sums add in another order).  Returns the max abs
    error of the float outputs and the largest |value| among them."""
    import torch
    err, mag = 0.0, 0.0
    for (name, _a), (dk, nk), (dp, np_) in zip(funcs, out_k, out_p):
        if not torch.equal(nk, np_):
            fail(f"K10 {what}: NULL flags of {name} differ")
        a, b = dk[~nk], dp[~np_]
        if a.is_floating_point():
            if a.numel():
                d = (a - b).abs()
                err = max(err, float(d.max()))
                mag = max(mag, float(b.abs().max()))
                if not bool((d <= 1e-12 + 1e-9 * b.abs()).all()):
                    fail(f"K10 {what}: {name} outside rtol 1e-9 (max abs "
                         f"{float(d.max())})")
        elif not torch.equal(a, b):
            fail(f"K10 {what}: {name} differs from the plain version")
    return err, mag


def window_bound_ms(ev, outs):
    """Least time of K10 on one window: the sorted order read once; each
    array K10 reads read once through it — a key's data and NULL flags,
    an argument's NULL flags, and its data only where a SUM, MIN or MAX
    reads it (COUNT reads the flags alone) — a random 32-byte sector per
    row for a data array and its own size for a NULL-flag array (one
    byte a row: 8 MiB at 2^23 rows, held in the 50 MB L2); every output
    written once.  Without an order (no keys) the reads are
    sequential."""
    nb, idx = ev["nb"], ev["idx"]
    data = {k[0].data_ptr(): k[0] for k in ev["keys"]}
    flags = {k[1].data_ptr(): k[1] for k in ev["keys"]}
    for name, a in ev["funcs"]:
        if a is None:
            continue
        d, nl = ev["args"][a]
        flags[nl.data_ptr()] = nl
        if name in ("sum", "min", "max"):
            data[d.data_ptr()] = d
    moved = (8 * nb if idx is not None else 0)
    moved += sum(nb * (SECTOR if idx is not None else d.element_size())
                 for d in data.values()) + nb * len(flags)
    moved += nbytes([t for pair in outs for t in pair])
    return moved / HBM_BYTES_PER_S * 1e3


def check_window_kernel(name, ev):
    """K10 against its plain version on one window's full inputs, timed
    beside its bound and one torch.cumsum over the same rows."""
    import torch
    out_k, out_p = k10_call(ev), k10_call(ev, plain=True)
    torch.cuda.synchronize()
    err, mag = compare_window(out_k, out_p, ev["funcs"], name)
    ms = cuda_ms(lambda: k10_call(ev))
    plain_ms = cuda_ms(lambda: k10_call(ev, plain=True))
    bound = window_bound_ms(ev, out_k)
    z = ev["keys"][0][0]
    scan_ms = cuda_ms(lambda: torch.cumsum(z, 0))
    funcs = ", ".join(f for f, _a in ev["funcs"])
    log(f"[K10] {name}: nb={ev['nb']}, n_live={ev['n_live']}, "
        f"{ev['n_part']} partition + {len(ev['keys']) - ev['n_part']} "
        f"order keys, {len(ev['args'])} arguments, functions [{funcs}]: "
        f"max abs err {err!r} (largest |float output| {mag!r}); "
        f"{ms:.3f} ms (plain {plain_ms:.3f} ms, "
        f"bound {bound:.4f} ms; one torch.cumsum over the rows "
        f"{scan_ms:.3f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)


def window_stage_ms(ev):
    """K2, K4 and K10 ms (CUDA events) and the one device -> host copy's
    ms of one captured window."""
    from tidb_tpu_torch.executor import device_exec
    from tidb_tpu_torch.ops.kernels import expr_vm, sort_topk
    dev = ev["keys"][0][0].device
    k2 = cuda_ms(lambda: expr_vm.run(ev["prog"], ev["inputs"], ev["nb"],
                                     ev["n_live"], dev))
    k4 = cuda_ms(lambda: sort_topk.window_order(
        [k[0] for k in ev["keys"]], [k[1] for k in ev["keys"]],
        ev["descs"], ev["nb"], ev["n_live"]))
    k10 = cuda_ms(lambda: k10_call(ev))
    n = ev["n_live"]
    outs = tuple((d[:n], nl[:n]) for d, nl in ev["outs"])
    device_exec._fetch(outs)
    t0 = time.perf_counter()
    device_exec._fetch(outs)
    d2h = (time.perf_counter() - t0) * 1e3
    return k2, k4, k10, d2h


def check_window_order(ev):
    """K4's window order on W2 (two int64 keys without NULLs on the live
    rows) against torch.sort(stable=True) of the one int64 that packs
    them, padding rows last."""
    import torch
    nb, n_live = ev["nb"], ev["n_live"]
    (supp, sn), (ship, shn) = ev["keys"]
    if bool(sn[:n_live].any()) or bool(shn[:n_live].any()):
        fail("K4 window order: W2's keys hold NULLs")
    s_live, h_live = supp[:n_live], ship[:n_live]
    smin, hmin = int(s_live.min()), int(h_live.min())
    span = int(h_live.max()) - hmin + 1
    live = torch.arange(nb, device=supp.device) < n_live
    packed = torch.where(live, (supp - smin) * span + (ship - hmin),
                         torch.full((), 1 << 62, device=supp.device))
    want = torch.sort(packed, stable=True).indices
    if not torch.equal(ev["idx"], want):
        fail("K4 window order differs from torch.sort of the packed key")
    lib_ms = cuda_ms(lambda: torch.sort(packed, stable=True))
    return lib_ms


def check_w2(res, n_rows, supp_counts, what):
    """W2's count, sum of row numbers and largest running count equal
    what the generated partition sizes (rows per l_suppkey) give."""
    row = res.rows[0]
    want = (str(n_rows), str(int((supp_counts * (supp_counts + 1)
                                  // 2).sum())), str(int(supp_counts.max())))
    if (row[0], row[1], row[4]) != want:
        fail(f"{what}: count, sum(row_number), max(count) {row} != {want} "
             "from the generated partition sizes")


def window_split(st, stages, dev_ms):
    """Where one window query's time went: the window operator's host
    time (``device_exec.LAST_WINDOW_STATS``: uploads, planning, kernels,
    the copy back, assembly), its kernels' and copy's own times (CUDA
    events and host clock, timed apart), and the rest of the query (the
    host operators around the window)."""
    k2, k4, k10, d2h = stages
    w = st["window_s"] * 1e3
    return (f"window of {st['n']} rows, bucket {st['nb']}: operator "
            f"{w:.3f} ms, of it K2 {k2:.3f} ms, K4 {k4:.3f} ms, K10 "
            f"{k10:.3f} ms, D2H {d2h:.3f} ms, host assembly "
            f"{st['assemble_s'] * 1e3:.3f} ms; the rest of the query "
            f"{dev_ms - w:.3f} ms")


def phase_window(s, n_rows, supp_counts, report):
    """``[window]``: W1-W4 on the SF1 tables, the kernels against their
    plain versions on the full captured inputs, the main-path run with
    its launch counts, and the rows against the host engine."""
    import torch
    from tidb_tpu_torch.executor import device_exec
    from tidb_tpu_torch.ops.kernels import sort_topk
    s.execute("use tpch")
    s.execute("set @@tidb_executor_engine = 'tpu'")
    events = {}
    for name, sql in WINDOW_QUERIES + (("w_orders", W_ORDERS),):
        with WindowCapture() as cap:
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
        if cap.last is None:
            fail(f"window {name}: the device window never ran")
        events[name] = cap.last
        log(f"[window] warm-up {name}: "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    # the kernels against their plain versions, on the card
    row = None
    for name in ("w2", "w4", "w_orders"):
        r = check_window_kernel(f"{name} (sf1)", events[name])
        if name == "w2":
            row = dict(r)
        row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
    report["window_scan"].update(row)
    lib_ms = check_window_order(events["w2"])
    for name in ("w2", "w4"):
        ev = events[name]
        keys = ev["keys"]
        k4 = cuda_ms(lambda: sort_topk.window_order(
            [k[0] for k in keys], [k[1] for k in keys], ev["descs"],
            ev["nb"], ev["n_live"]))
        bound = (nbytes([t for k in keys for t in k]) + 8 * ev["nb"]) \
            / HBM_BYTES_PER_S * 1e3
        extra = (f"; equal to torch.sort(stable=True) of the packed int64 "
                 f"key, {lib_ms:.3f} ms" if name == "w2" else "")
        log(f"[K4] window order {name}: nb={ev['nb']}, {len(keys)} keys: "
            f"{k4:.3f} ms (bound {bound:.4f} ms){extra}")
        if name == "w2":
            report["sort_topk"].update(window_order_ms=k4,
                                       window_order_bound_ms=bound,
                                       window_order_library_ms=lib_ms)
    stages = {name: window_stage_ms(events[name])
              for name, _sql in WINDOW_QUERIES}
    events.clear()
    torch.cuda.empty_cache()

    # the main path: counters at 0, each query once more (steady state)
    counters = window_counters()
    for c in counters.values():
        c[0] = 0
    dev_res, dev_ms, assemble = {}, {}, {}
    for name, sql in WINDOW_QUERIES:
        before = {k: c[0] for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_res[name] = s.execute(sql)[-1]
        torch.cuda.synchronize()
        dev_ms[name] = (time.perf_counter() - t0) * 1e3
        assemble[name] = dict(device_exec.LAST_WINDOW_STATS)
        moved = {k: c[0] - before[k] for k, c in counters.items()}
        for k in WINDOW_NEED:
            if moved[k] <= 0:
                fail(f"window {name}: kernel {k} was not launched "
                     "(degraded to the host engine?)")
    report["window_scan"]["launches"] = counters["window_scan"][0]
    log(f"[window] launches {dict((k, c[0]) for k, c in counters.items())}")
    for name, sql in WINDOW_QUERIES:
        res = s.execute("explain analyze " + sql)[-1]
        lines = [r for r in res.rows if "Window" in str(r[0])]
        if not lines or not all(any("engine:tpu" in str(c) for c in r)
                                for r in lines):
            for r in res.rows:
                log(f"    {r}")
            fail(f"window {name}: EXPLAIN ANALYZE shows a Window without "
                 "engine:tpu")
    check_w2(dev_res["w2"], n_rows, supp_counts, "window w2")
    s.execute("set @@tidb_executor_engine = 'host'")
    for name, sql in WINDOW_QUERIES:
        t0 = time.perf_counter()
        host = s.execute(sql)[-1]
        host_s = time.perf_counter() - t0
        if not host.rows or not rows_equal(dev_res[name], host):
            fail(f"window {name}: device rows differ from the host "
                 f"engine's:\ndevice {dev_res[name].rows[:5]}\n"
                 f"host   {host.rows[:5]}")
        log(f"[window] {name}: {len(host.rows)} rows equal the host "
            f"engine's, engine:tpu; device {dev_ms[name]:.3f} ms "
            f"({window_split(assemble[name], stages[name], dev_ms[name])}"
            f"); host engine {host_s:.3f} s; first {host.rows[:1]}")


def window_sf10(s, n_rows, supp_counts):
    """W2 over the SF10 lineitem on the device (the host engine's window
    over 60M rows does not fit the time budget): K10 against its plain
    version on its inputs, the result against the generated partition
    sizes, and its time."""
    import torch
    from tidb_tpu_torch.executor import device_exec
    s.execute("set @@tidb_executor_engine = 'tpu'")
    with WindowCapture() as cap:
        t0 = time.perf_counter()
        s.execute(W2)
        torch.cuda.synchronize()
    if cap.last is None:
        fail("sf10 window w2: the device window never ran")
    log(f"[window] sf10 warm-up w2: {time.perf_counter() - t0:.3f} s")
    ev = cap.last
    check_window_kernel("w2 (sf10)", ev)
    k2, k4, k10, d2h = window_stage_ms(ev)
    del ev, cap
    torch.cuda.empty_cache()
    counters = window_counters()
    for c in counters.values():
        c[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = s.execute(W2)[-1]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for k in WINDOW_NEED:
        if counters[k][0] <= 0:
            fail(f"sf10 window w2: kernel {k} was not launched")
    check_w2(res, n_rows, supp_counts, "sf10 window w2")
    split = window_split(device_exec.LAST_WINDOW_STATS, (k2, k4, k10, d2h),
                         dt * 1e3)
    log(f"[window] sf10 w2: {dt * 1e3:.3f} ms on the device engine "
        f"({split}); count, sum(row_number) and max(count) equal the "
        "generated partition sizes; launches "
        f"{dict((k, c[0]) for k, c in counters.items())}")


# -- the out-of-core path: paged tables, streamed and paged queries ----------

#: the queries that stream or page (the join without an aggregate has no
#: aggregate fragment to page), and the scan aggregates among them
STREAM_QUERIES = ("q1", "q6", "topn", "q3", "q5", "q9", "q18")
#: a streamed COUNT(DISTINCT) (its own path: no partial-state fold)
COUNT_DISTINCT = ("select l_returnflag, count(distinct l_suppkey) "
                  "from lineitem group by l_returnflag "
                  "order by l_returnflag")
SCAN_AGGS = ("q1", "q6", "topn")

#: kernels each streamed or paged query must launch: every page runs K2 +
#: K1 (and a join page K5a and K5b's count), the partial states fold
#: through the merge; Q3's and Q18's final states select their top rows
#: with K4 (the streamed scan aggregate fetches its whole state instead)
STREAM_NEED = {
    **{q: ["expr_vm", "groupby_agg", "merge_states"] for q in SCAN_AGGS},
    **{q: ["expr_vm", "groupby_agg", "join_probe", "join_expand",
           "merge_states"] for q in ("q5", "q9")},
    **{q: ["expr_vm", "groupby_agg", "join_probe", "join_expand",
           "merge_states", "sort_topk"] for q in ("q3", "q18")},
}


def stream_counters():
    from tidb_tpu_torch.ops.kernels import (expr_vm, groupby_agg,
                                            join_expand, join_probe,
                                            merge_states, sort_topk)
    return {"expr_vm": expr_vm.LAUNCHES, "groupby_agg": groupby_agg.LAUNCHES,
            "sort_topk": sort_topk.LAUNCHES,
            "join_probe": join_probe.LAUNCHES,
            "join_expand": join_expand.LAUNCHES,
            "merge_states": merge_states.LAUNCHES}


def pinned_h2d_rate():
    """Bytes / s of one pinned host → device copy of 256 MiB (CUDA
    events, after one warm-up copy)."""
    import torch
    n = 256 << 20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    dev.copy_(host, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    return n / (start.elapsed_time(end) / 1e3)


class StreamRecorder:
    """While installed, keeps every streamed or paged run's stage
    statistics (``device_exec.StreamStats``, one per run: a Q18 has its
    IN subquery's streamed aggregate and its paged join)."""

    def __init__(self):
        self.runs = []

    def __enter__(self):
        from tidb_tpu_torch.executor import device_exec
        self._orig = orig = device_exec.StreamStats.finish
        runs = self.runs

        def finish(st, *a, **kw):
            orig(st, *a, **kw)
            runs.append(dict(st.s))
        device_exec.StreamStats.finish = finish
        return self

    def __exit__(self, *exc):
        from tidb_tpu_torch.executor import device_exec
        device_exec.StreamStats.finish = self._orig


def stream_lines(tag, name, runs, dt, rate):
    """The ``[stream]`` line of each streamed or paged run of a query."""
    for st in runs:
        bound = st["h2d_bytes"] / rate
        log(f"[stream] {tag} {name} ({st['kind']}): {st['pages']} pages, "
            f"{st['h2d_bytes']:,} bytes host→device in {st['h2d_s']:.4f} s "
            f"on the copy stream (H2D bound {bound:.4f} s at "
            f"{rate / 1e9:.2f} GB/s pinned); host slicing "
            f"{st['slice_s']:.4f} s, dispatch {st['dispatch_s']:.4f} s, "
            f"sync {st['sync_s']:.4f} s ({st['syncs']} reads), merge "
            f"{st['merge_s']:.4f} s ({st['merges']} folds), fetch "
            f"{st['fetch_s']:.4f} s; capacity {st['capacity']}, "
            f"{st['groups']} groups; query {dt:.4f} s, of it "
            f"{st['index_s']:.4f} s in {st['index_builds']} join index "
            "builds (host numpy)")


def run_streamed(s, tag, name, sql, counters, need=None, kind=None):
    """One query on the device engine; it must run streamed (scan
    aggregates) or paged (joins).  Returns (result, seconds, launches,
    runs); each run carries ``index_s``, the host seconds the query spent
    in join index (re)builds (K6, numpy), and ``index_builds``."""
    import torch
    from tidb_tpu_torch.executor import device_join
    before = {k: c[0] for k, c in counters.items()}
    builds = []
    build_index = device_join.build_join_index

    def timed_build(*a, **kw):
        t = time.perf_counter()
        try:
            return build_index(*a, **kw)
        finally:
            builds.append(time.perf_counter() - t)
    device_join.build_join_index = timed_build
    try:
        with StreamRecorder() as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = s.execute(sql)[-1]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        device_join.build_join_index = build_index
    for r in rec.runs:
        r["index_s"], r["index_builds"] = sum(builds), len(builds)
    moved = {k: c[0] - before[k] for k, c in counters.items()}
    kinds = [r["kind"] for r in rec.runs]
    want = kind or ("stream" if name in SCAN_AGGS else "paged")
    if want not in kinds or not all(r["pages"] >= 2 for r in rec.runs
                                    if r["kind"] == want):
        fail(f"{tag} {name}: did not run {want} on the device (runs "
             f"{kinds}; degraded to the host engine or the resident "
             "path?)")
    for k in need or ():
        if moved[k] <= 0:
            fail(f"{tag} {name}: kernel {k} was not launched")
    return res, dt, moved, rec.runs


def phase_paged_sf1(args, dom, host_res, rate):
    import shutil
    import tempfile
    from tidb_tpu_torch import carry
    from tidb_tpu_torch.session import new_session
    t0 = time.perf_counter()
    tables = carry.gen_tpch(SF, seed=args.seed)
    root = tempfile.mkdtemp(prefix="tidb-paged-sf1-")
    try:
        s = new_session(dom)
        carry.install_tpch(s.execute, dom, "tpch_paged", tables,
                           paged_root=root)
        del tables
        log(f"[paged-sf1] lineitem and orders written paged to a "
            f"temporary directory, the rest bulk, ANALYZE: "
            f"{time.perf_counter() - t0:.1f}s")
        s.execute("set @@tidb_executor_engine = 'tpu'")
        s.execute(f"set tidb_device_stream_rows = {PAGED_SF1_ROWS}")
        counters = stream_counters()
        for c in counters.values():
            c[0] = 0
        sqls = dict(QUERIES)
        for name in STREAM_QUERIES:
            res, dt, moved, runs = run_streamed(
                s, "paged-sf1", name, sqls[name], counters,
                STREAM_NEED[name])
            if not rows_equal(res, host_res[name]):
                fail(f"paged-sf1 {name}: rows differ from the host "
                     f"engine's:\ndevice {res.rows[:5]}\n"
                     f"host   {host_res[name].rows[:5]}")
            log(f"[paged-sf1] {name}: {len(res.rows)} rows equal the host "
                f"engine's on the bulk tables; {dt * 1e3:.3f} ms, "
                f"launches {moved}")
            stream_lines("paged-sf1", name, runs, dt, rate)
        log(f"[paged-sf1] launches {dict((k, c[0]) for k, c in counters.items())}")
        # streamed COUNT(DISTINCT): per-page pair dedup (K1 `first`), one
        # K1 cnt_dist over the live pairs — against the host engine on
        # the bulk tables
        res, dt, moved, runs = run_streamed(
            s, "paged-sf1", "count_distinct", COUNT_DISTINCT, counters,
            ["expr_vm", "groupby_agg"], kind="stream")
        s.execute("use tpch")
        s.execute("set @@tidb_executor_engine = 'host'")
        host = s.execute(COUNT_DISTINCT)[-1]
        if not host.rows or not rows_equal(res, host):
            fail(f"paged-sf1 count_distinct: rows differ from the host "
                 f"engine's:\ndevice {res.rows}\nhost   {host.rows}")
        log(f"[paged-sf1] count_distinct: {len(res.rows)} rows equal the "
            f"host engine's on the bulk tables; {dt * 1e3:.3f} ms, "
            f"launches {moved}")
        stream_lines("paged-sf1", "count_distinct", runs, dt, rate)
        s.execute("use tpch_paged")
        s.execute("set @@tidb_executor_engine = 'tpu'")
        for name in SCAN_AGGS:
            res = s.execute("explain analyze " + sqls[name])[-1]
            agg_lines = [r for r in res.rows if "HashAgg" in str(r[0])]
            if not agg_lines or not all(
                    any("engine:tpu-stream" in str(c) for c in r)
                    for r in agg_lines):
                for r in res.rows:
                    log(f"    {r}")
                fail(f"paged-sf1 {name}: EXPLAIN ANALYZE shows a HashAgg "
                     "without engine:tpu-stream")
            log(f"[paged-sf1] {name}: EXPLAIN ANALYZE engine:tpu-stream")
    finally:
        shutil.rmtree(root, ignore_errors=True)


class FoldCapture:
    """While installed, keeps the largest partial-state fold that fit its
    merge capacity: (parts, n_keys, merge_ops, merge_cap, pack)."""

    def __init__(self):
        self.best = None

    def __enter__(self):
        from tidb_tpu_torch.ops.kernels import merge_states
        self._orig = orig = merge_states.merge

        def merge(parts, n_keys, merge_ops, merge_cap, pack=None):
            out = orig(parts, n_keys, merge_ops, merge_cap, pack)
            rows = sum(int(p[0][0].shape[0]) for p in parts)
            if int(out[4]) <= merge_cap and (
                    self.best is None or rows >= self.best[0]):
                self.best = (rows, (list(parts), n_keys, merge_ops,
                                    merge_cap, pack))
            return out
        merge_states.merge = merge
        return self

    def __exit__(self, *exc):
        from tidb_tpu_torch.ops.kernels import merge_states
        merge_states.merge = self._orig


def check_merge(name, call):
    """The merge kernel against its plain version on one fold of the main
    path, timed beside its bound: the live slots of every part and their
    group counts read once, the merged state written once."""
    import torch
    from tidb_tpu_torch.ops.kernels import merge_states
    parts, n_keys, merge_ops, merge_cap, pack = call
    out_k = merge_states.merge(*call)
    out_p = merge_states.merge_plain(*call)
    torch.cuda.synchronize()
    err = compare_agg(out_k, out_p, merge_ops, merge_cap, f"merge {name}")
    ms = cuda_ms(lambda: merge_states.merge(*call))
    plain_ms = cuda_ms(lambda: merge_states.merge_plain(*call))
    live = sum(min(int(p[4]), int(p[0][0].shape[0])) for p in parts)
    slot = 9 * n_keys + 9 * len(merge_ops)  # value 8 B + NULL flag 1 B each
    moved = live * slot + 8 * len(parts) + merge_cap * (slot + 1) + 8
    bound = moved / HBM_BYTES_PER_S * 1e3
    caps = sorted({int(p[0][0].shape[0]) for p in parts})
    log(f"[merge] {name}: {len(parts)} parts (capacities {caps}), {live} "
        f"live slots -> {int(out_k[4])} groups in {merge_cap} slots, "
        f"pack {pack}: max abs err {err:.3g}; {ms:.3f} ms (plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)


def phase_sf10(args, dom, rate, report):
    import numpy as np
    import torch
    from tidb_tpu_torch import carry
    from tidb_tpu_torch.session import new_session
    t0 = time.perf_counter()
    tables = carry.gen_tpch(SF_BIG, seed=args.seed)
    n = tables["lineitem"][1]
    log(f"[sf10] generated the eight TPC-H tables: lineitem {n} rows, "
        f"orders {tables['orders'][1]} in {time.perf_counter() - t0:.1f}s")
    s = new_session(dom)
    t0 = time.perf_counter()
    carry.install_tpch(s.execute, dom, "tpch10", tables, analyze=False)
    supp_counts = np.bincount(tables["lineitem"][0]["l_suppkey"])
    del tables
    log(f"[sf10] installed as bulk tables in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for t in carry.TPCH_TABLES:
        s.execute(f"analyze table {t}")
    log(f"[sf10] ANALYZE of the eight tables: "
        f"{time.perf_counter() - t0:.1f}s")
    s.execute("set @@tidb_executor_engine = 'tpu'")
    sqls = dict(QUERIES)
    counters = stream_counters()
    folds = {}
    for name in STREAM_QUERIES:
        if name in ("q1", "q18"):
            with FoldCapture() as cap:
                _r, dt, _m, _runs = run_streamed(s, "sf10", name,
                                                 sqls[name], counters)
            folds[name] = cap.best[1]
        else:
            _r, dt, _m, _runs = run_streamed(s, "sf10", name, sqls[name],
                                             counters)
        log(f"[sf10] warm-up {name}: {dt:.3f} s")
    merge_row = None
    for name in ("q1", "q18"):
        row = check_merge(f"sf10 {name}", folds.pop(name))
        if merge_row is None or row["bound_ms"] > merge_row["bound_ms"]:
            merge_row = dict(row, max_abs_err=max(
                row["max_abs_err"],
                merge_row["max_abs_err"] if merge_row else 0.0))
    report["merge_states"].update(merge_row)
    torch.cuda.empty_cache()

    for c in counters.values():
        c[0] = 0
    streamed = {}
    times = {}
    for name in STREAM_QUERIES:
        res, dt, moved, runs = run_streamed(s, "sf10", name, sqls[name],
                                            counters, STREAM_NEED[name])
        streamed[name], times[name] = res, dt
        log(f"[sf10] {name}: {dt:.4f} s streamed/paged, "
            f"{n / dt:,.0f} lineitem rows/s, launches {moved}")
        stream_lines("sf10", name, runs, dt, rate)
    report["merge_states"]["launches"] = counters["merge_states"][0]
    log(f"[sf10] launches {dict((k, c[0]) for k, c in counters.items())}")

    # the resident whole-input path of the same queries
    s.execute("set tidb_device_stream_rows = -1")
    host_check = ["q6", "q3"]
    resident = {}
    for name in STREAM_QUERIES:
        before = counters["groupby_agg"][0]
        with StreamRecorder() as rec:
            s.execute(sqls[name])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = s.execute(sqls[name])[-1]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if rec.runs or counters["groupby_agg"][0] == before:
            log(f"[sf10] {name}: the resident path did not run it "
                f"(streamed/paged runs {[r['kind'] for r in rec.runs]}); "
                "its streamed rows are compared with the host engine "
                "instead")
            if name not in host_check:
                host_check.append(name)
            continue
        if not rows_equal(streamed[name], res):
            fail(f"sf10 {name}: streamed rows differ from the resident "
                 f"path's:\nstreamed {streamed[name].rows[:5]}\n"
                 f"resident {res.rows[:5]}")
        resident[name] = res
        log(f"[sf10] {name}: {len(res.rows)} rows equal the resident "
            f"path's; resident {dt:.4f} s, streamed/paged "
            f"{times[name]:.4f} s")
    s.execute("set tidb_device_stream_rows = 0")
    s.execute("set @@tidb_executor_engine = 'host'")
    for name in host_check:
        t0 = time.perf_counter()
        host = s.execute(HOST_TEXT.get(name, sqls[name]))[-1]
        dt = time.perf_counter() - t0
        if not host.rows or not rows_equal(streamed[name], host):
            fail(f"sf10 {name}: streamed rows differ from the host "
                 f"engine's:\nstreamed {streamed[name].rows[:5]}\n"
                 f"host     {host.rows[:5]}")
        log(f"[sf10] {name}: {len(host.rows)} rows equal the host "
            f"engine's (host {dt:.3f} s, streamed/paged "
            f"{times[name]:.4f} s)")
    window_sf10(s, n, supp_counts)
    # the rows [hybrid] must give: the resident path's, or where it did
    # not run, the streamed rows the host engine confirmed
    return s, {name: (resident[name], "resident") if name in resident
               else (streamed[name], "streamed, = host engine")
               for name in HYBRID_QUERIES}


# -- the hybrid hash join: SF10 under memory-constrained budgets -------------

#: bench.py --mem-budget's two budgets (BENCH_SPILL_r01.json): at 300 MB
#: orders' used columns (345 MB at SF10) go over, at 120 MB most of its
#: partitions spill
HYBRID_BUDGETS = (300_000_000, 120_000_000)
#: the queries run under them: Q5 must take the hybrid path; Q3 and Q9
#: take whichever the gates choose
HYBRID_QUERIES = ("q5", "q3", "q9")
#: kernels a device partition launches: per probe page K2, K5a and K1,
#: the page states and the final states fold through the merge
HYBRID_NEED = ["expr_vm", "join_probe", "groupby_agg", "merge_states"]


class ProbeCapture:
    """While installed, keeps a copy of the first sorted unique probe a
    fragment runs (the hybrid partition index's probe: the dimension
    indexes are dense), cloned at the call, so later pages reusing the
    staging buffers cannot change it."""

    def __init__(self):
        self.ev = None

    def __enter__(self):
        from tidb_tpu_torch.executor import device_join

        def observe(event, **kw):
            if (event == "probe" and self.ev is None
                    and kw.get("layout") == "sorted"
                    and kw.get("mode") == "uniq"):
                def cl(v):
                    if isinstance(v, (list, tuple)):
                        return type(v)(cl(x) for x in v)
                    return v.clone() if hasattr(v, "clone") else v
                self.ev = {k: cl(v) for k, v in kw.items()}
        device_join.FRAGMENT_OBSERVER[0] = observe
        return self

    def __exit__(self, *exc):
        from tidb_tpu_torch.executor import device_join
        device_join.FRAGMENT_OBSERVER[0] = None


def hybrid_run(s, sql, counters):
    """One query on the device engine under the current budget.  Returns
    (result, seconds, launches, stats): stats is the run's
    ``LAST_PAGED_STATS`` (kind "hybrid" with the hj_* fields, "paged",
    or empty for the resident path) plus ``hj_ran``."""
    import torch
    from tidb_tpu_torch.executor import device_join, hybrid_join
    before = {k: c[0] for k, c in counters.items()}
    runs0 = hybrid_join.STATS["hj_runs"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = s.execute(sql)[-1]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = dict(device_join.LAST_PAGED_STATS.items())
    st["hj_ran"] = hybrid_join.STATS["hj_runs"] - runs0
    moved = {k: c[0] - before[k] for k, c in counters.items()}
    return res, dt, moved, st


def hybrid_line(tag, st, dt, rate):
    """The ``[hybrid]`` line of one hybrid run: the split, the spill, the
    host's partition / host-pass / wait seconds, the device pass, its
    H2D bytes and copy time, and its bound: the probe pages' and the
    partition build columns' bytes read once at the HBM rate plus the
    same bytes host → device at the measured pinned rate."""
    moved = st["h2d_bytes"] + st["build_h2d_bytes"]
    bound = moved / HBM_BYTES_PER_S + moved / rate
    log(f"[hybrid] {tag}: {st['hj_partitions']} partitions, "
        f"{st['hj_spilled_partitions']} spilled ({st['hj_spill_bytes']:,} "
        f"spill bytes), {st['hj_coproc_host_rows']:,} rows joined on the "
        f"host; join.partition {st['hj_partition_s']:.3f} s, device pass "
        f"{st['hj_probe_device_s']:.3f} s ({st['pages']} pages, "
        f"{st['h2d_bytes']:,} probe bytes + {st['build_h2d_bytes']:,} "
        f"partition bytes host→device, {st['h2d_s']:.4f} s on the copy "
        f"stream; bound {bound:.4f} s at {rate / 1e9:.2f} GB/s pinned and "
        f"HBM), host pass {st['hj_probe_host_s']:.3f} s, host wait "
        f"{st['hj_host_wait_s']:.3f} s, slicing {st['slice_s']:.4f} s, "
        f"merge {st['merge_s']:.4f} s ({st['merges']} folds); query "
        f"{dt:.4f} s, hybrid {st['hj_total_s']:.3f} s")
    return bound


def hybrid_path(st):
    if st.get("hj_ran"):
        return "hybrid"
    return st.get("kind") or "resident"


def phase_hybrid(s, rate, sf10_rows, report):
    """``[hybrid]`` — SF10 Q5 (and Q3, Q9) under bench.py --mem-budget's
    budgets on the ``tpch10`` tables of ``[sf10]``."""
    import torch
    from tidb_tpu_torch.executor import hybrid_join
    from tidb_tpu_torch.ops import residency
    sqls = dict(QUERIES)
    counters = stream_counters()
    s.execute("set @@tidb_executor_engine = 'tpu'")
    s.execute("set tidb_device_stream_rows = 0")
    probe_cap, fold_cap = ProbeCapture(), FoldCapture()
    try:
        for budget in HYBRID_BUDGETS:
            # an empty ledger and throughput store: the first run's split
            # is the one the CPU tests hold equal to the reference's
            residency.evict_all(f"[hybrid] budget {budget}")
            hybrid_join._THROUGHPUT.clear()
            torch.cuda.empty_cache()
            s.execute(f"set global tidb_device_mem_budget = {budget}")
            tag = f"q5 @ {budget:,} B"
            with probe_cap, fold_cap:
                res, dt, _m, st = hybrid_run(s, sqls["q5"], counters)
            if not st["hj_ran"]:
                fail(f"hybrid {tag} warm-up: the hybrid path did not run "
                     f"(path {hybrid_path(st)})")
            hybrid_line(f"warm-up {tag}", st, dt, rate)
            for c in counters.values():
                c[0] = 0
            res, dt, moved, st = hybrid_run(s, sqls["q5"], counters)
            if not st["hj_ran"]:
                fail(f"hybrid {tag}: the hybrid path did not run (path "
                     f"{hybrid_path(st)})")
            want, what = sf10_rows["q5"]
            if not rows_equal(res, want):
                fail(f"hybrid {tag}: rows differ from [sf10]'s {what} "
                     f"rows:\nhybrid {res.rows[:5]}\nsf10   {want.rows[:5]}")
            hybrid_line(tag, st, dt, rate)
            dev_parts = st["hj_partitions"] - st["hj_spilled_partitions"]
            log(f"[hybrid] {tag}: {len(res.rows)} rows equal [sf10]'s "
                f"{what} rows; {dev_parts} device partitions; launches "
                f"{moved}")
            if budget == HYBRID_BUDGETS[0]:
                missing = [k for k in HYBRID_NEED if moved[k] <= 0]
                if dev_parts < 1 or missing:
                    fail(f"hybrid {tag}: no device partition launched "
                         f"{missing or HYBRID_NEED}")
            else:
                if (st["hj_spilled_partitions"] < 1
                        or st["hj_coproc_host_rows"] <= 0):
                    fail(f"hybrid {tag}: no partition spilled and "
                         "co-processed on the host")
            for name in ("q3", "q9"):
                res, dt, moved, st = hybrid_run(s, sqls[name], counters)
                path = hybrid_path(st)
                want, what = sf10_rows[name]
                if not rows_equal(res, want):
                    fail(f"hybrid {name} @ {budget:,} B ({path}): rows "
                         f"differ from [sf10]'s {what} rows:\n"
                         f"got  {res.rows[:5]}\nsf10 {want.rows[:5]}")
                log(f"[hybrid] {name} @ {budget:,} B: path {path}; "
                    f"{len(res.rows)} rows equal [sf10]'s {what} rows; "
                    f"{dt:.4f} s, launches {moved}")
                if path == "hybrid":
                    hybrid_line(f"{name} @ {budget:,} B", st, dt, rate)
        if probe_cap.ev is None:
            fail("hybrid: no device partition ran a sorted probe")
        ev = probe_cap.ev
        ms, plain_ms, bound = check_probe(ev, "K5a hybrid partition probe")
        log(f"[hybrid] K5a sorted probe of a partition index: page of "
            f"{ev['keys'][0].shape[0]} rows, index of {int(ev['nv'])} "
            f"keys (packs {ev['packs']}): exact; {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms)")
        row = check_merge("hybrid q5", fold_cap.best[1])
        report["merge_states"]["max_abs_err"] = max(
            report["merge_states"]["max_abs_err"], row["max_abs_err"])
    finally:
        s.execute("set global tidb_device_mem_budget = 0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "tidb_tpu_torch")):
        print("chip_smoke: the tidb_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tidb_tpu_torch.ops import device as pdev
    pdev.set_device("cuda")
    report = {
        "groupby_agg": {"name": "K1 groupby_agg", "route": "cuda",
                        "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                  "groupby_agg.cu",
                        "replaces": "tidb_tpu/ops/device.py:1205",
                        "bound_by": "bytes", "library_ms": None},
        "expr_vm": {"name": "K2/K3 expr_vm", "route": "cuda",
                    "source": "tidb_tpu_torch/ops/kernels/csrc/expr_vm.cu",
                    "replaces": "tidb_tpu/executor/device_exec.py:480",
                    "bound_by": "bytes", "library_ms": None},
        "sort_topk": {"name": "K4 sort_topk", "route": "cuda",
                      "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                "sort_topk.cu",
                      "replaces": "tidb_tpu/executor/device_exec.py:711",
                      "bound_by": "bytes", "library_ms": None},
        "expr_vm_loadg": {"name": "K2 expr_vm LOADG (join row space)",
                          "route": "cuda",
                          "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                    "expr_vm.cu",
                          "replaces": "tidb_tpu/executor/device_join.py:704",
                          "bound_by": "bytes", "library_ms": None},
        "join_probe": {"name": "K5a join_probe", "route": "cuda",
                       "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                 "join_probe.cu",
                       "replaces": "tidb_tpu/executor/device_join.py:612",
                       "bound_by": "bytes", "library_ms": None},
        "join_expand": {"name": "K5b join_expand", "route": "cuda",
                        "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                  "join_expand.cu",
                        "replaces": "tidb_tpu/executor/device_join.py:519",
                        "bound_by": "bytes", "library_ms": None},
        "join_expand_count": {"name": "K5b join_expand count (final mask)",
                              "route": "cuda",
                              "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                        "join_expand.cu",
                              "replaces": "tidb_tpu/executor/"
                                          "device_join.py:892",
                              "bound_by": "bytes", "library_ms": None},
        "join_match": {"name": "K7 device_join_match (K4 + K5a + K5b)",
                       "route": "cuda",
                       "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                 "join_probe.cu",
                       "replaces": "tidb_tpu/ops/device.py:1506",
                       "bound_by": "bytes", "library_ms": None},
        # no one PyTorch call computes a group-by, so none a fold of them
        "merge_states": {"name": "K8/K9 merge_states (partial-state fold)",
                         "route": "cuda",
                         "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                   "merge_states.cu",
                         "replaces": "tidb_tpu/executor/device_exec.py:1323",
                         "bound_by": "bytes", "library_ms": None},
        # no one PyTorch call computes a segmented window (one
        # torch.cumsum over the rows is logged beside it)
        "window_scan": {"name": "K10 window_scan", "route": "cuda",
                        "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                  "window_scan.cu",
                        "replaces": "tidb_tpu/executor/device_exec.py:1529",
                        "bound_by": "bytes", "library_ms": None},
    }
    t_all = time.perf_counter()
    t_phase = [t_all]

    def phase_done(name):
        now = time.perf_counter()
        log(f"[phase] {name}: {now - t_phase[0]:.1f}s")
        t_phase[0] = now
    try:
        phase_build()
        phase_done("build")
        captured, joins = {}, {}
        dom, s, n_rows, keys = phase_sql_setup(args, captured, joins)
        phase_done("sql set-up")
        phase_kernels(args, captured, report)
        phase_join_kernels(args, joins, keys, report)
        supp_counts = keys["supp_counts"]
        captured.clear()
        joins.clear()
        del keys
        phase_done("kernels")
        host_res = phase_main_path(dom, s, n_rows, report)
        phase_done("main path")
        phase_window(s, n_rows, supp_counts, report)
        phase_done("window")
        rate = pinned_h2d_rate()
        log(f"[h2d] pinned host -> device copy of 256 MiB: "
            f"{rate / 1e9:.3f} GB/s")
        phase_paged_sf1(args, dom, host_res, rate)
        phase_done("paged-sf1")
        s10, sf10_rows = phase_sf10(args, dom, rate, report)
        phase_done("sf10")
        phase_hybrid(s10, rate, sf10_rows, report)
        phase_done("hybrid")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if not card:
        print("chip_smoke: nvidia-smi gave no card line", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_all:.1f}s")
    print(card)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # K4's row also carries its time as the window's order (W2, 2^23)
    extra = ("window_order_ms", "window_order_bound_ms",
             "window_order_library_ms")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
        for r in report.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
