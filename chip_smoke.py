#!/usr/bin/env python3
"""Smoke run of the H100 port (``tidb_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 42]
    python3 chip_smoke.py --faults    # the build and [faults] alone

Phases, each fatal on failure:

0. ``[lint]`` — the port's static checker (``python -m
   tidb_tpu_torch.lint --json``) in a process of its own while the
   kernels build (phase 1; a build failure stops it and is the run's
   error), with the device-side rules only (``LINT_RULES``: kernel
   launches through
   ``ops/kernels/build.py launch``, device slots, supervised dispatch,
   ``run_device``'s shape, host syncs in pipeline bodies); a finding, a
   stale allowlist entry or a non-zero exit fails the run.  One line
   with the rules, findings, allowlisted count and seconds, and the C
   functions the lint finds declared in ``ops/kernels/`` (the whole lint
   runs with the CPU tests, ``tests/test_torch_lint.py``);
1. build — the CUDA kernels under tidb_tpu_torch/ops/kernels/csrc, with
   nvcc for sm_90a (one process per source, started together);
2. SQL set-up — ``bootstrap_domain()`` / ``new_session()``, the eight
   TPC-H-shaped tables at scale factor 1 (``carry.gen_tpch``: lineitem
   from --seed, the rest from the reference benchmark's second stream)
   with ANALYZE, one warm-up run of each query (which records the
   programs and inputs the main path hands the kernels) and EXPLAIN
   ANALYZE, which must show ``engine:tpu`` on every HashAgg;
1b. the build's ptxas report: every entry function's stack frame and
   registers; a K2 entry with a stack frame fails the run;
1c. ``[fold-split]`` — ``python3 chip_smoke.py --fold-split`` in a
   process of its own, whose device trace keeps every launch (inside the
   whole run it drops some of the fold's): the ``[merge]`` check of
   phase 8 on seeded folds shaped like Q18's SF10 fold (a running state
   of 2^24 slots and seven blocks of 2^22, one packed key drawn over
   60M orderkeys, a sum), the mesh's (eight shard states of 2^21 slots,
   one key without a pack, a sum and a max) and Q1's (15 K1 states of
   4,096 slots, two packed keys, eight results), its ``by kernel`` line
   splitting the fold between ``ms_bounds`` and ``ms_merge``;
1d. ``[exchange-split]`` — ``python3 chip_smoke.py --exchange-split`` in
   a process of its own: kernel A on seeded rows shaped like ``[mpp]``'s
   Q3 partition (``EXCHANGE_Q3``) and at 1023 buckets, kernel B on a
   seeded 2^21-slot int64 and float64 shard (``JOIN_SUM_SHARD``), each
   against its plain version (A every buffer exact, B int64 exact and
   float64 within rtol 1e-9, the same bits over three calls), with ms a
   call, host issue ms, device ms by kernel, the runtime's launches,
   copies and memsets a call (it fails past the wrapper's
   ``launch_plan``, one launch, on a copy or a memset) and the bound;
1e. ``[first-launch]`` — ``python3 chip_smoke.py --first-launch`` in a
   process of its own that has run nothing on the card: the CUDA
   context's and the kernel library's load time, then every kernel's
   wrapper (K2, K1, K4, K5a, K5b, K7, the fold, K10, kernel A's hash and
   partition, kernel B) called twice on small seeded tensors, each
   call's ms (the first pays the kernel's module load, its attributes,
   workspaces and the allocator's growth: what a background warm takes
   off the query path);
3. kernels against their plain PyTorch versions on the card, at the main
   path's shapes: K2/K3 the expression VM on the Q1, Q6 and top-N
   programs, (K2's LOADG) on Q3's post-join program and on a program of
   64 registers over Q1's rows (exact), K1 the group-by aggregate on the
   Q1 and top-N inputs, on Q1's rows in one hot group, on Q1's values
   over 2^7, 2^8 and 2^9 uniform groups (timed also with its buckets
   forced into the workspace) and on seeded
   cases covering every aggregate, NULL keys, the pack and hash paths
   and capacity overflow (integers exact, floats rtol 1e-9 / atol 1e-12:
   atomics sum in another order) — each K2 and K1 line with one call's
   device time, device operations and host issue time, K2's with its
   rows per thread and shared bytes per block — K4 the top-k sort at cap = 2^21,
   k = 10, with descending keys, NULLs and ties (exact, top-k and full
   order) and one float key against torch.sort(stable=True) (exact), with
   its radix passes and bits per word, K5a the join
   probe on Q3's dense unique probes and Q9's sorted partsupp probe
   (exact), K5a's finish as the epilogue of the LEFT JOIN's ON residual
   launch (phase 4's ``left_on``: K2's program and inputs as the
   warm-up gave them) against the interpreter and ``finish_plain`` for
   every join kind, with and without a validity mask (exact), timed
   beside the same launch without the epilogue, K5b the CSR expansion of orders into lineitem at SF1 —
   inner, left, and with the total over the capacity (exact), K5b's count
   of each join query's final row mask (exact, against ``mask.sum()``),
   K7 the standalone join match (``[K7]``, one line a layout: orders ×
   lineitem keys on the unique dense path, partsupp's ps_partkey ×
   lineitem's l_partkey on the duplicate dense path, the orders keys
   spread past a dense span on the sorted path, the unique dense layout
   with NULL keys on both sides, and lineitem's keys with a tenth of the
   rows under one key, which takes the sorted path), each exact against
   its plain version on the same tensors, with its path, device ms and
   operations, host issue ms, device-to-host reads a call, bound, plain
   ms and the parent's route on the same tensors, and one
   ``device_join_match`` call split into upload, kernels and copy back;
   then a build of RANK_MAX rows a key down the rank and the sorted
   paths (``python3 chip_smoke.py --k7`` runs these lines alone, on
   SF1-shaped keys made with numpy); each timed with CUDA events beside its bound;
4. the main path — every launch counter set to 0, then Q1, Q6, the
   top-N, Q3, Q5, Q9, Q18, two joins without an aggregate (K7: orders ⋈
   lineitem builds on lineitem, the duplicate dense path; orders ⋈
   customer on customer, the unique dense path) and a LEFT
   JOIN of orders and customer with an ON residual over both sides
   (``left_on``) under ``tidb_executor_engine = 'tpu'``; each query must
   launch its kernels (K1 and K2; the top-N, Q3 and Q18 also K4; the join
   queries K5a, K5b's count of the final mask and, but ``left_on``'s
   unique probe, K5b; ``left_on`` K5a's finish in its ON residual's K2
   launch (its C launcher calls are logged); the joins without an aggregate
   K7's index stage, orders ⋈ lineitem its order stage, K5a and K5b,
   orders ⋈ customer its unique probe); the rows must
   equal the host engine's, with the same result types (every cell exact
   but in DOUBLE or FLOAT columns, which compare within rtol 1e-9 /
   atol 1e-12);
4b. ``[compile]`` — the compile layer (``executor/compile_service.py``)
   on the same session: the pipe cache dropped, the signature index off
   and ``tidb_compile_async = ON``, Q1 and Q3 must be served by the host
   engine (rows equal phase 4's host rows, compile mode
   ``async_pending``) while the background workers build and warm their
   pipelines on a CUDA stream of their own; after ``wait_idle`` the same
   queries must run on the card with equal rows, no new trace on the
   query's thread, compile mode ``bg``, their kernels launched and
   ``engine:tpu`` with ``compile_mode:bg`` in EXPLAIN ANALYZE; then
   ``ADMIN COMPILE``'s submitted / prewarmed / failed counts (none
   failed) and each ladder rung's bytes and ms;
5. ``[mpp]`` — the MPP engine (``tidb_executor_engine = 'tpu-mpp'``) on
   a local mesh of ``tidb_mpp_devices = 8`` logical shards on the card,
   on the same SF1 tables: one warm-up of Q1, Q6, Q3, Q5, Q9, Q18 and the
   orders ⋈ lineitem shuffle shape (tests/test_mpp_sql.py:175, grouped by
   the year of o_orderdate), with ``engine:tpu-mpp`` on the top HashAgg in
   EXPLAIN ANALYZE; then, every launch counter set to 0, each of them on
   the mesh (each must run a mesh fragment and launch its kernels — Q3
   and the shuffle shape kernel A, through the hash exchange), rows equal
   to phase 4's host rows (the shuffle shape's host rows run here once);
   Q3 again with no pipeline miss or build; bench_multichip.py phase 2's
   hot-key tables at 2^20 fact rows, which must converge through at
   least one exchange overflow retry with the host engine's rows; and
   K11's library steps at SF1 — ``dist_agg_step`` over lineitem by
   l_orderkey and ``dist_join_agg_step`` over orders ⋈ lineitem keys
   (1,500,000 × 6,001,215 rows, int64 and float64 values) against numpy.
   The largest fold of shard states those runs made (``[merge]``, as in
   phase 8) against its plain version.
   Kernel A against its plain version on Q3's and the shuffle's largest
   partition (exact), timed beside its bound and a stable ``torch.sort``
   of the bucket ids with the gathers; kernel B against its plain version
   on the int64 and float64 steps' largest shard (int64 exact, float64
   rtol 1e-9), timed beside its bound; K4 on the largest shard build
   side those runs sorted (one int64 key, invalid rows last) against its
   plain version and torch.sort(stable=True) of the packed key (exact),
   both timed.  One ``[mpp]`` line per run: the
   time, fragments, shuffles, exchange bytes, retries and launches; and
   Q3 once more under torch.profiler (device busy time, idle share, the
   kernels with the most device time);
6. ``[window]`` — on the same SF1 tables, the window shapes W1 (a share
   of the whole partition over aggregated groups), W2 (running ranks, sum
   and count over the raw rows, ~10,000 partitions), W3 (a rank over
   aggregated groups, filtered) and W4 (four huge partitions, a DESC
   decimal order key with peers, ranks, cume_dist, AVG, MIN, MAX and a
   DOUBLE sum), and a 1.5M-partition window: K10 against its plain
   version on each one's full captured inputs (W2, W4, 1.5M partitions;
   integers exact, floats rtol 1e-9 / atol 1e-12), each ``[K10]`` line
   with one call's launches and copies as the CUDA runtime's calls on
   the host count them (at most 3 launches, no copy), its device ms and
   device operations (null where the device trace missed launches) and
   host issue ms, its device time by kernel, its bound over the outputs
   it delivers beside the figure over the plain version's outputs (a
   NULL array a function) and a bound that writes each output row as random 32-byte
   sectors, torch's ``index_put_`` of rows shaped like its outputs
   through the window's order (the scatter alone), and the copy back's
   concatenation (``device_exec._fetch``'s device part) in K10's layout
   and in the plain version's; K4's window order on
   W2 against torch.sort(stable=True) of the packed key, K4's time, passes
   and bits per word on W2 and W4; then, every
   launch counter set to 0, W1-W4 on the device engine, each launching
   K2, K4 and K10, ``engine:tpu`` on every Window in EXPLAIN ANALYZE, W2's
   count, sum of row numbers and largest count equal to the generated
   partition sizes, the rows equal to the host engine's; ``[window]``
   lines with the device time, the K2 / K4 / K10 and device → host copy
   times and the host assembly;
6b. ``[server]`` — the port's MySQL server (``server.MySQLServer``) and
   status server in this process over the same domain and SF1 tables,
   and ``lineitem_p``: lineitem's rows bulk-installed partition by
   partition (``carry.install_bulk_numpy``), RANGE on YEAR(l_shipdate),
   one partition a year 1992-1998 and one MAXVALUE.  A protocol-41
   client on the port's ``server/packet.py`` (``WireClient``) sets
   ``tidb_executor_engine = 'tpu'``; EXPLAIN ANALYZE of Q1 and Q3 over
   the wire must show ``engine:tpu``; then, every launch counter set to
   0, Q1, Q3, Q18 and W2 in the text protocol and Q1 prepared with its
   ship-date bound a binary DATE parameter, each launching its kernels
   (K2 and K1; Q3 and Q18 also K4, K5a, K5b; W2 K2, K4, K10) with rows
   equal to phase 4's host rows (W2 to phase 6's device rows): every
   cell the same text but DOUBLE / FLOAT, decoded within rtol 1e-9 /
   atol 1e-12; two connections running Q1 and Q3 at once, three times
   each; Q1, Q6 and a Q6 pruned to ``p1994`` (EXPLAIN) over
   ``lineitem_p`` on ``engine:tpu`` with Q1's and Q6's rows; ``/status``
   over HTTP parses, with every key of the page, device-resident bytes
   above 0, ``device_hybrid_join`` and ``device_compiler``; last
   ``python -m tidb_tpu_torch.server`` in a process of its own on the
   card answers SELECT version() and a device aggregate over a table
   made with SQL there (``engine:tpu``), and exits 0 on SIGTERM.  One
   ``[server]`` line per query: ms over the wire, the same query's
   in-process ms (phase 4 or 6) and its launches;
6c. ``[fleet]`` — ``fabric.fleet.Fleet``: two ``python -m
   tidb_tpu_torch.fabric.worker`` processes on the card
   (``TIDB_TPU_TORCH_DEVICE=cuda``) and ``Fleet``'s default compile
   server (``python -m tidb_tpu_torch.fabric.compile_server``) over one
   durable log in a temporary run directory, each worker with
   ``tidb_device_mem_budget`` at 0.3 of the card's free memory, seeded
   by ``carry.fleet_seed`` (the SF1 tables from --seed and 7 in every
   worker; their schema, statistics and ``test.ledger`` written once
   through the log); each worker's boot time; over ``FleetClient`` to
   each worker's direct port, the result cache off, Q1, Q3 and Q18 twice
   with phase 4's host rows (``[server]``'s tolerance), ``engine:tpu``
   in EXPLAIN ANALYZE over the wire, wire ms beside ``[server]``'s; each
   worker's device-resident bytes as the segment holds them; Q1 on one
   worker then the other with the cache on (the outcome each got), then
   Q1 and the ledger's GROUP BY sent to both at once behind a barrier,
   three rounds (rows equal; the segment's dedup and cache counts);
   transfers on the ledger from both workers (each logged in
   ``test.transfers``, the sum read back every tenth) through a SIGKILL
   of one worker, its respawn and a drained shutdown: every acked
   transfer on both workers, nothing else but the one in doubt, every
   balance its transfers' sum, Q1 on the respawned worker on
   ``engine:tpu``; a cold fleet over the same log, the same checks and
   Q1 on both; BACKUP of ``test``, logical and physical, RESTORE under
   new names, the restored ledger's GROUP BY on ``engine:tpu`` on both
   workers equal to the original; each drained worker must have
   launched K2 and K1, the workers together K4, K5a and K5b (their drain
   summaries' ``launches``), and no worker may rebuild the kernel
   library or run nvcc (``kernel_build``); the drain summaries' log
   gauges, dedup counts and ``compile_persist_hits``; the compile
   server's ``stats`` after the serving round and the cold restart
   (fragment signatures recorded, dedups, library builds and hits; it
   must never initialise CUDA); at the run's very end, while it is under
   ``LIBRARY_BUILD_BEFORE_S``, one library build owned by a compile
   server process into a fresh artifact directory, timed, its bytes
   fetched against their sha256;
7. ``[paged-sf1]`` — the same SF1 ``lineitem`` and ``orders`` a second
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
8. ``[sf10]`` — ``carry.gen_tpch(10)`` into ``tpch10`` as bulk (RAM)
   tables with ANALYZE (``lineitem`` and ``orders`` sampled as a paged
   table is, ``SF10_SAMPLED``: the run's time cut); at the default ``tidb_device_stream_rows`` the
   reference's own gates stream the 60,012,150-row lineitem (scan
   aggregates) and page it (joins) in 15 pages of 4,194,304 rows.  The
   seven queries twice each (warm-up, then timed with the launch
   counters set to 0 before), each required to run streamed or paged;
   the partial-state merge against its plain version on Q1's and Q18's
   folds (integers exact, floats rtol 1e-9, n_groups exact, its fault
   word clear), timed beside its bound and beside run A's time of the
   parent's design (``RUN_A_MS``); each ``[merge]`` line
   with one call's launches and copies as the CUDA runtime's calls count
   them (more launches than ``merge_states.launch_plan`` fails the run),
   device ms (null where the device trace missed launches) and device
   time by kernel, and host issue ms;
   then each query twice on the resident whole-input path
   (``tidb_device_stream_rows = -1``), whose rows the streamed rows must
   equal exactly (a query the resident path cannot run is compared with
   the host engine instead), and Q6 and Q3 against the host engine.  One
   ``[stream]`` line per streamed or paged run: pages, bytes host →
   device, the copies' device time, the host slicing, sync and merge
   times, and the H2D bound at the pinned rate this run measures (one
   256 MiB copy); last W2 over the SF10 lineitem on the device (bucket
   2^26), K10 against its plain version on its inputs, K4's order against
   torch.sort(stable=True) of the packed key (both timed), its count, sum
   of row numbers and largest count against the generated partition
   sizes;
9. ``[hybrid]`` — on the same ``tpch10`` tables, ``tidb_device_mem_budget``
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
10. ``[mpp-sf10]`` — Q1 and Q3 on the ``tpch10`` tables on the 8-shard
   mesh (Q3 through the hash exchange: orders' 15,000,000 rows), warm-up
   then timed, rows equal to ``[sf10]``'s resident rows, and Q3 under
   torch.profiler;
10b. ``[mpp-cards]`` — the MPP engine on a SPLIT mesh (one tensor a
   shard, shard i's on its own device), driven from this one process.
   With two or more cards, ``tidb_mpp_devices = 0`` gives one shard a
   card: ``[mpp]``'s queries (Q1, Q6, Q3, Q5, Q9, Q18, the shuffle, the
   hot key) and SF10 Q1 and Q3, each warmed, then timed with its rows
   equal to the host engine's (SF10: ``[sf10]``'s) and to the one-card
   8-shard mesh's, EXPLAIN ANALYZE's ``engine:tpu-mpp``, no retry on the
   timed run (nothing dropped), a warm Q3 with no build, and launches on
   every card (``ops/kernels/build.py CARD_LAUNCHES``); the bytes each
   card holds, the exchange's bytes between cards and its largest
   all_to_all timed alone, each card pair's peer access; then a session
   with the engine on the last card (``set_device``) runs Q1 and Q3 from
   a thread whose device is 0, every launch on that card.  With one card:
   a split mesh of 4 shards, all on cuda:0, over SF1 Q1, Q3 and the
   shuffle with the same checks, and a line that says copies between
   cards and launches on a second card were not exercised.  ``python3
   chip_smoke.py --mpp-cards`` runs the phase alone after the tables and
   rows it is held to (a run on several cards);
10c. ``[faults]`` — the device-failure path on the card, every case's
   rows held to the host engine's.  First, once this process has given
   back what it caches on the card, each in a child process
   (``--fault-child``, killed after ``FAULT_CHILD_S``) on
   ``carry.gen_tpch(FAULT_CHILD_SF)``: (3) a hang — a sleep far longer
   than the phase, Q1 under a 1 s deadline must fail 9008, and the next
   two statements must each return the host engine's rows within the
   fence's bound plus ``HANG_SLACK_S`` with the device reported lost;
   (4) a sticky error — a device-side assert (an out-of-range index),
   then Q1, Q3 and ``left_on`` each return the host engine's rows, the
   device is reported lost (the first wrapper or sync that raised is in
   the reason) and ``build.CARD_LAUNCHES`` does not move after the
   loss.  Then in this process, on the SF1 tables: (1) a real
   out-of-memory — a ballast (``fill_card``: the card's free memory
   and the caching allocator's unused blocks) leaves about
   ``OOM_LEFT_FREE`` bytes to allocate, Q1 and Q3 (each traced) must
   walk the OOM ladder and degrade with ``host_degraded`` reason
   ``device``, then with the ballast freed Q1 runs on ``engine:tpu``
   again; (2) KILL during a call on the card — ``torch.cuda._sleep``
   keeps the engine's stream busy ``KILL_SLEEP_S``, Q1 starts under
   ``tidb_device_call_timeout`` and a second session's ``KILL QUERY``
   after ``KILL_AFTER_S`` must give 1317 with one supervisor kill and no
   hang or fence, then Q1 on the card.  Each case prints one line,
   ``[faults] case ... ok: ...``.  ``python3 chip_smoke.py --faults``
   runs the build and this phase alone;
10d. ``[lint]`` launchers — every C function counted in
   ``build.CARD_LAUNCHES`` in this process over the whole run (the
   phases clear it; ``_LaunchTally`` keeps the names; ``[mpp-cards]``'s
   timing of the guard itself leaves no count) must be one the lint
   found declared, and every declared one must have been launched (each
   is held against its plain version by some phase); a line lists the
   declared ones the run never launched;
11. report — the card's name and power limit, a ``kernels`` JSON line
   (``launches_server`` and ``launches_fleet`` beside each row's main-path
   ``launches``; ``cards`` and ``[mpp-cards]``'s ``launches_by_card``),
   and as the last line ``{"ok": true, "device": {...}}``.

Without a CUDA card, or without the ``tidb_tpu_torch`` package beside it,
the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import collections
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
#: the SF10 tables ANALYZE samples (as a paged table's) rather than
#: reads whole: unsampled, the eight tables took 157 s of the run
SF10_SAMPLED = ("lineitem", "orders")
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

#: joins with no aggregate over them: the executor's HashJoin matches its
#: keys through the standalone join match (K7), on lineitem's duplicate
#: keys and on customer's unique ones
JOIN_NO_AGG = """
select o_orderkey, o_orderdate, l_extendedprice, l_discount
from orders, lineitem
where o_orderkey = l_orderkey and o_orderdate = '1995-03-15'
order by o_orderkey, l_extendedprice, l_discount"""

JOIN_NO_AGG_UNIQ = """
select /*+ HASH_JOIN(orders, customer) */ o_orderkey, o_orderdate, c_name,
       c_nationkey
from orders, customer
where o_custkey = c_custkey and o_orderdate = '1995-03-15'
order by o_orderkey"""

#: a LEFT JOIN whose ON clause holds a residual over both sides: the
#: fragment probes customer's unique keys, and the residual's K2 launch
#: folds it into the match and, in its epilogue, turns the match into the
#: valid and no-match rows of every order (K5a's finish)
LEFT_ON = """
select c_mktsegment, count(*) as n, count(c_custkey) as matched,
       sum(o_totalprice) as total
from orders left join customer
  on o_custkey = c_custkey and o_totalprice > c_nationkey * 10000
group by c_mktsegment order by c_mktsegment"""

QUERIES = (("q1", Q1), ("q6", Q6), ("topn", TOPN), ("q3", Q3), ("q5", Q5),
           ("q9", Q9), ("q18", Q18), ("join_no_agg", JOIN_NO_AGG),
           ("join_no_agg_uniq", JOIN_NO_AGG_UNIQ), ("left_on", LEFT_ON))
#: the joins whose rows K7 matches, with no fragment over them
MATCH_QUERIES = ("join_no_agg", "join_no_agg_uniq")
JOIN_FRAGMENTS = ("q3", "q5", "q9", "q18", "left_on")

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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""


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

def ptxas_entries(text):
    """[(entry function, stack frame bytes, registers)] of one source's
    ``ptxas -v`` report (build.py compiles with ``-Xptxas -v``)."""
    import re
    out, fn, stack = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, stack = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and fn:
            stack = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, stack, int(m.group(1))))
            fn = None
    return out


#: the lint rules of the device side, run at the start of the run
LINT_RULES = ("launch-confinement", "device-slot-confinement",
              "supervised-confinement", "run-device-shape",
              "pipeline-host-sync")


class _LaunchTally(collections.Counter):
    """``build.CARD_LAUNCHES`` for the whole run: a Counter whose
    ``clear`` (the phases zero it before each measured run) keeps the
    C functions counted so far."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def clear(self):
        self.seen.update(f for f, _card in self)
        super().clear()

    def names(self) -> set:
        return self.seen | {f for f, _card in self}


def lint_start():
    """[lint], first half: the port's lint over this checkout with
    LINT_RULES in a child process, its report read by a thread, so the
    kernels build meanwhile.  Returns what :func:`lint_finish` takes."""
    import threading
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.lint", "--json", "--rules",
         ",".join(LINT_RULES)], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    box = {}

    def read_report():
        try:
            box["out"], box["err"] = proc.communicate(timeout=600)
        finally:
            box["s"] = time.perf_counter() - t0
    reader = threading.Thread(target=read_report, daemon=True)
    reader.start()
    return proc, reader, box


def kernel_launchers() -> tuple:
    """The lint's view of the launchers declared in ops/kernels/
    (``declared_launchers`` over those files alone: launch-confinement
    fails a declare anywhere else)."""
    import ast
    from tidb_tpu_torch.lint.engine import Context, SourceFile
    from tidb_tpu_torch.lint.rules.confinement import declared_launchers
    kdir = os.path.join(HERE, "tidb_tpu_torch", "ops", "kernels")
    files = []
    for name in sorted(os.listdir(kdir)):
        if name.endswith(".py"):
            path = os.path.join(kdir, name)
            with open(path) as f:
                text = f.read()
            files.append(SourceFile("ops/kernels/" + name, path, text,
                                    ast.parse(text, filename=path)))
    return declared_launchers(Context(files, HERE))


def lint_finish(proc, reader, box) -> dict:
    """[lint], second half: wait for the report (stopping the child if it
    is still running) and fail on a finding, a stale allowlist entry or
    a non-zero exit.  Returns {C function: "file:line"} of the launchers
    declared in ops/kernels/."""
    reader.join(620)
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    out, err = box.get("out", ""), box.get("err", "")
    try:
        rep = json.loads(out)
    except ValueError:
        fail(f"[lint] exit {proc.returncode} with no JSON report: "
             f"{(out + err)[-2000:]}")
    declared, unread = kernel_launchers()
    c = rep["counts"]
    log(f"[card] {card_line()}")
    log(f"[lint] rules {','.join(rep['rules'])}: findings {c['findings']}, "
        f"allowlisted {c['allowlisted']}, stale {c['stale_allowlist']}, "
        f"{box['s']:.2f}s (exit {proc.returncode}); C functions declared in "
        f"ops/kernels/: {len(declared)}")
    for f in rep["findings"]:
        log(f"[lint] {f['file']}:{f['line']}: [{f['rule']}] {f['msg']}")
    if proc.returncode != 0 or not rep["ok"]:
        fail(f"[lint] the device-side rules are not clean (exit "
             f"{proc.returncode}, {c['findings']} findings, "
             f"{c['stale_allowlist']} stale entries)")
    if unread or not declared:
        fail(f"[lint] launchers the lint cannot name: {unread}")
    return declared


def check_launchers(declared: dict):
    """[lint]: the C functions launched in this process are the ones
    declared: a launch of an undeclared one, or a declared one that no
    phase launched (a kernel held against nothing), fails the run."""
    from tidb_tpu_torch.ops.kernels import build
    launched = build.CARD_LAUNCHES.names()
    unknown = sorted(launched - set(declared))
    never = sorted(set(declared) - launched)
    log(f"[lint] C functions launched in this run: {len(launched)}, every "
        f"one declared: {not unknown}")
    log(f"[lint] declared, never launched in this process: "
        f"{', '.join(never) or 'none'}")
    if unknown:
        fail(f"[lint] launched C functions the lint found no declare of: "
             f"{unknown}")
    if never:
        fail(f"[lint] declared C functions no phase launched: "
             f"{[f'{n} ({declared[n]})' for n in never]}")


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
        if not os.path.exists(logp):
            continue
        with open(logp) as f:
            text = f.read()
        for fn, stack, regs in ptxas_entries(text):
            log(f"[build] {name}: {fn}: {stack} bytes stack frame, "
                f"{regs} registers")
            # K2's register file lives in shared memory, none in local
            if name == "expr_vm" and stack:
                fail(f"K2 entry {fn} has a {stack}-byte stack frame")
        for line in text.splitlines():
            if "spill" in line and "0 bytes spill stores, 0 bytes spill" \
                    not in line:
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
            # [K7]'s duplicate dense layout: partsupp ⋈ lineitem on partkey
            "ps_partkey": tables["partsupp"][0]["ps_partkey"],
            "l_partkey": tables["lineitem"][0]["l_partkey"],
            # the [mpp] phase's K11 steps: orders ⋈ lineitem values
            "l_quantity": tables["lineitem"][0]["l_quantity"],
            "o_totalprice": tables["orders"][0]["o_totalprice"],
            # W2's partition sizes, for its check
            "supp_counts": np.bincount(tables["lineitem"][0]["l_suppkey"]),
            # the [server] phase's lineitem_p
            "lineitem": tables["lineitem"]}
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
        if name in MATCH_QUERIES:
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


def vm_plan_text(prog):
    """How the VM runs `prog`: rows per thread and shared bytes a block."""
    from tidb_tpu_torch.ops.kernels import expr_vm
    rpt, stage, shared = expr_vm.launch_plan(
        prog.n_regs, len(prog.instrs), len(prog.ci), len(prog.cf))
    staged = {expr_vm.STAGE_NONE: "nothing", expr_vm.STAGE_PROG: "the stream",
              expr_vm.STAGE_ALL: "the stream and the constants"}[stage]
    return (f"{rpt} rows a thread, {shared} shared bytes a block ({staged} "
            f"staged)")


def k1_mode_text(c, keys, vals):
    """Where K1's buckets live for one call (the accumulate's mode)."""
    from tidb_tpu_torch.ops.kernels import groupby_agg as gb
    stride = gb.slot_layout(tuple(c["agg_ops"]))[0]
    pack = c["pack"]
    bits = sum(b for b, _o in pack) if pack is not None else None
    hashed = bits is None or bits > gb.BUCKET_BITS
    S = (1 << bits) if not hashed else None
    mode, smem = gb.accumulate_mode(S or 0, stride, hashed)
    name = {gb.MODE_WARP: "a copy per warp", gb.MODE_BLOCK: "one per block",
            gb.MODE_GLOBAL: "the workspace"}[mode]
    return f"slots of {stride} words, buckets in {name} ({smem} shared bytes)"


#: the wide K2 case's register count (the VM's limit is 64)
WIDE_REGS = 64


def wide_program(n_regs):
    """A program of `n_regs` registers: the right-nested product of
    distinct terms of input slot 0 (slot 0 * (i + 2) + i), which keeps
    one value per term live until the innermost product."""
    from tidb_tpu_torch.ops.kernels import expr_vm as ev
    a = ev.load(0, "i")
    for depth in range(1, 2 * n_regs + 2):
        terms = [ev.arith("add", ev.mulk(a, i + 2), ev.const(i, "i"))
                 for i in range(depth + 1)]
        e = terms[-1]
        for t in reversed(terms[:-1]):
            e = ev.arith("mul", t, e)
        prog = ev.Program.build([], [], [(e, "raw")])
        if prog.n_regs == n_regs:
            return prog
    fail(f"no chain takes {n_regs} registers")


def vm_wide(c, dev):
    """K2 on a program of WIDE_REGS registers over one int64 column of
    Q1's rows against its interpreter (exact), timed beside its bound."""
    import torch
    from tidb_tpu_torch.ops.kernels import expr_vm
    prog = wide_program(WIDE_REGS)
    col = next(inp[:2] for inp in c["inputs"]
               if inp[0].dtype == torch.int64)
    n, n_live = c["n"], c["n_live"]

    def run_k():
        return expr_vm.run(prog, [col], n, n_live, dev)

    def run_p():
        return expr_vm.interpret(prog, [col], n, n_live, dev)
    out_k = run_k()
    compare_vm(out_k, run_p(), "wide program")
    ms, plain_ms = cuda_ms(run_k), cuda_ms(run_p)
    bound = (nbytes(list(col)) + nbytes([out_k[0]] + list(out_k[1][0]))) \
        / HBM_BYTES_PER_S * 1e3
    split = call_split(run_k)
    log(f"[K2] wide program: {len(prog.instrs)} instructions, "
        f"{prog.n_regs} registers, n={n}: exact; {ms:.3f} ms (plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms); {split_text(split)}; "
        f"{vm_plan_text(prog)}")
    return dict(ms_wide=ms, plain_ms_wide=plain_ms, bound_ms_wide=bound)


#: K1's mid-size slot spaces: Q1's aggregates (slots of 20 words) over
#: 2^7, 2^8 and 2^9 uniform groups, 20, 40 and 80 KB a copy — past a copy
#: per warp, within one copy per block
MID_GROUP_BITS = (7, 8, 9)


def k1_mid_groups(c, dev, rng):
    """K1 on Q1's values and aggregates under a uniform key of each of
    MID_GROUP_BITS, held to its plain version, timed in the mode
    accumulate_mode picks and with the buckets forced into the workspace
    (global atomics)."""
    import contextlib
    from unittest import mock

    import torch
    from tidb_tpu_torch.ops.kernels import groupby_agg as gb
    mask, outs = c["vm_out"]
    prog, ops = c["prog"], c["agg_ops"]
    vals = tuple(outs[s][0] for s in prog.val_slots)
    vnulls = tuple(outs[s][1] for s in prog.val_slots)
    n = mask.shape[0]
    stride = gb.slot_layout(tuple(ops))[0]
    names = {gb.MODE_WARP: "a copy per warp", gb.MODE_BLOCK: "one copy per "
             "block", gb.MODE_GLOBAL: "the workspace"}
    row = {}
    for bits in MID_GROUP_BITS:
        S = 1 << bits
        key = torch.from_numpy(rng.integers(0, S, n)).to(dev)
        argv = ((key,), (torch.zeros_like(mask),), vals, vnulls, mask, 1,
                ops, S, ((bits, -1),))
        want = gb.groupby_plain(*argv)
        mode = gb.accumulate_mode(S, stride, False)[0]
        times, err = {}, 0.0
        for forced in (None, gb.MODE_GLOBAL):
            ctx = (mock.patch.object(gb, "accumulate_mode",
                                     lambda *_a, f=forced: (f, 0))
                   if forced is not None else contextlib.nullcontext())
            with ctx:
                got = gb.groupby_agg(*argv)
                torch.cuda.synchronize()
                err = max(err, compare_agg(got, want, ops, S,
                                           f"{S} uniform groups"))
                times[forced] = cuda_ms(lambda: gb.groupby_agg(*argv))
        log(f"[K1] q1's aggregates over {S} uniform groups ({S * stride * 8}"
            f" bytes of slots): max abs err {err:.3g}; {names[mode]} "
            f"{times[None]:.3f} ms, the workspace forced "
            f"{times[gb.MODE_GLOBAL]:.3f} ms")
        row[f"ms_mid_{S}"] = times[None]
        row[f"ms_mid_{S}_workspace"] = times[gb.MODE_GLOBAL]
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
    return row


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
        split = call_split(run_k)
        log(f"[K2] {name}: {len(launched.instrs)} instructions, "
            f"{launched.n_regs} registers, reads {len(read) // 2} of "
            f"{len(inputs)} input columns, hands on {len(handed)}, "
            f"n={n}: exact; {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
            f"{bound:.4f} ms); {split_text(split)}; {vm_plan_text(launched)}")
        c["vm_out"] = out_k
        if name == "q1":
            vm_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, device_ms=split[0],
                          device_ops_per_call=split[1], host_ms=split[2])
        else:
            vm_row[f"ms_{name}"] = ms
    vm_row.update(vm_wide(captured["q1"], dev))
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
        split = call_split(lambda: groupby_agg.groupby_agg(*argv))
        log(f"[K1] {name}: n={c['n']}, {len(c['agg_ops'])} aggregates, "
            f"capacity {cap}, pack {c['pack']}, n_groups {int(out_k[4])}: "
            f"max abs err {err:.3g}; {ms:.3f} ms (plain {plain_ms:.3f} ms, "
            f"bound {bound:.4f} ms); {split_text(split)}; "
            f"{k1_mode_text(c, keys, vals)}")
        if name == "q1":
            k1_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, device_ms=split[0],
                          device_ops_per_call=split[1], host_ms=split[2])
            # the hot group: Q1's rows with every key 0, one group, so
            # each warp's 32 lanes fall in one bucket
            hot = tuple(torch.zeros_like(k) for k in keys)
            hot_nulls = tuple(torch.zeros_like(k) for k in knulls)
            hargv = (hot, hot_nulls) + argv[2:]
            out_k = groupby_agg.groupby_agg(*hargv)
            out_p = groupby_agg.groupby_plain(*hargv)
            torch.cuda.synchronize()
            herr = compare_agg(out_k, out_p, c["agg_ops"], cap, "hot group")
            if int(out_k[4]) != 1:
                fail(f"K1 hot group: {int(out_k[4])} groups, not 1")
            hms = cuda_ms(lambda: groupby_agg.groupby_agg(*hargv))
            hplain = cuda_ms(lambda: groupby_agg.groupby_plain(*hargv))
            log(f"[K1] q1 with every key 0 (one hot group): max abs err "
                f"{herr:.3g}; {hms:.3f} ms (plain {hplain:.3f} ms)")
            k1_row.update(max_abs_err=max(err, herr), ms_hot=hms,
                          plain_ms_hot=hplain)
        else:
            k1_row[f"ms_{name}"] = ms

    # -- K1 on seeded cases covering the contract -----------------------------
    mid = k1_mid_groups(captured["q1"], dev,
                        np.random.default_rng(args.seed + 1))
    rng = np.random.default_rng(args.seed)
    mid["max_abs_err"] = max(mid["max_abs_err"], k1_row["max_abs_err"])
    k1_row.update(mid)
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
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms; "
        f"{k4_passes(spec, cap, ng, 'topk', report)})")
    # one key: torch.sort computes the same order
    one = ([key1], [up(np.zeros(cap, dtype=bool))], [True], [False])
    got = sort_topk.sort_indices(*one, cap, cap, k)
    ref = torch.sort(key1, descending=True, stable=True)[1][:k]
    full_one = sort_topk._sort_cuda(*one, cap, cap)
    if not torch.equal(got, ref) or not torch.equal(
            full_one, torch.sort(key1, descending=True, stable=True)[1]):
        fail("K4: single-key order differs from torch.sort")
    one_ms = cuda_ms(lambda: sort_topk.sort_indices(*one, cap, cap, k))
    lib_ms = cuda_ms(lambda: torch.sort(key1, descending=True,
                                        stable=True)[1][:k])
    log(f"[K4] single float key desc, cap={cap}: equal to "
        f"torch.sort(stable=True); {one_ms:.3f} ms (torch.sort "
        f"{lib_ms:.3f} ms; {k4_passes(one, cap, cap, 'one_key', report)})")
    report["sort_topk"].update(dict(max_abs_err=0.0, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound,
                                    ms_one_key=one_ms,
                                    library_ms_one_key=lib_ms))


def k4_split(spec, n, ng, call_ms, report):
    """Where one K4 call's time goes (W2's order): the device time of its
    kernels (the statistics, the packing with its histograms, the plans,
    the onesweep passes) and the copies, from torch.profiler (the mean of
    10 calls); the rest of the call's `call_ms` (CUDA events) is the
    host's part: the one device-to-host read of the statistics, the
    layout and the launches."""
    from tidb_tpu_torch.ops.kernels import sort_topk
    cols, nulls, descs, nfs = spec
    parts = {k: v[0] for k, v in device_profile(
        lambda: sort_topk._sort_cuda(cols, nulls, descs, nfs, n,
                                     ng)).items()}
    dev_ms = sum(parts.values())
    names = ", ".join(f"{k.split('(')[0]} {v:.3f} ms"
                      for k, v in sorted(parts.items(), key=lambda t: -t[1]))
    log(f"[K4] w2 order by kernel: {names}; device {dev_ms:.3f} ms of the "
        f"call's {call_ms:.3f} ms, the host's statistics read, layout and "
        f"launches {call_ms - dev_ms:.3f} ms")
    report["sort_topk"].update(window_order_device_ms=dev_ms,
                               window_order_host_ms=call_ms - dev_ms)


def k4_passes(spec, n, ng, shape, report):
    """K4's layout at one shape: the onesweep passes it ran (digit passes
    whose 8-bit digit had one value are skipped on the device) and the
    bits of each 64-bit word of the composite key; kept in the report's
    K4 row under ``passes`` / ``bits_per_word``."""
    from tidb_tpu_torch.ops.kernels import sort_topk
    cols, nulls, descs, nfs = spec
    info = {}
    sort_topk._sort_cuda(cols, nulls, descs, nfs, n, ng, info=info)
    row = report["sort_topk"]
    row.setdefault("passes", {})[shape] = info["passes"]
    row.setdefault("bits_per_word", {})[shape] = list(info["word_bits"])
    return (f"{info['passes']} of {info['digit_passes']} 8-bit digit "
            f"passes, bits per word {list(info['word_bits'])}")


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
    argv, kw = probe_args(ev), probe_kw(ev)

    def run_k():
        return join_probe.probe(*argv, **kw)

    def run_p():
        return join_probe.probe_plain(*argv, kw["layout"], kw["mode"],
                                      kw["kind"], kw["bvalid"], kw["order"],
                                      kw["dense_span"])
    out_k, out_p = run_k(), run_p()
    torch.cuda.synchronize()
    same_outputs(out_k, out_p, what)
    return cuda_ms(run_k), cuda_ms(run_p), probe_bound_ms(ev, out_k)


def probe_args(ev):
    """A captured K5a call's positional arguments."""
    return (ev["keys"], ev["knulls"], ev["pvalid"], ev["packs"], ev["a0"],
            ev["a1"], ev["nv"])


def probe_kw(ev):
    return dict(layout=ev["layout"], mode=ev["mode"], kind=ev["kind"],
                bvalid=ev["bvalid"], order=ev.get("order"),
                dense_span=ev["dense_span"])


#: the sorted probe's shared-memory samples timed at Q9's and the mesh's
#: shapes (join_probe.SAMPLE is the default)
PROBE_SAMPLES = (512, 1024, 2048, 4096)


def probe_samples(ev, what):
    """K5a's sorted probe of a captured call at each sample size of
    PROBE_SAMPLES, exact against the plain version each time; one line
    each."""
    import torch
    from tidb_tpu_torch.ops.kernels import join_probe
    argv, kw = probe_args(ev), probe_kw(ev)
    want = join_probe.probe_plain(*argv, kw["layout"], kw["mode"],
                                  kw["kind"], kw["bvalid"], kw["order"],
                                  kw["dense_span"])
    nv = int(ev["nv"])
    default = join_probe.SAMPLE

    def run():
        return join_probe.probe(*argv, **kw)
    try:
        for sample in PROBE_SAMPLES:
            join_probe.SAMPLE = sample
            got = run()
            torch.cuda.synchronize()
            same_outputs(got, want, f"K5a {what} sample {sample}")
            stride, entries = join_probe.sample_stride(nv, sample)
            log(f"[K5a] {what} sample {sample} ({8 * sample} B of shared "
                f"memory a block; stride {stride}, {entries} entries"
                f"{', the default' if sample == default else ''}): exact; "
                f"{cuda_ms(run):.3f} ms; {split_text(call_split(run))}")
    finally:
        join_probe.SAMPLE = default


def join_finish(joins, report):
    """K5a's finish as the epilogue of the ON residual's K2 launch (the
    ``left_on`` warm-up's program and inputs), against the interpreter and
    ``finish_plain`` for every join kind, with and without a validity
    mask (exact), timed for the main path's kind beside the same launch
    without the epilogue and beside its bound."""
    import torch
    from tidb_tpu_torch.executor.device_join import _VALID
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops.kernels import expr_vm, join_probe
    dev = pdev.device()
    evs = [ev for k, ev in sorted(joins["left_on"].items(),
                                  key=lambda kv: str(kv[0]))
           if k[0] == "vm" and ev.get("finish") is not None]
    if not evs:
        fail("K5a finish: left_on's ON residual ran no finish epilogue")
    ev = evs[0]
    prog, inputs, n = ev["prog"], ev["inputs"], ev["n"]
    pv, kind = ev["finish"]
    for k in join_probe.KINDS:
        for v in (pv, None):
            what = f"K5a finish {k}{'' if v is pv else ' no pvalid'}"
            got = expr_vm.run(prog, inputs, n, n, dev, finish=(v, k))
            want = expr_vm.interpret(prog, inputs, n, n, dev,
                                     finish=(v, k))
            torch.cuda.synchronize()
            compare_vm(got[:2], want[:2], what)
            same_outputs(list(got[2]), list(want[2]), what)

    def fin_k():
        return expr_vm.run(prog, inputs, n, n, dev, finish=(pv, kind))

    def vm_k():
        return expr_vm.run(prog, inputs, n, n, dev)

    def fin_p():
        return expr_vm.interpret(prog, inputs, n, n, dev,
                                 finish=(pv, kind))

    ms, vm_ms, plain_ms = cuda_ms(fin_k), cuda_ms(vm_k), cuda_ms(fin_p)
    mask, outs, (valid, nohit, n_valid) = fin_k()
    # the residual's own bound (its inputs read once, one sector a row
    # with a match for each column read through the build's row index,
    # the mask written once), and the finish's bytes on top: the validity
    # read once, the valid and no-match flags and the count written once
    hit_rows = int(inputs[prog.in_cols.index(_VALID)][0].sum())
    vm_bound = vm_bound_ms(prog, inputs, (mask, outs), hit_rows)
    fin_bound = (nbytes([t for t in (pv,) if t is not None])
                 + nbytes([valid, nohit, n_valid])) / HBM_BYTES_PER_S * 1e3
    # the host's issue time of the two in turns (with, without, without,
    # with); device ms and operations where the device trace kept the
    # calls (else not measured)
    host = {fin_k: [], vm_k: []}
    for fn in (fin_k, vm_k, vm_k, fin_k):
        host[fn].append(host_issue_ms(fn))
    split, vm_split = [], []
    for fn, sp in ((fin_k, split), (vm_k, vm_split)):
        got = device_profile(fn)
        ops = sum(v[1] for v in got.values())
        sp += [sum(v[0] for v in got.values()) if ops else None,
               ops or None, statistics.mean(host[fn])]
    log(f"[K5a] left_on finish ({kind}) in the ON residual's K2 launch: "
        f"n={n}, {int(n_valid)} valid, {int(nohit.sum())} with no match: "
        f"exact for each of {len(join_probe.KINDS)} join kinds, with and "
        f"without validity; {ms:.3f} ms with the epilogue, {vm_ms:.3f} ms "
        f"the same launch without it (plain {plain_ms:.3f} ms, bound "
        f"{vm_bound + fin_bound:.4f} ms, of it the finish's bytes "
        f"{fin_bound:.4f}); with {split_text(split)}; without "
        f"{split_text(vm_split)}")
    report["join_finish"].update(dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=vm_bound + fin_bound, device_ms=split[0],
        device_ops_per_call=split[1], host_ms=split[2], ms_vm_alone=vm_ms,
        device_ms_vm_alone=vm_split[0], host_ms_vm_alone=vm_split[2]))


#: ``[K7]``'s layouts, each with the path K7's summary must pick
K7_LAYOUTS = (("unique dense", "uniq"), ("duplicate dense", "rank"),
              ("sparse", "sorted"), ("nulls", "uniq"), ("hot key", "sorted"))
#: the sparse layout's key spread: orders' keys times this pass any dense
#: span
K7_SPREAD = 1_000_003


def k7_inputs(name, keys, rng):
    """(bk, bn, pk, pn) numpy arrays of one ``[K7]`` layout: the build's
    keys and NULL flags, the probe's keys and NULL flags."""
    import numpy as np
    ok, lk = keys["o_orderkey"], keys["l_orderkey"]
    if name == "duplicate dense":
        bk, pk = keys["ps_partkey"], keys["l_partkey"]
    elif name == "sparse":
        bk, pk = ok * K7_SPREAD, lk * K7_SPREAD
    elif name == "hot key":
        # lineitem's keys with a tenth of the rows under one order's key,
        # probed by every order
        bk = lk.copy()
        bk[rng.random(len(lk)) < 0.1] = ok[0]
        pk = ok
    else:
        bk, pk = ok, lk
    bn, pn = np.zeros(len(bk), bool), np.zeros(len(pk), bool)
    if name == "nulls":
        bn, pn = rng.random(len(bk)) < 0.1, rng.random(len(pk)) < 0.1
    return bk, bn, pk, pn


def k7_parent_route(bk, bn, pk, pv, nv):
    """The parent's K7 on the card, from the kernels it launched (K4's
    valid-first order of the build, K5a's sorted count, the total's read,
    K5b's expansion with its keep mask), without the copy back and the
    numpy filter that followed.  Returns (pi, bi, keep)."""
    from tidb_tpu_torch.ops.kernels import join_expand, join_probe, sort_topk
    order = sort_topk.valid_first_order(bk, bn)
    pr = join_probe.probe([pk], [None], pv, None, bk, None, nv,
                          layout="sorted", mode="count", order=order)
    total = int(pr["count"])
    if total == 0:
        return None
    ex = join_expand.expand(pr["cnt"], pr["pos0"], None, order,
                            order.shape[0], None, total)
    return ex["pi"], ex["bi"], ex["valid"]


def k7_rank_limit(keys, rng):
    """``[K7] rank limit``: a build of orders' first keys, each under
    RANK_MAX rows (the dense rank's last count) in shuffled row order,
    probed by lineitem's keys, matched down the rank path and down the
    sorted path (RANK_MAX lowered by one for the call) on the same
    tensors, each exact against the plain version.  Returns the row."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops.kernels import join_match
    dev = pdev.device()
    r = join_match.RANK_MAX
    ok = keys["o_orderkey"]
    bk = rng.permutation(np.repeat(ok[:len(ok) // r], r))
    bk, pk = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (bk, keys["l_orderkey"]))
    bn = torch.zeros(bk.shape[0], dtype=torch.bool, device=dev)
    pv = torch.ones(pk.shape[0], dtype=torch.bool, device=dev)
    want = join_match.match_plain(bk, bn, pk, pv)
    row = dict(build=bk.shape[0], probe=pk.shape[0], pairs=want[0].shape[0],
               maxmult=r)
    for path, limit in (("rank", r), ("sorted", r - 1)):
        join_match.RANK_MAX = limit
        try:
            info = {}
            got = join_match.match(bk, bn, pk, pv, info=info)
            torch.cuda.synchronize()
            if info["path"] != path:
                fail(f"K7 rank limit: path {info['path']}, expected {path}")
            same_outputs(list(got), list(want), f"K7 rank limit {path}")

            def fn():
                return join_match.match(bk, bn, pk, pv)

            ms, split = cuda_ms(fn), call_split(fn)
        finally:
            join_match.RANK_MAX = r
        row.update({f"{path}_ms": ms, f"{path}_device_ms": split[0],
                    f"{path}_device_ops_per_call": split[1]})
    log(f"[K7] rank limit: build {row['build']} ({r} rows a key, shuffled), "
        f"probe {row['probe']}, {row['pairs']} pairs: exact down both "
        f"paths; rank {row['rank_ms']:.3f} ms (device "
        f"{row['rank_device_ms']:.3f} ms in "
        f"{row['rank_device_ops_per_call']:g} operations), sorted "
        f"{row['sorted_ms']:.3f} ms (device {row['sorted_device_ms']:.3f} ms "
        f"in {row['sorted_device_ops_per_call']:g} operations)")
    return row


def k7_alone(seed):
    """``--k7``: only ``[K7]``'s lines, on SF1-shaped keys made with
    numpy instead of the SQL tables (orders' 1,500,000 keys by TPC-H's
    rule, 1-7 lineitem rows an order, partsupp's 4 rows of each of
    200,000 parts, lineitem's parts uniform), for a quick reading of K7
    alone."""
    import numpy as np
    rng = np.random.default_rng(1)
    i = np.arange(1_500_000)
    ok = (i // 8) * 32 + i % 8 + 1
    lk = np.repeat(ok, rng.integers(1, 8, len(ok)))
    keys = {"o_orderkey": ok, "l_orderkey": lk,
            "ps_partkey": np.repeat(np.arange(1, 200_001), 4),
            "l_partkey": rng.integers(1, 200_001, len(lk))}
    k7_layouts(argparse.Namespace(seed=seed), keys, {"join_match": {}})


def k7_match_split(arrays):
    """One ``device_join_match`` call's host clock split: the four
    uploads, K7's kernels (the match, its reads included) and the copy
    back of the pairs, each up to a synchronise.  Returns (ms of each,
    the numpy pairs)."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops.kernels import join_match
    bk, bn, pk, pn = arrays
    d = pdev.device()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ins = (pdev.upload(np.asarray(bk, dtype=np.int64), d),
           pdev.upload(np.asarray(bn, dtype=bool), d),
           pdev.upload(np.asarray(pk, dtype=np.int64), d),
           pdev.upload(~np.asarray(pn, dtype=bool), d))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pi, bi = join_match.match(*ins)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = (pi.cpu().numpy(), bi.cpu().numpy())
    t3 = time.perf_counter()
    return tuple((b - a) * 1e3 for a, b in ((t0, t1), (t1, t2), (t2, t3))), out


def k7_layouts(args, keys, report):
    """``[K7]``: the standalone join match in each layout of K7_LAYOUTS,
    exact against its plain version on the same tensors (and its path the
    one the layout must take), with ms, device ms and operations, host
    issue ms, device-to-host reads a call, the bound (both sides' keys
    and flags read once and 16 bytes a pair written once: the index's own
    traffic is left out), plain ms, the parent's route on the same
    tensors (:func:`k7_parent_route`) and one ``device_join_match`` call
    split into upload, kernels and copy back; then the rank limit
    (:func:`k7_rank_limit`)."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops.kernels import join_match
    dev = pdev.device()
    rng = np.random.default_rng(args.seed)
    layouts = {}
    for name, path in K7_LAYOUTS:
        arrays = k7_inputs(name, keys, rng)
        bk, bn, pk, pn = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in arrays)
        pv = ~pn
        info = {}
        got = join_match.match(bk, bn, pk, pv, info=info)
        want = join_match.match_plain(bk, bn, pk, pv)
        torch.cuda.synchronize()
        if info["path"] != path:
            fail(f"K7 {name}: path {info['path']}, expected {path}")
        same_outputs(list(got), list(want), f"K7 {name}")
        total = got[0].shape[0]
        if not total:
            fail(f"K7 {name}: no pairs")

        def k_call(bk=bk, bn=bn, pk=pk, pv=pv):
            return join_match.match(bk, bn, pk, pv)

        def p_call(bk=bk, bn=bn, pk=pk, pv=pv):
            return join_match.match_plain(bk, bn, pk, pv)

        def parent_call(bk=bk, bn=bn, pk=pk, pv=pv, nv=info["nvalid"]):
            return k7_parent_route(bk, bn, pk, pv, nv)

        ppi, pbi, keep = parent_call()
        same_outputs([ppi[keep].long(), pbi[keep].long()],
                     [t.long() for t in got], f"K7 {name} parent's route")
        ms, plain_ms = cuda_ms(k_call), cuda_ms(p_call)
        parent_ms = cuda_ms(parent_call)
        runtime = {}
        split = call_split(k_call, runtime=runtime)
        parent_split = call_split(parent_call)
        reads = sum(c for k, c in runtime.items()
                    if k.startswith(RUNTIME_COPY))
        nb_, np_ = bk.shape[0], pk.shape[0]
        bound = ((nbytes([bk, bn, pk, pv]) + 16 * total)
                 / HBM_BYTES_PER_S * 1e3)
        parts, pairs = k7_match_split(arrays)
        ref = pdev.device_join_match((arrays[0], arrays[1]),
                                     (arrays[2], arrays[3]))
        for a, b, c in zip(pairs, ref, got):
            if not (np.array_equal(a, b) and np.array_equal(a, c.cpu())):
                fail(f"K7 {name}: device_join_match's pairs differ")
        row = dict(path=info["path"], build=nb_, probe=np_, pairs=total,
                   maxmult=info["maxmult"], ms=ms, plain_ms=plain_ms,
                   bound_ms=bound, device_ms=split[0],
                   device_ops_per_call=split[1], host_ms=split[2],
                   reads_per_call=reads, parent_ms=parent_ms,
                   parent_device_ms=parent_split[0],
                   parent_device_ops_per_call=parent_split[1],
                   upload_ms=parts[0], kernels_ms=parts[1],
                   copy_back_ms=parts[2])
        layouts[name] = row
        log(f"[K7] {name}: build {nb_} ({int(bn.sum())} NULL), probe "
            f"{np_} ({int(pn.sum())} NULL), {total} pairs, path "
            f"{info['path']} (largest count under one key "
            f"{info['maxmult']}, capped at RANK_MAX + 1): exact; {ms:.3f} ms on the card (plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms); {split_text(split)}"
            f"; {reads:g} device-to-host reads a call; the parent's route "
            f"{parent_ms:.3f} ms ({split_text(parent_split)}); "
            f"device_join_match upload {parts[0]:.3f} ms, kernels "
            f"{parts[1]:.3f} ms, copy back {parts[2]:.3f} ms")
    layouts["rank limit"] = k7_rank_limit(keys, rng)
    main = layouts["unique dense"]
    report["join_match"].update(dict(
        max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], device_ms=main["device_ms"],
        device_ops_per_call=main["device_ops_per_call"],
        host_ms=main["host_ms"], layouts=layouts))


def phase_join_kernels(args, joins, keys, report):
    import numpy as np
    import torch
    from tidb_tpu_torch.executor.join_index import build_join_index
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops.kernels import expr_vm, join_expand, join_probe
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
            what = f"K5a {name} J{ev['pos']} {ev['layout']}/{ev['mode']}"
            ms, plain_ms, bound = check_probe(ev, what)
            split = call_split(lambda ev=ev: join_probe.probe(
                *probe_args(ev), **probe_kw(ev)))
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
                report["join_probe"].update(
                    ms_sorted=ms, plain_ms_sorted=plain_ms,
                    bound_ms_sorted=bound, searchsorted_ms=lib_ms,
                    device_ms_sorted=split[0],
                    device_ops_per_call_sorted=split[1],
                    host_ms_sorted=split[2])
            log(f"[K5a] {name} J{ev['pos']}: {ev['layout']} {ev['mode']} "
                f"probe, {len(ev['keys'])} key column(s), n={n}, "
                f"n_valid={int(ev['nv'])}: exact; {ms:.3f} ms (plain "
                f"{plain_ms:.3f} ms, bound {bound:.4f} ms); "
                f"{split_text(split)}{extra}")
            if ev["layout"] == "sorted":
                probe_samples(ev, f"{name} J{ev['pos']}")
            if name == "q3" and (probe_row is None
                                 or ms > probe_row["ms"]):
                probe_row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound, device_ms=split[0],
                                 device_ops_per_call=split[1],
                                 host_ms=split[2])
    report["join_probe"].update(probe_row)

    join_finish(joins, report)

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
    split = call_split(vm_k)
    log(f"[K2] q3 post-join: {len(prog.instrs)} instructions, reads "
        f"{len(expr_vm.gathered_slots(inputs))} of {len(inputs)} inputs "
        f"through a row index, n={n}, {valid_rows} valid rows: exact; "
        f"{ms:.3f} ms (plain {plain_ms:.3f} ms, bound {bound:.4f} ms); "
        f"{split_text(split)}; {vm_plan_text(prog)}")
    report["expr_vm_loadg"].update(dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        device_ms=split[0], device_ops_per_call=split[1],
        host_ms=split[2]))

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
        split = call_split(ex_k)
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
                           bound_ms=bound, device_ms=split[0],
                           device_ops_per_call=split[1], host_ms=split[2],
                           repeat_interleave_ms=lib_ms)
        log(f"[K5b] {case}: {no} orders -> total {total} pairs, cap {cap}, "
            f"max_cnt {idx.max_cnt}: exact; {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms); {split_text(split)}"
            f"{extra}")
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
            f"{plain_ms:.3f} ms, bound {bound:.4f} ms); "
            f"{split_text(call_split(c_k))}")
        if cnt_row is None or mask.shape[0] > cnt_row["n"]:
            cnt_row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, library_ms=plain_ms,
                           n=mask.shape[0])
    del cnt_row["n"]
    report["join_expand_count"].update(cnt_row)

    k7_layouts(args, keys, report)


def phase_main_path(dom, s, n_rows, report):
    import torch
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops.kernels import (build, expr_vm, groupby_agg,
                                            join_expand, join_match,
                                            join_probe, sort_topk)
    # K5b's count and K7 are entries over the kernels' own counters: a
    # call of one counts once where the counters of the kernels it runs
    # moved (K5b's by one; K7's launcher); K5a's finish counts the K2
    # launches that carried its epilogue, and K7's stages their launches
    composite = {"join_expand_count": [0], "join_match": [0]}
    stages = {f"join_match_{k}": c
              for k, c in join_match.STAGE_LAUNCHES.items()}
    counters = {"expr_vm": expr_vm.LAUNCHES, "groupby_agg":
                groupby_agg.LAUNCHES, "sort_topk": sort_topk.LAUNCHES,
                "join_probe": join_probe.LAUNCHES,
                "join_expand": join_expand.LAUNCHES,
                "join_finish": expr_vm.FINISH_LAUNCHES, **composite,
                **stages}
    agg = ["expr_vm", "groupby_agg"]
    frag = agg + ["join_probe", "join_expand", "join_expand_count"]
    need = {"q1": agg, "q6": agg, "topn": agg + ["sort_topk"],
            "q3": frag + ["sort_topk"], "q5": frag, "q9": frag,
            "q18": frag + ["sort_topk"],
            "join_no_agg": ["join_match", "join_match_index",
                            "join_match_order", "join_probe",
                            "join_expand"],
            "join_no_agg_uniq": ["join_match", "join_match_index",
                                 "join_match_uniq"],
            "left_on": agg + ["join_probe", "join_expand_count",
                              "join_finish"]}
    count_fn, match_fn = join_expand.count, pdev.device_join_match

    def counted_count(mask):
        before = join_expand.LAUNCHES[0]
        out = count_fn(mask)
        if join_expand.LAUNCHES[0] == before + 1:
            composite["join_expand_count"][0] += 1
        return out

    def counted_match(build_keys, probe_keys):
        before = join_match.LAUNCHES[0]
        out = match_fn(build_keys, probe_keys)
        if join_match.LAUNCHES[0] > before:
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
    dev_res, dev_ms = {}, {}
    loadg = 0
    device_join.build_join_index = timed_build
    join_expand.count, pdev.device_join_match = counted_count, counted_match
    try:
        for name, sql in QUERIES:
            card0 = collections.Counter(
                {f: c for (f, _card), c in build.CARD_LAUNCHES.items()})
            dev_res[name] = run_counted(s, name, sql, counters, need,
                                        n_rows, index_builds)
            dev_ms[name] = dev_res[name][2]
            if name in JOIN_FRAGMENTS:
                loadg += dev_res[name][1]["expr_vm"]
            if name in ("left_on",) + MATCH_QUERIES:
                card1 = collections.Counter(
                    {f: c for (f, _card), c in build.CARD_LAUNCHES.items()})
                card1.subtract(card0)
                log(f"[main] {name}: C launcher calls "
                    f"{dict(sorted((f, c) for f, c in card1.items() if c))}")
    finally:
        device_join.build_join_index = build_index
        join_expand.count, pdev.device_join_match = count_fn, match_fn
    dev_res = {k: v[0] for k, v in dev_res.items()}
    log("[main] launch counts above; the timing below is not counted")
    for k, c in counters.items():
        if k in report:
            report[k]["launches"] = c[0]
    report["join_match"].update(
        {f"launches_{k}": c[0] for k, c in join_match.STAGE_LAUNCHES.items()})
    report["expr_vm_loadg"]["launches"] = loadg
    # the same query twice in a row: its join indexes stay cached on the
    # build tables' columns (one index per column, as in the reference),
    # where the mixed sequence above rebuilds them when the filters change
    for name in JOIN_FRAGMENTS + MATCH_QUERIES:
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
    return host_res, dev_ms


def run_counted(s, name, sql, counters, need, n_rows, index_builds):
    """One main-path query on the device engine: (result, launches,
    milliseconds)."""
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
    return res, moved, dt * 1e3


# -- the compile layer: async flip, ADMIN COMPILE, first launches ------------

#: the queries of ``[compile]``: a scan aggregate and a join fragment
COMPILE_QUERIES = ("q1", "q3")


def compile_modes(before, after):
    """The compile modes that moved on this thread between two
    ``pipe_cache_stats(thread_local=True)`` reads."""
    return {k[5:]: after[k] - before[k] for k in after
            if k.startswith("mode_") and after[k] != before[k]}


def phase_compile(s, host_res, card):
    """``[compile]`` — the compile layer on the SF1 session after
    ``[main]``: under ``tidb_compile_async = ON`` with the pipe cache
    dropped, Q1 and Q3 are served by the host engine (rows equal phase
    4's host rows, compile mode ``async_pending``) while the background
    workers build and warm their pipelines on a stream of their own;
    after ``wait_idle`` the same queries run on the card (rows equal, no
    new trace on the query's thread, compile mode ``bg``, their kernels
    launched, ``engine:tpu`` and ``compile_mode:bg`` in EXPLAIN
    ANALYZE); then ``ADMIN COMPILE`` warms the next two row buckets of
    each hot recipe, each rung's bytes and seconds logged (a rung past
    the free share of the device budget is skipped and counted).  The
    signature index is off for the phase, so the earlier phases' builds
    cannot make the cold obtains inline."""
    from tidb_tpu_torch.executor import compile_service as cs
    from tidb_tpu_torch.executor import device_exec
    from tidb_tpu_torch.ops.kernels import (expr_vm, groupby_agg,
                                            join_expand, join_probe)
    counters = {"expr_vm": expr_vm.LAUNCHES,
                "groupby_agg": groupby_agg.LAUNCHES,
                "join_probe": join_probe.LAUNCHES,
                "join_expand": join_expand.LAUNCHES}
    need = {"q1": ["expr_vm", "groupby_agg"],
            "q3": ["expr_vm", "groupby_agg", "join_probe", "join_expand"]}
    prev_index = os.environ.get("TIDB_TPU_COMPILE_INDEX")
    os.environ["TIDB_TPU_COMPILE_INDEX"] = "off"
    stats = device_exec.pipe_cache_stats
    engine = s.execute("select @@tidb_executor_engine")[-1].rows[0][0]
    s.execute("set @@tidb_executor_engine = 'tpu'")
    try:
        if not cs.wait_idle(60.0):
            fail("[compile] a background job of an earlier phase is stuck")
        with device_exec._PIPE_LOCK:
            dropped = len(device_exec._PIPE_CACHE)
            device_exec._PIPE_CACHE.clear()
        cs.reset_for_tests()
        log(f"[compile] card {card}; pipe cache dropped ({dropped} "
            "entries), signature index off, tidb_compile_async = ON")
        s.execute("set @@tidb_compile_async = 'ON'")
        snap0 = cs.snapshot()
        for name in COMPILE_QUERIES:
            sql = dict(QUERIES)[name]
            st0 = stats(thread_local=True)
            t0 = time.perf_counter()
            res = s.execute(sql)[-1]
            dt = (time.perf_counter() - t0) * 1e3
            st1 = stats(thread_local=True)
            modes = compile_modes(st0, st1)
            if not rows_equal(res, host_res[name]):
                fail(f"[compile] {name}: host-served rows differ from the "
                     "host engine's")
            if not modes.get("async_pending"):
                fail(f"[compile] {name}: compile mode {modes}, not "
                     "async_pending (the cold miss did not defer)")
            log(f"[compile] {name} cold under async: {dt:.3f} ms, served "
                f"by the host engine, rows equal; compile modes {modes}; "
                f"traces on this thread {st1['traces'] - st0['traces']}")
        t0 = time.perf_counter()
        if not cs.wait_idle(300.0):
            fail(f"[compile] background builds did not finish: "
                 f"{cs.snapshot()}")
        snap1 = cs.snapshot()
        log(f"[compile] wait_idle {(time.perf_counter() - t0) * 1e3:.3f} "
            f"ms; bg submitted +{snap1['bg_submitted'] - snap0['bg_submitted']}"
            f", completed +{snap1['bg_completed'] - snap0['bg_completed']}, "
            f"failed +{snap1['bg_failed'] - snap0['bg_failed']}, bg seconds "
            f"{snap1['compile_bg_seconds']}; warms "
            + "; ".join(f"{w['shape']} {w['bytes']} bytes "
                        f"{w['s'] * 1e3:.3f} ms" for w in cs.WARM_LOG))
        if snap1["bg_completed"] - snap0["bg_completed"] < len(
                COMPILE_QUERIES) or snap1["bg_failed"] != snap0["bg_failed"]:
            fail(f"[compile] background builds: {snap1}")
        for name in COMPILE_QUERIES:
            sql = dict(QUERIES)[name]
            before = {k: c[0] for k, c in counters.items()}
            st0 = stats(thread_local=True)
            t0 = time.perf_counter()
            res = s.execute(sql)[-1]
            dt = (time.perf_counter() - t0) * 1e3
            st1 = stats(thread_local=True)
            moved = {k: c[0] - before[k] for k, c in counters.items()}
            modes = compile_modes(st0, st1)
            traces = st1["traces"] - st0["traces"]
            if not rows_equal(res, host_res[name]):
                fail(f"[compile] {name} after the flip: rows differ")
            if traces:
                fail(f"[compile] {name} after the flip: {traces} new traces")
            if not modes.get("bg") or modes.get("async_pending"):
                fail(f"[compile] {name} after the flip: compile modes "
                     f"{modes}, not bg")
            for k in need[name]:
                if moved[k] <= 0:
                    fail(f"[compile] {name} after the flip: kernel {k} was "
                         "not launched")
            rows = s.execute("explain analyze " + sql)[-1].rows
            aggs = [" ".join(str(x) for x in r) for r in rows
                    if "HashAgg" in str(r[0])]
            if not (aggs and all("engine:tpu" in a for a in aggs)
                    and any("compile_mode:bg" in a for a in aggs)):
                fail(f"[compile] {name}: EXPLAIN ANALYZE after the flip "
                     f"does not show engine:tpu and compile_mode:bg: {aggs}")
            log(f"[compile] {name} after wait_idle: {dt:.3f} ms on "
                f"engine:tpu, rows equal, 0 new traces, compile modes "
                f"{modes}, launches {moved}; EXPLAIN ANALYZE engine:tpu, "
                "compile_mode:bg")
        s.execute("set @@tidb_compile_async = 'OFF'")
        n_log = len(cs.WARM_LOG)
        t0 = time.perf_counter()
        rep = s.execute("admin compile")[-1].rows
        dt = time.perf_counter() - t0
        rungs = list(cs.WARM_LOG)[n_log:]
        if not rep or int(rep[0][2]):
            fail(f"[compile] ADMIN COMPILE: {rep}")
        log(f"[compile] ADMIN COMPILE in {dt:.3f}s: submitted "
            f"{rep[0][0]}, prewarmed {rep[0][1]}, failed {rep[0][2]}; "
            f"warm totals {cs.WARM}")
        for w in rungs:
            log(f"[compile] rung {w['shape']} bucket {w['bucket']}: "
                f"{w['bytes']} bytes, {w['s'] * 1e3:.3f} ms"
                + (f", skipped (free share {w['free_share']} bytes)"
                   if w["skipped"] else ""))
        if not cs.verify_drained()["ok"]:
            fail(f"[compile] jobs leaked: {cs.verify_drained()}")
    finally:
        s.execute("set @@tidb_compile_async = 'OFF'")
        s.execute(f"set @@tidb_executor_engine = '{engine}'")
        if prev_index is None:
            os.environ.pop("TIDB_TPU_COMPILE_INDEX", None)
        else:
            os.environ["TIDB_TPU_COMPILE_INDEX"] = prev_index


def first_launch_calls(seed, dev):
    """One call of every kernel's wrapper on small seeded tensors on the
    card, in launch order: name -> a zero-argument call."""
    import numpy as np
    import torch
    from tidb_tpu_torch.executor.join_index import build_join_index
    from tidb_tpu_torch.ops.kernels import (expr_vm, groupby_agg,
                                            join_expand, join_match,
                                            join_probe, merge_states,
                                            radix_exchange, shuffle_join,
                                            sort_topk, window_scan)
    from tidb_tpu_torch.sqltypes import TYPE_LONGLONG, FieldType
    from tidb_tpu_torch.utils.chunk import Column
    rng = np.random.default_rng(seed)
    n, nb = 1 << 12, 1 << 10

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ki = up(rng.integers(0, 100, n))
    kf = up(rng.standard_normal(n).round(1))
    nul = up(rng.random(n) < 0.05)
    none = up(np.zeros(n, bool))
    mask = up(rng.random(n) < 0.9)
    prog = expr_vm.Program.build(
        [expr_vm.cmp("lt", expr_vm.load(1, "i"), expr_vm.const(7, "i"))],
        [expr_vm.load(0, "i")], [(expr_vm.load(2, "f"), "raw")])
    vm_in = [(ki, nul), (up(rng.integers(0, 11, n)), none), (kf, nul)]
    pack = ((7, 0),)
    ops = ("sum_i", "sum_f")
    states = []

    def k1():
        states.append(groupby_agg.groupby_agg(
            (ki,), (nul,), (ki, kf), (nul, nul), mask, 1, ops, 1 << 9,
            pack))
    bkeys = rng.permutation(nb) * 3 + 5
    idx = build_join_index([Column(FieldType(tp=TYPE_LONGLONG),
                                   bkeys.astype(np.int64),
                                   np.zeros(nb, bool))])
    a0 = up(idx.starts if idx.kind == "dense" else idx.sorted_keys)
    a1 = up(idx.rows)
    pk = up(rng.integers(0, 3 * nb + 10, n))
    cnt = up(rng.integers(0, 4, n))
    pos0 = up(rng.integers(0, nb - 8, n))
    perm = up(rng.permutation(nb).astype(np.int32))
    wpart = [(up(rng.integers(0, 40, n)), nul)]
    worder = [(up(rng.integers(-3, 4, n)), none)]
    wargs = [(ki, nul), (kf, nul)]
    funcs = [("row_number", None), ("rank", None), ("sum", 0), ("max", 1)]
    widx = sort_topk.window_order([wpart[0][0], worder[0][0]],
                                  [wpart[0][1], worder[0][1]],
                                  [False, False], n, n - 7)
    hashed = []

    def rx_hash():
        hashed[:] = radix_exchange.dest_hash([ki], "single", valid=mask)
    bv = up(rng.integers(-10**9, 10**9, nb))
    return {
        "K2 expr_vm": lambda: expr_vm.run(prog, vm_in, n, n - 3, dev),
        "K1 groupby_agg": k1,
        "K4 sort_topk": lambda: sort_topk.sort_indices(
            [ki, kf], [nul, none], [True, False], [False, True], n, n, 10),
        "K5a join_probe": lambda: join_probe.probe(
            [pk], [None], mask, idx.packs, a0, a1, idx.n_valid,
            layout=idx.kind, mode="count", kind="inner",
            dense_span=idx.span),
        "K5b join_expand": lambda: join_expand.expand(
            cnt, pos0, mask, perm, nb, None, 1 << 14),
        "K7 join_match": lambda: join_match.match(
            up(bkeys), up(np.zeros(nb, bool)), pk, mask),
        "K8/K9 merge_states": lambda: merge_states.merge(
            states[-2:], 1, ops, 1 << 9, pack),
        "K10 window_scan": lambda: window_scan.run(
            n, n - 7, widx, wpart, worder, wargs, funcs, dev),
        "A radix_exchange rx_hash": rx_hash,
        "A radix_exchange": lambda: radix_exchange.partition(
            hashed[0], hashed[1], 8, 4, 1 << 10, [ki, kf]),
        "B shuffle_join": lambda: shuffle_join.join_sum(
            bv, up(rng.permutation(nb)), pos0, cnt, ki, mask),
    }


def first_launch(seed):
    """``--first-launch``: in a process that has run nothing on the card,
    the CUDA context, the kernel library's load, then each kernel's
    wrapper twice on small tensors — the first call pays the kernel's
    module load, its attributes, workspaces and the allocator's growth;
    the second is what a warm pipeline pays.  The difference is what a
    background warm takes off the query path."""
    import torch
    from tidb_tpu_torch.ops.kernels import build
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    ctx_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    build.lib()
    lib_ms = (time.perf_counter() - t0) * 1e3
    print(f"CUDA context {ctx_ms:.3f} ms; kernel library load "
          f"{lib_ms:.3f} ms (nvcc runs in this process "
          f"{build.STATS['nvcc_runs']})")
    out = {"context_ms": ctx_ms, "library_ms": lib_ms, "kernels": {}}
    calls = first_launch_calls(seed, dev)
    for name, call in calls.items():
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["kernels"][name] = ms
        print(f"{name}: first launch {ms[0]:.3f} ms, second {ms[1]:.3f} ms")
    print(json.dumps(out))


def phase_first_launch(args):
    """``[first-launch]`` — this script's ``--first-launch`` mode in a
    child process; its lines are relayed, and its failure fails the
    run."""
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--first-launch",
             "--seed", str(args.seed)], capture_output=True, text=True,
            timeout=300, cwd=HERE)
    except subprocess.TimeoutExpired:
        fail("first-launch: no end within 300 s")
    for line in r.stdout.splitlines():
        log(f"[first-launch] {line}")
    if r.returncode:
        fail(f"first-launch: exit {r.returncode}: {r.stderr[-3000:]}")


# -- the MPP mesh path: K11/K12 on a local mesh of 8 shards -------------------

#: logical shards of the ``[mpp]`` mesh (tidb_mpp_devices), on one card
MPP_SHARDS = 8
#: the queries of ``[mpp]`` (Q18 and the shuffle shape come after them)
MPP_QUERIES = ("q1", "q6", "q3", "q5", "q9")
#: the fact-fact shape of tests/test_mpp_sql.py:175 (orders ⋈ lineitem,
#: grouped by an orders column: the year of o_orderdate, as the generated
#: schema has no o_orderstatus): orders' 1,500,000 rows are past the
#: default broadcast threshold (10,240), so it takes the hash exchange
SHUFFLE_Q = """
select year(o_orderdate) as o_year, count(1), sum(l_quantity)
from orders, lineitem where o_orderkey = l_orderkey
group by o_year order by o_year"""
#: bench_multichip.py phase 2's hot-key tables at 2^20 fact rows: 70% of
#: the fact rows on one key, a 64-row dimension, broadcast threshold 30
SKEW_ROWS = 1 << 20
SKEW_Q = ("select count(1), sum(fact.v + dim.w) from fact, dim "
          "where fact.k = dim.k")
#: kernels every [mpp] fragment must launch: each shard's K2 programs and
#: K1 partial, and the fold of the shards' states; a join adds K4, K5a
#: and K5b; a hash exchange kernel A
MPP_AGG_NEED = ["expr_vm", "groupby_agg", "merge_states"]
MPP_JOIN_NEED = MPP_AGG_NEED + ["sort_topk", "join_probe", "join_expand"]
MPP_NEED = {"q1": MPP_AGG_NEED, "q6": MPP_AGG_NEED,
            "q3": MPP_JOIN_NEED + ["radix_exchange"], "q5": MPP_JOIN_NEED,
            "q9": MPP_JOIN_NEED, "q18": MPP_AGG_NEED,
            "shuffle": MPP_JOIN_NEED + ["radix_exchange"],
            "skew": MPP_JOIN_NEED + ["radix_exchange"]}


def mpp_counters():
    from tidb_tpu_torch.ops.kernels import (expr_vm, groupby_agg,
                                            join_expand, join_probe,
                                            merge_states, radix_exchange,
                                            shuffle_join, sort_topk)
    return {"expr_vm": expr_vm.LAUNCHES, "groupby_agg": groupby_agg.LAUNCHES,
            "sort_topk": sort_topk.LAUNCHES,
            "join_probe": join_probe.LAUNCHES,
            "join_expand": join_expand.LAUNCHES,
            "merge_states": merge_states.LAUNCHES,
            "radix_exchange": radix_exchange.LAUNCHES,
            "shuffle_join": shuffle_join.LAUNCHES}


class KernelCapture:
    """While installed, wraps kernel A's ``partition``, kernel B's
    ``join_sum``, K4's ``valid_first_order`` (a shard's join sort), K5a's
    ``probe`` (a shard's sorted count probe) and the host join index
    build (K6): counts the bytes each partition's grid
    sends through the mesh's all_to_all and the seconds spent building
    host join indexes (the skew guard's), and, with `keep`, keeps each
    kernel's largest call's inputs and outputs, per tag, for the checks
    against the plain versions (kernel A's: of its largest calls, the one
    with the most valid rows; and every call's valid share).  Timed runs
    keep nothing."""

    def __init__(self, keep=False):
        self.calls = {}
        self.bytes = 0
        self.index_s = 0.0
        self.tag = None
        self.keep = keep
        self.shares = {}  # tag: (rows, valid share) of each kernel A call

    def __enter__(self):
        from tidb_tpu_torch.executor import device_join
        from tidb_tpu_torch.ops.kernels import (join_probe, radix_exchange,
                                                shuffle_join, sort_topk)
        self._mods = (radix_exchange, shuffle_join, device_join, sort_topk,
                      join_probe)
        self._fns = (radix_exchange.partition, shuffle_join.join_sum,
                     device_join.build_join_index,
                     sort_topk.valid_first_order, join_probe.probe)
        part_fn, sum_fn, index_fn, order_fn, probe_fn = self._fns

        def valid_first_order(key, invalid):
            out = order_fn(key, invalid)
            self._keep("K4", key.shape[0], dict(key=key, invalid=invalid,
                                                out=out))
            return out

        def probe(keys, knulls, pvalid, packs, a0, a1, nv, **kw):
            out = probe_fn(keys, knulls, pvalid, packs, a0, a1, nv, **kw)
            if kw.get("layout") == "sorted" and kw.get("mode") == "count":
                self._keep("K5a", keys[0].shape[0], dict(
                    keys=keys, knulls=knulls, pvalid=pvalid, packs=packs,
                    a0=a0, a1=a1, nv=nv, layout="sorted", mode="count",
                    kind=kw.get("kind", "inner"), bvalid=kw.get("bvalid"),
                    order=kw.get("order"), dense_span=None))
            return out

        def build_join_index(*a, **kw):
            t = time.perf_counter()
            try:
                return index_fn(*a, **kw)
            finally:
                self.index_s += time.perf_counter() - t

        def partition(h, valid, n_dest, n_sub, cap, cols=()):
            out = part_fn(h, valid, n_dest, n_sub, cap, cols)
            self.bytes += n_dest * n_sub * cap * (
                1 + sum(c.element_size() for c in cols))
            if self.keep:
                # of the largest calls, the one with the most valid rows
                share = (1.0 if valid is None
                         else float(valid.float().mean()))
                self.shares.setdefault(self.tag, []).append(
                    (h.shape[0], share))
                self._keep("A", (h.shape[0], share), dict(
                    h=h, valid=valid, n_dest=n_dest, n_sub=n_sub, cap=cap,
                    cols=list(cols), out=out))
            return out

        def join_sum(bv, order, pos0, cnt, pv, pvalid=None):
            out = sum_fn(bv, order, pos0, cnt, pv, pvalid)
            self._keep("B", pos0.shape[0], dict(
                bv=bv, order=order, pos0=pos0, cnt=cnt, pv=pv,
                pvalid=pvalid, out=out))
            return out

        radix_exchange.partition = partition
        shuffle_join.join_sum = join_sum
        device_join.build_join_index = build_join_index
        sort_topk.valid_first_order = valid_first_order
        join_probe.probe = probe
        return self

    def _keep(self, kernel, size, ev):
        if not self.keep:
            return
        key = (kernel, self.tag)
        if key not in self.calls or size >= self.calls[key][0]:
            self.calls[key] = (size, ev)

    def __exit__(self, *exc):
        (self._mods[0].partition, self._mods[1].join_sum,
         self._mods[2].build_join_index,
         self._mods[3].valid_first_order, self._mods[4].probe) = self._fns
        return False


def mpp_run(s, name, sql, counters, cap, need=None):
    """One query on the mesh engine: (result, seconds, launches, MPP_STATS
    deltas, (exchange bytes, host join index seconds)); fails if a kernel
    of `need` did not launch or no mesh fragment ran."""
    import torch
    from tidb_tpu_torch.executor import mpp_exec
    before = {k: c[0] for k, c in counters.items()}
    st0 = dict(mpp_exec.MPP_STATS)
    cap.bytes, cap.index_s, cap.tag = 0, 0.0, name
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = s.execute(sql)[-1]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moved = {k: c[0] - before[k] for k, c in counters.items()}
    d = {k: mpp_exec.MPP_STATS[k] - st0[k] for k in st0}
    if d["fragments"] <= 0:
        fail(f"mpp {name}: no fragment ran on the mesh (degraded to one "
             "device or to the host?)")
    for k in need or ():
        if moved[k] <= 0:
            fail(f"mpp {name}: kernel {k} was not launched on the mesh "
                 "path")
    return res, dt, moved, d, (cap.bytes, cap.index_s)


def mpp_line(tag, name, dt, d, x, moved):
    xbytes, index_s = x
    log(f"[{tag}] {name}: {dt * 1e3:.3f} ms on the {MPP_SHARDS}-shard mesh, "
        f"of it {index_s * 1e3:.3f} ms in host join index builds (the "
        f"skew guard's K6, numpy, built on a cache miss), "
        f"fragments {d['fragments']}, shuffles {d['shuffle_joins']}, "
        f"exchange {xbytes:,} B, exchange retries "
        f"{d['exchange_overflow_retries']} (overflow) + "
        f"{d['exchange_retries']} (transport), capacity retries "
        f"{d['retries']}, launches {moved}")


def check_top_agg(s, name, sql):
    """EXPLAIN ANALYZE shows engine:tpu-mpp on the top HashAgg."""
    res = s.execute("explain analyze " + sql)[-1]
    aggs = [r for r in res.rows if "HashAgg" in str(r[0])]
    if not aggs or not any("engine:tpu-mpp" in str(c) for c in aggs[0]):
        for r in res.rows:
            log(f"    {r}")
        fail(f"mpp {name}: EXPLAIN ANALYZE shows no engine:tpu-mpp on the "
             "top HashAgg")


def _install_skew(s, dom, seed):
    """bench_multichip.py phase 2's hot-key tables at SKEW_ROWS fact rows,
    made from `seed`."""
    import numpy as np
    from tidb_tpu_torch import carry
    rng = np.random.default_rng(seed)
    s.execute("create database skew")
    s.execute("use skew")
    s.execute("create table dim (k bigint primary key, w bigint)")
    s.execute("insert into dim values " + ",".join(
        f"({i}, {i})" for i in range(1, 65)))
    s.execute("create table fact (a bigint primary key, k bigint, "
              "v bigint)")
    hot = rng.random(SKEW_ROWS) < 0.7
    k = np.where(hot, 7, rng.integers(1, 65, SKEW_ROWS))
    carry.install_bulk_numpy(dom, "skew", "fact", {
        "a": np.arange(1, SKEW_ROWS + 1, dtype=np.int64), "k": k,
        "v": np.arange(1, SKEW_ROWS + 1, dtype=np.int64)}, SKEW_ROWS)


def mpp_dist_steps(mpp_keys, cap, label=""):
    """K11's library entries on the card at SF1: dist_agg_step grouping
    lineitem's quantities by l_orderkey (1,500,000 groups), and
    dist_join_agg_step over orders ⋈ lineitem keys (1,500,000 × 6,001,215
    rows) with int64 and float64 values, each against numpy.  `label`
    marks the lines of a run that is not the timed one."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops.kernels import merge_states
    from tidb_tpu_torch.parallel import mpp
    mesh = mpp.make_mesh(MPP_SHARDS, device="cuda")
    lk, lq = mpp_keys["l_orderkey"], mpp_keys["l_quantity"]
    ok, ot = mpp_keys["o_orderkey"], mpp_keys["o_totalprice"]
    out = {}
    cap.tag = "dist_agg"
    (k, v, q), pad = mpp.shard_batch(mesh, lk, np.ones(len(lk), bool), lq)
    groups = int(np.unique(lk).shape[0])
    capacity = 1 << max(groups - 1, 1).bit_length()
    t0 = time.perf_counter()
    fk, (fs, fmx), fv, ng, ovf, fault = mpp.dist_agg_step(
        mesh, ("sum", "max"), capacity)(k, v & pad, q, q)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    try:
        merge_states.check_fault(fault)
    except merge_states.FoldOrderError as e:
        fail(f"mpp dist_agg_step: {e}")
    if bool(ovf) or int(ng) != groups:
        fail(f"mpp dist_agg_step: {int(ng)} groups (want {groups}), "
             f"overflow {bool(ovf)}")
    keys_np = np.unique(lk)
    gid = np.searchsorted(keys_np, lk)
    sums = np.bincount(gid, weights=lq, minlength=groups).astype(np.int64)
    maxs = np.full(groups, np.iinfo(np.int64).min)
    np.maximum.at(maxs, gid, lq)
    if not (np.array_equal(fk[:groups].cpu().numpy(), keys_np)
            and np.array_equal(fs[:groups].cpu().numpy(), sums)
            and np.array_equal(fmx[:groups].cpu().numpy(), maxs)):
        fail("mpp dist_agg_step: groups differ from numpy")
    log(f"[mpp] dist_agg_step{label}: {groups} groups of {len(lk)} "
        f"lineitem rows equal numpy; {dt * 1e3:.3f} ms (K1 per shard + the "
        "fold)")
    out["dist_agg_s"] = dt
    for kind in ("int64", "float64"):
        cap.tag = f"dist_join {kind}"
        bv = ot if kind == "int64" else ot / 100.0
        pv = lq if kind == "int64" else lq / 100.0
        (bk_t, bvalid, bv_t), bpad = mpp.shard_batch(
            mesh, ok, np.ones(len(ok), bool), bv)
        (pk_t, pvalid, pv_t), ppad = mpp.shard_batch(
            mesh, lk, np.ones(len(lk), bool), pv)
        xcap = 1 << 16
        t0 = time.perf_counter()
        total, pairs, dropped = mpp.dist_join_agg_step(mesh, xcap)(
            bk_t, bv_t, bvalid & bpad, pk_t, pv_t, pvalid & ppad)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        order = np.argsort(ok)
        pos = order[np.searchsorted(ok[order], lk)]
        if kind == "int64":
            want_total = int(np.sum(lq * ot[pos]))
            good = int(total) == want_total
        else:
            want_total = float(np.sum(pv * bv[pos]))
            good = np.isclose(float(total), want_total, rtol=1e-9,
                              atol=1e-12)
        if int(dropped) or int(pairs) != len(lk) or not good:
            fail(f"mpp dist_join_agg_step {kind}: total {total.item()} "
                 f"(numpy {want_total}), pairs {int(pairs)} (want "
                 f"{len(lk)}), dropped {int(dropped)}")
        log(f"[mpp] dist_join_agg_step {kind}{label}: orders ⋈ lineitem "
            f"keys, {int(pairs)} pairs, total equal to numpy ({want_total}); "
            f"{dt * 1e3:.3f} ms (kernel A, all_to_all, K5a range, K4, K5a "
            f"sorted probe and kernel B per shard)")
        out[f"dist_join_{kind}_s"] = dt
    return out


def check_exchange(ev, what):
    """Kernel A against its plain version on one captured call: every
    grid buffer, need and dropped exact.  Returns (ms, plain_ms,
    library_ms, bound_ms)."""
    import torch
    from tidb_tpu_torch.ops.kernels import radix_exchange as rx
    h, valid, cols = ev["h"], ev["valid"], ev["cols"]
    args = (h, valid, ev["n_dest"], ev["n_sub"], ev["cap"], cols)
    got = rx.partition(*args)
    want = rx.partition_plain(*args)
    for key in ("rows", "valid"):
        if not torch.equal(got[key], want[key]):
            fail(f"kernel A {what}: {key} differs from the plain version")
    for i, (a, b) in enumerate(zip(got["cols"], want["cols"])):
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            fail(f"kernel A {what}: column {i} differs")
    for key in ("need", "dropped"):
        if int(got[key]) != int(want[key]):
            fail(f"kernel A {what}: {key} {int(got[key])} != plain "
                 f"{int(want[key])}")
    ms = cuda_ms(lambda: rx.partition(*args))
    plain_ms = cuda_ms(lambda: rx.partition_plain(*args))
    bucket = rx.bucket_plain(h, valid, ev["n_dest"], ev["n_sub"])

    def library():
        # the yardstick: a stable sort of the bucket ids and the gathers
        order = torch.sort(bucket, stable=True).indices
        return [c[order] for c in cols]
    lib_ms = cuda_ms(library)
    return ms, plain_ms, lib_ms, exchange_bound_ms(ev)


def exchange_bound_ms(ev):
    """Kernel A's bound: h, valid and every column read once, the grid
    (rows, slot_valid, each column) written once, over HBM's rate."""
    m = ev["h"].shape[0]
    width = sum(c.element_size() for c in ev["cols"])
    slots = ev["n_dest"] * ev["n_sub"] * ev["cap"]
    moved = (m * (8 + (1 if ev["valid"] is not None else 0)) + m * width
             + slots * (8 + 1 + width))
    return moved / HBM_BYTES_PER_S * 1e3


def join_sum_bound_ms(ev):
    """Kernel B's bound: the order and the build values read once, pos0,
    cnt, the probe values and pvalid read once, over HBM's rate."""
    n = ev["order"].shape[0]
    npr = ev["pos0"].shape[0]
    moved = (n * 8 * 2 + npr * (8 * 3 + (1 if ev["pvalid"] is not None
                                         else 0)))
    return moved / HBM_BYTES_PER_S * 1e3


def check_join_sum(ev, what):
    """Kernel B against its plain version on one captured call: int64
    exact, float64 within rtol 1e-9 / atol 1e-12.  Returns (ms, plain_ms,
    bound_ms, err)."""
    import numpy as np
    from tidb_tpu_torch.ops.kernels import shuffle_join as sj
    args = (ev["bv"], ev["order"], ev["pos0"], ev["cnt"], ev["pv"],
            ev["pvalid"])
    total, pairs = sj.join_sum(*args)
    wt, wp = sj.join_sum_plain(*args)
    err = 0.0
    if int(pairs) != int(wp):
        fail(f"kernel B {what}: pairs {int(pairs)} != plain {int(wp)}")
    if total.is_floating_point():
        err = abs(float(total) - float(wt))
        if not np.isclose(float(total), float(wt), rtol=1e-9, atol=1e-12):
            fail(f"kernel B {what}: total {float(total)} vs plain "
                 f"{float(wt)} outside rtol 1e-9")
    elif int(total) != int(wt):
        fail(f"kernel B {what}: total {int(total)} != plain {int(wt)}")
    ms = cuda_ms(lambda: sj.join_sum(*args))
    plain_ms = cuda_ms(lambda: sj.join_sum_plain(*args))
    return ms, plain_ms, join_sum_bound_ms(ev), err


def check_join_sort(ev, tag, report):
    """K4 on the mesh's join-sort shape (the largest shard build side the
    kept runs sorted: one int64 key, its invalid rows last): the order
    against sort_plain and against torch.sort(stable=True) of the packed
    key (exact), both timed."""
    import torch
    from tidb_tpu_torch.ops.kernels import sort_topk
    key, invalid = ev["key"], ev["invalid"]
    n = key.shape[0]
    spec = ([key], [invalid], [False], [False])
    got = sort_topk.valid_first_order(key, invalid)
    if not torch.equal(got, ev["out"]) or not torch.equal(
            got, sort_topk.sort_plain(*spec, n, n)):
        fail("K4 join sort: order differs from the plain version")
    stats = sort_topk.key_stats_plain(*spec[:2], spec[2], n)
    layout = sort_topk.pack_layout(*stats, n, n)
    if layout.words != 1:
        fail(f"K4 join sort: the key packs into {layout.words} words")
    packed = sort_topk.pack_words_plain(*spec, n, n, layout)[0] ^ (-1 << 63)
    if not torch.equal(got, torch.sort(packed, stable=True).indices):
        fail("K4 join sort: order differs from torch.sort of the packed key")
    ms = cuda_ms(lambda: sort_topk.valid_first_order(key, invalid))
    lib_ms = cuda_ms(lambda: torch.sort(packed, stable=True))
    bound = (nbytes([key, invalid]) + 8 * n) / HBM_BYTES_PER_S * 1e3
    passes = k4_passes(spec, n, n, "join_sort", report)
    log(f"[mpp] K4 join sort on the largest shard build side ({tag}: {n} "
        f"rows, {int(invalid.sum())} invalid): exact; {ms:.3f} ms (bound "
        f"{bound:.4f} ms; {passes}); torch.sort(stable=True) of the packed "
        f"key {lib_ms:.3f} ms")
    report["sort_topk"].update(ms_join_sort=ms, join_sort_bound_ms=bound,
                               library_ms_join_sort=lib_ms)


def check_mesh_probe(ev, tag, report):
    """K5a on the mesh's largest shard probe (a sort join's count probe
    through K4's order): exact against the plain version, timed beside its
    bound, and at each sample size."""
    from tidb_tpu_torch.ops.kernels import join_probe
    ms, plain_ms, bound = check_probe(ev, f"K5a mesh probe ({tag})")
    split = call_split(lambda: join_probe.probe(*probe_args(ev),
                                                **probe_kw(ev)))
    log(f"[mpp] K5a sorted count probe on the largest shard ({tag}: "
        f"{ev['keys'][0].shape[0]} probe rows, {int(ev['nv'])} build "
        f"keys): exact; {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
        f"{bound:.4f} ms); {split_text(split)}")
    report["join_probe"].update(ms_mesh=ms, plain_ms_mesh=plain_ms,
                                bound_ms_mesh=bound)
    probe_samples(ev, f"mesh {tag}")


def mpp_profile(tag, s, name, sql):
    """One more run of `sql` under torch.profiler: the wall time, the
    device's busy time (the kernels' own time summed: the shards launch
    on one stream, so nothing overlaps) and idle share, and the kernels
    that took the most device time; the host join index builds of the run
    beside them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with KernelCapture() as cap, profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.execute(sql)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    index = f"host join index builds {cap.index_s * 1e3:.3f} ms"
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            kernels.append((us / 1e3, e.key, e.count))
    if not kernels:
        log(f"[{tag}] {name} profile: wall {wall:.3f} ms, {index}; the "
            "profiler gave no device time (busy and idle share not "
            "measured)")
        return
    busy = sum(k[0] for k in kernels)
    top = ", ".join(f"{key[:40]} {ms:.3f} ms x{n}" for ms, key, n in
                    sorted(kernels, reverse=True)[:8])
    k4 = [(ms, n) for ms, key, n in kernels if is_k4_kernel(key)]
    log(f"[{tag}] {name} profile: wall {wall:.3f} ms, {index}, device "
        f"busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}); K4's "
        f"kernels {sum(k[0] for k in k4):.3f} ms in "
        f"{sum(k[1] for k in k4)} launches; top kernels: {top}")


def is_k4_kernel(name):
    """A kernel of csrc/sort_topk.cu, by its (demangled) name."""
    return name.split("(")[0].split("<")[0].split()[-1].startswith("sk_")


#: the CUDA runtime's calls that launch a kernel or copy memory, by the
#: start of their names
RUNTIME_LAUNCH = ("cudaLaunch", "cuLaunch")
RUNTIME_COPY = ("cudaMemcpy", "cuMemcpy")


def device_profile(fn, calls=10, runtime=None):
    """{name: (device ms, operations)} of the kernels, fills and copies one
    call of `fn` runs: torch.profiler over `calls` calls after a warm-up
    call, averaged (the profiler can drop the first launch of its
    window).  `runtime`, a dict: the host's side is recorded too
    (ProfilerActivity.CPU), and the dict gets {name: calls a call} of the
    CUDA runtime's launch and copy calls, which are counted on the host
    as they are made, whatever the device trace keeps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if runtime is not None:
        acts.append(ProfilerActivity.CPU)
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if runtime is not None:
            if e.key.startswith(RUNTIME_LAUNCH + RUNTIME_COPY):
                runtime[e.key] = runtime.get(e.key, 0.0) + e.count / calls
            if e.device_type == DeviceType.CPU:
                continue  # a host op: its kernels are counted on their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            ms, ops = out.get(e.key, (0.0, 0.0))
            out[e.key] = (ms + us / 1e3 / calls, ops + e.count / calls)
    return out


def host_issue_ms(fn, calls=20):
    """The host's milliseconds to issue one call of `fn`: a synchronise
    before each call, none inside it (the mean of `calls`)."""
    import torch
    fn()
    total = 0.0
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / calls * 1e3


def call_split(fn, prof=None, runtime=None):
    """One call of `fn` split: (device ms, device operations — kernels,
    fills and copies — per call, host ms to issue it).  `prof`, a dict:
    gets device_profile's {name: (ms, operations)}; `runtime`: as
    device_profile's."""
    got = device_profile(fn, runtime=runtime)
    if prof is not None:
        prof.update(got)
    return (sum(v[0] for v in got.values()),
            sum(v[1] for v in got.values()), host_issue_ms(fn))


def split_text(split):
    dev_ms, ops, host = split
    if dev_ms is None:
        return (f"device ms not measured (the device trace missed "
                f"launches), host issue {host:.3f} ms")
    return (f"device {dev_ms:.3f} ms in {ops:g} operations a call, host "
            f"issue {host:.3f} ms")


def phase_mpp(s, dom, host_res, mpp_keys, seed, report):
    """``[mpp]`` — the MPP engine on a local mesh of 8 shards on the SF1
    tables: Q1, Q6, Q3, Q5, Q9, Q18, the orders ⋈ lineitem shuffle, a warm
    Q3 and a hot-key exchange (the SQL path), then K11's library steps
    (the library path), each counted on its own; kernels A and B against
    their plain versions on inputs captured in a run after the timed
    ones."""
    import torch
    from tidb_tpu_torch.executor import device_exec, mpp_exec
    from tidb_tpu_torch.ops import residency
    sqls = dict(QUERIES)
    counters = mpp_counters()
    # the mesh of this phase is the one-card mesh however many cards are
    # visible: its logical shards all on the session's card
    mpp_exec.set_mesh_devices([torch.device("cuda", 0)])
    mesh_rows = {}
    s.execute("use tpch")
    s.execute(f"set tidb_mpp_devices = {MPP_SHARDS}")
    s.execute("set @@tidb_executor_engine = 'tpu-mpp'")
    t0 = time.perf_counter()
    for name in MPP_QUERIES + ("q18",):
        s.execute(sqls[name])
        if name != "q18":
            check_top_agg(s, name, sqls[name])
    s.execute(SHUFFLE_Q)
    check_top_agg(s, "shuffle", SHUFFLE_Q)
    torch.cuda.synchronize()
    log(f"[mpp] warm-ups (placement, pipeline builds, EXPLAIN ANALYZE): "
        f"{time.perf_counter() - t0:.1f}s; engine:tpu-mpp on the top "
        "HashAgg of Q1, Q6, Q3, Q5, Q9 and the shuffle")
    s.execute("set @@tidb_executor_engine = 'host'")
    t0 = time.perf_counter()
    host_shuffle = s.execute(SHUFFLE_Q)[-1]
    log(f"[mpp] shuffle shape on the host engine: {len(host_shuffle.rows)} "
        f"rows in {time.perf_counter() - t0:.3f} s")
    _install_skew(s, dom, seed)
    host_skew = s.execute(SKEW_Q)[-1]
    s.execute("use tpch")
    s.execute("set @@tidb_executor_engine = 'tpu-mpp'")

    for c in counters.values():
        c[0] = 0
    with KernelCapture() as cap:
        # the SQL path, timed with nothing kept
        for name in MPP_QUERIES + ("q18", "shuffle"):
            sql = SHUFFLE_Q if name == "shuffle" else sqls[name]
            res, dt, moved, d, xb = mpp_run(s, name, sql, counters, cap,
                                            MPP_NEED[name])
            want = host_shuffle if name == "shuffle" else host_res[name]
            if not rows_equal(res, want):
                fail(f"mpp {name}: rows differ from the host engine's:\n"
                     f"mesh {res.rows[:5]}\nhost {want.rows[:5]}")
            if name in ("q3", "shuffle") and d["shuffle_joins"] <= 0:
                fail(f"mpp {name}: did not take the hash exchange")
            mesh_rows[name] = (res, dt)
            mpp_line("mpp", name, dt, d, xb, moved)
        # warm Q3: the learned capacities hit the cached pipeline
        ps0 = device_exec.pipe_cache_stats()
        res, dt, moved, d, xb = mpp_run(s, "q3 warm", sqls["q3"], counters,
                                        cap, MPP_NEED["q3"])
        ps1 = device_exec.pipe_cache_stats()
        misses = ps1["misses"] - ps0["misses"]
        builds = ps1["traces"] - ps0["traces"]
        if misses or builds or not rows_equal(res, host_res["q3"]):
            fail(f"mpp q3 warm: {misses} pipe misses, {builds} builds")
        mpp_line("mpp", "q3 warm (pipe misses 0, builds 0)", dt, d, xb,
                 moved)
        s.execute("use skew")
        s.execute("set tidb_broadcast_join_threshold_count = 30")
        try:
            res, dt, moved, d, xb = mpp_run(s, "skew", SKEW_Q, counters, cap,
                                            MPP_NEED["skew"])
        finally:
            s.execute("set tidb_broadcast_join_threshold_count = 10240")
            s.execute("use tpch")
        if (d["exchange_overflow_retries"] < 1 or d["shuffle_joins"] < 1
                or not rows_equal(res, host_skew)):
            fail(f"mpp skew: overflow retries "
                 f"{d['exchange_overflow_retries']}, shuffles "
                 f"{d['shuffle_joins']}, rows {res.rows} vs host "
                 f"{host_skew.rows}")
        mesh_rows["skew"] = (res, dt)
        mpp_line("mpp", f"skew ({SKEW_ROWS} fact rows, 70% on one key; "
                 "rows equal the host's, 0 dropped)", dt, d, xb, moved)
    sql_launches = {k: c[0] for k, c in counters.items()}
    log(f"[mpp] launches of the SQL mesh path (the queries, warm Q3 and "
        f"skew) {sql_launches}")
    for c in counters.values():
        c[0] = 0
    with KernelCapture() as cap:
        steps = mpp_dist_steps(mpp_keys, cap)
    lib_launches = {k: c[0] for k, c in counters.items()}
    log(f"[mpp] launches of K11's library path (dist_agg_step, "
        f"dist_join_agg_step int64 and float64) {lib_launches}; the runs "
        "and checks below are not counted")
    for path, launches, need in (
            ("SQL mesh", sql_launches, ("radix_exchange",)),
            ("K11 library", lib_launches, ("radix_exchange",
                                           "shuffle_join"))):
        for k in need:
            if launches[k] <= 0:
                fail(f"mpp: kernel {k} never launched on the {path} path")
    # kernel A runs on both paths, kernel B on the library path only
    report["radix_exchange"].update(
        launches=sql_launches["radix_exchange"],
        launches_dist_steps=lib_launches["radix_exchange"])
    report["shuffle_join"]["launches"] = lib_launches["shuffle_join"]
    # Q3 after the shuffle, whose orders index (another filter) the skew
    # guard must rebuild, as in the timed runs; then Q3 repeated at once
    s.execute(SHUFFLE_Q)
    mpp_profile("mpp", s, "q3 after the shuffle", sqls["q3"])
    mpp_profile("mpp", s, "q3 repeated at once", sqls["q3"])

    # the inputs for the checks, kept in runs of their own; Q3's time
    # with the inputs kept is shown beside the timed one
    with KernelCapture(keep=True) as cap, FoldCapture() as fold_cap:
        for name in ("q3", "shuffle"):
            cap.tag = fold_cap.tag = name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.execute(SHUFFLE_Q if name == "shuffle" else sqls[name])
            torch.cuda.synchronize()
            log(f"[mpp] {name} with kernel A's largest inputs kept: "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms (not a "
                "latency figure)")
        fold_cap.tag = "dist_agg_step"
        mpp_dist_steps(mpp_keys, cap, " (inputs kept)")

    # kernel A on Q3's and the shuffle's largest partition, kernel B on
    # the dist_join steps' largest local sums
    best = None
    for tag in ("q3", "shuffle"):
        ev = cap.calls.get(("A", tag), (0, None))[1]
        if ev is None:
            fail(f"mpp {tag}: kernel A's inputs were not captured")
        ms, plain_ms, lib_ms, bound = check_exchange(ev, tag)
        share = (1.0 if ev["valid"] is None else
                 float(ev["valid"].float().mean()))
        m = ev["h"].shape[0]
        same = sorted(f"{x:.4f}" for rows, x in cap.shares.get(tag, ())
                      if rows == m)
        log(f"[mpp] kernel A on {tag}'s largest partition with the most "
            "valid rows "
            f"({m} rows, {len(ev['cols'])} columns of "
            f"{[c.element_size() for c in ev['cols']]} bytes, valid share "
            f"{share:.4f}; the valid shares of the {len(same)} calls of "
            f"that size: {', '.join(same)}; grid "
            f"{ev['n_dest']}x{ev['n_sub']}x{ev['cap']}): exact; "
            f"{ms:.3f} ms (plain {plain_ms:.3f} ms, stable torch.sort + "
            f"gathers {lib_ms:.3f} ms, bound {bound:.4f} ms)")
        if best is None or bound > best["bound_ms"]:
            best = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, library_ms=lib_ms)
    report["radix_exchange"].update(best)
    sums = {}
    for kind in ("int64", "float64"):
        ev = cap.calls.get(("B", f"dist_join {kind}"), (0, None))[1]
        if ev is None:
            fail(f"mpp dist_join {kind}: kernel B's inputs were not "
                 "captured")
        ms, plain_ms, bound, err = check_join_sum(ev, kind)
        log(f"[mpp] kernel B on a {kind} shard ({ev['order'].shape[0]} "
            f"build slots, {ev['pos0'].shape[0]} probe slots): "
            f"{'exact' if kind == 'int64' else f'abs err {err:.3g}'}; "
            f"{ms:.3f} ms (plain {plain_ms:.3f} ms, bound {bound:.4f} ms)")
        sums[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          max_abs_err=err)
    # times of the int64 shard, the error of the float64 one
    report["shuffle_join"].update(
        sums["int64"], max_abs_err=sums["float64"]["max_abs_err"])
    sorts = [(size, tag, ev) for (kernel, tag), (size, ev)
             in cap.calls.items() if kernel == "K4"]
    if not sorts:
        fail("mpp: K4's join sort inputs were not captured")
    _size, tag, ev = max(sorts, key=lambda t: t[0])
    check_join_sort(ev, tag, report)
    probes = [(size, tag, ev) for (kernel, tag), (size, ev)
              in cap.calls.items() if kernel == "K5a"]
    if not probes:
        fail("mpp: K5a's sorted probe inputs were not captured")
    _size, tag, ev = max(probes, key=lambda t: t[0])
    check_mesh_probe(ev, tag, report)
    log(f"[mpp] K11 dist steps: {steps}")
    # the largest mesh fold of those runs: the n shards' states, in shard
    # order
    if fold_cap.best is None:
        fail("mpp: no fold of shard states was captured")
    row = check_merge(f"mpp {fold_cap.best_tag}", fold_cap.best[1])
    del fold_cap
    report["merge_states"].update(
        ms_mesh=row["ms"], plain_ms_mesh=row["plain_ms"],
        bound_ms_mesh=row["bound_ms"], max_abs_err=max(
            report["merge_states"].get("max_abs_err", 0.0),
            row["max_abs_err"]))
    # the placements leave the card for the phases after this one
    with mpp_exec._PLACE_LOCK:
        mpp_exec._MPP_PLACE_CACHE.clear()
    residency.evict_all("[mpp] done")
    mpp_exec.set_mesh_devices(None)
    s.execute("set @@tidb_executor_engine = 'tpu'")
    torch.cuda.empty_cache()
    # what [mpp-cards] holds its meshes to: the host engine's rows of the
    # shuffle and the hot key, and this phase's rows and seconds
    return {"shuffle": host_shuffle, "skew": host_skew}, mesh_rows


def phase_mpp_sf10(s, sf10_rows):
    """``[mpp-sf10]`` — Q1 and Q3 on the SF10 tables on the 8-shard mesh,
    against ``[sf10]``'s resident rows."""
    import torch
    from tidb_tpu_torch.executor import mpp_exec
    from tidb_tpu_torch.ops import residency
    sqls = dict(QUERIES)
    counters = mpp_counters()
    residency.evict_all("[mpp-sf10]")
    torch.cuda.empty_cache()
    mpp_exec.set_mesh_devices([torch.device("cuda", 0)])
    mesh_rows = {}
    s.execute("use tpch10")
    s.execute(f"set tidb_mpp_devices = {MPP_SHARDS}")
    s.execute("set @@tidb_executor_engine = 'tpu-mpp'")
    try:
        with KernelCapture() as cap:  # exchange bytes only
            for name in ("q1", "q3"):
                _r, dt, _m, d, xb = mpp_run(s, name, sqls[name], counters,
                                            cap, MPP_NEED[name])
                mpp_line("mpp-sf10", f"{name} warm-up", dt, d, xb, _m)
                res, dt, moved, d, xb = mpp_run(s, name, sqls[name],
                                                counters, cap,
                                                MPP_NEED[name])
                want, what = sf10_rows[name]
                if not rows_equal(res, want):
                    fail(f"mpp-sf10 {name}: rows differ from [sf10]'s "
                         f"{what} rows:\nmesh {res.rows[:5]}\n"
                         f"sf10 {want.rows[:5]}")
                if name == "q3" and d["shuffle_joins"] <= 0:
                    fail("mpp-sf10 q3: did not take the hash exchange")
                mesh_rows[name] = (res, dt)
                mpp_line("mpp-sf10", f"{name} ({len(res.rows)} rows equal "
                         f"[sf10]'s {what} rows)", dt, d, xb, moved)
        mpp_profile("mpp-sf10", s, "q3", sqls["q3"])
    finally:
        with mpp_exec._PLACE_LOCK:
            mpp_exec._MPP_PLACE_CACHE.clear()
        mpp_exec.set_mesh_devices(None)
        s.execute("set @@tidb_executor_engine = 'tpu'")
    return mesh_rows


# -- the mesh across cards: one process, one shard a card --------------------

#: [mpp-cards]'s queries where two or more cards are visible: [mpp]'s
CARDS_QUERIES = MPP_QUERIES + ("q18", "shuffle", "skew")
#: with one card: a split mesh of this many shards, every one on cuda:0,
#: over these queries
ONE_CARD_SHARDS = 4
ONE_CARD_QUERIES = ("q1", "q3", "shuffle")
#: each kernel's C launchers, whose calls ops/kernels/build.py counts by
#: card (CARD_LAUNCHES): the calls its own LAUNCHES counter counts (K4's
#: also count the sorts of K1's hash path, which K1's counter holds)
CARD_FNS = {"expr_vm": ("expr_vm_run",),
            "groupby_agg": ("gb_groups_run",),
            "sort_topk": ("sort_keys_run",),
            "join_probe": ("join_range_run", "join_probe_run"),
            "join_expand": ("join_expand_run",),
            "join_match": ("join_match_run",),
            "merge_states": ("ms_fold_run",),
            "window_scan": ("window_scan_run",),
            "radix_exchange": ("radix_hash_run", "radix_partition_run"),
            "shuffle_join": ("shuffle_join_run",)}


def card_launches():
    """{kernel: {card: launcher calls}} since CARD_LAUNCHES was cleared."""
    from tidb_tpu_torch.ops.kernels import build
    out = {}
    for k, fns in CARD_FNS.items():
        for (fn, card), c in build.CARD_LAUNCHES.items():
            if fn in fns:
                row = out.setdefault(k, {})
                row[card] = row.get(card, 0) + c
    return out


def cards_text() -> str:
    """Every visible card's name and power limit, as nvidia-smi gives
    them, and their count."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    lines = smi.stdout.strip().splitlines()
    return f"{'; '.join(lines)} ({len(lines)} cards)"


def sync_all():
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class A2ACapture:
    """While installed on `mesh`, keeps the grids of its largest
    all_to_all (by bytes) for a timing of the exchange alone."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.best = None

    def __enter__(self):
        fn = self.mesh.all_to_all

        def a2a(grids):
            nb = sum(g.numel() * g.element_size() for g in grids)
            if self.best is None or nb > self.best[0]:
                self.best = (nb, list(grids))
            return fn(grids)
        self.mesh.all_to_all = a2a
        return self

    def __exit__(self, *exc):
        del self.mesh.all_to_all
        return False


def exchange_ms(mesh, grids, reps=10):
    """The median ms of `mesh`'s all_to_all of `grids` alone, every card
    synchronised before and after, and the bytes it copies from one card
    to another."""
    b0 = mesh.stats["bytes_between_devices"]
    mesh.all_to_all(grids)
    sync_all()
    between = mesh.stats["bytes_between_devices"] - b0
    times = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        mesh.all_to_all(grids)
        sync_all()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2], between


def guard_us(n_cards, calls=20000):
    """The host cost of ``build.launch``'s device guard a call, in µs:
    one trivial C call of the library through it, on the current card
    and (with two or more cards) on another, less the same call made
    directly; medians of 5 rounds of `calls` calls."""
    import ctypes
    import torch
    from tidb_tpu_torch.ops.kernels import build
    fn = build.lib().tidb_cuda_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    torch.cuda.set_device(0)

    def per_call(call):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        return sorted(times)[2]
    direct = per_call(lambda: fn(0))
    out = {"same card": per_call(
        lambda: build.launch(torch.device("cuda", 0), fn, 0)) - direct}
    if n_cards >= 2:
        other = torch.device("cuda", n_cards - 1)
        out["another card"] = per_call(
            lambda: build.launch(other, fn, 0)) - direct
    # the timing calls are no kernel's launches: they leave no count
    for key in [k for k in build.CARD_LAUNCHES if k[0] == fn.__name__]:
        del build.CARD_LAUNCHES[key]
    build.CARD_LAUNCHES.clear()
    return direct, out


def cards_run(s, mesh, name, sql, counters, cap, want, n_cards, tag):
    """One query on the split mesh, warm: a warm-up (placement, builds,
    retries; EXPLAIN ANALYZE shows engine:tpu-mpp), then two timed runs,
    whose rows must equal every result of `want` ({what: result}), with
    no capacity or exchange retry (nothing dropped), the kernels of
    MPP_NEED launched, and kernels on each of the mesh's cards.  Returns
    (result, the two runs' seconds, the second's launches by kernel and
    card, MPP_STATS deltas and exchange bytes, the bytes its exchange
    copied between cards, its launches)."""
    from tidb_tpu_torch.ops.kernels import build
    s.execute(sql)
    sync_all()
    if name != "skew":
        check_top_agg(s, name, sql)
    dts = []
    for _ in range(2):
        sync_all()
        build.CARD_LAUNCHES.clear()
        x0 = mesh.stats["bytes_between_devices"]
        res, dt, moved, d, xb = mpp_run(s, name, sql, counters, cap,
                                        MPP_NEED[name])
        between = mesh.stats["bytes_between_devices"] - x0
        dts.append(dt)
        for what, w in want.items():
            if not rows_equal(res, w):
                fail(f"{tag} {name}: rows differ from {what}:\nsplit "
                     f"{res.rows[:5]}\n{what} {w.rows[:5]}")
        if d["retries"] or d["exchange_overflow_retries"]:
            fail(f"{tag} {name}: the warm run retried ({d}): a dispatch "
                 "dropped rows or overflowed")
    by_card = card_launches()
    if name in ("q3", "shuffle", "skew") and d["shuffle_joins"] <= 0:
        fail(f"{tag} {name}: did not take the hash exchange")
    ran = {card for per in by_card.values() for card in per}
    cards = set(range(n_cards))
    if ran != cards:
        fail(f"{tag} {name}: kernels ran on cards {sorted(ran)}, not on "
             f"every card of the mesh {sorted(cards)}")
    return res, dts, by_card, d, xb, between, moved


#: K11's library steps in [mpp-cards]: seeded rows, int64 keys over this
#: many distinct values, the agg step's capacity, the join step's
#: sub-bucket cap
CARDS_STEP_ROWS = 1 << 22
CARDS_STEP_KEYS = 1 << 20
CARDS_STEP_CAP = 1 << 21
CARDS_STEP_XCAP = 1 << 17


def cards_dist_steps(mesh, seed, cards):
    """K11's dist_agg_step and dist_join_agg_step on the split `mesh`
    against the same steps on a local mesh of as many shards on cuda:0,
    on seeded rows: every output exact (int64), nothing dropped, kernels
    (B's included) on each of the mesh's cards.  Returns the split run's
    launches by kernel and card."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops.kernels import build
    from tidb_tpu_torch.parallel import mpp
    rng = np.random.default_rng(seed)
    rows = CARDS_STEP_ROWS
    keys = rng.integers(0, CARDS_STEP_KEYS, rows)
    vals = rng.integers(-99, 99, rows)
    valid = rng.random(rows) < 0.9
    out, ms, by_card = {}, {}, None
    for tag, m in (("split", mesh),
                   ("local", mpp.make_mesh(mesh.n, device="cuda:0"))):
        (k, v, x), _pad = mpp.shard_batch(m, keys, valid, vals)
        agg = mpp.dist_agg_step(m, ("sum",), CARDS_STEP_CAP)
        join = mpp.dist_join_agg_step(m, CARDS_STEP_XCAP)
        agg(k, v, x)
        join(k, x, v, k, x, v)
        sync_all()
        build.CARD_LAUNCHES.clear()
        t0 = time.perf_counter()
        a = agg(k, v, x)
        j = join(k, x, v, k, x, v)
        sync_all()
        ms[tag] = (time.perf_counter() - t0) * 1e3
        if tag == "split":
            by_card = card_launches()
        ng = int(a[3])
        out[tag] = (ng, bool(a[4]), a[0][:ng].cpu(), a[1][0][:ng].cpu(),
                    [int(t) for t in j])
        del k, v, x, a, j
    (sng, sovf, sk, ss, sj), (lng, lovf, lk, ls, lj) = out["split"], \
        out["local"]
    if (sng != lng or sovf or lovf or not torch.equal(sk, lk)
            or not torch.equal(ss, ls) or sj != lj or sj[2]):
        fail(f"mpp-cards K11 steps: the split mesh gave {sng} groups, join "
             f"{sj}; the local mesh {lng}, {lj}")
    ran = {c for per in by_card.values() for c in per}
    if ran != {d.index for d in mesh.devices}:
        fail(f"mpp-cards K11 steps: kernels ran on cards {sorted(ran)}")
    log(f"[mpp-cards] K11 library steps on {rows:,} seeded rows "
        f"(dist_agg_step: {sng:,} groups; dist_join_agg_step: total "
        f"{sj[0]:,}, {sj[1]:,} pairs, 0 dropped), equal to the local "
        f"mesh's: {ms['split']:.3f} ms on the split mesh, "
        f"{ms['local']:.3f} ms on {mesh.n} shards on cuda:0; launches by "
        f"card {by_card}; {cards}")
    return by_card


def phase_mpp_cards(s, s10, host_res, mesh_rows, sf10_rows, mesh10_rows,
                    report, seed=42):
    """``[mpp-cards]`` — the MPP engine on a split mesh, one shard a card,
    driven from this one process.  With two or more cards:
    ``tidb_mpp_devices = 0`` (every card), SF1's [mpp] queries and SF10 Q1
    and Q3, each held to the host engine's (SF10: the resident path's)
    rows and to the one-card 8-shard mesh's, kernels on every card; then a
    session on the last card (``set_device``) runs Q1 and Q3 on the
    single-device engine.  With one card: a split mesh of 4 shards, every
    one on cuda:0, over SF1 Q1, Q3 and the shuffle, with the same checks,
    and a line that says what that cannot exercise."""
    import torch
    from tidb_tpu_torch.executor import device_exec, mpp_exec
    from tidb_tpu_torch.ops import residency
    n = torch.cuda.device_count()
    cards = cards_text()
    sqls = dict(QUERIES, shuffle=SHUFFLE_Q, skew=SKEW_Q)
    counters = mpp_counters()
    residency.evict_all("[mpp-cards]")
    torch.cuda.empty_cache()
    if n >= 2:
        mpp_exec.set_mesh_devices(None)
        names, shards = CARDS_QUERIES, n
        peers = [f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
                 for i in range(n) for j in range(n) if i != j]
        log(f"[mpp-cards] peer access: {', '.join(peers)}; {cards}")
    else:
        mpp_exec.set_mesh_devices([torch.device("cuda", 0)]
                                  * ONE_CARD_SHARDS)
        names, shards = ONE_CARD_QUERIES, ONE_CARD_SHARDS
    direct, guard = guard_us(n)
    log(f"[mpp-cards] launch guard's host cost a call (build.launch less a "
        f"direct call of {direct:.3f} µs): "
        + ", ".join(f"{k} {v:.3f} µs" for k, v in guard.items())
        + f"; {cards}")
    launches = {}
    try:
        s.execute("use tpch")
        s.execute("set tidb_mpp_devices = 0")
        s.execute("set @@tidb_executor_engine = 'tpu-mpp'")
        mesh = mpp_exec.mpp_mesh(s)
        if mesh is None or not mesh.split or mesh.n != shards:
            fail(f"mpp-cards: tidb_mpp_devices = 0 gave {mesh}, not a split "
                 f"mesh of {shards} shards")
        log(f"[mpp-cards] {mesh}, {cards}")
        t0 = time.perf_counter()
        with KernelCapture() as cap, A2ACapture(mesh) as a2a:
            for name in names:
                skew = name == "skew"
                if skew:
                    s.execute("use skew")
                    s.execute("set tidb_broadcast_join_threshold_count = 30")
                try:
                    res, dt, by_card, d, xb, between, moved = cards_run(
                        s, mesh, name, sqls[name], counters, cap,
                        {"the host engine's": host_res[name],
                         "the one-card 8-shard mesh's": mesh_rows[name][0]},
                        n, "mpp-cards")
                finally:
                    if skew:
                        s.execute("set tidb_broadcast_join_threshold_count "
                                  "= 10240")
                        s.execute("use tpch")
                for k, per in by_card.items():
                    row = launches.setdefault(k, {})
                    for card, c in per.items():
                        row[card] = row.get(card, 0) + c
                log(f"[mpp-cards] {name}: {dt[0] * 1e3:.3f} / "
                    f"{dt[1] * 1e3:.3f} ms (two timed runs) on {mesh.n} "
                    f"shards ([mpp]'s 8 shards on one card "
                    f"{mesh_rows[name][1] * 1e3:.3f} ms); {len(res.rows)} "
                    "rows equal the host engine's and the one-card mesh's; "
                    f"fragments {d['fragments']}, shuffles "
                    f"{d['shuffle_joins']}, retries 0 (nothing dropped); "
                    f"kernel A grids {xb[0]:,} B, of them {between:,} B "
                    f"copied between cards; launches by card {by_card}; "
                    f"{cards}")
            # warm Q3: the learned capacities hit the cached pipeline
            ps0 = device_exec.pipe_cache_stats()
            res, dt, _m, d, _x = mpp_run(s, "q3 warm", sqls["q3"], counters,
                                         cap, MPP_NEED["q3"])
            ps1 = device_exec.pipe_cache_stats()
            misses = ps1["misses"] - ps0["misses"]
            builds = ps1["traces"] - ps0["traces"]
            if misses or builds or not rows_equal(res, host_res["q3"]):
                fail(f"mpp-cards q3 warm: {misses} pipe misses, {builds} "
                     "builds")
            log(f"[mpp-cards] q3 warm: {dt * 1e3:.3f} ms, pipe misses 0, "
                f"builds 0; {cards}")
        placed = ", ".join(f"cuda:{i} {torch.cuda.memory_allocated(i):,} B"
                           for i in range(n))
        log(f"[mpp-cards] memory allocated on each card (every live "
            f"tensor, SF1's placements among them): {placed} (the ledger's "
            f"placements: {mpp_exec.place_cache_bytes():,} B); {cards}")
        if a2a.best is not None:
            ms, between = exchange_ms(mesh, a2a.best[1])
            log(f"[mpp-cards] the largest exchange of the runs alone "
                f"({a2a.best[0]:,} B of grids, {between:,} B between "
                f"cards): {ms:.3f} ms, every card synchronised before and "
                f"after; {cards}")
        a2a = None
        log(f"[mpp-cards] SF1: {time.perf_counter() - t0:.1f}s")
        for k, per in cards_dist_steps(mesh, seed, cards).items():
            row = launches.setdefault(k, {})
            for card, c in per.items():
                row[card] = row.get(card, 0) + c
        with mpp_exec._PLACE_LOCK:
            mpp_exec._MPP_PLACE_CACHE.clear()
        residency.evict_all("[mpp-cards] SF1 done")
        if n >= 2:
            s10.execute("use tpch10")
            s10.execute("set tidb_mpp_devices = 0")
            s10.execute("set @@tidb_executor_engine = 'tpu-mpp'")
            try:
                with KernelCapture() as cap:
                    for name in ("q1", "q3"):
                        res, dt, by_card, d, xb, between, _m = cards_run(
                            s10, mesh, name, sqls[name], counters, cap,
                            {f"[sf10]'s {sf10_rows[name][1]}":
                             sf10_rows[name][0],
                             "the one-card 8-shard mesh's":
                             mesh10_rows[name][0]}, n, "mpp-cards sf10")
                        log(f"[mpp-cards] sf10 {name}: {dt[0] * 1e3:.3f} / "
                            f"{dt[1] * 1e3:.3f} ms (two timed runs) on "
                            f"{mesh.n} shards ([mpp-sf10]'s 8 shards on one "
                            f"card {mesh10_rows[name][1] * 1e3:.3f} ms); "
                            f"rows equal; {between:,} B between cards; "
                            f"launches by card {by_card}; {cards}")
            finally:
                s10.execute("set @@tidb_executor_engine = 'tpu'")
                with mpp_exec._PLACE_LOCK:
                    mpp_exec._MPP_PLACE_CACHE.clear()
                residency.evict_all("[mpp-cards] SF10 done")
            last_card_session(s, n - 1, host_res, cards)
        else:
            log("[mpp-cards] one card visible: the split layout ran with "
                f"its {ONE_CARD_SHARDS} shards on cuda:0, so copies between "
                "cards and launches on a second card were NOT exercised by "
                f"this run; {cards}")
    finally:
        mpp_exec.set_mesh_devices(None)
        s.execute("set @@tidb_executor_engine = 'tpu'")
        torch.cuda.empty_cache()
    for key, row in report.items():
        row["cards"] = n
        row["launches_by_card"] = launches.get(key, {})


def last_card_session(s, card, host_res, cards):
    """[main]'s Q1 and Q3 on the single-device engine with the engine on
    the last card (``set_device(f"cuda:{card}")``), this thread's device
    set back to 0 first: every launch on that card, rows equal the host
    engine's, engine:tpu on the HashAggs."""
    import torch
    from tidb_tpu_torch.ops import device as pdev
    from tidb_tpu_torch.ops.kernels import build
    sqls = dict(QUERIES)
    pdev.set_device(f"cuda:{card}")
    try:
        s.execute("use tpch")
        s.execute("set @@tidb_executor_engine = 'tpu'")
        for name in ("q1", "q3"):
            torch.cuda.set_device(0)  # launches must not follow the thread
            s.execute(sqls[name])
            build.CARD_LAUNCHES.clear()
            sync_all()
            t0 = time.perf_counter()
            res = s.execute(sqls[name])[-1]
            sync_all()
            dt = time.perf_counter() - t0
            by_card = card_launches()
            ran = {c for per in by_card.values() for c in per}
            if ran != {card}:
                fail(f"mpp-cards last card {name}: kernels ran on cards "
                     f"{sorted(ran)}, not on cuda:{card} alone")
            if not rows_equal(res, host_res[name]):
                fail(f"mpp-cards last card {name}: rows differ from the "
                     "host engine's")
            ex = s.execute("explain analyze " + sqls[name])[-1]
            aggs = [r for r in ex.rows if "HashAgg" in str(r[0])]
            if not aggs or not all(any("engine:tpu" in str(c) for c in r)
                                   for r in aggs):
                fail(f"mpp-cards last card {name}: EXPLAIN ANALYZE shows a "
                     "HashAgg without engine:tpu")
            log(f"[mpp-cards] session on cuda:{card} (the thread's device "
                f"0): {name} {dt * 1e3:.3f} ms, rows equal the host "
                f"engine's, engine:tpu, launches by card {by_card}; {cards}")
    finally:
        # the engine back on the thread's current card, and that card 0
        pdev.set_device("cuda")
        torch.cuda.set_device(0)



def one_card_rows(s, names, sqls):
    """[mpp]'s rows and warm seconds of `names` on the one-card mesh of
    MPP_SHARDS logical shards (for ``--mpp-cards`` alone)."""
    import torch
    from tidb_tpu_torch.executor import mpp_exec
    mpp_exec.set_mesh_devices([torch.device("cuda", 0)])
    s.execute(f"set tidb_mpp_devices = {MPP_SHARDS}")
    s.execute("set @@tidb_executor_engine = 'tpu-mpp'")
    out = {}
    try:
        for name in names:
            if name == "skew":
                s.execute("use skew")
                s.execute("set tidb_broadcast_join_threshold_count = 30")
            try:
                s.execute(sqls[name])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = s.execute(sqls[name])[-1]
                torch.cuda.synchronize()
                out[name] = (res, time.perf_counter() - t0)
            finally:
                if name == "skew":
                    s.execute("set tidb_broadcast_join_threshold_count = "
                              "10240")
    finally:
        with mpp_exec._PLACE_LOCK:
            mpp_exec._MPP_PLACE_CACHE.clear()
        mpp_exec.set_mesh_devices(None)
        s.execute("set @@tidb_executor_engine = 'tpu'")
    return out


def mpp_cards_alone(args):
    """``--mpp-cards``: the ``[mpp-cards]`` phase alone, after what it is
    held to: SF1's tables, the host engine's and the one-card 8-shard
    mesh's rows of [mpp]'s queries, and with two or more cards SF10's
    tables, the resident path's Q1 and Q3 and the one-card mesh's."""
    import torch
    from tidb_tpu_torch import carry
    from tidb_tpu_torch.ops import residency
    from tidb_tpu_torch.session import new_session
    report = {k: {} for k in CARD_FNS}
    phase_build()
    dom, s, _n, keys = phase_sql_setup(args, {}, {})
    del keys
    sqls = dict(QUERIES, shuffle=SHUFFLE_Q, skew=SKEW_Q)
    many = torch.cuda.device_count() >= 2
    names = CARDS_QUERIES if many else ONE_CARD_QUERIES
    if "skew" in names:
        _install_skew(s, dom, args.seed)
    s.execute("set @@tidb_executor_engine = 'host'")
    host = {}
    for name in names:
        s.execute("use skew" if name == "skew" else "use tpch")
        host[name] = s.execute(HOST_TEXT.get(name, sqls[name]))[-1]
    s.execute("use tpch")
    mesh_rows = one_card_rows(s, names, sqls)
    s.execute("use tpch")
    residency.evict_all("--mpp-cards SF1 references")
    s10 = sf10_rows = mesh10_rows = None
    if many:
        t0 = time.perf_counter()
        tables = carry.gen_tpch(SF_BIG, seed=args.seed)
        s10 = new_session(dom)
        carry.install_tpch(s10.execute, dom, "tpch10", tables,
                           analyze=False)
        del tables
        for t in carry.TPCH_TABLES:
            s10.execute(f"analyze table {t}")
        log(f"[mpp-cards] SF10 made, installed and analyzed in "
            f"{time.perf_counter() - t0:.1f}s")
        s10.execute("set @@tidb_executor_engine = 'tpu'")
        s10.execute("set tidb_device_stream_rows = -1")
        sf10_rows = {}
        for name in ("q1", "q3"):
            s10.execute(sqls[name])
            sf10_rows[name] = (s10.execute(sqls[name])[-1], "resident")
        s10.execute("set tidb_device_stream_rows = 0")
        residency.evict_all("--mpp-cards SF10 resident")
        mesh10_rows = one_card_rows(s10, ("q1", "q3"), sqls)
    phase_mpp_cards(s, s10, host, mesh_rows, sf10_rows, mesh10_rows, report,
                    args.seed)
    log(f"[mpp-cards] launches by card of the phase's timed runs: "
        f"{ {k: r['launches_by_card'] for k, r in report.items()} }")


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


def window_bound_ms(ev, outs, scattered=False):
    """Least time of K10 on one window: the sorted order read once; each
    array K10 reads read once through it — a key's data and NULL flags,
    an argument's NULL flags, and its data only where a SUM, MIN or MAX
    reads it (COUNT reads the flags alone) — a random 32-byte sector per
    row for a data array and its own size for a NULL-flag array (one
    byte a row: 8 MiB at 2^23 rows, held in the 50 MB L2); every output
    written once.  Without an order (no keys) the reads are
    sequential.  `scattered`: the outputs' values written to input order
    as random 32-byte sectors, a row's values packed together (a second
    bound, printed beside the first).  Given K10's outputs, the NULL
    flags of the functions that are never NULL are one array, counted
    once; given the plain version's, an array a function (the figure
    the earlier kernel was held to)."""
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
    if scattered and idx is not None:
        moved += (nb * SECTOR * -(-8 * len(outs) // SECTOR)
                  + nbytes([nl for _d, nl in outs]))
    else:
        moved += nbytes([t for pair in outs for t in pair])
    return moved / HBM_BYTES_PER_S * 1e3


def k10_scatter_ms(ev):
    """torch's ``index_put_`` of rows shaped like K10's outputs (its int64
    rows and its NULL-flag rows, ``window_scan.output_layout``) through the
    window's order: what the random row scatter alone costs on this card
    (a yardstick, not the same function; None without an order)."""
    import torch
    from tidb_tpu_torch.ops.kernels import window_scan
    nb, idx = ev["nb"], ev["idx"]
    if idx is None:
        return None
    lay = window_scan.output_layout(window_scan.lane_groups(
        ev["funcs"], [d.is_floating_point() for d, _n in ev["args"]]))
    order = (idx[:nb],)
    rows = torch.zeros((nb, lay["n_data"]), dtype=torch.int64,
                       device=idx.device)
    dst = torch.empty_like(rows)
    ms = cuda_ms(lambda: dst.index_put_(order, rows))
    if lay["n_null"]:
        flags = torch.zeros((nb, lay["n_null"]), dtype=torch.bool,
                            device=idx.device)
        fdst = torch.empty_like(flags)
        ms += cuda_ms(lambda: fdst.index_put_(order, flags))
    return ms


def fetch_cat_ms(outs, n):
    """The device part of ``device_exec._fetch`` on the first `n` rows of
    window outputs (each flattened to int64 and concatenated into one
    buffer), timed with CUDA events: what the outputs' layout costs the
    copy back."""
    import torch

    def flat():
        parts = []
        for pair in outs:
            for t in pair:
                t = t[:n].reshape(-1)
                parts.append(t.view(torch.int64) if t.dtype == torch.float64
                             else t if t.dtype == torch.int64
                             else t.to(torch.int64))
        return torch.cat(parts)
    return cuda_ms(flat)


def check_window_kernel(name, ev, need_trace=True):
    """K10 against its plain version on one window's full inputs, timed
    beside its bound and one torch.cumsum over the same rows; its
    launches and copies counted from the CUDA runtime's calls on the
    host.  `need_trace`: fail too where the device trace records no
    ``ws_scan`` (it records none at SF10's shape, whose launches the
    runtime's calls still count)."""
    import torch
    from tidb_tpu_torch.ops.kernels import window_scan
    out_k, out_p = k10_call(ev), k10_call(ev, plain=True)
    torch.cuda.synchronize()
    err, mag = compare_window(out_k, out_p, ev["funcs"], name)
    ms = cuda_ms(lambda: k10_call(ev))
    plain_ms = cuda_ms(lambda: k10_call(ev, plain=True))
    # the function's outputs as K10 delivers them; the plain version's
    # (a NULL array a function), the earlier kernel's figure, beside it
    bound = window_bound_ms(ev, out_k)
    bound_plain = window_bound_ms(ev, out_p)
    bound_sc = window_bound_ms(ev, out_k, scattered=True)
    cat_k = fetch_cat_ms(out_k, ev["n_live"])
    cat_p = fetch_cat_ms(out_p, ev["n_live"])
    del out_p
    z = ev["keys"][0][0]
    scan_ms = cuda_ms(lambda: torch.cumsum(z, 0))
    scatter = k10_scatter_ms(ev)
    # the launches window_scan.launch_plan counts (a scan and a tail a
    # lane group), at most 3, and no copy; counted from the runtime's
    # calls on the host, the device trace's kernels beside them
    plan = window_scan.launch_plan(ev["nb"], window_scan.lane_groups(
        ev["funcs"], [d.is_floating_point() for d, _n in ev["args"]]))
    prof, runtime = {}, {}
    split = call_split(lambda: k10_call(ev), prof, runtime)
    launches = sum(v for k, v in runtime.items()
                   if k.startswith(RUNTIME_LAUNCH))
    copies = sum(v for k, v in runtime.items() if k.startswith(RUNTIME_COPY))
    want = min(plan["launches"], 3)
    traced = any(k.startswith("ws_scan") for k in prof)
    if launches == 0 or (need_trace and not traced):
        fail(f"K10 {name}: no launch recorded (runtime {runtime}, device "
             f"trace {sorted(prof)}): the launches cannot be counted")
    if (launches > want + 0.01 or copies
            or any(not k.startswith("ws_") for k in prof)):
        fail(f"K10 {name}: {launches:g} launches and {copies:g} copies a "
             f"call (runtime {runtime}); at most {want} launches and no "
             "copy")
    if split[1] < plan["launches"] - 0.01:
        # the device trace missed launches: its sums are short
        split = (None, None, split[2])
    by_name = ", ".join(f"{k.split('(')[0]} {kms:.3f} ms x{ops:g}"
                        for k, (kms, ops) in sorted(prof.items(),
                                                    key=lambda t: -t[1][0]))
    funcs = ", ".join(f for f, _a in ev["funcs"])
    log(f"[K10] {name}: nb={ev['nb']}, n_live={ev['n_live']}, "
        f"{ev['n_part']} partition + {len(ev['keys']) - ev['n_part']} "
        f"order keys, {len(ev['args'])} arguments, functions [{funcs}]: "
        f"max abs err {err!r} (largest |float output| {mag!r}); "
        f"{ms:.3f} ms (plain {plain_ms:.3f} ms, "
        f"bound {bound:.4f} ms (over the plain version's outputs, a NULL "
        f"array a function: {bound_plain:.4f} ms), bound with scattered "
        f"output rows {bound_sc:.4f} ms; one torch.cumsum over the rows "
        f"{scan_ms:.3f} ms; torch index_put_ of its output rows through "
        f"the order {scatter if scatter is None else round(scatter, 3)} "
        f"ms); {split_text(split)}; the runtime's calls {launches:g} "
        f"launches and {copies:g} copies a call (launch_plan "
        f"{plan['launches']})")
    log(f"[K10] {name} by kernel: {by_name or 'nothing recorded'}")
    log(f"[K10] {name} the copy back's concatenation of the "
        f"{ev['n_live']} live rows (device_exec._fetch's device part): "
        f"{cat_k:.3f} ms in K10's row-major layout, {cat_p:.3f} ms in "
        f"contiguous arrays (the plain version's layout, the earlier "
        f"kernel's)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                device_ms=split[0], device_ops_per_call=split[1],
                host_ms=split[2], index_put_ms=scatter,
                fetch_cat_ms=cat_k, fetch_cat_plain_ms=cat_p)


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
        spec = ([k[0] for k in keys], [k[1] for k in keys], ev["descs"],
                [not d for d in ev["descs"]])
        passes = k4_passes(spec, ev["nb"], ev["n_live"], name, report)
        log(f"[K4] window order {name}: nb={ev['nb']}, {len(keys)} keys: "
            f"{k4:.3f} ms (bound {bound:.4f} ms; {passes}){extra}")
        if name == "w2":
            report["sort_topk"].update(window_order_ms=k4,
                                       window_order_bound_ms=bound,
                                       window_order_library_ms=lib_ms)
            k4_split(spec, ev["nb"], ev["n_live"], k4, report)
        else:
            report["sort_topk"][f"window_order_{name}_ms"] = k4
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
    return dev_res["w2"], dev_ms["w2"]


def window_sf10(s, n_rows, supp_counts, report):
    """W2 over the SF10 lineitem on the device (the host engine's window
    over 60M rows does not fit the time budget): K10 against its plain
    version on its inputs, K4's order against torch.sort(stable=True) of
    the packed key (both timed), the result against the generated
    partition sizes, and its time."""
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
    check_window_kernel("w2 (sf10)", ev, need_trace=False)
    lib_ms = check_window_order(ev)
    k2, k4, k10, d2h = window_stage_ms(ev)
    keys = ev["keys"]
    bound = (nbytes([t for k in keys for t in k]) + 8 * ev["nb"]) \
        / HBM_BYTES_PER_S * 1e3
    passes = k4_passes(([k[0] for k in keys], [k[1] for k in keys],
                        ev["descs"], [not d for d in ev["descs"]]),
                       ev["nb"], ev["n_live"], "sf10_w2", report)
    log(f"[K4] window order w2 (sf10): nb={ev['nb']}, {len(keys)} keys: "
        f"{k4:.3f} ms (bound {bound:.4f} ms; {passes}); equal to "
        f"torch.sort(stable=True) of the packed int64 key, {lib_ms:.3f} ms")
    report["sort_topk"].update(window_order_sf10_ms=k4,
                               window_order_sf10_bound_ms=bound,
                               library_ms_sf10_w2_packed=lib_ms)
    del ev, cap, keys
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


# -- the MySQL wire server: the serving path over TCP -------------------------

#: every key of the status page's /status object
STATUS_KEYS = ("version", "connections", "kv_engine", "device_abandoned_calls",
               "device_supervisor", "device_residency", "device_scheduler",
               "device_mpp", "device_compiler", "device_breakers",
               "device_tracing", "device_hybrid_join", "device_fabric",
               "storage_wal")

#: Q1 with its ship-date bound as a prepared statement's parameter
Q1_PREPARED = Q1.replace("'1998-09-02'", "?")

#: Q6 over lineitem_p with its upper bound a DATE literal: the planner
#: prunes the scan to the partition of 1994 (EXPLAIN: partition:p1994)
Q6_PRUNED = Q6.replace("date_add('1994-01-01', interval 1 year)",
                       "'1995-01-01'")

#: MySQL column type codes the wire compares within rtol 1e-9 / atol 1e-12
WIRE_FLOAT_TYPES = (0x04, 0x05)


class WireClient:
    """A minimal MySQL protocol-41 client on the port's packet framing
    (``tidb_tpu_torch/server/packet.py``): a mysql_native_password
    handshake, COM_QUERY with text rows, and COM_STMT_PREPARE /
    COM_STMT_EXECUTE with binary parameters and binary rows.  Rows come
    back as display strings (None for NULL), with each column's type
    code."""

    def __init__(self, port, user="root", password="", db=""):
        import socket
        import struct
        from tidb_tpu_torch.server import protocol as P
        from tidb_tpu_torch.server.packet import PacketIO, read_nul_str
        self.P, self.struct = P, struct
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=600)
        self.io = PacketIO(self.sock)
        pkt = self.io.read_packet()
        if pkt[0] != 10:
            fail(f"wire: handshake protocol {pkt[0]}")
        _ver, pos = read_nul_str(pkt, 1)
        salt = pkt[pos + 4:pos + 12]
        pos += 4 + 9 + 2 + 1 + 2 + 2
        salt_len = pkt[pos]
        pos += 1 + 10
        salt += pkt[pos:pos + max(13, salt_len - 8) - 1]
        caps = (P.CLIENT_PROTOCOL_41 | P.CLIENT_SECURE_CONNECTION
                | P.CLIENT_PLUGIN_AUTH | P.CLIENT_MULTI_RESULTS
                | (P.CLIENT_CONNECT_WITH_DB if db else 0))
        auth = P.native_password_hash(password.encode(), salt[:20])
        out = (struct.pack("<II", caps, 1 << 24) + bytes([255])
               + b"\x00" * 23 + user.encode() + b"\x00"
               + bytes([len(auth)]) + auth)
        if db:
            out += db.encode() + b"\x00"
        self.io.write_packet(out + b"mysql_native_password\x00")
        resp = self.io.read_packet()
        if resp[0] != 0:
            fail(f"wire: authentication refused: {resp[3:]!r}")

    def query(self, sql):
        """('ok', affected) or ('rows', (names, types, rows)); an error
        packet fails the run."""
        self.io.reset_seq()
        self.io.write_packet(bytes([self.P.COM_QUERY]) + sql.encode())
        return self._result(sql, binary=False)

    def rows(self, sql):
        kind, res = self.query(sql)
        if kind != "rows":
            fail(f"wire: no result set from {sql[:60]!r}")
        return res

    def prepare_execute(self, sql, args):
        """Prepare `sql`, execute it once with `args` (int, str, or
        datetime.date as a binary DATE), close it."""
        import datetime
        struct, P = self.struct, self.P
        self.io.reset_seq()
        self.io.write_packet(bytes([P.COM_STMT_PREPARE]) + sql.encode())
        resp = self.io.read_packet()
        if resp[0] != 0:
            fail(f"wire: prepare refused: {resp[3:]!r}")
        sid, n_cols, n_params = struct.unpack_from("<IHH", resp, 1)
        for _ in range(n_params + (1 if n_params else 0)
                       + n_cols + (1 if n_cols else 0)):
            self.io.read_packet()
        out = (bytes([P.COM_STMT_EXECUTE]) + struct.pack("<I", sid)
               + b"\x00" + struct.pack("<I", 1))
        if args:
            out += bytes((len(args) + 7) // 8) + b"\x01"
            types, body = b"", b""
            for a in args:
                if isinstance(a, datetime.date):
                    types += bytes([0x0A, 0])
                    body += bytes([4]) + struct.pack("<HBB", a.year,
                                                     a.month, a.day)
                elif isinstance(a, int):
                    types += bytes([0x08, 0])
                    body += struct.pack("<q", a)
                else:
                    from tidb_tpu_torch.server.packet import lenenc_str
                    types += bytes([0xFE, 0])
                    body += lenenc_str(str(a).encode())
            out += types + body
        self.io.reset_seq()
        self.io.write_packet(out)
        res = self._result(sql, binary=True)
        self.io.reset_seq()
        self.io.write_packet(bytes([P.COM_STMT_CLOSE])
                             + struct.pack("<I", sid))
        return res

    def _result(self, sql, binary):
        from tidb_tpu_torch.server.packet import (read_lenenc_int,
                                                  read_lenenc_str)
        first = self.io.read_packet()
        if first[0] == 0x00:
            return "ok", read_lenenc_int(first, 1)[0]
        if first[0] == 0xFF:
            code = self.struct.unpack_from("<H", first, 1)[0]
            fail(f"wire: error {code} {first[9:].decode()!r} from "
                 f"{sql[:80]!r}")
        ncols = read_lenenc_int(first, 0)[0]
        names, types = [], []
        for _ in range(ncols):
            pkt, pos, vals = self.io.read_packet(), 0, []
            for _f in range(6):
                v, pos = read_lenenc_str(pkt, pos)
                vals.append(v)
            names.append(vals[4].decode())
            types.append(pkt[pos + 1 + 2 + 4])
        if self.io.read_packet()[0] != 0xFE:
            fail("wire: no EOF after the column definitions")
        rows = []
        while True:
            pkt = self.io.read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                break
            rows.append(self._binary_row(pkt, types) if binary
                        else self._text_row(pkt, ncols))
        return "rows", (names, types, rows)

    @staticmethod
    def _text_row(pkt, ncols):
        from tidb_tpu_torch.server.packet import read_lenenc_str
        row, pos = [], 0
        for _ in range(ncols):
            if pkt[pos] == 0xFB:
                row.append(None)
                pos += 1
            else:
                v, pos = read_lenenc_str(pkt, pos)
                row.append(v.decode())
        return tuple(row)

    def _binary_row(self, pkt, types):
        """A binary row as display strings (integers, doubles by repr,
        dates, and every length-encoded type as its text)."""
        from tidb_tpu_torch.server.packet import read_lenenc_str
        struct = self.struct
        nb = (len(types) + 9) // 8
        bitmap, pos, row = pkt[1:1 + nb], 1 + nb, []
        for i, tp in enumerate(types):
            if bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                row.append(None)
                continue
            fixed = {0x01: "<b", 0x02: "<h", 0x03: "<i", 0x08: "<q",
                     0x04: "<f", 0x05: "<d"}.get(tp)
            if fixed is not None:
                v = struct.unpack_from(fixed, pkt, pos)[0]
                pos += struct.calcsize(fixed)
                row.append(repr(v) if tp in WIRE_FLOAT_TYPES else str(v))
            elif tp in (0x07, 0x0A, 0x0C):
                ln = pkt[pos]
                y, mo, d = struct.unpack_from("<HBB", pkt, pos + 1)
                row.append(f"{y:04d}-{mo:02d}-{d:02d}" if ln else
                           "0000-00-00")
                pos += 1 + ln
            else:
                v, pos = read_lenenc_str(pkt, pos)
                row.append(v.decode())
        return tuple(row)

    def close(self):
        try:
            self.io.reset_seq()
            self.io.write_packet(bytes([self.P.COM_QUIT]))
        finally:
            self.sock.close()


def wire_equal(wire, res):
    """Rows over the wire equal a session ``Result``'s: the same column
    types, every cell the same text but in DOUBLE and FLOAT columns,
    which decode and compare within rtol 1e-9 / atol 1e-12."""
    import numpy as np
    _names, types, rows = wire
    if list(types) != [f.tp & 0xFF for f in res.ftypes]:
        return False
    if len(rows) != len(res.rows):
        return False
    for rw, rr in zip(rows, res.rows):
        for vw, vr, tp in zip(rw, rr, types):
            vr = vr.decode() if isinstance(vr, bytes) else vr
            if vw == vr:
                continue
            if (tp not in WIRE_FLOAT_TYPES or vw is None or vr is None
                    or not np.isclose(float(vw), float(vr), rtol=1e-9,
                                      atol=1e-12)):
                return False
    return True


def server_counters():
    from tidb_tpu_torch.ops.kernels import (expr_vm, groupby_agg,
                                            join_expand, join_probe,
                                            sort_topk, window_scan)
    return {"expr_vm": expr_vm.LAUNCHES, "groupby_agg": groupby_agg.LAUNCHES,
            "sort_topk": sort_topk.LAUNCHES,
            "join_probe": join_probe.LAUNCHES,
            "join_expand": join_expand.LAUNCHES,
            "window_scan": window_scan.LAUNCHES}


#: kernels each wire query must launch
_AGG = ["expr_vm", "groupby_agg"]
_JOIN = _AGG + ["sort_topk", "join_probe", "join_expand"]
SERVER_NEED = {"q1": _AGG, "q1_prepared": _AGG, "q3": _JOIN, "q18": _JOIN,
               "w2": ["expr_vm", "sort_topk", "window_scan"],
               "q1_p": _AGG, "q6_p": _AGG, "q6_pruned": _AGG}


def wire_run(c, name, sql, counters, want, ms_in, args=None):
    """One wire query: its rows against `want`, its kernels launched; one
    ``[server]`` line.  Returns its ms over the wire."""
    import datetime
    before = {k: v[0] for k, v in counters.items()}
    t0 = time.perf_counter()
    if args is None:
        kind, res = c.query(sql)
    else:
        kind, res = c.prepare_execute(sql, args)
    dt = (time.perf_counter() - t0) * 1e3
    moved = {k: v[0] - before[k] for k, v in counters.items()}
    if kind != "rows":
        fail(f"[server] {name}: no result set")
    if not wire_equal(res, want):
        fail(f"[server] {name}: wire rows differ from the in-process "
             f"rows:\nwire {res[2][:3]}\nwant {want.rows[:3]}")
    for k in SERVER_NEED[name]:
        if moved[k] <= 0:
            fail(f"[server] {name}: kernel {k} was not launched over the "
                 "wire (degraded to host?)")
    binary = " (binary protocol, DATE parameter)" if args and isinstance(
        args[0], datetime.date) else ""
    log(f"[server] {name}{binary}: {len(res[2])} rows equal; wire "
        f"{dt:.3f} ms, in-process {ms_in[0]:.3f} ms ({ms_in[1]}); "
        f"launches {moved}")
    return dt


def wire_engine_tpu(c, name, sql, op="HashAgg"):
    _n, _t, rows = c.rows("explain analyze " + sql)
    lines = [r for r in rows if op in str(r[0])]
    if not lines or not all(any("engine:tpu" in str(x) for x in r)
                            for r in lines):
        for r in rows:
            log(f"    {r}")
        fail(f"[server] {name}: EXPLAIN ANALYZE over the wire shows a "
             f"{op} without engine:tpu")
    return rows


def phase_server(dom, s, host_res, main_ms, w2, lineitem, report):
    """``[server]``: the port's MySQL server and status server in this
    process over the SF1 tables; the queries over TCP on the device
    engine, their rows against phase 4's and phase 6's, their launches;
    lineitem_p; the status page; the process entry.  Returns Q1's, Q3's,
    Q18's and W2's ms over the wire."""
    import datetime
    import threading
    import urllib.request
    from tidb_tpu_torch import carry
    from tidb_tpu_torch.server import MySQLServer
    from tidb_tpu_torch.server.http_status import StatusServer
    w2_res, w2_ms = w2
    # lineitem_p: one partition a ship year, each bulk-installed on its
    # partition's physical view
    s.execute("use tpch")
    years = ", ".join(f"partition p{y} values less than ({y + 1})"
                      for y in range(1992, 1999))
    s.execute(carry.LINEITEM_DDL.replace("create table lineitem",
                                         "create table lineitem_p")
              + f" partition by range (year(l_shipdate)) ({years}, "
                "partition pmax values less than maxvalue)")
    t0 = time.perf_counter()
    views = carry.install_bulk_numpy(dom, "tpch", "lineitem_p", *lineitem)
    sizes = [v.nrows for v in views]
    if sum(sizes) != lineitem[1]:
        fail(f"[server] lineitem_p holds {sum(sizes)} rows, not "
             f"{lineitem[1]}")
    log(f"[server] lineitem_p: {len(sizes)} partitions of {sizes} rows, "
        f"installed in {time.perf_counter() - t0:.1f}s")
    counters = server_counters()
    srv = MySQLServer(dom, port=0).start()
    status = StatusServer(dom, srv, port=0).start()
    clients = []
    try:
        c = WireClient(srv.port, db="tpch")
        clients.append(c)
        if c.rows("select version()")[2] != [("8.0.11-tpu-htap",)]:
            fail("[server] select version() over the wire")
        c.query("set tidb_executor_engine = 'tpu'")
        for name in ("q1", "q3"):
            wire_engine_tpu(c, name, dict(QUERIES)[name])
        for k in counters.values():
            k[0] = 0
        queries = [("q1", Q1, host_res["q1"], main_ms["q1"]),
                   ("q3", Q3, host_res["q3"], main_ms["q3"]),
                   ("q18", Q18, host_res["q18"], main_ms["q18"]),
                   ("w2", W2, w2_res, w2_ms)]
        wire_ms = {}
        for name, sql, want, ms_in in queries:
            wire_ms[name] = wire_run(
                c, name, sql, counters, want,
                (ms_in, f"phase {6 if name == 'w2' else 4}"))
        wire_run(c, "q1_prepared", Q1_PREPARED, counters, host_res["q1"],
                 (main_ms["q1"], "phase 4, text"),
                 args=[datetime.date(1998, 9, 2)])
        # two connections at once: Q1 on one, Q3 on the other, 3 rounds
        pair = [WireClient(srv.port, db="tpch") for _ in range(2)]
        clients += pair
        for p in pair:
            p.query("set tidb_executor_engine = 'tpu'")
        errors, times = [], {}

        def run(cl, name, sql):
            try:
                t = time.perf_counter()
                for _ in range(3):
                    got = cl.rows(sql)
                    if not wire_equal(got, host_res[name]):
                        errors.append(f"{name}: rows differ")
                times[name] = (time.perf_counter() - t) * 1e3 / 3
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(f"{name}: {type(e).__name__}: {e}")
        before = {k: v[0] for k, v in counters.items()}
        threads = [threading.Thread(target=run, args=(cl, n, dict(QUERIES)[n]))
                   for cl, n in zip(pair, ("q1", "q3"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if errors or any(t.is_alive() for t in threads):
            fail(f"[server] two connections at once: {errors or 'hung'}")
        moved = {k: v[0] - before[k] for k, v in counters.items()}
        for k in _JOIN:
            if moved[k] <= 0:
                fail(f"[server] two connections at once: kernel {k} was "
                     "not launched")
        log(f"[server] two connections at once, Q1 and Q3 3 times each: "
            f"rows equal; wire {times['q1']:.3f} / {times['q3']:.3f} ms a "
            f"query; launches {moved}")
        # lineitem_p on the device engine, against lineitem's rows
        q1_p = Q1.replace("from lineitem", "from lineitem_p")
        q6_p = Q6.replace("from lineitem", "from lineitem_p")
        q6_pruned = Q6_PRUNED.replace("from lineitem", "from lineitem_p")
        plan = c.rows("explain " + q6_pruned)[2]
        scan = [r for r in plan if "TableScan" in str(r[0])]
        if not scan or "partition:p1994" not in " ".join(map(str, scan[0])):
            fail(f"[server] q6_pruned: the scan is not pruned to p1994: "
                 f"{scan}")
        for name, sql, want in (("q1_p", q1_p, "q1"), ("q6_p", q6_p, "q6"),
                                ("q6_pruned", q6_pruned, "q6")):
            wire_engine_tpu(c, name, sql)
            wire_run(c, name, sql, counters, host_res[want],
                     (main_ms[want], "phase 4, over lineitem"))
        log(f"[server] q6_pruned scans {scan[0][-1] if scan else ''}")
        for k, v in counters.items():
            report[k]["launches_server"] = v[0]
        log(f"[server] launches over the wire {dict((k, v[0]) for k, v in counters.items())}")
        # the status page
        with urllib.request.urlopen(f"http://127.0.0.1:{status.port}/status",
                                    timeout=60) as r:
            st = json.loads(r.read().decode())
        missing = [k for k in STATUS_KEYS if k not in st]
        if missing:
            fail(f"[server] /status lacks {missing}")
        cached = st["device_residency"]["hbm_bytes_cached"]
        if cached <= 0:
            fail("[server] /status reports no device-resident bytes")
        log(f"[server] /status: {len(st)} keys, hbm_bytes_cached {cached}, "
            f"device_hybrid_join {st['device_hybrid_join']}, "
            f"device_compiler {st['device_compiler']}")
    finally:
        for cl in clients:
            try:
                cl.close()
            except OSError:
                pass
        status.shutdown()
        srv.shutdown()
    server_process()
    return wire_ms


def server_process():
    """``python -m tidb_tpu_torch.server`` in a process of its own on the
    card: it answers SELECT version() and a device aggregate over a table
    made with SQL there, under engine:tpu, and exits 0 on SIGTERM."""
    import signal
    import socket
    import tempfile
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    err = tempfile.TemporaryFile()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.server", "--port", str(port),
         "--status-port", "-1"], cwd=HERE, stdout=subprocess.DEVNULL,
        stderr=err)
    try:
        c = None
        while c is None:
            if proc.poll() is not None:
                err.seek(0)
                fail(f"[server] the server process exited "
                     f"{proc.returncode}: {err.read().decode()[-2000:]}")
            if time.perf_counter() - t0 > 240:
                fail("[server] the server process did not listen in 240 s")
            try:
                c = WireClient(port)
            except OSError:
                time.sleep(0.5)
        t_up = time.perf_counter() - t0
        try:
            version = c.rows("select version()")[2]
            c.query("create database srv")
            c.query("use srv")
            c.query("create table t (g int, v bigint)")
            c.query("insert into t values " + ",".join(
                f"({i % 7}, {i * 3 - 500})" for i in range(2000)))
            c.query("set tidb_executor_engine = 'tpu'")
            q = "select g, sum(v), count(*) from t group by g order by g"
            wire_engine_tpu(c, "process entry", q)
            got = c.rows(q)[2]
        finally:
            c.close()
        want = [(str(g), str(sum(i * 3 - 500 for i in range(2000)
                                 if i % 7 == g)),
                 str(sum(1 for i in range(2000) if i % 7 == g)))
                for g in range(7)]
        if version != [("8.0.11-tpu-htap",)] or got != want:
            fail(f"[server] the server process answered {version} and "
                 f"{got[:3]}, not {want[:3]}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        if rc != 0:
            err.seek(0)
            fail(f"[server] the server process exited {rc} on SIGTERM: "
                 f"{err.read().decode()[-2000:]}")
        log(f"[server] python -m tidb_tpu_torch.server: listening after "
            f"{t_up:.1f}s, SELECT version() and a device aggregate under "
            "engine:tpu answered, exit 0 on SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()


# -- the serving fleet: two worker processes over one durable store ----------

#: the [fleet] phase's workers and init hook (carry.fleet_seed: the SF1
#: tables in every worker, their KV half and the ledger once, through the
#: shared log)
FLEET_WORKERS = 2
FLEET_INIT = "tidb_tpu_torch.carry:fleet_seed"
#: each worker's tidb_device_mem_budget: this share of the card's free
#: memory when the phase starts (a worker's own auto budget would count
#: the whole card as its own)
FLEET_MEM_SHARE = 0.3
#: bounds of the phase's waits, in seconds
FLEET_BOOT_S = 420.0
FLEET_WAIT_S = 240.0
#: transfers each worker's client must have acknowledged before the kill,
#: and again after the respawn; rounds of Q1 sent to both workers at once
FLEET_TRANSFERS = 30
FLEET_ROUNDS = 3
#: the restored ledger's aggregate
LEDGER_AGG = ("select branch, count(*), sum(bal) from {}.ledger "
              "group by branch order by branch")


def fleet_client(fleet, slot, cache=False):
    """A FleetClient on `slot`'s direct port, db tpch, on the device
    engine, the result cache on or off."""
    from tidb_tpu_torch.fabric.client import FleetClient
    c = FleetClient(fleet.direct_port(slot), db="tpch", timeout=600)
    c.must_exec("set tidb_executor_engine = 'tpu'")
    c.must_exec(f"set tidb_result_cache = '{'ON' if cache else 'OFF'}'")
    return c


def fleet_rows_equal(rows, res):
    """FleetClient's text rows against a session Result, at [server]'s
    tolerance (the text protocol's cells; DOUBLE / FLOAT columns of
    `res` within rtol 1e-9 / atol 1e-12)."""
    return wire_equal((None, [f.tp & 0xFF for f in res.ftypes], rows), res)


def fleet_outcome(c, sql):
    """What served `sql` on this connection, from EXPLAIN ANALYZE over
    the wire: "engine:tpu" when every HashAgg ran on the device, "cache"
    when the fleet's result cache served it; else the run fails."""
    _cols, rows = c.must_query("explain analyze " + sql)
    lines = [" ".join(str(x) for x in r) for r in rows
             if "HashAgg" in str(r[0])]
    if lines and all("engine:tpu" in ln for ln in lines):
        return "engine:tpu"
    if lines and any("engine:cache" in ln for ln in lines):
        return "cache"
    for r in rows:
        log(f"    {r}")
    fail(f"[fleet] {sql[:50]!r}: EXPLAIN ANALYZE over the wire shows a "
         "HashAgg neither on engine:tpu nor served by the cache")


def fleet_boot(label, run_dir, sysvars, env):
    """Start a fleet of FLEET_WORKERS over `run_dir` and time each
    worker's boot; a worker that does not come up fails the run (and the
    fleet is shut down)."""
    import threading
    from tidb_tpu_torch.fabric.fleet import Fleet
    fleet = Fleet(FLEET_WORKERS, init=FLEET_INIT, durable=True,
                  sysvars=sysvars, env_extra=env, run_dir=run_dir)
    err = []

    def start():
        try:
            fleet.start(timeout_s=FLEET_BOOT_S)
        except BaseException as e:  # noqa: BLE001 - reported below
            err.append(e)
    t0 = time.monotonic()
    th = threading.Thread(target=start)
    th.start()
    ready = {}
    while th.is_alive() or len(ready) < FLEET_WORKERS:
        for s in fleet.slots:
            if s.idx not in ready and s.ready.is_set():
                ready[s.idx] = (time.monotonic() - t0,
                                time.monotonic() - s.started_at)
        if not th.is_alive() and (err or len(ready) == FLEET_WORKERS):
            break
        time.sleep(0.02)
    th.join()
    if err:
        fleet.shutdown(drain=False)
        fail(f"[fleet] {label}: the fleet did not start: {err[0]} "
             f"(worker lines: {fleet.lines[-5:]})")
    boot = time.monotonic() - t0
    log(f"[fleet] {label}: {FLEET_WORKERS} workers up in {boot:.1f}s; "
        + "; ".join(f"slot {i} ready at {ready[i][0]:.1f}s, "
                    f"{ready[i][1]:.1f}s after its spawn (pid "
                    f"{fleet.worker_pid(i)})" for i in sorted(ready))
        + f"; compile server pid {fleet.compile_server_proc.pid}")
    return fleet, boot


def compile_server_stats(fleet, label):
    """Log the fleet's compile server's ``stats``; the run fails if the
    server initialised CUDA or answered a request with an error."""
    from tidb_tpu_torch.fabric.compile_client import CompileClient
    st = CompileClient(fleet.compile_server_addr).request({"op": "stats"})
    log(f"[fleet] compile server ({label}): fragment signatures recorded "
        f"{st['compiles']}, dedup {st['dedup_served']}, library builds "
        f"{st['builds']} ({st['build_s']:.3f}s), library artifact hits "
        f"{st['artifact_hits']}, fetches {st['fetches']}, errors "
        f"{st['errors']}, cuda_initialized {st['cuda_initialized']}")
    if st["cuda_initialized"] or st["errors"]:
        fail(f"[fleet] compile server ({label}): {st}")
    return st


#: the run's elapsed seconds before which the server-owned library build
#: runs at its end (a build took 12-22 s on the card; the run's limit is
#: 1200 s)
LIBRARY_BUILD_BEFORE_S = 975.0


def server_library_build(card):
    """One library build owned by a compile server process, into a
    fresh artifact directory: the nvcc build each worker of a fleet on a
    fresh tree would otherwise pay; the library's bytes come back by
    ``fetch`` and match their sha256."""
    import hashlib
    import shutil
    import tempfile
    from tidb_tpu_torch.fabric.compile_client import CompileClient
    from tidb_tpu_torch.ops.kernels import build as kbuild
    d = tempfile.mkdtemp(prefix="chip-smoke-artifacts-")
    sock = os.path.join(d, "compile.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.fabric.compile_server",
         "--socket", sock],
        env={**os.environ, "TIDB_TPU_COMPILE_ARTIFACTS":
             os.path.join(d, "art"), "PYTHONPATH": HERE},
        stdout=subprocess.PIPE, text=True, cwd=HERE)
    try:
        ready = json.loads(proc.stdout.readline() or "{}")
        if ready.get("metric") != "compile_server_ready":
            fail(f"[fleet] compile server did not start: {ready}")
        cli = CompileClient(sock)
        t0 = time.perf_counter()
        resp = cli.request({"op": "compile", "kind": "library",
                            "digest": kbuild._digest()})
        wall = time.perf_counter() - t0
        got = cli.request({"op": "fetch", "key_hash": kbuild._digest()})
        blob = bytes(got["module"])
        if hashlib.sha256(blob).hexdigest() != got["sha256"]:
            fail("[fleet] the fetched library does not match its sha256")
        again = cli.request({"op": "compile", "kind": "library",
                             "digest": kbuild._digest()})
        st = cli.request({"op": "stats"})
        log(f"[fleet] server-owned library build into a fresh artifact "
            f"directory: {resp['build_s']:.3f}s in the server ({wall:.3f}s"
            f" the request), {len(blob)} bytes fetched, sha256 equal; a "
            f"second request built {again['built']}; builds {st['builds']}, "
            f"artifact hits {st['artifact_hits']}, cuda_initialized "
            f"{st['cuda_initialized']} ({card})")
        if not resp["built"] or again["built"] or st["cuda_initialized"]:
            fail(f"[fleet] server-owned library build: {resp} {again} {st}")
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
        shutil.rmtree(d, ignore_errors=True)


def fleet_resident_bytes(fleet):
    """Each slot's device-resident bytes as its residency ledger charges
    them to the segment (the fleet residency hook)."""
    total = fleet.coord.hbm_remote_bytes("default", exclude_slot=-1)
    return {s: total - fleet.coord.hbm_remote_bytes("default", exclude_slot=s)
            for s in range(FLEET_WORKERS)}


class Teller:
    """One client thread of transfers on ``test.ledger`` through one
    worker: each transfer moves an amount between two accounts (locked
    in account order) and logs itself in ``test.transfers``, in one
    transaction.  A transfer whose COMMIT was answered OK is acked; one
    cut by a lost connection is in doubt (the worker died with it); a
    refused one (a lock wait, a conflict) is counted by its error code.
    Every tenth ack, the sum of the balances is read back.  Only a
    client that `may_die` rides out a lost connection (its worker is the
    one the phase kills)."""

    def __init__(self, fleet, slot, seed, total, may_die=False):
        import random
        import threading
        self.fleet, self.slot, self.total = fleet, slot, total
        self.may_die = may_die
        self.rng = random.Random(seed)
        self.acked, self.in_doubt, self.refused = [], [], {}
        self.commit_ms = []
        self.sum_checks = 0
        self.error = None
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _connect(self):
        from tidb_tpu_torch.fabric.client import FleetClient
        c = FleetClient(self.fleet.direct_port(self.slot), db="test",
                        timeout=120)
        c.must_exec("set innodb_lock_wait_timeout = 10")
        return c

    def _transfer(self, c, t):
        tid, src, dst, amt = t
        lo, hi = sorted((src, dst))
        delta = {src: -amt, dst: amt}
        t0 = time.perf_counter()
        for sql in ("begin",
                    f"update ledger set bal = bal + {delta[lo]} "
                    f"where acct = {lo}",
                    f"update ledger set bal = bal + {delta[hi]} "
                    f"where acct = {hi}",
                    f"insert into transfers values ({tid}, {src}, {dst}, "
                    f"{amt})",
                    "commit"):
            kind, payload = c.query(sql)
            if kind == "err":
                c.query("rollback")
                return payload[0]
        self.commit_ms.append((time.perf_counter() - t0) * 1e3)
        return 0

    def _run(self):
        from tidb_tpu_torch import carry
        from tidb_tpu_torch.fabric.client import WireError
        try:
            c = self._connect()
            seq = 0
            while not self.stop.is_set():
                seq += 1
                src, dst = self.rng.sample(range(1, carry.LEDGER_ACCTS + 1),
                                           2)
                t = ((self.slot + 1) * 1_000_000 + seq, src, dst,
                     self.rng.randint(1, 50))
                pid = self.fleet.worker_pid(self.slot)
                acked = False
                try:
                    code = self._transfer(c, t)
                    if code:
                        self.refused[code] = self.refused.get(code, 0) + 1
                        continue
                    self.acked.append(t)
                    acked = True
                    if len(self.acked) % 10 == 0:
                        self._check_sum(c)
                except WireError:
                    # the worker died under this client: a transfer it
                    # had not acked is in doubt; go on against the
                    # respawned worker
                    if not self.may_die:
                        raise
                    if not acked:
                        self.in_doubt.append(t)
                    if not self.fleet.wait_respawn(self.slot, pid,
                                                   FLEET_WAIT_S):
                        raise
                    c = self._connect()
            c.close()
        except BaseException as e:  # noqa: BLE001 - reported by the phase
            self.error = e

    def _check_sum(self, c):
        from tidb_tpu_torch import carry
        got = c.must_query("select sum(bal), count(*) from ledger")[1]
        if got != [(str(self.total), str(carry.LEDGER_ACCTS))]:
            raise AssertionError(
                f"slot {self.slot}: ledger sum / count {got}, not "
                f"{self.total} / {carry.LEDGER_ACCTS}")
        self.sum_checks += 1

    def wait_acked(self, n, what):
        deadline = time.monotonic() + FLEET_WAIT_S
        while len(self.acked) < n:
            if self.error is not None or time.monotonic() > deadline:
                fail(f"[fleet] slot {self.slot}'s client has "
                     f"{len(self.acked)} acked transfers, not {n}, "
                     f"{what}: {self.error!r}")
            time.sleep(0.02)

    def finish(self):
        self.stop.set()
        self.thread.join(FLEET_WAIT_S)
        if self.thread.is_alive():
            fail(f"[fleet] slot {self.slot}'s client hung")
        if self.error is not None:
            fail(f"[fleet] slot {self.slot}'s client: "
                 f"{type(self.error).__name__}: {self.error}")


def check_ledger(fleet, tellers, label):
    """On every worker: the balances keep their sum; every acked
    transfer is in ``transfers``, and nothing but acked and in-doubt
    ones; each account's balance is its seed plus the transfers present.
    Returns the ledger's aggregate by branch (equal on every worker)."""
    from tidb_tpu_torch import carry
    from tidb_tpu_torch.fabric.client import FleetClient
    acked = {t[0]: t for tl in tellers for t in tl.acked}
    doubt = {t[0]: t for tl in tellers for t in tl.in_doubt}
    aggs = []
    for slot in range(FLEET_WORKERS):
        c = FleetClient(fleet.direct_port(slot), db="test", timeout=120)
        try:
            present = {int(r[0]): (int(r[0]), int(r[1]), int(r[2]),
                                   int(r[3]))
                       for r in c.must_query(
                           "select id, src, dst, amt from transfers")[1]}
            bal = {int(a): int(b) for a, b in c.must_query(
                "select acct, bal from ledger")[1]}
            aggs.append(c.must_query(LEDGER_AGG.format("test"))[1])
        finally:
            c.close()
        lost = sorted(set(acked) - set(present))
        if lost:
            fail(f"[fleet] {label}: slot {slot} lacks {len(lost)} acked "
                 f"transfers, e.g. {lost[:5]}")
        extra = sorted(set(present) - set(acked) - set(doubt))
        if extra:
            fail(f"[fleet] {label}: slot {slot} holds transfers no client "
                 f"made: {extra[:5]}")
        want = {a: carry.LEDGER_SEED_BAL
                for a in range(1, carry.LEDGER_ACCTS + 1)}
        for _tid, src, dst, amt in present.values():
            want[src] -= amt
            want[dst] += amt
        if bal != want:
            bad = [a for a in want if bal.get(a) != want[a]]
            fail(f"[fleet] {label}: slot {slot}'s balances disagree with "
                 f"its transfers at {len(bad)} accounts, e.g. "
                 f"{[(a, bal.get(a), want[a]) for a in bad[:3]]}")
        total = sum(bal.values())
        if total != carry.LEDGER_ACCTS * carry.LEDGER_SEED_BAL:
            fail(f"[fleet] {label}: slot {slot}'s balances sum to {total}")
        log(f"[fleet] {label}: slot {slot}: {len(acked)} acked transfers "
            f"all present, {len(set(present) & set(doubt))} of "
            f"{len(doubt)} in doubt present, sum of {len(bal)} balances "
            f"{total}")
    if any(a != aggs[0] for a in aggs):
        fail(f"[fleet] {label}: the workers' ledger aggregates differ")
    return aggs[0]


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _s, names in os.walk(path) for f in names)


def phase_fleet(host_res, server_ms, seed, report):
    """``[fleet]``: two worker processes on the card over one durable
    shared store (``fabric.fleet.Fleet``), serving the SF1 tables over
    the wire; their sharing; a SIGKILL under concurrent transfers and a
    cold restart; BACKUP / RESTORE.

    A Fleet spawns its workers in its own working directory and puts
    that first on their PYTHONPATH, so the phase runs from this
    checkout: the workers import the package this script imports, and
    each drain summary's ``package`` must lie here."""
    prev = os.getcwd()
    os.chdir(HERE)
    try:
        fleet_phase(host_res, server_ms, seed, report)
    finally:
        os.chdir(prev)


def fleet_phase(host_res, server_ms, seed, report):
    import shutil
    import tempfile
    import threading
    import torch
    from tidb_tpu_torch import carry
    from tidb_tpu_torch.fabric.client import FleetClient
    from tidb_tpu_torch.fabric.worker import DEVICE_ENV, LAUNCH_COUNTERS
    from tidb_tpu_torch.ops.kernels import build as kbuild
    t_phase = time.monotonic()
    free, total_mem = torch.cuda.mem_get_info()
    share = int(free * FLEET_MEM_SHARE)
    sysvars = {"tidb_device_mem_budget": str(share)}
    env = {DEVICE_ENV: "cuda", carry.FLEET_SF_ENV: str(SF),
           carry.FLEET_SEED_ENV: str(seed)}
    lib = kbuild.library_path()
    libs_before = {f: os.stat(os.path.join(kbuild.BUILD_DIR, f)).st_mtime_ns
                   for f in os.listdir(kbuild.BUILD_DIR) if f.endswith(".so")}
    if os.path.basename(lib) not in libs_before:
        fail("[fleet] the kernel library is not built before the fleet")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    log(f"[fleet] card {smi.stdout.strip()}; memory free "
        f"{free / 1e9:.3f} of {total_mem / 1e9:.3f} GB; each worker's "
        f"tidb_device_mem_budget {share} bytes ({FLEET_MEM_SHARE} of free)")
    run_dir = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    summaries, tellers = [], []
    fleet = None
    try:
        fleet, boot1 = fleet_boot("boot", run_dir, sysvars, env)
        # -- serving on the card ------------------------------------------
        for slot in range(FLEET_WORKERS):
            c = fleet_client(fleet, slot)
            try:
                for name in ("q1", "q3", "q18"):
                    sql = dict(QUERIES)[name]
                    ms = []
                    for _ in range(2):
                        t0 = time.perf_counter()
                        rows = c.must_query(sql)[1]
                        ms.append((time.perf_counter() - t0) * 1e3)
                        if not fleet_rows_equal(rows, host_res[name]):
                            fail(f"[fleet] slot {slot} {name}: rows differ "
                                 f"from the host engine's:\nwire {rows[:3]}"
                                 f"\nhost {host_res[name].rows[:3]}")
                    if fleet_outcome(c, sql) != "engine:tpu":
                        fail(f"[fleet] slot {slot} {name}: not engine:tpu "
                             "with the result cache off")
                    log(f"[fleet] slot {slot} {name}: {len(rows)} rows equal"
                        f" the host engine's; wire {ms[0]:.3f} ms first "
                        f"(uploads and builds), {ms[1]:.3f} ms again "
                        f"([server] {server_ms[name]:.3f} ms); EXPLAIN "
                        "ANALYZE engine:tpu")
            finally:
                c.close()
        log(f"[fleet] device-resident bytes charged to the segment by slot: "
            f"{fleet_resident_bytes(fleet)}; card memory free "
            f"{torch.cuda.mem_get_info()[0] / 1e9:.3f} GB")
        srv_stats = compile_server_stats(fleet, "after Q1, Q3 and Q18")
        if not srv_stats["compiles"]:
            fail("[fleet] no worker recorded a fragment signature through "
                 "the compile server")
        # -- the fleet's sharing: the result cache and dedup --------------
        q1 = dict(QUERIES)["q1"]
        conns = [fleet_client(fleet, s, cache=True)
                 for s in range(FLEET_WORKERS)]
        try:
            outcomes, got = [], []
            for c in conns:
                outcomes.append(fleet_outcome(c, q1))
                got.append(c.must_query(q1)[1])
            if not all(fleet_rows_equal(r, host_res["q1"]) for r in got):
                fail("[fleet] Q1 with the cache on: rows differ")
            log(f"[fleet] Q1 on slot 0 then slot 1, the cache on: rows "
                f"equal; outcomes {outcomes}")
            ledger_agg = LEDGER_AGG.format("test")
            want_agg = conns[0].must_query(ledger_agg)[1]
            for name, sql, cache in (("Q1", q1, "ON"),
                                     ("the ledger's GROUP BY", ledger_agg,
                                      "OFF")):
                for c in conns:
                    c.must_exec(f"set tidb_result_cache = '{cache}'")
                before = fleet.coord.counters()
                barrier = threading.Barrier(FLEET_WORKERS)
                errors = []

                def run(c, sql=sql):
                    try:
                        for _ in range(FLEET_ROUNDS):
                            barrier.wait(FLEET_WAIT_S)
                            rows = c.must_query(sql)[1]
                            if not (fleet_rows_equal(rows, host_res["q1"])
                                    if sql == q1 else rows == want_agg):
                                errors.append("rows differ")
                    except BaseException as e:  # noqa: BLE001 - below
                        errors.append(f"{type(e).__name__}: {e}")
                ths = [threading.Thread(target=run, args=(c,))
                       for c in conns]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join(FLEET_WAIT_S * FLEET_ROUNDS)
                if errors or any(th.is_alive() for th in ths):
                    fail(f"[fleet] {name} on both workers at once: "
                         f"{errors or 'hung'}")
                after = fleet.coord.counters()
                log(f"[fleet] {name} on both workers at once, "
                    f"{FLEET_ROUNDS} rounds, the cache {cache}: rows equal; "
                    "segment " + ", ".join(
                        f"{k} +{after[k] - before[k]}"
                        for k in ("fabric_dedup_leads", "fabric_dedup_hits",
                                  "fabric_dedup_timeouts",
                                  "fabric_cache_hits")))
        finally:
            for c in conns:
                c.close()
        # -- durability: transfers, a SIGKILL, the respawn -----------------
        c = FleetClient(fleet.direct_port(0), db="test", timeout=120)
        c.must_exec("create table transfers (id bigint primary key, "
                    "src int, dst int, amt int)")
        c.close()
        c = FleetClient(fleet.direct_port(1), db="test", timeout=120)
        try:
            deadline = time.monotonic() + FLEET_WAIT_S
            while c.query("select count(*) from transfers")[0] != "rows":
                if time.monotonic() > deadline:
                    fail("[fleet] slot 1 never saw slot 0's CREATE TABLE")
                time.sleep(0.05)
        finally:
            c.close()
        total = carry.LEDGER_ACCTS * carry.LEDGER_SEED_BAL
        tellers = [Teller(fleet, s, 1000 + s, total, may_die=(s == 1))
                   for s in range(FLEET_WORKERS)]
        # past a multiple of ten: the kill lands in a transfer, not in
        # a client's sum check
        tellers[1].wait_acked(FLEET_TRANSFERS + 5, "before the kill")
        old_pid = fleet.worker_pid(1)
        n0 = len(tellers[0].acked)
        t_kill = time.monotonic()
        fleet.kill_worker(1)
        if not fleet.wait_respawn(1, old_pid, FLEET_WAIT_S):
            fail("[fleet] slot 1 was not respawned after SIGKILL")
        respawn_s = time.monotonic() - t_kill
        survivor = len(tellers[0].acked) - n0
        n1 = len(tellers[1].acked)
        tellers[1].wait_acked(n1 + FLEET_TRANSFERS, "after the respawn")
        tellers[0].wait_acked(n0 + FLEET_TRANSFERS, "after the respawn")
        for tl in tellers:
            tl.finish()
        log(f"[fleet] SIGKILL of slot 1 (pid {old_pid}) under transfers from"
            f" both workers: respawned as pid {fleet.worker_pid(1)} in "
            f"{respawn_s:.1f}s; slot 0 acked {survivor} transfers meanwhile")
        for tl in tellers:
            ms = sorted(tl.commit_ms)
            log(f"[fleet] slot {tl.slot}'s client: {len(tl.acked)} acked, "
                f"{len(tl.in_doubt)} in doubt, refused {tl.refused}, "
                f"{tl.sum_checks} sum checks; a transfer over the wire "
                f"p50 {ms[len(ms) // 2]:.3f} ms, p99 "
                f"{ms[int(len(ms) * 0.99)]:.3f} ms")
        if not tellers[1].in_doubt:
            log("[fleet] (the kill cut no transfer: it landed between two)")
        agg = check_ledger(fleet, tellers, "after the respawn")
        c = fleet_client(fleet, 1)
        try:
            if not fleet_rows_equal(c.must_query(q1)[1], host_res["q1"]):
                fail("[fleet] Q1 on the respawned worker: rows differ")
            if fleet_outcome(c, q1) != "engine:tpu":
                fail("[fleet] Q1 on the respawned worker: not engine:tpu")
        finally:
            c.close()
        log("[fleet] Q1 on the respawned worker: rows equal, engine:tpu")
        drained = fleet.shutdown()
        summaries += [s.summary for s in fleet.slots]
        fleet = None
        if not (drained and drained["ok"]):
            fail(f"[fleet] shutdown: not drained: {drained}")
        log(f"[fleet] shutdown: drained {drained}")
        # -- a cold fleet over the same log --------------------------------
        fleet, boot2 = fleet_boot("cold restart over the same log", run_dir,
                                  sysvars, env)
        if check_ledger(fleet, tellers, "cold restart") != agg:
            fail("[fleet] cold restart: the ledger's aggregate moved")
        for slot in range(FLEET_WORKERS):
            c = fleet_client(fleet, slot)
            try:
                if not fleet_rows_equal(c.must_query(q1)[1], host_res["q1"]):
                    fail(f"[fleet] cold restart: Q1's rows differ on slot "
                         f"{slot}")
                if fleet_outcome(c, q1) != "engine:tpu":
                    fail(f"[fleet] cold restart: Q1 not engine:tpu on slot "
                         f"{slot}")
            finally:
                c.close()
        log("[fleet] cold restart: Q1's rows equal on both workers, "
            "engine:tpu")
        compile_server_stats(fleet, "cold restart")
        # -- BACKUP / RESTORE -------------------------------------------------
        for mode in ("logical", "physical"):
            d = os.path.join(run_dir, f"br-{mode}")
            db = f"ledger_{mode}"
            c = FleetClient(fleet.direct_port(0), db="test", timeout=600)
            try:
                t0 = time.perf_counter()
                c.must_query(f"backup database test to '{d}'"
                             + (" mode physical" if mode == "physical"
                                else ""))
                t_bk = time.perf_counter() - t0
                t0 = time.perf_counter()
                c.must_query(f"restore database {db} from '{d}'")
                t_rs = time.perf_counter() - t0
            finally:
                c.close()
            for slot in range(FLEET_WORKERS):
                c = fleet_client(fleet, slot)
                try:
                    sql = LEDGER_AGG.format(db)
                    if c.must_query(sql)[1] != agg:
                        fail(f"[fleet] {mode} restore: slot {slot}'s ledger "
                             "aggregate differs from the original")
                    if fleet_outcome(c, sql) != "engine:tpu":
                        fail(f"[fleet] {mode} restore: the aggregate is not "
                             f"engine:tpu on slot {slot}")
                finally:
                    c.close()
            log(f"[fleet] {mode} BACKUP of test {t_bk:.3f}s, "
                f"{dir_bytes(d)} bytes; RESTORE as {db} {t_rs:.3f}s; the "
                "restored ledger's GROUP BY equals the original on both "
                "workers, engine:tpu")
        drained = fleet.shutdown()
        summaries += [s.summary for s in fleet.slots]
        fleet = None
        if not (drained and drained["ok"]):
            fail(f"[fleet] cold fleet shutdown: not drained: {drained}")
        # the replay alone: the fleet's log recovered in this process
        from tidb_tpu_torch.kv import wal as wal_mod
        from tidb_tpu_torch.kv.shared_store import DurableMVCCStore
        eng = DurableMVCCStore(wal_mod.WAL(os.path.join(run_dir, "wal")))
        try:
            rec = eng.recover()
        finally:
            eng.close()
        log(f"[fleet] the fleet's log recovered in this process: "
            f"{rec['replayed']} records replayed in {rec['recover_s']:.3f}s"
            f" (from a checkpoint: {rec['from_checkpoint']}, "
            f"{rec['resolved_orphans']} orphans resolved)")
    finally:
        for tl in tellers:
            tl.stop.set()
        if fleet is not None:
            fleet.shutdown(drain=False)
        shutil.rmtree(run_dir, ignore_errors=True)
    libs_after = {f: os.stat(os.path.join(kbuild.BUILD_DIR, f)).st_mtime_ns
                  for f in os.listdir(kbuild.BUILD_DIR) if f.endswith(".so")}
    if libs_after != libs_before:
        fail(f"[fleet] a worker rebuilt the kernel library: {libs_before} -> "
             f"{libs_after}")
    if any(s is None for s in summaries):
        fail("[fleet] a worker that drained printed no summary")
    here_pkg = os.path.realpath(os.path.join(HERE, "tidb_tpu_torch"))
    for s in summaries:
        if os.path.realpath(s.get("package") or "") != here_pkg:
            fail(f"[fleet] slot {s['slot']} (pid {s['pid']}) ran the package "
                 f"at {s.get('package')}, not this checkout's {here_pkg}")
    launches = {k: sum(s["launches"][k] for s in summaries)
                for k in LAUNCH_COUNTERS}
    for s in summaries:
        if not (s["launches"]["expr_vm"] and s["launches"]["groupby_agg"]):
            fail(f"[fleet] slot {s['slot']} (pid {s['pid']}) launched no K1 "
                 f"or K2 on the card: {s['launches']}")
        if s["kernel_build"]["nvcc_runs"]:
            fail(f"[fleet] slot {s['slot']} (pid {s['pid']}) ran nvcc: "
                 f"{s['kernel_build']}")
        log(f"[fleet] slot {s['slot']} pid {s['pid']}: nvcc runs "
            f"{s['kernel_build']['nvcc_runs']}, library from the server "
            f"{s['kernel_build']['from_server']}; compile_persist_hits "
            f"{s['compile'].get('compile_persist_hits', 0)}; signatures "
            f"recorded through the server "
            f"{s['fabric']['fabric_remote_compiles']}, known there "
            f"{s['fabric']['fabric_artifact_hits']}, remote errors "
            f"{s['fabric']['fabric_remote_errors']}")
        log(f"[fleet] drain summary slot {s['slot']} pid {s['pid']}: "
            f"launches {s['launches']}; wal {s.get('wal')}; dedup leads "
            f"{s['fabric']['fabric_dedup_leads']} hits "
            f"{s['fabric']['fabric_dedup_hits']} timeouts "
            f"{s['fabric']['fabric_dedup_timeouts']}; cache hits "
            f"{s['fabric']['cache_hits']}")
    for k in ("expr_vm", "groupby_agg", "sort_topk", "join_probe",
              "join_expand"):
        if launches[k] <= 0:
            fail(f"[fleet] kernel {k} was never launched in a worker")
    for k, n in launches.items():
        report[k]["launches_fleet"] = n
    log(f"[fleet] launches in the workers that drained ({len(summaries)} "
        f"incarnations; the SIGKILLed one's count died with it): {launches}")
    log(f"[fleet] phase {time.monotonic() - t_phase:.1f}s (boots "
        f"{boot1:.1f}s and {boot2:.1f}s, respawn {respawn_s:.1f}s)")


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
        #: the run under way, kept beside the fold it gave (best_tag)
        self.tag = self.best_tag = None

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
                self.best_tag = self.tag
            return out
        merge_states.merge = merge
        return self

    def __exit__(self, *exc):
        from tidb_tpu_torch.ops.kernels import merge_states
        merge_states.merge = self._orig


#: the fold's ms a call in the parent tree's design (a gather of the live
#: slots, then K1's kernels), chip_smoke run A of the fold's redesign on
#: NVIDIA H100 80GB HBM3, 700.00 W; printed beside the new time
RUN_A_MS = {"sf10 q1": 0.6455360054969788, "sf10 q18": 4.749599933624268,
            "hybrid q5": 0.712224006652832,
            "mpp dist_agg_step": 2.9530880451202393}


def check_merge(name, call):
    """The merge kernel against its plain version on one fold of the main
    path, timed beside its bound: the live slots of every part and their
    group counts read once, the merged state written once.  Its launches
    and copies are counted from the CUDA runtime's calls on the host; it
    fails past ``merge_states.launch_plan``'s launches, on a set fault
    word, or with no launch recorded."""
    import torch
    from tidb_tpu_torch.ops.kernels import merge_states
    parts, n_keys, merge_ops, merge_cap, pack = call
    out_k = merge_states.merge(*call)
    out_p = merge_states.merge_plain(*call)
    torch.cuda.synchronize()
    # raises where a part was found out of the fold's order
    ng = merge_states.read_groups(out_k)
    err = compare_agg(out_k, out_p, merge_ops, merge_cap, f"merge {name}")
    # the plain version sums floats with index_add_, whose atomics add in
    # no fixed order, the kernel in part order: bit equality is logged,
    # not required
    lim = min(ng, merge_cap)
    flt = [j for j, r in enumerate(out_k[2]) if r.is_floating_point()]
    bit_equal = sum(torch.equal(out_k[2][j][:lim].view(torch.int64),
                                out_p[2][j][:lim].view(torch.int64))
                    for j in flt)
    ms = cuda_ms(lambda: merge_states.merge(*call))
    plain_ms = cuda_ms(lambda: merge_states.merge_plain(*call))
    live = sum(min(int(p[4]), int(p[0][0].shape[0])) for p in parts)
    slot = 9 * n_keys + 9 * len(merge_ops)  # value 8 B + NULL flag 1 B each
    moved = live * slot + 8 * len(parts) + merge_cap * (slot + 1) + 8
    bound = moved / HBM_BYTES_PER_S * 1e3
    caps = sorted({int(p[0][0].shape[0]) for p in parts})
    plan = merge_states.launch_plan([int(p[0][0].shape[0]) for p in parts],
                                    merge_cap, n_keys, pack)
    prof, runtime = {}, {}
    split = call_split(lambda: merge_states.merge(*call), prof, runtime)
    launches = sum(v for k, v in runtime.items()
                   if k.startswith(RUNTIME_LAUNCH))
    copies = sum(v for k, v in runtime.items() if k.startswith(RUNTIME_COPY))
    if launches == 0:
        fail(f"merge {name}: no launch recorded (runtime {runtime}, device "
             f"trace {sorted(prof)}): the launches cannot be counted")
    if launches > plan + 0.01:
        fail(f"merge {name}: {launches:g} launches a call (runtime "
             f"{runtime}); launch_plan gives {plan}")
    traced = sum(ops for k, (_ms, ops) in prof.items()
                 if not k.startswith(("Memcpy", "Memset")))
    if traced < launches - 0.01:
        # the device trace missed launches: its sums are short
        split = (None, None, split[2])
    by_name = ", ".join(f"{k.split('(')[0]} {kms:.3f} ms x{ops:g}"
                        for k, (kms, ops) in sorted(prof.items(),
                                                    key=lambda t: -t[1][0]))
    run_a = RUN_A_MS.get(name)
    log(f"[merge] {name}: {len(parts)} parts (capacities {caps}), {live} "
        f"live slots -> {ng} groups in {merge_cap} slots, "
        f"pack {pack}: max abs err {err:.3g} ({bit_equal} of {len(flt)} "
        f"float results bit-equal), fault word clear; {ms:.3f} ms ("
        + ("" if run_a is None else f"run A {run_a:.3f} ms; ")
        + f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms); "
        f"{split_text(split)}; "
        f"the runtime's calls {launches:g} launches and {copies:g} copies a "
        f"call (launch_plan {plan})")
    log(f"[merge] {name} by kernel: {by_name or 'nothing recorded'}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                device_ms=split[0], device_ops_per_call=split[1],
                host_ms=split[2], launches_per_call=launches,
                copies_per_call=copies)


def split_folds(seed):
    """The ``[fold-split]`` folds, seeded: {name: (parts, n_keys,
    merge_ops, merge_cap, pack)} on the card, each part a state in the
    fold's order (distinct keys ascending, or K1's own output)."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops.kernels import groupby_agg
    from tidb_tpu_torch.parallel import mpp
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)

    def up(a):
        return torch.from_numpy(a).to(dev)

    q18 = []
    for cap in [1 << 24] + [1 << 22] * 7:
        keys = torch.unique(up(rng.integers(1, 60_000_001, cap * 7 // 8)))
        n = keys.numel()
        k = torch.zeros(cap, dtype=torch.int64, device=dev)
        k[:n] = keys
        nl = torch.zeros(cap, dtype=torch.bool, device=dev)
        q18.append(((k,), (nl,), (up(rng.integers(1, 51, cap)),), (nl,),
                    torch.tensor(n, dtype=torch.int64, device=dev),
                    torch.arange(cap, device=dev) < n))
    mesh = []
    for _s in range(MPP_SHARDS):
        n = 750_000
        mesh.append(mpp._local_state(
            up(rng.integers(1, 6_000_001, n)),
            torch.ones(n, dtype=torch.bool, device=dev),
            [up(rng.integers(1, 51, n)), up(rng.standard_normal(n))],
            ("sum", "max"), 1 << 21))
    q1_ops = ("sum_i", "sum_f", "sum_f", "sum_f", "sum_i", "sum_f", "sum_f",
              "sum_i")
    q1_pack = ((3, 0), (2, 0))
    q1 = []
    for _p in range(15):
        n = 1 << 16
        z = torch.zeros(n, dtype=torch.bool, device=dev)
        vals = tuple(up(rng.standard_normal(n)) if op == "sum_f"
                     else up(rng.integers(0, 50, n)) for op in q1_ops)
        q1.append(groupby_agg.groupby_agg(
            (up(rng.integers(0, 3, n)), up(rng.integers(0, 2, n))), (z, z),
            vals, (z,) * len(q1_ops), ~z, 2, q1_ops, 4096, q1_pack))
    return {"seeded q18": (q18, 1, ("sum_i",), 1 << 24, ((26, -1),)),
            "seeded mesh": (mesh, 1, ("sum_i", "max"), 1 << 21, None),
            "seeded q1": (q1, 2, q1_ops, 4096, q1_pack)}


def fold_split(seed):
    """``--fold-split``: check_merge on :func:`split_folds`, in a process
    that has run nothing else on the card."""
    for name, call in split_folds(seed).items():
        check_merge(name, call)


def phase_fold_split(args):
    """``[fold-split]`` — this script's ``--fold-split`` mode in a child
    process; its lines are relayed, and its failure fails the run."""
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--fold-split",
             "--seed", str(args.seed)], capture_output=True, text=True,
            timeout=600, cwd=HERE)
    except subprocess.TimeoutExpired:
        fail("fold-split: no end within 600 s")
    for line in r.stdout.splitlines():
        log(f"[fold-split] {line}")
    if r.returncode:
        fail(f"fold-split: exit {r.returncode}: {r.stderr[-3000:]}")


#: kernel A's largest partition on ``[mpp]``'s Q3 (the ``[mpp] kernel A on
#: q3's largest partition`` line of the kernel redesign's run A on NVIDIA
#: H100 80GB HBM3, 700.00 W: rows, element size of each column, grid),
#: which ``[exchange-split]`` rebuilds from a seed at each share of valid
#: rows: 0.54, lineitem's rows that Q3's date filter keeps (a shard full
#: of live rows), and 0, the call that line captured (the mesh's last
#: shard, past lineitem's live rows)
EXCHANGE_Q3 = {"rows": 1 << 20, "es": (8, 1, 8, 1, 8, 1, 4, 1),
               "n_dest": 8, "n_sub": 4, "cap": 1 << 16,
               "shares": (0.54, 0.0)}
#: kernel B's shard on the library path's dist_join_agg_step at SF1: the
#: 8 x 4 x 2^16 slot grid after the exchange, orders' and lineitem's valid
#: rows of one shard, one match a probe row
JOIN_SUM_SHARD = {"n": 1 << 21, "valid_build": 187_500,
                  "valid_probe": 750_152}
#: the CUDA runtime's memset calls, by the start of their names
RUNTIME_MEMSET = ("cudaMemset", "cuMemset")
#: the split's ms a call in the parent tree's design (four launches and a
#: fill for kernel A, five launches for kernel B): the first parent-tree
#: call of the split in run B of their redesign, NVIDIA H100 80GB HBM3,
#: 700.00 W; printed beside the new time
PARENT_SPLIT_MS = {"A q3-shape, valid share 0.54": 0.3577,
                   "A q3-shape, valid share 0.0": 0.2532,
                   "A nb=1023": 0.4660, "B int64": 0.2105,
                   "B float64": 0.2147}


def exchange_split_calls(seed):
    """The ``[exchange-split]`` calls, seeded: {name: (kernel, event)},
    events shaped as KernelCapture keeps them."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    dtypes = {8: np.int64, 4: np.int32, 2: np.int16}
    q3 = EXCHANGE_Q3
    m = q3["rows"]
    h = up(rng.integers(-(1 << 63), (1 << 63) - 1, m, dtype=np.int64))
    cols = [up(rng.random(m) < 0.01) if es == 1 else
            up(rng.integers(-10**6, 10**6, m).astype(dtypes[es]))
            for es in q3["es"]]
    grid = dict(n_dest=q3["n_dest"], n_sub=q3["n_sub"], cap=q3["cap"])
    calls = {}
    for share in q3["shares"]:
        calls[f"A q3-shape, valid share {share}"] = ("A", dict(
            grid, h=h, valid=up(rng.random(m) < share), cols=cols))
    share = q3["shares"][0]
    per = int(m * share / 1023 * 1.5)
    calls["A nb=1023"] = ("A", dict(
        h=h, valid=up(rng.random(m) < share), cols=cols, n_dest=1023,
        n_sub=1, cap=1 << per.bit_length()))
    sh = JOIN_SUM_SHARD
    n = sh["n"]
    order = up(rng.permutation(n).astype(np.int64))
    pvalid = np.zeros(n, bool)
    pvalid[rng.choice(n, sh["valid_probe"], replace=False)] = True
    pos0 = rng.integers(0, sh["valid_build"], n)
    cnt = pvalid.astype(np.int64)
    for kind in ("int64", "float64"):
        if kind == "int64":
            bv = rng.integers(1, 500_000_00, n)
            pv = rng.integers(1, 51, n)
        else:
            bv = rng.integers(1, 500_000_00, n) / 100.0
            pv = rng.integers(1, 51, n) / 100.0
        calls[f"B {kind}"] = ("B", dict(
            bv=up(bv), order=order, pos0=up(pos0), cnt=up(cnt), pv=up(pv),
            pvalid=up(pvalid)))
    return calls


def split_call(name, fn, limit, bound):
    """One kernel call split as ``[exchange-split]`` prints it: ms a call,
    host issue ms, device ms by kernel, the runtime's launches, copies
    and memsets a call; fails past `limit` launches (the wrapper's
    ``launch_plan``), on a copy or a memset, or with no launch
    recorded."""
    ms = cuda_ms(fn)
    prof, runtime = {}, {}
    dev_ms, ops, host = call_split(fn, prof, runtime)

    def calls(prefixes):
        return sum(v for k, v in runtime.items() if k.startswith(prefixes))
    launches = calls(RUNTIME_LAUNCH)
    copies = calls(RUNTIME_COPY)
    memsets = calls(RUNTIME_MEMSET)
    if launches == 0:
        fail(f"exchange-split {name}: no launch recorded (runtime "
             f"{runtime}): the launches cannot be counted")
    if launches > limit + 0.01 or copies or memsets:
        fail(f"exchange-split {name}: {launches:g} launches, {copies:g} "
             f"copies, {memsets:g} memsets a call (runtime {runtime}); at "
             f"most {limit} launches and none of the others")
    by_name = ", ".join(f"{k.split('(')[0]} {kms:.4f} ms x{n:g}"
                        for k, (kms, n) in sorted(prof.items(),
                                                  key=lambda t: -t[1][0]))
    parent = PARENT_SPLIT_MS.get(name)
    log(f"{name}: {ms:.4f} ms a call ("
        + ("" if parent is None else f"the parent's {parent:.4f} ms; ")
        + f"bound {bound:.4f} ms, {bound / ms:.1%} of it); device "
        f"{dev_ms:.4f} ms in {ops:g} operations a call, host issue "
        f"{host:.4f} ms; the runtime's calls {launches:g} launches, "
        f"{copies:g} copies, {memsets:g} memsets a call")
    log(f"{name} by kernel: {by_name or 'nothing recorded'}")
    return dict(ms=ms, device_ms=dev_ms, device_ops_per_call=ops,
                host_ms=host, launches_per_call=launches,
                copies_per_call=copies, bound_ms=bound)


def exchange_split(seed):
    """``--exchange-split``: kernels A and B on :func:`exchange_split_calls`
    against their plain versions (A every buffer exact; B int64 exact,
    float64 within rtol 1e-9 and the same bits over three calls), each
    split by :func:`split_call`, in a process that has run nothing else
    on the card.  Prints the figures as one JSON line last."""
    import numpy as np
    import torch
    from tidb_tpu_torch.ops.kernels import radix_exchange as rx
    from tidb_tpu_torch.ops.kernels import shuffle_join as sj
    out = {}
    for name, (kernel, ev) in exchange_split_calls(seed).items():
        if kernel == "A":
            args = (ev["h"], ev["valid"], ev["n_dest"], ev["n_sub"],
                    ev["cap"], ev["cols"])
            got, want = rx.partition(*args), rx.partition_plain(*args)
            same = (all(torch.equal(got[k], want[k])
                        for k in ("rows", "valid"))
                    and all(torch.equal(a.view(torch.uint8),
                                        b.view(torch.uint8))
                            for a, b in zip(got["cols"], want["cols"]))
                    and all(int(got[k]) == int(want[k])
                            for k in ("need", "dropped")))
            if not same:
                fail(f"exchange-split {name}: kernel A differs from its "
                     "plain version")
            log(f"{name}: {ev['h'].shape[0]} rows, columns of "
                f"{[c.element_size() for c in ev['cols']]} bytes, grid "
                f"{ev['n_dest']}x{ev['n_sub']}x{ev['cap']}, need "
                f"{int(got['need'])}, dropped {int(got['dropped'])}: exact")
            plan = rx.launch_plan(ev["h"].shape[0],
                                  ev["n_dest"] * ev["n_sub"], ev["cap"])
            out[name] = split_call(name, lambda: rx.partition(*args),
                                   plan["launches"], exchange_bound_ms(ev))
        else:
            args = (ev["bv"], ev["order"], ev["pos0"], ev["cnt"], ev["pv"],
                    ev["pvalid"])
            runs = [sj.join_sum(*args) for _ in range(3)]
            wt, wp = sj.join_sum_plain(*args)
            total, pairs = runs[0]
            if int(pairs) != int(wp):
                fail(f"exchange-split {name}: pairs {int(pairs)} != plain "
                     f"{int(wp)}")
            if total.is_floating_point():
                if not np.isclose(float(total), float(wt), rtol=1e-9,
                                  atol=1e-12):
                    fail(f"exchange-split {name}: total {float(total)} vs "
                         f"plain {float(wt)}")
                bits = {int(t.view(torch.int64)) for t, _p in runs}
                if len(bits) != 1:
                    fail(f"exchange-split {name}: float totals differ "
                         "across three calls")
            elif int(total) != int(wt):
                fail(f"exchange-split {name}: total {int(total)} != plain "
                     f"{int(wt)}")
            log(f"{name}: {ev['order'].shape[0]} build slots, "
                f"{ev['pos0'].shape[0]} probe slots, {int(pairs)} pairs: "
                + ("exact" if not total.is_floating_point() else
                   f"abs err {abs(float(total) - float(wt)):.3g}, the same "
                   "bits over three calls"))
            plan = sj.launch_plan(ev["order"].shape[0],
                                  ev["pos0"].shape[0])
            out[name] = split_call(name, lambda: sj.join_sum(*args),
                                   plan["launches"], join_sum_bound_ms(ev))
    print(json.dumps({"exchange_split": out}))


def phase_exchange_split(args, report):
    """``[exchange-split]`` — this script's ``--exchange-split`` mode in a
    child process; its lines are relayed, its figures go to the A and B
    rows of the kernels line, and its failure fails the run."""
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--exchange-split",
             "--seed", str(args.seed)], capture_output=True, text=True,
            timeout=600, cwd=HERE)
    except subprocess.TimeoutExpired:
        fail("exchange-split: no end within 600 s")
    got = None
    for line in r.stdout.splitlines():
        if line.startswith('{"exchange_split"'):
            got = json.loads(line)["exchange_split"]
            continue
        log(f"[exchange-split] {line}")
    if r.returncode or got is None:
        fail(f"exchange-split: exit {r.returncode}: {r.stderr[-3000:]}")
    keys = ("device_ms", "device_ops_per_call", "host_ms",
            "launches_per_call", "copies_per_call")
    for row, name in (("radix_exchange", "A q3-shape, valid share "
                                         f"{EXCHANGE_Q3['shares'][0]}"),
                      ("shuffle_join", "B int64")):
        report[row].update({k: got[name][k] for k in keys})
        report[row]["ms_split"] = got[name]["ms"]
        report[row]["bound_ms_split"] = got[name]["bound_ms"]


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
    from tidb_tpu_torch.statistics import analyze
    from tidb_tpu_torch.storage import paged
    is_paged = paged.chunk_is_paged
    for t in carry.TPCH_TABLES:
        if t in SF10_SAMPLED:
            # the run's time cut: ANALYZE samples these as it samples a
            # paged table (analyze.SAMPLE_CAP rows in evenly spaced
            # blocks, the statistics scaled to the table)
            paged.chunk_is_paged = lambda chunk: True
        try:
            s.execute(f"analyze table {t}")
        finally:
            paged.chunk_is_paged = is_paged
    log(f"[sf10] ANALYZE of the eight tables ({', '.join(SF10_SAMPLED)} "
        f"sampled, {analyze.SAMPLE_CAP} rows each): "
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
    rows = {name: check_merge(f"sf10 {name}", folds.pop(name))
            for name in ("q1", "q18")}
    # the row of the larger fold (Q18's), with Q1's many small parts
    # beside it
    merge_row = dict(max(rows.values(), key=lambda r: r["bound_ms"]),
                     max_abs_err=max(
                         [r["max_abs_err"] for r in rows.values()]
                         + [report["merge_states"].get("max_abs_err", 0.0)]))
    merge_row.update({f"{k}_q1": rows["q1"][k] for k in (
        "ms", "plain_ms", "device_ms", "device_ops_per_call", "host_ms")})
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
    window_sf10(s, n, supp_counts, report)
    # the rows [hybrid] and [mpp-sf10] must give: the resident path's,
    # or where it did not run, the streamed rows the host engine confirmed
    return s, {name: (resident[name], "resident") if name in resident
               else (streamed[name], "streamed, = host engine")
               for name in ("q1",) + HYBRID_QUERIES}


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
        report["merge_states"].update(
            ms_hybrid=row["ms"], plain_ms_hybrid=row["plain_ms"],
            bound_ms_hybrid=row["bound_ms"], max_abs_err=max(
                report["merge_states"]["max_abs_err"], row["max_abs_err"]))
    finally:
        s.execute("set global tidb_device_mem_budget = 0")


# -- [faults]: the device-failure path on the card ----------------------------

#: the children's scale factor (cases 3 and 4): SF1's host Q1 alone takes
#: 10-16 s, past the hang case's bound of the fence plus 5 s, and SF0.1's
#: lineitem (600,572 rows) is still above the 65,536-row dispatch floor
FAULT_CHILD_SF = 0.1
#: a child process of the phase is killed after this many seconds
FAULT_CHILD_S = 90.0
#: case 2: the card is kept busy this long while KILL arrives after
#: KILL_AFTER_S
KILL_SLEEP_S = 2.0
KILL_AFTER_S = 0.3
#: case 3: the deadline that fences the card (its bound), and the most a
#: statement after the hang may take beyond it
HANG_TIMEOUT_S = 1.0
HANG_SLACK_S = 5.0
#: case 1: what the ballast leaves free on the card (Q1's upload needs
#: ~380 MB)
OOM_LEFT_FREE = 96 << 20


def sleep_rate():
    """``torch.cuda._sleep`` cycles a second on this card (one timed
    sleep of 5e7 cycles)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    end.synchronize()
    return 50_000_000 / (start.elapsed_time(end) / 1e3)


def trace_events(s, sql):
    """(result, [(event name, tags)]) of one statement run under a trace
    (``tidb_trace_sampling_rate`` 1 for it)."""
    from tidb_tpu_torch.session import tracing
    s.execute("set tidb_trace_sampling_rate = 1")
    try:
        res = s.execute(sql)[-1]
        tr = tracing.last_trace(conn_id=s.conn_id)
    finally:
        s.execute("set tidb_trace_sampling_rate = 0")
    evs = [(name, tags) for sp in (tr.spans if tr else ())
           for _t, name, tags in sp.events]
    return res, evs


def fault_launches():
    from tidb_tpu_torch.ops.kernels import expr_vm, groupby_agg
    return expr_vm.LAUNCHES[0] + groupby_agg.LAUNCHES[0]


def on_card(s, name, sql, host, what):
    """`sql` must run on the card (K2 and K1 launched, ``engine:tpu``)
    with the host engine's rows."""
    import torch
    n0 = fault_launches()
    res = s.execute(sql)[-1]
    torch.cuda.synchronize()
    if fault_launches() <= n0:
        fail(f"[faults] {what}: {name} launched no kernel")
    if not rows_equal(res, host):
        fail(f"[faults] {what}: {name} rows differ from the host "
             f"engine's:\n{res.rows[:3]}\n{host.rows[:3]}")
    plan = s.execute("explain analyze " + sql)[-1]
    if not any("engine:tpu" in str(c) for r in plan.rows
               if "HashAgg" in str(r[0]) for c in r):
        fail(f"[faults] {what}: {name} is not on engine:tpu")
    return fault_launches() - n0


def card_memory() -> str:
    """The card's free memory and this process's allocated and reserved
    bytes, as a phrase of a ``[faults]`` line."""
    import torch
    free, total = torch.cuda.mem_get_info()
    return (f"card free {free / 2**30:.2f} of {total / 2**30:.2f} GiB, this "
            f"process allocated {torch.cuda.memory_allocated() / 2**30:.2f}"
            f" / reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB")


def give_back_card():
    """Drop what this process caches on the card: every cached upload,
    unreachable tensors, the allocator's unused segments."""
    import gc
    import torch
    from tidb_tpu_torch.ops import residency
    residency.evict_all("[faults]")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def fill_card(leave):
    """A ballast that leaves about `leave` bytes for the caching
    allocator to hand out: one tensor of the card's free memory
    (``cudaMemGetInfo``), less a margin, then chunks (halving from 256
    MiB to 1 MiB) into whatever the allocator still finds (the unused
    blocks of its partly used segments, which ``cudaMemGetInfo`` does not
    count as free, and the margin), then the last chunks given back until
    `leave` bytes are.  Returns
    (the ballast's tensors, the bytes the allocator can still hand out:
    the card's free memory and its reserved but unallocated blocks)."""
    import torch
    free = torch.cuda.mem_get_info()[0]
    parts = [torch.empty(max(free - (256 << 20), 0), dtype=torch.uint8,
                         device="cuda")]
    size = 256 << 20
    while size >= 1 << 20:
        try:
            parts.append(torch.empty(size, dtype=torch.uint8,
                                     device="cuda"))
        except torch.OutOfMemoryError:
            size //= 2
    given = 0
    while given < leave and len(parts) > 1:
        given += parts.pop().numel()
    left = (torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
            - torch.cuda.memory_allocated())
    return parts, left


def fault_oom(s, host_res, card):
    """Case 1: a real out-of-memory.  A ballast leaves less free memory
    than Q1's upload needs; Q1 and Q3 walk the OOM ladder (one evict-all
    retry), degrade to the host engine with reason ``device`` and return
    its rows; the ballast freed, Q1 runs on the card again."""
    import torch
    from tidb_tpu_torch.executor.circuit import get_breaker
    from tidb_tpu_torch.ops import residency
    s.execute("set @@tidb_executor_engine = 'tpu'")
    t0 = time.perf_counter()
    residency.evict_all("[faults] case 1")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.mem_get_info()[1]
    # the allocator's unused blocks in partly used segments, which
    # empty_cache cannot give back (an earlier phase's leftovers)
    held = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    ballast, left = fill_card(OOM_LEFT_FREE)
    notes = [f"{left / 2**20:.1f} MiB left of {total / 2**30:.2f} GiB (the "
             f"allocator held {held / 2**20:.1f} MiB unused before the "
             "ballast)"]
    for name in ("q1", "q3"):
        rec0 = residency.snapshot()["hbm_oom_recoveries"]
        t1 = time.perf_counter()
        res, evs = trace_events(s, dict(QUERIES)[name])
        dt = time.perf_counter() - t1
        names = [e for e, _t in evs if e in ("oom_ladder", "host_degraded")]
        # the statement's first device fragment: the ladder's one retry,
        # then the host engine (a later fragment of the same statement,
        # Q3's join match, may fit once the ladder has evicted)
        first = names.index("oom_ladder") if "oom_ladder" in names else -1
        after = [t for e, t in evs if e == "host_degraded"]
        if first < 0 or "host_degraded" not in names[first + 1:] \
                or after[0].get("reason") != "device":
            fail(f"[faults] case 1: {name} under the ballast "
                 f"({left / 2**20:.1f} MiB left): events "
                 f"{[e for e, _t in evs]} (want oom_ladder, then "
                 "host_degraded with reason device)")
        if not rows_equal(res, host_res[name]):
            fail(f"[faults] case 1: {name} rows differ from the host "
                 "engine's")
        recovered = residency.snapshot()["hbm_oom_recoveries"] - rec0
        notes.append(f"{name} events {names}, host_degraded reason "
                     f"{after[0]['reason']}, {recovered} OOM recoveries, "
                     f"{len(res.rows)} rows equal the host engine's in "
                     f"{dt:.3f} s")
    del ballast
    give_back_card()
    notes.append(f"ballast freed ({card_memory()})")
    br = get_breaker(s, shape="agg")
    if br.snapshot()["state"] != "closed":
        time.sleep(br.snapshot()["cooldown_s"] + 0.1)
    t1 = time.perf_counter()
    launched = on_card(s, "q1", Q1, host_res["q1"], "case 1")
    notes.append(f"ballast freed, q1 back on engine:tpu in "
                 f"{(time.perf_counter() - t1) * 1e3:.3f} ms with its "
                 f"EXPLAIN ANALYZE (K2 + K1 launches {launched}, breakers "
                 f"agg {br.snapshot()['state']} / join "
                 f"{get_breaker(s, shape='join').snapshot()['state']})")
    log(f"[faults] case 1 oom ok in {time.perf_counter() - t0:.1f} s: "
        + "; ".join(notes) + f"; {card}")


def fault_kill(s, dom, host_res, rate, card):
    """Case 2: KILL QUERY while the statement's call waits on the card.
    The card is kept busy ~2 s on the engine's stream; Q1 starts under a
    supervisor deadline and a second session kills it after 0.3 s: 1317,
    one kill, no hang and no fence; once the card is free Q1 runs on it
    again with the host engine's rows."""
    import threading
    import torch
    from tidb_tpu_torch.errors import ErrCode, TiDBError
    from tidb_tpu_torch.executor import supervisor
    from tidb_tpu_torch.session import new_session
    s.execute("set @@tidb_executor_engine = 'tpu'")
    s.execute("set tidb_device_call_timeout = 30")
    snap0 = supervisor.snapshot()
    out = {}

    def victim():
        try:
            s.execute(Q1)
            out["code"] = "completed"
        except TiDBError as e:
            out["code"] = e.code
        out["s"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    with torch.cuda.stream(torch.cuda.default_stream()):
        torch.cuda._sleep(int(KILL_SLEEP_S * rate))
    t0 = time.perf_counter()
    th = threading.Thread(target=victim)
    th.start()
    time.sleep(KILL_AFTER_S)
    killer = new_session(dom)
    killer.execute(f"kill query {s.conn_id}")
    th.join(30.0)
    snap1 = supervisor.snapshot()
    moved = {k: snap1[k] - snap0[k] for k in ("kills", "hangs", "fences")}
    if out.get("code") != ErrCode.QueryInterrupted:
        fail(f"[faults] case 2: the killed Q1 gave {out} (want 1317)")
    if moved != {"kills": 1, "hangs": 0, "fences": 0}:
        fail(f"[faults] case 2: supervisor moved {moved} (want one kill, "
             "no hang, no fence)")
    torch.cuda.synchronize()
    deadline = time.monotonic() + 10.0
    while supervisor.abandoned_calls() and time.monotonic() < deadline:
        time.sleep(0.01)
    s.execute("set tidb_device_call_timeout = 0")
    launched = on_card(s, "q1", Q1, host_res["q1"], "case 2")
    log(f"[faults] case 2 kill ok: 1317 after {out['s']:.3f} s (kill sent at "
        f"{KILL_AFTER_S} s, card busy {KILL_SLEEP_S} s), supervisor "
        f"{moved}, abandoned outstanding {supervisor.abandoned_calls()}; "
        f"then q1 on engine:tpu with the host engine's rows (K2 + K1 "
        f"launches {launched}); {card}")


def fault_children(seed, card):
    """Cases 3 and 4, each in a child process killed after at most
    FAULT_CHILD_S: its hung kernel or broken context dies with it."""
    for case in ("hang", "sticky"):
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--fault-child", case, "--seed", str(seed)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            text = proc.communicate(timeout=FAULT_CHILD_S)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            text = proc.communicate()[0]
            fail(f"[faults] case {case}: the child ran past "
                 f"{FAULT_CHILD_S:.0f} s:\n{text[-3000:]}")
        ok = [ln for ln in text.splitlines()
              if ln.startswith(f"[faults] case {case} ok")]
        if proc.returncode != 0 or not ok:
            fail(f"[faults] case {case}: the child exited "
                 f"{proc.returncode}:\n{text[-3000:]}")
        log(f"{ok[0]}; the child process {time.perf_counter() - t0:.1f} s; "
            f"{card}")


def phase_faults(dom, s, host_res, seed, card):
    """``[faults]`` — the device-failure path on the card: a hang and a
    sticky error each in a child process, then a real OOM and a KILL in
    this process on the SF1 tables.  Every case holds its rows to the
    host engine's.  Returns the K2 and K1 launches of this process's
    cases."""
    from tidb_tpu_torch.ops.kernels import expr_vm, groupby_agg
    rate = sleep_rate()
    # the children's tables and kernels need room on the card
    give_back_card()
    log(f"[faults] torch.cuda._sleep: {rate:.4g} cycles/s; before the "
        f"children: {card_memory()}; {card}")
    fault_children(seed, card)
    for c in (expr_vm.LAUNCHES, groupby_agg.LAUNCHES):
        c[0] = 0
    fault_oom(s, host_res, card)
    fault_kill(s, dom, host_res, rate, card)
    counts = {"expr_vm": expr_vm.LAUNCHES[0],
              "groupby_agg": groupby_agg.LAUNCHES[0]}
    log(f"[faults] K2 and K1 launches of cases 1-2: {counts}")
    return counts


def faults_alone(args):
    """``--faults``: the build, the SF1 tables, Q1 and Q3 on the host
    engine for their rows, then ``[faults]``."""
    from tidb_tpu_torch import carry
    from tidb_tpu_torch.session import bootstrap_domain, new_session
    phase_build()
    tables = carry.gen_tpch(SF, seed=args.seed)
    dom = bootstrap_domain()
    s = new_session(dom)
    carry.install_tpch(s.execute, dom, "tpch", tables)
    del tables
    s.execute("set @@tidb_executor_engine = 'host'")
    host_res = {name: s.execute(dict(QUERIES)[name])[-1]
                for name in ("q1", "q3")}
    s.execute("set @@tidb_executor_engine = 'tpu'")
    for name in ("q1", "q3"):
        s.execute(dict(QUERIES)[name])
    phase_faults(dom, s, host_res, args.seed, card_line())


def fault_child(case, seed):
    """A child of ``[faults]``: the TPC-H tables at FAULT_CHILD_SF, the
    host engine's rows of Q1, Q3 and ``left_on``, Q1 on the card, then
    case 3 (``hang``) or case 4 (``sticky``).  Prints one line, ``[faults]
    case <case> ok: ...``, and ends with ``os._exit``: its card is hung or its context broken, and
    nothing may wait on either at exit."""
    import faulthandler
    import torch
    from tidb_tpu_torch import carry
    from tidb_tpu_torch.errors import TiDBError
    from tidb_tpu_torch.executor import supervisor
    from tidb_tpu_torch.ops.kernels import build as kbuild
    from tidb_tpu_torch.session import bootstrap_domain, new_session
    # every thread's stack, should the child stall before it is killed
    faulthandler.dump_traceback_later(FAULT_CHILD_S * 2 / 3, exit=False,
                                      file=sys.stdout)
    t0 = time.perf_counter()
    # read only should the child fail: the parent relays its "ok" line
    log(f"[faults] case {case}: started, {card_memory()}")
    tables = carry.gen_tpch(FAULT_CHILD_SF, seed=seed)
    n = tables["lineitem"][1]
    dom = bootstrap_domain()
    s = new_session(dom)
    carry.install_tpch(s.execute, dom, "tpch", tables)
    del tables
    sqls = dict(QUERIES)
    s.execute("set @@tidb_executor_engine = 'host'")
    host = {name: s.execute(HOST_TEXT.get(name, sqls[name]))[-1]
            for name in ("q1", "q3", "left_on")}
    s.execute("set @@tidb_executor_engine = 'tpu'")
    launched = on_card(s, "q1", Q1, host["q1"], f"case {case}")
    notes = [f"sf {FAULT_CHILD_SF} (lineitem {n} rows) set up in "
             f"{time.perf_counter() - t0:.1f} s, q1 on engine:tpu (K2 + K1 "
             f"launches {launched})"]
    if case == "hang":
        rate = sleep_rate()
        torch.cuda._sleep(int(3600 * rate))   # far longer than the phase
        s.execute(f"set tidb_device_call_timeout = {HANG_TIMEOUT_S}")
        t1 = time.perf_counter()
        try:
            s.execute(Q1)
            fail("[faults] case hang: Q1 on the hung card returned")
        except TiDBError as e:
            if e.code != 9008:
                fail(f"[faults] case hang: Q1 gave {e.code} {e} (want "
                     "9008)")
        notes.append(f"q1 DeviceHangError 9008 after "
                     f"{time.perf_counter() - t1:.3f} s (deadline "
                     f"{HANG_TIMEOUT_S} s)")
        for name in ("q1", "q3"):
            t1 = time.perf_counter()
            res = s.execute(sqls[name])[-1]
            dt = time.perf_counter() - t1
            if not rows_equal(res, host[name]):
                fail(f"[faults] case hang: {name} after the hang: rows "
                     "differ from the host engine's")
            if dt > HANG_TIMEOUT_S + HANG_SLACK_S:
                fail(f"[faults] case hang: {name} after the hang took "
                     f"{dt:.3f} s (bound {HANG_TIMEOUT_S} + "
                     f"{HANG_SLACK_S} s)")
            notes.append(f"{name} after the hang: the host engine's rows "
                         f"in {dt:.3f} s")
    else:
        try:
            x = torch.zeros(4, device="cuda")
            x[torch.tensor([1 << 20], device="cuda")] += 1
            torch.cuda.synchronize()
            fail("[faults] case sticky: the out-of-range index raised "
                 "nothing")
        except SmokeFailure:
            raise
        except Exception as e:  # noqa: BLE001 — the trigger, caught here
            notes.append(f"the trigger's sync raised {type(e).__name__}: "
                         f"{str(e).splitlines()[0]}")
        after = None
        for name in ("q1", "q3", "left_on"):
            t1 = time.perf_counter()
            res = s.execute(sqls[name])[-1]
            dt = time.perf_counter() - t1
            if not rows_equal(res, host[name]):
                fail(f"[faults] case sticky: {name}: rows differ from the "
                     "host engine's")
            total = sum(kbuild.CARD_LAUNCHES.values())
            if after is not None and total != after:
                fail(f"[faults] case sticky: {name} launched "
                     f"{total - after} kernels after the loss")
            if supervisor.device_lost() is not None and after is None:
                after = total
            notes.append(f"{name}: the host engine's rows in {dt:.3f} s, "
                         f"card launches so far {total}")
    snap = supervisor.snapshot()
    if not snap["device_lost"]:
        fail(f"[faults] case {case}: the device is not reported lost: "
             f"{snap}")
    notes.append(f"device lost ({snap['lost_reason']}); supervisor hangs "
                 f"{snap['hangs']}, fences {snap['fences']}, kills "
                 f"{snap['kills']}")
    log(f"[faults] case {case} ok: " + "; ".join(notes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--fold-split", action="store_true",
                    help="only the [fold-split] folds (phase 1c), in this "
                         "process")
    ap.add_argument("--exchange-split", action="store_true",
                    help="only the [exchange-split] calls of kernels A "
                         "and B (phase 1d), in this process")
    ap.add_argument("--k7", action="store_true",
                    help="only the [K7] lines, on SF1-shaped keys made "
                         "with numpy, in this process")
    ap.add_argument("--first-launch", action="store_true",
                    help="only the [first-launch] calls (phase 1e), in "
                         "this process")
    ap.add_argument("--mpp-cards", action="store_true",
                    help="only the [mpp-cards] phase, after the tables "
                         "and rows it is held to (a run on several cards)")
    ap.add_argument("--faults", action="store_true",
                    help="only the build and the [faults] phase, after "
                         "the SF1 tables and the rows it is held to")
    ap.add_argument("--fault-child", choices=("hang", "sticky"),
                    help="one child case of [faults] (the phase starts "
                         "it); its card is left hung or its context "
                         "broken")
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
    if args.fault_child:
        # the child's card is hung or its context broken: exit without
        # waiting on either
        rc = 0
        try:
            fault_child(args.fault_child, args.seed)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", flush=True)
            rc = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    if (args.fold_split or args.exchange_split or args.first_launch
            or args.mpp_cards or args.faults or args.k7):
        try:
            if args.fold_split:
                fold_split(args.seed)
            elif args.k7:
                k7_alone(args.seed)
            elif args.exchange_split:
                exchange_split(args.seed)
            elif args.mpp_cards:
                mpp_cards_alone(args)
            elif args.faults:
                faults_alone(args)
            else:
                first_launch(args.seed)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        return 0
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
        "join_finish": {"name": "K5a finish (a LEFT JOIN's match after its "
                                "ON residual), the epilogue of the "
                                "residual's K2 launch",
                        "route": "cuda",
                        "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                  "expr_vm.cu",
                        "replaces": "tidb_tpu/executor/device_join.py:779",
                        "bound_by": "bytes", "library_ms": None},
        # no one PyTorch call computes an equi-join's pairs
        "join_match": {"name": "K7 join_match (a device index; one probe "
                               "launch on a unique dense build, else K5a's "
                               "count and K5b)",
                       "route": "cuda",
                       "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                 "join_match.cu",
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
        # library_ms: a stable torch.sort of the bucket ids + the gathers
        "radix_exchange": {"name": "A radix_exchange (K11/K12 exchange)",
                           "route": "cuda",
                           "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                     "radix_exchange.cu",
                           "replaces": "tidb_tpu/parallel/mpp.py:250",
                           "bound_by": "bytes", "library_ms": None},
        # no one PyTorch call computes a sort join's range sums (a cumsum
        # and two gathers is the plain version)
        "shuffle_join": {"name": "B shuffle_join (K11 shuffle join sum)",
                         "route": "cuda",
                         "source": "tidb_tpu_torch/ops/kernels/csrc/"
                                   "shuffle_join.cu",
                         "replaces": "tidb_tpu/parallel/mpp.py:325",
                         "bound_by": "bytes", "library_ms": None},
    }
    t_all = time.perf_counter()
    t_phase = [t_all]

    def phase_done(name):
        now = time.perf_counter()
        log(f"[phase] {name}: {now - t_phase[0]:.1f}s")
        t_phase[0] = now
    from tidb_tpu_torch.ops.kernels import build as kbuild
    kbuild.CARD_LAUNCHES = _LaunchTally()
    try:
        lint = lint_start()
        try:
            phase_build()
        except BaseException:
            # the build's error is the run's: the lint's child goes
            lint[0].kill()
            lint[0].wait()
            raise
        declared = lint_finish(*lint)
        phase_done("lint and build")
        phase_fold_split(args)
        phase_done("fold split")
        phase_exchange_split(args, report)
        phase_done("exchange split")
        phase_first_launch(args)
        phase_done("first launch")
        captured, joins = {}, {}
        dom, s, n_rows, keys = phase_sql_setup(args, captured, joins)
        phase_done("sql set-up")
        phase_kernels(args, captured, report)
        phase_join_kernels(args, joins, keys, report)
        supp_counts = keys["supp_counts"]
        lineitem = keys["lineitem"]
        mpp_keys = {k: keys[k] for k in ("l_orderkey", "o_orderkey",
                                         "l_quantity", "o_totalprice")}
        captured.clear()
        joins.clear()
        del keys
        phase_done("kernels")
        host_res, main_ms = phase_main_path(dom, s, n_rows, report)
        phase_done("main path")
        phase_compile(s, host_res, card_line())
        phase_done("compile")
        host_more, mesh_rows = phase_mpp(s, dom, host_res, mpp_keys,
                                         args.seed, report)
        del mpp_keys
        phase_done("mpp")
        w2 = phase_window(s, n_rows, supp_counts, report)
        phase_done("window")
        server_ms = phase_server(dom, s, host_res, main_ms, w2, lineitem,
                                 report)
        del lineitem
        phase_done("server")
        phase_fleet(host_res, server_ms, args.seed, report)
        phase_done("fleet")
        rate = pinned_h2d_rate()
        log(f"[h2d] pinned host -> device copy of 256 MiB: "
            f"{rate / 1e9:.3f} GB/s")
        phase_paged_sf1(args, dom, host_res, rate)
        phase_done("paged-sf1")
        s10, sf10_rows = phase_sf10(args, dom, rate, report)
        phase_done("sf10")
        phase_hybrid(s10, rate, sf10_rows, report)
        phase_done("hybrid")
        mesh10_rows = phase_mpp_sf10(s10, sf10_rows)
        phase_done("mpp-sf10")
        phase_mpp_cards(s, s10, {**host_res, **host_more}, mesh_rows,
                        sf10_rows, mesh10_rows, report, args.seed)
        phase_done("mpp-cards")
        for k, n in phase_faults(dom, s, host_res, args.seed,
                                 card_line()).items():
            report[k]["launches_faults"] = n
        phase_done("faults")
        # last, and only while the run is well inside its time limit: one
        # library build owned by a compile server (~12-22 s)
        if time.perf_counter() - t_all < LIBRARY_BUILD_BEFORE_S:
            server_library_build(card_line())
        else:
            log(f"[fleet] server-owned library build skipped: the run is "
                f"at {time.perf_counter() - t_all:.1f}s, past "
                f"{LIBRARY_BUILD_BEFORE_S:.0f}s")
        phase_done("library build")
        check_launchers(declared)
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
    # K4's row also carries its time at the other main-path shapes (the
    # window's order at W2, W4 and SF10 W2; the mesh's join sort; one
    # float key), torch.sort's time there, and its passes and bits per
    # word at each shape
    extra = ("window_order_ms", "window_order_bound_ms",
             "window_order_library_ms", "window_order_w4_ms",
             "window_order_sf10_ms", "window_order_sf10_bound_ms",
             "library_ms_sf10_w2_packed", "ms_one_key", "library_ms_one_key",
             "ms_join_sort", "join_sort_bound_ms", "library_ms_join_sort",
             "window_order_device_ms", "window_order_host_ms",
             "passes", "bits_per_word",
             # K1, K2 and the fold: one call's device time, device
             # operations and host issue time; K2 at its other shapes and
             # on the wide program, K1 at the top-N and the hot group
             "device_ms", "device_ops_per_call", "host_ms", "ms_q6",
             "ms_topn", "ms_wide", "plain_ms_wide", "bound_ms_wide",
             "ms_hot", "plain_ms_hot", "ms_q1", "plain_ms_q1",
             "device_ms_q1", "device_ops_per_call_q1", "host_ms_q1",
             # K1 over mid-size slot spaces, and with the workspace forced
             *(f"ms_mid_{1 << b}{w}" for b in MID_GROUP_BITS
               for w in ("", "_workspace")),
             # K5a's sorted probe at Q9 and on the mesh's largest shard,
             # K5b's inner expansion against torch.repeat_interleave
             "ms_sorted", "plain_ms_sorted", "bound_ms_sorted",
             "searchsorted_ms", "device_ms_sorted",
             "device_ops_per_call_sorted", "host_ms_sorted", "ms_mesh",
             "plain_ms_mesh", "bound_ms_mesh", "repeat_interleave_ms",
             # K10: torch's index_put_ of rows shaped like its outputs;
             # the copy back's concatenation in its layout and in the
             # plain version's
             "index_put_ms", "fetch_cat_ms", "fetch_cat_plain_ms",
             # the fold on the hybrid join's largest fold and the mesh's
             # (ms_mesh above); its launches and copies a call
             "ms_hybrid", "plain_ms_hybrid", "bound_ms_hybrid",
             "launches_per_call", "copies_per_call",
             # kernels A and B at the [exchange-split] shapes
             "ms_split", "bound_ms_split",
             # the [server] path's launches (counters at 0 before it), and
             # the [fleet] workers' (each worker's counters start at 0)
             "launches_server", "launches_fleet",
             # the visible cards, and [mpp-cards]'s launches by card
             "cards", "launches_by_card",
             # [faults]' launches in this process (its OOM and KILL cases)
             "launches_faults",
             # K5a's finish: the ON residual's K2 launch without the
             # epilogue; K7: its stages' main-path launches and [K7]'s
             # line a layout
             "ms_vm_alone", "device_ms_vm_alone", "host_ms_vm_alone",
             "launches_index", "launches_uniq", "launches_order",
             "layouts")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
        for r in report.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
