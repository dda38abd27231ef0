"""System variable registry (reference: sessionctx/variable/sysvar.go — 248
registered variables; the registry pattern is kept, population grows with the
engine)."""

from __future__ import annotations

from ..errors import TiDBError, ErrCode

SCOPE_NONE = 0
SCOPE_SESSION = 1
SCOPE_GLOBAL = 2
SCOPE_BOTH = 3


class SysVar:
    __slots__ = ("name", "scope", "default", "kind", "min", "max", "choices")

    def __init__(self, name, scope=SCOPE_BOTH, default="", kind="str",
                 vmin=None, vmax=None, choices=None):
        self.name = name
        self.scope = scope
        self.default = default
        self.kind = kind  # str | int | bool | enum | float
        self.min = vmin
        self.max = vmax
        self.choices = choices

    def validate(self, value):
        v = value.decode() if isinstance(value, bytes) else str(value)
        if self.kind == "bool":
            u = v.upper()
            if u in ("ON", "1", "TRUE"):
                return "ON"
            if u in ("OFF", "0", "FALSE"):
                return "OFF"
            raise TiDBError(f"Variable '{self.name}' can't be set to the value of '{v}'")
        if self.kind == "int":
            try:
                i = int(v)
            except ValueError:
                raise TiDBError(f"Incorrect argument type to variable '{self.name}'")
            if self.min is not None and i < self.min:
                i = self.min
            if self.max is not None and i > self.max:
                i = self.max
            return str(i)
        if self.kind == "float":
            import math
            try:
                f = float(v)
            except ValueError:
                raise TiDBError(
                    f"Incorrect argument type to variable '{self.name}'")
            if not math.isfinite(f):
                # nan compares False against any bound, sailing past the
                # clamp — and a NaN cooldown wedges the circuit breaker
                raise TiDBError(
                    f"Variable '{self.name}' can't be set to the value "
                    f"of '{v}'")
            if self.min is not None and f < self.min:
                return str(self.min)
            if self.max is not None and f > self.max:
                return str(self.max)
            return v  # keep the user's spelling (SHOW round-trips)
        if self.kind == "enum":
            if self.choices and v.lower() not in self.choices:
                raise TiDBError(f"Variable '{self.name}' can't be set to the value of '{v}'")
            # store normalized: every reader compares lowercase literals
            # (SET tidb_device_compact = OFF must actually disable it)
            return v.lower()
        return v


_REGISTRY: dict[str, SysVar] = {}


def register(var: SysVar):
    _REGISTRY[var.name] = var


def get_registry():
    return _REGISTRY


for _v in [
    SysVar("autocommit", SCOPE_BOTH, "ON", "bool"),
    SysVar("sql_mode", SCOPE_BOTH, "ONLY_FULL_GROUP_BY,STRICT_TRANS_TABLES,"
           "NO_ZERO_IN_DATE,NO_ZERO_DATE,ERROR_FOR_DIVISION_BY_ZERO,"
           "NO_ENGINE_SUBSTITUTION"),
    SysVar("max_execution_time", SCOPE_BOTH, "0", "int", 0),
    SysVar("max_allowed_packet", SCOPE_BOTH, "67108864", "int", 1024),
    SysVar("time_zone", SCOPE_BOTH, "SYSTEM"),
    SysVar("tx_isolation", SCOPE_BOTH, "REPEATABLE-READ"),
    SysVar("transaction_isolation", SCOPE_BOTH, "REPEATABLE-READ"),
    SysVar("transaction_read_only", SCOPE_BOTH, "0", "bool"),
    SysVar("character_set_client", SCOPE_BOTH, "utf8mb4"),
    SysVar("character_set_connection", SCOPE_BOTH, "utf8mb4"),
    SysVar("character_set_results", SCOPE_BOTH, "utf8mb4"),
    SysVar("collation_connection", SCOPE_BOTH, "utf8mb4_bin"),
    SysVar("names", SCOPE_SESSION, "utf8mb4"),
    SysVar("wait_timeout", SCOPE_BOTH, "28800", "int", 0),
    SysVar("interactive_timeout", SCOPE_BOTH, "28800", "int", 1),
    SysVar("max_connections", SCOPE_GLOBAL, "0", "int", 0, 100000),
    SysVar("version_comment", SCOPE_NONE, "tpu-htap"),
    SysVar("port", SCOPE_NONE, "4000", "int"),
    SysVar("socket", SCOPE_NONE, ""),
    SysVar("datadir", SCOPE_NONE, "/tmp/tpu-htap"),
    SysVar("last_insert_id", SCOPE_SESSION, "0", "int"),
    SysVar("hostname", SCOPE_NONE, "localhost"),
    # engine knobs (the tidb_* namespace of the reference)
    SysVar("tidb_executor_engine", SCOPE_BOTH, "auto", "enum",
           choices=("auto", "host", "tpu", "tpu-mpp")),
    SysVar("tidb_mpp_devices", SCOPE_BOTH, "0", "int", 0),
    # engine tuning knobs (VERDICT r3: hardcoded thresholds must be
    # bench-time tunable): the auto-mode device dispatch row floor
    # 0 = derive the auto-mode dispatch floor from the calibrated cost
    # constants (planner/cost_model.py device_breakeven_rows); a positive
    # value overrides it
    SysVar("tidb_device_dispatch_rows", SCOPE_BOTH, "0", "int", 0),
    # plan-baseline auto capture (reference: bindinfo/handle.go:749)
    SysVar("tidb_capture_plan_baselines", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_mem_quota_query", SCOPE_BOTH, str(1 << 30), "int", 0),
    SysVar("tidb_max_chunk_size", SCOPE_BOTH, "65536", "int", 32),
    SysVar("tidb_snapshot_isolation", SCOPE_BOTH, "ON", "bool"),
    # the fleet's version-stamped fragment result cache
    # (executor/agg_cache.py); OFF pins every agg to a fresh compute —
    # the bench's bit-equality oracle for a delta-folded page
    SysVar("tidb_result_cache", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_build_stats_concurrency", SCOPE_BOTH, "4", "int", 1),
    SysVar("tidb_distsql_scan_concurrency", SCOPE_BOTH, "15", "int", 1),
    SysVar("tidb_executor_concurrency", SCOPE_BOTH, "5", "int", 1),
    SysVar("tidb_txn_mode", SCOPE_BOTH, "pessimistic", "enum",
           choices=("pessimistic", "optimistic")),
    SysVar("tidb_retry_limit", SCOPE_BOTH, "10", "int", 0),
    # prepared-plan cache (reference: planner/core/cache.go; v5 config
    # prepared-plan-cache {enabled, capacity})
    SysVar("tidb_enable_prepared_plan_cache", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_prepared_plan_cache_size", SCOPE_BOTH, "100", "int", 0),
    # TopSQL sampling (reference: tidb_enable_top_sql, default OFF)
    SysVar("tidb_enable_top_sql", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_enable_window_function", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_enable_topn_push_down", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_mesh_shape", SCOPE_BOTH, "1", "str"),
    # streamed device pipeline batch bound: bounds HBM + transfer memory
    # for larger-than-memory inputs at the cost of re-transfer per run
    # (0 = auto: paged inputs and inputs over 4 default pages stream;
    # -1 = resident inputs never stream, the escape hatch that
    # executor/exec_select.py and executor/device_join.py read)
    SysVar("tidb_device_stream_rows", SCOPE_BOTH, "0", "int", -1),
    # shape-canonicalization granularity: geometric row buckets per
    # doubling that device uploads pad to (ops/device.py bucket_rows) so
    # compiled XLA programs are reusable across deltas/tables/scale
    # factors. 2 = powers of sqrt(2) (<=19% padding), 1 = powers of 2,
    # 0 = exact shapes (recompile per row count)
    SysVar("tidb_device_shape_buckets", SCOPE_BOTH, "2", "int", 0, 8),
    # post-join compaction in device fragments: auto = CPU backend only
    SysVar("tidb_device_compact", SCOPE_BOTH, "auto", "enum",
           choices=("auto", "on", "off")),
    SysVar("tidb_slow_log_threshold", SCOPE_BOTH, "300", "int", 0),
    # query-lifecycle span tracing (session/tracing.py): fraction of
    # statements sampled into a full span trace (0 = off, the default —
    # one branch per chokepoint; 1 = every statement).  TRACE statements
    # are always-on regardless of this rate.
    SysVar("tidb_trace_sampling_rate", SCOPE_BOTH, "0", "float", 0, 1),
    SysVar("cte_max_recursion_depth", SCOPE_BOTH, "1000", "int", 0, 4294967295),
    SysVar("tidb_auto_analyze_ratio", SCOPE_GLOBAL, "0.5", "float"),
    SysVar("tidb_enable_auto_analyze", SCOPE_GLOBAL, "ON", "bool"),
    SysVar("tidb_record_plan_in_slow_log", SCOPE_BOTH, "ON", "bool"),
    # write-ahead-log fsync policy (kv/wal.py, durable stores only):
    # `commit` (default) = every commit joins a GROUP fsync before it
    # acks; `interval` = a background flusher fsyncs every ~20ms (a
    # crash loses at most the unsynced window); `never` = OS-buffered
    # only (the fleet still replicates via the log, but a host crash
    # loses the buffer tail).  GLOBAL: the log is process-wide, so a
    # session SET must not weaken durability another session relies on
    SysVar("tidb_wal_fsync", SCOPE_GLOBAL, "commit", "enum",
           choices=("never", "interval", "commit")),
    # MVCC GC (reference: gc_worker.go gcLifeTimeKey/gcRunIntervalKey)
    SysVar("tidb_gc_life_time", SCOPE_GLOBAL, "10m0s"),
    SysVar("tidb_gc_run_interval", SCOPE_GLOBAL, "10m0s"),
    SysVar("tidb_gc_enable", SCOPE_GLOBAL, "ON", "bool"),
    # telemetry is local-only and OFF by default (reference default ON,
    # but this build never egresses)
    SysVar("tidb_enable_telemetry", SCOPE_GLOBAL, "OFF", "bool"),
    # -- MySQL-compat breadth (reference: sysvar.go registers 248;
    #    clients and ORMs read/SET these at connect time) ---------------
    SysVar("auto_increment_increment", SCOPE_BOTH, "1", "int", 1, 65535),
    SysVar("auto_increment_offset", SCOPE_BOTH, "1", "int", 1, 65535),
    SysVar("block_encryption_mode", SCOPE_BOTH, "aes-128-ecb"),
    SysVar("character_set_database", SCOPE_BOTH, "utf8mb4"),
    SysVar("character_set_server", SCOPE_BOTH, "utf8mb4"),
    SysVar("character_set_system", SCOPE_NONE, "utf8mb4"),
    SysVar("collation_database", SCOPE_BOTH, "utf8mb4_bin"),
    SysVar("collation_server", SCOPE_BOTH, "utf8mb4_bin"),
    SysVar("default_week_format", SCOPE_BOTH, "0", "int", 0, 7),
    SysVar("div_precision_increment", SCOPE_BOTH, "4", "int", 0, 30),
    SysVar("foreign_key_checks", SCOPE_BOTH, "OFF", "bool"),
    SysVar("group_concat_max_len", SCOPE_BOTH, "1024", "int", 4),
    SysVar("innodb_lock_wait_timeout", SCOPE_BOTH, "50", "int", 1),
    SysVar("lc_time_names", SCOPE_BOTH, "en_US"),
    SysVar("license", SCOPE_NONE, "Apache License 2.0"),
    SysVar("lower_case_table_names", SCOPE_NONE, "2", "int", 0, 2),
    SysVar("max_sort_length", SCOPE_BOTH, "1024", "int", 4),
    SysVar("net_buffer_length", SCOPE_BOTH, "16384", "int", 1024),
    SysVar("net_read_timeout", SCOPE_BOTH, "30", "int", 1),
    SysVar("net_write_timeout", SCOPE_BOTH, "60", "int", 1),
    SysVar("performance_schema", SCOPE_NONE, "OFF", "bool"),
    SysVar("protocol_version", SCOPE_NONE, "10", "int"),
    SysVar("query_cache_size", SCOPE_GLOBAL, "0", "int", 0),
    SysVar("query_cache_type", SCOPE_BOTH, "OFF", "bool"),
    SysVar("read_only", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("sql_safe_updates", SCOPE_BOTH, "OFF", "bool"),
    SysVar("sql_select_limit", SCOPE_BOTH, str(2**64 - 1), "str"),
    SysVar("system_time_zone", SCOPE_NONE, "UTC"),
    SysVar("table_definition_cache", SCOPE_GLOBAL, "2000", "int", 400),
    SysVar("thread_cache_size", SCOPE_GLOBAL, "9", "int", 0),
    SysVar("tmp_table_size", SCOPE_BOTH, "16777216", "int", 1024),
    SysVar("unique_checks", SCOPE_BOTH, "ON", "bool"),
    SysVar("version", SCOPE_NONE, "8.0.11-tpu-htap"),
    SysVar("version_compile_machine", SCOPE_NONE, "tpu"),
    SysVar("version_compile_os", SCOPE_NONE, "Linux"),
    SysVar("warning_count", SCOPE_SESSION, "0", "int"),
    SysVar("error_count", SCOPE_SESSION, "0", "int"),
    SysVar("default_authentication_plugin", SCOPE_GLOBAL,
           "mysql_native_password"),
    SysVar("init_connect", SCOPE_GLOBAL, ""),
    SysVar("have_openssl", SCOPE_NONE, "DISABLED"),
    SysVar("have_ssl", SCOPE_NONE, "DISABLED"),
    SysVar("max_user_connections", SCOPE_BOTH, "0", "int", 0, 100000),
    SysVar("max_prepared_stmt_count", SCOPE_GLOBAL, "16382", "int", -1),
    SysVar("binlog_format", SCOPE_BOTH, "ROW"),
    SysVar("log_bin", SCOPE_NONE, "OFF", "bool"),
    SysVar("timestamp", SCOPE_SESSION, "0"),
    SysVar("profiling", SCOPE_BOTH, "OFF", "bool"),
    SysVar("optimizer_switch", SCOPE_BOTH, "index_merge=on"),
    # -- tidb_* engine knobs (reference names, same semantics) ----------
    SysVar("tidb_allow_batch_cop", SCOPE_BOTH, "1", "int", 0, 2),
    SysVar("tidb_allow_mpp", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_auto_analyze_start_time", SCOPE_GLOBAL, "00:00 +0000"),
    SysVar("tidb_auto_analyze_end_time", SCOPE_GLOBAL, "23:59 +0000"),
    SysVar("tidb_backoff_weight", SCOPE_BOTH, "2", "int", 1),
    # -- resilience layer (utils/backoff.py + executor/circuit.py) ------
    # classified device failures before the device→host breaker OPENs
    # (0 disables the breaker entirely)
    SysVar("tidb_device_circuit_threshold", SCOPE_BOTH, "5", "int", 0,
           10000),
    # seconds the breaker stays OPEN before a HALF_OPEN probe fragment
    SysVar("tidb_device_circuit_cooldown", SCOPE_BOTH, "30", "float", 0),
    # hard wall-clock deadline (seconds) for ONE device call through the
    # supervisor (executor/supervisor.py): expiry raises DeviceHangError
    # (errno 9008), abandons the call, fences/reinitializes the backend
    # and counts toward the circuit breaker. 0 = unsupervised inline
    # dispatch (the remaining max_execution_time window still supervises,
    # but ITS expiry is QueryInterrupted — a user limit, not a hang).
    # Set it ABOVE the workload's worst-case cold-compile time: off-CPU
    # the deadline covers compilation, and a too-small value re-fences
    # (re-colds) the very compile it then times out again
    SysVar("tidb_device_call_timeout", SCOPE_BOTH, "0", "float", 0),
    # HBM residency budget in BYTES (ops/residency.py): cached device
    # uploads (Column._device, join-leaf dcols) are byte-accounted against
    # it and evicted LRU-first under pressure. 0 = auto: the jax-reported
    # device memory limit off-CPU, unlimited on the in-process CPU
    # backend (host RAM is governed by tidb_mem_quota_query/MemTracker).
    # Read from GLOBAL scope (SET GLOBAL), same discipline as the
    # breaker knobs: the ledger is process-wide, so a session-scoped SET
    # must not clobber the budget another session configured
    SysVar("tidb_device_mem_budget", SCOPE_BOTH, "0", "int", 0),
    # -- serving front end (executor/scheduler.py) ----------------------
    # the session's tenant identity for device admission, WFQ scheduling,
    # per-tenant residency shares and breaker/scheduler stat lines
    SysVar("tidb_resource_group", SCOPE_SESSION, "default", "str"),
    # bounded fragment-admission queue depth (total queued tickets across
    # all tenants); a full queue refuses admission with a classified
    # DeviceAdmissionError (9009) and the fragment degrades to the host
    # engine. 0 disables the admission layer entirely (pass-through).
    # GLOBAL-scope read, same discipline as the breaker/residency knobs
    SysVar("tidb_device_sched_queue_depth", SCOPE_BOTH, "64", "int", 0,
           100000),
    # seconds a fragment may wait in the admission queue before the
    # refusal (9009) degrades it to the host engine; 0 = wait forever
    SysVar("tidb_device_admission_timeout", SCOPE_BOTH, "5", "float", 0),
    # max fragments of ONE resource group running on the device at once
    # (0 = unlimited): a heavy analytical tenant cannot occupy every slot
    SysVar("tidb_device_tenant_running_cap", SCOPE_BOTH, "4", "int", 0,
           10000),
    # WFQ weights, "group:weight,group2:weight" (unlisted groups weigh 1):
    # each grant advances the tenant's virtual clock by 1/weight, lowest
    # clock goes next — heavier tenants get proportionally more slots
    SysVar("tidb_device_wfq_weights", SCOPE_BOTH, "", "str"),
    # -- compile service (executor/compile_service.py) ------------------
    # ON: a cold compiled-pipeline cache miss submits the fragment
    # signature to the background compile pool and THIS execution serves
    # from the host engine (no breaker charge) — first-query latency is
    # bounded by host speed, never by XLA; when the executable lands,
    # same-shaped queries flip to the device with zero new traces.
    # OFF (default): cache misses compile inline as before (still
    # breaker-guarded + persisted through the compile service)
    SysVar("tidb_compile_async", SCOPE_BOTH, "OFF", "bool"),
    # SET GLOBAL ... = ON kicks a background prewarm of every registered
    # fragment recipe's bucket ladder, immediately and on any later
    # Domain start in this process (globals are in-memory, so the SET is
    # when the intent exists; see ADMIN COMPILE for the waiting form)
    SysVar("tidb_compile_prewarm", SCOPE_BOTH, "OFF", "bool"),
    # background compile worker threads (process-wide pool, GLOBAL-scope
    # read: a session SET must not resize the shared pool)
    SysVar("tidb_compile_workers", SCOPE_BOTH, "2", "int", 1, 64),
    # wall-clock deadline (seconds) for ONE background compile attempt,
    # enforced by the device-runtime supervisor: a hung remote compile is
    # abandoned + fenced like any device hang, then retried on the
    # compileRetry curve. 0 = no deadline (the default: CPU-backend
    # builds are in-process and cannot tunnel-hang)
    SysVar("tidb_compile_timeout", SCOPE_BOTH, "0", "float", 0),
    SysVar("tidb_broadcast_join_threshold_size", SCOPE_BOTH,
           str(100 * 1024 * 1024), "int", 0),
    SysVar("tidb_broadcast_join_threshold_count", SCOPE_BOTH,
           str(10 * 1024), "int", 0),
    SysVar("tidb_checksum_table_concurrency", SCOPE_BOTH, "4", "int", 1),
    SysVar("tidb_constraint_check_in_place", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_current_ts", SCOPE_SESSION, "0", "int"),
    SysVar("tidb_ddl_error_count_limit", SCOPE_GLOBAL, "512", "int", 0),
    SysVar("tidb_ddl_reorg_batch_size", SCOPE_GLOBAL, "256", "int", 32),
    SysVar("tidb_ddl_reorg_worker_cnt", SCOPE_GLOBAL, "4", "int", 1),
    SysVar("tidb_disable_txn_auto_retry", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_enable_cascades_planner", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_enable_chunk_rpc", SCOPE_SESSION, "ON", "bool"),
    SysVar("tidb_enable_clustered_index", SCOPE_BOTH, "INT_ONLY"),
    SysVar("tidb_enable_collect_execution_info", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_enable_fast_analyze", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_enable_index_merge", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_enable_noop_functions", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_enable_parallel_apply", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_enable_slow_log", SCOPE_GLOBAL, "ON", "bool"),
    SysVar("tidb_enable_stmt_summary", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_enable_table_partition", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_enable_vectorized_expression", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_force_priority", SCOPE_SESSION, "NO_PRIORITY"),
    SysVar("tidb_general_log", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_hash_join_concurrency", SCOPE_BOTH, "5", "int", 1),
    SysVar("tidb_window_concurrency", SCOPE_BOTH, "4", "int", 1),
    # rows below which ShuffleExec-style host parallelism is skipped
    SysVar("tidb_shuffle_min_rows", SCOPE_BOTH, "8192", "int", 0),
    SysVar("tidb_hashagg_final_concurrency", SCOPE_BOTH, "5", "int", 1),
    SysVar("tidb_hashagg_partial_concurrency", SCOPE_BOTH, "5", "int", 1),
    SysVar("tidb_index_join_batch_size", SCOPE_BOTH, "25000", "int", 1),
    SysVar("tidb_index_lookup_concurrency", SCOPE_BOTH, "4", "int", 1),
    SysVar("tidb_index_lookup_size", SCOPE_BOTH, "20000", "int", 1),
    SysVar("tidb_index_serial_scan_concurrency", SCOPE_BOTH, "1", "int", 1),
    SysVar("tidb_init_chunk_size", SCOPE_BOTH, "32", "int", 1, 32),
    SysVar("tidb_isolation_read_engines", SCOPE_SESSION, "tpu,host"),
    SysVar("tidb_low_resolution_tso", SCOPE_SESSION, "OFF", "bool"),
    SysVar("tidb_max_delta_schema_count", SCOPE_GLOBAL, "1024", "int", 100),
    SysVar("tidb_mem_oom_action", SCOPE_GLOBAL, "CANCEL", "enum",
           choices=("cancel", "log")),
    SysVar("tidb_mem_quota_apply_cache", SCOPE_BOTH,
           str(32 << 20), "int", 0),
    SysVar("tidb_opt_agg_push_down", SCOPE_BOTH, "OFF", "bool"),
    # calibrated cost-model constants (planner/cost_model.py): one
    # currency for access-path, join-variant and engine-placement choice;
    # apply_calibration() overwrites the globals with measured values
    # (reference: the tidb_opt_*_factor family, sessionctx/variable)
    SysVar("tidb_opt_scan_row_cost", SCOPE_BOTH, "1.0", "float"),
    SysVar("tidb_opt_seek_cost", SCOPE_BOTH, "8.0", "float"),
    SysVar("tidb_opt_seek_base", SCOPE_BOTH, "30.0", "float"),
    SysVar("tidb_opt_hash_build_cost", SCOPE_BOTH, "2.0", "float"),
    SysVar("tidb_opt_merge_sort_cost", SCOPE_BOTH, "0.05", "float"),
    SysVar("tidb_opt_agg_row_cost", SCOPE_BOTH, "2.0", "float"),
    SysVar("tidb_opt_device_row_cost", SCOPE_BOTH, "0.02", "float"),
    SysVar("tidb_opt_device_dispatch_cost", SCOPE_BOTH, "195000.0",
           "float"),
    SysVar("tidb_opt_correlation_threshold", SCOPE_BOTH, "0.9", "float"),
    # reference cost-factor family (sessionctx/variable/sysvar.go) — kept
    # alongside the calibrated tidb_opt_*_cost constants for SQL compat
    SysVar("tidb_opt_cpu_factor", SCOPE_BOTH, "3.0", "float"),
    SysVar("tidb_opt_copcpu_factor", SCOPE_BOTH, "3.0", "float"),
    SysVar("tidb_opt_scan_factor", SCOPE_BOTH, "1.5", "float"),
    SysVar("tidb_opt_desc_factor", SCOPE_BOTH, "3.0", "float"),
    SysVar("tidb_opt_seek_factor", SCOPE_BOTH, "20.0", "float"),
    SysVar("tidb_opt_memory_factor", SCOPE_BOTH, "0.001", "float"),
    SysVar("tidb_opt_disk_factor", SCOPE_BOTH, "1.5", "float"),
    SysVar("tidb_opt_network_factor", SCOPE_BOTH, "1.0", "float"),
    SysVar("tidb_opt_concurrency_factor", SCOPE_BOTH, "3.0", "float"),
    SysVar("tidb_opt_tiflash_concurrency_factor", SCOPE_BOTH, "24.0",
           "float"),
    SysVar("tidb_opt_correlation_exp_factor", SCOPE_BOTH, "1", "int", 0),
    SysVar("tidb_opt_enable_correlation_adjustment", SCOPE_BOTH, "ON",
           "bool"),
    SysVar("tidb_opt_limit_push_down_threshold", SCOPE_BOTH, "100", "int",
           0),
    SysVar("tidb_opt_prefer_range_scan", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_opt_broadcast_join", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_opt_broadcast_cartesian_join", SCOPE_BOTH, "1", "int", 0,
           2),
    SysVar("tidb_opt_mpp_outer_join_fixed_build_side", SCOPE_BOTH, "OFF",
           "bool"),
    SysVar("tidb_optimizer_selectivity_level", SCOPE_SESSION, "0", "int",
           0),
    SysVar("tidb_regard_null_as_point", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_opt_distinct_agg_push_down", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_opt_insubq_to_join_and_agg", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_opt_join_reorder_threshold", SCOPE_BOTH, "0", "int", 0, 63),
    SysVar("tidb_opt_write_row_id", SCOPE_SESSION, "OFF", "bool"),
    SysVar("tidb_projection_concurrency", SCOPE_BOTH, "-1", "int", -1),
    # breadth batch (reference sessionctx/variable/sysvar.go, matching
    # scopes/defaults; consumed where the engine has the corresponding
    # subsystem, SELECT/SET-compatible knobs otherwise)
    SysVar("allow_auto_random_explicit_insert", SCOPE_BOTH, "OFF", "bool"),
    SysVar("ddl_slow_threshold", SCOPE_GLOBAL, "300", "int", 0),
    SysVar("identity", SCOPE_SESSION, "0", "int"),
    SysVar("last_plan_from_binding", SCOPE_SESSION, "OFF", "bool"),
    SysVar("last_plan_from_cache", SCOPE_SESSION, "OFF", "bool"),
    SysVar("plugin_dir", SCOPE_GLOBAL, "/data/deploy/plugin", "str"),
    SysVar("plugin_load", SCOPE_GLOBAL, "", "str"),
    SysVar("rand_seed1", SCOPE_SESSION, "0", "int", 0),
    SysVar("rand_seed2", SCOPE_SESSION, "0", "int", 0),
    SysVar("skip_name_resolve", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_allow_fallback_to_tikv", SCOPE_BOTH, "", "str"),
    SysVar("tidb_allow_function_for_expression_index", SCOPE_GLOBAL,
           "json_extract, lower, md5, reverse, upper", "str"),
    SysVar("tidb_allow_remove_auto_inc", SCOPE_SESSION, "OFF", "bool"),
    SysVar("tidb_analyze_version", SCOPE_BOTH, "2", "int", 1, 2),
    SysVar("tidb_backoff_lock_fast", SCOPE_BOTH, "10", "int", 1),
    SysVar("tidb_batch_commit", SCOPE_SESSION, "OFF", "bool"),
    SysVar("tidb_batch_delete", SCOPE_SESSION, "OFF", "bool"),
    SysVar("tidb_batch_insert", SCOPE_SESSION, "OFF", "bool"),
    SysVar("tidb_check_mb4_value_in_utf8", SCOPE_GLOBAL, "ON", "bool"),
    SysVar("tidb_config", SCOPE_SESSION, "", "str"),
    SysVar("tidb_ddl_reorg_priority", SCOPE_SESSION, "PRIORITY_LOW",
           "str"),
    SysVar("tidb_dml_batch_size", SCOPE_BOTH, "0", "int", 0),
    SysVar("tidb_enable_1pc", SCOPE_GLOBAL, "ON", "bool"),
    SysVar("tidb_enable_amend_pessimistic_txn", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_enable_async_commit", SCOPE_GLOBAL, "ON", "bool"),
    SysVar("tidb_enable_auto_increment_in_generated", SCOPE_BOTH, "OFF",
           "bool"),
    SysVar("tidb_enable_change_multi_schema", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_enable_column_tracking", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_enable_exchange_partition", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_enable_extended_stats", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_enable_historical_stats", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_enable_index_merge_join", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_enable_list_partition", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_enable_ordered_result_mode", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_enable_paging", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_enable_pipelined_window_function", SCOPE_BOTH, "ON",
           "bool"),
    SysVar("tidb_enable_point_get_cache", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_enable_pseudo_for_outdated_stats", SCOPE_BOTH, "ON",
           "bool"),
    SysVar("tidb_enable_rate_limit_action", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_enable_strict_double_type_check", SCOPE_BOTH, "ON",
           "bool"),
    SysVar("tidb_enforce_mpp", SCOPE_SESSION, "OFF", "bool"),
    SysVar("tidb_evolve_plan_baselines", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_evolve_plan_task_end_time", SCOPE_GLOBAL, "23:59 +0000",
           "str"),
    SysVar("tidb_evolve_plan_task_max_time", SCOPE_GLOBAL, "600", "int",
           0),
    SysVar("tidb_evolve_plan_task_start_time", SCOPE_GLOBAL,
           "00:00 +0000", "str"),
    SysVar("tidb_expensive_query_time_threshold", SCOPE_GLOBAL, "60",
           "int", 10),
    SysVar("tidb_gc_concurrency", SCOPE_GLOBAL, "-1", "int", -1, 256),
    SysVar("tidb_gc_scan_lock_mode", SCOPE_GLOBAL, "LEGACY", "str"),
    SysVar("tidb_guarantee_linearizability", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_hash_exchange_with_new_collation", SCOPE_BOTH, "ON",
           "bool"),
    SysVar("tidb_index_lookup_join_concurrency", SCOPE_BOTH, "-1", "int",
           -1),
    SysVar("tidb_last_query_info", SCOPE_SESSION, "", "str"),
    SysVar("tidb_last_txn_info", SCOPE_SESSION, "", "str"),
    SysVar("tidb_log_file_max_days", SCOPE_GLOBAL, "0", "int", 0),
    SysVar("tidb_mem_quota_hashjoin", SCOPE_SESSION, str(32 << 30),
           "int", 0),
    SysVar("tidb_mem_quota_indexlookupjoin", SCOPE_SESSION, str(32 << 30),
           "int", 0),
    SysVar("tidb_mem_quota_indexlookupreader", SCOPE_SESSION,
           str(32 << 30), "int", 0),
    SysVar("tidb_mem_quota_mergejoin", SCOPE_SESSION, str(32 << 30),
           "int", 0),
    SysVar("tidb_mem_quota_sort", SCOPE_SESSION, str(32 << 30), "int", 0),
    SysVar("tidb_mem_quota_topn", SCOPE_SESSION, str(32 << 30), "int", 0),
    SysVar("tidb_memory_usage_alarm_ratio", SCOPE_SESSION, "0.8", "float"),
    SysVar("tidb_merge_join_concurrency", SCOPE_BOTH, "1", "int", 1),
    SysVar("tidb_metric_query_range_duration", SCOPE_SESSION, "60", "int",
           10),
    SysVar("tidb_metric_query_step", SCOPE_SESSION, "60", "int", 10),
    SysVar("tidb_mpp_store_fail_ttl", SCOPE_BOTH, "60s", "str"),
    SysVar("tidb_multi_statement_mode", SCOPE_BOTH, "OFF", "enum",
           choices=("off", "on", "warn")),
    SysVar("tidb_partition_prune_mode", SCOPE_BOTH, "static", "enum",
           choices=("static", "dynamic", "static-only", "dynamic-only")),
    SysVar("tidb_persist_analyze_options", SCOPE_GLOBAL, "ON", "bool"),
    SysVar("tidb_placement_mode", SCOPE_BOTH, "STRICT", "enum",
           choices=("strict", "ignore")),
    SysVar("tidb_pprof_sql_cpu", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_read_consistency", SCOPE_SESSION, "strict", "enum",
           choices=("strict", "weak")),
    SysVar("tidb_redact_log", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_restricted_read_only", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_shard_allocate_step", SCOPE_SESSION, str(1 << 30), "int",
           1),
    SysVar("tidb_skip_ascii_check", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_stats_load_pseudo_timeout", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_stats_load_sync_wait", SCOPE_SESSION, "0", "int", 0),
    SysVar("tidb_stmt_summary_history_size", SCOPE_BOTH, "24", "int", 0,
           255),
    SysVar("tidb_stmt_summary_internal_query", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_stmt_summary_max_sql_length", SCOPE_BOTH, "4096", "int",
           0),
    SysVar("tidb_stmt_summary_refresh_interval", SCOPE_BOTH, "1800",
           "int", 1),
    SysVar("tidb_streamagg_concurrency", SCOPE_BOTH, "1", "int", 1),
    SysVar("tidb_table_cache_lease", SCOPE_GLOBAL, "3", "int", 1, 10),
    SysVar("tidb_tmp_table_max_size", SCOPE_SESSION, str(64 << 20), "int",
           1 << 20),
    SysVar("tidb_top_sql_max_collect", SCOPE_GLOBAL, "10000", "int", 1),
    SysVar("tidb_top_sql_max_statement_count", SCOPE_GLOBAL, "200", "int",
           0, 5000),
    SysVar("tidb_top_sql_precision_seconds", SCOPE_GLOBAL, "1", "int", 1),
    SysVar("tidb_top_sql_report_interval_seconds", SCOPE_GLOBAL, "60",
           "int", 1),
    SysVar("tidb_track_aggregate_memory_usage", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_tso_client_batch_max_wait_time", SCOPE_GLOBAL, "0.0",
           "float"),
    SysVar("tidb_use_plan_baselines", SCOPE_BOTH, "ON", "bool"),
    SysVar("tx_isolation_one_shot", SCOPE_SESSION, "", "str"),
    SysVar("tx_read_ts", SCOPE_SESSION, "0", "int", 0),
    SysVar("txn_scope", SCOPE_SESSION, "global", "str"),
    SysVar("windowing_use_high_precision", SCOPE_BOTH, "ON", "bool"),
    SysVar("tidb_query_log_max_len", SCOPE_GLOBAL, "4096", "int", 0),
    SysVar("tidb_read_staleness", SCOPE_SESSION, "0", "int"),
    # historical read view: every read runs at this datetime until unset
    # (reference: sessionctx/variable tidb_snapshot + stale-read txns)
    SysVar("tidb_snapshot", SCOPE_SESSION, "", "str"),
    SysVar("tidb_replica_read", SCOPE_SESSION, "leader"),
    SysVar("tidb_row_format_version", SCOPE_GLOBAL, "2", "int", 1, 2),
    SysVar("tidb_scatter_region", SCOPE_GLOBAL, "OFF", "bool"),
    SysVar("tidb_skip_isolation_level_check", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_skip_utf8_check", SCOPE_BOTH, "OFF", "bool"),
    SysVar("tidb_slow_query_file", SCOPE_SESSION, ""),
    SysVar("tidb_stmt_summary_max_stmt_count", SCOPE_GLOBAL, "3000",
           "int", 1),
    SysVar("tidb_store_limit", SCOPE_BOTH, "0", "int", 0),
    SysVar("tidb_txn_assertion_level", SCOPE_BOTH, "FAST"),
    SysVar("tidb_wait_split_region_finish", SCOPE_SESSION, "ON", "bool"),
    SysVar("tidb_wait_split_region_timeout", SCOPE_SESSION, "300", "int", 1),
    SysVar("tidb_window_concurrency", SCOPE_BOTH, "-1", "int", -1),
    SysVar("tx_read_only", SCOPE_BOTH, "0", "bool"),
    SysVar("sql_log_bin", SCOPE_SESSION, "ON", "bool"),
    SysVar("sql_notes", SCOPE_BOTH, "ON", "bool"),
    SysVar("sql_quote_show_create", SCOPE_BOTH, "ON", "bool"),
    SysVar("sql_warnings", SCOPE_BOTH, "OFF", "bool"),
]:
    register(_v)
