"""Server process entry point of the port (reference: tidb-server/main.go:164
— flags → config, store + domain bootstrap, MySQL wire server + HTTP status
server, signal-driven graceful shutdown).

Run:  python -m tidb_tpu_torch.server [--port 4000] [--config cfg.toml]
      [--device cuda|cpu]

The device engine runs on the CUDA card unless ``--device cpu`` asks for
the kernels' plain versions on the CPU.  With ``--device cuda`` and no
card visible the server refuses to start (exit 1, the
``DeviceNotAvailable`` message on stderr): it never serves host-only.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tidb-tpu-torch-server",
        description="MySQL-compatible HTAP server on a CUDA device engine")
    p.add_argument("--host", default=None, help="listen host")
    p.add_argument("-P", "--port", type=int, default=None,
                   help="MySQL protocol port (default 4000)")
    p.add_argument("--status-host", default=None)
    p.add_argument("--status-port", type=int, default=None,
                   help="HTTP status port (default 10080; -1 disables)")
    p.add_argument("--store", default=None,
                   help="kv engine: auto | native | python")
    p.add_argument("--config", default=None, help="TOML config file")
    p.add_argument("--config-check", action="store_true",
                   help="validate the config file and exit")
    p.add_argument("--device", default="cuda",
                   help="device engine: cuda (default), cuda:N or cpu")
    p.add_argument("-V", "--version", action="store_true")
    return p


def resolve_config(args):
    from ..config import load_config
    cfg = load_config(args.config, strict=args.config_check)
    # CLI flags override the file (reference: main.go overrideConfig)
    if args.host is not None:
        cfg.host = args.host
    if args.port is not None:
        cfg.port = args.port
    if args.status_host is not None:
        cfg.status.status_host = args.status_host
    if args.status_port is not None:
        if args.status_port < 0:
            cfg.status.report_status = False
        else:
            cfg.status.status_port = args.status_port
    if args.store is not None:
        cfg.store = args.store
    return cfg


def make_tls_context(cert_path: str = "", key_path: str = "",
                     auto_dir: str | None = None):
    """ssl.SSLContext for the wire server's in-handshake upgrade
    (reference: server/conn.go:256 upgradeToTLS + security.auto-tls).
    With no cert configured and auto_dir set, generates a self-signed
    RSA cert via the openssl CLI (the reference generates one in-process
    at startup). Returns None when TLS cannot be enabled."""
    import ssl
    import subprocess as sp
    import os as _os
    explicit = bool(cert_path)
    if not cert_path and auto_dir is not None:
        # per-user 0700 directory, ownership-verified: a fixed path in a
        # world-writable tmp would let another local user pre-plant the
        # server's TLS identity
        _os.makedirs(auto_dir, mode=0o700, exist_ok=True)
        st = _os.stat(auto_dir)
        if st.st_uid != _os.getuid() or (st.st_mode & 0o077):
            print(f"[tls] refusing auto-TLS dir {auto_dir}: not owned by "
                  f"this user or too permissive", file=sys.stderr)
            return None
        cert_path = _os.path.join(auto_dir, "auto-tls-cert.pem")
        key_path = _os.path.join(auto_dir, "auto-tls-key.pem")
        if not (_os.path.exists(cert_path) and _os.path.exists(key_path)):
            try:
                sp.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                        "-nodes", "-keyout", key_path, "-out", cert_path,
                        "-days", "365", "-subj", "/CN=tidb-tpu-torch"],
                       check=True, capture_output=True, timeout=60)
                _os.chmod(key_path, 0o600)
            except Exception as e:
                print(f"[tls] auto-TLS generation failed: {e}",
                      file=sys.stderr)
                return None
    if not cert_path or not key_path:
        return None
    try:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert_path, key_path)
        return ctx
    except Exception:
        if explicit:
            # a configured cert that fails to load must not silently
            # degrade the server to plaintext
            raise
        return None


def run_server(cfg, ready_event: threading.Event | None = None):
    """Bootstrap and serve until SIGINT/SIGTERM. Returns the exit code:
    1, before anything listens, when the device engine's device does not
    exist (``ops.device.set_device`` chose it)."""
    from ..ops import device as dev
    try:
        dev.device()
    except dev.DeviceNotAvailable as e:
        print(f"[tidb-tpu-torch] {e}", file=sys.stderr, flush=True)
        return 1
    from ..kv import new_store
    from ..session import bootstrap_domain
    from .server import MySQLServer
    from .http_status import StatusServer

    store = new_store(backend=cfg.store)
    domain = bootstrap_domain(store)
    # calibrate the cost-model constants on THIS machine (reference: the
    # tidb_opt_*_factor family is hand-tuned there; here a ~50ms startup
    # micro-bench measures seek/build/sort relative to the vectorized
    # scan and installs the ratios as globals — planner/cost_model.py)
    if cfg.performance.calibrate_costs:
        from ..planner.cost_model import apply_calibration
        apply_calibration(domain)
    for name, val in (
            ("tidb_mem_quota_query", str(cfg.performance.mem_quota_query)),
            ("tidb_executor_engine", cfg.performance.executor_engine),
            ("tidb_mesh_shape", cfg.performance.mesh_shape),
            ("tidb_slow_log_threshold",
             str(cfg.performance.slow_log_threshold_ms))):
        domain.global_vars[name] = val
    if cfg.security.skip_grant_table:
        # sticky: later priv.load() calls (GRANT etc.) must not re-enable
        domain.priv.disabled = True
        domain.priv.enabled = False

    # server mode: liveness is real — re-register with a finite TTL so a
    # wedged process ages out of the registry; the stats worker's periodic
    # sweep heartbeats the lease (domain/infosync keepalive analog). The
    # embedded deployment keeps the infinite-TTL registration from
    # bootstrap (nothing heartbeats an idle library user).
    domain.coordinator.register_server(
        "tidb-0", {"version": "8.0.11-tpu-htap",
                   "status_port": cfg.status.status_port}, ttl_s=60.0)
    domain.stats_worker.start()  # auto-analyze loop (domain.go:1270 analog)
    domain.gc_worker.start()     # MVCC safepoint GC (store/gcworker analog)
    domain.topsql.start()        # CPU attribution sampler (util/topsql)
    ssl_ctx = None
    if cfg.security.ssl_cert or cfg.security.auto_tls:
        import tempfile
        ssl_ctx = make_tls_context(
            cfg.security.ssl_cert, cfg.security.ssl_key,
            auto_dir=(os.path.join(tempfile.gettempdir(),
                                   f"tidb_tpu_torch_tls_{os.getuid()}")
                      if cfg.security.auto_tls else None))
    sql_srv = MySQLServer(domain, host=cfg.host, port=cfg.port,
                          ssl_ctx=ssl_ctx).start()
    status_srv = None
    if cfg.status.report_status:
        status_srv = StatusServer(domain, sql_srv,
                                  host=cfg.status.status_host,
                                  port=cfg.status.status_port).start()
    print(f"[tidb-tpu-torch] SQL listening on {cfg.host}:{sql_srv.port}"
          + (f", status on :{status_srv.port}" if status_srv else ""),
          file=sys.stderr, flush=True)

    stop = threading.Event()

    def on_signal(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    if ready_event is not None:
        ready_event.set()
    stop.wait()
    # graceful: stop accepting, close status, drain (reference:
    # server.go GracefulDown)
    print("[tidb-tpu-torch] shutting down", file=sys.stderr, flush=True)
    if status_srv is not None:
        status_srv.shutdown()
    sql_srv.shutdown()
    domain.ddl_worker.stop()
    domain.stats_worker.stop()
    domain.topsql.stop()
    return 0


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.version:
        print("tidb-tpu-torch-server 8.0.11-tpu-htap")
        return 0
    try:
        cfg = resolve_config(args)
    except (ValueError, OSError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 1
    if args.config_check:
        print("config OK")
        return 0
    from ..ops.device import set_device
    set_device(args.device)
    return run_server(cfg)


if __name__ == "__main__":
    sys.exit(main())
