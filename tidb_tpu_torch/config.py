"""Layered server configuration (reference: config/config.go — TOML file →
CLI flag override → dynamic sysvars; config-check mode).

Only the knobs this engine actually consumes are modeled; unknown TOML keys
fail loudly under --config-check (reference config-strict behavior) and
warn otherwise."""

from __future__ import annotations

import dataclasses
import sys


@dataclasses.dataclass
class StatusConfig:
    report_status: bool = True
    status_host: str = "127.0.0.1"
    status_port: int = 10080


@dataclasses.dataclass
class PerformanceConfig:
    mem_quota_query: int = 1 << 30
    executor_engine: str = "auto"      # auto | host | tpu | tpu-mpp
    mesh_shape: str = "1"
    slow_log_threshold_ms: int = 300
    #: startup cost-model micro-bench (planner/cost_model.py): measures
    #: seek/hash-build/sort constants relative to the vectorized scan on
    #: this machine and installs them as the tidb_opt_* globals
    calibrate_costs: bool = True


@dataclasses.dataclass
class SecurityConfig:
    skip_grant_table: bool = False
    #: PEM cert/key enabling the wire protocol's in-handshake TLS upgrade
    ssl_cert: str = ""
    ssl_key: str = ""
    #: generate a self-signed cert at startup when no cert is configured
    #: (reference: security.auto-tls)
    auto_tls: bool = False


@dataclasses.dataclass
class Config:
    host: str = "127.0.0.1"
    port: int = 4000
    store: str = "auto"                # auto | native | python (kv engine)
    path: str = ""                     # reserved: persistent store path
    status: StatusConfig = dataclasses.field(default_factory=StatusConfig)
    performance: PerformanceConfig = dataclasses.field(
        default_factory=PerformanceConfig)
    security: SecurityConfig = dataclasses.field(
        default_factory=SecurityConfig)

    def apply_toml(self, data: dict, strict: bool = False):
        unknown = []

        def fill(obj, d, prefix=""):
            names = {f.name: f for f in dataclasses.fields(obj)}
            for k, v in d.items():
                key = k.replace("-", "_")
                if key not in names:
                    unknown.append(prefix + k)
                    continue
                cur = getattr(obj, key)
                if dataclasses.is_dataclass(cur):
                    if isinstance(v, dict):
                        fill(cur, v, prefix + k + ".")
                    else:  # scalar assigned to a [section]: invalid
                        unknown.append(f"{prefix}{k} (expected a table)")
                else:
                    setattr(obj, key, type(cur)(v) if cur is not None else v)

        fill(self, data)
        if unknown:
            msg = f"unknown config keys: {', '.join(unknown)}"
            if strict:
                raise ValueError(msg)
            print(f"[warn] {msg}", file=sys.stderr)
        return self


def load_config(path: str | None, strict: bool = False) -> Config:
    cfg = Config()
    if path:
        import tomllib
        with open(path, "rb") as f:
            cfg.apply_toml(tomllib.load(f), strict=strict)
    return cfg
