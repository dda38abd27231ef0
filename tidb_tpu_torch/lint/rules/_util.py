"""Shared AST helpers for the rule modules."""

from __future__ import annotations

import ast


def dotted(node) -> str:
    """Best-effort dotted-name rendering of an expression: ``build.launch``,
    ``self._lock``, ``failpoint.inject`` — "" when the expression is not
    a plain name/attribute chain."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


def call_name(call: ast.Call) -> str:
    return dotted(call.func)


def const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def string_literals(tree) -> set:
    """Every string constant in the tree (docstrings included — they name
    gauges/keys often enough that excluding them only creates noise)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value)
        elif isinstance(node, ast.JoinedStr):
            # f-string: keep the literal fragments (the static prefix of
            # "sched_degradations:{g}" is what surfacing checks match on)
            for v in node.values:
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    out.add(v.value)
    return out


def import_map(tree, current_rel: str,
               package: str = "tidb_tpu_torch") -> dict:
    """local-name -> package-relative module path ("executor/scheduler")
    for every intra-package import in the module.  Names imported FROM a
    module map to "module::name".  Used for best-effort cross-module call
    resolution; anything outside the package maps to nothing."""
    # current module's package path, "/"-separated, no trailing file
    cur_parts = current_rel.rsplit(".py", 1)[0].split("/")
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == package or a.name.startswith(package + "."):
                    mod = "/".join(a.name.split(".")[1:])
                    out[(a.asname or a.name.split(".")[-1])] = mod
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                if not (node.module or "").startswith(package):
                    continue
                base = (node.module or package).split(".")[1:]
            else:
                # relative: level 1 = current package dir, 2 = parent, ...
                base = cur_parts[:-(node.level)] if node.level <= \
                    len(cur_parts) else []
                if node.module:
                    base = base + node.module.split(".")
            mod = "/".join(base)
            for a in node.names:
                local = a.asname or a.name
                # could be a submodule (from ..executor import scheduler)
                # or a symbol (from .engine import run) — record both
                # interpretations; resolution tries module-first
                out[local] = f"{mod}/{a.name}" if mod else a.name
                out[local + "::sym"] = f"{mod}::{a.name}" if mod \
                    else f"::{a.name}"
    return out
