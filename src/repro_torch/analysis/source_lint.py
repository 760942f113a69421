"""AST lint: f32 promotion idioms in the port's numeric hot paths, the port
of ``repro.analysis.source_lint``.

The state census proves the step keeps no master copy; this lint names a
new promotion by file and line before any run. It walks ``models/`` and
``core/`` and flags torch's promotion idioms:

  * ``f32-method``     — ``x.float()``, ``x.double()``
  * ``to-f32``         — ``x.to(torch.float32 | torch.float64)`` (positional)
  * ``type-f32``       — ``x.type(torch.float32)``
  * ``f32-dtype-arg``  — ``dtype=torch.float32`` (or ``np.float32``,
                         ``"float32"``, float64 alike) passed to any call,
                         ``.to(dtype=…)`` included

Narrowing casts (``.to(torch.bfloat16)``, ``.half()``) are not flagged.
An intentional widening is allowed in place by a ``# f32-ok: <reason>``
comment on the flagged line or the line above. The lint reads names, not
values: a module constant bound to a dtype (``F32 = torch.float32``) is
not followed.
"""

from __future__ import annotations

import ast
import pathlib

ALLOW_MARK = "f32-ok"
DEFAULT_ROOTS = ("src/repro_torch/models", "src/repro_torch/core")

_F32_NAMES = {"float32", "float64"}
_TORCH_WIDE = _F32_NAMES | {"float", "double"}      # torch.float is float32


def _is_f32_node(node) -> bool:
    if isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "torch":
            return node.attr in _TORCH_WIDE
        return node.attr in _F32_NAMES
    if isinstance(node, ast.Constant):
        return node.value in _F32_NAMES
    return False


def _allowed(lines: list, lineno: int) -> bool:
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and ALLOW_MARK in lines[ln - 1]:
            return True
    return False


def lint_file(path: str) -> list:
    src = pathlib.Path(path).read_text()
    lines = src.splitlines()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [{"file": path, "line": e.lineno or 0,
                 "code": "syntax-error", "snippet": str(e)}]
    out = []

    def add(node, code):
        if _allowed(lines, node.lineno):
            return
        snippet = lines[node.lineno - 1].strip() if node.lineno <= len(lines) else ""
        out.append({"file": path, "line": node.lineno, "code": code,
                    "snippet": snippet[:120]})

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in ("float", "double") and not node.args and not node.keywords:
                add(node, "f32-method")
            elif fn.attr == "to" and node.args and _is_f32_node(node.args[0]):
                add(node, "to-f32")
            elif fn.attr == "type" and node.args and _is_f32_node(node.args[0]):
                add(node, "type-f32")
        for kw in node.keywords:
            if kw.arg == "dtype" and _is_f32_node(kw.value):
                add(node, "f32-dtype-arg")
    return sorted(out, key=lambda f: (f["line"], f["code"]))


def lint_paths(roots=DEFAULT_ROOTS, repo_root: str = ".") -> list:
    findings = []
    base = pathlib.Path(repo_root)
    for root in roots:
        for p in sorted((base / root).rglob("*.py")):
            findings.extend(lint_file(str(p)))
    for f in findings:
        try:
            f["file"] = str(pathlib.Path(f["file"]).resolve().relative_to(base.resolve()))
        except ValueError:
            pass
    return findings
