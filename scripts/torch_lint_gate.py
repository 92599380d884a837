"""Static gate over the PyTorch/CUDA port: run ruff/mypy/pip-audit when
installed, else a self-contained AST fallback with the same hard-fail
contract.

The counterpart of ``scripts/lint_gate.py`` (which lints ``rabia_tpu``,
``tests``, ``benchmarks``, ``scripts`` and ``examples``) for the port's
own files: ``rabia_tpu_torch/``, ``tests/test_torch_*.py``,
``scripts/torch_*.py``, ``examples/torch_*.py``,
``examples/_torch_common.py`` and ``chip_smoke.py``. ruff runs with the
repo's rule set (pyproject); mypy over the port's counterparts of the
reference's typed tier (``core/types.py``, ``core/errors.py``,
``core/config.py``, ``obs``, ``chaos``). Hosts without the tools still
get a floor: byte-compile every file, flag unused
module-level imports (F401), undefined-name-prone wildcard imports,
bare excepts (E722), and comparison-to-literal pitfalls (E711/E712) —
the highest-signal subset of the CI rule set, implemented on `ast` so
it needs nothing beyond the standard library.

Exit code is non-zero on any finding either way: this script is a
gate, not a report.
"""

from __future__ import annotations

import ast
import pathlib
import py_compile
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = "rabia_tpu_torch"
# the port's files outside its package, as globs under the root
GLOBS = ["tests/test_torch_*.py", "scripts/torch_*.py", "examples/torch_*.py",
         "examples/_torch_common.py", "chip_smoke.py"]
# the counterparts of the reference's mypy tier (pyproject [tool.mypy])
MYPY_FILES = ["core/types.py", "core/errors.py", "core/config.py", "obs", "chaos"]


def port_files(root: pathlib.Path) -> list[pathlib.Path]:
    """Every Python file the gate lints under ``root``."""
    files = sorted((root / PACKAGE).rglob("*.py"))
    for g in GLOBS:
        files.extend(sorted(root.glob(g)))
    return files


def _have(tool: str) -> bool:
    return shutil.which(tool) is not None


def run_real_tools(root: pathlib.Path = ROOT) -> int:
    rc = 0
    print("== ruff check ==")
    files = [str(p.relative_to(root)) for p in port_files(root)]
    rc |= subprocess.call(["ruff", "check", *files], cwd=root)
    if _have("mypy"):
        print("== mypy (the port's counterpart of pyproject's tier) ==")
        rc |= subprocess.call(
            ["mypy", "--ignore-missing-imports",
             *(f"{PACKAGE}/{f}" for f in MYPY_FILES)], cwd=root)
    else:
        print("mypy not installed; skipping (CI runs it)")
    if _have("pip-audit"):
        print("== pip-audit ==")
        rc |= subprocess.call(["pip-audit", "."], cwd=root)
    else:
        print("pip-audit not installed; skipping (CI runs it)")
    return rc


class _Fallback(ast.NodeVisitor):
    """Single-file F401/E711/E712/E722/F403 + B006/RUF006
    approximation (the round-13 additions mirror the ruff codes
    enabled in pyproject: mutable defaults and dangling
    asyncio.create_task results)."""

    def __init__(self, path: pathlib.Path, src: str) -> None:
        self.path = path
        self.src = src
        self.findings: list[str] = []
        self.imports: dict[str, int] = {}
        self.noqa = {
            i + 1
            for i, line in enumerate(src.splitlines())
            if "noqa" in line
        }

    def _flag(self, lineno: int, code: str, msg: str) -> None:
        if lineno not in self.noqa:
            self.findings.append(f"{self.path}:{lineno}: {code} {msg}")

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.imports[(a.asname or a.name).split(".")[0]] = node.lineno

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for a in node.names:
            if a.name == "*":
                self._flag(node.lineno, "F403", "wildcard import")
            else:
                self.imports[a.asname or a.name] = node.lineno

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self._flag(node.lineno, "E722", "bare except")
        self.generic_visit(node)

    def _check_defaults(self, node) -> None:
        defaults = list(node.args.defaults)
        defaults += [d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call)
                and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set")
            )
            if mutable:
                self._flag(
                    d.lineno, "B006",
                    f"mutable default in {node.name}() is shared "
                    "across calls",
                )

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_Expr(self, node: ast.Expr) -> None:
        # RUF006: a create_task whose handle is dropped can be GC'd
        # mid-flight (the task silently disappears). Mirror ruff's
        # scope: asyncio.create_task / <loop>.create_task / a bare
        # imported create_task — NOT TaskGroup.create_task (the group
        # holds the strong reference).
        if isinstance(node.value, ast.Call):
            f = node.value.func
            dangling = False
            if isinstance(f, ast.Attribute) and f.attr == "create_task":
                base = f.value
                dangling = isinstance(base, ast.Name) and (
                    base.id == "asyncio" or base.id.endswith("loop")
                )
            elif isinstance(f, ast.Name) and f.id == "create_task":
                dangling = "create_task" in self.imports
            if dangling:
                self._flag(
                    node.lineno, "RUF006",
                    "create_task result must be bound (a dangling "
                    "task may be garbage-collected mid-flight)",
                )
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        for op, cmp in zip(node.ops, node.comparators):
            # identity checks, NOT `in (None, True, False)` — membership
            # uses ==, and `1 == True` would flag every integer compare
            if (
                isinstance(op, (ast.Eq, ast.NotEq))
                and isinstance(cmp, ast.Constant)
                and (cmp.value is None or cmp.value is True or cmp.value is False)
            ):
                code = "E711" if cmp.value is None else "E712"
                self._flag(
                    node.lineno, code, f"comparison to {cmp.value!r}"
                )
        self.generic_visit(node)

    def finish(self) -> None:
        used = {
            n.id for n in ast.walk(self.tree) if isinstance(n, ast.Name)
        }
        # names referenced from strings (__all__, lazy __getattr__) count
        for n in ast.walk(self.tree):
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                used.add(n.value)
        for name, lineno in self.imports.items():
            if name not in used and name not in self.src.split():
                self._flag(lineno, "F401", f"unused import {name!r}")

    def run(self) -> list[str]:
        self.tree = ast.parse(self.src)
        self.visit(self.tree)
        self.finish()
        return self.findings


def run_fallback(root: pathlib.Path = ROOT) -> int:
    print("ruff not installed; running stdlib AST fallback gate")
    ok = True
    files = port_files(root)
    for path in files:
        try:
            py_compile.compile(str(path), doraise=True)
        except py_compile.PyCompileError as e:
            print(f"byte-compile failed: {e.msg}")
            ok = False
    findings: list[str] = []
    for path in files:
        try:
            findings.extend(_Fallback(path, path.read_text()).run())
        except SyntaxError as e:
            findings.append(f"{path}: syntax error: {e}")
    for f in findings:
        print(f)
    print(f"{len(findings)} findings")
    return 0 if ok and not findings else 1


def main() -> int:
    if _have("ruff"):
        return run_real_tools()
    return run_fallback()


if __name__ == "__main__":
    sys.exit(main())
