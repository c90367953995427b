"""Dependency-free static gate — the local analog of the reference's
clang-format/clang-tidy hard CI failure (reference:
.github/workflows/cmake-single-platform.yml:34-36, .clang-tidy:1-107).

Checks every tracked .py file for:
  * syntax errors (ast.parse)
  * lines longer than MAX_LINE columns
  * tabs in indentation, trailing whitespace, missing final newline
  * unused imports (AST-based, pyflakes-style approximation)
  * mutable default arguments (list/dict/set literals)

Exit code 0 iff clean.  Run via tools/ci.sh or directly:
    python tools/lint_gate.py [paths...]
"""

from __future__ import annotations

import ast
import pathlib
import sys

MAX_LINE = 99
DEFAULT_PATHS = ["simpledsp_jax", "tests", "tools", "examples",
                 "bench.py", "bench_ops.py", "bench_scaling.py",
                 "bench_stream.py", "chip_smoke.py", "__graft_entry__.py"]

# Names that count as "used" even when only referenced in strings/comments
# (re-export indexes keep imports solely for __all__ / package surface).
_REEXPORT_FILES = {"__init__.py"}


def _unused_imports(tree: ast.AST, source: str) -> list:
    imported = {}  # name -> lineno
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                imported[name] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                imported[a.asname or a.name] = node.lineno
    if not imported:
        return []
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            pass  # the base Name node is walked separately
    # __all__ strings and docstring references to the name keep it.
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for name in imported:
                if name in node.value:
                    used.add(name)
    return [(line, name) for name, line in sorted(imported.items(),
                                                  key=lambda kv: kv[1])
            if name not in used]


def check_file(path: pathlib.Path) -> list:
    problems = []
    text = path.read_text()
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError as e:
        return [(e.lineno or 0, f"syntax error: {e.msg}")]

    lines = text.split("\n")
    if text and not text.endswith("\n"):
        problems.append((len(lines), "missing final newline"))
    for i, line in enumerate(lines, 1):
        if len(line) > MAX_LINE:
            problems.append((i, f"line too long ({len(line)} > {MAX_LINE})"))
        if line != line.rstrip():
            problems.append((i, "trailing whitespace"))
        stripped_len = len(line) - len(line.lstrip())
        if "\t" in line[:stripped_len]:
            problems.append((i, "tab in indentation"))

    if path.name not in _REEXPORT_FILES:
        for line, name in _unused_imports(tree, text):
            problems.append((line, f"unused import: {name}"))

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for default in node.args.defaults + node.args.kw_defaults:
                if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                    problems.append(
                        (node.lineno,
                         f"mutable default argument in {node.name}()"))
    return problems


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    roots = [pathlib.Path(p) for p in (args or DEFAULT_PATHS)]
    files = []
    for r in roots:
        if r.is_dir():
            files.extend(sorted(r.rglob("*.py")))
        elif r.exists():
            files.append(r)
    n_problems = 0
    for f in files:
        for line, msg in check_file(f):
            print(f"{f}:{line}: {msg}")
            n_problems += 1
    print(f"lint gate: {len(files)} files, {n_problems} problems")
    return 1 if n_problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
