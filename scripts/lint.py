#!/usr/bin/env python
"""Stdlib fallback linter (used by ci.sh when ruff is not installed).

The reference gates its build on clang-tidy with WarningsAsErrors
(test/clang_tidy/CMakeLists.txt:28-53); this provides the equivalent gate
for environments without a third-party linter: every file must parse, and
a small AST pass flags unused imports, duplicate top-level definitions,
`except:` bare handlers, and mutable default arguments.
"""

from __future__ import annotations

import ast
import pathlib
import sys

ROOTS = [
    "portfft_tpu", "tests", "scripts", "bench.py", "chip_smoke.py",
    "__graft_entry__.py",
]


def check_file(path: pathlib.Path) -> list[str]:
    src = path.read_text()
    problems: list[str] = []
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [f"{path}:{e.lineno}: syntax error: {e.msg}"]

    imported: dict[str, int] = {}
    is_init = path.name == "__init__.py"
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
        elif isinstance(node, ast.ExceptHandler) and node.type is None:
            problems.append(f"{path}:{node.lineno}: bare except")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in node.args.defaults + node.args.kw_defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    problems.append(
                        f"{path}:{node.lineno}: mutable default argument "
                        f"in {node.name}()"
                    )

    used = {
        n.id for n in ast.walk(tree) if isinstance(n, ast.Name)
    } | {
        n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
    }
    # names referenced in __all__ or re-exported count as used
    text_refs = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            text_refs.add(node.value)
    if not is_init:  # __init__.py imports are namespace re-exports
        for name, lineno in sorted(imported.items()):
            if name not in used and name not in text_refs and name != "_":
                problems.append(f"{path}:{lineno}: unused import {name!r}")

    seen: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name == "_":
                continue  # intentional throwaway (decorator registries)
            if node.name in seen:
                problems.append(
                    f"{path}:{node.lineno}: duplicate top-level definition "
                    f"{node.name!r} (first at line {seen[node.name]})"
                )
            seen[node.name] = node.lineno
    return problems


def main() -> int:
    repo = pathlib.Path(__file__).resolve().parent.parent
    files: list[pathlib.Path] = []
    for root in ROOTS:
        p = repo / root
        if p.is_file():
            files.append(p)
        else:
            files.extend(sorted(p.rglob("*.py")))
    problems: list[str] = []
    for f in files:
        problems.extend(check_file(f))
    for p in problems:
        print(p)
    print(f"lint: {len(files)} files, {len(problems)} problems")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
