"""swarmlint core: file discovery, the shared AST context, rule runner.

A rule is an object with a ``code`` (``"SWM00x"``), a one-line
``summary`` and ``check(ctx) -> Iterable[Violation]``.  Rules share one
:class:`FileContext` per file so expensive passes (parsing, traced-body
discovery) run once.  Suppression is per line:

    something_flagged()  # swarmlint: disable=SWM005

Only ``*.py`` source files are linted; ``__pycache__``, hidden
directories and non-Python files are skipped explicitly so generated
bytecode or data can never produce findings.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Iterable, Iterator

_DISABLE_RE = re.compile(r"#\s*swarmlint:\s*disable=([A-Z0-9,\s]+)")
_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", ".pytest_cache",
              "node_modules", ".venv"}


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def text(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def github(self) -> str:
        return (f"::error file={self.path},line={self.line},"
                f"col={self.col},title={self.rule}::{self.message}")


class FileContext:
    """Per-file shared state handed to every rule."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.posix_path = path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._traced: set[ast.AST] | None = None
        # parent links let rules look outward from a node (loop
        # enclosure, method-of-class checks)
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    # -- traced-body discovery (shared by SWM001/002/006) ---------------
    def traced_bodies(self) -> set[ast.AST]:
        """Function/lambda nodes whose bodies run under a JAX trace:
        ``@jit``-decorated functions, functions passed to ``*.jit`` /
        ``shard_map`` / ``lax.scan`` (directly, via ``functools.partial``
        or as ``self._name`` attribute references), and inline lambdas
        handed to any of those."""
        if self._traced is None:
            self._traced = _collect_traced(self.tree)
        return self._traced

    def suppressed(self, line: int, code: str) -> bool:
        if 1 <= line <= len(self.lines):
            m = _DISABLE_RE.search(self.lines[line - 1])
            if m and code in {c.strip() for c in m.group(1).split(",")}:
                return True
        return False


# ---------------------------------------------------------------------------
# traced-body discovery
# ---------------------------------------------------------------------------

_TRACING_FUNCS = {"jit", "shard_map", "pmap", "scan", "while_loop",
                  "fori_loop", "checkpoint", "remat"}


def _callee_name(func: ast.AST) -> str | None:
    """Trailing name of a call target: ``jit``/``jax.jit``/``self._jax.jit``
    all resolve to ``jit``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_partial(call: ast.Call) -> bool:
    return _callee_name(call.func) == "partial"


def _traced_ref_names(arg: ast.AST, lambdas: set[ast.AST],
                      names: set[str]) -> None:
    """Record what a tracing call's function argument refers to."""
    if isinstance(arg, ast.Lambda):
        lambdas.add(arg)
    elif isinstance(arg, ast.Name):
        names.add(arg.id)
    elif isinstance(arg, ast.Attribute):      # self._window_fn
        names.add(arg.attr)
    elif isinstance(arg, ast.Call) and _is_partial(arg) and arg.args:
        _traced_ref_names(arg.args[0], lambdas, names)


def _decorated_traced(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(target, ast.Call) and _is_partial(target) \
                and target.args:
            target = target.args[0]
        if _callee_name(target) in ("jit", "shard_map", "pmap"):
            return True
        # @functools.partial(jax.jit, static_argnums=...) form
        if isinstance(dec, ast.Call) and _is_partial(dec) and dec.args \
                and _callee_name(dec.args[0]) in ("jit", "shard_map", "pmap"):
            return True
    return False


def _collect_traced(tree: ast.Module) -> set[ast.AST]:
    traced: set[ast.AST] = set()
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _decorated_traced(node):
            traced.add(node)
        elif isinstance(node, ast.Call) \
                and _callee_name(node.func) in _TRACING_FUNCS:
            args = list(node.args)
            if _is_partial(node):
                args = args[1:]               # partial(jit, f) — rare
            if args:
                _traced_ref_names(args[0], traced, names)
    if names:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in names:
                traced.add(node)
    return traced


def walk_body(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node lexically inside a traced function body, including
    nested defs (a closure defined inside a jitted body is traced with
    it)."""
    for field in ast.iter_child_nodes(fn):
        yield from ast.walk(field)


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def discover(paths: Iterable[str]) -> list[str]:
    """Expand files/directories into the ordered list of ``.py`` source
    files; everything else (bytecode, caches, data) is skipped."""
    out: list[str] = []
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                out.append(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs
                             if d not in _SKIP_DIRS and not d.startswith("."))
            out += [os.path.join(root, f) for f in sorted(files)
                    if f.endswith(".py")]
    return out


class LintEngine:
    def __init__(self, rules=None):
        if rules is None:
            from .rules import default_rules
            rules = default_rules()
        self.rules = rules

    def lint_file(self, path: str) -> list[Violation]:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            ctx = FileContext(path, source)
        except SyntaxError as e:
            return [Violation("SWM000", path, e.lineno or 1, 0,
                              f"syntax error: {e.msg}")]
        out: list[Violation] = []
        for rule in self.rules:
            out += [v for v in rule.check(ctx)
                    if not ctx.suppressed(v.line, v.rule)]
        return sorted(out, key=lambda v: (v.line, v.col, v.rule))

    def lint_paths(self, paths: Iterable[str]) -> list[Violation]:
        out: list[Violation] = []
        for path in discover(paths):
            out += self.lint_file(path)
        return out


def lint_paths(paths: Iterable[str], rules=None) -> list[Violation]:
    return LintEngine(rules).lint_paths(paths)
