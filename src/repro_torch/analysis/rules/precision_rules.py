"""SWM006 — low-precision count matmuls (the PR 4 bf16-rounding rule).

TPU MXU matmuls default to bf16 input precision: integer counts above
256 round, which silently corrupts histogram contractions (the fused
engine's per-cell count matmul produced off-by-a-few collector rows
until PR 4 pinned ``precision=HIGHEST``).  Any ``@`` / ``jnp.matmul`` /
``jnp.dot`` / ``jnp.einsum`` / ``lax.dot_general`` whose operands are
count-like (histograms, one-hots, masks, bucket/partition ids) must
request ``precision=...HIGHEST`` or pin an exact accumulator dtype via
``preferred_element_type``.

Scope: kernel packages (``kernels/``) and traced bodies — where arrays
are device arrays.  Host NumPy matmuls are exact and exempt.
"""
from __future__ import annotations

import ast
import re

from ..engine import FileContext, Violation, _callee_name, walk_body

_MATMUL_CALLS = {"matmul", "dot", "einsum", "dot_general", "tensordot"}
_COUNT_TOKENS = {"hist", "hists", "hist2d", "histogram", "histograms",
                 "count", "counts", "cnt", "cnts", "onehot", "onehots",
                 "oh", "mask", "masks", "bucket", "buckets"}
_SPLIT = re.compile(r"[^a-z]+")


def _tokens(expr: ast.AST) -> set[str]:
    toks: set[str] = set()
    for node in ast.walk(expr):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name:
            toks.update(t for t in _SPLIT.split(name.lower()) if t)
    return toks


def _county(*exprs: ast.AST) -> str | None:
    for expr in exprs:
        hit = _tokens(expr) & _COUNT_TOKENS
        if hit:
            return sorted(hit)[0]
    return None


class LowPrecisionCountMatmul:
    code = "SWM006"
    summary = ("count-operand matmul without precision=HIGHEST / "
               "preferred_element_type — bf16 MXU inputs round counts "
               "above 256")

    def check(self, ctx: FileContext):
        in_kernels = "/kernels/" in f"/{ctx.posix_path}"
        if in_kernels:
            nodes = ast.walk(ctx.tree)
        else:
            nodes = (n for fn in ctx.traced_bodies() for n in walk_body(fn))
        for node in nodes:
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.MatMult):
                hit = _county(node.left, node.right)
                if hit:
                    yield Violation(
                        self.code, ctx.path, node.lineno, node.col_offset,
                        f"`@` over count-like operand ({hit}) cannot "
                        "request precision — use jnp.matmul(..., "
                        "precision=jax.lax.Precision.HIGHEST)")
            elif isinstance(node, ast.Call) \
                    and _callee_name(node.func) in _MATMUL_CALLS:
                kwargs = {kw.arg for kw in node.keywords}
                if kwargs & {"precision", "preferred_element_type"}:
                    continue
                hit = _county(*node.args)
                if hit:
                    yield Violation(
                        self.code, ctx.path, node.lineno, node.col_offset,
                        f"`{_callee_name(node.func)}` over count-like "
                        f"operand ({hit}) defaults to bf16 MXU inputs — "
                        "pass precision=jax.lax.Precision.HIGHEST (or "
                        "preferred_element_type)")
