"""SWM006 on PyTorch — count matmuls on the card, and TF32 turned on.

A float32 matmul on an H100 may run on the tensor cores in TF32, whose
10-bit mantissa rounds integer counts above 2**11: the port's keyword
plane lost matches that way until its count product was made an exact
bit test.  This is the TPU's bf16 lesson of ``precision_rules.py``
stated for PyTorch.  In a module that imports ``torch`` the rule flags

* a ``@`` / ``torch.matmul`` / ``mm`` / ``bmm`` / ``einsum`` whose
  operands are count-like (histograms, one-hots, masks, bucket ids: the
  tokens of ``precision_rules.py``) — nothing in the call can pin its
  precision, so a site that is exact by construction says why with the
  engine's pragma (``# swarmlint: disable=SWM006`` and a reason);
* TF32 being turned on under ``src/``: ``…allow_tf32 = True``,
  ``torch.set_float32_matmul_precision("high" | "medium")`` or an
  ``fp32_precision`` of ``"tf32"``.
"""
from __future__ import annotations

import ast

from ..engine import FileContext, Violation, _callee_name
from .precision_rules import _county

_MATMUL_CALLS = {"matmul", "mm", "bmm", "einsum"}
_TF32_PRECISIONS = {"high", "medium"}


def _imports_torch(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "torch" for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom) and not node.level \
                and (node.module or "").split(".")[0] == "torch":
            return True
    return False


def _is_true(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _string(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class TorchCountMatmul:
    code = "SWM006"
    summary = ("count-operand matmul in torch code, or TF32 turned on — "
               "TF32 tensor-core inputs round counts above 2**11")

    def check(self, ctx: FileContext):
        if not _imports_torch(ctx.tree):
            return
        under_src = "/src/" in f"/{ctx.posix_path}"
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.MatMult):
                hit = _county(node.left, node.right)
                if hit:
                    yield Violation(
                        self.code, ctx.path, node.lineno, node.col_offset,
                        f"`@` over count-like operand ({hit}) runs in TF32 "
                        "where TF32 is on — count with integer or boolean "
                        "ops, or state why it is exact")
            elif isinstance(node, ast.Call) \
                    and _callee_name(node.func) in _MATMUL_CALLS:
                hit = _county(*node.args)
                if hit:
                    yield Violation(
                        self.code, ctx.path, node.lineno, node.col_offset,
                        f"`{_callee_name(node.func)}` over count-like "
                        f"operand ({hit}) runs in TF32 where TF32 is on — "
                        "count with integer or boolean ops, or state why "
                        "it is exact")
            if not under_src:
                continue
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    name = _callee_name(target)
                    if (name == "allow_tf32" and _is_true(node.value)) or (
                            name == "fp32_precision"
                            and _string(node.value) == "tf32"):
                        yield Violation(
                            self.code, ctx.path, node.lineno,
                            node.col_offset,
                            f"`{name}` turns TF32 on: float32 products "
                            "round to a 10-bit mantissa")
            elif isinstance(node, ast.Call) and _callee_name(node.func) \
                    == "set_float32_matmul_precision" and node.args \
                    and _string(node.args[0]) in _TF32_PRECISIONS:
                yield Violation(
                    self.code, ctx.path, node.lineno, node.col_offset,
                    "`set_float32_matmul_precision("
                    f"{_string(node.args[0])!r})` lets float32 products "
                    "run in TF32")
