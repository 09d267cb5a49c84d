"""SWM001/SWM002 — jit-lifecycle and traced-body purity rules.

The planes compile once per shape *bucket* (``_pad_pow2``/``_pad64``)
and cache the executable (``self._jit_* = jax.jit(...)`` at init, or a
keyed ``_window_cache``).  Code that constructs a fresh ``jax.jit`` /
``shard_map`` inside a loop, or jits-and-calls inline, defeats that
convention: every call re-traces and re-compiles (SWM001).

Anything reachable from a traced body runs at *trace* time, not at run
time: a ``time.time()`` read is baked in as a constant, ``np.random``
draws once per compilation, host I/O and tracer calls fire on re-trace
only.  SWM002 flags those inside jitted / ``lax.scan`` / ``shard_map``
bodies — the telemetry contract (DESIGN.md §9) keeps tracer use in the
un-jitted wrappers for exactly this reason.
"""
from __future__ import annotations

import ast

from ..engine import (FileContext, Violation, _callee_name, _is_partial,
                      walk_body)

_JIT_MAKERS = {"jit", "shard_map", "pmap"}
_IO_CALLS = {"print", "open", "input"}
_TRACER_METHODS = {"span", "instant", "counter", "record_decision",
                   "emit_span", "record"}


def _is_jit_maker(call: ast.Call) -> bool:
    name = _callee_name(call.func)
    if name in _JIT_MAKERS:
        return True
    return bool(_is_partial(call) and call.args
                and _callee_name(call.args[0]) in _JIT_MAKERS)


class JitRecompileHazard:
    code = "SWM001"
    summary = ("jax.jit/shard_map constructed per call (loop body or "
               "inline invocation) — compile once and cache, keyed by "
               "the pow2 shape bucket")

    def check(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.While)):
                yield from self._loop_body(ctx, node)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Call) \
                    and _is_jit_maker(node.func):
                yield Violation(
                    self.code, ctx.path, node.lineno, node.col_offset,
                    "inline jax.jit(f)(...) builds and discards an "
                    "executable every call — hoist the jit and reuse it "
                    "(pad args to the pow2 bucket or mark them static)")

    def _loop_body(self, ctx: FileContext, loop: ast.For | ast.While):
        for stmt in loop.body + getattr(loop, "orelse", []):
            for node in ast.walk(stmt):
                # a function *defined* in the loop is constructed, not
                # called — only flag direct jit construction
                if isinstance(node, ast.Call) and _is_jit_maker(node) \
                        and not isinstance(node.func, ast.Call):
                    yield Violation(
                        self.code, ctx.path, node.lineno, node.col_offset,
                        "jax.jit/shard_map constructed inside a loop — "
                        "each iteration re-traces and re-compiles; build "
                        "once outside (cache keyed by shape bucket / "
                        "static args)")


class TracedSideEffects:
    code = "SWM002"
    summary = ("side effect inside a traced body (jit / lax.scan / "
               "shard_map): wall clock, global RNG, host I/O and tracer "
               "calls run at trace time, not per step")

    def check(self, ctx: FileContext):
        for fn in ctx.traced_bodies():
            for node in walk_body(fn):
                if not isinstance(node, ast.Call):
                    continue
                msg = self._effect(node)
                if msg:
                    yield Violation(self.code, ctx.path, node.lineno,
                                    node.col_offset, msg)

    def _effect(self, call: ast.Call) -> str | None:
        func = call.func
        if isinstance(func, ast.Name) and func.id in _IO_CALLS:
            return (f"host I/O `{func.id}(...)` inside a traced body "
                    "runs only at trace time — use jax.debug or hoist "
                    "to the un-jitted wrapper")
        if not isinstance(func, ast.Attribute):
            return None
        base = func.value
        if isinstance(base, ast.Name):
            if base.id == "time":
                return (f"`time.{func.attr}()` inside a traced body is "
                        "a trace-time constant — time in the caller "
                        "(telemetry.timers)")
            if base.id in ("tr", "tracer"):
                if func.attr in _TRACER_METHODS:
                    return (f"tracer call `.{func.attr}(...)` inside a "
                            "traced body fires on re-trace only — emit "
                            "spans from the un-jitted wrapper")
        if isinstance(base, ast.Attribute) and base.attr == "random" \
                and isinstance(base.value, ast.Name) \
                and base.value.id in ("np", "numpy"):
            return (f"`np.random.{func.attr}` inside a traced body "
                    "draws once at trace time — use jax.random with a "
                    "threaded key")
        if isinstance(base, ast.Attribute) and base.attr == "tracer" \
                and func.attr in _TRACER_METHODS:
            return (f"tracer call `.{func.attr}(...)` inside a traced "
                    "body fires on re-trace only — emit spans from the "
                    "un-jitted wrapper")
        return None
