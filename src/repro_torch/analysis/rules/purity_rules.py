"""SWM003/SWM004/SWM005 — RNG, event immutability and clock discipline.

* SWM003: every random draw in ``src/`` goes through a threaded
  ``np.random.Generator`` (``default_rng(seed)``) so experiments are
  replayable end-to-end; module-global ``np.random.<fn>`` state breaks
  the same-seed determinism pins.
* SWM004: the ``streaming/api.py`` event types are frozen dataclasses —
  the latch-free reader contract (§4.3.1) depends on events never
  mutating after publication.  Assigning to their fields (or bypassing
  via ``object.__setattr__``) is flagged statically instead of failing
  at run time.
* SWM005: wall-clock reads live in ``telemetry/timers.py`` (Stopwatch /
  time_us) and the tracer's epoch — one clock, one place; ad-hoc
  ``time.time()`` deltas elsewhere fragment the timing story the
  flight recorder tells.
"""
from __future__ import annotations

import ast
import os
from functools import lru_cache

from ..engine import FileContext, Violation

_RNG_FACTORY_OK = {"default_rng", "Generator", "SeedSequence",
                   "BitGenerator", "PCG64", "PCG64DXSM", "Philox",
                   "RandomState"}

_CLOCK_ATTRS = {"time", "time_ns", "perf_counter", "perf_counter_ns",
                "monotonic", "monotonic_ns", "process_time",
                "process_time_ns", "clock_gettime"}
_CLOCK_ALLOWLIST = ("telemetry/timers.py", "telemetry/tracer.py")


class GlobalStateRNG:
    code = "SWM003"
    summary = ("np.random.<fn> uses the module-global RNG — thread a "
               "seeded np.random.default_rng Generator instead")

    def check(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Attribute):
                continue
            base = node.value
            if isinstance(base, ast.Attribute) and base.attr == "random" \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id in ("np", "numpy") \
                    and node.attr not in _RNG_FACTORY_OK:
                yield Violation(
                    self.code, ctx.path, node.lineno, node.col_offset,
                    f"`np.random.{node.attr}` draws from global RNG "
                    "state — same-seed replay breaks; use a threaded "
                    "np.random.default_rng(seed) Generator")


@lru_cache(maxsize=1)
def frozen_event_names() -> frozenset[str]:
    """Names of the frozen dataclasses in ``streaming/api.py`` — the
    repo's source of truth for the event vocabulary."""
    api = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                       "streaming", "api.py")
    try:
        with open(api, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except OSError:
        return frozenset()
    return frozenset(_frozen_classes(tree))


def _frozen_classes(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and any(
                _is_frozen_dataclass(d) for d in node.decorator_list):
            yield node.name


def _is_frozen_dataclass(dec: ast.AST) -> bool:
    if not isinstance(dec, ast.Call):
        return False
    name = dec.func.id if isinstance(dec.func, ast.Name) else (
        dec.func.attr if isinstance(dec.func, ast.Attribute) else None)
    return name == "dataclass" and any(
        kw.arg == "frozen" and isinstance(kw.value, ast.Constant)
        and kw.value.value is True for kw in dec.keywords)


class FrozenEventAssignment:
    code = "SWM004"
    summary = ("assignment to a field of a frozen event dataclass — "
               "events are immutable after publication; use "
               "dataclasses.replace")

    def check(self, ctx: FileContext):
        frozen = set(frozen_event_names())
        frozen.update(_frozen_classes(ctx.tree))
        if not frozen:
            return
        # module scope: top-level statements only (function bodies get
        # their own scope with their own bindings)
        module_stmts = [s for s in ctx.tree.body
                        if not isinstance(s, (ast.FunctionDef,
                                              ast.AsyncFunctionDef,
                                              ast.ClassDef))]
        yield from self._scope(ctx, module_stmts, frozen, args=None)
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._scope(ctx, node.body, frozen,
                                       args=node.args)

    def _scope(self, ctx, stmts, frozen, args):
        bound: dict[str, str] = {}
        if args is not None:
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                cls = _annotation_name(a.annotation)
                if cls in frozen:
                    bound[a.arg] = cls
        nodes = [n for s in stmts for n in ast.walk(s)]
        for node in nodes:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                cls = _trailing_name(node.value.func)
                if cls in frozen:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            bound[tgt.id] = cls
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                cls = _annotation_name(node.annotation)
                if cls in frozen:
                    bound[node.target.id] = cls
        if not bound:
            return
        for node in nodes:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id in bound \
                        and tgt.value.id != "self":
                    yield Violation(
                        self.code, ctx.path, tgt.lineno, tgt.col_offset,
                        f"`{tgt.value.id}.{tgt.attr} = ...` mutates "
                        f"frozen event {bound[tgt.value.id]} — events "
                        "are immutable; build a new one with "
                        "dataclasses.replace")
            if isinstance(node, ast.Call) \
                    and _trailing_name(node.func) == "__setattr__" \
                    and len(node.args) >= 1 \
                    and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in bound \
                    and node.args[0].id != "self":
                yield Violation(
                    self.code, ctx.path, node.lineno, node.col_offset,
                    f"object.__setattr__ on frozen event "
                    f"{bound[node.args[0].id]} bypasses immutability — "
                    "use dataclasses.replace")


def _trailing_name(func: ast.AST) -> str | None:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _annotation_name(ann: ast.AST | None) -> str | None:
    if ann is None:
        return None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1]
    return None


class WallClockOutsideTimers:
    code = "SWM005"
    summary = ("raw wall-clock read outside telemetry/timers.py — use "
               "Stopwatch / time_us / time_once_us")

    def check(self, ctx: FileContext):
        if ctx.posix_path.endswith(_CLOCK_ALLOWLIST):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or not isinstance(node.func, ast.Attribute):
                continue
            func = node.func
            base = func.value
            if isinstance(base, ast.Name) and base.id == "time" \
                    and func.attr in _CLOCK_ATTRS:
                yield Violation(
                    self.code, ctx.path, node.lineno, node.col_offset,
                    f"raw `time.{func.attr}()` — wall-clock reads live "
                    "in telemetry.timers (Stopwatch/time_us) so every "
                    "report shares one clock")
            elif func.attr in ("now", "utcnow") and (
                    (isinstance(base, ast.Name) and base.id == "datetime")
                    or (isinstance(base, ast.Attribute)
                        and base.attr == "datetime")):
                yield Violation(
                    self.code, ctx.path, node.lineno, node.col_offset,
                    f"`datetime.{func.attr}()` wall-clock read — use "
                    "telemetry.timers")
