"""Static kernel signature checker — ``FakeTensorMode`` twin-diffing.

The port's twin of the JAX package's ``analysis/kernels.py``.  Every
kernel package ships an ``ops.py`` entry point (checks → the kernel's
``torch.library`` op → the hand-written CUDA kernel) and a plain
PyTorch ``ref.py`` version.  The parity tests compare *values* on small
shapes; this checker compares **signatures** — output tree structure
(``tree.py``), shapes and dtypes — across a grid of input shapes
(aligned and ragged) without a device or any data: each entry runs under
``FakeTensorMode`` on fake **CUDA** tensors, so its CUDA path is traced
through the ops' fake implementations (no kernel is built or launched),
and each ref on fake tensors of the same shapes and types.  A torch
built without CUDA cannot index a fake CUDA tensor, which the refs do,
so there the refs run on fake CPU tensors (a ref's signature does not
depend on its device); every entry output must lie on the card.

The cases are the JAX package's eight over its grids, 19 checks; where
the port's entry takes its arguments otherwise, the case says so.

Used by ``python -m repro_torch.analysis`` (on by default;
``--no-kernels`` skips).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Sequence

import torch

from .. import tree as T


class Spec(NamedTuple):
    """A tensor argument by shape and dtype (``jax.ShapeDtypeStruct``'s
    twin)."""
    shape: tuple
    dtype: torch.dtype


@dataclass
class KernelCase:
    """One entry/ref pair checked across ``arg_grids``: each grid entry
    is a tuple of :class:`Spec` positional args; ``note`` labels the
    sweep in reports."""
    name: str
    entry: Callable[..., Any]
    ref: Callable[..., Any]
    arg_grids: Sequence[tuple]
    note: str = ""


@dataclass
class SignatureMismatch:
    case: str
    args: str
    detail: str

    def text(self) -> str:
        return f"{self.case}({self.args}): {self.detail}"


@dataclass
class KernelReport:
    checked: int = 0
    mismatches: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.mismatches


def default_cases() -> list[KernelCase]:
    from ..kernels import (flash_attention, keyword_match, knn_match,
                           moe_histogram, spatial_match, stats_update)
    from ..kernels.stats_update.ops import OUT_CH

    f32, i32, bf16 = torch.float32, torch.int32, torch.bfloat16
    S = Spec

    def inputs_ref(bank6):
        # rebuild the full 8-channel bank (R/PRESPANQ need no input),
        # run the plain version, select the maintained output channels
        z = torch.zeros_like(bank6[0])
        full = torch.stack([bank6[0], bank6[1], z, bank6[2], z,
                            bank6[3], bank6[4], bank6[5]])
        out = stats_update.close_round_ref(full)
        return torch.stack([out[c] for c in OUT_CH])

    return [
        KernelCase(
            "spatial_match", spatial_match.spatial_match,
            spatial_match.spatial_match_ref,
            [(S((n, 2), f32), S((q, 4), f32))
             for n, q in [(7, 5), (128, 64), (130, 257)]],
            note="per-point / per-rect hit counts, ragged + aligned N,Q"),
        KernelCase(
            "keyword_match", keyword_match.keyword_match,
            keyword_match.keyword_match_ref,
            [(S((n, 2), f32), S((n, t), f32),
              S((q, 4), f32), S((q, t), f32))
             for n, t, q in [(16, 8, 4), (130, 33, 57)]],
            note="spatial ∧ keyword-subset counts"),
        KernelCase(
            "knn_match", functools.partial(knn_match.knn_match, k=8),
            lambda p, f: knn_match.knn_match_ref(p, f, 8),
            [(S((n, 2), f32), S((q, 2), f32))
             for n, q in [(64, 16), (200, 33)]],
            note="k=8 ascending squared distances"),
        KernelCase(
            "moe_histogram",
            functools.partial(moe_histogram.moe_histogram, num_experts=8),
            lambda i, g: moe_histogram.moe_histogram_ref(i, g, 8),
            [(S((t, k), i32), S((t, k), f32))
             for t, k in [(64, 4), (130, 2)]],
            note="per-expert (count, gate-load) histograms"),
        KernelCase(
            "stats_update.close_round", stats_update.close_round,
            stats_update.close_round_ref,
            [(S((8, p, g1), f32),) for p, g1 in [(8, 65), (33, 513)]],
            note="K1 round close of the whole bank vs the plain version"),
        KernelCase(
            "stats_update.close_round_xla", stats_update.close_round_xla,
            stats_update.close_round_ref,
            [(S((8, p, g1), f32),) for p, g1 in [(8, 65), (33, 513)]],
            note="blocked-cumsum round close (the JAX package's portable "
                 "XLA fold, in torch ops) vs the plain version"),
        KernelCase(
            "stats_update.close_round_inputs",
            stats_update.close_round_inputs, inputs_ref,
            [(S((6, p, g1), f32),) for p, g1 in [(8, 65), (33, 513)]],
            note="transfer-minimal 6-in/5-out fold vs derived plain "
                 "version"),
        KernelCase(
            "flash_attention", flash_attention.flash_attention,
            flash_attention.attention_ref,
            [(S((b, h, s, d), dt), S((b, h, s, d), dt),
              S((b, h, s, d), dt))
             for b, h, s, d in [(1, 2, 16, 8), (2, 4, 100, 16)]
             for dt in (f32, bf16)],
            note="causal self-attention (B, H, S, D), f32 + bf16, ragged "
                 "seq; D = 8 is zero-padded to a built head dim on the "
                 "card, inside the op"),
    ]


ENTRY_DEVICE = "cuda"


def ref_device() -> str:
    """Where the refs run: the card's fake tensors where torch is built
    with CUDA, fake CPU tensors otherwise (module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _signature(fn, args, device):
    """(structure, [(shape, dtype)], devices) of ``fn``'s outputs on
    fake tensors of ``args``' specs on ``device``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn(*(torch.empty(a.shape, dtype=a.dtype, device=device)
                   for a in args))
    leaves = T.leaves(out)
    return (T.map(lambda _: None, out),
            [(tuple(t.shape), str(t.dtype)) for t in leaves],
            {t.device.type for t in leaves})


def check_kernel_signatures(cases: Sequence[KernelCase] | None = None
                            ) -> KernelReport:
    """Diff every case's entry vs ref signature across its shape grid;
    returns a report with one mismatch per divergence."""
    report = KernelReport()
    for case in (default_cases() if cases is None else cases):
        for args in case.arg_grids:
            desc = ", ".join(f"{tuple(a.shape)}:{a.dtype}" for a in args)
            report.checked += 1
            try:
                tree_e, sig_e, dev_e = _signature(case.entry, args,
                                                  ENTRY_DEVICE)
            except Exception as e:
                report.mismatches.append(SignatureMismatch(
                    case.name, desc, f"entry failed to trace: "
                    f"{type(e).__name__}: {e}"))
                continue
            try:
                tree_r, sig_r, _ = _signature(case.ref, args, ref_device())
            except Exception as e:
                report.mismatches.append(SignatureMismatch(
                    case.name, desc, f"ref failed to trace: "
                    f"{type(e).__name__}: {e}"))
                continue
            if tree_e != tree_r:
                report.mismatches.append(SignatureMismatch(
                    case.name, desc,
                    f"output tree differs: entry {tree_e} vs ref "
                    f"{tree_r}"))
            elif sig_e != sig_r:
                report.mismatches.append(SignatureMismatch(
                    case.name, desc,
                    f"signature differs: entry {sig_e} vs ref {sig_r}"))
            elif dev_e != {ENTRY_DEVICE}:
                report.mismatches.append(SignatureMismatch(
                    case.name, desc,
                    f"entry outputs on {sorted(dev_e)}, not the card"))
    return report
