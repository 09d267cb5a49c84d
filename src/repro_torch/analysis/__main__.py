"""swarmlint CLI.

    python -m repro_torch.analysis [paths...] [--format=text|github]
                             [--no-kernels | --kernels-only]

Runs the SWM lint rules over the given paths (default: ``src``) and the
kernel signature checker, exiting non-zero on any finding.  GitHub
format emits ``::error`` workflow annotations for the CI gate.
"""
from __future__ import annotations

import argparse
import sys

from .engine import lint_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="swarmlint: SWM rules + kernel signature checker")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files/directories to lint (default: src)")
    ap.add_argument("--format", choices=["text", "github"], default="text")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip the FakeTensorMode kernel signature check")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run only the kernel signature check")
    args = ap.parse_args(argv)

    failed = False
    if not args.kernels_only:
        violations = lint_paths(args.paths or ["src"])
        for v in violations:
            print(v.github() if args.format == "github" else v.text())
        if violations:
            failed = True
        print(f"[swarmlint] {len(violations)} violation(s) in "
              f"{', '.join(args.paths or ['src'])}", file=sys.stderr)
    if not args.no_kernels:
        from .kernels import check_kernel_signatures
        report = check_kernel_signatures()
        for m in report.mismatches:
            if args.format == "github":
                print(f"::error title=kernel-signature::{m.text()}")
            else:
                print(f"kernel-signature: {m.text()}")
        if not report.ok:
            failed = True
        print(f"[swarmlint] kernel signatures: {report.checked} checked, "
              f"{len(report.mismatches)} mismatch(es)", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
