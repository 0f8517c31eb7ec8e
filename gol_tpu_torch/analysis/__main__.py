"""CLI: `python -m gol_tpu_torch.analysis [--strict] [paths...]`.

Default target is the `gol_tpu_torch/` package of the repo this file
sits in. Exit codes: 0 = clean (every finding allowlisted, no stale
entries in --strict), 1 = new findings (or, with --strict, stale
allowlist entries), 2 = usage/allowlist-format errors.

The allowlist (`gol_tpu_torch/analysis/allowlist.txt`) is shrink-only
by contract: new hazards must be fixed, not added to it — the strict
gate fails on an entry whose finding is gone, so the finding count can
only go down.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from gol_tpu_torch.analysis.core import Allowlist, AllowlistError
from gol_tpu_torch.analysis.torchlint import lint_paths, rel_paths

_HERE = pathlib.Path(__file__).resolve().parent
_DEFAULT_ALLOWLIST = _HERE / "allowlist.txt"
_REPO_ROOT = _HERE.parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gol_tpu_torch.analysis",
        description="PyTorch/CUDA hazard linter: host syncs, tensor "
                    "branching, kernel-library rebuilds, dtype drift, "
                    "donation decisions, and the concurrency passes",
    )
    ap.add_argument("paths", nargs="*", type=pathlib.Path,
                    help="files/dirs to lint (default: the gol_tpu_torch "
                         "package)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale allowlist entries (CI mode: "
                         "the finding count can only go down)")
    ap.add_argument("--allowlist", type=pathlib.Path,
                    default=_DEFAULT_ALLOWLIST, metavar="FILE",
                    help="grandfathered findings (default: the committed "
                         "gol_tpu_torch/analysis/allowlist.txt)")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="report every finding, grandfathered or not")
    ap.add_argument("--root", type=pathlib.Path, default=_REPO_ROOT,
                    help=argparse.SUPPRESS)  # tests re-anchor rel paths
    ap.add_argument("--list-checks", action="store_true",
                    help="print the registered checks and exit")
    args = ap.parse_args(argv)

    if args.list_checks:
        from gol_tpu_torch.analysis.checks import ALL_CHECKS

        for mod in ALL_CHECKS:
            doc = (mod.__doc__ or "").strip().splitlines()[0]
            print(f"{mod.CHECK:15s} {doc}")
        return 0

    paths = args.paths or [_HERE.parent]
    allow = Allowlist()
    if not args.no_allowlist and args.allowlist.exists():
        try:
            allow = Allowlist.load(args.allowlist)
        except AllowlistError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    findings = lint_paths(paths, args.root)
    fresh = [f for f in findings if not allow.allows(f)]
    grandfathered = len(findings) - len(fresh)
    # Staleness is only provable for files this run scanned: a
    # partial-tree invocation must not fail the shrink-only gate over
    # entries it never looked at.
    stale = allow.stale(findings, scanned=rel_paths(paths, args.root))

    for f in fresh:
        print(f.render())
    print(f"# {len(findings)} finding(s), {grandfathered} grandfathered "
          f"({args.allowlist.name})")
    if stale and args.strict:
        for e in stale:
            print(f"# STALE allowlist entry ({args.allowlist.name}:"
                  f"{e.lineno}): {e.check} | {e.path} | {e.scope} — the "
                  "finding is gone; delete the entry", file=sys.stderr)
    if fresh:
        print(f"{len(fresh)} new finding(s) — fix them, or allowlist "
              "with a reason", file=sys.stderr)
        return 1
    if stale and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
