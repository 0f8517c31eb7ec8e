"""torchlint — the static hazard linter's entry surface.

The counterpart of gol_tpu's `jaxlint`, thin by design: parsing,
hot-context discovery and the allowlist live in `core.py`; the hazard
knowledge lives in one module per check under `checks/`. This module
owns the run loop — walk files, build a ModuleContext per module, fan
it through every registered check — and is what the CLI
(`__main__.py`) and the tier-1 tests call.
"""

from __future__ import annotations

import pathlib
from typing import List, Optional, Sequence

from gol_tpu_torch.analysis.core import Finding, ModuleContext, iter_py_files

__all__ = ["lint_paths", "rel_paths"]


def _rel(f: pathlib.Path, root: pathlib.Path) -> str:
    try:
        return f.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return f.as_posix()


def rel_paths(paths: Sequence[pathlib.Path],
              root: pathlib.Path) -> set:
    """Repo-relative paths a lint over `paths` covers — what the strict
    gate feeds Allowlist.stale, so a partial-tree run never declares
    entries for UNSCANNED files stale."""
    return {_rel(f, root) for f in iter_py_files(paths, root)}


def lint_paths(paths: Sequence[pathlib.Path], root: pathlib.Path,
               checks: Optional[Sequence] = None) -> List[Finding]:
    """Run every check over every .py under `paths`; `root` anchors the
    repo-relative paths findings (and allowlist entries) use. A file
    that does not parse yields a single `parse-error` finding rather
    than aborting the run — a syntax error anywhere must not blind the
    linter to the rest of the tree.

    Two check shapes. Per-module checks expose `run(ctx)` and see one
    file at a time. Project checks expose `run_project(ctxs)` and see
    every parsed module at once — what the concurrency passes need: a
    lock-order cycle is a property of the merged lock graph, never of
    one file, and a lock held here across a call that blocks THERE is
    only visible to an interprocedural walk. A check may expose both.
    """
    from gol_tpu_torch.analysis.checks import ALL_CHECKS

    active = list(checks) if checks is not None else list(ALL_CHECKS)
    findings: List[Finding] = []
    ctxs: List[ModuleContext] = []
    for f in iter_py_files(paths, root):
        rel = _rel(f, root)
        try:
            ctx = ModuleContext(f, rel, f.read_text())
        except SyntaxError as e:
            findings.append(Finding("parse-error", rel, e.lineno or 0,
                                    "<module>", f"cannot parse: {e.msg}"))
            continue
        ctxs.append(ctx)
        for mod in active:
            if hasattr(mod, "run"):
                findings.extend(mod.run(ctx))
    for mod in active:
        if hasattr(mod, "run_project"):
            findings.extend(mod.run_project(ctxs))
    findings.sort(key=lambda f: (f.path, f.line, f.check))
    return findings
