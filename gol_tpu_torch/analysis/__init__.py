"""Machine-checked guardrails for the port's two failure planes.

gol_tpu's `analysis` package, ported: the hazards that silently erase
the card's speed (host syncs on the dispatch path, kernel-library
rebuilds, Python branching on tensor values, dtype drift between the
packed and dense kernel families, in-place decisions on the steppers'
carried state) and the distributed protocol orderings the server and
the multi-process mirror assume (FlipBatch/TurnComplete adjacency, no
flips across a BoardSync, monotone turns, sparse-redo dispatch
identity):

- `torchlint` + `checks/` + `concurrency/`: a pure-AST static linter
  over the package (`python -m gol_tpu_torch.analysis --strict`,
  tier-1 via tests/test_torch_analysis.py), with gol_tpu's check
  names, CLI and allowlist format. Pre-existing findings live in
  `allowlist.txt` WITH a reason each; new hazards fail, and the strict
  gate keeps the allowlist shrink-only.
- `invariants`: a runtime event-stream / dispatch-order monitor wired
  into the engine server's broadcaster and the stepper dispatch chain
  behind the `GOL_TPU_CHECK_INVARIANTS` opt-in (cli
  `--check-invariants`); `concurrency.lockcheck` the lock factory and
  its dynamic order graph.

The linter imports neither torch nor the package it lints — it must
run (and fail usefully) even when the code under analysis cannot
import.
"""

from gol_tpu_torch.analysis.core import Allowlist, Finding
from gol_tpu_torch.analysis.torchlint import lint_paths
from gol_tpu_torch.analysis.invariants import (
    DispatchLinearityChecker,
    EventStreamChecker,
    InvariantViolation,
    checked_stepper,
    enable,
    invariants_enabled,
    violations_total,
)

__all__ = [
    "Allowlist",
    "DispatchLinearityChecker",
    "EventStreamChecker",
    "Finding",
    "InvariantViolation",
    "checked_stepper",
    "enable",
    "invariants_enabled",
    "lint_paths",
    "violations_total",
]
