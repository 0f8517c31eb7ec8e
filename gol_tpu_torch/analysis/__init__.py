"""Analysis helpers of the port: the runtime invariant checker
(`invariants` — event-stream ordering and stepper dispatch linearity,
behind the `GOL_TPU_CHECK_INVARIANTS` opt-in, cli `--check-invariants`)
and the lock factory (`concurrency.lockcheck`). gol_tpu's static JAX
linter has no counterpart here yet."""

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
    "DispatchLinearityChecker",
    "EventStreamChecker",
    "InvariantViolation",
    "checked_stepper",
    "enable",
    "invariants_enabled",
    "violations_total",
]
