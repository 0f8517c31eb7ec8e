"""gol_tpu_torch.testing — deterministic fault injection, as in
`gol_tpu.testing`.

Production code imports this lazily and only consults it when
`GOL_TPU_FAULTS` is set (or a plan was installed programmatically), so
the package costs nothing on the happy path. See `faults.py` for the
spec grammar and the FaultySocket wrapper. `leaks.py` adds the per-test
concurrency guard: lockcheck forced ON plus a thread/socket leak census
around each distributed test. `chaos.py` is the seeded chaos harness
(verb storms, stalled observers and a SIGKILLed `--serve --sessions`
process, judged against the plain oracle); import it as
`gol_tpu_torch.testing.chaos`."""

from gol_tpu_torch.testing.faults import (
    FaultPlan,
    FaultRule,
    FaultSpecError,
    FaultySocket,
    active_plan,
    clear,
    install,
    wrap,
)
from gol_tpu_torch.testing.leaks import assert_no_leaks, lockcheck_guard

__all__ = [
    "assert_no_leaks",
    "lockcheck_guard",
    "FaultPlan",
    "FaultRule",
    "FaultSpecError",
    "FaultySocket",
    "active_plan",
    "clear",
    "install",
    "wrap",
]
