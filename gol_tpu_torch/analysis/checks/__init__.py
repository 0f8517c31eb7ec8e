"""Check registry. Each module: CHECK name + run(ctx) and/or
run_project(ctxs) -> findings."""

from gol_tpu_torch.analysis.checks import (
    blocking_io,
    donation,
    dtype_drift,
    host_sync,
    obs_in_jit,
    partition_spec,
    recompile,
    tracer_branch,
)
from gol_tpu_torch.analysis.concurrency import CONCURRENCY_CHECKS

#: Every check the CLI and the tier-1 tests run, in report order —
#: gol_tpu's order, so reports and allowlist keys line up. The
#: concurrency plane (lock-order, lock-blocking, thread-ownership,
#: guarded-field) lives in gol_tpu_torch.analysis.concurrency and
#: registers here like any other check.
ALL_CHECKS = [host_sync, tracer_branch, recompile, dtype_drift, donation,
              obs_in_jit, blocking_io, partition_spec] + CONCURRENCY_CHECKS

__all__ = ["ALL_CHECKS", "blocking_io", "donation", "dtype_drift",
           "host_sync", "obs_in_jit", "partition_spec", "recompile",
           "tracer_branch"]
