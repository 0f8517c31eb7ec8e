"""Seconds the engine's auto-chunk calibration took, from its first
measurement to convergence: the program's
`gol_tpu_engine_setup_seconds{phase="calibrate"}` at the window's end
(the calibration converges before the window opens)."""

from perfbench.harness import series


def read(seen):
    entry = seen.registry.get("after", {}).get(
        series("gol_tpu_engine_setup_seconds", phase="calibrate"))
    return None if entry is None else entry["value"]
