"""Thread blocks one launch of the kernel the window ran occupies: the
program's `gol_tpu_stepper_launch_blocks{kernel}` gauge (set when the
stepper is built for the board, from the kernel's plan) for the kernel
with the most launches in the window (the program's launch counters).
The fill that caps a board on one cluster: 8 of the card's 132 SMs at
512². None where the program sets no such gauge."""

from perfbench.harness import series


def read(seen):
    launched = {}
    for kernel in seen.launches.get("after", {}):
        n = seen.launch_delta(kernel)
        if n:
            launched[kernel] = n
    if not launched:
        return None
    kernel = max(launched, key=launched.get)
    entry = seen.registry.get("after", {}).get(
        series("gol_tpu_stepper_launch_blocks", kernel=kernel))
    return None if entry is None else entry["value"]
