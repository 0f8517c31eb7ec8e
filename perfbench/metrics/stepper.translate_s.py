"""Seconds the Generations stepper spent translating the board from gray
levels to states on the host when the engine put it on the card: the
program's `gol_tpu_stepper_translate_seconds{entry="put"}` sum at the
window's end (the one put is set-up's)."""

from perfbench.harness import series


def read(seen):
    entry = seen.registry.get("after", {}).get(
        series("gol_tpu_stepper_translate_seconds", entry="put"))
    return None if entry is None else entry["value"]["sum"]
