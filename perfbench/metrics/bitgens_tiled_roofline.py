"""Kernel D's share of its roofline in a Brian's Brain (B2/S/C3) cell:
the least time for the work its traced launches did (operations bound
it: 12 INT32 instructions per packed word of one plane per turn) over
their summed time in the device trace. Each launch is one pass over
both planes' words; its turns are the window's engine turns over the
kernel's launches (the program's counters)."""

from perfbench import yardstick, yardstick_gens
from perfbench.harness import series


def read(seen):
    launches, seconds = seen.kernel("bitgens_tiled")
    turns = seen.delta(series("gol_tpu_engine_turns_total", kind="chunk"))
    counted = seen.launch_delta("bitgens_tiled")
    if not launches or not counted or not turns:
        return None
    cfg = seen.config
    words = yardstick.packed_words(cfg["height"], cfg["width"])
    share = yardstick_gens.brain_roofline_pct(launches, seconds, words,
                                              turns / counted)
    return None if share is None else share[0]
