"""Kernel A's share of its roofline in a cell whose board fits one
cluster (512²): the least time for the work its traced launches did
(operations bound it: 12 INT32 instructions per packed word per turn, at
the whole card's rate) over their summed time in the device trace. Each
launch is one fused chunk, every turn of it on the cluster's slabs; its
turns are the window's engine turns over the kernel's launches (the
program's counters). The count is the same whatever implements the
step, so a plan that spreads the board over more SMs raises it."""

from perfbench import yardstick
from perfbench.harness import series


def read(seen):
    launches, seconds = seen.kernel("bitlife_resident")
    turns = seen.delta(series("gol_tpu_engine_turns_total", kind="chunk"))
    counted = seen.launch_delta("bitlife_resident")
    if not launches or not counted or not turns:
        return None
    cfg = seen.config
    words = yardstick.packed_words(cfg["height"], cfg["width"])
    share = yardstick.life_roofline_pct(launches, seconds, words,
                                        turns / counted)
    return None if share is None else share[0]
