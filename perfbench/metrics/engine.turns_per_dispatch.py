"""Turns per fused chunk in the window: the growth of the program's
`gol_tpu_engine_turns_total{kind="chunk"}` over that of
`gol_tpu_engine_dispatches_total{kind="chunk"}`."""

from perfbench.harness import series


def read(seen):
    turns = seen.delta(series("gol_tpu_engine_turns_total", kind="chunk"))
    chunks = seen.delta(series("gol_tpu_engine_dispatches_total",
                               kind="chunk"))
    if not chunks:
        return None
    return turns / chunks
