"""Share of the window the engine thread spent blocked waiting out the
launch queue: realising a count or fetching a board for a request
(the ticker's counts, the window's edge readings, board syncs). The
growth of the program's
`gol_tpu_engine_thread_seconds{phase="drain"}` over the window's
length."""

from perfbench.harness import series


def read(seen):
    total = seen.delta(series("gol_tpu_engine_thread_seconds",
                              phase="drain"))
    if total is None or seen.window_s <= 0:
        return None
    return 100.0 * total / seen.window_s
