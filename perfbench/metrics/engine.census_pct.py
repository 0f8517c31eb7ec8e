"""Share of the window spent in the program's memory census (the
allocator's statistics and the card's total memory, read at most twice
a second from the stepper's dispatch boundary, on the engine thread in
the batch cell): the growth of `gol_tpu_device_census_seconds` over
the window's length. `engine.enqueue_pct` includes it."""


def read(seen):
    total = seen.delta("gol_tpu_device_census_seconds")
    if total is None or seen.window_s <= 0:
        return None
    return 100.0 * total / seen.window_s
