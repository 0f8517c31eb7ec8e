"""Share of the window the engine spent enqueuing fused chunks: the
growth of the program's
`gol_tpu_device_dispatch_split_seconds{phase="enqueue"}` over the
window's length."""

from perfbench.harness import series


def read(seen):
    total = seen.delta(series("gol_tpu_device_dispatch_split_seconds",
                              phase="enqueue"))
    if total is None or seen.window_s <= 0:
        return None
    return 100.0 * total / seen.window_s
