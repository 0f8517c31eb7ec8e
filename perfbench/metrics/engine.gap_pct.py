"""Share of the window in which the card idled between two fused
chunks, as the card's own timing events measure it: the growth of
`gol_tpu_engine_device_gap_seconds`, summed over its `after` labels
(drain, census, enqueue: what the engine thread did between the two
enqueues), over the window's length. Set only where the chunks are
timed by CUDA events."""

PREFIX = "gol_tpu_engine_device_gap_seconds{"


def read(seen):
    after = seen.registry.get("after", {})
    labels = [s for s in after if s.startswith(PREFIX)]
    if not labels or seen.window_s <= 0:
        return None
    total = 0.0
    for s in labels:
        d = seen.delta(s)
        if d is None:
            return None
        total += d
    return 100.0 * total / seen.window_s
