"""Card work queued ahead of the host at a fused boundary, in ms: the
mean over the window's boundaries of the program's
`gol_tpu_engine_run_ahead_seconds` (turns enqueued and not yet
complete, times the newest complete chunk's device seconds per turn),
its sum's growth over its count's."""

NAME = "gol_tpu_engine_run_ahead_seconds"


def read(seen):
    edges = [seen.registry.get(e, {}).get(NAME) for e in ("before", "after")]
    if None in edges:
        return None
    before, after = (e["value"] for e in edges)
    n = after["count"] - before["count"]
    if n <= 0:
        return None
    return 1e3 * (after["sum"] - before["sum"]) / n
