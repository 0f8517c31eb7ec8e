"""Device plane — the part of `gol_tpu.obs.device` the engine calls:
`cause()`, which labels WHY device work happened inside a block (the
kernel build records it — see ops/_build.py), and `observe_split()`,
which records a dispatch's device-vs-host time split.

Host-side only: nothing here synchronises the device.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from gol_tpu_torch import obs

__all__ = ["cause", "current_cause", "observe_split"]

CAUSE_UNATTRIBUTED = "unattributed"

_cause_stack = threading.local()


@contextlib.contextmanager
def cause(label: str):
    """Declare why device work inside this block happened (thread-local,
    nestable — innermost wins)."""
    stack = getattr(_cause_stack, "stack", None)
    if stack is None:
        stack = _cause_stack.stack = []
    stack.append(str(label))
    try:
        yield
    finally:
        stack.pop()


def current_cause() -> str:
    stack = getattr(_cause_stack, "stack", None)
    return stack[-1] if stack else CAUSE_UNATTRIBUTED


_SPLIT = {
    p: obs.histogram(
        "gol_tpu_device_dispatch_split_seconds",
        "Per-dispatch wall seconds split at the synchronisation "
        "boundaries: enqueue (dispatch call returning), sync (fetched "
        "buffers materialising = device work + transfer), host (decode "
        "+ event fan-out)",
        {"phase": p},
    ) for p in ("enqueue", "sync", "host")
}
_DEVICE_FRACTION = obs.gauge(
    "gol_tpu_device_fraction",
    "Last fully-split dispatch's sync share of its wall time "
    "(device work + transfer over enqueue+sync+host)",
)


def observe_split(enqueue_s: Optional[float] = None,
                  sync_s: Optional[float] = None,
                  host_s: Optional[float] = None) -> None:
    """Record one dispatch's device-vs-host time split at the boundaries
    the engine already crosses (no added synchronisation): `enqueue` =
    the dispatch call returning, `sync` = the fetched result
    materialising on the host (device work + transfer), `host` = decode
    + event fan-out. Fused chunks report enqueue only (nothing is
    fetched per chunk); diff chunks report all three, and the fraction
    gauge tracks the last fully-split dispatch."""
    for phase, seconds in (("enqueue", enqueue_s), ("sync", sync_s),
                           ("host", host_s)):
        if seconds is not None:
            _SPLIT[phase].observe(seconds)
    if enqueue_s is not None and sync_s is not None and host_s is not None:
        total = enqueue_s + sync_s + host_s
        if total > 0:
            _DEVICE_FRACTION.set(round(sync_s / total, 5))
