"""Device plane — the part of `gol_tpu.obs.device` the engine calls:
`cause()`, which labels WHY device work happened inside a block (the
kernel build records it — see ops/_build.py), and `observe_split()`,
which records how long a fused dispatch took to enqueue.

Host-side only: nothing here synchronises the device.
"""

from __future__ import annotations

import contextlib
import threading

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


_ENQUEUE = obs.histogram(
    "gol_tpu_device_dispatch_split_seconds",
    "Per-dispatch wall seconds until the dispatch call returned",
    {"phase": "enqueue"},
)


def observe_split(enqueue_s: float) -> None:
    """Record one fused dispatch's enqueue time. Fused chunks report
    only this phase: nothing is fetched per chunk, so the sync boundary
    does not exist there (gol_tpu's diff chunks add sync and host
    phases; they are not ported yet)."""
    _ENQUEUE.observe(enqueue_s)
