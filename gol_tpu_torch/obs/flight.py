"""Flight recorder — the host-side copy of `gol_tpu.obs.flight`.

A bounded process-global ring of recent lifecycle notes (dispatch
commits, fatal errors) that `dump()` writes crash-atomically, together
with the newest tracer spans and the current metric values, so a
post-mortem pins the turn the engine died at.

Enablement follows the registry (`GOL_TPU_METRICS=0`): notes no-op
behind one flag read. File dumps
additionally need a configured directory (`configure`) — library
callers that never call it get no files on disk.
"""

from __future__ import annotations

import collections
import importlib
import json
import os
import threading
import time
from typing import Optional

from gol_tpu_torch.obs.registry import REGISTRY, atomic_write_text

# Live module object — see the twin note in tracing.py.
_registry = importlib.import_module("gol_tpu_torch.obs.registry")

__all__ = ["FLIGHT", "FlightRecorder", "configure", "dump", "note"]

#: Ring capacity: notes are per lifecycle event / per dispatch chunk.
DEFAULT_CAPACITY = 4096

#: Newest tracer records embedded in a dump.
SPAN_TAIL = 2048


class FlightRecorder:
    """Bounded note ring + crash-atomic dumps. One process-global
    instance (`FLIGHT`)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._ring: "Optional[collections.deque]" = None
        self._recorded = 0
        self._dir: Optional[str] = None
        self._dump_lock = threading.Lock()

    def note(self, kind: str, **fields) -> None:
        """Record one lifecycle note — safe from any thread, no-op when
        disabled."""
        if not _registry._ENABLED:
            return
        ring = self._ring
        if ring is None:
            ring = self._ring = collections.deque(maxlen=self.capacity)
        self._recorded += 1
        ring.append((time.time(), kind, fields or None))

    def configure(self, directory: Optional[str] = None) -> None:
        """Arm file dumps into `directory` (None keeps them off)."""
        if directory is not None:
            self._dir = os.fspath(directory)

    @property
    def entries(self) -> list:
        return list(self._ring) if self._ring is not None else []

    def payload(self, reason: Optional[str] = None) -> dict:
        """The black box content as one JSON-able dict."""
        from gol_tpu_torch.obs.tracing import TRACER

        return {
            "enabled": True,
            "reason": reason,
            "dumped_at": time.time(),
            "pid": os.getpid(),
            "entries": [
                {"ts": ts, "kind": kind, **(fields or {})}
                for ts, kind, fields in self.entries
            ],
            "metrics": REGISTRY.snapshot(),
            "spans": TRACER.chrome_trace(limit=SPAN_TAIL)["traceEvents"],
        }

    def dump(self, reason: str, path=None) -> Optional[str]:
        """Write the black box crash-atomically. With neither `path` nor
        a configured directory (or when disabled) nothing is written and
        None returns — safe to call from failure paths."""
        if not _registry._ENABLED:
            return None
        if path is None:
            if self._dir is None:
                return None
            try:
                os.makedirs(self._dir, exist_ok=True)
            except OSError:
                return None
            path = os.path.join(
                self._dir, f"flightrecorder-{os.getpid()}.json"
            )
        path = os.fspath(path)
        with self._dump_lock:
            self.note("flight.dump", reason=reason)
            atomic_write_text(
                path, json.dumps(self.payload(reason), indent=1)
            )
        return path


#: The process-global black box every layer of this package notes into.
FLIGHT = FlightRecorder()


def note(kind: str, **fields) -> None:
    FLIGHT.note(kind, **fields)


def configure(directory: Optional[str] = None) -> None:
    FLIGHT.configure(directory)


def dump(reason: str, path=None) -> Optional[str]:
    return FLIGHT.dump(reason, path)
