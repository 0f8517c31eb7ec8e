"""Named-span tracer — the host-side copy of `gol_tpu.obs.tracing`.

Any layer records named spans and instant events into a bounded
process-global ring; the ring exports as Chrome-trace JSON. A SPAN is
(name, cat, ts, dur, tid, args) with `ts` the wall time at enter; an
EVENT is the same minus `dur`.

Enablement follows the registry (`GOL_TPU_METRICS=0`): every record
call returns behind one flag read, and the ring is allocated lazily on
the first record.
"""

from __future__ import annotations

import collections
import importlib
import os
import threading
import time
from typing import Optional

# The live module object (the package __init__ rebinds the attribute
# `gol_tpu_torch.obs.registry` to its same-named convenience FUNCTION):
# every record call reads `_registry._ENABLED`.
_registry = importlib.import_module("gol_tpu_torch.obs.registry")

__all__ = ["TRACER", "Tracer", "add_span", "event"]

#: Ring capacity: ~64k records keep the recent minutes of a run.
DEFAULT_CAPACITY = 65_536


class Tracer:
    """Bounded ring of spans/events with Chrome-trace export."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._ring: "Optional[collections.deque]" = None
        self._recorded = 0

    def _rec(self, record) -> None:
        ring = self._ring
        if ring is None:
            ring = self._ring = collections.deque(maxlen=self.capacity)
        self._recorded += 1
        ring.append(record)

    def add_span(self, name: str, cat: str, ts: float, dur: float,
                 args: Optional[dict] = None) -> None:
        """Record one completed span: `ts` wall seconds at start, `dur`
        seconds."""
        if not _registry._ENABLED:
            return
        self._rec(("X", name, cat, ts, dur,
                   threading.get_ident(), args or None))

    def add_event(self, name: str, cat: str, ts: Optional[float] = None,
                  args: Optional[dict] = None) -> None:
        if not _registry._ENABLED:
            return
        self._rec(("i", name, cat,
                   time.time() if ts is None else ts, 0.0,
                   threading.get_ident(), args or None))

    @property
    def records(self) -> list:
        return list(self._ring) if self._ring is not None else []

    @property
    def dropped(self) -> int:
        retained = len(self._ring) if self._ring is not None else 0
        return max(0, self._recorded - retained)

    def chrome_trace(self, limit: Optional[int] = None) -> dict:
        """The ring as a Chrome-trace dict (`traceEvents`, ts/dur in
        microseconds); `limit` keeps only the newest N records."""
        pid = os.getpid()
        events = []
        records = self.records
        if limit is not None and len(records) > limit:
            records = records[-limit:]
        for ph, name, cat, ts, dur, tid, args in records:
            ev = {"name": name, "cat": cat or "gol", "ph": ph,
                  "ts": round(ts * 1e6, 1), "pid": pid, "tid": tid}
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 1)
            else:
                ev["s"] = "p"
            if args:
                ev["args"] = dict(args)
            events.append(ev)
        return {
            "traceEvents": events,
            "metadata": {
                "pid": pid,
                "recorded": self._recorded,
                "dropped": self.dropped,
                "dumped_at": time.time(),
            },
        }


#: The process-global tracer every layer of this package records into.
TRACER = Tracer()


def event(name: str, cat: str = "", **args) -> None:
    TRACER.add_event(name, cat, None, args or None)


def add_span(name: str, cat: str, ts: float, dur: float,
             args: Optional[dict] = None) -> None:
    TRACER.add_span(name, cat, ts, dur, args)
