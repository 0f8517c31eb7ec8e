"""Metrics registry — typed, low-overhead, process-global.

The host-side copy of `gol_tpu.obs.registry` that the engine and the
stepper of this package count into: `Counter`, `Gauge` and `Histogram`
in one get-or-create `Registry`, exposed as a JSON-able snapshot (the
flight recorder embeds it; the Prometheus text and HTTP planes are not
ported yet).

- **Pure stdlib.** Nothing here touches torch or the device.
- **Never inside a kernel.** All instrumentation is host-side, at
  dispatch/event granularity, never per cell.
- **Zero-cost when disabled.** `GOL_TPU_METRICS=0` in the environment
  (or `set_enabled(False)`) turns every `inc`/`set`/`observe` into an immediate return behind one
  module-global flag.
- **Thread-safe.** Every mutation takes the metric's own lock.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import tempfile
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "atomic_write_text",
    "counter",
    "enabled",
    "exponential_buckets",
    "gauge",
    "histogram",
    "registry",
    "set_enabled",
]

#: Module-global enablement flag — ONE attribute read on every metric
#: mutation. Default on; `GOL_TPU_METRICS=0` turns the whole plane off.
_ENABLED = os.environ.get("GOL_TPU_METRICS", "1") != "0"


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool = True) -> None:
    """Programmatic switch (tests, embedders). Affects mutation calls
    immediately; build-time gates (the stepper wrapper) read it at
    construction."""
    global _ENABLED
    _ENABLED = bool(on)


def atomic_write_text(path, text: str) -> None:
    """Crash-safe text write: temp file in the target directory, fsync,
    `os.replace` — a killed process never leaves a truncated artifact."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".obs-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def exponential_buckets(start: float, factor: float, count: int) -> tuple:
    """`count` exponentially-spaced upper bounds from `start`."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    out, b = [], start
    for _ in range(count):
        out.append(b)
        b *= factor
    return tuple(out)


#: Default histogram bounds: 100 µs .. ~52 s, x2.
DEFAULT_BUCKETS = exponential_buckets(1e-4, 2.0, 20)

_LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Dict[str, str]]) -> _LabelsKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: _LabelsKey, extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""

    def esc(v: str) -> str:
        return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in pairs) + "}"


class _Metric:
    """Shared identity + lock; subclasses hold the value plane."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: _LabelsKey):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = threading.Lock()

    def snapshot_value(self):
        raise NotImplementedError


class Counter(_Metric):
    """Monotone counter. `inc(n)` with n >= 0."""

    kind = "counter"

    def __init__(self, name, help, labels):
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot_value(self):
        return self._value


class Gauge(_Metric):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name, help, labels):
        super().__init__(name, help, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot_value(self):
        return self._value


class Histogram(_Metric):
    """Distribution with fixed upper bounds (Prometheus cumulative-`le`
    semantics at exposition time)."""

    kind = "histogram"

    def __init__(self, name, help, labels,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        # Per-bucket (non-cumulative) counts; index len(bounds) = +Inf.
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot_value(self):
        with self._lock:
            return {
                "buckets": [[b, n] for b, n in
                            zip(list(self.bounds) + ["+Inf"], self._counts)],
                "sum": self._sum,
                "count": self._count,
            }


class Registry:
    """Get-or-create metric store with a JSON snapshot. One
    process-global instance (`REGISTRY`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[Tuple[str, _LabelsKey], _Metric]" = {}

    def _get_or_create(self, cls, name, help, labels, **kw):
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[dict] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """JSON-able {series: {type, value}} map; series keys carry their
        labels in Prometheus spelling."""
        out = {}
        for m in sorted(self.metrics(), key=lambda m: (m.name, m.labels)):
            key = f"{m.name}{_fmt_labels(m.labels)}"
            out[key] = {"type": m.kind, "value": m.snapshot_value()}
            if m.help:
                out[key]["help"] = m.help
        return out


#: The process-global registry every layer of this package counts into.
REGISTRY = Registry()


def registry() -> Registry:
    return REGISTRY


def counter(name: str, help: str = "", labels: Optional[dict] = None) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Optional[dict] = None) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Optional[dict] = None,
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)
