"""Metrics registry — typed, low-overhead, process-global: the port's
copy of `gol_tpu.obs.registry`, with the same metric names.

Three metric types, Prometheus-shaped:

- `Counter`: monotone float, `inc(n)`.
- `Gauge`: last-write-wins float, `set/inc/dec`.
- `Histogram`: exponential (or caller-supplied) upper bounds, cumulative
  `le` semantics at exposition time, `observe(v)`, quantiles.
- `CollectedCounter`: a counter whose value is read from a callable
  when the registry is read, for counts a hot path keeps for itself.

`TopKGauge` is the bounded labeled family (top-K children named, the
rest one aggregate); entity series (`track_entity_series`,
`evict_entity`) let a per-peer teardown remove every series of one
peer; `Registry.prometheus_text` and `snapshot` are the `/metrics` and
`/vars` bodies (`obs.http`), and `dump` writes the snapshot.

Design constraints, in order:

- **Pure stdlib.** Nothing here touches torch or the device:
  `analysis.invariants` counts its violations here, so the registry
  sits below everything.
- **Never inside a kernel.** All instrumentation is host-side, at
  dispatch/event granularity (≤ kHz), never per cell.
- **Zero-cost when disabled.** `set_enabled(False)` (or
  `GOL_TPU_METRICS=0` in the environment) turns every `inc`/`set`/
  `observe` into an immediate return behind one module-global flag
  check; construction-time wrappers (parallel/stepper.py) additionally
  skip wrapping entirely when metrics are off at build time.
- **Thread-safe.** Writers are the engine thread, the ticker, conn
  writer threads and the broadcaster concurrently; every mutation takes
  the metric's own lock (uncontended at these rates), so totals are
  exact.

Identity: a metric is (name, labels). `Registry.counter(...)` et al.
are get-or-create — calling twice with the same identity returns the
same object, calling with the same name but a different type raises.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

__all__ = [
    "CollectedCounter",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "TopKGauge",
    "atomic_write_text",
    "collected_counter",
    "counter",
    "enabled",
    "evict_entity",
    "exponential_buckets",
    "gauge",
    "histogram",
    "merge_cumulative_buckets",
    "quantile_from_buckets",
    "registry",
    "remove",
    "set_enabled",
    "track_entity_series",
]

#: Module-global enablement flag — ONE attribute read on every metric
#: mutation. Default on; `GOL_TPU_METRICS=0` (or set_enabled(False))
#: turns the whole plane off.
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
    `os.replace` — a killed process never leaves a truncated artifact
    (the io/pgm.py discipline, shared here so Timeline dumps and
    registry dumps get it too)."""
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
    """`count` exponentially-spaced upper bounds from `start` —
    the Prometheus ExponentialBuckets shape."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    out, b = [], start
    for _ in range(count):
        out.append(b)
        b *= factor
    return tuple(out)


#: Default histogram bounds: 100 µs .. ~52 s, x2 — covers a single diff
#: dispatch on local hardware through a cold-compile-sized stall.
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


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    # Integral values print without the trailing .0 — easier to grep
    # and byte-stable across Python versions.
    return str(int(v)) if float(v).is_integer() and abs(v) < 1e15 else repr(v)


class _Metric:
    """Shared identity + lock; subclasses hold the value plane."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: _LabelsKey):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = threading.Lock()

    # -- exposition --

    def sample_lines(self) -> Iterable[str]:
        raise NotImplementedError

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

    def sample_lines(self):
        yield f"{self.name}{_fmt_labels(self.labels)} {_fmt_value(self._value)}"

    def snapshot_value(self):
        return self._value


class CollectedCounter(_Metric):
    """A counter kept outside the registry: its value is `read()`, taken
    each time the registry is read (exposition, snapshot), so the code
    that counts adds nothing to its own path. The count is the owner's:
    where the owner resets it, the series resets, as a counter does when
    its process restarts."""

    kind = "counter"

    def __init__(self, name, help, labels, read: Callable[[], float]):
        super().__init__(name, help, labels)
        self._read = read

    @property
    def value(self) -> float:
        return float(self._read())

    def sample_lines(self):
        yield f"{self.name}{_fmt_labels(self.labels)} {_fmt_value(self.value)}"

    def snapshot_value(self):
        return self.value


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

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def sample_lines(self):
        yield f"{self.name}{_fmt_labels(self.labels)} {_fmt_value(self._value)}"

    def snapshot_value(self):
        return self._value


class Histogram(_Metric):
    """Distribution with fixed upper bounds (Prometheus cumulative-`le`
    semantics: an observation lands in the first bucket whose bound is
    >= v; exposition emits cumulative counts plus `_sum`/`_count`)."""

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

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def sample_lines(self):
        cum = 0
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        for bound, n in zip(self.bounds, counts):
            cum += n
            yield (f"{self.name}_bucket"
                   f"{_fmt_labels(self.labels, [('le', _fmt_value(bound))])}"
                   f" {cum}")
        yield (f"{self.name}_bucket"
               f"{_fmt_labels(self.labels, [('le', '+Inf')])} {total}")
        yield f"{self.name}_sum{_fmt_labels(self.labels)} {_fmt_value(s)}"
        yield f"{self.name}_count{_fmt_labels(self.labels)} {total}"

    def snapshot_value(self):
        with self._lock:
            return {
                "buckets": [[b, n] for b, n in
                            zip(list(self.bounds) + ["+Inf"], self._counts)],
                "sum": self._sum,
                "count": self._count,
            }

    def cumulative_buckets(self) -> list:
        """[(upper_bound, cumulative_count)] incl. the +Inf bucket —
        the exposition's `le` view, as data (quantile input)."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for b, n in zip(self.bounds, counts):
            cum += n
            out.append((b, cum))
        out.append((float("inf"), cum + counts[-1]))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Prometheus-style histogram_quantile over this histogram's
        own buckets (linear interpolation inside the landing bucket).
        None on an empty histogram."""
        return quantile_from_buckets(self.cumulative_buckets(), q)


class TopKGauge(_Metric):
    """Bounded-cardinality labeled gauge family — ONE registry entry
    whose exposition emits at most `cap` labeled children (the top-cap
    by value, the "worst" peers an operator actually wants named) plus
    a single `{label="other"}` aggregate (max over the rest, with an
    `<name>_other_children` companion so the hidden population is
    visible). Per-PEER labels at relay-scale peer counts would
    otherwise mint one registry child per connection: thousands of
    series per scrape for peers whose lag is 0. Children live in a
    plain dict — `set_child`/`remove_child` are O(1); ranking happens
    at exposition time only. The registry stays O(cap) on the wire and
    O(live children) in memory, and teardown (`remove_child`) keeps
    the dict bounded under churn (pinned by the 1000-peer test)."""

    kind = "gauge"

    def __init__(self, name, help, labels, label: str = "peer",
                 cap: int = 16):
        super().__init__(name, help, labels)
        if cap < 1:
            raise ValueError("cap must be >= 1")
        self.label = label
        self.cap = cap
        self._children: Dict[str, float] = {}

    def set_child(self, child, v: float) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._children[str(child)] = float(v)

    def remove_child(self, child) -> bool:
        with self._lock:
            return self._children.pop(str(child), None) is not None

    def child_count(self) -> int:
        return len(self._children)

    def _ranked(self):
        with self._lock:
            items = list(self._children.items())
        items.sort(key=lambda kv: (-kv[1], kv[0]))
        return items[: self.cap], items[self.cap:]

    def sample_lines(self):
        top, rest = self._ranked()
        for k, v in sorted(top):
            yield (f"{self.name}"
                   f"{_fmt_labels(self.labels, [(self.label, k)])}"
                   f" {_fmt_value(v)}")
        if rest:
            other = max(v for _, v in rest)
            yield (f"{self.name}"
                   f"{_fmt_labels(self.labels, [(self.label, 'other')])}"
                   f" {_fmt_value(other)}")
            yield (f"{self.name}_other_children"
                   f"{_fmt_labels(self.labels)} {len(rest)}")

    def snapshot_value(self):
        top, rest = self._ranked()
        out = {"children": dict(top)}
        if rest:
            out["other"] = max(v for _, v in rest)
            out["other_children"] = len(rest)
        return out


def quantile_from_buckets(buckets, q: float) -> Optional[float]:
    """`histogram_quantile` over cumulative `le` buckets: `buckets` is
    [(upper_bound, cumulative_count), ...] sorted by bound, +Inf last
    (exactly `Histogram.cumulative_buckets()`, or what a scraper
    reassembles from `<name>_bucket{le=...}` series — the ONE shared
    quantile the console, the bench capture and the tests all use, so
    the numbers cannot drift between surfaces).

    Prometheus semantics: the target rank is q * total observations;
    the answer interpolates linearly inside the first bucket whose
    cumulative count reaches it (lower edge 0 for the first bucket). A
    rank landing in the +Inf bucket returns the highest finite bound —
    the histogram cannot resolve beyond it. None on an empty histogram;
    q outside [0, 1] raises."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_bound, prev_cum = 0.0, 0
    saw_finite = False
    for bound, cum in buckets:
        if bound == float("inf"):
            break
        saw_finite = True
        if cum >= rank:
            frac = (0.0 if cum == prev_cum
                    else (rank - prev_cum) / (cum - prev_cum))
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = bound, cum
    # Rank lands in the +Inf bucket: the highest finite bound is the
    # most the histogram can resolve (Prometheus does the same).
    return prev_bound if saw_finite else None


def merge_cumulative_buckets(bucket_lists) -> list:
    """Sum several cumulative-bucket lists (same-name histograms from
    N registries/endpoints or N label sets) into one — fleet-wide
    percentiles. Bounds need not match: the union grid is used, each
    input contributing its cumulative count at every bound at or past
    its own (cumulative counts are monotone step functions, so the sum
    at a bound between two of an input's bounds is the lower one —
    exact, no interpolation)."""
    lists = [b for b in bucket_lists if b]
    if not lists:
        return []
    bounds = sorted({b for lst in lists for b, _ in lst})
    out = []
    for bound in bounds:
        cum = 0
        for lst in lists:
            at = 0
            for b, c in lst:
                if b <= bound:
                    at = c
                else:
                    break
            cum += at
        out.append((bound, cum))
    if not out or out[-1][0] != float("inf"):
        out.append((float("inf"), sum(lst[-1][1] for lst in lists)))
    return out


class Registry:
    """Get-or-create metric store with Prometheus-text and JSON
    exposition. One process-global instance (`REGISTRY`) serves the
    whole package; tests build private ones."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[Tuple[str, _LabelsKey], _Metric]" = {}
        #: Per-entity series declarations (bounded-cardinality audit):
        #: label -> family names whose per-entity children must leave
        #: the registry with the entity. Plain families mint one
        #: labeled series per entity ({label: value}); topk families
        #: are single TopKGauge entries whose CHILDREN are keyed by the
        #: entity. `evict_entity` is the one teardown path every churny
        #: plane (sessions, peers, usage principals) routes through —
        #: pinned by the 1000-tenant churn test.
        self._entity_plain: "Dict[str, set]" = {}
        self._entity_topk: "Dict[str, set]" = {}

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

    def collected_counter(self, name: str, help: str,
                          labels: Optional[dict],
                          read: Callable[[], float]) -> CollectedCounter:
        """A counter series whose value is `read()` when the registry
        is read (see CollectedCounter); get-or-create, so the first
        `read` registered under an identity stays."""
        return self._get_or_create(CollectedCounter, name, help, labels,
                                   read=read)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[dict] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def topk_gauge(self, name: str, help: str = "",
                   labels: Optional[dict] = None, *,
                   label: str = "peer", cap: int = 16) -> TopKGauge:
        """Bounded per-entity gauge family (see TopKGauge): exposition
        cardinality is O(cap) however many children are live."""
        return self._get_or_create(TopKGauge, name, help, labels,
                                   label=label, cap=cap)

    def get(self, name: str, labels: Optional[dict] = None
            ) -> Optional[_Metric]:
        """The registered metric under one identity, or None — a peek
        that never creates (evict_entity and tests use it)."""
        with self._lock:
            return self._metrics.get((name, _labels_key(labels)))

    def track_entity_series(self, label: str, *names: str,
                            topk: bool = False) -> None:
        """Declare per-entity metric families: every series of `names`
        keyed by `{label: <entity>}` (or, with topk=True, every
        TopKGauge child keyed by the entity) is evicted by ONE
        `evict_entity(label, entity)` call at teardown. Idempotent;
        declaration order is free (a family may be tracked before it
        is ever registered)."""
        with self._lock:
            dst = self._entity_topk if topk else self._entity_plain
            dst.setdefault(label, set()).update(names)

    def evict_entity(self, label: str, value) -> int:
        """Remove every tracked per-entity series of one entity — the
        shared bounded-cardinality teardown (sessions at destroy/park,
        peers at disconnect, usage principals at forget). Returns the
        number of series/children actually removed; unknown entities
        are a harmless 0."""
        with self._lock:
            plain = tuple(self._entity_plain.get(label, ()))
            topk = tuple(self._entity_topk.get(label, ()))
        n = 0
        for name in plain:
            if self.remove(name, {label: str(value)}):
                n += 1
        for name in topk:
            m = self.get(name)
            if isinstance(m, TopKGauge) and m.remove_child(value):
                n += 1
        return n

    def remove(self, name: str, labels: Optional[dict] = None) -> bool:
        """Evict one labeled series (e.g. a destroyed session's child
        metrics — gol_tpu.sessions). Bounded-cardinality discipline:
        per-ENTITY labels are legal only if the entity's teardown calls
        this, otherwise the registry grows without bound under churn.
        Returns False when the series was never registered. A handle
        obtained earlier keeps working but lands nowhere visible; the
        next get-or-create under the same identity starts fresh."""
        key = (name, _labels_key(labels))
        with self._lock:
            return self._metrics.pop(key, None) is not None

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def percentiles(self, name: str, qs: Sequence[float] = (0.5, 0.95, 0.99)
                    ) -> Optional[dict]:
        """{p50: v, p95: v, ...} over EVERY labeled series of the named
        histogram family merged into one distribution (an endpoint's
        per-label children are one population to an operator). None
        when the family is absent or empty."""
        lists = [m.cumulative_buckets() for m in self.metrics()
                 if m.name == name and isinstance(m, Histogram)]
        if not lists:
            return None
        merged = merge_cumulative_buckets(lists)
        out = {}
        for q in qs:
            v = quantile_from_buckets(merged, q)
            if v is None:
                return None
            out[f"p{q * 100:g}"] = round(v, 6)
        return out

    # -- exposition --

    def prometheus_text(self) -> str:
        """The text exposition format (one HELP/TYPE header per metric
        family, then every labeled series)."""
        lines = []
        seen_headers = set()
        for m in sorted(self.metrics(), key=lambda m: (m.name, m.labels)):
            if m.name not in seen_headers:
                seen_headers.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.sample_lines())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able {series: {type, value}} map — the `/vars` payload
        and the BENCH_DETAIL.json capture. Series keys carry their
        labels in Prometheus spelling so the two expositions line up."""
        out = {}
        for m in sorted(self.metrics(), key=lambda m: (m.name, m.labels)):
            key = f"{m.name}{_fmt_labels(m.labels)}"
            out[key] = {"type": m.kind, "value": m.snapshot_value()}
            if m.help:
                out[key]["help"] = m.help
        return out

    def dump(self, path) -> None:
        """Crash-safe JSON snapshot (temp file + rename — a killed
        engine never leaves a truncated artifact)."""
        atomic_write_text(path, json.dumps(self.snapshot(), indent=2))


#: The process-global registry every gol_tpu layer instruments into.
REGISTRY = Registry()


def registry() -> Registry:
    return REGISTRY


def counter(name: str, help: str = "", labels: Optional[dict] = None) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Optional[dict] = None) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def collected_counter(name: str, help: str, labels: Optional[dict],
                      read: Callable[[], float]) -> CollectedCounter:
    return REGISTRY.collected_counter(name, help, labels, read)


def histogram(name: str, help: str = "", labels: Optional[dict] = None,
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)


def remove(name: str, labels: Optional[dict] = None) -> bool:
    return REGISTRY.remove(name, labels)


def track_entity_series(label: str, *names: str, topk: bool = False) -> None:
    REGISTRY.track_entity_series(label, *names, topk=topk)


def evict_entity(label: str, value) -> int:
    return REGISTRY.evict_entity(label, value)
