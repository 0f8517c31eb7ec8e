"""The history plane's store: a tiny stdlib TSDB for metric samples.

Every other observability surface in gol_tpu is point-in-time: metrics
exist at scrape instants, the alert evaluator judges the current
sample, the controller scales on what it sees *now*. This module is
the memory: per-source, per-series (timestamp, value) history held in
bounded in-memory rings and persisted in crash-atomic, keyframe-indexed
segment logs following the replay plane's recorder discipline
(gol_tpu/replay/log.py) — append + flush per record, torn tails
TOLERATED on read (a SIGKILL mid-write loses at most the half-written
record, never an earlier sample), eviction size-bounded and
oldest-first, never the active segment.

Layout on disk (`<root>/hist-<epoch_millis:016d>.tlog`):

    record  := u32 payload_len, f64 append_walltime, payload
    payload := codec byte (0 = raw, 1 = zlib) + JSON object
    JSON    := {"t":"s","src":S,"ts":T,"s":[[key,value],...]}   sample
             | {"t":"key","state":{src:{key:[ts,value],...}}}   keyframe

Each segment OPENS with a keyframe record carrying the last known
value of every live series, so any segment is interpretable on its
own: after older segments are evicted, a resume still answers
"current value" queries for slow-moving series that have not re-sent
since. Samples carry ABSOLUTE values (the wire's delta encoding is in
the series *set*, not the values), so replay order is the only state
and a dropped record can never corrupt later ones.

The query half implements the alert grammar's aggregations —
`sum` (bare family), `max`, `min`, `avg`, `rate`, `delta`, and
bucket-merge `p50/p95/p99` built on the registry's shared
`quantile_from_buckets` / `merge_cumulative_buckets` — over
[start, end] at a fixed step. Stdlib only, like every obs module.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import re
import struct
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Tuple

_reg = importlib.import_module("gol_tpu_torch.obs.registry")

__all__ = [
    "TSDB",
    "eval_expr",
    "parse_expr",
    "read_records",
    "scan_segments",
]

log = logging.getLogger(__name__)

#: Record header: payload bytes, append wall-clock seconds (the same
#: shape the replay log uses — u32 length, f64 timestamp).
_REC = struct.Struct("<Id")
_SEG = re.compile(r"^hist-(\d{16})\.tlog$")
#: One record's decoded-payload ceiling — far above any real keyframe
#: (thousands of series at ~100 bytes each); a length past it reads as
#: corruption, i.e. the torn tail.
_REC_RAW_MAX = 8 << 20

DEFAULT_RETENTION_SECS = 3600.0
DEFAULT_MAX_BYTES = 64 << 20
DEFAULT_SEGMENT_BYTES = 4 << 20
#: Per-series in-memory point ring.
DEFAULT_MAX_POINTS = 4096
#: Per-source series-cardinality bound (a hostile or buggy writer
#: inventing label values must not grow memory without bound).
DEFAULT_MAX_SERIES = 8192

_AGGS = ("sum", "max", "min", "avg", "rate", "delta",
         "p50", "p95", "p99")
_EXPR_RE = re.compile(
    r"^(?:(?P<agg>[a-z]\w*)\((?P<fam1>[A-Za-z_:][\w:]*)\)"
    r"|(?P<fam2>[A-Za-z_:][\w:]*))$"
)


def parse_expr(expr: str) -> Tuple[str, str]:
    """`family` or `agg(family)` -> (agg, family); the alert rule
    grammar's left-hand side plus `delta` (bare family == sum, exactly
    like the rules). ValueError on anything else — the /query endpoint
    maps that to HTTP 400."""
    m = _EXPR_RE.match(expr.strip())
    if not m:
        raise ValueError(f"cannot parse query expr {expr!r}")
    agg = m.group("agg") or "sum"
    if agg not in _AGGS:
        raise ValueError(
            f"unknown aggregation {agg!r} (one of {', '.join(_AGGS)})"
        )
    return agg, m.group("fam1") or m.group("fam2")


def _pack(obj: dict) -> bytes:
    raw = json.dumps(obj, separators=(",", ":")).encode()
    if len(raw) > 256:
        z = zlib.compress(raw, 1)
        if len(z) < len(raw):
            return b"\x01" + z
    return b"\x00" + raw


def _unpack(payload: bytes) -> dict:
    """Decode one record payload; raises ValueError on anything
    malformed (the reader treats that as the torn tail)."""
    if not payload:
        raise ValueError("empty record payload")
    codec, data = payload[0], payload[1:]
    if codec == 1:
        d = zlib.decompressobj()
        data = d.decompress(data, _REC_RAW_MAX)
        if d.unconsumed_tail or not d.eof:
            raise ValueError("oversized or truncated record blob")
    elif codec != 0:
        raise ValueError(f"unknown record codec {codec}")
    obj = json.loads(data.decode())
    if not isinstance(obj, dict):
        raise ValueError("record payload is not an object")
    return obj


def scan_segments(root: str) -> List[Tuple[int, str]]:
    """Sorted [(start_millis, path)] — tolerant of a missing dir."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for name in names:
        m = _SEG.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort()
    return out


def read_records(path: str):
    """Yield decoded record dicts until EOF or the torn tail. Identical
    discipline to the replay log's reader: a header whose length
    overruns the file (or fails to decode) is the half-written tail of
    a crash — stop there, never raise, never yield garbage."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return
    off = 0
    while off + _REC.size <= len(blob):
        n, ts = _REC.unpack_from(blob, off)
        if n > _REC_RAW_MAX or off + _REC.size + n > len(blob):
            break  # torn tail: the crash frontier
        try:
            obj = _unpack(blob[off + _REC.size:off + _REC.size + n])
        except (ValueError, zlib.error, UnicodeDecodeError):
            break  # undecodable == torn: replay stops at the last good
        obj["_walltime"] = ts
        yield obj
        off += _REC.size + n


class _Series:
    """One series' bounded point ring. Appends must be monotone in
    ts — a non-monotone sample is DROPPED (counted), because history
    with rewinds cannot answer range queries truthfully."""

    __slots__ = ("points",)

    def __init__(self, max_points: int):
        self.points: deque = deque(maxlen=max_points)

    def append(self, ts: float, value: float) -> bool:
        if self.points and ts <= self.points[-1][0]:
            return False
        self.points.append((ts, value))
        return True


class TSDB:
    """The store. All public methods are thread-safe (the collector's
    reader threads append while HTTP query threads read)."""

    def __init__(self, root: Optional[str] = None, *,
                 retention_secs: float = DEFAULT_RETENTION_SECS,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_points: int = DEFAULT_MAX_POINTS,
                 max_series: int = DEFAULT_MAX_SERIES,
                 resume: bool = False):
        self.root = root
        self.retention_secs = float(retention_secs)
        self.max_bytes = int(max_bytes)
        self.segment_bytes = int(segment_bytes)
        self.max_points = int(max_points)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._by_source: Dict[str, Dict[str, _Series]] = {}
        #: Per-source bounded annotation ring: alert transitions and
        #: span digests shipped in sample-frame meta.
        self._events: Dict[str, deque] = {}
        self._file = None
        self._file_bytes = 0
        self._samples_total = _reg.counter(
            "gol_tpu_tsdb_samples_total",
            "Samples accepted into the history store",
        )
        self._dropped = {
            reason: _reg.counter(
                "gol_tpu_tsdb_dropped_samples_total",
                "Samples the history store refused",
                {"reason": reason},
            ) for reason in ("non_monotone", "cardinality")
        }
        self._torn = _reg.counter(
            "gol_tpu_tsdb_torn_records_total",
            "Records dropped at a torn segment tail on resume",
        )
        self._series_gauge = _reg.gauge(
            "gol_tpu_tsdb_series", "Live series across all sources",
        )
        self._bytes_gauge = _reg.gauge(
            "gol_tpu_tsdb_bytes", "On-disk bytes across history segments",
        )
        if root:
            os.makedirs(root, exist_ok=True)
            if resume:
                self._replay()
            # Always a FRESH segment: the previous one may end in a
            # torn tail, and appending past a tear would corrupt it.
            self._roll()

    # -- ingest ------------------------------------------------------

    def append(self, source: str, ts: float, samples, *,
               meta: Optional[dict] = None, log_record: bool = True,
               walltime: Optional[float] = None) -> int:
        """Apply one decoded sample batch; returns accepted count."""
        accepted = []
        with self._lock:
            series = self._by_source.setdefault(source, {})
            for key, value in samples:
                s = series.get(key)
                if s is None:
                    if len(series) >= self.max_series:
                        self._dropped["cardinality"].inc()
                        continue
                    s = series[key] = _Series(self.max_points)
                if s.append(ts, value):
                    accepted.append([key, value])
                else:
                    self._dropped["non_monotone"].inc()
            if meta:
                self._note_meta(source, ts, meta)
            if accepted:
                self._samples_total.inc(len(accepted))
                self._series_gauge.set(
                    sum(len(m) for m in self._by_source.values())
                )
                if log_record and self._file is not None:
                    self._log_locked(
                        {"t": "s", "src": source, "ts": ts,
                         "s": accepted},
                        walltime=walltime,
                    )
        return len(accepted)

    def _note_meta(self, source: str, ts: float, meta: dict) -> None:
        ring = self._events.setdefault(source, deque(maxlen=256))
        for tr in meta.get("alerts") or []:
            if isinstance(tr, dict):
                ring.append({"ts": ts, "kind": "alert", **{
                    k: tr.get(k) for k in ("rule", "from", "to")
                }})
        spans = meta.get("spans")
        if isinstance(spans, dict):
            ring.append({"ts": ts, "kind": "spans", **spans})

    # -- persistence (recorder discipline) ---------------------------

    def _log_locked(self, obj: dict,
                    walltime: Optional[float] = None) -> None:
        payload = _pack(obj)
        if self._file_bytes + _REC.size + len(payload) \
                > self.segment_bytes:
            self._roll_locked()
        try:
            self._file.write(
                _REC.pack(len(payload),
                          time.time() if walltime is None else walltime)
                + payload
            )
            self._file.flush()
        except OSError:
            log.exception("history segment append failed")
            return
        self._file_bytes += _REC.size + len(payload)

    def _roll(self) -> None:
        with self._lock:
            self._roll_locked()

    def _roll_locked(self) -> None:
        if not self.root:
            return
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        millis = int(time.time() * 1000)
        # A same-millisecond roll (tests) must not reuse a filename.
        segs = scan_segments(self.root)
        if segs and millis <= segs[-1][0]:
            millis = segs[-1][0] + 1
        path = os.path.join(self.root, f"hist-{millis:016d}.tlog")
        self._file = open(path, "ab")
        self._file_bytes = 0
        # Keyframe first: the segment is self-interpretable even after
        # every older one is evicted.
        state: Dict[str, Dict[str, list]] = {}
        for src, series in self._by_source.items():
            last = {k: list(s.points[-1]) for k, s in series.items()
                    if s.points}
            if last:
                state[src] = last
        payload = _pack({"t": "key", "state": state})
        try:
            self._file.write(
                _REC.pack(len(payload), millis / 1000.0) + payload
            )
            self._file.flush()
            self._file_bytes = _REC.size + len(payload)
        except OSError:
            log.exception("history keyframe write failed")
        self._evict_locked()

    def _evict_locked(self) -> None:
        segs = scan_segments(self.root)
        total = 0
        sizes = []
        for _, path in segs:
            try:
                n = os.path.getsize(path)
            except OSError:
                n = 0
            sizes.append(n)
            total += n
        cutoff = (time.time() - 1.5 * self.retention_secs) * 1000
        # Oldest first; never the newest (active) segment.
        for (millis, path), n in zip(segs[:-1], sizes[:-1]):
            if total <= self.max_bytes and millis >= cutoff:
                break
            try:
                os.remove(path)
                total -= n
            except OSError:
                pass
        self._bytes_gauge.set(total)

    def _replay(self) -> None:
        """Resume: replay every surviving segment into memory, seeded
        by keyframes (a keyframe's values re-append behind the monotone
        guard, so duplicates across a segment boundary self-dedup)."""
        for _, path in scan_segments(self.root):
            for obj in read_records(path):
                kind = obj.get("t")
                try:
                    if kind == "key":
                        for src, series in (obj.get("state")
                                            or {}).items():
                            for key, (ts, value) in series.items():
                                self.append(src, float(ts),
                                            [(key, float(value))],
                                            log_record=False)
                    elif kind == "s":
                        self.append(
                            str(obj["src"]), float(obj["ts"]),
                            [(k, float(v)) for k, v in obj["s"]],
                            log_record=False,
                        )
                except (KeyError, TypeError, ValueError):
                    self._torn.inc()
                    break

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    # -- reads -------------------------------------------------------

    def sources(self) -> List[str]:
        with self._lock:
            return sorted(self._by_source)

    def events(self, source: str) -> List[dict]:
        with self._lock:
            return list(self._events.get(source) or ())

    def _copy_points(self, source: Optional[str],
                     name: str) -> List[List[Tuple[float, float]]]:
        """Point lists of every series named `name` (exact metric name,
        labels ignored) in `source` (all sources when None)."""
        out = []
        with self._lock:
            srcs = ([source] if source is not None
                    else list(self._by_source))
            for src in srcs:
                for key, s in (self._by_source.get(src) or {}).items():
                    if key == name or key.startswith(name + "{"):
                        out.append(list(s.points))
        return out

    def _bucket_series(self, source: Optional[str], family: str):
        """[(le_bound, points)] for every `<family>_bucket` series."""
        out = []
        with self._lock:
            srcs = ([source] if source is not None
                    else list(self._by_source))
            for src in srcs:
                for key, s in (self._by_source.get(src) or {}).items():
                    if not key.startswith(family + "_bucket{"):
                        continue
                    m = re.search(r'le="([^"]*)"', key)
                    if not m:
                        continue
                    try:
                        bound = float(m.group(1))
                    except ValueError:
                        continue
                    out.append((bound, list(s.points)))
        return out

    def latest(self, source: str,
               max_age: Optional[float] = None,
               now: Optional[float] = None) -> Dict[str, float]:
        """Last value per series of one source (a Series dict the
        scrape-layer helpers consume directly)."""
        now = time.time() if now is None else now
        out = {}
        with self._lock:
            for key, s in (self._by_source.get(source) or {}).items():
                if not s.points:
                    continue
                ts, value = s.points[-1]
                if max_age is not None and now - ts > max_age:
                    continue
                out[key] = value
        return out

    def at(self, source: str, t: float,
           lookback: Optional[float] = None) -> Dict[str, float]:
        """Series dict of one source as of time `t` (last sample at or
        before it, within `lookback`)."""
        out = {}
        with self._lock:
            for key, s in (self._by_source.get(source) or {}).items():
                v = _value_at(list(s.points), t, lookback)
                if v is not None:
                    out[key] = v
        return out

    def last_sample_time(self, source: Optional[str] = None
                         ) -> Optional[float]:
        with self._lock:
            srcs = ([source] if source is not None
                    else list(self._by_source))
            latest = None
            for src in srcs:
                for s in (self._by_source.get(src) or {}).values():
                    if s.points:
                        ts = s.points[-1][0]
                        if latest is None or ts > latest:
                            latest = ts
            return latest

    def query(self, expr: str, start: float, end: float, step: float,
              source: Optional[str] = None) -> dict:
        """The /query payload: aggregated across all sources by
        default, or restricted to one. Raises ValueError on a bad
        expr/range (HTTP 400 upstream)."""
        agg, family = parse_expr(expr)
        if not (end > start and step > 0):
            raise ValueError("need end > start and step > 0")
        if (end - start) / step > 100_000:
            raise ValueError("range/step asks for too many points")
        points = eval_expr(self, agg, family, start, end, step,
                           source=source)
        return {
            "expr": expr, "start": start, "end": end, "step": step,
            "series": [{
                "source": source if source is not None else "*",
                "points": [[t, v] for t, v in points],
            }],
        }

    def history_payload(self, since: float,
                        now: Optional[float] = None) -> dict:
        """The /history payload the console's --since mode renders:
        per source, the Series dict at the window's edges plus a
        turns-rate sparkline series."""
        now = time.time() if now is None else now
        start = now - max(1.0, since)
        out = {}
        for src in self.sources():
            cur = self.at(src, now, lookback=since + 30.0)
            if not cur:
                continue
            prev = self.at(src, start, lookback=30.0)
            spark = eval_expr(
                self, "rate", "gol_tpu_engine_turns_total",
                start, now, max(1.0, since / 16), source=src,
            )
            out[src] = {
                "ts": now, "prev_ts": start,
                "series": cur, "prev": prev,
                "spark": [[t, v] for t, v in spark if v is not None],
                "events": self.events(src)[-32:],
            }
        return {"since": since, "now": now, "sources": out}


def _value_at(points: List[Tuple[float, float]], t: float,
              lookback: Optional[float] = None) -> Optional[float]:
    """Last value at or before `t`, no older than `lookback` — the
    staleness horizon Prometheus calls the lookback delta."""
    lo, hi = 0, len(points)
    while lo < hi:
        mid = (lo + hi) // 2
        if points[mid][0] <= t:
            lo = mid + 1
        else:
            hi = mid
    if lo == 0:
        return None
    ts, value = points[lo - 1]
    if lookback is not None and t - ts > lookback:
        return None
    return value


def eval_expr(db: TSDB, agg: str, family: str, start: float,
              end: float, step: float,
              source: Optional[str] = None,
              ) -> List[Tuple[float, Optional[float]]]:
    """Aligned [(t, value|None)] at each step in (start, end]. The
    aggregations mirror the alert evaluator's `_value` semantics, over
    stored history instead of the live instant: sum/max/min/avg
    combine matching series' values-at-t; `rate` is the per-second
    counter increase over the trailing step (reset-guarded, summed
    across series); `delta` the raw difference (gauges); pNN the
    shared bucket-merge quantile of the observations that landed in
    the trailing step."""
    lookback = max(2 * step, 10.0)
    steps = []
    t = start + step
    while t <= end + 1e-9:
        steps.append(t)
        t += step
    if agg in ("p50", "p95", "p99"):
        q = {"p50": 0.5, "p95": 0.95, "p99": 0.99}[agg]
        buckets = db._bucket_series(source, family)
        out = []
        for t in steps:
            per_le: Dict[float, float] = {}
            for bound, points in buckets:
                cur = _value_at(points, t, lookback)
                if cur is None:
                    continue
                prev = _value_at(points, t - step, lookback) or 0.0
                per_le[bound] = per_le.get(bound, 0.0) \
                    + max(0.0, cur - prev)
            if not per_le:
                out.append((t, None))
                continue
            merged = sorted(per_le.items())
            out.append((t, _reg.quantile_from_buckets(merged, q)))
        return out
    series = db._copy_points(source, family)
    out = []
    for t in steps:
        vals = []
        for points in series:
            cur = _value_at(points, t, lookback)
            if cur is None:
                continue
            if agg in ("rate", "delta"):
                prev = _value_at(points, t - step, lookback)
                if prev is None:
                    continue
                d = cur - prev
                if agg == "rate":
                    # Counter reset: the post-reset value is the best
                    # lower bound on the true increase.
                    vals.append(max(0.0, d if d >= 0 else cur) / step)
                else:
                    vals.append(d)
            else:
                vals.append(cur)
        if not vals:
            out.append((t, None))
        elif agg == "max":
            out.append((t, max(vals)))
        elif agg == "min":
            out.append((t, min(vals)))
        elif agg == "avg":
            out.append((t, sum(vals) / len(vals)))
        else:  # sum, rate, delta
            out.append((t, sum(vals)))
    return out
