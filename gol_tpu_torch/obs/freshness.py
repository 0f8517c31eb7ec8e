"""Freshness plane — end-to-end turn-age SLOs and the alert evaluator
(the host-side copy of `gol_tpu.obs.freshness`).

The whole serving stack exists so an observer's screen tracks the
engine's committed turn, but until this module nothing MEASURED that
contract: metrics counted frames, traces timed hops, and the one
question an operator of a fan-out tree asks — "how far behind the
engine is this leaf, and which hop is eating the lag?" — had no series
and no alarm. Three pieces (docs/OBSERVABILITY.md "Freshness plane"):

- **Turn age.** Every peer-facing server (EngineServer, SessionServer,
  relay downstream, replay server) tracks each peer's last-WRITTEN
  turn against the authoritative committed turn of whatever it serves
  (engine, session, shadow raster, pump position). `TurnClock` keeps a
  bounded (turn, wall-ts) commit history so "peer is at turn T" turns
  into SECONDS: the age is how long ago the first turn the peer is
  missing was committed — a paused engine ages nobody, a degraded
  (frame-shedding) peer ages in real time. Exported per sweep as
  `gol_tpu_server_peer_turn_age_seconds{peer=token}` (a TopKGauge —
  the bounded-cardinality rules: top-K worst named, the rest one
  aggregate), an age histogram and a worst-age gauge, both labeled by
  tier. The CLIENT computes the same number for its own applied board
  (`ClientFreshness`, `gol_tpu_client_turn_age_seconds`) on the
  corrected clock — what a user actually experiences.

- **Hop-stamp hygiene.** Forward-latency math trusts wall-clock stamps
  that cross the wire (`_TAG_FBATCH.ts`, heartbeat turns). `sane_turn`
  / `sane_lag` are the ONE validation both relays and clients apply
  before a stamp reaches a histogram: negative, absurd (1e18),
  non-finite, or bool-typed values are dropped, never observed — a
  hostile stamp cannot corrupt the freshness plane (pinned by the wire
  fuzz suite).

- **Alert evaluator.** A stdlib rules engine running inside the
  metrics sidecar (`obs.http.MetricsServer(alerts=...)`, CLI
  `--alert-rules FILE`): threshold + `for:` duration over
  scraped-or-local series — the rule text evaluates against ANY
  Prometheus text exposition, the local registry's included, so the
  same rule file works against a sidecar's own series and against a
  scrape. `/alerts` serves the JSON state; firing/resolved transitions
  bump counters, note the flight recorder, and surface in
  `obs.console` (ALERT rows, nonzero `--once` exit for CI).

Rule syntax, one rule per line (see parse_rules):

    # name: [agg(]family[)] OP threshold [for DURATION]
    turn_age_p99: p99(gol_tpu_server_turn_age_seconds) > 2 for 30s
    violations:   gol_tpu_invariant_violations_total > 0
    pool_busy:    rate(gol_tpu_writer_pool_busy_seconds_total) > 0.8 for 10s

Pure stdlib (the registry discipline); every hot-path call is host-side
and sweep-granular, never per frame.
"""

from __future__ import annotations

import bisect
import logging
import re
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from gol_tpu_torch import obs
from gol_tpu_torch.obs.registry import quantile_from_buckets

__all__ = [
    "AlertEvaluator",
    "AlertRule",
    "ClientFreshness",
    "ServerFreshness",
    "TurnClock",
    "cumulative_bucket_delta",
    "parse_rules",
    "sane_lag",
    "sane_turn",
]

log = logging.getLogger(__name__)

#: Turn numbers past this are hostile, not deep (the wire's own
#: plausibility ceiling — a u64 header can carry anything).
MAX_TURN = 1 << 62

#: Ages/lags past this are stamp corruption, not staleness: no real
#: serving session is a year behind its engine. Keeps one absurd
#: negative emit stamp from parking a histogram in the +Inf bucket.
MAX_AGE = 366 * 24 * 3600.0


def sane_turn(turn) -> Optional[int]:
    """A wire-carried turn number, validated: int (bools — JSON
    true/false — are hostile here), 0 <= t < MAX_TURN. None otherwise."""
    if isinstance(turn, bool) or not isinstance(turn, int):
        return None
    if not 0 <= turn < MAX_TURN:
        return None
    return turn


def sane_lag(emit_ts, now: Optional[float] = None) -> Optional[float]:
    """Emit-stamp -> lag seconds, made safe to observe: the stamp must
    be a finite number and the resulting lag must land in [0, MAX_AGE)
    (sub-zero readings within clock granularity clamp to 0, exactly
    the turn-latency rule; anything further off is a corrupt or
    hostile stamp and returns None — dropped, never observed)."""
    if isinstance(emit_ts, bool) or not isinstance(emit_ts, (int, float)):
        return None
    ts = float(emit_ts)
    if ts != ts or ts in (float("inf"), float("-inf")):
        return None
    lag = (time.time() if now is None else now) - ts
    if lag >= MAX_AGE or lag < -MAX_AGE:
        return None
    return max(0.0, lag)


class TurnClock:
    """Bounded (turn, wall-ts) commit history: the conversion from
    "peer is at turn T" to SECONDS of staleness. `age_of(T)` is how
    long ago the first turn PAST T was committed — 0 when the peer is
    at (or past) the head, and crucially 0 for every peer of a paused
    or settled stream (no commits after T means nothing is missing),
    while a peer falling behind a live stream ages in real time."""

    __slots__ = ("_turns", "_times", "_lock", "capacity")

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._turns: List[int] = []
        self._times: List[float] = []
        self._lock = threading.Lock()

    def note(self, turn, ts: Optional[float] = None) -> None:
        """Record one committed turn (monotone; stale/hostile values
        are dropped — see sane_turn; a non-finite or absurd `ts`,
        e.g. derived from a NaN emit stamp, falls back to now)."""
        t = sane_turn(turn)
        if t is None:
            return
        now = time.time()
        if ts is not None and isinstance(ts, (int, float)) \
                and not isinstance(ts, bool):
            ts = float(ts)
            if ts == ts and abs(now - ts) < MAX_AGE:
                now = ts
        with self._lock:
            if self._turns and t <= self._turns[-1]:
                return
            self._turns.append(t)
            self._times.append(now)
            if len(self._turns) > self.capacity:
                # Drop in blocks: amortized O(1) per note.
                cut = self.capacity // 4
                del self._turns[:cut]
                del self._times[:cut]

    def head(self) -> int:
        with self._lock:
            return self._turns[-1] if self._turns else -1

    def age_of(self, peer_turn: int,
               now: Optional[float] = None) -> float:
        """Seconds since the first commit this peer has NOT seen
        (0 when it is current, or when nothing was ever committed).
        A peer older than the retained history reads the oldest
        retained commit — a lower bound, which is the honest answer."""
        with self._lock:
            if not self._turns or peer_turn >= self._turns[-1]:
                return 0.0
            i = bisect.bisect_right(self._turns, peer_turn)
            ts = self._times[min(i, len(self._times) - 1)]
        age = (time.time() if now is None else now) - ts
        return min(max(0.0, age), MAX_AGE)


#: Labeled children the per-peer age family exposes before collapsing
#: into the {peer="other"} aggregate — the cardinality rule.
PEER_AGE_TOPK = 16

#: Minimum seconds between metric-publishing sweeps: sampling rides
#: the heartbeat loops AND the broadcasters' per-chunk housekeeping,
#: and the second caller inside the window is a free no-op.
SAMPLE_MIN_SECS = 0.25


class ServerFreshness:
    """One serving plane's turn-age tracking. The server notes commits
    (`note_commit`) as the authority advances and stamps each peer's
    last-written turn on the connection itself (`_Conn.fresh_turn`, at
    the send sites); `sample()` turns that into the exported series:

    - gol_tpu_server_peer_turn_age_seconds{peer=token}  (TopKGauge)
    - gol_tpu_server_turn_age_seconds{tier=...}         (histogram)
    - gol_tpu_server_worst_turn_age_seconds{tier=...}   (gauge)

    `key` routes multi-authority servers (sessions, recordings): each
    key owns its own TurnClock, so one stalled session cannot age
    another session's watchers."""

    def __init__(self, tier: str):
        self.tier = tier
        self._clocks: Dict[Optional[str], TurnClock] = {}
        self._clock_lock = threading.Lock()
        self._last_sample = 0.0
        #: Peer tokens this instance has published children for —
        #: close() evicts them all, so a shut-down server cannot leave
        #: ghost peers in the shared family.
        self._published: set = set()
        self._peer_ages = obs.registry().topk_gauge(
            "gol_tpu_server_peer_turn_age_seconds",
            "Seconds each attached peer's last-written turn lags the "
            "authoritative committed turn — bounded exposition: top-K "
            "worst labeled, the rest one 'other' aggregate; children "
            "evicted at detach",
            label="peer", cap=PEER_AGE_TOPK,
        )
        self._age_hist = obs.histogram(
            "gol_tpu_server_turn_age_seconds",
            "Peer turn-age distribution (sampled once per liveness "
            "sweep per peer)", {"tier": tier},
        )
        self._worst = obs.gauge(
            "gol_tpu_server_worst_turn_age_seconds",
            "Worst attached peer's turn age at the last sweep "
            "(obs.console's AGE column)", {"tier": tier},
        )

    def clock(self, key: Optional[str] = None) -> TurnClock:
        with self._clock_lock:
            c = self._clocks.get(key)
            if c is None:
                c = self._clocks[key] = TurnClock()
            return c

    def note_commit(self, turn, key: Optional[str] = None,
                    ts: Optional[float] = None) -> None:
        self.clock(key).note(turn, ts)

    def drop_key(self, key: Optional[str]) -> None:
        """Forget a destroyed authority's clock (session destroy)."""
        with self._clock_lock:
            self._clocks.pop(key, None)

    def forget(self, token) -> None:
        """Evict one peer's labeled child at detach (the cardinality
        discipline's teardown half)."""
        self._published.discard(str(token))
        self._peer_ages.remove_child(str(token))

    def close(self) -> None:
        """Server shutdown: evict every child this instance published
        and this tier's gauge/histogram series — a dead server's last
        worst-age reading must not stay glued to the registry (it
        would hold fleet-max AGE columns and `max(...)` alert rules
        hostage forever in any process that serves again)."""
        for token in list(self._published):
            self._peer_ages.remove_child(token)
        self._published.clear()
        obs.registry().remove("gol_tpu_server_worst_turn_age_seconds",
                              {"tier": self.tier})
        obs.registry().remove("gol_tpu_server_turn_age_seconds",
                              {"tier": self.tier})
        with self._clock_lock:
            self._clocks.clear()

    def sample(self, entries: Iterable[Tuple[object, Optional[str]]],
               now: Optional[float] = None, force: bool = False) -> float:
        """One sweep over `(conn, key)` pairs: compute each peer's
        age, publish the per-peer children + histogram + worst gauge.
        Rate-limited (SAMPLE_MIN_SECS) so the broadcaster and the
        heartbeat judge can both call it without double-observing.
        Returns the worst age seen (0.0 on a skipped sweep)."""
        mono = time.monotonic()
        if not force and mono - self._last_sample < SAMPLE_MIN_SECS:
            return 0.0
        self._last_sample = mono
        worst = 0.0
        for conn, key in entries:
            if getattr(conn, "scrub", False):
                # Seek-parked peers are deliberately historical: their
                # staleness is the feature, not an alarm — and any age
                # published BEFORE the park must not stay glued to the
                # top-K family for the park's duration.
                self.forget(conn.token)
                continue
            turn = getattr(conn, "fresh_turn", -1)
            if turn < 0:
                # Never written to (mid-attach, board sync pending):
                # there is no staleness to measure yet — age_of(-1)
                # would read the whole retained history and poison the
                # histogram/worst gauge on every attach.
                continue
            age = self.clock(key).age_of(turn, now)
            worst = max(worst, age)
            token = str(conn.token)
            self._published.add(token)
            self._peer_ages.set_child(token, round(age, 3))
            self._age_hist.observe(age)
        self._worst.set(round(worst, 3))
        return worst


class ClientFreshness:
    """The client-side twin: how stale is THIS process's applied
    board? The head clock advances from everything the server tells us
    about its committed turn — stamped turn events and batch frames
    (emit stamps corrected onto the local clock by the clock-probe offset)
    and heartbeat beacons (which carry the committed turn precisely so
    an idle-attached client still sees progress). `age()` is then the
    TurnClock math against the last APPLIED turn — measured end-to-end
    freshness, the number the canary publishes."""

    def __init__(self):
        self._clock = TurnClock()
        self.applied_turn = -1

    def note_head(self, turn, ts: Optional[float] = None) -> None:
        self._clock.note(turn, ts)

    def note_applied(self, turn) -> None:
        t = sane_turn(turn)
        if t is not None and t > self.applied_turn:
            self.applied_turn = t

    def head(self) -> int:
        return self._clock.head()

    def age(self, now: Optional[float] = None) -> float:
        return self._clock.age_of(self.applied_turn, now)


# --- alert rules ---------------------------------------------------------


_AGGS = ("sum", "max", "min", "avg", "p50", "p95", "p99", "rate")

_RULE_RE = re.compile(
    r"^(?P<name>[A-Za-z_][\w.-]*)\s*:\s*"
    r"(?:(?P<agg>[a-z0-9]+)\s*\(\s*(?P<fam1>[A-Za-z_:][\w:]*)\s*\)"
    r"|(?P<fam2>[A-Za-z_:][\w:]*))\s*"
    r"(?P<op>>=|<=|>|<)\s*"
    r"(?P<thr>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)"
    r"(?:\s+for\s+(?P<dur>\d+(?:\.\d+)?)(?P<unit>s|m|h)?)?\s*$"
)

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

_UNIT_SECS = {None: 1.0, "s": 1.0, "m": 60.0, "h": 3600.0}


def cumulative_bucket_delta(cur: list, prev: Optional[list]) -> list:
    """Window one histogram between two scrapes: cumulative `le`
    buckets at t1 minus the same histogram's buckets at t0 — the
    distribution of observations that arrived IN BETWEEN (the
    histogram_quantile(rate(...)) idea, without a range vector). With
    no previous sample the full histogram is the window. Counts are
    monotone, so the delta is itself a valid cumulative list; an empty
    window (no new observations) yields a zero-total list, which
    quantile_from_buckets maps to None."""
    if not prev:
        return cur

    def prev_at(bound: float) -> int:
        at = 0
        for b, c in prev:
            if b <= bound:
                at = c
            else:
                break
        return at

    return [(b, max(0, c - prev_at(b))) for b, c in cur]


class AlertRule:
    """One parsed rule: `name: agg(family) OP threshold [for dur]`.
    States: ok -> pending (condition true, `for` not yet served) ->
    firing; leaving the condition from firing is a resolve."""

    __slots__ = ("name", "agg", "family", "op", "threshold",
                 "for_secs", "raw", "state", "since", "firing_since",
                 "last_value", "history")

    def __init__(self, name: str, agg: str, family: str, op: str,
                 threshold: float, for_secs: float, raw: str):
        self.name = name
        self.agg = agg
        self.family = family
        self.op = op
        self.threshold = threshold
        self.for_secs = for_secs
        self.raw = raw
        self.state = "ok"
        self.since: Optional[float] = None
        self.firing_since: Optional[float] = None
        self.last_value: Optional[float] = None
        #: (ts, condition) samples — the recorded history `for:` is
        #: judged against (see AlertEvaluator.eval_once /
        #: seed_history). Bounded; pruned to ~2x the for window.
        self.history: deque = deque(maxlen=512)

    def expr(self) -> str:
        base = (self.family if self.agg == "sum"
                else f"{self.agg}({self.family})")
        tail = (f" for {self.for_secs:g}s" if self.for_secs else "")
        return f"{base} {self.op} {self.threshold:g}{tail}"

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "expr": self.expr(),
            "state": self.state,
            "value": self.last_value,
            "threshold": self.threshold,
            "for": self.for_secs,
            "since": self.since,
            "firing_since": self.firing_since,
        }


def parse_rules(text: str) -> List[AlertRule]:
    """Parse a rule file (one rule per line; blanks and `#` comments
    skipped). Raises ValueError naming the offending line — the CLI
    turns that into a STARTUP error, so a typo'd rule file can never
    take the sidecar (or the server behind it) down at runtime."""
    rules: List[AlertRule] = []
    seen = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        m = _RULE_RE.match(line)
        if not m:
            raise ValueError(
                f"alert rule line {lineno}: cannot parse {line!r} "
                "(expected 'name: [agg(]family[)] OP threshold "
                "[for DURATION]')"
            )
        agg = m.group("agg") or "sum"
        if agg not in _AGGS:
            raise ValueError(
                f"alert rule line {lineno}: unknown aggregation "
                f"{agg!r} (one of {', '.join(_AGGS)})"
            )
        name = m.group("name")
        if name in seen:
            raise ValueError(
                f"alert rule line {lineno}: duplicate rule name "
                f"{name!r}"
            )
        seen.add(name)
        family = m.group("fam1") or m.group("fam2")
        for_secs = (float(m.group("dur")) * _UNIT_SECS[m.group("unit")]
                    if m.group("dur") else 0.0)
        rules.append(AlertRule(
            name, agg, family, m.group("op"),
            float(m.group("thr")), for_secs, line,
        ))
    return rules


def load_rules(path: str) -> List[AlertRule]:
    with open(path) as f:
        return parse_rules(f.read())


class AlertEvaluator:
    """Evaluate rules on an interval inside the metrics sidecar.

    The value source is Prometheus TEXT — by default the local
    registry's own exposition, but `eval_once(text=...)` takes any
    scrape, so the identical rule grammar works against a remote
    endpoint (CI harnesses, the fuzz suite). Evaluation can never
    crash the sidecar: a family that does not exist yields None
    (condition false), and any unexpected evaluation error is logged
    and swallowed (pinned by the fuzz suite).

    Transitions are observable three ways: `gol_tpu_alert_firing
    {rule=...}` 0/1 gauges (the console's ALERT rows read these off
    /metrics), `gol_tpu_alert_transitions_total{state=firing|resolved}`
    counters (bench_compare gates `alerts_firing` off a zero
    baseline), and flight-recorder notes — the black box records WHEN
    the SLO broke, next to what the serving plane was doing."""

    def __init__(self, rules: List[AlertRule], *,
                 registry: Optional[object] = None,
                 interval: float = 1.0,
                 series_source=None):
        self.rules = list(rules)
        self._registry = registry if registry is not None \
            else obs.registry()
        #: Optional zero-arg callable returning a Series dict — the
        #: collector points this at its TSDB's merged latest values,
        #: so fleet-wide rules evaluate over COLLECTED series instead
        #: of the collector's own registry.
        self._series_source = series_source
        self.interval = max(0.05, interval)
        self._rate_prev: Dict[str, Tuple[float, float]] = {}
        #: Per-rule previous cumulative buckets: quantile rules are
        #: WINDOWED (observations since the last eval), so one bad
        #: minute cannot latch a p99 rule for the process lifetime.
        self._bucket_prev: Dict[str, list] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._firing_gauge = obs.gauge(
            "gol_tpu_alerts_firing",
            "Alert rules currently in the firing state",
        )
        self._transitions = {
            s: obs.counter(
                "gol_tpu_alert_transitions_total",
                "Alert state transitions", {"state": s},
            ) for s in ("firing", "resolved")
        }
        self._rule_gauges = {
            r.name: obs.gauge(
                "gol_tpu_alert_firing",
                "1 while the named rule fires (obs.console ALERT rows)",
                {"rule": r.name},
            ) for r in self.rules
        }
        for g in self._rule_gauges.values():
            g.set(0)
        self._firing_gauge.set(0)

    # -- lifecycle --

    def start(self) -> "AlertEvaluator":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="gol-alerts", daemon=True,
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for r in self.rules:
            obs.registry().remove("gol_tpu_alert_firing",
                                  {"rule": r.name})
        # The aggregate gauge follows the same teardown discipline: a
        # closed evaluator that was firing must not leave the count
        # glued in the registry (a process that serves again would
        # render phantom ALRT columns forever).
        self._firing_gauge.set(0)
        obs.registry().remove("gol_tpu_alerts_firing")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.eval_once()
            except Exception:
                # The evaluator must never take the sidecar down —
                # a broken rule degrades to a logged no-op.
                log.exception("alert evaluation failed")

    # -- evaluation --

    def _value(self, rule: AlertRule, series: dict,
               now: float) -> Optional[float]:
        from gol_tpu_torch.obs.console import (
            histogram_buckets,
            max_series,
            sum_series,
        )

        if rule.agg in ("p50", "p95", "p99"):
            buckets = histogram_buckets(series, rule.family)
            if not buckets:
                return None
            # Windowed, not all-time: the quantile of observations
            # since the LAST eval (cumulative-bucket delta). An
            # all-time quantile over a cumulative histogram would
            # latch — after one bad minute the lifetime p99 stays hot
            # for hours and the rule never resolves.
            prev = self._bucket_prev.get(rule.name)
            self._bucket_prev[rule.name] = buckets
            return quantile_from_buckets(
                cumulative_bucket_delta(buckets, prev),
                {"p50": 0.5, "p95": 0.95, "p99": 0.99}[rule.agg],
            )
        if rule.agg == "rate":
            cur = sum_series(series, rule.family)
            if cur is None:
                return None
            prev = self._rate_prev.get(rule.name)
            self._rate_prev[rule.name] = (now, cur)
            if prev is None or now <= prev[0]:
                return None  # first sample: no rate yet
            return max(0.0, cur - prev[1]) / (now - prev[0])
        if rule.agg == "max":
            return max_series(series, rule.family)
        vals = [v for key, v in series.items()
                if key == rule.family or key.startswith(rule.family + "{")]
        if not vals:
            return None
        if rule.agg == "min":
            return min(vals)
        if rule.agg == "avg":
            return sum(vals) / len(vals)
        return sum(vals)

    def eval_once(self, now: Optional[float] = None,
                  text: Optional[str] = None) -> dict:
        """One evaluation pass over `text` (default: the local
        registry's exposition). Returns the /alerts payload."""
        from gol_tpu_torch.obs import flight
        from gol_tpu_torch.obs.console import parse_prometheus

        now = time.monotonic() if now is None else now
        if text is not None:
            series = parse_prometheus(text)
        elif self._series_source is not None:
            series = self._series_source()
        else:
            series = parse_prometheus(self._registry.prometheus_text())
        with self._lock:
            firing = 0
            for rule in self.rules:
                try:
                    v = self._value(rule, series, now)
                except Exception:
                    log.exception("rule %r evaluation failed", rule.name)
                    v = None
                rule.last_value = v
                cond = v is not None and _OPS[rule.op](v, rule.threshold)
                # `for:` is judged against recorded HISTORY, not just
                # the consecutive-eval clock: the sample log below is
                # what _sustained() reads, and what seed_history()
                # pre-populates from the collector's store after a
                # restart.
                rule.history.append((now, cond))
                horizon = now - max(60.0, 2.0 * rule.for_secs)
                while rule.history and rule.history[0][0] < horizon:
                    rule.history.popleft()
                if cond:
                    if rule.state == "ok":
                        rule.state = "pending"
                        rule.since = now
                    if (rule.state == "pending"
                            and now - rule.since >= rule.for_secs
                            and _sustained(rule, now)):
                        rule.state = "firing"
                        rule.firing_since = now
                        self._transitions["firing"].inc()
                        self._rule_gauges[rule.name].set(1)
                        flight.note("alert.firing", rule=rule.name,
                                    value=v, expr=rule.expr())
                        log.warning("ALERT firing: %s (value %r)",
                                    rule.expr(), v)
                else:
                    if rule.state == "firing":
                        self._transitions["resolved"].inc()
                        self._rule_gauges[rule.name].set(0)
                        flight.note("alert.resolved", rule=rule.name,
                                    value=v, expr=rule.expr())
                        log.warning("alert resolved: %s (value %r)",
                                    rule.expr(), v)
                    rule.state = "ok"
                    rule.since = None
                    rule.firing_since = None
                if rule.state == "firing":
                    firing += 1
            self._firing_gauge.set(firing)
            return self.payload_locked(firing)

    def payload_locked(self, firing: int) -> dict:
        return {
            "rules": [r.as_dict() for r in self.rules],
            "firing": firing,
            "interval": self.interval,
        }

    def payload(self) -> dict:
        """The /alerts endpoint body — sane with zero rules loaded
        (an empty rules list, firing 0), pinned by the fuzz suite."""
        with self._lock:
            firing = sum(1 for r in self.rules if r.state == "firing")
            return self.payload_locked(firing)

    def seed_history(self, values_fn, now: Optional[float] = None
                     ) -> int:
        """Seed each `for:` rule's condition history from STORED
        samples (the collector calls this with its TSDB after
        `--resume`): `values_fn(rule)` returns [(age_seconds, value),
        ...] — ages relative to now, oldest first or not (sorted
        here). A breach that was already N seconds old when this
        evaluator (re)started keeps its pending credit, so a collector
        restart cannot reset every `for:` clock; a recorded good
        sample inside the window keeps blocking the page exactly as a
        live one would. Returns how many rules were seeded pending."""
        now = time.monotonic() if now is None else now
        seeded = 0
        with self._lock:
            for rule in self.rules:
                if not rule.for_secs:
                    continue
                try:
                    samples = values_fn(rule)
                except Exception:
                    log.exception("history seed failed for rule %r",
                                  rule.name)
                    continue
                if not samples:
                    continue
                run_start = None
                for age, v in sorted(samples, key=lambda p: -p[0]):
                    cond = v is not None \
                        and _OPS[rule.op](v, rule.threshold)
                    rule.history.append((now - age, cond))
                    if cond:
                        if run_start is None:
                            run_start = now - age
                    else:
                        run_start = None
                if run_start is not None and rule.state == "ok":
                    rule.state = "pending"
                    rule.since = run_start
                    seeded += 1
        return seeded


def _sustained(rule: AlertRule, now: float) -> bool:
    """True when every recorded condition sample inside the trailing
    `for:` window held — the history-plane firing gate. With live-only
    evaluation this agrees with the pending clock (a false sample
    resets the state machine anyway); with seeded history it is the
    stronger judge: one noisy recorded scrape inside the window blocks
    the page until a clean window accrues."""
    if not rule.for_secs:
        return True
    return all(c for t, c in rule.history if t >= now - rule.for_secs)
