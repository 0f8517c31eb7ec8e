"""Freshness plane — end-to-end turn-age SLOs (the host-side copy of
`gol_tpu.obs.freshness`).

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

The alert-rule half of `gol_tpu.obs.freshness` (`AlertRule`,
`AlertEvaluator`, `--alert-rules`) is not ported yet.

Pure stdlib (the registry discipline); every hot-path call is host-side
and sweep-granular, never per frame.
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from gol_tpu_torch import obs

__all__ = [
    "ClientFreshness",
    "ServerFreshness",
    "TurnClock",
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
