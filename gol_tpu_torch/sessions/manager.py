"""SessionManager — bucketed multi-tenant board ownership (the port of
`gol_tpu.sessions.manager`, with the same verbs, files, metric names
and defaults).

The manager reaches the device only through each bucket's
`BatchStepper` (`parallel.stepper.make_batch_stepper`): on the CUDA card
unless the caller asks for the CPU (`device="cpu"`); without a card the
constructor raises. A packable bucket's k-turn chunk is one launch of
kernel A's batched entry, whatever its occupancy.

Threading contract (the engine-thread discipline of
`engine.distributor`, applied to buckets): when a `SessionEngine` is
running, ITS thread is the only one that touches device tensors —
public verbs from other threads post requests the engine services
between dispatches. Without an engine (tests, the bench), the calling
thread owns the device and verbs execute inline. Bookkeeping dicts are
guarded by one lock either way, so `list_sessions` is safe from any
thread and never touches the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from typing import Callable, Optional

import numpy as np

from gol_tpu_torch import obs
from gol_tpu_torch.models.rules import GenRule, LIFE, Rule, get_rule
from gol_tpu_torch.obs import accounting, device, flight, tracing
from gol_tpu_torch.analysis.concurrency import lockcheck

#: Session ids are path components (checkpoints live under
#: out/sessions/<id>/) and metric label values — one conservative
#: charset serves both, and rejects traversal outright.
SESSION_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")

#: Per-session registry series — the exact set `destroy` evicts
#: (tests pin that the registry shrinks back under churn).
PER_SESSION_SERIES = (
    "gol_tpu_session_turns_total",
    "gol_tpu_session_watchers",
)

# Bounded-cardinality audit: every per-session series is declared to
# the registry's shared eviction helper, so ONE evict_entity call at
# destroy/park removes the whole set (and the churn test can assert
# the registry ends where it started).
obs.track_entity_series("session", *PER_SESSION_SERIES)

#: Board-dimension sanity bound for wire-driven creates: a hostile
#: create must not make the server allocate an arbitrary raster.
MAX_SESSION_CELLS = 4096 * 4096

#: Minimum per-turn changed-words cap once the compact encoding
#: engages (the engine's DIFF_SPARSE_MIN_CAP, same rationale).
COMPACT_MIN_CAP = 64


def valid_session_id(sid) -> bool:
    return isinstance(sid, str) and bool(SESSION_ID_RE.match(sid))


def seeded_board(height: int, width: int, seed: int,
                 density: float = 0.25) -> np.ndarray:
    """The deterministic soup a seeded create starts from — one
    derivation shared by `create`, manifest-driven resume, and the
    chaos harness's unfaulted oracle (`gol_tpu_torch.testing.chaos`), so
    "bit-identical to an unfaulted run" is checkable from the recipe
    alone."""
    rng = np.random.default_rng(int(seed))
    return ((rng.random((height, width)) < float(density))
            .astype(np.uint8) * np.uint8(255))


class SessionError(ValueError):
    """A session verb failed for a caller-visible reason (unknown id,
    duplicate create, invalid geometry/rule). The message is the wire
    `reason` — keep it one short token-ish phrase."""


class _SessionMetrics:
    """Registry handles for the session plane (gol_tpu_torch.obs). Bucket-
    and process-level series are unbounded-lifetime; per-SESSION
    children are created at `create` and evicted at `destroy` (see
    PER_SESSION_SERIES)."""

    def __init__(self):
        self.active = obs.gauge(
            "gol_tpu_sessions_active", "Currently live sessions"
        )
        self.buckets = obs.gauge(
            "gol_tpu_session_buckets", "Shape/rule buckets currently held"
        )
        self.creates = obs.counter(
            "gol_tpu_session_creates_total", "Sessions created"
        )
        self.destroys = obs.counter(
            "gol_tpu_session_destroys_total", "Sessions destroyed"
        )
        self.checkpoints = obs.counter(
            "gol_tpu_session_checkpoints_total",
            "Per-session PGM checkpoints written",
        )
        self.resumes = obs.counter(
            "gol_tpu_session_resumes_total",
            "Sessions restored from per-session checkpoints",
        )
        self.parked = obs.gauge(
            "gol_tpu_sessions_parked",
            "Sessions currently hibernated (checkpointed, device "
            "rows freed; rehydrated bit-exactly on attach)",
        )
        self.hibernates = obs.counter(
            "gol_tpu_session_hibernates_total",
            "Sessions parked to their checkpoint (idle policy or the "
            "park verb)",
        )
        self.rehydrates = obs.counter(
            "gol_tpu_session_rehydrates_total",
            "Parked sessions restored into a bucket slot on attach",
        )
        self.adoptions = obs.counter(
            "gol_tpu_session_adoptions_total",
            "Sessions adopted from ANOTHER manager's checkpoint tree "
            "(control-plane migration: park on A, adopt on B)",
        )
        paths = ("fused", "diffs", "compact")
        self.dispatches = {
            p: obs.counter(
                "gol_tpu_session_dispatches_total",
                "Bucket dispatches by path", {"path": p},
            ) for p in paths
        }
        self.dispatch_seconds = {
            p: obs.histogram(
                "gol_tpu_session_dispatch_seconds",
                "Host-blocking seconds per bucket dispatch", {"path": p},
            ) for p in paths
        }
        self.compact_redos = obs.counter(
            "gol_tpu_session_compact_redos_total",
            "Bucket chunks redone densely after a value-buffer overflow",
        )
        self.bucket_grows = obs.counter(
            "gol_tpu_session_bucket_grows_total",
            "Bucket capacity doublings (each is a new stack and stepper)",
        )


_METRICS = _SessionMetrics()


class Sink:
    """Per-session event consumer protocol. All callbacks run on the
    dispatching thread (the SessionEngine's, or the caller's in inline
    mode) — implementations must be non-blocking (the server sink
    enqueues to per-connection writer queues). Exceptions raised by a
    sink detach it."""

    #: Sinks that don't want per-turn flip payloads still get
    #: `on_sync`/`on_turn`/`on_close`.
    want_flips = True

    #: EPHEMERAL sinks (the replay plane's RecorderSink) never count
    #: as watchers for the hibernation policy: a session whose only
    #: sink is ephemeral still idles, still parks (the park closes the
    #: ephemeral sink with reason "parked"), and its `info()` watcher
    #: count stays honest. They DO count for the dispatch path —
    #: recording needs the diff stream.
    ephemeral = False

    #: A POSITIVE value makes this sink chunk-granular: the manager
    #: hands whole dispatched chunks to `on_flip_chunk` instead of the
    #: per-turn on_flips/on_turn loop, and the SessionEngine scales
    #: the bucket's dispatch chunk up to this many turns (the batched
    #: wire). 0 = per-turn callbacks (the legacy contract,
    #: preserved).
    batch_turns = 0

    def on_sync(self, sid: str, turn: int, board: np.ndarray) -> None:
        """Full board state at attach (and after any resync)."""

    def on_flips(self, sid: str, turn: int, coords: np.ndarray) -> None:
        """One turn's flipped cells as an (N, 2) int32 x,y array —
        exactly the single-board engine's FlipBatch payload."""

    def on_flip_chunk(self, sid: str, first_turn: int, counts,
                      bitmaps, words) -> None:
        """A whole dispatched chunk for this session in the S-sparse
        layout (events.FlipChunk: per-turn changed-word counts,
        bitmaps, concatenated XOR masks), covering turns
        `first_turn .. first_turn + len(counts) - 1`. Called instead
        of the per-turn loop when `batch_turns` > 0 and the bucket is
        packed; a chunk-granular sink does its own per-turn
        bookkeeping."""

    def on_turn(self, sid: str, turn: int) -> None:
        """A turn committed for this session."""

    def on_close(self, sid: str, reason: str) -> None:
        """The session is gone (destroyed / manager shutdown)."""


class Session:
    """One tenant: a slot in a bucket plus its own turn clock."""

    def __init__(self, sid: str, bucket: "_Bucket", slot: int,
                 start_turn: int, seed: Optional[int] = None,
                 density: float = 0.25):
        self.id = sid
        self.bucket = bucket
        self.slot = slot
        self.start_turn = start_turn
        #: Creation recipe, when the board came from a seeded soup —
        #: recorded in the session manifest so a crash BEFORE the first
        #: checkpoint still resumes deterministically (the manifest
        #: entry alone can rebuild the turn-0 board).
        self.seed = seed
        self.density = density
        self.birth_ticks = bucket.ticks
        self.created_at = time.time()
        #: monotonic instant this session last lost its final sink
        #: (or was created sinkless) — the auto-park policy's idle
        #: clock; None while anything is attached.
        self.idle_since: Optional[float] = time.monotonic()
        # Per-session labeled children — evicted at destroy.
        self.turns_metric = obs.counter(
            "gol_tpu_session_turns_total",
            "Turns committed per live session (evicted at destroy)",
            {"session": sid},
        )
        self.watchers_metric = obs.gauge(
            "gol_tpu_session_watchers",
            "Sinks attached per live session (evicted at destroy)",
            {"session": sid},
        )

    @property
    def turn(self) -> int:
        """Completed turns: sessions in a bucket step in lockstep, so a
        session's clock is its resume offset plus the bucket ticks
        since it joined."""
        return self.start_turn + (self.bucket.ticks - self.birth_ticks)

    def info(self) -> dict:
        b = self.bucket
        return {
            "id": self.id,
            "width": b.width,
            "height": b.height,
            "rule": str(b.rule),
            "turn": self.turn,
            # Ephemeral sinks (recorders) are plumbing, not watchers.
            "watchers": len(_watching(b.sinks.get(self.id, ()))),
            "bucket": b.key,
        }


def _host_words(t) -> np.ndarray:
    """A device tensor as a host array, int32 words viewed as gol_tpu's
    uint32 (bool masks pass through)."""
    host = np.ascontiguousarray(t.cpu().numpy())
    return host.view(np.uint32) if host.dtype == np.int32 else host


def _watching(sinks) -> list:
    """The NON-ephemeral sinks of one session — what the idle/park
    policy and the watcher counts mean by "watched"."""
    return [sk for sk in (sinks or ())
            if not getattr(sk, "ephemeral", False)]


class _Bucket:
    """One (height, width, rule) shape class: a BatchStepper, its
    stacked device state, and the slot bookkeeping."""

    def __init__(self, height: int, width: int, rule: Rule,
                 capacity: int, dev=None):
        from gol_tpu_torch.parallel.stepper import make_batch_stepper

        self.height, self.width, self.rule = height, width, rule
        self.key = f"{width}x{height}/{rule}"
        self.device = dev
        # Compiles fired while a bucket is built/warmed are attributed
        # to it on the device plane (the device plane's cause label).
        with device.cause("bucket-new"):
            self.bs = make_batch_stepper(capacity, height, width, rule,
                                         dev)
            zero = np.zeros((height, width), np.uint8)
            self.stack = self.bs.put_all([zero] * capacity)
        if device.cost_probes_enabled():
            cost = device.publish_cost(
                "bucket.step", height, width, rule,
                layout="packed" if self.bs.packed else "dense",
                boards=capacity,
            )
            m = accounting.meter()
            if m is not None:
                # Per-bucket price: one step of the WHOLE stack (padding
                # slots step too) — the accounting plane splits it
                # across the bucket's live tenants at dispatch time.
                m.set_price(f"bucket.step:{self.key}", cost)
        #: Free slots, lowest first (pop from the end).
        self.free = list(range(capacity - 1, -1, -1))
        self.sessions: "dict[int, Session]" = {}   # slot -> Session
        self.sinks: "dict[str, list[Sink]]" = {}   # sid -> sinks
        #: Total turns this bucket has stepped since creation — every
        #: occupied slot advances by exactly this clock.
        self.ticks = 0
        #: Per-slot activity weights (changed-word counts) of the last
        #: watched dispatch — the accounting plane's bucket-split rule;
        #: None after a fused dispatch (equal turn-weighted shares).
        self.last_weights: "Optional[dict]" = None
        #: Adaptive per-turn changed-words cap for the compact path
        #: (None = not yet enabled; next watched chunk runs plain
        #: diffs to observe activity). Pow2 with 2x headroom, exactly
        #: the engine's `_adapt_sparse_cap` hysteresis.
        self.compact_cap: Optional[int] = None
        self.last_save_tick = 0

    @property
    def live(self) -> int:
        return len(self.sessions)

    def watched(self) -> bool:
        return any(self.sinks.get(s.id) for s in self.sessions.values())

    def flip_watched(self) -> bool:
        return any(
            sink.want_flips
            for s in self.sessions.values()
            for sink in self.sinks.get(s.id, ())
        )

    def batch_hint(self) -> int:
        """Negotiated batch pacing for this bucket's dispatch chunk —
        the SessionEngine raises a watched bucket's chunk to it, so a
        batching watcher isn't pinned at the 16-turn interactive chunk
        (the chunk-pinning fix). Sessions in a bucket step in
        LOCKSTEP, so the raise only happens when EVERY attached sink
        is chunk-granular (one per-turn watcher anywhere in the bucket
        keeps the interactive chunk — the tenant paying the latency
        must be one who negotiated it), and the SMALLEST negotiated
        max-k paces the bucket (conservative: nobody's whole-batch
        latency exceeds their own negotiation)."""
        hints = [getattr(sink, "batch_turns", 0)
                 for s in self.sessions.values()
                 for sink in self.sinks.get(s.id, ())]
        if not hints or 0 in hints:
            return 0
        return min(hints)

    def adapt_cap(self, peak_words: int) -> None:
        ceiling = self.bs.total_words // 2
        if (not self.bs.offers("step_n_with_diffs_compact")
                or ceiling < COMPACT_MIN_CAP or 2 * peak_words > ceiling):
            new = None
        else:
            want = (
                max(COMPACT_MIN_CAP, 1 << (2 * peak_words - 1).bit_length())
                if peak_words else COMPACT_MIN_CAP
            )
            new = min(want, 1 << (ceiling.bit_length() - 1))
        if new != self.compact_cap:
            # Each distinct cap changes the k-turn scan's buffers —
            # timeline-worthy, exactly like the engine's sparse cap.
            tracing.event("session.compact_cap", "engine",
                          bucket=self.key, cap=new, peak=peak_words)
        self.compact_cap = new


class SessionManager:
    def __init__(self, *, out_dir: str = "out",
                 default_rule: "Rule | str" = LIFE,
                 bucket_capacity: int = 16,
                 autosave_turns: int = 0,
                 max_sessions: Optional[int] = None,
                 park_idle_secs: Optional[float] = None,
                 device=None):
        if bucket_capacity < 1:
            raise ValueError("bucket_capacity must be >= 1")
        self.out_dir = out_dir
        self.default_rule = (get_rule(default_rule)
                             if isinstance(default_rule, str)
                             else default_rule)
        self.bucket_capacity = bucket_capacity
        self.autosave_turns = max(0, int(autosave_turns))
        #: Admission budget (docs/RESILIENCE.md "Overload &
        #: degradation"): creates beyond this raise
        #: SessionError("max-sessions") — the server turns that into an
        #: over-budget rejection with a retry_after hint. None = no cap.
        #: The budget counts RESIDENT sessions only: parked sessions
        #: hold no device rows, so hibernation turns --max-sessions
        #: from an HBM bound into an admission-rate bound
        #: (docs/SESSIONS.md "Hibernation").
        self.max_sessions = max_sessions
        #: Idle-hibernation policy: sessions with no sink (watcher or
        #: driver) for this many seconds are parked by `park_idle`
        #: (the SessionEngine sweeps it every loop round). 0 parks at
        #: the first idle sweep; None (default) never auto-parks.
        self.park_idle_secs = park_idle_secs
        #: Replay-plane recording state (gol_tpu_torch.replay): when the
        #: serving layer records sessions it sets this (e.g.
        #: {"keyframe_turns": K}) and every session.json sidecar
        #: carries it under "record" — the durable mark that a
        #: session's out/sessions/<id>/replay/ log is live.
        self.record_meta: "Optional[dict]" = None
        #: Recorder factory `(sid, width, height) -> Optional[Sink]`:
        #: when set (SessionServer --record), EVERY `_create` — wire
        #: verb, resume, rehydration — attaches the returned ephemeral
        #: sink INSIDE the create, on the owner thread, before the
        #: session's first dispatch: the recording's first keyframe is
        #: the birth (or revival) board, never a few chunks late.
        self.recorder_factory = None
        #: Hibernated sessions: sid -> manifest-shaped meta (width/
        #: height/rule/seed/density + parked/turn). No device rows,
        #: no bucket slot — just the durable record; `_rehydrate`
        #: turns an entry back into a live Session on attach.
        self._parked: "dict[str, dict]" = {}
        from gol_tpu_torch.parallel.stepper import resolve_device

        #: The card unless the caller asked for the CPU; raises
        #: without one (no fallback).
        self.device = resolve_device(device)
        #: True only inside `resume_all`: restoring creates defer the
        #: manifest rewrite to one commit at the end of the resume.
        self._restoring = False
        #: True only inside `_park_idle`: a parking sweep defers the
        #: manifest rewrite to one commit at the end (same rationale).
        self._deferring_manifest = False
        self._buckets: "dict[tuple, _Bucket]" = {}
        self._by_id: "dict[str, Session]" = {}
        self._lock = lockcheck.make_rlock("SessionManager._lock")
        #: Cross-thread verb requests: (fn, event, box) serviced by the
        #: engine thread between dispatches (see `_exec`).
        self._requests: list = []
        #: The SessionEngine driving this manager, if any (set by the
        #: engine itself); its kick event wakes an idle loop when a
        #: request lands.
        self._engine = None
        self._kick = threading.Event()
        self._closed = False

    # --- public verbs (any thread) ---

    def create(self, sid: str, *, width: int, height: int,
               rule: "Rule | str | None" = None,
               board: Optional[np.ndarray] = None,
               seed: Optional[int] = None, density: float = 0.25,
               start_turn: int = 0) -> dict:
        """Create a session; returns its info dict. `board` wins over
        `seed` (a deterministic random soup); neither means an empty
        board. Raises SessionError on invalid ids/geometry/rules or a
        duplicate id."""
        if not valid_session_id(sid):
            raise SessionError("bad-session-id")
        if (not isinstance(width, int) or not isinstance(height, int)
                or width <= 0 or height <= 0
                or width * height > MAX_SESSION_CELLS):
            raise SessionError("bad-dimensions")
        try:
            rule_obj = (self.default_rule if rule is None
                        else get_rule(rule) if isinstance(rule, str)
                        else rule)
        except ValueError:
            raise SessionError("bad-rule") from None
        if isinstance(rule_obj, GenRule) or 0 in rule_obj.birth:
            # Two-state only; B0 padding slots would seethe (see
            # BatchStepper's docstring).
            raise SessionError("unsupported-rule")
        if board is None and seed is not None:
            board = seeded_board(height, width, int(seed), float(density))
        if board is not None:
            board = np.asarray(board, np.uint8)
            if board.shape != (height, width):
                raise SessionError("bad-board")
        return self._exec(lambda: self._create(
            sid, width, height, rule_obj, board, int(start_turn),
            seed=None if seed is None else int(seed),
            density=float(density),
        ))

    def destroy(self, sid: str) -> None:
        self._exec(lambda: self._destroy(sid, "destroyed"))

    def park(self, sid: str) -> dict:
        """Hibernate a session (docs/SESSIONS.md "Hibernation"):
        checkpoint it (crash-atomic PGM + sidecar), record it parked
        in the manifest, and free its bucket slot (a slot clear —
        no new stack in a warm bucket). Raises
        SessionError("watched") while any sink is attached,
        ("parked") when already hibernated. The next attach
        rehydrates it bit-exactly."""
        return self._exec(lambda: self._park(sid))

    def adopt(self, sid: str, source_dir: "str | os.PathLike") -> dict:
        """Adopt a session hibernated under ANOTHER manager's out tree
        (control-plane migration: park on engine A, adopt on
        engine B, flip the serving endpoint). Reads the source tree's
        `session.json` sidecar + latest snapshot — the same bit-exact
        state a local rehydrate would load — creates the session
        resident HERE at the snapshot turn, and immediately
        re-checkpoints into THIS manager's own tree so the adopted
        session is durable locally (B's resume never depends on A's
        disk again).

        The source tree is read-only: the parked record on A stays
        A's to destroy (the controller's two-phase migration record
        sequences that). Raises SessionError("exists") for a duplicate
        id, ("unknown-session") when the source has no such session or
        it is tombstoned there, ("unrecoverable") for a torn source
        tree."""
        if not valid_session_id(sid):
            raise SessionError("bad-session-id")
        return self._exec(
            lambda: self._adopt(sid, os.fspath(source_dir)))

    def park_idle(self) -> int:
        """Park every session idle (no sink) past `park_idle_secs` —
        the SessionEngine sweeps this between dispatch rounds (the
        _exec routing keeps the device work on the owner thread for
        any other caller). Returns the number parked; 0 when the
        policy is off."""
        if self.park_idle_secs is None or self._closed:
            return 0
        return self._exec(self._park_idle)

    def _park_idle(self) -> int:
        now = time.monotonic()
        due = [
            s.id for s in list(self._by_id.values())
            if not _watching(s.bucket.sinks.get(s.id))
            and s.idle_since is not None
            and now - s.idle_since >= self.park_idle_secs
        ]
        # One manifest commit for the whole sweep, not one per parked
        # session — a burst of N idle sessions would otherwise rewrite
        # the N-entry manifest N times under the manager lock (O(N²)
        # serialization stalling every verb). The crash window stays
        # bounded-conservative: a session parked in memory but not yet
        # recorded merely resumes LIVE from its just-written snapshot.
        n = 0
        self._deferring_manifest = True
        try:
            for sid in due:
                try:
                    self._park(sid)
                    n += 1
                except (SessionError, OSError):
                    continue
        finally:
            self._deferring_manifest = False
        if n:
            with contextlib.suppress(OSError):
                self._write_manifest()
        return n

    def is_parked(self, sid: str) -> bool:
        return sid in self._parked

    def parked_meta(self, sid: str) -> Optional[dict]:
        """A parked session's manifest-shaped record (width/height/
        rule/seed/density/turn), or None — the full recipe the
        server's idempotent create-retry compare needs (the public
        listing drops seed/density on purpose)."""
        meta = self._parked.get(sid)
        return dict(meta) if meta is not None else None

    def known(self, sid: str) -> bool:
        """Live OR parked — what an attach may name (lock-free dict
        membership, the peek_turn discipline)."""
        return sid in self._by_id or sid in self._parked

    def peek_geometry(self, sid: str) -> "Optional[tuple[int, int]]":
        """(width, height) of a live or parked session, lock-free;
        None for unknown ids."""
        s = self._by_id.get(sid)
        if s is not None:
            return s.bucket.width, s.bucket.height
        meta = self._parked.get(sid)
        if meta is not None:
            return meta.get("width"), meta.get("height")
        return None

    def checkpoint(self, sid: str) -> dict:
        """Write out/sessions/<sid>/<W>x<H>x<T>.pgm (crash-atomic) plus
        the session.json sidecar; returns {"path", "turn"}."""
        return self._exec(lambda: self._checkpoint(sid))

    def attach(self, sid: str, sink: Sink) -> dict:
        """Register a sink: it receives `on_sync` with the current
        board at the next dispatch boundary, then per-turn callbacks.
        Returns the session info."""
        return self._exec(lambda: self._attach(sid, sink))

    def detach(self, sid: str, sink: Sink) -> None:
        self._exec(lambda: self._detach(sid, sink))

    def fetch_board(self, sid: str) -> np.ndarray:
        """Current (H, W) {0,255} board of a session."""
        return self._exec(lambda: self._fetch_board(sid))

    def list_sessions(self) -> list:
        with self._lock:
            live = [s.info() for s in
                    sorted(self._by_id.values(), key=lambda s: s.id)]
            parked = [
                {"id": sid, "width": meta.get("width"),
                 "height": meta.get("height"),
                 "rule": meta.get("rule"),
                 "turn": int(meta.get("turn", 0)),
                 "watchers": 0, "parked": True}
                for sid, meta in sorted(self._parked.items())
            ]
        return sorted(live + parked, key=lambda i: i["id"])

    def get(self, sid: str) -> Optional[Session]:
        with self._lock:
            return self._by_id.get(sid)

    def peek_turn(self, sid: str) -> int:
        """Lock-free turn hint for liveness paths (the server's
        heartbeat beacons): plain GIL-atomic dict/attribute reads,
        never the manager lock — that lock is held across whole bucket
        dispatches, and a beacon that waits on a cold first dispatch defeats
        its own purpose. May be one dispatch stale; 0 for unknown ids.
        Parked sessions answer their hibernated turn."""
        s = self._by_id.get(sid)
        if s is not None:
            return s.turn
        meta = self._parked.get(sid)
        return int(meta.get("turn", 0)) if meta is not None else 0

    def resume_all(self) -> int:
        """Restore the crash-consistent session set under out/sessions/
        (`--resume latest`, per session; docs/SESSIONS.md
        "Crash-consistent resume"). Manifest-first: when
        manifest.json is readable it names EXACTLY the live set as of
        the last completed create/destroy — each listed session resumes
        from its latest snapshot, or, never having checkpointed, is
        rebuilt from its manifest recipe (seeded soup at turn 0).
        Tombstoned sessions are never resurrected in either mode (the
        tombstone lands BEFORE the manifest rewrite, closing the
        SIGKILL-mid-destroy window). A missing/torn manifest falls back
        to the legacy directory scan. Unreadable entries are skipped —
        resume discovery runs on freshly crashed trees. Returns the
        number restored."""
        from gol_tpu_torch.checkpoint import (
            is_tombstoned,
            latest_any_snapshot,
            read_session_manifest,
            session_checkpoint_dir,
            snapshot_turn,
        )
        from gol_tpu_torch.io.pgm import read_pgm

        root = session_checkpoint_dir(self.out_dir)
        manifest = read_session_manifest(self.out_dir)
        if manifest is None:
            try:
                candidates = {
                    sid: None for sid in sorted(os.listdir(root))
                }
            except OSError:
                return 0
        else:
            candidates = {sid: manifest[sid] for sid in sorted(manifest)}
        restored = 0
        # Restoring creates must NOT rewrite the manifest one by one:
        # a crash mid-resume would commit a manifest naming only the
        # sessions restored so far, silently shrinking the
        # authoritative live set — exactly the torn half-set resume
        # exists to prevent. The pre-crash manifest stays authoritative
        # until the whole set is back; ONE rewrite at the end commits
        # it (and repairs a torn manifest after a directory scan).
        from gol_tpu_torch.checkpoint import manifest_parked

        self._restoring = True
        try:
            for sid, meta in candidates.items():
                if (not valid_session_id(sid) or sid in self._by_id
                        or sid in self._parked
                        or is_tombstoned(self.out_dir, sid)):
                    continue
                if manifest_parked(meta):
                    # Hibernated at the crash/restart: restore the
                    # RECORD, not a slot — the fleet stays mostly
                    # asleep across restarts, and the next attach
                    # rehydrates from the snapshot exactly as it
                    # would have pre-restart.
                    self._parked[sid] = dict(meta)
                    restored += 1
                    continue
                found = latest_any_snapshot(os.path.join(root, sid))
                board = turn = None
                if found is not None:
                    path, w, h = found
                    with contextlib.suppress(OSError, ValueError):
                        board = read_pgm(path)
                        turn = snapshot_turn(path)
                rule = (meta or {}).get("rule")
                if rule is None:
                    with contextlib.suppress(OSError, ValueError,
                                             KeyError, TypeError):
                        side = json.loads(open(
                            os.path.join(root, sid, "session.json")
                        ).read())
                        rule = side.get("rule")
                # The creation recipe rides along even on the snapshot
                # path: a resumed session must keep answering a
                # rid-retried identical-recipe create with ok (the
                # state-based idempotency compares seed/density), and
                # the next manifest rewrite must not lose the recipe.
                seed = (meta or {}).get("seed")
                density = (meta or {}).get("density")
                if board is None:
                    # Created, never checkpointed, killed: the manifest
                    # recipe rebuilds the turn-0 board bit-exactly. A
                    # manifest entry with neither snapshot nor seed
                    # cannot be reconstructed and is skipped
                    # (board-injected sessions accept bounded loss
                    # until first checkpoint).
                    if meta is None or seed is None:
                        continue
                    w, h = meta.get("width"), meta.get("height")
                    turn = 0
                try:
                    self.create(
                        sid, width=w, height=h, rule=rule,
                        board=board, seed=seed,
                        density=0.25 if density is None else density,
                        start_turn=int(turn))
                    restored += 1
                except (SessionError, OSError, ValueError, TypeError):
                    continue
        finally:
            self._restoring = False
        if restored:
            with self._lock:
                with contextlib.suppress(OSError):
                    self._write_manifest()
            _METRICS.parked.set(len(self._parked))
            flight.note("sessions.resume", count=restored)
        return restored

    def close(self) -> None:
        """Close every sink and drop all sessions (process teardown)."""

        def _do():
            self._closed = True
            for sid in [s.id for s in self._by_id.values()]:
                self._destroy(sid, "shutdown")

        with contextlib.suppress(TimeoutError):
            self._exec(_do)

    def health(self) -> dict:
        with self._lock:
            return {
                "status": "ok",
                "sessions": len(self._by_id),
                "parked": len(self._parked),
                "buckets": len(self._buckets),
                "ticks": {b.key: b.ticks for b in self._buckets.values()},
            }

    # --- request plumbing ---

    def _exec(self, fn: Callable, timeout: float = 60.0):
        eng = self._engine
        if eng is None or not eng.running() or eng.is_engine_thread():
            with self._lock:
                return fn()
        ev = threading.Event()
        box: dict = {}
        with self._lock:
            self._requests.append((fn, ev, box))
        self._kick.set()
        if not ev.wait(timeout):
            raise TimeoutError("session engine did not service the verb")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _service_requests(self) -> None:
        """Owner thread: run all pending verbs."""
        with self._lock:
            reqs, self._requests = self._requests, []
        for fn, ev, box in reqs:
            try:
                with self._lock:
                    box["result"] = fn()
            except BaseException as e:  # delivered to the caller
                box["error"] = e
            finally:
                ev.set()

    # --- verb implementations (owner thread, lock held via _exec) ---

    def _bucket_for(self, height: int, width: int, rule: Rule,
                    min_free: int = 1) -> _Bucket:
        key = (height, width, str(rule))
        b = self._buckets.get(key)
        if b is None:
            b = _Bucket(height, width, rule, self.bucket_capacity,
                        self.device)
            self._buckets[key] = b
            _METRICS.buckets.set(len(self._buckets))
            tracing.event("session.bucket", "lifecycle", bucket=b.key,
                          capacity=b.bs.capacity)
        while len(b.free) < min_free:
            self._grow(b)
        return b

    def _grow(self, b: _Bucket) -> None:
        """Double a full bucket's capacity: a new BatchStepper (a new
        stack — the documented cost of outgrowing a bucket; slot
        churn within capacity allocates nothing)."""
        from gol_tpu_torch.parallel.stepper import make_batch_stepper

        old_cap = b.bs.capacity
        new_cap = old_cap * 2
        with device.cause("bucket-grow"):
            boards = [b.bs.fetch_one(b.stack, i) for i in range(old_cap)]
            boards += [np.zeros((b.height, b.width), np.uint8)] * old_cap
            b.bs = make_batch_stepper(new_cap, b.height, b.width, b.rule,
                                      b.device)
            b.stack = b.bs.put_all(boards)
        b.free = list(range(new_cap - 1, old_cap - 1, -1)) + b.free
        _METRICS.bucket_grows.inc()
        tracing.event("session.bucket_grow", "lifecycle", bucket=b.key,
                      capacity=new_cap)
        flight.note("session.bucket_grow", bucket=b.key, capacity=new_cap)

    def _create(self, sid: str, width: int, height: int, rule: Rule,
                board: Optional[np.ndarray], start_turn: int,
                seed: Optional[int] = None,
                density: float = 0.25) -> dict:
        if sid in self._by_id or sid in self._parked:
            # A parked session still owns its id (it is one attach
            # away from being live again) — a create over it is a
            # duplicate, exactly as over a resident one.
            raise SessionError("exists")
        if (self.max_sessions is not None
                and len(self._by_id) >= self.max_sessions):
            # Admission budget: the caller (SessionServer) rides a
            # retry_after hint on this reason so a storm backs off
            # instead of hammering a full house.
            raise SessionError("max-sessions")
        b = self._bucket_for(height, width, rule)
        slot = b.free.pop()
        if board is not None:
            b.stack = b.bs.set_one(b.stack, slot, board)
        else:
            b.stack = b.bs.clear_one(b.stack, slot)
        s = Session(sid, b, slot, start_turn, seed=seed, density=density)
        b.sessions[slot] = s
        self._by_id[sid] = s
        # The manifest rewrite is the create's durability commit: a
        # kill before this line leaves no trace to resume (correct —
        # the verb never acked), a kill after it resumes the session
        # from its manifest recipe even with zero checkpoints written.
        # During resume_all the pre-crash manifest stays authoritative
        # instead (one rewrite at the end of the resume).
        if not self._restoring:
            self._write_manifest()
        # A re-created id takes over a DESTROYED predecessor's
        # directory: the dead incarnation's snapshots and tombstone
        # must not survive into the new one (a later `--resume latest`
        # would skip the live session as destroyed, or restore the dead
        # one's board). Strictly AFTER the manifest commit, with the
        # tombstone removed last: every kill window resumes either
        # nothing (tombstone still present) or the new recipe — never
        # the destroyed incarnation. Gated on the tombstone so resuming
        # a live session never wipes its own checkpoint history.
        self._clear_session_remnants(sid)
        _METRICS.creates.inc()
        _METRICS.active.set(len(self._by_id))
        # Device rows changed hands: a (rate-limited) census keeps the
        # HBM watermark honest even for fleets that park before their
        # first dispatch (the churn smoke's flatness gauge).
        device.observe_memory()
        tracing.event("session.create", "lifecycle", session=sid,
                      bucket=b.key, slot=slot, turn=start_turn)
        flight.note("session.create", session=sid, bucket=b.key)
        if self.recorder_factory is not None:
            # Tape from birth: the recorder's attach-time keyframe is
            # THIS board at THIS turn (after remnant clearing, so a
            # re-created id's log starts clean). A recorder that fails
            # to arm never fails the create — the session is the
            # product, the tape is best-effort.
            with contextlib.suppress(Exception):
                sink = self.recorder_factory(sid, b.width, b.height)
                if sink is not None:
                    self._attach(sid, sink)
        return s.info()

    def _clear_session_remnants(self, sid: str) -> None:
        from gol_tpu_torch.checkpoint import (
            is_tombstoned,
            session_checkpoint_dir,
            tombstone_path,
        )

        if not is_tombstoned(self.out_dir, sid):
            return
        d = os.path.join(session_checkpoint_dir(self.out_dir), sid)
        try:
            names = os.listdir(d)
        except OSError:
            return
        for name in names:
            if name.endswith(".pgm") or name == "session.json":
                with contextlib.suppress(OSError):
                    os.unlink(os.path.join(d, name))
        # The dead incarnation's RECORDING must not survive either: a
        # replay server pointed at this tree would serve the destroyed
        # board's history under the new session's id.
        from gol_tpu_torch.replay.log import replay_dir, scan_segments

        for _, seg in scan_segments(replay_dir(d)):
            with contextlib.suppress(OSError):
                os.unlink(seg)
        # Tombstone last: a kill mid-clear must leave the predecessor
        # destroyed (tombstone intact), never half-resurrected.
        with contextlib.suppress(OSError):
            os.unlink(tombstone_path(self.out_dir, sid))

    def _write_manifest(self) -> None:
        """Crash-atomic rewrite of out/sessions/manifest.json — the
        authoritative live-session set for `--resume latest`
        (docs/SESSIONS.md "Crash-consistent resume"). Called under the
        manager lock at every create/destroy, so the file always
        records a verb-boundary state, never a torn half-set."""
        from gol_tpu_torch.checkpoint import session_manifest_path

        path = session_manifest_path(self.out_dir)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        sessions = {}
        for s in sorted(self._by_id.values(), key=lambda s: s.id):
            b = s.bucket
            meta = {"width": b.width, "height": b.height,
                    "rule": str(b.rule)}
            if s.seed is not None:
                meta["seed"] = s.seed
                meta["density"] = s.density
            sessions[s.id] = meta
        # Parked sessions are part of the authoritative set: they must
        # survive a restart AS parked (no slot claimed at resume) and
        # still rehydrate on attach (docs/SESSIONS.md "Hibernation").
        for sid, meta in sorted(self._parked.items()):
            sessions[sid] = dict(meta)
        obs.atomic_write_text(path, json.dumps({"sessions": sessions}))

    def _require(self, sid: str) -> Session:
        s = self._by_id.get(sid)
        if s is None:
            # A parked session is NOT unknown — verbs that need a
            # resident board (checkpoint, fetch) answer "parked" so
            # the caller knows an attach would revive it.
            raise SessionError(
                "parked" if sid in self._parked else "unknown-session"
            )
        return s

    def _destroy(self, sid: str, reason: str) -> None:
        if sid not in self._by_id and sid in self._parked:
            # Destroying a hibernated session: no slot to free — drop
            # the record with the same tombstone-first durability
            # (every kill window leaves it destroyed, never
            # resurrected). A shutdown-close leaves parked sessions
            # parked: they must resume.
            if reason == "shutdown":
                return
            del self._parked[sid]
            self._write_tombstone(sid, reason)
            self._write_manifest()
            _METRICS.destroys.inc()
            _METRICS.parked.set(len(self._parked))
            tracing.event("session.destroy", "lifecycle", session=sid,
                          reason=reason, parked=True)
            flight.note("session.destroy", session=sid, reason=reason)
            return
        s = self._require(sid)
        b = s.bucket
        for sink in b.sinks.pop(sid, []):
            with contextlib.suppress(Exception):
                sink.on_close(sid, reason)
        # Tombstone FIRST, manifest second: every kill window between
        # the two leaves the session destroyed on resume (the manifest
        # may still list it; the tombstone overrules). A shutdown-close
        # is not a destroy — those sessions must resume.
        if reason != "shutdown":
            self._write_tombstone(sid, reason)
        b.stack = b.bs.clear_one(b.stack, s.slot)
        del b.sessions[s.slot]
        b.free.append(s.slot)
        del self._by_id[sid]
        if reason != "shutdown":
            self._write_manifest()
        # Bounded-cardinality contract: the per-session children leave
        # the registry WITH the session (pinned by test_sessions),
        # and so does its live usage view (history stays in the ledger).
        obs.evict_entity("session", sid)
        m = accounting.meter()
        if m is not None:
            m.forget(sid)
        _METRICS.destroys.inc()
        _METRICS.active.set(len(self._by_id))
        tracing.event("session.destroy", "lifecycle", session=sid,
                      reason=reason)
        flight.note("session.destroy", session=sid, reason=reason)

    def _write_tombstone(self, sid: str, reason: str) -> None:
        from gol_tpu_torch.checkpoint import tombstone_path

        path = tombstone_path(self.out_dir, sid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # Existence IS the record (a truncated tombstone still
        # counts); the payload is forensics for operators.
        obs.atomic_write_text(
            path, json.dumps({"id": sid, "reason": reason,
                              "ts": time.time()}),
        )

    def _fetch_board(self, sid: str) -> np.ndarray:
        s = self._require(sid)
        return s.bucket.bs.fetch_one(s.bucket.stack, s.slot)

    def _checkpoint(self, sid: str) -> dict:
        from gol_tpu_torch.checkpoint import session_checkpoint_dir
        from gol_tpu_torch.io.pgm import write_pgm

        s = self._require(sid)
        b = s.bucket
        d = os.path.join(session_checkpoint_dir(self.out_dir), sid)
        os.makedirs(d, exist_ok=True)
        turn = s.turn
        path = os.path.join(d, f"{b.width}x{b.height}x{turn}.pgm")
        write_pgm(path, self._fetch_board(sid))
        side = {"id": sid, "width": b.width, "height": b.height,
                "rule": str(b.rule), "turn": turn}
        if self.record_meta is not None:
            side["record"] = dict(self.record_meta)
        obs.atomic_write_text(
            os.path.join(d, "session.json"), json.dumps(side),
        )
        _METRICS.checkpoints.inc()
        tracing.event("session.checkpoint", "lifecycle", session=sid,
                      turn=turn)
        return {"path": path, "turn": turn}

    def _park(self, sid: str) -> dict:
        s = self._by_id.get(sid)
        if s is None:
            raise SessionError(
                "parked" if sid in self._parked else "unknown-session"
            )
        b = s.bucket
        if _watching(b.sinks.get(sid)):
            raise SessionError("watched")
        # Ephemeral sinks (recorders) don't block hibernation — they
        # close with the park (their last segment is already durable;
        # the next attach re-arms a recorder off the rehydrated board).
        for sink in list(b.sinks.get(sid, ())):
            with contextlib.suppress(Exception):
                sink.on_close(sid, "parked")
        b.sinks.pop(sid, None)
        # The checkpoint IS the hibernated state: crash-atomic PGM +
        # sidecar at the current turn, so a kill anywhere past this
        # line rehydrates exactly what was parked.
        saved = self._checkpoint(sid)
        meta = {"width": b.width, "height": b.height,
                "rule": str(b.rule), "parked": True,
                "turn": int(saved["turn"])}
        if s.seed is not None:
            meta["seed"] = s.seed
            meta["density"] = s.density
        # Free the device rows: a slot clear (no new stack
        # in a warm bucket — the create/destroy discipline).
        b.stack = b.bs.clear_one(b.stack, s.slot)
        del b.sessions[s.slot]
        b.free.append(s.slot)
        del self._by_id[sid]
        self._parked[sid] = meta
        # Manifest after the parked record exists in memory: the
        # rewrite commits the parked flag durably (a kill between the
        # checkpoint and this rewrite resumes the session LIVE from
        # its snapshot — bounded conservatism, never loss). The idle
        # sweep defers it to ONE commit per sweep (see _park_idle).
        if not self._deferring_manifest:
            self._write_manifest()
        obs.evict_entity("session", sid)
        m = accounting.meter()
        if m is not None:
            m.forget(sid)
        _METRICS.hibernates.inc()
        _METRICS.parked.set(len(self._parked))
        _METRICS.active.set(len(self._by_id))
        device.observe_memory()
        tracing.event("session.park", "lifecycle", session=sid,
                      turn=meta["turn"])
        flight.note("session.park", session=sid, turn=meta["turn"])
        return {"id": sid, "turn": meta["turn"], "path": saved["path"]}

    def _rehydrate(self, sid: str) -> Session:
        """Parked -> live: read the hibernated snapshot (manifest
        recipe as the torn-disk fallback) and re-create the session in
        its bucket at the recorded turn — bit-exact (PGM snapshots are
        complete state), slot writes only (no new stack in a
        warm bucket). Raises SessionError("max-sessions") when the
        RESIDENT budget is full — rehydration is an admission, and the
        caller's retry hint applies."""
        from gol_tpu_torch.checkpoint import (
            latest_any_snapshot,
            session_checkpoint_dir,
            snapshot_turn,
        )
        from gol_tpu_torch.io.pgm import read_pgm

        meta = self._parked[sid]
        # A parked record may have been resumed from a torn/hostile
        # manifest: every field access must surface as a SessionError
        # (the server's attach path answers those; anything else would
        # kill its accept machinery).
        try:
            w, h = int(meta["width"]), int(meta["height"])
            rule = get_rule(meta.get("rule") or str(self.default_rule))
            seed = meta.get("seed")
            density = float(meta.get("density", 0.25))
            turn = int(meta.get("turn", 0))
        except (KeyError, TypeError, ValueError):
            raise SessionError("unrecoverable") from None
        d = os.path.join(session_checkpoint_dir(self.out_dir), sid)
        board = None
        found = latest_any_snapshot(d)
        if found is not None:
            path, _w, _h = found
            with contextlib.suppress(OSError, ValueError):
                board = read_pgm(path)
                turn = snapshot_turn(path)
        if board is None and seed is not None:
            # Torn snapshot tree: the recipe still rebuilds turn 0
            # deterministically (bounded loss, never resurrection of
            # garbage).
            board = seeded_board(w, h, int(seed), density)
            turn = 0
        if board is None or board.shape != (h, w):
            # (a snapshot of a different geometry than the manifest
            # claims is a torn tree, not a crash-worthy surprise)
            raise SessionError("unrecoverable")
        del self._parked[sid]
        try:
            self._create(sid, w, h, rule, board, turn,
                         seed=seed, density=density)
        except BaseException:
            self._parked[sid] = meta  # stay parked on any failure
            raise
        _METRICS.rehydrates.inc()
        _METRICS.parked.set(len(self._parked))
        tracing.event("session.rehydrate", "lifecycle", session=sid,
                      turn=turn)
        flight.note("session.rehydrate", session=sid, turn=turn)
        return self._by_id[sid]

    def _adopt(self, sid: str, source_dir: str) -> dict:
        """Owner-thread half of `adopt`: load the FOREIGN tree's
        sidecar + snapshot (read-only), create resident, re-checkpoint
        locally. Mirrors `_rehydrate`'s torn-tree discipline — every
        malformed field is a SessionError, never a crash."""
        from gol_tpu_torch.checkpoint import (
            is_tombstoned,
            latest_any_snapshot,
            session_checkpoint_dir,
            snapshot_turn,
        )
        from gol_tpu_torch.io.pgm import read_pgm

        if sid in self._by_id or sid in self._parked:
            raise SessionError("exists")
        if is_tombstoned(source_dir, sid):
            # Destroyed at the source: adopting it would resurrect a
            # session some verb already acked as gone.
            raise SessionError("unknown-session")
        d = os.path.join(session_checkpoint_dir(source_dir), sid)
        try:
            with open(os.path.join(d, "session.json")) as f:
                side = json.load(f)
        except (OSError, ValueError):
            raise SessionError("unknown-session") from None
        try:
            w, h = int(side["width"]), int(side["height"])
            rule = get_rule(side.get("rule") or str(self.default_rule))
            turn = int(side.get("turn", 0))
        except (KeyError, TypeError, ValueError):
            raise SessionError("unrecoverable") from None
        if w <= 0 or h <= 0 or w * h > MAX_SESSION_CELLS:
            raise SessionError("unrecoverable")
        board = None
        found = latest_any_snapshot(d)
        if found is not None:
            path, _w, _h = found
            with contextlib.suppress(OSError, ValueError):
                board = read_pgm(path)
                turn = snapshot_turn(path)
        if board is None or board.shape != (h, w):
            # No complete snapshot (or one of a different geometry
            # than the sidecar claims): nothing bit-exact to adopt.
            raise SessionError("unrecoverable")
        info = self._create(sid, w, h, rule, board, turn)
        # Durability lands HERE before the verb acks: the adopted
        # session must resume from THIS tree even if the source
        # engine's disk disappears the moment the migration commits.
        self._checkpoint(sid)
        _METRICS.adoptions.inc()
        tracing.event("session.adopt", "lifecycle", session=sid,
                      turn=turn, source=source_dir)
        flight.note("session.adopt", session=sid, turn=turn)
        return info

    def _attach(self, sid: str, sink: Sink) -> dict:
        s = self._by_id.get(sid)
        if s is None and sid in self._parked:
            # Attach is the rehydration trigger: a parked session
            # comes back resident, bit-exact, before the sync below.
            s = self._rehydrate(sid)
        elif s is None:
            raise SessionError("unknown-session")
        b = s.bucket
        board = self._fetch_board(sid)
        sink.on_sync(sid, s.turn, board)
        b.sinks.setdefault(sid, []).append(sink)
        if not getattr(sink, "ephemeral", False):
            # Only real watchers stop the idle clock: a recorder-only
            # session still auto-parks (docs/SESSIONS.md).
            s.idle_since = None
        s.watchers_metric.set(len(_watching(b.sinks[sid])))
        tracing.event("session.attach", "lifecycle", session=sid)
        return s.info()

    def _detach(self, sid: str, sink: Sink) -> None:
        s = self._by_id.get(sid)
        if s is None:
            return
        sinks = s.bucket.sinks.get(sid, [])
        with contextlib.suppress(ValueError):
            sinks.remove(sink)
        if not sinks:
            s.bucket.sinks.pop(sid, None)
        if not _watching(sinks) and s.idle_since is None:
            # The idle clock starts when the LAST watcher leaves — the
            # auto-park policy's trigger (ephemeral sinks don't hold
            # the session awake).
            s.idle_since = time.monotonic()
        s.watchers_metric.set(len(_watching(sinks)))
        tracing.event("session.detach", "lifecycle", session=sid)

    def resync(self, sid: str, sink: Sink, prepare=None) -> None:
        """Serve `sink` a FRESH BoardSync on the engine thread,
        between dispatches (the replay plane's live-rejoin: a scrubbed
        peer returns to the present contiguously — `prepare` runs
        first, atomically with the sync, e.g. clearing the scrub
        flag). Raises SessionError for unknown/parked ids."""

        def _do():
            s = self._require(sid)
            if prepare is not None:
                prepare()
            sink.on_sync(sid, s.turn, self._fetch_board(sid))

        self._exec(_do)

    # --- the bucketed dispatch loop (owner thread) ---

    def pump(self, turns: int, chunk: Optional[int] = None) -> None:
        """Inline stepping (no engine thread): advance every occupied
        bucket by exactly `turns` turns in up-to-`chunk`-sized
        dispatches (dispatches may come back cadence-capped — see
        `_dispatch_bucket`)."""

        def _do():
            for b in list(self._buckets.values()):
                if not b.live:
                    continue
                left = turns
                while left > 0:
                    left -= self._dispatch_bucket(
                        b, min(left, chunk or turns)
                    )

        self._exec(_do)

    def _dispatch_bucket(self, b: _Bucket, k: int) -> int:
        """One dispatch of up to `k` turns for one bucket; returns the
        turns actually stepped (the autosave cadence may cap k so a
        kill loses at most one cadence interval — the engine's
        bounded-loss contract, per bucket)."""
        if self.autosave_turns > 0:
            k = max(1, min(
                k, b.last_save_tick + self.autosave_turns - b.ticks
            ))
        t0 = time.perf_counter()
        wall0 = time.time()
        if b.flip_watched():
            with device.cause("bucket-dispatch"):
                path = self._dispatch_diffs(b, k)
        else:
            with device.cause("bucket-dispatch"):
                b.stack, _counts = b.bs.step_n(b.stack, k)
            device.observe_split(enqueue_s=time.perf_counter() - t0)
            path = "fused"
            self._commit(b, k)
            if b.watched():
                # Sinks that declined flip payloads still get their
                # per-turn on_turn callbacks (the singleton engine
                # emits TurnComplete to every synced peer regardless
                # of want_flips — same contract here).
                self._emit(b, k, {})
        dt = time.perf_counter() - t0
        _METRICS.dispatches[path].inc()
        _METRICS.dispatch_seconds[path].observe(dt)
        m = accounting.meter()
        if m is not None and b.sessions:
            # Attribute the ONE shared bucket dispatch to its tenants:
            # activity-weighted when the diff headers produced per-slot
            # changed-word counts, equal turn-weighted on the fused
            # path. Conservation-checked inside (shares sum to dt).
            items = list(b.sessions.items())
            w = b.last_weights if path != "fused" else None
            m.charge_bucket(
                [s.id for _, s in items],
                None if w is None else [w.get(slot, 0.0)
                                        for slot, _ in items],
                seconds=dt,
                flops=m.price_flops(f"bucket.step:{b.key}") * k,
                turns=k, what=b.key,
            )
        tracing.add_span(
            "session.dispatch", "engine", wall0, dt,
            {"bucket": b.key, "path": path, "turns": k,
             "sessions": b.live},
        )
        if (self.autosave_turns > 0
                and b.ticks - b.last_save_tick >= self.autosave_turns):
            b.last_save_tick = b.ticks
            for s in list(b.sessions.values()):
                with contextlib.suppress(OSError):
                    self._checkpoint(s.id)
        return k

    def _dispatch_diffs(self, b: _Bucket, k: int) -> str:
        """One watched dispatch: compact when the adaptive cap is live
        (overflow -> dense redo, never trust a dropped-write buffer),
        plain per-session diff stacks otherwise. Demuxes the decoded
        per-turn rows to each watched session's sinks — the identical
        flip stream the single-board engine would have produced for
        that board (pinned by bit-equality tests)."""
        from gol_tpu_torch.parallel.stepper import (
            compact_decode_rows,
            compact_value_bucket,
        )

        path = "diffs"
        rows_by_slot = None
        if b.compact_cap is not None:
            path = "compact"
            total_cap = k * b.compact_cap
            enq0 = time.perf_counter()
            stack, headers, values, counts = (
                b.bs.step_n_with_diffs_compact(b.stack, k, total_cap)
            )
            enq_s = time.perf_counter() - enq0
            sync0 = time.perf_counter()
            hdr = _host_words(headers)
            totals = hdr[:, :, 0].sum(axis=1)
            if totals.size and int(totals.max()) > total_cap:
                # Activity burst past the shared buffer in at least one
                # session: redo the whole bucket chunk densely from the
                # pre-dispatch stack (bit-identical result).
                b.compact_cap = None
                _METRICS.compact_redos.inc()
                tracing.event("session.compact_redo", "engine",
                              bucket=b.key, total_cap=total_cap)
                flight.note("session.compact_redo", bucket=b.key)
                return self._dispatch_diffs(b, k)
            # One bounded-shape slice fetches every session's used
            # prefix (bucketed, so the per-chunk slice takes a
            # bounded set of shapes — compact_value_bucket).
            n = min(int(values.shape[1]),
                    compact_value_bucket(int(totals.max()) if totals.size
                                         else 0))
            vals = _host_words(values[:, :n])
            sync_s = time.perf_counter() - sync0
            b.stack = stack
            self._commit(b, k)
            host0 = time.perf_counter()
            rows_by_slot = {}
            chunks_by_slot = {}
            weights = {}
            peak = 0
            for slot, s in b.sessions.items():
                hs = hdr[slot]
                peak = max(peak, int(hs[:, 0].max()) if hs.size else 0)
                # Activity weight = this tenant's changed words across
                # the chunk (the accounting plane's split rule).
                weights[slot] = float(hs[:, 0].sum()) if hs.size else 0.0
                sinks = b.sinks.get(s.id)
                if not sinks:
                    continue
                if any(getattr(sk, "batch_turns", 0) for sk in sinks):
                    # Chunk-granular sinks ride the device layout
                    # directly — counts/bitmaps are the header, the
                    # values slice is the used prefix; no dense
                    # scatter for these sessions.
                    counts_s = hs[:, 0].astype(np.int64)
                    chunks_by_slot[slot] = (
                        counts_s, hs[:, 1:],
                        vals[slot][:int(counts_s.sum())],
                    )
                if any(not getattr(sk, "batch_turns", 0)
                       for sk in sinks):
                    rows_by_slot[slot] = list(compact_decode_rows(
                        hs, vals[slot], b.bs.total_words
                    ))
            b.last_weights = weights
            b.adapt_cap(peak)
        else:
            enq0 = time.perf_counter()
            stack, diffs, counts = b.bs.step_n_with_diffs(b.stack, k)
            enq_s = time.perf_counter() - enq0
            sync0 = time.perf_counter()
            host = _host_words(diffs)
            sync_s = time.perf_counter() - sync0
            b.stack = stack
            self._commit(b, k)
            host0 = time.perf_counter()
            rows_by_slot = {}
            chunks_by_slot = {}
            weights = {}
            peak = 0
            for slot, s in b.sessions.items():
                d = host[slot]
                weights[slot] = float(np.count_nonzero(d))
                if b.bs.packed:
                    peak = max(
                        peak,
                        max((int(np.count_nonzero(d[t]))
                             for t in range(k)), default=0),
                    )
                sinks = b.sinks.get(s.id)
                if not sinks:
                    continue
                if b.bs.packed and any(
                        getattr(sk, "batch_turns", 0) for sk in sinks):
                    from gol_tpu_torch.parallel.stepper import (
                        sparse_chunk_from_dense,
                    )

                    chunks_by_slot[slot] = sparse_chunk_from_dense(
                        np.asarray(d).reshape(k, -1)
                    )
                if any(not getattr(sk, "batch_turns", 0)
                       for sk in sinks) or not b.bs.packed:
                    rows_by_slot[slot] = [
                        d[t].reshape(-1) for t in range(k)
                    ]
            b.last_weights = weights
            if b.bs.packed:
                b.adapt_cap(peak)
        self._emit(b, k, rows_by_slot, chunks_by_slot)
        # Device-vs-host split of this bucket dispatch (same boundaries
        # as the singleton engine: enqueue / materialise / decode+emit).
        device.observe_split(enq_s, sync_s,
                             time.perf_counter() - host0)
        return path

    def _commit(self, b: _Bucket, k: int) -> None:
        b.ticks += k
        for s in b.sessions.values():
            s.turns_metric.inc(k)
        flight.note("sessions.commit", bucket=b.key, ticks=b.ticks)
        # BatchStepper dispatches bypass instrument_stepper, so the
        # memory census (rate-limited inside) rides the commit.
        device.observe_memory()

    def _emit(self, b: _Bucket, k: int, rows_by_slot: dict,
              chunks_by_slot: "Optional[dict]" = None) -> None:
        """Fan one dispatched chunk out to the attached sinks, per
        session: chunk-granular sinks get the whole chunk in ONE
        on_flip_chunk call, per-turn sinks keep the legacy
        flips-then-turn loop in turn order."""
        from gol_tpu_torch.ops.bitlife import unpack_np
        from gol_tpu_torch.utils.cell import xy_from_mask

        hw = b.height // 32 if b.bs.packed else None
        for slot, s in list(b.sessions.items()):
            sinks = b.sinks.get(s.id)
            if not sinks:
                continue
            chunk = (chunks_by_slot or {}).get(slot)
            if chunk is not None:
                dead = []
                for sink in [sk for sk in sinks
                             if getattr(sk, "batch_turns", 0)]:
                    try:
                        sink.on_flip_chunk(s.id, s.turn - k + 1, *chunk)
                    except Exception:
                        dead.append(sink)
                for sink in dead:
                    self._detach(s.id, sink)
                sinks = [sk for sk in (b.sinks.get(s.id) or ())
                         if not getattr(sk, "batch_turns", 0)]
                if not sinks:
                    continue
            rows = rows_by_slot.get(slot)
            base = s.turn - k
            for t in range(k):
                turn = base + t + 1
                coords = None
                if rows is not None:
                    row = rows[t]
                    if b.bs.packed:
                        mask = unpack_np(
                            np.asarray(row).reshape(hw, b.width), b.height
                        ) != 0
                    else:
                        mask = np.asarray(row).reshape(b.height, b.width)
                    coords = xy_from_mask(mask)
                dead = []
                for sink in sinks:
                    try:
                        if coords is not None and sink.want_flips \
                                and len(coords):
                            sink.on_flips(s.id, turn, coords)
                        sink.on_turn(s.id, turn)
                    except Exception:
                        dead.append(sink)
                for sink in dead:
                    self._detach(s.id, sink)
                # Re-read survivors, still EXCLUDING chunk-granular
                # sinks when this session's chunk was already handed
                # out above (they must not also get the per-turn loop).
                sinks = [sk for sk in (b.sinks.get(s.id) or ())
                         if chunk is None
                         or not getattr(sk, "batch_turns", 0)]
                if not sinks:
                    break
