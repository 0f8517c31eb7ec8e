"""RecorderSink — a session's wire stream, taped.

One more Sink on the session (gol_tpu_torch.sessions.Sink): chunk-granular
(`batch_turns` > 0), so the manager hands it the same S-sparse device
chunks every batching watcher gets, and it writes the ENCODED FBATCH
frames plus periodic BoardSync keyframes to a SegmentLog — the engine
encodes once per chunk whether anyone is watching live or not, and the
bytes on disk are the bytes a replay server later forwards verbatim
(zero re-encode end to end).

The sink is EPHEMERAL (`ephemeral = True`): it never counts as a
watcher for the hibernation policy — an idle recorded session still
parks (the manager closes the recorder with reason "parked", the log's
last segment stays durable), and the next attach re-creates the
recorder off the rehydrated board (a fresh keyframe at the parked
turn, so the log never records the gap that never stepped).

Callbacks run on the dispatching engine thread; disk appends are
buffered writes + flush (no fsync — the torn-tail discipline of
log.py makes a crash lose at most the tail record)."""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from gol_tpu_torch.distributed import wire
from gol_tpu_torch.obs import tracing
from gol_tpu_torch.replay.log import KEYFRAME_TURNS, SegmentLog
from gol_tpu_torch.sessions.manager import SessionManager, Sink

__all__ = ["RecorderSink"]


class RecorderSink(Sink):
    #: Never a watcher for park/idle policy (see module docstring).
    ephemeral = True
    want_flips = True

    def __init__(self, manager: SessionManager, sid: str,
                 width: int, height: int, log: SegmentLog,
                 on_closed: Optional[Callable[[str, str], None]] = None):
        self._manager = manager
        self.sid = sid
        self._width = width
        self._height = height
        self.log = log
        self._on_closed = on_closed
        #: Chunk-granular at the keyframe cadence: every recorded
        #: frame covers at most one keyframe interval, which is what
        #: bounds how far past a requested turn a seek can land.
        self.batch_turns = log.keyframe_turns

    # --- Sink protocol (engine thread) ---

    def on_sync(self, sid: str, turn: int, board) -> None:
        """Attach/resync raster -> a keyframe starting a new segment
        (also the crash-restart cut point: stale future segments are
        dropped by start_segment)."""
        self.log.start_segment(
            turn, wire.board_to_frame(turn, board, 0), time.time()
        )
        tracing.event("replay.keyframe", "wire", session=sid, turn=turn)

    def on_flip_chunk(self, sid: str, first_turn: int, counts,
                      bitmaps, words) -> None:
        from gol_tpu_torch.distributed.server import encode_batch_frames

        k = len(counts)
        frames = encode_batch_frames(
            counts, bitmaps, words, first_turn,
            self._width, self._height, self.batch_turns, time.time(),
        )
        ts = time.time()
        for f in frames:
            span = (first_turn, first_turn + k - 1)
            self.log.append(f, ts, span[1])
        self._maybe_keyframe(first_turn + k - 1)

    def on_flips(self, sid: str, turn: int, coords) -> None:
        """Per-turn fallback (a non-packed bucket, or a mixed bucket
        whose dispatch ran the per-turn demux): one single-turn FBATCH
        frame — the same on-disk grammar either way."""
        bitmap, wordvals = wire.coords_to_words(
            coords, self._width, self._height
        )
        _, nb = wire.grid_words(self._width, self._height)
        frame = wire.flip_batch_to_frame(
            turn, nb, np.asarray([len(wordvals)], np.uint32),
            bitmap.reshape(1, -1), wordvals, time.time(),
        )
        self.log.append(frame, time.time(), turn)

    def on_turn(self, sid: str, turn: int) -> None:
        # Per-turn fallback path: callbacks for a whole chunk run
        # AFTER the chunk committed, so _fetch_board always returns
        # the POST-chunk board — cutting a keyframe mid-chunk would
        # stamp that board with an earlier turn and every frame after
        # it would double-apply on replay. Only the chunk's final
        # turn (== the session's committed turn) may cut one.
        if turn == self._manager.peek_turn(self.sid):
            self._maybe_keyframe(turn)

    def _maybe_keyframe(self, turn: int) -> None:
        if not self.log.due_keyframe(turn):
            return
        # Engine thread owns the device (the _SessionSink drain-resync
        # precedent): fetch the post-chunk board directly.
        board = self._manager._fetch_board(self.sid)
        self.log.start_segment(
            turn, wire.board_to_frame(turn, board, 0), time.time()
        )
        tracing.event("replay.keyframe", "wire", session=self.sid,
                      turn=turn)

    def on_close(self, sid: str, reason: str) -> None:
        self.log.close()
        if self._on_closed is not None:
            self._on_closed(sid, reason)
