"""gol_tpu_torch.replay — the replay plane (docs/REPLAY.md).

Every session a seekable recording; recorded runs served at zero
engine dispatches:

- `log` — the append-only segment log (verbatim FBATCH + BoardSync
  keyframe payloads, keyframe-indexed by filename, torn-tail
  tolerant, size-bounded) and its decode helpers (`seek_frames`,
  `board_at`).
- `recorder` — `RecorderSink`, the ephemeral session sink that tapes
  a live session (`--serve --sessions --record`).
- `server` — `ReplayServer` (`--replay DIR`), the static broadcast
  tier serving recordings to N observers with zero engine dispatches,
  composing under the relay tree; `serve_seek`, the one seek
  implementation both serving planes share.

`ReplayServer` is imported lazily: the log/decoder half stays light
(numpy + wire only) for `obs.report merge --replay-to`.
"""

from gol_tpu_torch.replay.log import (
    KEYFRAME_TURNS,
    SegmentLog,
    board_at,
    find_recordings,
    last_turn,
    replay_dir,
    scan_segments,
    seek_frames,
)

__all__ = [
    "KEYFRAME_TURNS",
    "RecorderSink",
    "ReplayServer",
    "SegmentLog",
    "board_at",
    "find_recordings",
    "last_turn",
    "replay_dir",
    "scan_segments",
    "seek_frames",
    "serve_seek",
]


def __getattr__(name):
    if name == "ReplayServer" or name == "serve_seek":
        from gol_tpu_torch.replay import server

        return getattr(server, name)
    if name == "RecorderSink":
        from gol_tpu_torch.replay.recorder import RecorderSink

        return RecorderSink
    raise AttributeError(name)
