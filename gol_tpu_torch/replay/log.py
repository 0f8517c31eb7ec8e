"""Segment log — a session's wire stream as seekable bytes on disk.

The wire already emits the perfect log format: `_TAG_FBATCH` frames
are SELF-CONTAINED (the turn-axis delta chain never crosses a frame —
wire.py's invariant) and BoardSync rasters are complete state, so a
recording is just the encoded frame payloads written VERBATIM — the
relay's zero-re-encode invariant extended to disk. Serving a recording
is a byte-copy problem (gol_tpu_torch.replay.server); decoding one is the
ordinary client apply path (`board_at` below reproduces it host-side
for time-travel debugging).

Layout (one directory per recording, `<session-dir>/replay/`):

    seg-<turn:016d>.glog        one SEGMENT per keyframe interval

A segment starts with its keyframe — a `_TAG_BOARD` payload at the
turn in the filename — followed by the FBATCH payloads for the turns
after it. Records are length-prefixed and wall-clock stamped:

    <u32 payload_len> <f64 wall_ts> <payload bytes>

The filename IS the keyframe index: "nearest keyframe <= T" is a
directory listing, no sidecar index to corrupt. Crash consistency is
by construction: records are appended and flushed in order, so a
SIGKILL leaves at most a torn TAIL record, which `read_records`
detects by length and discards — serving continues from the last good
frame (the wire-fuzz suite pins this). The log is size-bounded:
oldest segments are evicted once `max_bytes` is exceeded (the current
segment is never evicted), so a viral board's history is a ring, not
a disk leak.
"""

from __future__ import annotations

import contextlib
import os
import re
import struct
from typing import Iterator, Optional

import numpy as np

from gol_tpu_torch import obs
from gol_tpu_torch.distributed import wire

__all__ = [
    "SegmentLog",
    "apply_fbatch_slice",
    "board_at",
    "fbatch_span",
    "find_recordings",
    "last_turn",
    "read_records",
    "replay_dir",
    "scan_segments",
    "seek_frames",
]

#: Record header: payload length, emit wall clock. The payload is a
#: raw wire frame payload (no 4-byte wire length prefix — that is
#: transport framing, re-applied at serve time by `_Conn.send_raw`).
_REC = struct.Struct("<Id")

_SEG = re.compile(r"^seg-(\d{16})\.glog$")

#: Default keyframe cadence in turns — the seek granularity AND the
#: catch-up cost of a cold attach (one raster + up to this many turns
#: of deltas).
KEYFRAME_TURNS = 256


class _LogMetrics:
    """Writer-side counters (issue catalog: docs/REPLAY.md)."""

    def __init__(self):
        self.segments = obs.counter(
            "gol_tpu_replay_segments_written",
            "Replay-log segments started (one per keyframe)",
        )
        self.bytes = obs.counter(
            "gol_tpu_replay_bytes_written",
            "Replay-log bytes appended (records incl. headers)",
        )
        self.evicted = obs.counter(
            "gol_tpu_replay_segments_evicted_total",
            "Oldest segments evicted by the max-bytes bound",
        )
        self.keyframe_turns = obs.gauge(
            "gol_tpu_replay_keyframe_turns",
            "Configured keyframe cadence of this process's recorders "
            "(turns between BoardSync keyframes = seek granularity)",
        )


_METRICS = _LogMetrics()


def replay_dir(session_dir: str | os.PathLike) -> str:
    """Where a session's recording lives: `<session-dir>/replay/` —
    alongside the session checkpoints, inside the same crash-consistency
    story (tombstone-gated remnant clearing covers it)."""
    return os.path.join(os.fspath(session_dir), "replay")


class SegmentLog:
    """Append-only writer for one recording. NOT thread-safe — the
    recorder calls it from the one dispatching (engine) thread, the
    same single-writer discipline every device structure rides."""

    def __init__(self, root: str | os.PathLike,
                 keyframe_turns: int = KEYFRAME_TURNS,
                 max_bytes: Optional[int] = None):
        self.root = os.fspath(root)
        self.keyframe_turns = max(1, int(keyframe_turns))
        self.max_bytes = max_bytes
        _METRICS.keyframe_turns.set(self.keyframe_turns)
        self._f = None
        self._seg_start = -1
        #: Last turn any appended frame covered (the keyframe's turn
        #: until frames arrive).
        self.last_turn = -1
        self._total_bytes = 0
        with contextlib.suppress(OSError):
            self._total_bytes = sum(
                os.path.getsize(p) for _, p in scan_segments(self.root)
            )

    # --- writing ---

    def _write_record(self, payload: bytes, ts: float) -> None:
        rec = _REC.pack(len(payload), ts) + payload
        self._f.write(rec)
        # Flush per record: a concurrent seek reads the file the
        # recorder is appending, and must see whole records (a torn
        # OS-level tail is discarded by the reader either way).
        self._f.flush()
        self._total_bytes += len(rec)
        _METRICS.bytes.inc(len(rec))

    def start_segment(self, turn: int, payload: bytes,
                      ts: float) -> None:
        """Begin a new segment with its keyframe (a `_TAG_BOARD`
        payload at `turn`). Any existing segment at or past this turn
        is DROPPED first: a crash-restarted engine resumes from its
        checkpoint, and frames the dead incarnation recorded beyond
        that turn describe a future that never happened."""
        self.close_segment()
        os.makedirs(self.root, exist_ok=True)
        for seg_turn, path in scan_segments(self.root):
            if seg_turn >= turn:
                with contextlib.suppress(OSError):
                    self._total_bytes -= os.path.getsize(path)
                with contextlib.suppress(OSError):
                    os.unlink(path)
        self._total_bytes = max(0, self._total_bytes)
        path = os.path.join(self.root, f"seg-{turn:016d}.glog")
        self._f = open(path, "wb")
        self._seg_start = turn
        self.last_turn = turn
        self._write_record(payload, ts)
        _METRICS.segments.inc()
        self._evict()

    def append(self, payload: bytes, ts: float, last_turn: int) -> None:
        """Append one stream frame (FBATCH) covering turns up to
        `last_turn`. Frames before the first keyframe are dropped —
        without a raster beneath them they are undecodable."""
        if self._f is None:
            return
        self._write_record(payload, ts)
        self.last_turn = max(self.last_turn, int(last_turn))

    def due_keyframe(self, turn: int) -> bool:
        return (self._seg_start < 0
                or turn - self._seg_start >= self.keyframe_turns)

    def _evict(self) -> None:
        if self.max_bytes is None:
            return
        while self._total_bytes > self.max_bytes:
            segs = scan_segments(self.root)
            if len(segs) <= 1:
                return  # never evict the current (only) segment
            _, oldest = segs[0]
            try:
                size = os.path.getsize(oldest)
                os.unlink(oldest)
            except OSError:
                return
            self._total_bytes -= size
            _METRICS.evicted.inc()

    def close_segment(self) -> None:
        if self._f is not None:
            with contextlib.suppress(OSError):
                self._f.close()
            self._f = None

    def close(self) -> None:
        self.close_segment()


# --- reading (tolerant: every path here runs on freshly crashed trees) ---


def scan_segments(root: str | os.PathLike) -> "list[tuple[int, str]]":
    """Sorted [(keyframe_turn, path)] of a recording directory; an
    unreadable/missing directory is an empty recording, never an
    exception."""
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    out = []
    for name in names:
        m = _SEG.match(name)
        if m:
            out.append((int(m.group(1)),
                        os.path.join(os.fspath(root), name)))
    out.sort()
    return out


def read_records(path: str) -> "list[tuple[float, bytes]]":
    """Every whole record of one segment, in order. A torn tail — a
    header or payload cut short by a crash, or a header claiming an
    implausible length — ends the list silently: everything before the
    tear is intact (records are appended and flushed in order), and
    serving continues from the last good frame."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return []
    out = []
    off = 0
    while off + _REC.size <= len(blob):
        n, ts = _REC.unpack_from(blob, off)
        if n > wire.MAX_FRAME or off + _REC.size + n > len(blob):
            break  # torn or hostile tail: discard from here
        out.append((ts, blob[off + _REC.size:off + _REC.size + n]))
        off += _REC.size + n
    return out


def iter_records(root: str | os.PathLike
                 ) -> Iterator[tuple[float, bytes]]:
    for _, path in scan_segments(root):
        yield from read_records(path)


def fbatch_span(payload: bytes) -> "Optional[tuple[int, int]]":
    """(first_turn, last_turn) of an FBATCH payload, or None for any
    other (or malformed) record — header-only, no blob decode."""
    if not payload or payload[0] != wire._TAG_FBATCH \
            or len(payload) < wire._FBATCH_HDR.size:
        return None
    try:
        _, first, k, _, _, _, _, _ = wire._FBATCH_HDR.unpack_from(payload)
    except struct.error:
        return None
    if not 0 < k <= wire.FBATCH_MAX_TURNS:
        return None
    return int(first), int(first) + int(k) - 1


def _is_board(payload: bytes) -> bool:
    return bool(payload) and payload[0] == wire._TAG_BOARD


def seek_frames(root: str | os.PathLike, turn: int
                ) -> "Optional[tuple[int, int, list[bytes]]]":
    """The seek answer for turn T: `(keyframe_turn, landed_turn,
    payloads)` where payloads[0] is the nearest <= T keyframe's board
    payload and the rest are the FBATCH suffix through the frame
    containing T (a straddling frame is included whole — frames are
    indivisible on the wire, so the landing turn may exceed T by less
    than one frame). T before the first keyframe answers from the
    first keyframe (evicted history is gone); T past the end lands at
    the recording's end. None = no usable recording."""
    segs = scan_segments(root)
    best = None
    for i, (seg_turn, path) in enumerate(segs):
        if seg_turn <= turn or best is None:
            best = i
    if best is None:
        return None
    seg_turn, path = segs[best]
    records = read_records(path)
    if not records or not _is_board(records[0][1]):
        # Torn keyframe: walk back to the newest earlier segment
        # whose keyframe still decodes (one step is not enough on a
        # doubly-corrupted tree — serve whatever good history exists).
        for i in range(best - 1, -1, -1):
            got = seek_frames_at(segs[i])
            if got is not None:
                return got
        return None
    payloads = [records[0][1]]
    landed = seg_turn
    for _, payload in records[1:]:
        span = fbatch_span(payload)
        if span is None:
            continue
        first, last = span
        if first > turn:
            break
        payloads.append(payload)
        landed = max(landed, last)
    return seg_turn, landed, payloads


def seek_frames_at(seg: "tuple[int, str]"
                   ) -> "Optional[tuple[int, int, list[bytes]]]":
    """One whole segment as a seek answer (keyframe + every frame) —
    the torn-keyframe fallback and the catch-up primitive."""
    seg_turn, path = seg
    records = read_records(path)
    if not records or not _is_board(records[0][1]):
        return None
    payloads = [r[1] for r in records
                if _is_board(r[1]) or fbatch_span(r[1]) is not None]
    landed = seg_turn
    for p in payloads[1:]:
        span = fbatch_span(p)
        if span is not None:
            landed = max(landed, span[1])
    return seg_turn, landed, payloads


def last_turn(root: str | os.PathLike) -> int:
    """Last decodable turn of a recording (-1 when empty)."""
    segs = scan_segments(root)
    for seg in reversed(segs):
        got = seek_frames_at(seg)
        if got is not None:
            return got[1]
    return -1


def apply_fbatch_slice(board: np.ndarray, msg: dict,
                       upto_turn: int) -> int:
    """Advance a raster by ONE parsed FBATCH frame, applying only
    turns <= `upto_turn` — the partial-frame twin of the client's
    `apply_fbatch_raster` (same odd-repetition XOR math, upper-bounded
    instead of floor-gated), so `board_at` can land EXACTLY on a turn
    inside a frame. Returns the last turn applied (first_turn - 1 when
    the whole frame is past the bound)."""
    h, w = board.shape
    total, nb = wire.grid_words(w, h)
    if msg["nb"] != nb:
        raise wire.WireError(
            f"batch bitmap rows of {msg['nb']} words, this board "
            f"needs {nb}"
        )
    counts = msg["counts"].astype(np.int64)
    k, first = int(msg["k"]), int(msg["first_turn"])
    klim = min(k, upto_turn - first + 1)
    if klim <= 0:
        return first - 1
    dbm, dwords = msg["dbitmaps"], msg["dwords"]
    nzt = np.flatnonzero(counts)
    offs = np.zeros(len(nzt) + 1, np.int64)
    np.cumsum(counts[nzt], out=offs[1:])
    # Net change over turns [0, klim): D[j] appears (klim - j) times
    # in XOR_{t<klim} S[t]; odd repetition counts survive.
    reps = klim - nzt
    sel = np.flatnonzero((reps > 0) & (reps % 2 == 1))
    if sel.size:
        acc = np.zeros(total, np.uint32)
        for i in sel:
            idx = wire._bitmap_indices(dbm[i])
            acc[idx] ^= dwords[offs[i]:offs[i + 1]]
        fw = np.flatnonzero(acc)
        if fw.size:
            bits = (acc[fw, None] >> np.arange(32, dtype=np.uint32)) & 1
            rr, bb = np.nonzero(bits)
            x = fw[rr] % w
            y = (fw[rr] // w) * 32 + bb
            if y.size and int(y.max()) >= h:
                raise wire.WireError("batch mask bit past the board height")
            board[y, x] ^= np.uint8(255)
    return first + klim - 1


def board_at(root: str | os.PathLike, turn: int
             ) -> "Optional[tuple[int, np.ndarray]]":
    """(landed_turn, (H, W) uint8 board) of the recording at the
    nearest recorded state <= `turn` + any partial frame needed to
    land exactly — the time-travel primitive `obs.report merge
    --replay-to` joins with the flight recorder. None when the
    recording has no usable keyframe."""
    got = seek_frames(root, turn)
    if got is None:
        return None
    _, _, payloads = got
    msg = wire.parse_payload(payloads[0])
    landed, board = wire.msg_to_board(msg)
    board = np.array(board, dtype=np.uint8)
    for payload in payloads[1:]:
        fmsg = wire.parse_payload(payload)
        if fmsg.get("t") != "fbatch":
            continue
        landed = max(landed, apply_fbatch_slice(board, fmsg, turn))
    return int(landed), board


def find_recordings(path: str | os.PathLike) -> "dict[str, str]":
    """{recording_id: replay_dir} under `path` — accepts a sessions
    root (`out/sessions`, each `<sid>/replay/`), a single session
    directory, or a bare replay directory of seg files. The flexible
    spelling is what `--replay DIR` takes."""
    path = os.fspath(path)
    if scan_segments(path):
        return {os.path.basename(os.path.dirname(path.rstrip("/")))
                or "recording": path}
    d = replay_dir(path)
    if scan_segments(d):
        return {os.path.basename(path.rstrip("/")) or "recording": d}
    out = {}
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return out
    for name in names:
        d = replay_dir(os.path.join(path, name))
        if scan_segments(d):
            out[name] = d
    return out
