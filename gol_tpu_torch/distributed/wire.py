"""Wire protocol for the controller ⇄ engine link — the port's copy of
`gol_tpu.distributed.wire`, byte for byte the same frames.

The reference intended `net/rpc` over TCP between controller, broker and
engine workers but shipped only dead stubs (ref: gol/distributor.go:44-52,
459-530; topology spec ref: README.md:201-207). This is the working
equivalent: length-prefixed JSON messages over a stream socket — a
control plane carrying events, keys and board syncs. (The *data plane* —
halo exchange, alive-count reductions — never touches this layer: it
stays on the device, inside the step.)

Framing: 4-byte big-endian payload length, then either a UTF-8 JSON
object (control plane: hello, keys, events, acks — every message has a
"t" discriminator) or a BINARY frame whose first byte is a tag < 0x20
(bulk plane: flips, board rasters, final alive sets — raw header +
zlib payload, no base64). JSON payloads always start with '{' (0x7b),
so the tag byte is also the discriminator: receivers decode either
kind without negotiation. SENDING binary is negotiated — a peer
advertises `"binary": true` in its hello, legacy peers keep getting
base64-inside-JSON. The base64 layer is a ~33% byte inflation on a
path that is link-bound.

Message catalog:
  controller → engine:
    {"t":"hello","want_flips":bool[,"secret":s][,"compact":bool]
                 [,"binary":bool][,"batch":K][,"session":id]
                 [,"sessions":true]}
        attach + subscription (the secret authenticates when the server
        was started with one — the reference's :8030 listener was open
        to any peer, ref: gol/distributor.go:49-52; that is a flaw to
        beat. "compact" advertises the zlib'd flips encoding; "binary"
        the raw tag+header+zlib frames; servers send legacy JSON to
        peers that advertise neither. "session" targets a NAMED session
        on a multi-tenant `--serve --sessions` server — unknown ids are
        rejected with {"t":"error","reason":"unknown-session"}; a hello
        with neither "session" nor a singleton board behind it is a
        CONTROL peer that only speaks the session verbs below.)
    {"t":"key","key":"p|s|q|k"}       keyboard verb (ref: sdl/loop.go:18-27)
  session verbs (gol_tpu.sessions; either direction is JSON-only —
  docs/SESSIONS.md):
    {"t":"session","op":"create","id":s,"width":W,"height":H
                   [,"rule":r][,"seed":n][,"density":f]}
    {"t":"session","op":"destroy"|"checkpoint","id":s}
    {"t":"session","op":"list"}
        any authenticated peer may manage sessions; every request is
        answered in-stream by
    {"t":"session-r","op":...,"ok":bool[,"reason":s][,"session":{...}]
                     [,"sessions":[...]][,"path":p][,"turn":N]}
        failure reasons are single tokens ("exists", "unknown-session",
        "bad-dimensions", "bad-rule", "bad-request", ...) — the fuzz
        suite pins that a malformed verb gets a reasoned rejection,
        never a dead reader thread.
  engine → controller:
    {"t":"board","turn":N,"width":W,"height":H,"data":b64}  attach sync
    {"t":"flips","turn":N,"cells_z":b64}                    per-turn diff
        (zlib'd int32 x,y pairs — the board-raster treatment; plain
        JSON "cells":[[x,y],...] is still DECODED for back-compat)
    delta-of-sparse flips (binary tag 6, negotiated via hello "delta"):
        per-turn CHANGED-WORD frame instead of cell coords — the
        changed-word bitmap XORed against the previous sent turn's
        bitmap (settled boards revisit the same active words, so the
        delta zlibs to near nothing) plus the changed words' XOR masks
        themselves, both zlib-bounded. The chain resets at every
        BoardSync on both ends; turns with no flips send no frame and
        do not advance the chain. Productized
        behind the byte measurement in BENCH_DETAIL `wire_delta_sparse`.
    k-turn flip batches (binary tag 7, negotiated via hello "batch":
    max-k; requires "binary"):
        ONE frame carries up to max-k turns of changed-word XOR masks,
        delta-compressed along the TURN axis: turn i's changed-word set
        rides as D[i] = S[i] XOR S[i-1] (D[0] = S[0] raw), so a settled
        board — where consecutive turns flip the same cells — collapses
        to one turn's payload per batch. Frames are SELF-CONTAINED (the
        first turn always ships raw), which is how the delta chain
        "resets" at BoardSync: no encoder/decoder state ever crosses a
        frame, so a resync can never decode against a stale chain (the
        property _TAG_DFLIPS maintains by explicit per-peer resets).
        The header stamps the batch's emit wall clock once — turn
        latency is measured emit-of-batch → apply-of-batch
        (gol_tpu_client_batch_latency_seconds, NOT the per-turn
        histogram: docs/OBSERVABILITY.md "Batch latency semantics").
        This frame is the watched-path throughput fix:
        per-turn frames cap a watched 512² session at ~300 turns/s;
        batch frames lift it past 100k (BENCH_DETAIL
        `wire_watched_512x512_batch`).
    {"t":"ev", ...}                   one serialized Event (below)
    {"t":"detached"}                  'q' acknowledged; engine lives on
    {"t":"bye"}                       stream over (final turn or 'k')
  either direction (liveness — docs/RESILIENCE.md):
    {"t":"hb","turn":N}               server heartbeat, sent when a
        peer's stream has been idle past the heartbeat interval (binary
        peers get the raw-tag form); the client answers with a JSON
        {"t":"hb"} pong, which is what refreshes the server's
        idle-eviction clock. Peers that predate the frame ignore it
        (unknown kinds are ignorable on both sides).
  clock probe (docs/OBSERVABILITY.md — negotiated via the attach-ack's
  "clock" key; legacy peers on either side just never exchange these):
    {"t":"clk","t0":T}                controller ping carrying its wall
        clock; the server echoes {"t":"clk","t0":T,"ts":S} immediately
        and QUEUE-FREE with its own wall clock, giving the client an
        NTP-style offset sample bounded by RTT/2 — the min-RTT sample
        becomes gol_tpu_client_clock_offset_seconds and corrects the
        turn-latency math and merged timelines.
"""

from __future__ import annotations

import base64
import json
import math
import socket
import struct
import zlib
from typing import Optional

import numpy as np

from gol_tpu_torch.events import (
    AliveCellsCount,
    CellFlipped,
    Event,
    FinalTurnComplete,
    ImageOutputComplete,
    State,
    StateChange,
    TurnComplete,
)
from gol_tpu_torch.obs import tracing
from gol_tpu_torch.utils.cell import Cell

MAX_FRAME = 64 << 20
#: Decompressed-payload ceiling. The frame cap bounds *compressed*
#: size only; a hostile or buggy peer could otherwise make a receiver
#: allocate multi-GB buffers from a 64 MiB zlib bomb. 512
#: MiB covers every legitimate payload (an 8192² raster is 64 MiB raw;
#: a full-board flip of int32 pairs on the same board is 512 MiB) —
#: callers that know the exact expected size pass a tighter limit.
MAX_RAW = 512 << 20
_LEN = struct.Struct(">I")


class WireError(ConnectionError):
    pass


def _decompress(data: bytes, limit: Optional[int] = None) -> bytes:
    """zlib-decompress with a hard output bound (never trusts the
    peer's sizes — see MAX_RAW, read at call time so the ceiling is
    one live module attribute, not a def-time snapshot)."""
    if limit is None:
        limit = MAX_RAW
    d = zlib.decompressobj()
    out = d.decompress(data, limit)
    if d.unconsumed_tail:
        raise WireError(f"decompressed payload exceeds {limit} bytes")
    if not d.eof:
        # zlib.decompress would raise on an incomplete stream; the
        # incremental object just stops — surface truncation/corruption
        # instead of returning a silently partial payload.
        raise WireError("truncated zlib stream")
    return out


def frame_bytes(payload: bytes) -> bytes:
    """Length-prefix one raw payload — the on-wire form of a frame.
    The writer pool queues these (already framed, so a pool thread
    never touches the encoding layer); `send_frame` is the blocking
    twin for direct sends."""
    if len(payload) > MAX_FRAME:
        raise WireError(f"frame too large: {len(payload)} bytes")
    return _LEN.pack(len(payload)) + payload


def send_frame(sock: socket.socket, payload: bytes) -> None:
    """Length-prefix and send one raw payload (binary frame or encoded
    JSON) — the single sender both planes share."""
    sock.sendall(frame_bytes(payload))
    # One instant mark per frame at THE send chokepoint both planes
    # share — the wire hop of the session timeline (gol_tpu_torch.obs.tracing;
    # a no-op flag read when the plane is off).
    tracing.event("wire.send", "wire", bytes=len(payload))


def send_msg(sock: socket.socket, msg: dict) -> None:
    send_frame(sock, json.dumps(msg, separators=(",", ":")).encode())


def recv_msg(sock: socket.socket,
             allow_binary: bool = True) -> Optional[dict]:
    """Next message, or None on clean EOF at a frame boundary. Binary
    frames decode to the same dict shapes the JSON forms produce, with
    payloads already parsed (see _parse_frame) — consumers dispatch on
    "t" either way. Every malformed payload raises WireError (JSON
    included: a JSONDecodeError escaping here would kill reader
    threads whose handlers expect WireError/OSError only).

    `allow_binary=False` rejects bulk frames WITHOUT parsing them —
    the engine server's receive side (hellos, key verbs) is
    JSON-only, and refusing early means an unauthenticated peer can
    never make the server inflate a zlib payload (the bulk decoders
    allocate up to MAX_RAW on legitimate frames).

    Sockets carrying a read deadline (settimeout — the liveness
    discipline of docs/RESILIENCE.md) surface an *idle* expiry — zero
    bytes of the next frame read — as TimeoutError for the caller's
    heartbeat logic to judge; a deadline that expires MID-frame is a
    broken peer, not idleness, and raises WireError (resuming a
    half-read frame is impossible — the stream position is lost)."""
    payload = recv_frame(sock)
    if payload is None:
        return None
    msg = parse_payload(payload, allow_binary=allow_binary)
    # The receive-side twin of send_frame's mark: frame size + decoded
    # kind, so a merged timeline shows each hop's traffic inline.
    tracing.event("wire.recv", "wire", bytes=len(payload), t=msg.get("t"))
    return msg


def recv_frame(sock: socket.socket) -> Optional[bytes]:
    """Next RAW frame payload (length prefix stripped, nothing
    parsed), or None on clean EOF at a frame boundary — the relay
    tier's read primitive: a relay forwards these bytes verbatim
    downstream (zero re-encode) and parses its own copy separately.
    Deadline semantics are exactly recv_msg's (idle expiry →
    TimeoutError, mid-frame → WireError)."""
    header = _recv_exact(sock, _LEN.size, allow_eof=True)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise WireError(f"frame too large: {n} bytes")
    try:
        return _recv_exact(sock, n, allow_eof=False)
    except TimeoutError:
        raise WireError(
            "receive deadline expired mid-frame (header without payload)"
        ) from None


def parse_payload(payload: bytes, allow_binary: bool = True) -> dict:
    """One raw frame payload -> the message dict (JSON or parsed
    binary frame) — recv_msg's decode half, shared with consumers
    that keep the raw bytes (the relay)."""
    if payload[:1] == b"{":
        try:
            return json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise WireError(f"malformed JSON frame: {e}") from None
    if not allow_binary:
        raise WireError("unexpected binary frame on a control-only link")
    return _parse_frame(payload)


def _recv_exact(sock: socket.socket, n: int, allow_eof: bool) -> Optional[bytes]:
    """THE raw-socket read primitive of the wire plane (the
    blocking-io-timeout analysis check pins that: every other read in
    gol_tpu/distributed goes through recv_msg, whose sockets carry a
    deadline). A read deadline expiring with zero bytes buffered is
    clean idleness and propagates as TimeoutError; expiring mid-frame
    means the stream position is lost and raises WireError."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except TimeoutError:
            if not buf:
                raise
            raise WireError("receive deadline expired mid-frame") from None
        if not chunk:
            if allow_eof and not buf:
                return None
            raise WireError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


# --- binary frames (negotiated via hello "binary") ---

#: Frame tags (first payload byte). JSON payloads start with '{'
#: (0x7b), so any tag < 0x20 is unambiguous.
_TAG_FLIPS, _TAG_BOARD, _TAG_FINAL, _TAG_LFLIPS, _TAG_HB = 1, 2, 3, 4, 5
_TAG_DFLIPS = 6
_TAG_FBATCH = 7
_TAG_MSAMPLES = 8
_FLIPS_HDR = struct.Struct("<BQ")       # tag, turn
_BOARD_HDR = struct.Struct("<BQIIQ")    # tag, turn, width, height, token
_FINAL_HDR = struct.Struct("<BQ")       # tag, turn
_LFLIPS_HDR = struct.Struct("<BQI")     # tag, turn, coords-blob bytes
_HB_HDR = struct.Struct("<BQ")          # tag, turn (liveness beacon)
_DFLIPS_HDR = struct.Struct("<BQII")    # tag, turn, changed words, bitmap-blob bytes
#: tag, first turn, k (turns), nb (bitmap words/turn), emit ts, then
#: the three blob lengths: per-turn delta counts, delta bitmaps (one
#: row per nonzero-count turn), delta word masks (Σcounts values).
_FBATCH_HDR = struct.Struct("<BQIIdIII")
#: Turns one batch frame may claim — far above any negotiable max-k
#: (the engine's diff-chunk budget caps real batches in the hundreds
#: to low thousands); a header claiming more is an attack, not a peer.
FBATCH_MAX_TURNS = 1 << 16


def _coords_to_frame(hdr: struct.Struct, tag: int, turn: int,
                     cells) -> bytes:
    """The one coordinate-list encoding (header + zlib'd int32 x,y
    pairs) behind both the flips and final frames — the encode twin of
    `_coords_from`."""
    coords = np.ascontiguousarray(np.asarray(cells, np.int32).reshape(-1, 2))
    return hdr.pack(tag, turn) + zlib.compress(coords.tobytes(), 1)


def flips_to_frame(turn: int, cells) -> bytes:
    """One turn's flip batch as a raw binary frame — the compact JSON
    form minus its ~33% base64 inflation on a link-bound path."""
    return _coords_to_frame(_FLIPS_HDR, _TAG_FLIPS, turn, cells)


def board_to_frame(turn: int, world: np.ndarray, token: int = 0) -> bytes:
    h, w = world.shape
    raw = zlib.compress(np.ascontiguousarray(world, np.uint8).tobytes(), 1)
    return _BOARD_HDR.pack(_TAG_BOARD, turn, w, h, token) + raw


def final_to_frame(turn: int, alive) -> bytes:
    return _coords_to_frame(_FINAL_HDR, _TAG_FINAL, turn, alive)


def level_flips_to_frame(turn: int, cells, levels) -> bytes:
    """A multi-state turn's flips WITH their new gray levels (Generations
    visualisation): coords blob + levels blob, both zlib'd."""
    coords = np.ascontiguousarray(np.asarray(cells, np.int32).reshape(-1, 2))
    lv = np.ascontiguousarray(np.asarray(levels, np.uint8).reshape(-1))
    if len(lv) != len(coords):
        raise ValueError(f"{len(coords)} cells vs {len(lv)} levels")
    cz = zlib.compress(coords.tobytes(), 1)
    return (_LFLIPS_HDR.pack(_TAG_LFLIPS, turn, len(cz))
            + cz + zlib.compress(lv.tobytes(), 1))


def grid_words(width: int, height: int) -> tuple[int, int]:
    """(total packed words, bitmap words) of the wire-level changed-word
    grid for a WxH board: 32 vertically-adjacent cells per word, words
    numbered (y//32)*width + x — a wire-layer convention shared by both
    endpoints, independent of how (or whether) the device packs."""
    total = -(-height // 32) * width
    return total, -(-total // 32)


def coords_to_words(cells, width: int, height: int):
    """One turn's flip coords -> (bitmap, words): the changed-word
    bitmap (grid_words' second element long) and the changed words' XOR
    masks in ascending word order — the delta-of-sparse frame's payload
    (the server-side encode twin of `words_to_coords`)."""
    xy = np.ascontiguousarray(np.asarray(cells, np.int64).reshape(-1, 2))
    total, nb = grid_words(width, height)
    flat = (xy[:, 1] // 32) * width + xy[:, 0]
    bit = np.uint32(1) << (xy[:, 1] % 32).astype(np.uint32)
    uniq, inv = np.unique(flat, return_inverse=True)
    words = np.zeros(len(uniq), np.uint32)
    np.bitwise_or.at(words, inv, bit)
    bitmap = np.zeros(nb, np.uint32)
    np.bitwise_or.at(
        bitmap, (uniq >> 5).astype(np.int64),
        np.uint32(1) << (uniq & 31).astype(np.uint32),
    )
    return bitmap, words


def words_to_coords(bitmap, words, width: int, height: int) -> np.ndarray:
    """(bitmap, words) -> (N, 2) int32 x,y flip coords in row-major
    (y, x) order — the SAME order the coord-frame path delivers, so the
    downstream event stream is identical either way. Raises WireError
    on any inconsistency: bitmap popcount vs word count, set bits
    outside the grid, or mask bits past the board height (the last
    word of a non-multiple-of-32 board)."""
    total, nb = grid_words(width, height)
    bitmap = np.asarray(bitmap, np.uint32)
    words = np.asarray(words, np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    idx = np.flatnonzero((bitmap[:, None] >> shifts) & 1)
    if idx.size != len(words):
        raise WireError(
            f"delta-flips bitmap pops {idx.size} words, frame carries "
            f"{len(words)}"
        )
    if idx.size and int(idx.max()) >= total:
        raise WireError("delta-flips bitmap bit outside the board grid")
    rows, bits = np.nonzero(((words[:, None] >> shifts) & 1).astype(bool))
    x = idx[rows] % width
    y = (idx[rows] // width) * 32 + bits
    if y.size and int(y.max()) >= height:
        raise WireError("delta-flips mask bit past the board height")
    order = np.lexsort((x, y))
    return np.column_stack([x[order], y[order]]).astype(np.int32)


def delta_flips_to_frame(turn: int, bitmap_delta, words) -> bytes:
    """One turn's flips as a delta-of-sparse binary frame: the
    changed-word bitmap XORed against the previous SENT turn's bitmap,
    plus the changed words' XOR masks (see the module docstring)."""
    bz = zlib.compress(
        np.ascontiguousarray(bitmap_delta, np.uint32).tobytes(), 1
    )
    wz = zlib.compress(np.ascontiguousarray(words, np.uint32).tobytes(), 1)
    return (_DFLIPS_HDR.pack(_TAG_DFLIPS, turn, len(words), len(bz))
            + bz + wz)


def heartbeat_to_frame(turn: int) -> bytes:
    """The server's liveness beacon as a raw binary frame (9 bytes on
    the wire) — carries the committed turn so an idle-attached client
    can still show progress. JSON peers get `{"t":"hb","turn":N}`."""
    return _HB_HDR.pack(_TAG_HB, turn)


# --- remote-write metric samples (the history plane) ---

#: tag, emit wall ts (epoch seconds), sample count, flags — then one
#: zlib blob: JSON `{"s": [[key, value], ...], "m": {...}}`. Samples
#: carry ABSOLUTE values of series that CHANGED since the sender's
#: previous push ("delta-encoded" means delta in the series *set*,
#: never in the values, so a lost frame can only delay a point — it
#: can never corrupt later ones); a frame with MSAMPLES_FULL set
#: carries the sender's whole registry (sent on (re)connect, and on a
#: keyframe cadence, so the collector can seed segment keyframes).
_MSAMPLES_HDR = struct.Struct("<BdII")
MSAMPLES_FULL = 1
#: Samples one frame may claim — a sidecar registry tops out in the
#: hundreds of series; a header claiming more is an attack, not a peer.
MSAMPLES_MAX = 1 << 16
#: Longest series key (`name{labels}`) a sample may carry. Bounds the
#: decompression allowance computed from the header's sample count, so
#: a lying header cannot buy itself a big inflation budget.
MSAMPLE_KEY_MAX = 512
#: Allowance for the optional meta dict (alert state transitions and
#: span digests ride along with the samples).
MSAMPLES_META_MAX = 64 << 10


def samples_to_frame(ts: float, samples, *, full: bool = False,
                     meta: Optional[dict] = None) -> bytes:
    """Assemble one _TAG_MSAMPLES frame from (key, value) pairs."""
    obj = {"s": [[k, float(v)] for k, v in samples]}
    if meta:
        obj["m"] = meta
    raw = json.dumps(obj, separators=(",", ":")).encode()
    return (_MSAMPLES_HDR.pack(_TAG_MSAMPLES, ts, len(obj["s"]),
                               MSAMPLES_FULL if full else 0)
            + zlib.compress(raw, 1))


def _parse_msamples(payload: bytes) -> dict:
    _, ts, n, flags = _MSAMPLES_HDR.unpack_from(payload)
    if n > MSAMPLES_MAX:
        raise WireError(f"implausible sample count {n}")
    if not math.isfinite(ts):
        raise WireError("non-finite samples timestamp")
    limit = 1024 + n * (MSAMPLE_KEY_MAX + 64) + MSAMPLES_META_MAX
    raw = _decompress(payload[_MSAMPLES_HDR.size:], limit=limit)
    try:
        obj = json.loads(raw.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError(f"malformed samples payload: {e}") from None
    entries = obj.get("s") if isinstance(obj, dict) else None
    if not isinstance(entries, list):
        raise WireError("samples payload carries no sample list")
    if len(entries) != n:
        raise WireError(
            f"header says {n} samples, payload carries {len(entries)}"
        )
    samples = []
    for item in entries:
        if (not isinstance(item, list) or len(item) != 2
                or not isinstance(item[0], str)
                or not isinstance(item[1], (int, float))
                or isinstance(item[1], bool)):
            raise WireError("malformed sample entry")
        key, value = item[0], float(item[1])
        if len(key) > MSAMPLE_KEY_MAX:
            raise WireError(
                f"sample key of {len(key)} chars exceeds "
                f"{MSAMPLE_KEY_MAX}"
            )
        if not math.isfinite(value):
            raise WireError(f"non-finite sample value for {key!r}")
        samples.append((key, value))
    meta = obj.get("m", {})
    if not isinstance(meta, dict):
        raise WireError("samples meta is not an object")
    return {"t": "msamples", "ts": ts,
            "full": bool(flags & MSAMPLES_FULL),
            "samples": samples, "meta": meta}


# --- k-turn flip batches (negotiated via hello "batch") ---

#: Raw-payload ceiling under which a batch blob is worth deflating.
#: Measured on the serving container: zlib level 1 runs ~20 MB/s on
#: incompressible word masks — fine for the few-KB payloads a settled
#: board produces per batch, ruinous on the multi-MB payloads of an
#: active board (it would cost more wall time than the link saves on
#: loopback/LAN). Each blob carries a codec byte, so the choice is
#: per-blob and per-frame, never negotiated.
FBATCH_ZLIB_MAX = 64 << 10


def _pack_blob(raw: bytes) -> bytes:
    """codec byte (0 = raw, 1 = zlib) + payload."""
    if len(raw) <= FBATCH_ZLIB_MAX:
        z = zlib.compress(raw, 1)
        if len(z) < len(raw):
            return b"\x01" + z
    return b"\x00" + raw


def _unpack_blob(blob: bytes, limit: int) -> bytes:
    """Decode one codec-tagged batch blob with a hard output bound
    (the caller knows the exact expected size from the header)."""
    if not blob:
        raise WireError("empty batch blob")
    codec, data = blob[0], blob[1:]
    if codec == 0:
        if len(data) > limit:
            raise WireError(
                f"batch blob of {len(data)} bytes exceeds {limit}"
            )
        return data
    if codec == 1:
        return _decompress(data, limit=max(limit, 1))
    raise WireError(f"unknown batch blob codec {codec}")


def _bitmap_indices(bitmap_row) -> np.ndarray:
    """Set-bit positions of one changed-word bitmap row, ascending —
    the word indices its masks land at."""
    shifts = np.arange(32, dtype=np.uint32)
    return np.flatnonzero((bitmap_row[:, None] >> shifts) & 1)


def _indices_to_bitmap(idx, nb: int) -> np.ndarray:
    bm = np.zeros(nb, np.uint32)
    np.bitwise_or.at(
        bm, (idx >> 5).astype(np.int64),
        np.uint32(1) << (idx & 31).astype(np.uint32),
    )
    return bm


def chunk_deltas(counts, bitmaps, values, a: int, b: int,
                 total_words: int):
    """Turn-axis delta of one chunk segment: per-turn S-sparse rows
    (`counts` (k,), changed-word `bitmaps` (k, nb) uint32, `values`
    (Σcounts,) uint32 masks in ascending word order per turn — the
    device compact layout) for turns [a, b) become (dcounts,
    dbitmaps, dwords) where row i is D[i] = S[a+i] XOR S[a+i-1]
    (D[0] = S[a] raw: frames are self-contained). `dbitmaps` carries
    one row per NONZERO dcount, in turn order.

    The dominant case — a settled board, where S[t] == S[t-1] exactly
    — is detected by whole-array comparison (no per-word work); only
    genuinely differing adjacent turns pay a dense XOR of their two
    scattered rows."""
    counts = np.asarray(counts, np.int64)
    k = b - a
    offs = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    cnts = counts[a:b]
    bms = np.asarray(bitmaps, np.uint32)[a:b]
    same = np.zeros(k, bool)
    if k > 1:
        cand = (cnts[1:] == cnts[:-1]) & (bms[1:] == bms[:-1]).all(axis=1)
        if cand.any():
            if (cnts == cnts[0]).all() and cnts[0] > 0:
                # Uniform counts (the settled steady state): one
                # reshaped compare settles value equality for every
                # adjacent pair at once.
                v = values[offs[a]:offs[b]].reshape(k, int(cnts[0]))
                same[1:] = cand & (v[1:] == v[:-1]).all(axis=1)
            else:
                for t in (np.flatnonzero(cand) + 1):
                    lo, hi = offs[a + t], offs[a + t + 1]
                    plo, phi = offs[a + t - 1], offs[a + t]
                    same[t] = np.array_equal(values[lo:hi],
                                             values[plo:phi])
    dcounts = np.zeros(k, np.uint32)
    drows = []
    dparts = []
    for t in range(k):
        if t and same[t]:
            continue  # D[t] == 0
        lo, hi = offs[a + t], offs[a + t + 1]
        if t == 0:
            if cnts[0]:
                dcounts[0] = cnts[0]
                drows.append(bms[0])
                dparts.append(values[lo:hi])
            continue
        d = np.zeros(total_words, np.uint32)
        d[_bitmap_indices(bms[t])] = values[lo:hi]
        plo, phi = offs[a + t - 1], offs[a + t]
        d[_bitmap_indices(bms[t - 1])] ^= values[plo:phi]
        nz = np.flatnonzero(d)
        if nz.size:
            dcounts[t] = nz.size
            drows.append(_indices_to_bitmap(nz, bms.shape[1]))
            dparts.append(d[nz])
    nb = bms.shape[1]
    dbitmaps = (np.stack(drows) if drows
                else np.zeros((0, nb), np.uint32))
    dwords = (np.concatenate(dparts) if dparts
              else np.zeros(0, np.uint32))
    return dcounts, dbitmaps, dwords


def flip_batch_to_frame(first_turn: int, nb: int, dcounts, dbitmaps,
                        dwords, ts: float) -> bytes:
    """Assemble one _TAG_FBATCH frame from turn-axis deltas (the
    `chunk_deltas` output shape)."""
    dcounts = np.ascontiguousarray(dcounts, np.uint32)
    dbitmaps = np.ascontiguousarray(dbitmaps, np.uint32)
    dwords = np.ascontiguousarray(dwords, np.uint32)
    blobs = [_pack_blob(dcounts.tobytes()),
             _pack_blob(dbitmaps.tobytes()),
             _pack_blob(dwords.tobytes())]
    return _FBATCH_HDR.pack(
        _TAG_FBATCH, first_turn, len(dcounts), nb, ts,
        len(blobs[0]), len(blobs[1]), len(blobs[2]),
    ) + b"".join(blobs)


def _parse_fbatch(payload: bytes) -> dict:
    (_, first, k, nb, ts, lc, lb, lw) = _FBATCH_HDR.unpack_from(payload)
    if not 0 < k <= FBATCH_MAX_TURNS:
        raise WireError(f"implausible batch turn count {k}")
    if not 0 < nb <= MAX_RAW // 4:
        raise WireError(f"implausible batch bitmap width {nb}")
    body = payload[_FBATCH_HDR.size:]
    if lc + lb + lw != len(body):
        raise WireError("batch blobs disagree with the frame length")
    craw = _unpack_blob(body[:lc], 4 * k)
    if len(craw) != 4 * k:
        raise WireError(
            f"batch header says {k} turns, counts blob carries "
            f"{len(craw)} bytes"
        )
    counts = np.frombuffer(craw, np.uint32)
    nnz = int(np.count_nonzero(counts))
    total = int(counts.sum(dtype=np.int64))
    if total > MAX_RAW // 4 or nnz * nb > MAX_RAW // 4:
        raise WireError(f"implausible batch payload ({total} words)")
    braw = _unpack_blob(body[lc:lc + lb], 4 * nnz * nb)
    if len(braw) != 4 * nnz * nb:
        raise WireError(
            f"batch bitmap blob of {len(braw)} bytes, {nnz} nonzero "
            f"turns x {nb} words expected"
        )
    wraw = _unpack_blob(body[lc + lb:], 4 * total)
    if len(wraw) != 4 * total:
        raise WireError(
            f"batch counts sum to {total} words, mask blob carries "
            f"{len(wraw)} bytes"
        )
    dbitmaps = np.frombuffer(braw, np.uint32).reshape(nnz, nb)
    # Every nonzero turn's bitmap must pop exactly its count — a lying
    # count would misalign every later turn's mask slice.
    pops = np.bitwise_count(dbitmaps).sum(axis=1, dtype=np.int64)
    if not np.array_equal(pops, counts[counts > 0].astype(np.int64)):
        raise WireError("batch bitmap popcounts disagree with counts")
    return {"t": "fbatch", "first_turn": first, "k": k, "nb": nb,
            "ts": ts, "counts": counts, "dbitmaps": dbitmaps,
            "dwords": np.frombuffer(wraw, np.uint32)}


def _coords_from(blob: bytes) -> np.ndarray:
    raw = _decompress(blob)
    if len(raw) % 8:
        raise WireError(f"coordinate payload of {len(raw)} bytes")
    return np.frombuffer(raw, np.int32).reshape(-1, 2)


def _parse_frame(payload: bytes) -> dict:
    """Binary frame -> the dict shape its JSON sibling decodes to, with
    the payload already parsed ("coords" / "world" keys instead of the
    base64 fields). Every malformed-frame failure surfaces as
    WireError — struct/zlib/reshape errors escaping here would kill
    accept/reader threads whose handlers only expect WireError/OSError
    (a peer could wedge the server pre-auth with a 5-byte frame)."""
    try:
        return _parse_frame_inner(payload)
    except WireError:
        raise
    except (struct.error, zlib.error, ValueError, IndexError) as e:
        raise WireError(f"malformed binary frame: {e}") from None


def _parse_frame_inner(payload: bytes) -> dict:
    tag = payload[0]
    if tag == _TAG_FLIPS:
        _, turn = _FLIPS_HDR.unpack_from(payload)
        return {"t": "flips", "turn": turn,
                "coords": _coords_from(payload[_FLIPS_HDR.size:])}
    if tag == _TAG_BOARD:
        _, turn, w, h, token = _BOARD_HDR.unpack_from(payload)
        if h <= 0 or w <= 0 or h * w > MAX_RAW:
            raise WireError(f"implausible board dimensions {w}x{h}")
        raw = _decompress(payload[_BOARD_HDR.size:], limit=h * w)
        return {"t": "board", "turn": turn, "width": w, "height": h,
                "token": token,
                "world": np.frombuffer(raw, np.uint8).reshape(h, w)}
    if tag == _TAG_FINAL:
        _, turn = _FINAL_HDR.unpack_from(payload)
        return {"t": "ev", "k": "final", "turn": turn,
                "coords": _coords_from(payload[_FINAL_HDR.size:])}
    if tag == _TAG_LFLIPS:
        _, turn, czlen = _LFLIPS_HDR.unpack_from(payload)
        body = payload[_LFLIPS_HDR.size:]
        if czlen > len(body):
            raise WireError("level-flips coords blob overruns the frame")
        coords = _coords_from(body[:czlen])
        lv = np.frombuffer(_decompress(body[czlen:]), np.uint8)
        if len(lv) != len(coords):
            raise WireError(
                f"{len(coords)} cells vs {len(lv)} levels in frame"
            )
        return {"t": "flips", "turn": turn, "coords": coords, "levels": lv}
    if tag == _TAG_DFLIPS:
        _, turn, m, bzlen = _DFLIPS_HDR.unpack_from(payload)
        body = payload[_DFLIPS_HDR.size:]
        if bzlen > len(body):
            raise WireError("delta-flips bitmap blob overruns the frame")
        if m > MAX_RAW // 4:
            raise WireError(f"implausible delta-flips word count {m}")
        braw = _decompress(body[:bzlen])
        if len(braw) % 4:
            raise WireError(
                f"delta-flips bitmap payload of {len(braw)} bytes"
            )
        # The header states the exact word count — bound the value
        # inflation to it (a zero-word frame still needs a 1-byte
        # allowance: max_length=0 would mean UNLIMITED to zlib).
        wraw = _decompress(body[bzlen:], limit=max(4 * m, 1))
        if len(wraw) != 4 * m:
            raise WireError(
                f"delta-flips header says {m} words, payload carries "
                f"{len(wraw)} bytes"
            )
        return {"t": "dflips", "turn": turn,
                "dbitmap": np.frombuffer(braw, np.uint32),
                "dwords": np.frombuffer(wraw, np.uint32)}
    if tag == _TAG_FBATCH:
        return _parse_fbatch(payload)
    if tag == _TAG_MSAMPLES:
        return _parse_msamples(payload)
    if tag == _TAG_HB:
        _, turn = _HB_HDR.unpack_from(payload)
        return {"t": "hb", "turn": turn}
    # Unknown tags pass through as an ignorable kind (forward compat,
    # like unknown JSON "t" values).
    return {"t": f"bin{tag}"}


# --- event (de)serialization ---

_STATE = {s.name: s for s in State}


def event_to_msg(ev: Event) -> dict:
    if isinstance(ev, AliveCellsCount):
        return {"t": "ev", "k": "alive", "turn": ev.completed_turns,
                "count": ev.cells_count}
    if isinstance(ev, ImageOutputComplete):
        return {"t": "ev", "k": "image", "turn": ev.completed_turns,
                "filename": ev.filename}
    if isinstance(ev, StateChange):
        return {"t": "ev", "k": "state", "turn": ev.completed_turns,
                "state": ev.new_state.name}
    if isinstance(ev, TurnComplete):
        return {"t": "ev", "k": "turn", "turn": ev.completed_turns}
    if isinstance(ev, FinalTurnComplete):
        # The alive set can be millions of cells (a 5120^2 board at 25%
        # density is ~6.5M) — plain JSON pairs would blow MAX_FRAME, so
        # the coordinates ride as zlib(int32 x,y pairs) like board rasters.
        # Cell is a NamedTuple, so asarray builds the (N, 2) x,y array
        # directly — no per-cell intermediate lists on multi-million-cell
        # finals.
        coords = np.asarray(ev.alive, np.int32).reshape(-1, 2)
        packed = base64.b64encode(zlib.compress(coords.tobytes(), 1))
        return {"t": "ev", "k": "final", "turn": ev.completed_turns,
                "alive_z": packed.decode("ascii")}
    if isinstance(ev, CellFlipped):  # normally batched into "flips";
        # single-cell form stays legacy JSON (decodable by every peer)
        return {"t": "flips", "turn": ev.completed_turns,
                "cells": [[ev.cell.x, ev.cell.y]]}
    raise TypeError(f"unserializable event {ev!r}")


def msg_flips_array(msg: dict) -> tuple:
    """(turn, (N, 2) int32 x,y array) from a flips message — the
    vectorized decode (Controller batch mode); `msg_to_events` expands
    the same array into per-cell CellFlipped events."""
    turn = msg["turn"]
    if "coords" in msg:  # binary frame, already parsed
        coords = msg["coords"]
    elif "cells_z" in msg:
        coords = np.frombuffer(
            _decompress(base64.b64decode(msg["cells_z"])), np.int32
        ).reshape(-1, 2)
    else:
        coords = np.asarray(msg["cells"], np.int32).reshape(-1, 2)
    return turn, coords


def flips_to_msg(turn: int, cells, levels=None) -> dict:
    """One turn's flip batch as zlib'd int32 (x, y) pairs — the board-
    raster/FinalTurnComplete treatment applied to the per-turn stream
    An active 512² board flips ~10³-10⁴ cells per
    turn; JSON pairs cost ~9 bytes/cell on the wire, this ~1-2.
    `levels` (multi-state rules) rides alongside as zlib'd bytes."""
    coords = np.asarray(cells, np.int32).reshape(-1, 2)
    packed = base64.b64encode(zlib.compress(coords.tobytes(), 1))
    msg = {"t": "flips", "turn": turn, "cells_z": packed.decode("ascii")}
    if levels is not None:
        lv = np.ascontiguousarray(np.asarray(levels, np.uint8).reshape(-1))
        if len(lv) != len(coords):
            raise ValueError(f"{len(coords)} cells vs {len(lv)} levels")
        msg["levels_z"] = base64.b64encode(
            zlib.compress(lv.tobytes(), 1)
        ).decode("ascii")
    return msg


def msg_flips_levels(msg: dict):
    """The (N,) uint8 level array of a flips message, or None for a
    two-state batch. Length agreement with the coords is checked at
    decode time for binary frames; JSON callers pair this with
    `msg_flips_array` and verify themselves."""
    if "levels" in msg:  # binary frame, already parsed
        return msg["levels"]
    if "levels_z" in msg:
        return np.frombuffer(
            _decompress(base64.b64decode(msg["levels_z"])), np.uint8
        )
    return None


def msg_to_events(msg: dict) -> list[Event]:
    """Expand one engine→controller message into Event objects (a "flips"
    batch becomes one CellFlipped per cell)."""
    t = msg["t"]
    if t == "flips":
        turn, coords = msg_flips_array(msg)
        return [CellFlipped(turn, Cell(int(x), int(y))) for x, y in coords]
    if t != "ev":
        raise TypeError(f"not an event message: {msg!r}")
    k, turn = msg["k"], msg["turn"]
    if k == "alive":
        return [AliveCellsCount(turn, msg["count"])]
    if k == "image":
        return [ImageOutputComplete(turn, msg["filename"])]
    if k == "state":
        return [StateChange(turn, _STATE[msg["state"]])]
    if k == "turn":
        return [TurnComplete(turn)]
    if k == "final":
        if "coords" in msg:  # binary frame, already parsed
            coords = msg["coords"]
        else:
            coords = np.frombuffer(
                _decompress(base64.b64decode(msg["alive_z"])), np.int32
            ).reshape(-1, 2)
        return [FinalTurnComplete(turn, [Cell(int(x), int(y)) for x, y in coords])]
    raise TypeError(f"unknown event kind {k!r}")


def board_to_msg(turn: int, world: np.ndarray, token: int = 0) -> dict:
    h, w = world.shape
    raw = zlib.compress(np.ascontiguousarray(world, np.uint8).tobytes(), 1)
    return {"t": "board", "turn": turn, "width": w, "height": h,
            "token": token, "data": base64.b64encode(raw).decode("ascii")}


def msg_to_board(msg: dict) -> tuple[int, np.ndarray]:
    if "world" in msg:  # binary frame, already parsed (and bounded)
        return msg["turn"], msg["world"]
    h, w = int(msg["height"]), int(msg["width"])
    if h <= 0 or w <= 0 or h * w > MAX_RAW:
        raise WireError(f"implausible board dimensions {w}x{h}")
    # The header states the exact raster size — bound the inflation to
    # it (reshape would reject a short payload either way).
    raw = _decompress(base64.b64decode(msg["data"]), limit=h * w)
    world = np.frombuffer(raw, np.uint8).reshape(h, w)
    return msg["turn"], world
