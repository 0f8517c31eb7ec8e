"""Stdlib RFC-6455 WebSocket framing — the browser edge of the relay.

The "millions of users" surface is browsers, and browsers speak
WebSocket, not length-prefixed TCP frames. This module is the minimal
server side of RFC 6455, stdlib only, shaped for the relay's
zero-re-encode invariant: every gol_tpu wire frame payload rides
UNCHANGED inside one WS binary message (the 4-byte length prefix is
dropped — WS frames self-delimit), so a browser observer receives the
IDENTICAL bytes a TCP observer would, and a JS client decodes them
with the same tag-dispatch the Python client uses.

Subprotocol (`gol-tpu-wire`): after the HTTP upgrade, the client's
first message is the hello JSON (text or binary); everything after is
the ordinary message catalog (wire.py) minus framing. Control mapping:

- WS ping (server → client) IS the heartbeat beacon — the payload
  carries the committed turn as ASCII digits; the browser's automatic
  pong is the liveness refresh (the hb/pong plane with zero client
  JS).
- WS close ends the stream (the "bye" of the WS world; a "bye" JSON
  still precedes it so portable clients need no special casing).

Server-side enforcement (the RFC's masking rules, pinned by the fuzz
sweep): client frames MUST be masked, server frames MUST NOT be;
control frames must be FIN, unfragmented and <= 125 bytes; unknown
opcodes, oversized messages and malformed headers fail the connection
cleanly — the reader surfaces `WSError`, the relay detaches the peer,
nothing else dies.

Raw-socket reads live ONLY in `_read_exact` (this module's sanctioned
read primitive — the blocking-io-timeout lint treats it like
wire._recv_exact): an idle read deadline surfaces as TimeoutError at
a frame boundary, WSError mid-frame.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
from typing import Optional, Tuple

from gol_tpu_torch.distributed.wire import MAX_FRAME

__all__ = [
    "GUID",
    "OP_BINARY",
    "OP_CLOSE",
    "OP_PING",
    "OP_PONG",
    "OP_TEXT",
    "WSError",
    "accept_key",
    "encode_frame",
    "handshake",
    "read_message",
]

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
SUBPROTOCOL = "gol-tpu-wire"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA

#: Message-size ceiling: the TCP wire's own frame cap — a WS peer can
#: carry anything a TCP peer could, nothing bigger.
MAX_MESSAGE = MAX_FRAME

#: HTTP request-head ceiling for the upgrade (headers only — a hostile
#: peer must not feed us an unbounded preamble).
MAX_REQUEST = 16 << 10

#: Fragments one message may arrive in (fragmentation is legal; an
#: unbounded fragment train is an attack).
MAX_FRAGMENTS = 256


class WSError(ConnectionError):
    """Protocol violation or malformed frame — the connection is
    unrecoverable (stream position lost), the peer detaches cleanly."""


def accept_key(key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key."""
    digest = hashlib.sha1((key + GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def _read_exact(sock: socket.socket, n: int) -> bytes:
    """THE raw read primitive of the WS plane (the wire._recv_exact
    discipline): deadline expiry with zero bytes is idleness
    (TimeoutError), mid-frame expiry or EOF is a broken peer."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except TimeoutError:
            if not buf:
                raise
            raise WSError("read deadline expired mid-frame") from None
        if not chunk:
            raise WSError("connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def handshake(sock: socket.socket) -> dict:
    """Serve one HTTP upgrade: parse the request head, validate the
    WebSocket headers, send the 101 response (echoing the gol-tpu-wire
    subprotocol when offered). Returns the lowercased header map.
    Raises WSError on anything malformed — the caller closes."""
    head = bytearray()
    while b"\r\n\r\n" not in head:
        if len(head) > MAX_REQUEST:
            raise WSError("oversized upgrade request")
        try:
            chunk = sock.recv(4096)
        except TimeoutError:
            raise WSError("upgrade request timed out") from None
        if not chunk:
            raise WSError("connection closed during upgrade")
        head.extend(chunk)
    try:
        text = bytes(head).split(b"\r\n\r\n", 1)[0].decode("latin-1")
    except UnicodeDecodeError:  # pragma: no cover - latin-1 total
        raise WSError("undecodable upgrade request") from None
    lines = text.split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) < 3 or parts[0] != "GET":
        raise WSError(f"not a websocket GET: {lines[0]!r}")
    headers: dict = {"_path": parts[1]}
    for line in lines[1:]:
        if ":" not in line:
            continue
        k, v = line.split(":", 1)
        headers[k.strip().lower()] = v.strip()
    if "websocket" not in headers.get("upgrade", "").lower():
        raise WSError("missing Upgrade: websocket")
    key = headers.get("sec-websocket-key")
    if not key:
        raise WSError("missing Sec-WebSocket-Key")
    resp = [
        "HTTP/1.1 101 Switching Protocols",
        "Upgrade: websocket",
        "Connection: Upgrade",
        f"Sec-WebSocket-Accept: {accept_key(key)}",
    ]
    offered = [p.strip() for p in
               headers.get("sec-websocket-protocol", "").split(",")]
    if SUBPROTOCOL in offered:
        resp.append(f"Sec-WebSocket-Protocol: {SUBPROTOCOL}")
    sock.sendall(("\r\n".join(resp) + "\r\n\r\n").encode("ascii"))
    return headers


def encode_frame(opcode: int, payload: bytes, fin: bool = True,
                 mask: bool = False) -> bytes:
    """One WS frame. Server→client frames are unmasked (the RFC
    REQUIRES it); mask=True builds a client-side frame — the test
    client and the fuzz suite use it."""
    b0 = (0x80 if fin else 0) | (opcode & 0x0F)
    n = len(payload)
    mbit = 0x80 if mask else 0
    if n < 126:
        header = struct.pack("!BB", b0, mbit | n)
    elif n < (1 << 16):
        header = struct.pack("!BBH", b0, mbit | 126, n)
    else:
        header = struct.pack("!BBQ", b0, mbit | 127, n)
    if not mask:
        return header + payload
    key = os.urandom(4)
    masked = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return header + key + masked


def _read_frame(sock: socket.socket,
                require_mask: bool) -> Tuple[int, bool, bytes]:
    """(opcode, fin, payload) of one raw frame; server side demands
    masked client frames and bounds every length."""
    h = _read_exact(sock, 2)
    fin = bool(h[0] & 0x80)
    if h[0] & 0x70:
        raise WSError("RSV bits set without a negotiated extension")
    opcode = h[0] & 0x0F
    masked = bool(h[1] & 0x80)
    n = h[1] & 0x7F
    if require_mask and not masked:
        # The RFC is explicit: a server MUST fail the connection on
        # an unmasked client frame (proxy-cache poisoning defence).
        raise WSError("unmasked client frame")
    if opcode >= OP_CLOSE:
        # Control frames: FIN, never fragmented, tiny.
        if not fin:
            raise WSError("fragmented control frame")
        if n > 125:
            raise WSError("oversized control frame")
    if n == 126:
        (n,) = struct.unpack("!H", _read_exact(sock, 2))
    elif n == 127:
        (n,) = struct.unpack("!Q", _read_exact(sock, 8))
    if n > MAX_MESSAGE:
        raise WSError(f"frame of {n} bytes exceeds {MAX_MESSAGE}")
    key = _read_exact(sock, 4) if masked else b""
    payload = _read_exact(sock, n) if n else b""
    if masked and n:
        # Vectorized unmask: a per-byte Python loop at the 64 MB
        # message cap would be a GIL-holding CPU-exhaustion gift to
        # any hostile peer.
        import numpy as np

        data = np.frombuffer(payload, np.uint8) ^ np.frombuffer(
            (key * ((n + 3) // 4))[:n], np.uint8
        )
        payload = data.tobytes()
    return opcode, fin, payload


def read_message(sock: socket.socket,
                 require_mask: bool = True,
                 on_control=None) -> Tuple[int, Optional[bytes]]:
    """Next complete MESSAGE: (opcode, payload). Handles continuation
    fragments (returned under the initial opcode). Control frames at
    a message boundary return as their own messages; a control frame
    INTERLEAVED between fragments (legal — RFC 6455 §5.4) goes to
    `on_control(op, payload)` so the fragment buffer survives (close
    still returns immediately — the connection is ending either way);
    without a callback, interleaved pings/pongs are dropped. Raises
    WSError on every protocol violation, TimeoutError on an idle
    deadline at a message boundary."""
    opcode = None
    parts: list = []
    total = 0
    while True:
        try:
            op, fin, payload = _read_frame(sock, require_mask)
        except TimeoutError:
            if opcode is not None:
                # Mid-MESSAGE idleness: the fragment buffer would be
                # silently lost if this surfaced as boundary idleness
                # — the stream is unrecoverable, say so.
                raise WSError(
                    "read deadline expired between fragments"
                ) from None
            raise
        if op in (OP_CLOSE, OP_PING, OP_PONG):
            if op != OP_CLOSE and opcode is not None:
                # Interleaved mid-fragmentation: hand to the caller's
                # hook (or drop) — returning it would discard the
                # buffered fragments and then kill the conformant
                # peer on its continuation.
                if on_control is not None:
                    on_control(op, payload)
                continue
            return op, payload
        if op == OP_CONT:
            if opcode is None:
                raise WSError("continuation frame with nothing to continue")
        elif op in (OP_TEXT, OP_BINARY):
            if opcode is not None:
                raise WSError("new data frame inside a fragmented message")
            opcode = op
        else:
            raise WSError(f"unknown opcode {op:#x}")
        parts.append(payload)
        total += len(payload)
        if total > MAX_MESSAGE:
            raise WSError("fragmented message exceeds the size cap")
        if len(parts) > MAX_FRAGMENTS:
            raise WSError("fragment train exceeds the cap")
        if fin:
            return opcode, b"".join(parts)


def close_frame(code: int = 1000, reason: str = "") -> bytes:
    payload = struct.pack("!H", code) + reason.encode("utf-8")[:100]
    return encode_frame(OP_CLOSE, payload)
