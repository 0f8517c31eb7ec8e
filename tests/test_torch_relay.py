"""The port's broadcast tier against gol_tpu's, on the CPU.

`gol_tpu_torch.relay` (the relay node and the WebSocket gateway) must
be a drop-in peer of `gol_tpu.relay` in either direction of a chain:

- ZERO RE-ENCODE: under one scripted upstream (a recorded gol_tpu run
  replayed frame for frame), both packages' relays hand a downstream
  observer the upstream's FBATCH payloads byte for byte, and the same
  BoardSync bytes at attach; a LATE attacher's BoardSync, encoded from
  the relay's shadow raster, is equal across packages and to the plain
  board at its turn.
- MIXED CHAINS: every pairing of root (EngineServer) and relay package
  runs a 64² board to its end through root → relay → leaf; the leaf's
  final board is the plain run's, and the FBATCH frames on the
  root→relay link are the ones on the relay→leaf link.
- CLOCK: a downstream probe's echo carries the relay's clock PLUS its
  upstream offset, in every pairing, so a leaf's ages are against the
  root's stamps whichever package sits where.
- WEBSOCKET: the handshake response, the frame codec and the close
  frame are gol_tpu's byte for byte, and the gateway carries the
  upstream payloads unchanged inside WS binary messages.

Every wait has its own timeout; runtime invariants and lockcheck are on
(the port's `testing.leaks.lockcheck_guard`).
"""

import contextlib
import itertools
import json
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

import gol_tpu.distributed.client as jcli
import gol_tpu.distributed.server as jsrv
import gol_tpu.relay.node as jnode
from gol_tpu.distributed import wire as jw
from gol_tpu.ops import life as jlife
from gol_tpu.params import Params as JParams
from gol_tpu.relay import ws as jws
from gol_tpu_torch.distributed import client as tcli
from gol_tpu_torch.distributed import server as tsrv
from gol_tpu_torch.distributed import wire as tw
from gol_tpu_torch.params import Params as TParams
from gol_tpu_torch.relay import node as tnode
from gol_tpu_torch.relay import ws as tws
from gol_tpu_torch.testing.leaks import lockcheck_guard

WAIT = 10.0

PKG = {
    "gol_tpu": types.SimpleNamespace(
        srv=jsrv, cli=jcli, node=jnode, ws=jws, wire=jw, Params=JParams,
        extra={}),
    "gol_tpu_torch": types.SimpleNamespace(
        srv=tsrv, cli=tcli, node=tnode, ws=tws, wire=tw, Params=TParams,
        extra={"device": "cpu"}),
}
NAMES = list(PKG)
PAIRINGS = list(itertools.product(NAMES, NAMES))
PAIR_IDS = [f"{r}-root-{n}-relay" for r, n in PAIRINGS]
FBATCH = jw._TAG_FBATCH
BOARD = jw._TAG_BOARD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _guards(monkeypatch):
    yield from lockcheck_guard(monkeypatch)


def _world(seed=7, w=64, h=64, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8) * 255


def _plain(world, turns):
    w = np.asarray(world)
    for _ in range(turns // 16):
        w = jlife.step_n(w, 16)
    for _ in range(turns % 16):
        w = jlife.step_n(w, 1)
    return np.asarray(w)


def _wait(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def _tokens_from_one(monkeypatch):
    """Peer tokens from 1 in both packages (they ride the BoardSync)."""
    for P in PKG.values():
        monkeypatch.setattr(P.srv._Conn, "_next_token",
                            itertools.count(1).__next__)


def _recv_payload(sock):
    """One frame payload (length-prefixed), or None at EOF."""
    return jw.recv_frame(sock)


# --- a scripted upstream: a recorded gol_tpu run, replayed ---------------


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The root→observer stream of a gol_tpu EngineServer running a 64²
    soup 48 turns in 16-turn batch frames: the board frame and the
    FBATCH payloads exactly as gol_tpu encoded them, and the world."""
    world = _world(11)
    out = tmp_path_factory.mktemp("rec")
    srv = jsrv.EngineServer(
        JParams(turns=48, threads=1, image_width=64, image_height=64,
                out_dir=str(out), tick_seconds=60.0),
        port=0, batch_turns=16, initial_world=world)
    srv._keys.put("p")
    srv.start()
    s = socket.create_connection(srv.address, timeout=WAIT)
    try:
        _wait(lambda: srv.engine._paused, "the engine to pause")
        jw.send_msg(s, {"t": "hello", "want_flips": True, "binary": True,
                        "batch": 16})
        payloads = []
        while True:
            p = jw.recv_frame(s)
            if p is None:
                break
            if p[:1] and p[0] == BOARD and not payloads:
                payloads.append(p)
                jw.send_msg(s, {"t": "key", "key": "p"})
            elif p[:1] and p[0] == FBATCH:
                payloads.append(p)
            elif p[:1] == b"{" and json.loads(p).get("t") == "bye":
                break
    finally:
        s.close()
        srv.shutdown()
    assert payloads[0][0] == BOARD and len(payloads) >= 4
    last = jw._parse_frame(payloads[-1])
    return types.SimpleNamespace(
        world=world, payloads=payloads,
        last_turn=last["first_turn"] + last["k"] - 1)


class ScriptedRoot:
    """A fake root: acks the relay's hello, sends the recorded board,
    then (once released) the recorded FBATCH frames, then stays quiet,
    answering clock probes."""

    def __init__(self, payloads):
        self.payloads = payloads
        self.release = threading.Event()
        self.stop = threading.Event()
        self.listener = socket.create_server(("127.0.0.1", 0))
        self.address = self.listener.getsockname()
        self.conns = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        try:
            s, _ = self.listener.accept()
        except OSError:
            return
        self.conns.append(s)
        try:
            s.settimeout(WAIT)
            jw.recv_msg(s, allow_binary=False)  # hello
            jw.send_msg(s, {"t": "attach-ack", "clock": True, "depth": 0,
                            "batch": 16})
            s.sendall(jw.frame_bytes(self.payloads[0]))
            while not self.release.wait(0.02):
                if self.stop.is_set():
                    return
            for p in self.payloads[1:]:
                s.sendall(jw.frame_bytes(p))
            while not self.stop.is_set():
                try:
                    s.settimeout(0.05)
                    m = jw.recv_msg(s, allow_binary=False)
                except TimeoutError:
                    continue
                except (jw.WireError, OSError):
                    return
                if m is None:
                    return
                if m.get("t") == "clk":
                    jw.send_msg(s, {"t": "clk", "t0": m.get("t0"),
                                    "ts": time.time()})
        except OSError:
            pass

    def close(self):
        self.stop.set()
        self.release.set()
        self.listener.close()
        self.thread.join(WAIT)
        for s in self.conns:
            with contextlib.suppress(OSError):
                s.close()


def _attach(address, **extra):
    s = socket.create_connection(address, timeout=WAIT)
    s.settimeout(WAIT)
    jw.send_msg(s, {"t": "hello", "want_flips": True, "binary": True,
                    "role": "observe", "batch": 16, **extra})
    ack = jw.recv_msg(s, allow_binary=False)
    return s, ack


def _next_bulk(sock):
    """The next board or FBATCH payload on a downstream socket."""
    while True:
        p = _recv_payload(sock)
        assert p is not None, "stream ended early"
        if p[:1] and p[0] in (BOARD, FBATCH):
            return p


def _relay_round(pkg, recorded, monkeypatch):
    """One relay of `pkg` under a scripted root: an early observer's
    board and forwarded frames, then a late attacher's BoardSync."""
    _tokens_from_one(monkeypatch)
    root = ScriptedRoot(recorded.payloads)
    relay = PKG[pkg].node.RelayNode(root.address, port=0).start()
    socks = []
    try:
        assert relay.synced.wait(WAIT)
        early, ack = _attach(relay.address)
        socks.append(early)
        assert ack["t"] == "attach-ack" and ack["depth"] == 1
        got = [_next_bulk(early)]
        root.release.set()
        while len(got) < len(recorded.payloads):
            got.append(_next_bulk(early))
        _wait(lambda: relay.turn == recorded.last_turn,
              "the relay's shadow to reach the last turn")
        late, _ = _attach(relay.address)
        socks.append(late)
        late_sync = _next_bulk(late)
        shadow = relay.board.copy()
    finally:
        for s in socks:
            s.close()
        relay.shutdown()
        root.close()
    return got, late_sync, shadow


@pytest.fixture(scope="module")
def oracle_round(recorded):
    with pytest.MonkeyPatch.context() as mp:
        return _relay_round("gol_tpu", recorded, mp)


@pytest.mark.parametrize("pkg", NAMES)
def test_relay_forwards_upstream_bytes_unchanged(pkg, recorded,
                                                 oracle_round, monkeypatch):
    """Zero re-encode: every FBATCH payload a downstream gets is the
    upstream's, byte for byte, and the attach BoardSync is gol_tpu's."""
    got, _, _ = (oracle_round if pkg == "gol_tpu"
                 else _relay_round(pkg, recorded, monkeypatch))
    assert got[1:] == recorded.payloads[1:]
    assert got == oracle_round[0]
    turn, board = jw.msg_to_board(jw._parse_frame(got[0]))
    assert turn == 0
    np.testing.assert_array_equal(np.asarray(board) != 0,
                                  recorded.world != 0)


@pytest.mark.parametrize("pkg", NAMES)
def test_late_attach_board_sync_equal_across_packages(pkg, recorded,
                                                      oracle_round,
                                                      monkeypatch):
    """A late attacher is synced from the relay's shadow raster: the
    BoardSync bytes are equal across packages and decode to the plain
    board at the last forwarded turn."""
    _, late, shadow = (oracle_round if pkg == "gol_tpu"
                       else _relay_round(pkg, recorded, monkeypatch))
    assert late == oracle_round[1]
    turn, board = tw.msg_to_board(tw._parse_frame(late))
    assert turn == recorded.last_turn
    want = _plain(recorded.world, recorded.last_turn)
    np.testing.assert_array_equal(np.asarray(board) != 0, want != 0)
    np.testing.assert_array_equal(shadow != 0, want != 0)


# --- mixed-package chains over a real engine ------------------------------


class Tap:
    """A loopback proxy that records the bytes it carries downstream."""

    def __init__(self, upstream):
        self.upstream = tuple(upstream[:2])
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self.address = self._lsock.getsockname()
        self.down = bytearray()
        self._socks = []
        threading.Thread(target=self._serve, daemon=True).start()

    def _pump(self, src, dst, buf):
        while True:
            try:
                data = src.recv(1 << 16)
            except OSError:
                break
            if not data:
                break
            if buf is not None:
                buf.extend(data)
            try:
                dst.sendall(data)
            except OSError:
                break
        for s in (src, dst):
            with contextlib.suppress(OSError):
                s.shutdown(socket.SHUT_RDWR)

    def _serve(self):
        try:
            c, _ = self._lsock.accept()
        except OSError:
            return
        u = socket.create_connection(self.upstream, timeout=WAIT)
        u.settimeout(None)
        self._socks += [c, u]
        for args in ((c, u, None), (u, c, self.down)):
            threading.Thread(target=self._pump, args=args,
                             daemon=True).start()

    def close(self):
        self._lsock.close()
        for s in self._socks:
            s.close()


def _fbatches(raw: bytes) -> list:
    out, i = [], 0
    while i + 4 <= len(raw):
        n = int.from_bytes(raw[i:i + 4], "big")
        p = bytes(raw[i + 4:i + 4 + n])
        if p[:1] and p[0] == FBATCH:
            out.append(p)
        i += 4 + n
    return out


@pytest.mark.parametrize("root_pkg,relay_pkg", PAIRINGS, ids=PAIR_IDS)
def test_mixed_chain_leaf_matches_plain_with_zero_reencode(
        root_pkg, relay_pkg, tmp_path):
    """root → relay → leaf across packages, run to its end: the leaf's
    final board is the plain run's, and the relay→leaf FBATCH frames are
    the root→relay ones."""
    R, N = PKG[root_pkg], PKG[relay_pkg]
    world, turns = _world(5), 96
    srv = R.srv.EngineServer(
        R.Params(turns=turns, threads=1, image_width=64, image_height=64,
                 out_dir=str(tmp_path / "out"), tick_seconds=60.0),
        port=0, batch_turns=16, initial_world=world, **R.extra)
    srv._keys.put("p")
    srv.start()
    up = Tap(srv.address)
    relay = N.node.RelayNode(up.address, port=0, batch_turns=16).start()
    down, leaf, driver = None, None, None
    try:
        _wait(lambda: srv.engine._paused, "the root to pause")
        assert relay.synced.wait(WAIT)
        down = Tap(relay.address)
        leaf = N.cli.Controller(*down.address, want_flips=True, batch=True,
                                batch_turns=16, observe=True,
                                reconnect=False, timeout=WAIT)
        assert leaf.wait_sync(WAIT)
        driver = R.cli.Controller(*srv.address, want_flips=False,
                                  reconnect=False, timeout=WAIT)
        assert driver.wait_sync(WAIT)
        driver.send_key("p")
        _wait(lambda: leaf.events.closed, "the leaf's stream to end",
              timeout=60)
        np.testing.assert_array_equal(leaf.board != 0,
                                      _plain(world, turns) != 0)
        assert leaf.sync_turn == 0
        forwarded = _fbatches(down.down)
        assert forwarded and forwarded == _fbatches(up.down)
    finally:
        for c in (leaf, driver):
            if c is not None:
                c.close()
        relay.shutdown()
        srv.shutdown()
        up.close()
        if down is not None:
            down.close()


@pytest.mark.parametrize("root_pkg,relay_pkg", PAIRINGS, ids=PAIR_IDS)
def test_clock_offsets_sum_along_mixed_chains(root_pkg, relay_pkg,
                                              tmp_path):
    """A downstream probe's echo is the relay's clock PLUS its upstream
    offset: a synthetic 5 s skew on the hop shows up exactly once, in
    every pairing of root and relay package."""
    R, N = PKG[root_pkg], PKG[relay_pkg]
    srv = R.srv.EngineServer(
        R.Params(turns=10 ** 9, threads=1, image_width=64,
                 image_height=64, out_dir=str(tmp_path / "out"),
                 tick_seconds=60.0),
        port=0, initial_world=_world(2), **R.extra).start()
    relay = N.node.RelayNode(srv.address, port=0).start()
    s = None
    try:
        assert relay.synced.wait(WAIT)
        s, ack = _attach(relay.address)
        assert ack.get("clock") is True
        _wait(lambda: relay.clock_offset is not None,
              "the upstream clock probe run")
        assert relay.clock_offset == 0.0  # loopback snaps to zero
        relay.clock_offset = 5.0
        t0 = time.time()
        jw.send_msg(s, {"t": "clk", "t0": t0})
        while True:
            msg = jw.recv_msg(s)
            if msg.get("t") == "clk" and msg.get("t0") == t0:
                break
        skew = float(msg["ts"]) - time.time()
        assert 4.0 < skew < 6.0, skew
    finally:
        if s is not None:
            s.close()
        relay.shutdown()
        srv.shutdown()


# --- the WebSocket gateway ------------------------------------------------

UPGRADE = (
    "GET /stream HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
    "Connection: Upgrade\r\nSec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
    "Sec-WebSocket-Protocol: chat, gol-tpu-wire\r\n"
    "Sec-WebSocket-Version: 13\r\n\r\n").encode()


def _handshake_reply(ws, request: bytes):
    a, b = socket.socketpair()
    a.settimeout(WAIT)
    b.settimeout(WAIT)
    try:
        a.sendall(request)
        headers = ws.handshake(b)
        return headers, a.recv(4096)
    finally:
        a.close()
        b.close()


def test_ws_handshake_and_codec_byte_identical(monkeypatch):
    """The 101 reply, unmasked frames at every length class, masked
    frames under one mask key, close frames, and the parse of each — the
    port's `relay/ws.py` is gol_tpu's byte for byte."""
    assert tws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo=" == \
        jws.accept_key("dGhlIHNhbXBsZSBub25jZQ==")
    assert _handshake_reply(tws, UPGRADE) == _handshake_reply(jws, UPGRADE)
    assert (tws.SUBPROTOCOL, tws.MAX_MESSAGE) == (jws.SUBPROTOCOL,
                                                  jws.MAX_MESSAGE)
    rng = np.random.default_rng(3)
    for n in (0, 1, 125, 126, 65535, 65536, 70000):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for op in (tws.OP_BINARY, tws.OP_TEXT, tws.OP_PING):
            if op == tws.OP_PING and n > 125:
                continue
            assert (tws.encode_frame(op, payload)
                    == jws.encode_frame(op, payload))
            monkeypatch.setattr(tws.os, "urandom", lambda k: b"\x01\x02\x03\x04")
            monkeypatch.setattr(jws.os, "urandom", lambda k: b"\x01\x02\x03\x04")
            masked = tws.encode_frame(op, payload, mask=True)
            assert masked == jws.encode_frame(op, payload, mask=True)
            # Each package reads the other's client frame.
            for reader in (tws, jws):
                a, b = socket.socketpair()
                try:
                    a.sendall(masked)
                    b.settimeout(WAIT)
                    assert reader.read_message(b) == (op, payload)
                finally:
                    a.close()
                    b.close()
    for code, reason in ((1000, ""), (1008, "policy"), (1011, "x" * 60)):
        assert tws.close_frame(code, reason) == jws.close_frame(code, reason)


@pytest.mark.parametrize("request_bytes", [
    b"POST / HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GET / HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GET / HTTP/1.1\r\nUpgrade: websocket\r\n\r\n",
], ids=["post", "no-upgrade", "no-key"])
def test_ws_bad_upgrades_refused_alike(request_bytes):
    for ws in (tws, jws):
        with pytest.raises(ws.WSError):
            _handshake_reply(ws, request_bytes)


def _ws_client(address, hello):
    s = socket.create_connection(address, timeout=WAIT)
    s.settimeout(WAIT)
    s.sendall(UPGRADE)
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = s.recv(4096)
        assert chunk, "gateway closed during the handshake"
        resp += chunk
    assert resp.startswith(b"HTTP/1.1 101")
    s.sendall(jws.encode_frame(jws.OP_TEXT, json.dumps(hello).encode(),
                               mask=True))
    return s


@pytest.mark.parametrize("pkg", NAMES)
def test_ws_gateway_carries_upstream_payloads(pkg, recorded, monkeypatch):
    """A browser-side client of either package's gateway gets the
    attach BoardSync and then the upstream's FBATCH payloads unchanged
    inside WS binary messages."""
    _tokens_from_one(monkeypatch)
    root = ScriptedRoot(recorded.payloads)
    relay = PKG[pkg].node.RelayNode(root.address, port=0, ws_port=0).start()
    s = None
    try:
        assert relay.synced.wait(WAIT)
        s = _ws_client(relay.ws_address,
                       {"t": "hello", "want_flips": True, "binary": True,
                        "batch": 16})
        got = []
        while len(got) < len(recorded.payloads):
            op, payload = jws.read_message(s, require_mask=False)
            if op == jws.OP_PING:
                s.sendall(jws.encode_frame(jws.OP_PONG, payload or b"",
                                           mask=True))
                continue
            if op == jws.OP_BINARY and payload[0] in (BOARD, FBATCH):
                got.append(payload)
                if len(got) == 1:
                    root.release.set()
        assert got[1:] == recorded.payloads[1:]
        turn, board = jw.msg_to_board(jw._parse_frame(got[0]))
        assert turn == 0
        np.testing.assert_array_equal(np.asarray(board) != 0,
                                      recorded.world != 0)
    finally:
        if s is not None:
            s.close()
        relay.shutdown()
        root.close()
