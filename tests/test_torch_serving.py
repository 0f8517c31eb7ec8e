"""The port's serving core against gol_tpu's, on the CPU.

A `gol_tpu_torch` EngineServer (its engine on the kernels' plain
versions, `device="cpu"`) and gol_tpu's serve the same runs to both
packages' Controllers. Every pairing — port ↔ port, port server ↔
gol_tpu Controller, gol_tpu server ↔ port Controller, and gol_tpu ↔
gol_tpu as the oracle — must see the same stream: the server→client
bytes, recorded by a loopback tap, decode to equal messages once the
wall-clock fields are set aside, and the board, flips and final frames
are byte-identical. Then the engine's BoardSync (the committed world,
never mid-emission), attach / detach / reattach against the plain run,
'k' and `resume_from`, the driver slot and the secret, Generations gray
levels and their downgrade, heartbeats through a cold first dispatch,
one injected socket reset survived by reconnect, and the CLI's
`--serve` / `--connect`.

Every socket wait has its own timeout of at most 10 s. Runtime
invariants and lockcheck are on for every test (the port's
`testing.leaks.lockcheck_guard`), and gol_tpu's violation counter must
not grow either.
"""

import dataclasses
import itertools
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import gol_tpu.distributed.client as jcli
import gol_tpu.distributed.server as jsrv
from gol_tpu import events as jev
from gol_tpu.analysis import invariants as jinv
from gol_tpu.analysis.concurrency import lockcheck as jlock
from gol_tpu.distributed import wire as jw
from gol_tpu.ops import life as jlife
from gol_tpu.params import Params as JParams
from gol_tpu_torch import events as tev
from gol_tpu_torch.distributed import client as tcli
from gol_tpu_torch.distributed import server as tsrv
from gol_tpu_torch.engine import distributor as td
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.params import Params as TParams
from gol_tpu_torch.testing import FaultPlan, faults
from gol_tpu_torch.testing.leaks import lockcheck_guard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 10.0  # every socket / thread wait in this file

PKG = {
    "gol_tpu": types.SimpleNamespace(
        srv=jsrv, cli=jcli, ev=jev, Params=JParams, extra={}),
    "gol_tpu_torch": types.SimpleNamespace(
        srv=tsrv, cli=tcli, ev=tev, Params=TParams,
        extra={"device": "cpu"}),
}
PAIRINGS = [("gol_tpu_torch", "gol_tpu_torch"), ("gol_tpu_torch", "gol_tpu"),
            ("gol_tpu", "gol_tpu_torch"), ("gol_tpu", "gol_tpu")]
_SERVER_KW = ("secret", "heartbeat_secs", "evict_secs", "max_peers",
              "batch_turns", "initial_world", "start_turn",
              "cycle_check_seconds")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _guards(monkeypatch):
    """Invariants and lockcheck on in both packages; no violation, no
    lockcheck report, no leaked thread or listener."""
    j_inv, j_lock = jinv.violations_total(), jlock.reports_total()
    yield from lockcheck_guard(monkeypatch)
    assert jinv.violations_total() == j_inv
    assert jlock.reports_total() == j_lock


@pytest.fixture(autouse=True)
def _clean_fault_plan():
    faults.clear()
    yield
    faults.clear()


def make_server(pkg, golden_root, tmp_path, *, resume_from=None, **kw):
    P = PKG[pkg]
    server_kw = {k: kw.pop(k) for k in _SERVER_KW if k in kw}
    params = dict(turns=100, threads=2, image_width=64, image_height=64,
                  image_dir=str(golden_root / "images"),
                  out_dir=str(tmp_path / "out"), tick_seconds=60.0,
                  chunk=2)
    params.update(kw)
    return P.srv.EngineServer(P.Params(**params), port=0,
                              resume_from=resume_from, **server_kw,
                              **P.extra)


def controller(pkg, address, **kw):
    kw.setdefault("timeout", WAIT)
    kw.setdefault("reconnect", False)
    return PKG[pkg].cli.Controller(*address[:2], **kw)


def wait_until(pred, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def drain(ctl, out: list) -> threading.Thread:
    """Collect a controller's events on a thread until its stream ends."""
    def run():
        for ev in ctl.events:
            out.append(ev)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def join(*threads):
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive(), "a stream did not end in time"


def golden(golden_root, name="64x64x100.pgm"):
    return read_pgm(golden_root / "check" / "images" / name)


def plain(world, turns):
    """The plain run: gol_tpu's dense Life step, in blocks of 64 turns
    and single turns (two compiled shapes, whatever `turns` is)."""
    w = np.asarray(world)
    for _ in range(turns // 64):
        w = jlife.step_n(w, 64)
    for _ in range(turns % 64):
        w = jlife.step_n(w, 1)
    return np.asarray(w)


class Tap:
    """A loopback proxy between one controller and the server that
    records the bytes it carries each way (the link is the wire)."""

    def __init__(self, upstream):
        self.upstream = tuple(upstream[:2])
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self._lsock.settimeout(WAIT)
        self.address = self._lsock.getsockname()
        self.down = bytearray()
        self.up = bytearray()
        self._socks = []
        self._threads = [threading.Thread(target=self._serve, daemon=True)]
        self._threads[0].start()

    def _pump(self, src, dst, buf):
        while True:
            try:
                data = src.recv(1 << 16)
            except OSError:
                break
            if not data:
                break
            buf.extend(data)
            try:
                dst.sendall(data)
            except OSError:
                break
        for s in (src, dst):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _serve(self):
        try:
            c, _ = self._lsock.accept()
        except OSError:
            return
        u = socket.create_connection(self.upstream, timeout=WAIT)
        c.settimeout(None)
        u.settimeout(None)
        self._socks += [c, u]
        for args in ((c, u, self.up), (u, c, self.down)):
            t = threading.Thread(target=self._pump, args=args, daemon=True)
            t.start()
            self._threads.append(t)

    def close(self):
        self._lsock.close()
        for t in self._threads[1:]:
            t.join(WAIT)
        for s in self._socks:
            s.close()


def frames(raw: bytes) -> list:
    """Split a recorded stream into frame payloads."""
    out, i = [], 0
    while i + 4 <= len(raw):
        n = int.from_bytes(raw[i:i + 4], "big")
        out.append(bytes(raw[i + 4:i + 4 + n]))
        i += 4 + n
    assert i == len(raw), "recorded stream ends mid-frame"
    return out


#: Binary frame tags compared byte for byte: flips, board, final,
#: level flips, delta flips.
BULK_TAGS = (1, 2, 3, 4, 6)


def _norm(v):
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if dataclasses.is_dataclass(v):
        return (type(v).__name__,
                {f.name: _norm(getattr(v, f.name))
                 for f in dataclasses.fields(v)})
    if hasattr(v, "name") and hasattr(v, "value"):
        return ("enum", v.name)
    return v


def decoded_stream(raw: bytes) -> list:
    """The server→client stream decoded (gol_tpu's decoder; the codecs
    are held equal in test_torch_wire.py), with the wall-clock parts set
    aside: heartbeats, clock-probe echoes, ticker counts, `ts` stamps."""
    out = []
    for p in frames(raw):
        msg = json.loads(p) if p[:1] == b"{" else jw._parse_frame(p)
        if msg.get("t") in ("hb", "clk"):
            continue
        if msg.get("t") == "ev" and msg.get("k") == "alive":
            continue
        msg.pop("ts", None)
        out.append(_norm(msg))
    return out


def bulk_frames(raw: bytes) -> list:
    return [p for p in frames(raw) if p[:1] and p[0] in BULK_TAGS]


def client_events(evs) -> list:
    return [_norm(e) for e in evs if type(e).__name__ != "AliveCellsCount"]


def serve_paused(spkg, cpkg, golden_root, tmp_path, monkeypatch, peers,
                 **server_kw):
    """One deterministic served run: the engine is paused at turn 0, every
    peer in `peers` (controller keyword dicts; the first drives) attaches
    through a tap and syncs, then the driver resumes the run, which ends
    on its own. Returns the taps' recordings, each controller's events
    and final shadow board."""
    for P in PKG.values():  # peer tokens from 1 in both packages
        monkeypatch.setattr(P.srv._Conn, "_next_token",
                            itertools.count(1).__next__)
    server = make_server(spkg, golden_root, tmp_path, **server_kw)
    server._keys.put("p")
    server.start()
    taps, ctls, evs, threads = [], [], [], []
    try:
        wait_until(lambda: server.engine._paused, "the engine to pause")
        for kw in peers:
            tap = Tap(server.address)
            taps.append(tap)
            ctl = controller(cpkg, tap.address, **kw)
            ctls.append(ctl)
            assert ctl.wait_sync(WAIT)
            evs.append([])
            threads.append(drain(ctl, evs[-1]))
        ctls[0].send_key("p")
        join(*threads)
        assert server.wait(WAIT)
    finally:
        for c in ctls:
            c.close()
        server.shutdown()
        for tap in taps:
            tap.close()
    return {"down": [bytes(t.down) for t in taps], "events": evs,
            "boards": [None if c.board is None else c.board.copy()
                       for c in ctls],
            "out": tmp_path / "out"}


DRIVER = dict(want_flips=True, batch=True, batch_turns=16)
OBSERVER = dict(want_flips=True, observe=True)


@pytest.fixture(scope="module")
def oracle(golden_root, tmp_path_factory):
    """gol_tpu ↔ gol_tpu: the stream every other pairing must match."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GOL_TPU_CHECK_INVARIANTS", "1")
        return serve_paused("gol_tpu", "gol_tpu", golden_root,
                            tmp_path_factory.mktemp("oracle"), mp,
                            [DRIVER, OBSERVER], chunk=0)


@pytest.mark.parametrize("spkg,cpkg", PAIRINGS,
                         ids=[f"{s}-server-{c}-client" for s, c in PAIRINGS])
def test_pairings_see_the_same_stream(spkg, cpkg, oracle, golden_root,
                                      tmp_path, monkeypatch):
    if (spkg, cpkg) == ("gol_tpu", "gol_tpu"):
        got = oracle
    else:
        got = serve_paused(spkg, cpkg, golden_root, tmp_path, monkeypatch,
                           [DRIVER, OBSERVER], chunk=0)
    want = golden(golden_root)
    for board in got["boards"]:
        np.testing.assert_array_equal(board, want)
    assert (got["out"] / "64x64x100.pgm").read_bytes() == (
        golden_root / "check" / "images" / "64x64x100.pgm").read_bytes()
    for i in range(2):
        stream = decoded_stream(got["down"][i])
        assert stream == decoded_stream(oracle["down"][i]), f"peer {i}"
        assert bulk_frames(got["down"][i]) == bulk_frames(oracle["down"][i])
        assert (client_events(got["events"][i])
                == client_events(oracle["events"][i])), f"peer {i}"
    # The driver rode k-turn batch frames, the observer per-turn delta
    # frames; both started from a turn-0 board frame.
    kinds = [{m[0] if isinstance(m, tuple) else m.get("t")
              for m in decoded_stream(d)} for d in got["down"]]
    assert "fbatch" in kinds[0] and "dflips" in kinds[1]
    assert bulk_frames(got["down"][0])[0][0] == jw._TAG_BOARD


@pytest.mark.parametrize("pkg", ["gol_tpu_torch", "gol_tpu"])
def test_sync_waits_while_a_chunk_is_emitted(pkg, golden_root):
    """`_service_requests` answers counts at once but holds a sync while
    `_emitting`; at the boundary the BoardSync carries the COMMITTED
    world (never the in-flight chunk's) and turns flips on — the same in
    both engines."""
    eng_mod = {"gol_tpu": __import__("gol_tpu.engine.distributor",
                                     fromlist=["x"]),
               "gol_tpu_torch": td}[pkg]
    P = PKG[pkg]
    w0 = read_pgm(golden_root / "images" / "64x64.pgm")
    eng = eng_mod.Engine(
        P.Params(turns=100, image_width=64, image_height=64),
        emit_flips=False, emit_flip_batches=True, initial_world=w0,
        **P.extra)
    try:
        w5 = plain(w0, 5).copy()
        world = eng.stepper.put(w5)
        eng._committed = (5, world, eng.stepper.alive_count_async(world))
        # An in-flight chunk a sync must not read.
        eng._pending_diffs = {"k": 3,
                              "world": eng.stepper.put(plain(w0, 8).copy())}
        eng._emitting = True
        eng.request_board_sync(enable_flips=True, token=9)
        done, box = threading.Event(), {}
        eng._requests.append(("count", done, box))
        eng._service_requests()
        assert done.is_set() and box == {"turn": 5,
                                         "count": int((w5 != 0).sum())}
        assert eng.events.qsize() == 0 and not eng.emit_flips
        assert [r[0] for r in eng._requests] == ["sync"]
        eng._emitting = False
        eng._service_requests()
        (sync,) = [eng.events.get(timeout=WAIT)]
        assert type(sync).__name__ == "BoardSync"
        assert (sync.completed_turns, sync.token) == (5, 9)
        np.testing.assert_array_equal(sync.world, w5)
        assert eng.emit_flips and eng._requests == []
    finally:
        eng.io.stop()


def test_board_sync_in_the_pipelined_watched_path(golden_root, monkeypatch):
    """Syncs requested on the engine thread throughout a pipelined
    watched run — at every diff dispatch, while the chunk is in flight,
    and between a chunk's emitted rows — are each served once, at a
    chunk boundary: the committed turn (the last TurnComplete before it),
    equal to the board the stream has built and to the plain run, with
    the next flips for the turn after — no turn applied twice."""
    monkeypatch.setattr(td, "DIFF_CHUNK", 8)
    w0 = read_pgm(golden_root / "images" / "64x64.pgm")
    eng = td.Engine(TParams(turns=300, image_width=64, image_height=64,
                            tick_seconds=60.0),
                    emit_flip_batches=True, initial_world=w0, device="cpu")
    requested, served = [], []
    dispatch, emit, serve = (eng._diff_dispatch, eng._emit_turn_flips,
                             eng._service_requests)

    def dispatching(turn):
        requested.append(("dispatch", turn))
        eng.request_board_sync(enable_flips=True, token=len(requested))
        return dispatch(turn)

    def emitting(t, mask):
        if t % 5 == 0:
            assert eng._emitting
            requested.append(("emitting", t))
            eng.request_board_sync(enable_flips=True,
                                   token=len(requested))
        emit(t, mask)

    def servicing():
        if any(r[0] == "sync" for r in eng._requests) and not eng._emitting:
            served.append(eng._pending_diffs is not None)
        serve()

    eng._diff_dispatch = dispatching
    eng._emit_turn_flips = emitting
    eng._service_requests = servicing
    states = [np.asarray(w0)]
    for _ in range(300):
        states.append(np.asarray(jlife.step_n(states[-1], 1)))
    board = np.zeros((64, 64), np.uint8)
    last_turn, tokens = 0, []
    expect_next = None
    eng.start()
    try:
        for ev in eng.events:
            name = type(ev).__name__
            if name == "FlipBatch":
                if expect_next is not None:
                    assert ev.completed_turns == expect_next
                    expect_next = None
                board[ev.cells[:, 1], ev.cells[:, 0]] ^= 255
            elif name == "TurnComplete":
                assert ev.completed_turns == last_turn + 1 or last_turn == 0
                last_turn = ev.completed_turns
            elif name == "BoardSync":
                tokens.append(ev.token)
                assert ev.completed_turns == last_turn
                np.testing.assert_array_equal(ev.world, board)
                np.testing.assert_array_equal(ev.world, states[last_turn])
                expect_next = last_turn + 1
            elif name == "FinalTurnComplete":
                assert ev.completed_turns == 300
    finally:
        eng.join(WAIT)
    assert eng.error is None
    np.testing.assert_array_equal(board, states[300])
    assert sorted(tokens) == list(range(1, len(requested) + 1))
    assert {kind for kind, _ in requested} == {"dispatch", "emitting"}
    assert any(served), "no sync was served with a chunk in flight"


def _counter(kind):
    from gol_tpu_torch import obs

    m = obs.registry().get("gol_tpu_engine_dispatches_total",
                           {"kind": kind})
    return 0 if m is None else m.value


def test_attach_detach_reattach_matches_the_plain_run(golden_root,
                                                      tmp_path):
    """Headless, then watched, then headless again, on one run: a
    driver attaches with flips, detaches, an observer reattaches, and
    'k' ends the run on a snapshot equal to the plain run at its turn.
    The legs dispatch fused chunks, then diff chunks, then chunks."""
    server = make_server("gol_tpu_torch", golden_root, tmp_path,
                         turns=10**9, chunk=16)
    real = server.engine.stepper

    def slow_step_n(world, k):  # bound the headless rate: small turns
        time.sleep(0.002)
        return real.step_n(world, k)

    server.engine.stepper = dataclasses.replace(real, step_n=slow_step_n)
    legs = []

    def leg():
        legs.append((_counter("chunk"), _counter("diffs")))

    leg()
    server.start()
    ctls = []
    try:
        wait_until(lambda: server.engine.completed_turns >= 64, "headless")
        leg()
        drv = controller("gol_tpu_torch", server.address, want_flips=True,
                         batch=True, batch_turns=16)
        ctls.append(drv)
        assert drv.wait_sync(WAIT)
        sync_turn = drv.sync_turn
        # The board as the events build it (the shadow raster may run
        # ahead of the consumer): the sync's cells, then each turn's.
        mine = np.zeros((64, 64), np.uint8)
        for ev in drv.events:
            if type(ev).__name__ == "FlipBatch":
                mine[ev.cells[:, 1], ev.cells[:, 0]] ^= 255
            elif (type(ev).__name__ == "TurnComplete"
                  and ev.completed_turns == sync_turn + 200):
                break
        np.testing.assert_array_equal(
            mine, plain(read_pgm(golden_root / "images" / "64x64.pgm"),
                        sync_turn + 200))
        assert drv.detach(WAIT)
        leg()
        # The engine flushes its in-flight diff chunk, then goes back to
        # fused chunks: the next leg starts once it has.
        wait_until(lambda: _counter("chunk") >= legs[-1][0] + 2,
                   "fused chunks after detach")
        leg()
        t_detach = server.engine.completed_turns
        wait_until(lambda: server.engine.completed_turns >= t_detach + 64,
                   "headless after detach")
        leg()
        ob = controller("gol_tpu_torch", server.address, want_flips=True,
                        observe=True)
        ctls.append(ob)
        assert ob.wait_sync(WAIT) and ob.sync_turn > sync_turn + 200
        killer = controller("gol_tpu_torch", server.address,
                            want_flips=False)
        ctls.append(killer)
        assert killer.wait_sync(WAIT)
        killer.send_key("k")
        tail = []
        join(drain(ob, tail), drain(killer, []))
        assert server.wait(WAIT)
    finally:
        for c in ctls:
            c.close()
        server.shutdown()
    leg()
    (snap,) = [f for f in os.listdir(tmp_path / "out") if f.endswith(".pgm")]
    t_end = int(snap[:-4].split("x")[2])
    world = read_pgm(tmp_path / "out" / snap)
    np.testing.assert_array_equal(
        world, plain(read_pgm(golden_root / "images" / "64x64.pgm"), t_end))
    np.testing.assert_array_equal(ob.board, world)
    chunk = [b[0] - a[0] for a, b in zip(legs, legs[1:])]
    diffs = [b[1] - a[1] for a, b in zip(legs, legs[1:])]
    assert chunk[0] > 0 and diffs[0] == 0      # headless
    assert diffs[1] > 0                        # watched
    assert chunk[3] > 0 and diffs[3] == 0      # headless again
    assert diffs[4] > 0                        # the observer's leg


@pytest.mark.parametrize("cpkg", ["gol_tpu_torch", "gol_tpu"])
def test_kill_snapshot_then_resume(cpkg, golden_root, tmp_path):
    server = make_server("gol_tpu_torch", golden_root, tmp_path,
                         turns=10**9)
    server.start()
    try:
        ctl = controller(cpkg, server.address, want_flips=False)
        assert ctl.wait_sync(WAIT)
        ctl.send_key("k")
        evs = []
        join(drain(ctl, evs))
        assert server.wait(WAIT)
    finally:
        ctl.close()
        server.shutdown()
    (img,) = [e for e in evs if type(e).__name__ == "ImageOutputComplete"]
    snap = tmp_path / "out" / f"{img.filename}.pgm"
    t0 = img.completed_turns
    assert tsrv.snapshot_turn(str(snap)) == t0
    server2 = make_server("gol_tpu_torch", golden_root, tmp_path,
                          turns=t0 + 50, resume_from=str(snap))
    assert server2.engine.start_turn == t0
    server2.start()
    try:
        ctl2 = controller(cpkg, server2.address, want_flips=True,
                          batch=True)
        evs2 = []
        join(drain(ctl2, evs2))
        assert server2.wait(WAIT)
    finally:
        ctl2.close()
        server2.shutdown()
    (final,) = [e for e in evs2 if type(e).__name__ == "FinalTurnComplete"]
    expect = plain(read_pgm(snap), 50)
    assert final.completed_turns == t0 + 50
    assert {(c.x, c.y) for c in final.alive} == {
        (x, y) for y, x in zip(*np.nonzero(expect))}
    np.testing.assert_array_equal(ctl2.board, expect)


@pytest.mark.parametrize("cpkg", ["gol_tpu_torch", "gol_tpu"])
def test_driver_slot_secret_and_takeover(cpkg, golden_root, tmp_path):
    """A second driver bounces 'busy' with a retry hint, a wrong or
    missing secret is refused, observers steer nothing, and a detached
    driver's slot is taken over by a new driver that can steer."""
    C = PKG[cpkg].cli
    server = make_server("gol_tpu_torch", golden_root, tmp_path,
                         turns=10**9, secret="hunter2").start()
    ctls = []
    try:
        with pytest.raises(C.UnauthorizedError):
            controller(cpkg, server.address, want_flips=False,
                       secret="wrong")
        with pytest.raises(C.UnauthorizedError):
            controller(cpkg, server.address, want_flips=False)
        a = controller(cpkg, server.address, want_flips=True, batch=True,
                       secret="hunter2")
        ctls.append(a)
        assert a.wait_sync(WAIT)
        with pytest.raises(C.ServerBusyError) as ei:
            controller(cpkg, server.address, want_flips=False,
                       secret="hunter2")
        assert str(ei.value) == "busy" and ei.value.retry_after > 0
        ob = controller(cpkg, server.address, want_flips=False,
                        observe=True, secret="hunter2")
        ctls.append(ob)
        assert ob.wait_sync(WAIT)
        ob.send_key("k")  # refused: observers are read-only
        assert a.detach(WAIT)
        b = controller(cpkg, server.address, want_flips=True, batch=True,
                       secret="hunter2")
        ctls.append(b)
        assert b.wait_sync(WAIT)
        assert not server.done.is_set()
        last = b.sync_turn
        seen = 0
        for ev in b.events:
            if type(ev).__name__ == "TurnComplete":
                assert ev.completed_turns >= last
                last = ev.completed_turns
                seen += 1
                if seen >= 10:
                    break
        b.send_key("k")
        assert server.wait(WAIT)
        assert server.engine.error is None
    finally:
        for c in ctls:
            c.close()
        server.shutdown()


def _level_board(evs, shape):
    board = np.zeros(shape, np.uint8)
    for ev in evs:
        if type(ev).__name__ == "FlipBatch" and ev.levels is not None:
            board[ev.cells[:, 1], ev.cells[:, 0]] = ev.levels
    return board


@pytest.mark.parametrize("spkg", ["gol_tpu_torch", "gol_tpu"])
def test_generations_gray_levels_and_downgrade(spkg, golden_root, tmp_path,
                                               monkeypatch):
    """A B2/S/C3 server streams gray levels to a level-capable peer
    (equal to the snapshot PGM) and plain flips to a peer without the
    capability; the port server's streams equal gol_tpu's."""
    peers = [dict(want_flips=True, batch=True, levels=True),
             dict(want_flips=True, batch=True, observe=True)]
    got = serve_paused(spkg, "gol_tpu_torch", golden_root, tmp_path,
                       monkeypatch, peers, turns=40, rule="B2/S/C3")
    want = read_pgm(got["out"] / "64x64x40.pgm")
    np.testing.assert_array_equal(got["boards"][0], want)
    levels = [e for e in got["events"][0] if type(e).__name__ == "FlipBatch"]
    assert levels and all(e.levels is not None for e in levels)
    # The opening sync seeds the level board; then the levels apply.
    sync_board = read_pgm(golden_root / "images" / "64x64.pgm")
    board = sync_board.copy()
    for e in levels:
        board[e.cells[:, 1], e.cells[:, 0]] = e.levels
    np.testing.assert_array_equal(board, want)
    plainflips = [e for e in got["events"][1]
                  if type(e).__name__ == "FlipBatch" and len(e.cells)]
    assert plainflips and all(e.levels is None for e in plainflips)
    assert any(p[:1] == bytes([jw._TAG_LFLIPS])
               for p in frames(got["down"][0]))
    if spkg == "gol_tpu_torch":
        ref = serve_paused("gol_tpu", "gol_tpu_torch", golden_root,
                           tmp_path / "ref", monkeypatch, peers, turns=40,
                           rule="B2/S/C3")
        for i in range(2):
            assert decoded_stream(got["down"][i]) == decoded_stream(
                ref["down"][i])
            assert bulk_frames(got["down"][i]) == bulk_frames(ref["down"][i])


def test_attach_during_a_cold_first_dispatch(golden_root, tmp_path):
    """An attach while the engine sits in a long first dispatch (a cold
    kernel build on the card) is acked at once, heartbeats keep the
    client's read deadline alive through it, the sync follows, and the
    ticker's seeded turn-0 count is out within 5 s."""
    server = make_server("gol_tpu_torch", golden_root, tmp_path,
                         turns=1000, image_width=16, image_height=16,
                         chunk=500, tick_seconds=0.5, heartbeat_secs=0.5,
                         initial_world=np.zeros((16, 16), np.uint8))
    real = server.engine.stepper
    stall = threading.Event()

    def slow_step_n(world, k):
        if not stall.is_set():  # the first dispatch only
            stall.set()
            time.sleep(3.0)
        return real.step_n(world, k)

    server.engine.stepper = dataclasses.replace(real, step_n=slow_step_n)
    counts = []
    put = server.engine.events.put

    def recording_put(ev):
        if type(ev).__name__ == "AliveCellsCount":
            counts.append((time.monotonic(), ev.completed_turns))
        put(ev)

    server.engine.events.put = recording_put
    t_start = time.monotonic()
    server.start()
    try:
        assert stall.wait(WAIT), "engine never dispatched"
        t0 = time.monotonic()
        ctl = controller("gol_tpu_torch", server.address, want_flips=False,
                         timeout=2.0, reconnect=True)
        assert time.monotonic() - t0 < 2.0
        assert ctl.wait_sync(WAIT)
        assert ctl.board.shape == (16, 16) and ctl.reconnects == 0
        ctl.close()
    finally:
        server.shutdown()
    assert counts and counts[0][1] == 0 and counts[0][0] - t_start < 5.0


def test_injected_reset_is_survived_by_reconnect(golden_root, tmp_path):
    """GOL_TPU_FAULTS' grammar through `faults.install`: the client's
    40th socket read resets the link; the client re-dials, resyncs and
    ends on the golden board with the golden alive set."""
    faults.install(FaultPlan.parse("client:reset@recv:40"))
    server = make_server("gol_tpu_torch", golden_root, tmp_path, chunk=1,
                         heartbeat_secs=2.0).start()
    try:
        ctl = controller("gol_tpu_torch", server.address, want_flips=True,
                         reconnect=True, reconnect_seed=7, backoff_base=0.02,
                         backoff_cap=0.25, reconnect_window=WAIT)
        evs = []
        join(drain(ctl, evs))
        assert server.wait(WAIT)
    finally:
        ctl.close()
        server.shutdown()
    assert ctl.reconnects >= 1, "the injected reset never triggered"
    want = golden(golden_root)
    np.testing.assert_array_equal(ctl.board, want)
    final = [e for e in evs if type(e).__name__ == "FinalTurnComplete"]
    assert final and final[0].completed_turns == 100
    assert {(c.x, c.y) for c in final[0].alive} == {
        (x, y) for y, x in zip(*np.nonzero(want))}


def test_health_and_metrics_sidecar(golden_root, tmp_path):
    """`EngineServer.health` (host state only) behind the port's
    MetricsServer: /healthz, /metrics with the server's series, /vars."""
    import urllib.request

    from gol_tpu_torch.obs.http import MetricsServer

    server = make_server("gol_tpu_torch", golden_root, tmp_path,
                         turns=10**9).start()
    side = MetricsServer(port=0, health=server.health).start()
    try:
        ctl = controller("gol_tpu_torch", server.address, want_flips=False)
        assert ctl.wait_sync(WAIT)
        base = f"http://{side.address[0]}:{side.address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=WAIT) as r:
            info = json.loads(r.read())
        assert info["status"] == "ok" and info["driver_attached"]
        assert info["peers"] == 1 and info["completed_turns"] >= 0
        with urllib.request.urlopen(base + "/metrics", timeout=WAIT) as r:
            text = r.read().decode()
        assert "gol_tpu_server_attaches_total" in text
        assert "gol_tpu_engine_dispatches_total" in text
        with urllib.request.urlopen(base + "/vars", timeout=WAIT) as r:
            assert json.loads(r.read())
        ctl.send_key("k")
        assert server.wait(WAIT)
        assert server.health()["status"] == "shutting-down"
    finally:
        ctl.close()
        side.close()
        server.shutdown()


def _cli(*args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "gol_tpu_torch", *args],
        cwd=kw.get("cwd", REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL, text=True)


def _listen_port(proc):
    deadline = time.monotonic() + 30
    for line in proc.stdout:
        if line.startswith("engine serving on "):
            return int(line.rsplit(":", 1)[1])
        assert time.monotonic() < deadline
    raise AssertionError("server printed no address")


def test_cli_serve_connect_kill_and_resume_latest(golden_root, tmp_path):
    """`--serve 0 --platform cpu` with a `--connect --observe -noVis`
    process beside it, 'k' from a driver, then `--serve --resume latest`
    from that snapshot to a final board equal to the plain run."""
    common = ["-w", "64", "-h", "64", "--platform", "cpu", "--images",
              str(golden_root / "images"), "--out", str(tmp_path / "out")]
    srv = _cli("--serve", "0", "-turns", str(10**9), "--tick", "0.2",
               *common)
    try:
        port = _listen_port(srv)
        obs_proc = _cli("--connect", f"127.0.0.1:{port}", "--observe",
                        "-noVis", *common)
        head = []
        for line in obs_proc.stdout:  # attached: the ticker's counts print
            head.append(line)
            if line.startswith("Completed Turns"):
                break
        ctl = controller("gol_tpu_torch", ("127.0.0.1", port),
                         want_flips=False)
        assert ctl.wait_sync(WAIT)
        ctl.send_key("k")
        assert srv.wait(30) == 0
        out, _ = obs_proc.communicate(timeout=30)
        out = "".join(head) + out
        assert obs_proc.returncode == 0, out
        ctl.close()
    finally:
        for p in (srv,):
            if p.poll() is None:
                p.kill()
    (snap,) = [f for f in os.listdir(tmp_path / "out") if f.endswith(".pgm")]
    t0 = int(snap[:-4].split("x")[2])
    # The resumed server runs its 20 turns alone and exits.
    srv2 = _cli("--serve", "0", "-turns", str(t0 + 20), "--resume",
                "latest", *common)
    try:
        _listen_port(srv2)
        assert srv2.wait(30) == 0
    finally:
        if srv2.poll() is None:
            srv2.kill()
    final = read_pgm(tmp_path / "out" / f"64x64x{t0 + 20}.pgm")
    np.testing.assert_array_equal(final, plain(read_pgm(
        tmp_path / "out" / snap), 20))
    srv2.stdout.close()
    srv.stdout.close()
