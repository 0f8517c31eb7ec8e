"""The port's session plane (gol_tpu_torch/sessions/, the SessionServer
and SessionControl of gol_tpu_torch/distributed/) against gol_tpu's, on
the CPU.

The same numpy boards, made from seeds, go through both packages'
SessionManagers: a 16-session bucket turn for turn (each session's
delivered flip coordinates and boards equal, the compact path engaged),
the compact overflow redo, hibernation (park / rehydrate), the warm
bucket's census across create / destroy / checkpoint / park, bounded
metric children under churn, the checkpoint, manifest, sidecar and
tombstone files (byte-identical, the tombstone's wall-clock stamp set
aside), a port manager resuming a gol_tpu tree and the reverse, and the
wire: a port SessionServer with gol_tpu's SessionControl and
Controller(session=) and the reverse (every batch frame of a common turn
byte-identical, the boards equal to the plain run), rid replay and the
max-sessions retry_after. Runtime invariants and lockcheck are on for
every test; every socket wait is at most 10 s. Exact comparisons: the
automaton is integer-deterministic.
"""

import itertools
import json
import os
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

import gol_tpu.distributed as jdist
import gol_tpu.sessions as jsess
from gol_tpu import obs as jobs
from gol_tpu.analysis import invariants as jinv
from gol_tpu.analysis.concurrency import lockcheck as jlock
from gol_tpu.distributed import wire as jw
from gol_tpu.ops import life as jlife
from gol_tpu.params import Params as JParams
import gol_tpu_torch.distributed as tdist
import gol_tpu_torch.sessions as tsess
from gol_tpu_torch import obs as tobs
from gol_tpu_torch.params import Params as TParams
from gol_tpu_torch.sessions import manager as tman
from gol_tpu_torch.testing.leaks import lockcheck_guard

WAIT = 10.0  # every socket / thread wait in this file

PKG = {
    "gol_tpu": types.SimpleNamespace(
        sess=jsess, dist=jdist, obs=jobs, Params=JParams, extra={}),
    "gol_tpu_torch": types.SimpleNamespace(
        sess=tsess, dist=tdist, obs=tobs, Params=TParams,
        extra={"device": "cpu"}),
}
PAIRINGS = [("gol_tpu_torch", "gol_tpu_torch"), ("gol_tpu_torch", "gol_tpu"),
            ("gol_tpu", "gol_tpu_torch"), ("gol_tpu", "gol_tpu")]


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


def _soup(seed, side=64, density=0.3):
    rng = np.random.default_rng(seed)
    return ((rng.random((side, side)) < density) * 255).astype(np.uint8)


def plain(board, turns, rule="B3/S23"):
    """gol_tpu's dense step, in blocks of 16 turns and single turns."""
    w = np.asarray(board)
    for _ in range(turns // 16):
        w = jlife.step_n(w, 16, rule=rule)
    for _ in range(turns % 16):
        w = jlife.step_n(w, 1, rule=rule)
    return np.asarray(w)


def manager(pkg, tmp_path, **kw):
    P = PKG[pkg]
    return P.sess.SessionManager(out_dir=str(tmp_path / pkg), **kw,
                                 **P.extra)


class Recorder:
    """Shadow-raster sink recording every callback: the per-session
    stream both packages must deliver identically."""

    want_flips = True
    ephemeral = False
    batch_turns = 0

    def __init__(self):
        self.board = None
        self.log = []

    def on_sync(self, sid, turn, board):
        self.board = np.array(board)
        self.log.append(("sync", turn, self.board.tobytes()))

    def on_flips(self, sid, turn, coords):
        xy = np.asarray(coords).reshape(-1, 2)
        self.board[xy[:, 1], xy[:, 0]] ^= np.uint8(255)
        self.log.append(("flips", turn, xy.astype(np.int64).tobytes()))

    def on_flip_chunk(self, sid, first_turn, counts, bitmaps, words):
        raise AssertionError("per-turn sink got a chunk")

    def on_turn(self, sid, turn):
        self.log.append(("turn", turn))

    def on_close(self, sid, reason):
        self.log.append(("close", reason))


def _counter(pkg, name, **labels):
    return PKG[pkg].obs.registry().counter(name, labels=labels or None).value


# --- the bucket, turn for turn ---


def _sixteen(pkg, tmp_path):
    m = manager(pkg, tmp_path, bucket_capacity=16)
    sinks = {}
    for i in range(16):
        sid = f"s{i:02d}"
        # Low density: the boards settle within the first chunk, so the
        # adaptive cap engages and later chunks ride the compact path.
        m.create(sid, width=64, height=64,
                 board=_soup(100 + i, density=0.04))
        sinks[sid] = Recorder()
        m.attach(sid, sinks[sid])
    compact0 = _counter(pkg, "gol_tpu_session_dispatches_total",
                        path="compact")
    m.pump(48, chunk=8)
    compact = _counter(pkg, "gol_tpu_session_dispatches_total",
                       path="compact") - compact0
    boards = {sid: m.fetch_board(sid) for sid in sinks}
    return m, sinks, boards, compact


def test_sixteen_session_bucket_matches_gol_tpu_turn_for_turn(tmp_path):
    tm, tsinks, tboards, tcompact = _sixteen("gol_tpu_torch", tmp_path)
    jm, jsinks, jboards, jcompact = _sixteen("gol_tpu", tmp_path)
    assert tcompact == jcompact > 0
    assert len(tm._buckets) == 1
    for i, sid in enumerate(sorted(tsinks)):
        assert tsinks[sid].log == jsinks[sid].log, sid
        want = plain(_soup(100 + i, density=0.04), 48)
        assert np.array_equal(tboards[sid], want)
        assert np.array_equal(tboards[sid], jboards[sid])
        assert np.array_equal(tsinks[sid].board, want)
    assert tm.list_sessions() == jm.list_sessions()
    assert tm.health() == jm.health()


def _burst(pkg, tmp_path):
    m = manager(pkg, tmp_path, bucket_capacity=4)
    m.create("a", width=64, height=64, board=_soup(1, density=0.05))
    m.create("b", width=64, height=64, board=_soup(3, density=0.05))
    sink = Recorder()
    m.attach("a", sink)
    m.pump(16, chunk=8)  # quiet boards: a small cap locks in
    b = next(iter(m._buckets.values()))
    cap = b.compact_cap
    redos0 = _counter(pkg, "gol_tpu_session_compact_redos_total")
    burst = _soup(2, density=0.45)
    m._exec(lambda: b.__setattr__(
        "stack", b.bs.set_one(b.stack, m.get("a").slot, burst)))
    sink.board = np.array(burst)  # resync the shadow to the swap
    m.pump(8, chunk=8)
    redos = _counter(pkg, "gol_tpu_session_compact_redos_total") - redos0
    return cap, redos, sink, m.fetch_board("a"), m.fetch_board("b")


def test_compact_overflow_redo_matches_gol_tpu(tmp_path):
    """A dense soup swapped into a slot overflows the compact buffer:
    both packages redo the chunk from the pre-dispatch stack and deliver
    the same stream."""
    got = _burst("gol_tpu_torch", tmp_path)
    want = _burst("gol_tpu", tmp_path)
    assert got[0] == want[0] is not None
    assert got[1] == want[1] >= 1
    assert got[2].log == want[2].log
    oracle = plain(_soup(2, density=0.45), 8)
    assert np.array_equal(got[3], oracle) and np.array_equal(got[2].board,
                                                             oracle)
    assert np.array_equal(got[4], want[4])


def test_park_rehydrate_matches_gol_tpu(tmp_path):
    out = {}
    for pkg in PKG:
        m = manager(pkg, tmp_path, bucket_capacity=4)
        m.create("p", width=64, height=64, seed=11)
        m.create("q", width=64, height=64, seed=12)
        m.pump(20, chunk=10)
        r = m.park("p")
        m.pump(10, chunk=10)  # the parked board does not move
        sink = Recorder()
        m.attach("p", sink)  # rehydrates at the parked turn
        m.pump(6, chunk=3)
        out[pkg] = (r["turn"], sink.log, m.fetch_board("p"),
                    m.list_sessions(), m.is_parked("p"))
    t, j = out["gol_tpu_torch"], out["gol_tpu"]
    assert t[0] == j[0] == 20 and t[1] == j[1] and t[3] == j[3]
    assert np.array_equal(t[2], j[2])
    assert np.array_equal(t[2], plain(tman.seeded_board(64, 64, 11), 26))
    assert not t[4]


def test_warm_bucket_census_unchanged_over_the_lifecycle(tmp_path):
    """gol_tpu pins its jit cache here; the port's census of stacks: no
    new stack across create / destroy / checkpoint / park / rehydrate
    inside a warm bucket, and one new stepper only when it grows."""
    m = manager("gol_tpu_torch", tmp_path, bucket_capacity=4)
    m.create("warm", width=64, height=64, board=_soup(5, density=0.04))
    m.pump(8, chunk=8)
    sink = Recorder()
    m.attach("warm", sink)
    m.pump(24, chunk=8)
    b = next(iter(m._buckets.values()))
    warm = b.bs.cache_sizes()
    assert warm == {"stacks": [(4, 2, 64, "resident")]}
    for i in range(3):
        m.create(f"churn{i}", width=64, height=64, seed=i)
        m.pump(8, chunk=8)
        m.checkpoint(f"churn{i}")
        m.park(f"churn{i}")
        m.attach(f"churn{i}", Recorder())
        m.pump(8, chunk=8)
        m.destroy(f"churn{i}")
    assert b.bs.cache_sizes() == warm
    grows0 = _counter("gol_tpu_torch", "gol_tpu_session_bucket_grows_total")
    for i in range(4):
        m.create(f"g{i}", width=64, height=64, seed=20 + i)
    assert _counter("gol_tpu_torch",
                    "gol_tpu_session_bucket_grows_total") == grows0 + 1
    assert b.bs.cache_sizes() == {"stacks": [(8, 2, 64, "resident")]}
    m.pump(5, chunk=5)
    for i in range(4):
        assert np.array_equal(m.fetch_board(f"g{i}"),
                              plain(tman.seeded_board(64, 64, 20 + i), 5))


def test_metric_children_evicted_under_churn(tmp_path):
    m = manager("gol_tpu_torch", tmp_path)
    m.create("base", width=64, height=64, seed=1)
    m.pump(4, chunk=4)
    assert any('session="base"' in k for k in tobs.registry().snapshot())
    m.destroy("base")
    assert not any('session="base"' in k for k in tobs.registry().snapshot())
    baseline = len(tobs.registry().metrics())
    for i in range(12):
        m.create(f"churner-{i}", width=64, height=64, seed=i)
        m.pump(4, chunk=4)
        if i % 2:
            m.park(f"churner-{i}")
            m.attach(f"churner-{i}", Recorder())
        m.destroy(f"churner-{i}")
    assert len(tobs.registry().metrics()) == baseline


def test_metric_names_are_gol_tpus():
    """The plane-level series (per-session children aside) carry
    gol_tpu's names and labels."""
    def plane(reg):
        return {n for n in reg.snapshot()
                if n.startswith("gol_tpu_session") and 'session="' not in n}

    names = plane(jobs.registry())
    assert names and names == plane(tobs.registry())


def test_verb_refusals_match_gol_tpu(tmp_path):
    calls = [
        dict(sid="../escape", width=64, height=64),
        dict(sid="x", width=0, height=64),
        dict(sid="x", width=10**6, height=10**6),
        dict(sid="x", width=64, height=64, rule="Bnope"),
        dict(sid="x", width=64, height=64, rule="B0/S23"),
        dict(sid="x", width=64, height=64, rule="B2/S345/C4"),
    ]
    for pkg in PKG:
        m = manager(pkg, tmp_path)
        reasons = []
        for kw in calls:
            kw = dict(kw)
            with pytest.raises(PKG[pkg].sess.SessionError) as e:
                m.create(kw.pop("sid"), **kw)
            reasons.append(str(e.value))
        m.create("x", width=64, height=64)
        for fn in (lambda: m.create("x", width=64, height=64),
                   lambda: m.destroy("never"), lambda: m.park("never")):
            with pytest.raises(PKG[pkg].sess.SessionError) as e:
                fn()
            reasons.append(str(e.value))
        PKG[pkg].reasons = reasons
    assert PKG["gol_tpu_torch"].reasons == PKG["gol_tpu"].reasons
    assert tsess.valid_session_id("a.b-c_9") and not tsess.valid_session_id(
        "a/b")
    assert tman.MAX_SESSION_CELLS == jsess.manager.MAX_SESSION_CELLS
    assert tman.COMPACT_MIN_CAP == jsess.manager.COMPACT_MIN_CAP
    assert np.array_equal(tman.seeded_board(40, 48, 5, 0.3),
                          jsess.manager.seeded_board(40, 48, 5, 0.3))


# --- files on disk ---


def _lifecycle(pkg, tmp_path):
    m = manager(pkg, tmp_path, bucket_capacity=4)
    m.record_meta = {"keyframe_turns": 64}
    m.create("k1", width=64, height=64, board=_soup(31))
    m.create("k2", width=64, height=64, rule="B36/S23", seed=32,
             density=0.2)
    m.create("k3", width=96, height=64, seed=33)
    m.create("gone", width=64, height=64, seed=34)
    m.pump(20, chunk=5)
    for sid in ("k1", "k2"):
        m.checkpoint(sid)
    m.park("k3")
    m.destroy("gone")
    m.pump(7, chunk=7)
    return tmp_path / pkg / "sessions"


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            data = open(p, "rb").read()
            if f == ".tombstone":
                data = {k: v for k, v in json.loads(data).items()
                        if k != "ts"}
            out[os.path.relpath(p, root)] = data
    return out


def test_checkpoint_manifest_and_tombstone_files_match_gol_tpu(tmp_path):
    got = _tree(_lifecycle("gol_tpu_torch", tmp_path))
    want = _tree(_lifecycle("gol_tpu", tmp_path))
    assert sorted(got) == sorted(want)
    assert "manifest.json" in got and "gone/.tombstone" in got
    assert "k3/96x64x20.pgm" in got and "k2/session.json" in got
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("writer,reader", [("gol_tpu", "gol_tpu_torch"),
                                           ("gol_tpu_torch", "gol_tpu")])
def test_resume_all_across_packages(writer, reader, tmp_path):
    """One package's out/sessions tree (snapshots, a parked session, a
    tombstone, a never-checkpointed seeded session) resumed by the
    other's manager: the same live and parked set, the same boards."""
    root = _lifecycle(writer, tmp_path)
    m = PKG[reader].sess.SessionManager(out_dir=str(root.parent),
                                        bucket_capacity=4,
                                        **PKG[reader].extra)
    w = PKG[writer].sess.SessionManager(out_dir=str(root.parent),
                                        bucket_capacity=4,
                                        **PKG[writer].extra)
    assert m.resume_all() == 3
    infos = {s["id"]: s for s in m.list_sessions()}
    assert sorted(infos) == ["k1", "k2", "k3"]
    assert infos["k3"].get("parked") and infos["k2"]["rule"] == "B36/S23"
    assert infos["k1"]["turn"] == infos["k2"]["turn"] == 20
    boards = {sid: m.fetch_board(sid) for sid in ("k1", "k2")}
    assert np.array_equal(boards["k1"], plain(_soup(31), 20))
    m.pump(5, chunk=5)
    assert np.array_equal(m.fetch_board("k2"),
                          plain(boards["k2"], 5, rule="B36/S23"))
    m.attach("k3", Recorder())  # rehydrates the parked session
    assert np.array_equal(m.fetch_board("k3"), plain(
        jsess.manager.seeded_board(64, 96, 33), 20))
    del w


def test_engine_thread_services_verbs_and_streams(tmp_path):
    m = manager("gol_tpu_torch", tmp_path, bucket_capacity=4)
    eng = tsess.SessionEngine(m, watched_chunk=4, idle_chunk=16).start()
    try:
        m.create("live", width=64, height=64, board=_soup(40))
        sink = Recorder()
        m.attach("live", sink)
        deadline = time.monotonic() + WAIT
        while (sum(e[0] == "turn" for e in sink.log) < 20
               and time.monotonic() < deadline):
            time.sleep(0.01)
        info = m.checkpoint("live")
        assert info["turn"] >= 20
        m.detach("live", sink)
        turns = [e[1] for e in sink.log if e[0] == "turn"]
        start = sink.log[0][1]
        assert turns == list(range(start + 1, start + 1 + len(turns)))
        assert np.array_equal(sink.board, plain(_soup(40), turns[-1]))
    finally:
        eng.stop()
        eng.join(WAIT)
        m.close()
    assert not eng.running() and eng.error is None


# --- the wire ---


def session_server(pkg, tmp_path, **kw):
    P = PKG[pkg]
    params = P.Params(turns=10**9, image_width=64, image_height=64,
                      out_dir=str(tmp_path / f"srv-{pkg}"))
    kw.setdefault("watched_chunk", 16)
    kw.setdefault("idle_chunk", 16)
    return P.dist.SessionServer(params, port=0, **kw, **P.extra)


class Tap:
    """A loopback proxy recording the server→client bytes."""

    def __init__(self, upstream):
        self.upstream = tuple(upstream[:2])
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self._lsock.settimeout(WAIT)
        self.address = self._lsock.getsockname()
        self.down = bytearray()
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
            if buf is not None:
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
        for args in ((c, u, None), (u, c, self.down)):
            t = threading.Thread(target=self._pump, args=args, daemon=True)
            t.start()
            self._threads.append(t)

    def close(self):
        self._lsock.close()
        for s in self._socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in self._threads[1:]:
            t.join(WAIT)
        for s in self._socks:
            s.close()


def frames(raw: bytes) -> list:
    out, i = [], 0
    while i + 4 <= len(raw):
        n = int.from_bytes(raw[i:i + 4], "big")
        if i + 4 + n > len(raw):
            break  # the tap closed mid-frame
        out.append(bytes(raw[i + 4:i + 4 + n]))
        i += 4 + n
    return out


def served(spkg, cpkg, tmp_path, monkeypatch, turns=96):
    """A session created and watched over the wire: `cpkg`'s
    SessionControl creates it on `spkg`'s server, `cpkg`'s batching
    driver watches it through a tap until `turns` turns past its sync.
    Returns (create reply, sync turn, board frame payload, {first turn:
    batch frame payload}, the driver's final board and turn)."""
    for P in PKG.values():  # peer tokens from 1 in both packages
        monkeypatch.setattr(P.dist.server._Conn, "_next_token",
                            itertools.count(1).__next__)
    C = PKG[cpkg].dist
    srv = session_server(spkg, tmp_path).start()
    tap = None
    try:
        with C.SessionControl(*srv.address, timeout=WAIT) as sc:
            info = sc.create("w1", width=64, height=64, seed=77)
        tap = Tap(srv.address)
        drv = C.Controller(*tap.address, session="w1", want_flips=True,
                           batch=True, batch_turns=16, timeout=WAIT,
                           reconnect=False)
        try:
            assert drv.wait_sync(WAIT)
            sync = drv.sync_turn
            deadline = time.monotonic() + WAIT
            last = sync
            # The consumed stream's shadow (the sync replays as a flip
            # burst against zeros): exactly at `last` when the loop
            # stops, unlike `drv.board`, which the reader keeps moving.
            board = np.zeros((64, 64), bool)
            for ev in drv.events:
                if type(ev).__name__ == "FlipBatch" and len(ev.cells):
                    xy = np.asarray(ev.cells).reshape(-1, 2)
                    board[xy[:, 1], xy[:, 0]] ^= True
                if type(ev).__name__ == "TurnComplete":
                    last = ev.completed_turns
                    if last >= sync + turns:
                        break
                assert time.monotonic() < deadline, "no stream progress"
            drv.detach(WAIT)
        finally:
            drv.close()
    finally:
        srv.shutdown()
        if tap is not None:
            tap.close()
    board_frame, batches = None, []
    for p in frames(bytes(tap.down)):
        if p[:1] == bytes([jw._TAG_BOARD]) and board_frame is None:
            board_frame = p
        elif p[:1] == bytes([jw._TAG_FBATCH]):
            batches.append(p)
    return info, sync, board_frame, batches, (board, last)


def expected_batch_frame(plain_boards, payload):
    """gol_tpu's own encoding (`encode_batch_frames`) of the plain run's
    turns that a received batch frame covers, stamped with the received
    frame's `ts` — the bytes the frame must be."""
    from gol_tpu.distributed.server import encode_batch_frames
    from gol_tpu.ops.bitlife import pack_np
    from gol_tpu.parallel.stepper import sparse_chunk_from_dense

    msg = jw._parse_frame(payload)
    first, k = msg["first_turn"], msg["k"]
    packed = [pack_np(plain_boards[t]) for t in range(first - 1, first + k)]
    diffs = np.stack([packed[i] ^ packed[i + 1] for i in range(k)])
    (frame,) = encode_batch_frames(*sparse_chunk_from_dense(diffs), first,
                                   64, 64, k, msg["ts"])
    return frame


@pytest.mark.parametrize("spkg,cpkg", PAIRINGS,
                         ids=[f"{s}-server-{c}-client" for s, c in PAIRINGS])
def test_session_pairings_see_the_same_stream(spkg, cpkg, tmp_path,
                                              monkeypatch):
    """Every pairing of server and client packages: the create reply is
    gol_tpu's, the attach sync frame holds the plain run's board at its
    turn, every batch frame on the link is byte for byte gol_tpu's
    encoding of the plain run's turns (its wall-clock stamp taken from
    the frame), and the consumed stream lands on the plain board. The
    server free-runs, so the sync turn differs between runs; the bytes
    of a given turn do not."""
    info, sync, board_frame, batches, (board, last) = served(
        spkg, cpkg, tmp_path, monkeypatch)
    assert info == {"id": "w1", "width": 64, "height": 64,
                    "rule": "B3/S23", "turn": 0, "watchers": 0,
                    "bucket": "64x64/B3/S23"}
    b0 = tman.seeded_board(64, 64, 77)
    top = max([last] + [jw._parse_frame(p)["first_turn"]
                        + jw._parse_frame(p)["k"] for p in batches])
    boards = [b0]
    for _ in range(top):
        boards.append(np.asarray(jlife.step_n(boards[-1], 1)))
    # The attach sync is the board at its turn (a dispatch boundary).
    assert sync % 16 == 0
    sync_msg = jw._parse_frame(board_frame)
    assert sync_msg["turn"] == sync
    assert np.array_equal(sync_msg["world"] != 0, boards[sync] != 0)
    assert np.array_equal(board, boards[last] != 0)
    assert len(batches) >= 6
    firsts = [jw._parse_frame(p)["first_turn"] for p in batches]
    assert firsts == list(range(sync + 1, sync + 1 + 16 * len(firsts), 16))
    for p in batches:
        assert p == expected_batch_frame(boards, p)


def _raw_verb(address, msg):
    s = socket.create_connection(tuple(address[:2]), timeout=WAIT)
    s.settimeout(WAIT)
    try:
        jw.send_msg(s, {"t": "hello", "want_flips": False})
        while True:
            r = jw.recv_msg(s)
            if r.get("t") == "session-r" or r.get("t") == "error":
                break
            if r.get("t") == "hello" or r.get("t") in ("hb", "clk"):
                jw.send_msg(s, msg)
        return r
    finally:
        s.close()


def test_rid_replay_and_max_sessions_match_gol_tpu(tmp_path):
    """A retried create (same rid) answers its recorded reply, and an
    over-budget create answers max-sessions with a retry_after hint,
    the same on both servers."""
    replies = {}
    for pkg in PKG:
        srv = session_server(pkg, tmp_path, max_sessions=1,
                             retry_after_secs=0.25).start()
        try:
            with PKG["gol_tpu"].dist.SessionControl(
                    *srv.address, timeout=WAIT, retry_window=0) as sc:
                create = {"t": "session", "op": "create", "id": "one",
                          "width": 64, "height": 64, "seed": 1,
                          "density": 0.25, "rid": "rid-1"}
                first = sc._rpc(create)
                again = sc._rpc(create)
                over = sc._rpc({**create, "id": "two", "rid": "rid-2"})
                listed = sc._rpc({"t": "session", "op": "list"})
        finally:
            srv.shutdown()
        assert again == first and first["ok"]
        replies[pkg] = (first, over, [s["id"] for s in listed["sessions"]])
    assert replies["gol_tpu_torch"] == replies["gol_tpu"]
    assert replies["gol_tpu"][1]["reason"] == "max-sessions"
    assert replies["gol_tpu"][1]["retry_after"] == 0.25
