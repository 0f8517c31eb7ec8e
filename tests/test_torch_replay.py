"""The port's replay plane (gol_tpu_torch/replay/: the segment log, the
recorder, the replay server and the seek verb) against gol_tpu's, on the
CPU, and the CLI's session and replay flags.

The same session, made from a seed, is recorded by both packages: the
segment names and every record decode equal once the wall-clock stamps
are set aside, and `board_at` lands on the plain run at every sampled
turn, inside frames too. A log recorded by the port is served by
gol_tpu's ReplayServer and the reverse, and a cold client's seek lands on
the plain board. Also: seek idempotent under rid replay and bounded by
one keyframe interval, the recorder ephemeral across park, a re-created
id dropping the dead incarnation's log, the sidecar's recording state,
and the CLI's flags, guards and serve paths (`--serve --sessions
--record`, `--connect --session`, `--replay`) in subprocesses. Runtime
invariants and lockcheck are on; every socket wait is at most 10 s.
"""

import ast
import os
import pathlib
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import gol_tpu.distributed.client as jcli
import gol_tpu.replay.log as jlog
import gol_tpu.replay.recorder as jrec
import gol_tpu.replay.server as jrs
import gol_tpu.sessions.manager as jman
from gol_tpu.analysis import invariants as jinv
from gol_tpu.analysis.concurrency import lockcheck as jlock
from gol_tpu.distributed import wire as jw
from gol_tpu.ops import life as jlife
import gol_tpu_torch.distributed.client as tcli
import gol_tpu_torch.replay.log as tlog
import gol_tpu_torch.replay.recorder as trec
import gol_tpu_torch.replay.server as trs
import gol_tpu_torch.sessions.manager as tman
from gol_tpu_torch import cli
from gol_tpu_torch.checkpoint import session_checkpoint_dir
from gol_tpu_torch.testing.leaks import lockcheck_guard

REPO = pathlib.Path(__file__).resolve().parent.parent
WAIT = 10.0  # every socket / thread wait in this file
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}

PKG = {
    "gol_tpu": types.SimpleNamespace(man=jman, log=jlog, rec=jrec, rs=jrs,
                                     cli=jcli, extra={}),
    "gol_tpu_torch": types.SimpleNamespace(man=tman, log=tlog, rec=trec,
                                           rs=trs, cli=tcli,
                                           extra={"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _guards(monkeypatch):
    j_inv, j_lock = jinv.violations_total(), jlock.reports_total()
    yield from lockcheck_guard(monkeypatch)
    assert jinv.violations_total() == j_inv
    assert jlock.reports_total() == j_lock


def plain_boards(seed, turns, side=64):
    """The plain run's board at every turn 0..turns (gol_tpu's step)."""
    boards = [tman.seeded_board(side, side, seed)]
    for _ in range(turns):
        boards.append(np.asarray(jlife.step_n(boards[-1], 1)))
    return boards


def record(pkg, out_dir, *, side=64, seed=7, turns=300, chunk=30,
           keyframe_turns=64):
    """An inline-manager recording (no engine thread) by `pkg`: returns
    the replay dir and {turn: board} at every chunk boundary."""
    P = PKG[pkg]
    m = P.man.SessionManager(out_dir=str(out_dir), bucket_capacity=4,
                             **P.extra)
    m.create("s1", width=side, height=side, seed=seed)
    d = P.log.replay_dir(os.path.join(str(out_dir), "sessions", "s1"))
    log = P.log.SegmentLog(d, keyframe_turns=keyframe_turns)
    rec = P.rec.RecorderSink(m, "s1", side, side, log)
    m.attach("s1", rec)
    oracle = {0: m.fetch_board("s1").copy()}
    done = 0
    while done < turns:
        m.pump(chunk, chunk=chunk)
        done += chunk
        oracle[m.peek_turn("s1")] = m.fetch_board("s1").copy()
    m.detach("s1", rec)
    rec.on_close("s1", "done")
    return d, oracle


def _decoded(payload):
    msg = jw._parse_frame(payload)
    msg.pop("ts", None)
    return {k: (v.tobytes() if isinstance(v, np.ndarray) else v)
            for k, v in msg.items()}


def test_recordings_decode_equal_across_packages(tmp_path):
    td, toracle = record("gol_tpu_torch", tmp_path / "t")
    jd, joracle = record("gol_tpu", tmp_path / "j")
    tsegs, jsegs = tlog.scan_segments(td), jlog.scan_segments(jd)
    assert [t for t, _ in tsegs] == [t for t, _ in jsegs]
    assert tsegs[0][0] == 0  # taped from birth
    for (_, tp), (_, jp) in zip(tsegs, jsegs):
        trecs, jrecs = tlog.read_records(tp), jlog.read_records(jp)
        assert [_decoded(p) for _, p in trecs] == [
            _decoded(p) for _, p in jrecs]
    assert sorted(toracle) == sorted(joracle)
    for t in toracle:
        assert np.array_equal(toracle[t], joracle[t])
    assert tlog.last_turn(td) == jlog.last_turn(jd) == 300


def test_board_at_matches_the_plain_run(tmp_path):
    """Turns at chunk boundaries and inside recorded frames (the partial
    apply), read by both packages' `board_at` from the port's log."""
    d, oracle = record("gol_tpu_torch", tmp_path, turns=120, chunk=40)
    boards = plain_boards(7, 120)
    for turn in (0, 1, 17, 39, 40, 41, 63, 64, 65, 97, 120):
        for log in (tlog, jlog):
            landed, got = log.board_at(d, turn)
            assert landed == turn
            assert np.array_equal(got != 0, boards[turn] != 0), turn


def test_seek_frames_lands_within_keyframe_interval(tmp_path):
    d, _ = record("gol_tpu_torch", tmp_path, turns=300, chunk=25,
                  keyframe_turns=64)
    for want in (0, 1, 40, 130, 299, 300):
        k, landed, payloads = tlog.seek_frames(d, want)
        assert (k, landed) == jlog.seek_frames(d, want)[:2]
        assert k <= want <= landed < want + 64 + 25
        assert payloads[0][0] == jw._TAG_BOARD  # a keyframe first
    assert tlog.seek_frames(d, 10 ** 9)[1] == 300


def _cold_seek(spkg, cpkg, root, turn):
    """A cold client of `cpkg` on `spkg`'s replay server: it syncs, seeks
    to `turn`, and reads its board."""
    S, C = PKG[spkg], PKG[cpkg]
    srv = S.rs.ReplayServer(str(root), port=0, replay_rate=0).start()
    try:
        ctl = C.cli.Controller(*srv.address, want_flips=True, batch=True,
                               batch_turns=1024, batch_flip_events=False,
                               observe=True, timeout=WAIT, reconnect=False)
        try:
            assert ctl.wait_sync(WAIT)
            r = ctl.seek(turn, timeout=WAIT)
            assert r["ok"], r
            again = ctl.seek(turn, timeout=WAIT, rid=r["rid"])
            deadline = time.monotonic() + WAIT
            want = S.log.board_at(root / "s1" / "replay", r["turn"])[1]
            while (time.monotonic() < deadline
                   and not np.array_equal(ctl.board != 0, want != 0)):
                time.sleep(0.02)
            return r, again, ctl.board.copy()
        finally:
            ctl.close()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("writer,server", [("gol_tpu_torch", "gol_tpu"),
                                           ("gol_tpu", "gol_tpu_torch")])
def test_recording_served_by_the_other_package(writer, server, tmp_path):
    """A log one package recorded, served by the other package's replay
    server to its own client: the seek lands within one keyframe
    interval, answers a rid retry verbatim, and the board is the plain
    run's at the landed turn."""
    record(writer, tmp_path, turns=240, chunk=30, keyframe_turns=64)
    boards = plain_boards(7, 240)
    r, again, board = _cold_seek(server, server, tmp_path / "sessions", 100)
    assert r["keyframe"] <= 100 <= r["turn"] < 100 + 64 + 30
    assert again == r
    assert np.array_equal(board != 0, boards[r["turn"]] != 0)


def test_seek_replies_match_across_servers(tmp_path):
    """The same recording behind both packages' replay servers, with
    the port's client on gol_tpu's and the reverse: equal replies (rid
    aside), equal boards."""
    record("gol_tpu_torch", tmp_path, turns=180, chunk=30, keyframe_turns=32)
    out = [_cold_seek(s, c, tmp_path / "sessions", 77)
           for s, c in (("gol_tpu", "gol_tpu_torch"),
                        ("gol_tpu_torch", "gol_tpu"))]
    strip = [{k: v for k, v in r.items() if k != "rid"} for r, _, _ in out]
    assert strip[0] == strip[1]
    assert np.array_equal(out[0][2], out[1][2])


def test_live_seek_on_a_recording_session_server(tmp_path):
    """The port's SessionServer with record=True: a driver seeks into
    its own session's history (the board is the plain run's at the
    landed turn), rejoins live, and the manager's tree then serves a
    cold client of gol_tpu's replay server."""
    from gol_tpu_torch.distributed import (Controller, SessionControl,
                                           SessionServer)
    from gol_tpu_torch.params import Params

    p = Params(turns=10**9, image_width=64, image_height=64,
               out_dir=str(tmp_path))
    srv = SessionServer(p, port=0, device="cpu", record=True,
                        keyframe_turns=32, watched_chunk=16,
                        idle_chunk=16).start()
    boards = plain_boards(7, 64)
    try:
        with SessionControl(*srv.address, timeout=WAIT) as sc:
            sc.create("s1", width=64, height=64, seed=7)
        drv = Controller(*srv.address, session="s1", want_flips=True,
                         batch=True, batch_turns=16, timeout=WAIT,
                         reconnect=False)
        try:
            assert drv.wait_sync(WAIT)
            r = drv.seek(40, timeout=WAIT)
            assert r["ok"] and r["keyframe"] <= 40 <= r["turn"], r
            deadline = time.monotonic() + WAIT
            while (time.monotonic() < deadline and not np.array_equal(
                    drv.board != 0, boards[r["turn"]] != 0)):
                time.sleep(0.02)
            assert np.array_equal(drv.board != 0, boards[r["turn"]] != 0)
            assert drv.seek("live", timeout=WAIT)["ok"]
        finally:
            drv.close()
    finally:
        srv.shutdown()
    r, _, board = _cold_seek("gol_tpu", "gol_tpu", tmp_path / "sessions", 50)
    assert np.array_equal(board != 0, boards[r["turn"]] != 0)


def test_recorder_is_ephemeral_for_park_and_rearms(tmp_path):
    closed = []
    m = tman.SessionManager(out_dir=str(tmp_path), bucket_capacity=4,
                            device="cpu")
    d = tlog.replay_dir(os.path.join(session_checkpoint_dir(str(tmp_path)),
                                     "p1"))

    def factory(sid, w, h):
        return trec.RecorderSink(m, sid, w, h,
                                 tlog.SegmentLog(d, keyframe_turns=32),
                                 on_closed=lambda s, r: closed.append(r))

    m.recorder_factory = factory
    m.create("p1", width=64, height=64, seed=9)
    m.pump(64, chunk=32)
    turn = m.peek_turn("p1")
    board = m.fetch_board("p1").copy()
    assert m.park("p1")["turn"] == turn  # the recorder does not block it
    assert closed == ["parked"] and m.is_parked("p1")

    class Probe:
        want_flips = False
        batch_turns = 0

        def on_sync(self, sid, t, b):
            self.turn, self.board = t, np.array(b)

        def on_flips(self, *a):
            pass

        def on_turn(self, *a):
            pass

        def on_close(self, *a):
            pass

    probe = Probe()
    m.attach("p1", probe)  # rehydrates and re-arms the recorder
    assert probe.turn == turn and np.array_equal(probe.board, board)
    assert any(t == turn for t, _ in tlog.scan_segments(d))
    assert np.array_equal(tlog.board_at(d, turn)[1] != 0, board != 0)


def test_recreated_id_drops_dead_incarnations_recording(tmp_path):
    m = tman.SessionManager(out_dir=str(tmp_path), bucket_capacity=4,
                            device="cpu")
    d = tlog.replay_dir(os.path.join(session_checkpoint_dir(str(tmp_path)),
                                     "z1"))
    m.recorder_factory = lambda sid, w, h: trec.RecorderSink(
        m, sid, w, h, tlog.SegmentLog(d, keyframe_turns=32))
    m.create("z1", width=64, height=64, seed=1)
    m.pump(64, chunk=32)
    assert tlog.scan_segments(d)
    m.destroy("z1")
    m.create("z1", width=64, height=64, seed=2)
    assert [t for t, _ in tlog.scan_segments(d)] == [0]
    assert np.array_equal(tlog.board_at(d, 0)[1] != 0,
                          tman.seeded_board(64, 64, 2) != 0)


def test_session_json_carries_recording_state(tmp_path):
    sides = []
    for pkg in PKG:
        P = PKG[pkg]
        m = P.man.SessionManager(out_dir=str(tmp_path / pkg),
                                 bucket_capacity=4, **P.extra)
        m.record_meta = {"keyframe_turns": 64}
        m.create("s1", width=64, height=64, seed=7)
        m.checkpoint("s1")
        sides.append((tmp_path / pkg / "sessions" / "s1"
                      / "session.json").read_bytes())
    assert sides[0] == sides[1] and b'"record": {"keyframe_turns": 64}' in sides[0]


# --- the CLI ---


def _gol_tpu_messages() -> set:
    """Every string constant of gol_tpu's CLI (adjacent literals are
    joined by the parser): the guards' messages the port keeps."""
    tree = ast.parse((REPO / "gol_tpu" / "cli.py").read_text())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


@pytest.mark.parametrize("argv", [
    ["--serve", "0", "--record"],
    ["--serve", "0", "--sessions", "--keyframe-turns", "5"],
    ["--serve", "0", "--sessions", "--record-max-bytes", "5"],
    ["--serve", "0", "--replay-rate", "0"],
    ["--replay", "/x"],
    ["--replay", "/x", "--serve", "0", "--sessions"],
    ["--replay", "/x", "--serve", "0", "--connect", "localhost:1"],
    ["--replay", "/x", "--serve", "0", "--tile", "64"],
    ["--replay", "/x", "--serve", "0", "--resume", "latest"],
    ["--serve", "0", "--sessions", "--tile", "64"],
    ["--sessions"],
    ["--serve", "0", "--sessions", "--resume", "x.pgm"],
    ["--session", "s1"],
    ["--serve", "0", "--park-idle-secs", "1"],
], ids=lambda a: " ".join(a))
def test_cli_guards_keep_gol_tpus_messages(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["-noVis", "--platform", "cpu"])
    msg = str(e.value)
    assert msg.startswith("error: ")
    assert msg in _gol_tpu_messages(), msg


def test_cli_replay_without_recordings_errors(tmp_path):
    with pytest.raises(SystemExit, match="no recordings under"):
        cli.main(["--replay", str(tmp_path), "--serve", "127.0.0.1:0",
                  "-noVis", "--platform", "cpu"])


def _spawn(*args, cwd):
    proc = subprocess.Popen(
        [sys.executable, "-m", "gol_tpu_torch", *args], cwd=cwd, env=ENV,
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    proc.lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            proc.lines.put(line)

    threading.Thread(target=pump, daemon=True).start()
    return proc


def _address(proc, prefix):
    deadline = time.monotonic() + 3 * WAIT
    while time.monotonic() < deadline:
        try:
            line = proc.lines.get(timeout=0.1)
        except queue.Empty:
            assert proc.poll() is None, proc.stderr.read()
            continue
        m = re.match(prefix + r" on ([\d.]+):(\d+)", line)
        if m:
            return m.group(1), int(m.group(2))
    raise AssertionError(f"no {prefix!r} line in time")


def _stop(proc):
    """SIGINT, as a terminal's ^C: the process shuts down and exits 0."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        rc = proc.wait(WAIT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(WAIT)
        raise AssertionError("the process did not end on SIGINT")
    return rc


def _until(pred, what):
    deadline = time.monotonic() + WAIT
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def test_cli_sessions_record_connect_and_replay(tmp_path):
    """`--serve 0 --sessions --record`, a session created over the wire,
    a `--connect --session` process attached to it (the server counts
    its watcher); then `--replay out/sessions --serve 0 --replay-rate 0`
    and a `--connect --session --observe` process on it. Every process
    ends on SIGINT, the servers with exit code 0."""
    from gol_tpu_torch.distributed import SessionControl

    out = tmp_path / "out"
    srv = _spawn("--serve", "0", "--sessions", "--record",
                 "--keyframe-turns", "64", "--platform", "cpu", "--out",
                 str(out), cwd=tmp_path)
    procs = [srv]
    try:
        addr = _address(srv, "session engine serving")
        with SessionControl(*addr, timeout=WAIT) as sc:
            sc.create("c1", width=64, height=64, seed=3)
            con = _spawn("--connect", f"{addr[0]}:{addr[1]}", "--session",
                         "c1", "-noVis", "--platform", "cpu", cwd=tmp_path)
            procs.append(con)
            _until(lambda: sc.list()[0]["watchers"] == 1, "the attach")
            turn = sc.list()[0]["turn"]
            _until(lambda: sc.list()[0]["turn"] > turn + 64, "turns")
            assert con.poll() is None, con.stderr.read()
            _stop(con)  # a controller ends on ^C by KeyboardInterrupt
            _until(lambda: sc.list()[0]["watchers"] == 0, "the detach")
        assert _stop(srv) == 0, srv.stderr.read()
        assert tlog.scan_segments(out / "sessions" / "c1" / "replay")
        rep = _spawn("--replay", str(out / "sessions"), "--serve", "0",
                     "--replay-rate", "0", "--platform", "cpu",
                     cwd=tmp_path)
        procs.append(rep)
        addr = _address(rep, "replay serving")
        con = _spawn("--connect", f"{addr[0]}:{addr[1]}", "--session", "c1",
                     "-noVis", "--observe", "--platform", "cpu",
                     cwd=tmp_path)
        procs.append(con)
        time.sleep(1.0)
        assert con.poll() is None, con.stderr.read()
        _stop(con)
        assert _stop(rep) == 0, rep.stderr.read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(WAIT)
