"""The port's fleet controller against gol_tpu's, on the CPU.

- SPEC: every malformed field is refused with the same `SpecError`
  message, and the defaults and loaded specs are equal.
- MANIFEST: a `ControllerManifest` written by either package (two-phase
  migration records, aborts, spawn and roll registries) is read back by
  the other to the same state, and garbage reads as a fresh controller
  in both.
- DECISIONS: both packages' `Controller`s, fed the same scraped rows
  under the same injected clock and seed, plan and apply the same heal,
  scale (drain-then-kill, history-driven grow / hold / shrink), budget,
  backoff, staleness and placement decisions, with the same calls into
  the spawn / re-point / terminate legs.
- DATA PLANE: either package's `repoint_relay` re-points a port relay,
  whose downstream resyncs bit-exactly from the new upstream; either
  package's controller resumes a crashed migration between two port
  session servers; a port controller process heals a SIGKILLed relay
  by spawning `python -m gol_tpu_torch --relay`.
"""

import contextlib
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import gol_tpu.control as jctl
import gol_tpu.control.controller as jmod
from gol_tpu.distributed import wire as jw
from gol_tpu_torch.distributed import wire as tw
import gol_tpu_torch.control as tctl
import gol_tpu_torch.control.controller as tmod
from gol_tpu_torch.testing.leaks import lockcheck_guard

REPO = pathlib.Path(__file__).resolve().parent.parent
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
WAIT = 10.0

PKG = {
    "gol_tpu": types.SimpleNamespace(ctl=jctl, mod=jmod),
    "gol_tpu_torch": types.SimpleNamespace(ctl=tctl, mod=tmod),
}
NAMES = list(PKG)
PAIRINGS = [(a, b) for a in NAMES for b in NAMES]


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


def _wait(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# --- spec -----------------------------------------------------------------

ROOT = "127.0.0.1:8100"


@pytest.mark.parametrize("raw", [
    {},
    {"root": "nocolon"},
    {"root": ROOT, "scrape": "9100"},
    {"root": ROOT, "secret": 7},
    {"root": ROOT, "relays": {"min": 4, "max": 2}},
    {"root": ROOT, "relays": {"observers_per_relay": 0}},
    {"root": ROOT, "engines": [{"addr": "bad"}]},
    {"root": ROOT, "engines": [{"addr": "127.0.0.1:8030"}]},
    {"root": ROOT, "engines": [{"addr": "127.0.0.1:8030", "out": "o",
                                "args": "x"}]},
    {"root": ROOT, "engines": [{"addr": "127.0.0.1:8030", "out": "a"},
                               {"addr": "127.0.0.1:8030", "out": "b"}]},
    {"root": ROOT, "sessions": {"s1": "127.0.0.1:9999"}},
    {"root": ROOT, "interval_secs": 0},
    {"root": ROOT, "actions_per_round": 0},
    {"root": ROOT, "heal_alerts": [3]},
    {"root": ROOT, "canary_max_age_s": 2.0},
    {"root": ROOT, "sessions": {"s1": "auto"}},
    {"root": ROOT, "spawn_args": "--platform cpu"},
])
def test_spec_errors_equal(raw):
    msgs = []
    for P in PKG.values():
        with pytest.raises(P.ctl.SpecError) as e:
            P.ctl.FleetSpec(raw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _spec_fields(spec):
    return {k: v for k, v in vars(spec).items()
            if k != "engines"} | {
        "engines": [vars(e) for e in spec.engines]}


def test_spec_defaults_and_load_equal(tmp_path):
    raw = {"root": ROOT, "relays": {"min": 2, "max": 4},
           "engines": [{"addr": "127.0.0.1:8030", "out": "o",
                        "args": ["--platform", "cpu"]}],
           "collector": "127.0.0.1:9300", "canary_max_age_s": 2.0,
           "spawn_args": ["--platform", "cpu"]}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(raw))
    got = [(_spec_fields(P.ctl.FleetSpec({"root": ROOT})),
            _spec_fields(P.ctl.load_spec(str(path))))
           for P in PKG.values()]
    assert got[0] == got[1]
    for P in PKG.values():
        with pytest.raises(P.ctl.SpecError, match="cannot read spec"):
            P.ctl.load_spec(tmp_path / "missing.json")
        (tmp_path / "bad.json").write_text("{not json")
        with pytest.raises(P.ctl.SpecError, match="not valid JSON"):
            P.ctl.load_spec(tmp_path / "bad.json")


# --- manifest -------------------------------------------------------------


def _manifest_story(P, path):
    m = P.ctl.ControllerManifest(path)
    rid = m.migration_begin("s1", "127.0.0.1:1", "127.0.0.1:2")
    assert m.migration_begin("s1", "127.0.0.1:1", "127.0.0.1:2") == rid
    m.migration_done(rid, serving="127.0.0.1:2")
    rid2 = m.migration_begin("s9", "127.0.0.1:1", "127.0.0.1:2")
    m.migration_abort(rid2, "observed on neither")
    open_rid = m.migration_begin("s5", "127.0.0.1:3", "127.0.0.1:4")
    m.record_spawn("relays", "127.0.0.1:7001", "127.0.0.1:9101", 4242)
    m.record_spawn("engines", "127.0.0.1:8030", "127.0.0.1:9100", 77)
    m.roll_start(3)
    m.roll_mark("127.0.0.1:8030")
    return rid, rid2, open_rid


def _manifest_state(P, path, rids):
    m = P.ctl.ControllerManifest(path)
    return {
        "pending": sorted(m.pending_migrations()),
        "records": [m.migration(r) for r in rids],
        "serving": [m.serving(s) for s in ("s1", "s9", "s5")],
        "relays": m.spawned("relays"), "engines": m.spawned("engines"),
        "roll": m.roll_state(),
    }


@pytest.mark.parametrize("writer,reader", PAIRINGS,
                         ids=[f"{a}-writes-{b}-reads" for a, b in PAIRINGS])
def test_manifest_round_trips_across_packages(writer, reader, tmp_path):
    W, R = PKG[writer], PKG[reader]
    path = tmp_path / "controller.json"
    rids = _manifest_story(W, path)
    state = _manifest_state(R, path, rids)
    assert state == _manifest_state(W, path, rids)
    assert state["pending"] == [rids[2]]
    assert state["records"][1]["phase"] == "aborted"
    # The reader drives the open record to done and the writer reads
    # the result back.
    m = R.ctl.ControllerManifest(path)
    m.migration_done(rids[2], serving="127.0.0.1:4")
    again = W.ctl.ControllerManifest(path)
    assert again.pending_migrations() == {}
    assert again.serving("s5") == "127.0.0.1:4"
    path.write_text("}{ not json")
    assert R.ctl.ControllerManifest(path).pending_migrations() == {}


def test_manifest_files_equal_for_the_same_story(tmp_path):
    texts = []
    for name, P in PKG.items():
        path = tmp_path / f"{name}.json"
        _manifest_story(P, path)
        texts.append(json.loads(path.read_text()))
    assert texts[0] == texts[1]


# --- reconcile decisions on the same scraped rows --------------------------


def _snap(rows=(), down=()):
    return {"rows": list(rows), "down": list(down), "tree": [],
            "usage": None}


def _relay_row(endpoint, listen, upstream, peers=0, ws=0, alerts=()):
    return {"endpoint": endpoint, "up": True, "listen": listen,
            "upstream": upstream, "relay_peers": peers, "ws_peers": ws,
            "peers": None, "alerts": list(alerts)}


def _root_row(peers):
    return {"endpoint": "127.0.0.1:9100", "up": True, "listen": ROOT,
            "upstream": None, "peers": peers, "relay_peers": None,
            "ws_peers": None, "alerts": []}


R1 = _relay_row("127.0.0.1:9101", "127.0.0.1:7001", ROOT)
R2 = _relay_row("127.0.0.1:9102", "127.0.0.1:7002", "127.0.0.1:7001")
R2R = _relay_row("127.0.0.1:9102", "127.0.0.1:7002", ROOT)
HOT = [_relay_row("127.0.0.1:9101", "127.0.0.1:7001", ROOT,
                  alerts=["relay_turn_age"]),
       _relay_row("127.0.0.1:9102", "127.0.0.1:7002", ROOT,
                  alerts=["relay_turn_age"])]


def _ledger(tmp_path, name, seconds):
    d = tmp_path / name / "usage"
    d.mkdir(parents=True, exist_ok=True)
    (d / "usage-0.jsonl").write_text(json.dumps(
        {"principal": "t1", "res": {"dispatch_seconds": seconds}}) + "\n")
    return str(tmp_path / name)


class Legs:
    """Records every call a controller makes into its spawn / re-point /
    terminate / heal / retire / migrate legs."""

    def __init__(self, P, monkeypatch, *, fake_heal=False,
                 fake_retire=False, fail_heal=False, canary=None,
                 locations=None, fake_migrate=False):
        self.calls = []
        C = P.ctl.Controller
        monkeypatch.setattr(
            C, "_spawn_relay",
            lambda ctl, up: (self.calls.append(("spawn", up))
                             or ("127.0.0.1:7009", "127.0.0.1:9109")))
        monkeypatch.setattr(
            P.mod, "repoint_relay",
            lambda child, new, secret=None, **kw:
                self.calls.append(("repoint", child, new)))
        monkeypatch.setattr(
            C, "_terminate",
            lambda ctl, key, pid: self.calls.append(("kill", key)))
        if fake_heal or fail_heal:
            def heal(ctl, s, i, r):
                self.calls.append(("heal", s))
                if fail_heal:
                    raise RuntimeError("spawn failed")
            monkeypatch.setattr(C, "_heal_relay", heal)
        if fake_retire:
            monkeypatch.setattr(
                C, "_retire",
                lambda ctl, listen, rows: self.calls.append(
                    ("retire", listen)))
        if canary is not None:
            monkeypatch.setattr(C, "_canary_age_points",
                                lambda ctl: canary)
        if locations is not None:
            monkeypatch.setattr(C, "_session_locations",
                                lambda ctl: dict(locations))
        if fake_migrate:
            monkeypatch.setattr(
                C, "_begin_migration",
                lambda ctl, sid, src, dst: self.calls.append(
                    ("migrate", sid, src, dst)))


def _heal_dead(P, ctl, mp, tmp):
    legs = Legs(P, mp)
    out = [ctl.reconcile_once(snapshot=_snap([R1, R2]), now=1000.0)]
    for t in (1002.0, 1004.0, 1006.0):
        out.append(ctl.reconcile_once(
            snapshot=_snap([R2], down=["127.0.0.1:9101"]), now=t))
    return out, legs.calls


def _stale(P, ctl, mp, tmp):
    legs = Legs(P, mp, fake_heal=True)
    ctl._last_ok["127.0.0.1:9101"] = 990.0
    out = [ctl.reconcile_once(snapshot=_snap(HOT[:1]), now=1000.0)]
    ctl._last_ok["127.0.0.1:9101"] = 999.5
    out.append(ctl.reconcile_once(snapshot=_snap(HOT[:1]), now=1000.0))
    return out, legs.calls


def _budget_backoff(P, ctl, mp, tmp):
    ctl._last_ok.update({"127.0.0.1:9101": 1000.0,
                         "127.0.0.1:9102": 1000.0})
    legs = Legs(P, mp, fake_heal=True)
    out = [ctl.reconcile_once(snapshot=_snap(HOT), now=1000.0)]
    legs2 = Legs(P, mp, fail_heal=True)
    for t in (1000.0, 1000.0, 1002.0):
        out.append(ctl.reconcile_once(snapshot=_snap(HOT[:1]), now=t))
    out.append(sorted((k, v[0], v[1]) for k, v in ctl._backoff.items()))
    return out, legs.calls + legs2.calls


def _drain_then_kill(P, ctl, mp, tmp):
    legs = Legs(P, mp)
    out = [ctl.reconcile_once(snapshot=_snap([_root_row(5), R1]),
                              now=1000.0)]
    ctl.manifest.record_spawn("relays", "127.0.0.1:7002",
                              "127.0.0.1:9102", None)
    r2 = dict(R2R, relay_peers=1)
    child = _relay_row("127.0.0.1:9103", "127.0.0.1:7003",
                       "127.0.0.1:7002")
    ctl._last_ok.update({"127.0.0.1:9102": 2000.0,
                         "127.0.0.1:9103": 2000.0})
    out.append(ctl.reconcile_once(
        snapshot=_snap([_root_row(0), r2, child]), now=2000.0))
    out.append(sorted(ctl._retiring))
    ctl._last_ok["127.0.0.1:9102"] = 2002.0
    out.append(ctl.reconcile_once(
        snapshot=_snap([_root_row(0), dict(r2, relay_peers=0), child]),
        now=2002.0))
    return out, legs.calls


def _ambiguous(P, ctl, mp, tmp):
    legs = Legs(P, mp, fake_heal=True)
    r2 = R2R
    out = [ctl.reconcile_once(snapshot=_snap([R1, r2]), now=1000.0)]
    for t in (1000.5, 1001.0):
        out.append(ctl.reconcile_once(
            snapshot=_snap([R1], down=["127.0.0.1:9102"]), now=t))
    return out, legs.calls


def _history(points):
    def run(P, ctl, mp, tmp):
        ctl.manifest.record_spawn("relays", "127.0.0.1:7001",
                                  "127.0.0.1:9101", None)
        ctl._last_ok["127.0.0.1:9101"] = 1000.0
        legs = Legs(P, mp, canary=points, fake_retire=True)
        out = [ctl.reconcile_once(snapshot=_snap([R1]), now=1000.0)]
        return out, legs.calls
    return run


def _auto(P, ctl, mp, tmp):
    calls = []
    for src in ("127.0.0.1:9001", "127.0.0.1:9002", None):
        calls.append(ctl._pick_auto_destination(src))
    legs = Legs(P, mp, locations={"s1": "127.0.0.1:9001"},
                fake_migrate=True)
    row = {"endpoint": "127.0.0.1:9101", "up": True, "listen": None,
           "upstream": None, "peers": 0, "relay_peers": None,
           "ws_peers": None, "alerts": []}
    ctl._last_ok["127.0.0.1:9101"] = 1000.0
    out = [calls, ctl.reconcile_once(snapshot=_snap([row]), now=1000.0)]
    return out, legs.calls


def _spec_for(name, tmp):
    base = {"root": ROOT, "actions_per_round": 4}
    if name == "heal-dead-relay":
        return {**base, "scrape": ["127.0.0.1:9101", "127.0.0.1:9102"]}
    if name == "stale-evidence":
        return {**base, "stale_secs": 1.0,
                "heal_alerts": ["relay_turn_age"]}
    if name == "budget-and-backoff":
        return {**base, "stale_secs": 5.0, "actions_per_round": 1,
                "heal_alerts": ["relay_turn_age"]}
    if name == "drain-then-kill":
        return {**base, "stale_secs": 5.0,
                "relays": {"min": 0, "max": 8, "observers_per_relay": 2}}
    if name == "growth-held-while-ambiguous":
        return {**base, "relays": {"min": 2, "max": 8},
                "actions_per_round": 1, "down_rounds": 2,
                "stale_secs": 5.0}
    if name.startswith("history"):
        return {**base, "collector": "127.0.0.1:9300",
                "relays": {"min": 0, "max": 4, "observers_per_relay": 64},
                "canary_max_age_s": 2.0, "canary_for_secs": 6.0}
    if name == "auto-placement":
        return {**base, "engines": [
            {"addr": "127.0.0.1:9001", "out": _ledger(tmp, "a", 5.0),
             "metrics": "127.0.0.1:9101"},
            {"addr": "127.0.0.1:9002", "out": _ledger(tmp, "b", 1.0)}],
            "sessions": {"s1": "auto"}}
    raise KeyError(name)


SCENARIOS = {
    "heal-dead-relay": _heal_dead,
    "stale-evidence": _stale,
    "budget-and-backoff": _budget_backoff,
    "drain-then-kill": _drain_then_kill,
    "growth-held-while-ambiguous": _ambiguous,
    "history-grow": _history([(1.0, 5.0), (2.0, 4.0), (3.0, 6.0)]),
    "history-flap": _history([(1.0, 0.1), (2.0, 5.0), (3.0, 0.1)]),
    "history-shrink": _history([(1.0, 0.1), (2.0, 0.2), (3.0, 0.1)]),
    "history-dead-collector": _history(None),
    "auto-placement": _auto,
}


def _decide(pkg, name, tmp_path):
    P = PKG[pkg]
    tmp = tmp_path / pkg
    tmp.mkdir()
    ctl = P.ctl.Controller(P.ctl.FleetSpec(_spec_for(name, tmp)),
                           out_dir=str(tmp / "ctl"), seed=0)
    with pytest.MonkeyPatch.context() as mp:
        try:
            out, calls = SCENARIOS[name](P, ctl, mp, tmp)
        finally:
            ctl.shutdown()
    return json.loads(json.dumps(out).replace(str(tmp), "<tmp>")), calls


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_reconcile_decisions_equal(name, tmp_path):
    j_out, j_calls = _decide("gol_tpu", name, tmp_path)
    t_out, t_calls = _decide("gol_tpu_torch", name, tmp_path)
    assert t_out == j_out
    assert t_calls == j_calls
    if name == "heal-dead-relay":
        assert ("spawn", ROOT) in t_calls
        assert ("repoint", "127.0.0.1:7002", "127.0.0.1:7009") in t_calls
    if name == "drain-then-kill":
        assert t_calls[-1] == ("kill", "127.0.0.1:7002")


def test_spawn_commands_run_the_port(tmp_path, monkeypatch):
    """The controller's spawned relays and engines run `-m
    gol_tpu_torch` with the spec's extra argv, never `-m gol_tpu`."""
    ctl = tctl.Controller(tctl.FleetSpec({
        "root": ROOT, "spawn_args": ["--platform", "cpu"],
        "engines": [{"addr": "127.0.0.1:8030", "out": str(tmp_path / "e"),
                     "args": ["--platform", "cpu"]}]}),
        out_dir=str(tmp_path / "ctl"), seed=0)
    cmds = []
    monkeypatch.setattr(tctl.Controller, "_spawn",
                        lambda self, cmd, tag, banner, key=None:
                            cmds.append(cmd) or (None, "127.0.0.1:1"))
    monkeypatch.setattr(ctl.manifest, "record_spawn",
                        lambda *a: None)
    ctl._procs = {"127.0.0.1:8030": types.SimpleNamespace(pid=1),
                  None: types.SimpleNamespace(pid=2)}
    try:
        ctl._spawn_relay(ROOT)
        ctl._spawn_engine(ctl.spec.engines[0])
    finally:
        ctl.shutdown()
    for cmd in cmds:
        assert cmd[1:3] == ["-m", "gol_tpu_torch"]
        assert cmd[-2:] == ["--platform", "cpu"]
    assert "--relay" in cmds[0] and "--sessions" in cmds[1]


# --- the data plane -------------------------------------------------------


def _fake_root(board):
    """A quiet root serving `board`: acks a relay, sends one board
    frame, echoes clock probes."""
    listener = socket.create_server(("127.0.0.1", 0))
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            try:
                s, _ = listener.accept()
            except OSError:
                return
            try:
                s.settimeout(WAIT)
                jw.recv_msg(s, allow_binary=False)
                jw.send_msg(s, {"t": "attach-ack", "clock": True,
                                "depth": 0, "batch": 16})
                s.sendall(jw.frame_bytes(jw.board_to_frame(0, board, 0)))
                while not stop.wait(0.05):
                    try:
                        s.settimeout(0.05)
                        m = jw.recv_msg(s, allow_binary=False)
                    except TimeoutError:
                        continue
                    except (jw.WireError, OSError):
                        break
                    if m is None:
                        break
                    if m.get("t") == "clk":
                        jw.send_msg(s, {"t": "clk", "t0": m.get("t0"),
                                        "ts": time.time()})
            except Exception:
                pass
            finally:
                with contextlib.suppress(OSError):
                    s.close()

    threading.Thread(target=serve, daemon=True).start()
    return listener, stop


def _next_board(sock):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        try:
            m = jw.recv_msg(sock)
        except TimeoutError:
            continue
        assert m is not None, "stream ended while waiting for a board"
        if m.get("t") == "board":
            return np.array(jw.msg_to_board(m)[1], np.uint8)
    pytest.fail("no board frame arrived")


@pytest.mark.parametrize("pkg", NAMES)
def test_repoint_a_port_relay_resyncs_bit_exact(pkg):
    from gol_tpu_torch.relay import RelayNode

    board_a, board_b = _world(11), _world(22)
    la, stopa = _fake_root(board_a)
    lb, stopb = _fake_root(board_b)
    relay = RelayNode(la.getsockname(), port=0, reconnect_window=WAIT,
                      reconnect_seed=3).start()
    leaf = None
    try:
        assert relay.synced.wait(WAIT)
        leaf = socket.create_connection(relay.address, timeout=WAIT)
        jw.send_msg(leaf, {"t": "hello", "want_flips": True,
                           "binary": True, "role": "observe"})
        assert jw.recv_msg(leaf, allow_binary=False)["t"] == "attach-ack"
        np.testing.assert_array_equal(_next_board(leaf) != 0,
                                      board_a != 0)
        own = "127.0.0.1:%d" % relay.address[1]
        with pytest.raises((jw.WireError, tw.WireError),
                           match="repoint refused"):
            PKG[pkg].ctl.repoint_relay(own, own)
        target = "127.0.0.1:%d" % lb.getsockname()[1]
        r = PKG[pkg].ctl.repoint_relay(own, target)
        assert r.get("ok") and r.get("upstream") == target
        deadline = time.monotonic() + WAIT
        while not np.array_equal(_next_board(leaf) != 0, board_b != 0):
            assert time.monotonic() < deadline
        assert relay.upstream == ("127.0.0.1", lb.getsockname()[1])
    finally:
        if leaf is not None:
            leaf.close()
        stopa.set()
        stopb.set()
        la.close()
        lb.close()
        relay.shutdown()


@pytest.mark.parametrize("pkg", NAMES)
def test_crashed_migration_resumes_between_port_servers(pkg, tmp_path):
    """A controller killed between the park and adopt legs resumes from
    the manifest: the re-driven legs land once on the port's session
    servers, the record reaches done, and one copy of the session
    exists; an intent for a vanished session aborts."""
    from gol_tpu_torch.distributed import SessionControl, SessionServer
    from gol_tpu_torch.params import Params

    C = PKG[pkg].ctl

    def srv(sub):
        p = Params(turns=10 ** 9, threads=1, image_width=64,
                   image_height=64, out_dir=str(tmp_path / sub))
        return SessionServer(p, port=0, watched_chunk=4, idle_chunk=8,
                             device="cpu").start()

    sa, sb = srv("outA"), srv("outB")
    a_addr = "127.0.0.1:%d" % sa.address[1]
    b_addr = "127.0.0.1:%d" % sb.address[1]
    raw = {"root": ROOT, "sessions": {"m1": b_addr},
           "engines": [{"addr": a_addr, "out": str(tmp_path / "outA")},
                       {"addr": b_addr, "out": str(tmp_path / "outB")}],
           "actions_per_round": 4}
    ca = cb = c2 = None
    try:
        ca = SessionControl(*sa.address)
        ca.create("m1", width=64, height=64, seed=5)
        out = str(tmp_path / "ctl")
        os.makedirs(out, exist_ok=True)
        m1 = C.ControllerManifest(os.path.join(out, "controller.json"))
        rid = m1.migration_begin("m1", a_addr, b_addr)
        ca.park("m1")
        ghost = m1.migration_begin("ghost", a_addr, b_addr)
        c2 = C.Controller(C.FleetSpec(raw), out_dir=out, seed=1)
        s = c2.reconcile_once(snapshot=_snap(), now=1000.0)
        migs = [a for a in s["applied"] if a["verb"] == "migrate"]
        assert len(migs) == 2 and all(a["ok"] for a in migs), s
        assert c2.manifest.migration(rid)["phase"] == "done"
        assert c2.manifest.migration(ghost)["phase"] == "aborted"
        cb = SessionControl(*sb.address)
        assert [x["id"] for x in cb.list()] == ["m1"]
        assert ca.list() == []
        assert c2.reconcile_once(snapshot=_snap(), now=1002.0)[
            "planned"] == 0
    finally:
        for c in (ca, cb):
            if c is not None:
                c.close()
        if c2 is not None:
            c2.shutdown()
        sa.shutdown()
        sb.shutdown()


def _spawn(argv, log):
    return subprocess.Popen([sys.executable, "-m", "gol_tpu_torch", *argv],
                            stdout=open(log, "w"), stderr=subprocess.STDOUT,
                            cwd=REPO, env=ENV)


def _banner(log, prefix, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for line in pathlib.Path(log).read_text().splitlines():
            if line.startswith(prefix):
                return line[len(prefix):].split()[0]
        time.sleep(0.05)
    pytest.fail(f"no {prefix!r} banner in {log}:\n"
                + pathlib.Path(log).read_text())


def _health(metrics):
    """The /healthz body (a controller has no "status" key, so the
    sidecar answers 503 with the body all the same)."""
    try:
        with urllib.request.urlopen(f"http://{metrics}/healthz",
                                    timeout=WAIT) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def test_cli_control_heals_a_killed_relay(tmp_path):
    """The fleet on the CPU as processes: a port `--serve --sessions`
    root, a `--control` process with relays.min 1 whose spawns run `-m
    gol_tpu_torch --relay --platform cpu`; SIGKILL the spawned relay and
    the controller spawns its replacement."""
    procs = []
    try:
        root = _spawn(["--serve", "127.0.0.1:0", "--sessions", "--platform",
                       "cpu", "--out", str(tmp_path / "root"),
                       "--metrics-port", "0"], tmp_path / "root.log")
        procs.append(root)
        addr = _banner(tmp_path / "root.log", "session engine serving on ")
        rm = _banner(tmp_path / "root.log", "metrics serving on http://")
        spec = {"root": addr, "scrape": [rm.split("/")[0]],
                "relays": {"min": 1, "max": 2}, "interval_secs": 0.3,
                "down_rounds": 2, "stale_secs": 5.0,
                "spawn_args": ["--platform", "cpu"]}
        (tmp_path / "spec.json").write_text(json.dumps(spec))
        ctl = _spawn(["--control", str(tmp_path / "spec.json"),
                      "--out", str(tmp_path / "ctl"), "--metrics-port",
                      "0"], tmp_path / "ctl.log")
        procs.append(ctl)
        cm = _banner(tmp_path / "ctl.log", "metrics serving on http://")
        cm = cm.split("/")[0]
        man = tmp_path / "ctl" / "controller.json"

        def relays():
            try:
                return json.loads(man.read_text())["spawned"]["relays"]
            except (OSError, ValueError, KeyError):
                return {}

        _wait(lambda: len(relays()) == 1, "the first relay spawn",
              timeout=40)
        ((listen, meta),) = relays().items()
        os.kill(meta["pid"], signal.SIGKILL)
        _wait(lambda: any(m["pid"] != meta["pid"]
                          for m in relays().values()),
              "the controller to heal the killed relay", timeout=40)
        health = _health(cm)
        assert health["mode"] == "control" and health["rounds"] >= 2
        logs = sorted((tmp_path / "ctl" / "logs").glob("relay-*.log"))
        assert len(logs) >= 2
        assert "relay serving on" in logs[-1].read_text()
    finally:
        for p in reversed(procs):
            p.send_signal(signal.SIGINT)
        for p in reversed(procs):
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        # Spawned relays outlive a controller by design: stop them.
        with contextlib.suppress(OSError, ValueError, KeyError):
            spawned = json.loads((tmp_path / "ctl" / "controller.json")
                                 .read_text())["spawned"]["relays"]
            for meta in spawned.values():
                with contextlib.suppress(OSError):
                    os.kill(meta["pid"], signal.SIGKILL)
