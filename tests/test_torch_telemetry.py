"""The port's telemetry planes against gol_tpu's, on the CPU.

- ALERTS: the same rule text parses to the same rules (and the same
  errors), and the same series fed to both packages' `AlertEvaluator`s
  under one injected clock give the same verdicts at every step —
  pending, firing, resolved, windowed quantiles, rates, seeded history,
  fleet-wide series — with no wall-clock deadline anywhere.
- LEDGER: usage segments written by either package are read by the
  other's `read_ledger` and `report usage` to the same totals; torn
  tails are skipped alike.
- PRICE: the port's cost price (its own operation count) lands in the
  meter, the gauges and the ledger; a bucket's charge is price × turns,
  split across its tenants with the shares conserved, and an engine's
  is price × turns.
- HISTORY: TSDB segments written by either package are queried by the
  other (`eval_expr`, every truncation point a clean prefix, resume
  past a torn tail), and a `RemoteWriter` of either package feeds a
  `CollectorServer` of the other, `/query` and `/history` included.
- CONSOLE and REPORT: either package's console renders the other's
  sidecars alike, and `report merge` (with `--hops` and `--replay-to`)
  writes the same merged JSON.
- CANARY: a WebSocket canary of either package reports a turn age
  through the port's relay gateway.
"""

import io
import itertools
import json
import os
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import gol_tpu.obs.accounting as jacc
import gol_tpu.obs.canary as jcan
import gol_tpu.obs.collector as jcol
import gol_tpu.obs.console as jcon
import gol_tpu.obs.freshness as jfr
import gol_tpu.obs.http as jhttp
import gol_tpu.obs.report as jrep
import gol_tpu.obs.tsdb as jts
from gol_tpu.obs.registry import Registry as JRegistry
import gol_tpu_torch.obs.accounting as tacc
import gol_tpu_torch.obs.canary as tcan
import gol_tpu_torch.obs.collector as tcol
import gol_tpu_torch.obs.console as tcon
import gol_tpu_torch.obs.freshness as tfr
import gol_tpu_torch.obs.http as thttp
import gol_tpu_torch.obs.report as trep
import gol_tpu_torch.obs.tsdb as tts
from gol_tpu_torch.obs import device as tdev
from gol_tpu_torch.obs.registry import Registry as TRegistry
from gol_tpu_torch.testing.leaks import lockcheck_guard

WAIT = 10.0

PKG = {
    "gol_tpu": types.SimpleNamespace(
        acc=jacc, can=jcan, col=jcol, con=jcon, fr=jfr, http=jhttp,
        rep=jrep, ts=jts, Registry=JRegistry),
    "gol_tpu_torch": types.SimpleNamespace(
        acc=tacc, can=tcan, col=tcol, con=tcon, fr=tfr, http=thttp,
        rep=trep, ts=tts, Registry=TRegistry),
}
NAMES = list(PKG)
PAIRINGS = list(itertools.product(NAMES, NAMES))
PAIR_IDS = [f"{a}-writes-{b}-reads" for a, b in PAIRINGS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _guards(monkeypatch):
    yield from lockcheck_guard(monkeypatch)


def _wait(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


# --- alerts ---------------------------------------------------------------

RULES = """
# a comment line and a blank line are skipped

age_p99: p99(gol_tpu_server_turn_age_seconds) > 2 for 30s
viol:    gol_tpu_invariant_violations_total > 0
busy:    rate(gol_tpu_writer_pool_busy_seconds_total) > 0.8 for 10s
worst:   max(gol_tpu_client_turn_age_seconds) >= 5 for 2m
floor:   min(gol_tpu_engine_committed_turn) < 1e3
mean:    avg(gol_tpu_relay_depth) <= 3.5 for 0.5h
"""


def test_rule_catalog_parses_alike():
    got = [[(r.name, r.agg, r.family, r.op, r.threshold, r.for_secs,
             r.expr(), r.as_dict()) for r in P.fr.parse_rules(RULES)]
           for P in PKG.values()]
    assert got[0] == got[1] and len(got[0]) == 6


@pytest.mark.parametrize("bad", [
    "not a rule at all",
    "x: frob(gol_tpu_foo) > 1",
    "x: gol_tpu_foo >",
    "x: gol_tpu_foo > 1 for ever",
    "a: gol_tpu_x > 1\na: gol_tpu_y > 2",
])
def test_rule_errors_alike(bad):
    msgs = []
    for P in PKG.values():
        with pytest.raises(ValueError) as e:
            P.fr.parse_rules(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


HIST = "\n".join([
    'gol_tpu_age_seconds_bucket{le="0.1"} %d',
    'gol_tpu_age_seconds_bucket{le="1"} %d',
    'gol_tpu_age_seconds_bucket{le="10"} %d',
    'gol_tpu_age_seconds_bucket{le="+Inf"} %d',
    "gol_tpu_age_seconds_sum 101",
    "gol_tpu_age_seconds_count %d",
    "gol_tpu_busy_total %d",
]) + "\n"

#: name -> (rules, [(now, series text)]): one scripted clock each.
SCENARIOS = {
    "for-hold-fire-resolve": (
        "hot: gol_tpu_x_total > 5 for 2s",
        [(1000.0 + t, f"gol_tpu_x_total {v}\n") for t, v in
         ((0, 9), (1, 9), (2.1, 9), (3, 1), (4, 9), (6.5, 9), (7, 0))]),
    "windowed-quantile-and-rate": (
        "slow: p99(gol_tpu_age_seconds) > 2\n"
        "busy: rate(gol_tpu_busy_total) > 0.5 for 5s",
        [(100.0, HIST % (10, 10, 20, 20, 20, 0)),
         (110.0, HIST % (10, 10, 20, 20, 20, 8)),
         (117.0, HIST % (200, 200, 210, 210, 210, 20)),
         (120.0, HIST % (200, 200, 260, 260, 260, 30))]),
    "turn-age-wedged-then-drained": (
        "age: max(gol_tpu_server_peer_turn_age_seconds) > 1 for 3s",
        [(50.0 + t, 'gol_tpu_server_peer_turn_age_seconds{peer="%s"} %s\n'
          % (p, a)) for t, p, a in
         ((0, "7", 0.01), (1, "7", 1.5), (2, "7", 2.5), (4.2, "7", 4.7),
          (5, "other", 0.02), (6, "7", 0.0))]),
    "missing-and-garbage": (
        "ghost: p99(gol_tpu_does_not_exist) > 1\n"
        "ghost2: gol_tpu_also_absent > 0",
        [(1.0, ""), (2.0, "garbage !!! not prometheus\n\x00\xff"),
         (3.0, "gol_tpu_other 5\n")]),
}


def _verdicts(P, rules, steps):
    ev = P.fr.AlertEvaluator(P.fr.parse_rules(rules))
    try:
        out = []
        for now, text in steps:
            p = ev.eval_once(now=now, text=text)
            out.append([(r["name"], r["state"], r["value"], r["since"])
                        for r in p["rules"]] + [p["firing"]])
        return out
    finally:
        ev.close()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_alert_verdicts_equal_under_an_injected_clock(name):
    rules, steps = SCENARIOS[name]
    jv, tv = (_verdicts(P, rules, steps) for P in PKG.values())
    assert tv == jv
    if name == "turn-age-wedged-then-drained":
        states = [step[0][1] for step in tv]
        assert states == ["ok", "pending", "pending", "firing", "ok", "ok"]


@pytest.mark.parametrize("samples", [
    [(1.5, 9.0), (1.0, 9.0), (0.5, 9.0)],
    [(1.5, 9.0), (1.0, 1.0), (0.5, 9.0)],
    [(1.0, 1.0), (0.5, 2.0)],
], ids=["credit", "noisy", "all-clear"])
def test_seeded_history_alike(samples):
    got = []
    for P in PKG.values():
        ev = P.fr.AlertEvaluator(
            P.fr.parse_rules("hot: gol_tpu_x_total > 5 for 2s"))
        try:
            seeded = ev.seed_history(lambda rule: samples, now=1000.0)
            trail = [ev.rules[0].state]
            for dt in (0.6, 2.0):
                p = ev.eval_once(now=1000.0 + dt, text="gol_tpu_x_total 9\n")
                trail.append(p["rules"][0]["state"])
            got.append((seeded, trail))
        finally:
            ev.close()
    assert got[0] == got[1]


def test_fleet_series_source_alike():
    got = []
    for P in PKG.values():
        fleet = {'gol_tpu_age_seconds{src="a"}': 0.5,
                 'gol_tpu_age_seconds{src="b"}': 9.0}
        ev = P.fr.AlertEvaluator(
            P.fr.parse_rules("lag: max(gol_tpu_age_seconds) > 2 for 1s"),
            series_source=lambda: dict(fleet))
        try:
            trail = [ev.eval_once(now=1000.0)["rules"][0]["state"],
                     ev.eval_once(now=1001.1)["rules"][0]["state"]]
            fleet['gol_tpu_age_seconds{src="b"}'] = 0.1
            trail.append(ev.eval_once(now=1002.0)["rules"][0]["state"])
            got.append(trail)
        finally:
            ev.close()
    assert got[0] == got[1] == ["pending", "firing", "ok"]


def _get(address, path):
    url = "http://%s:%d%s" % (address[0], address[1], path)
    try:
        with urllib.request.urlopen(url, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_sidecar_alerts_and_usage_endpoints_alike():
    """/alerts with and without an evaluator, /usage's shape, and the
    404 of /query and /history away from a collector: the port's
    sidecar answers as gol_tpu's does."""
    got = []
    for P in PKG.values():
        reg = P.Registry()
        reg.counter("gol_tpu_x_total", "x").inc(9)
        ev = P.fr.AlertEvaluator(
            P.fr.parse_rules("hot: gol_tpu_x_total > 5"), registry=reg,
            interval=60.0)
        bare = P.http.MetricsServer(port=0, registry=reg).start()
        armed = P.http.MetricsServer(port=0, registry=reg,
                                     alerts=ev).start()
        try:
            ev.eval_once(now=1.0)
            a0 = _get(bare.address, "/alerts")
            a1 = _get(armed.address, "/alerts")
            usage = _get(bare.address, "/usage")
            q = _get(bare.address, "/query?expr=rate(x)")
            h = _get(bare.address, "/history?since=5")
        finally:
            bare.close()
            armed.close()
        got.append((a0, a1[0], a1[1]["firing"], a1[1]["rules"],
                    usage[0], sorted(usage[1]), q, h))
    assert got[0] == got[1]
    assert got[1][2] == 1 and got[1][6][0] == 404


# --- the usage ledger -----------------------------------------------------


def _write_ledger(pkg, directory):
    """A meter of `pkg` charging three principals in two flushes, then a
    torn tail appended to its segment."""
    m = PKG[pkg].acc.Meter()
    m.configure_ledger(str(directory))
    m.charge("s1", dispatch_seconds=0.5, flops=1e6, turns=10,
             wire_bytes=100)
    m.charge("peer:3", wire_bytes=4096, host_seconds=0.01)
    m._ledger.flush_once()
    m.charge("s1", flops=2e6, turns=5, queue_frame_seconds=0.25)
    m.charge(PKG[pkg].acc.LEGACY, dispatch_seconds=1.0, turns=7)
    m.close()
    (seg,) = sorted(p for p in os.listdir(directory)
                    if p.startswith("usage-"))
    with open(os.path.join(directory, seg), "ab") as f:
        f.write(b'{"principal": "s1", "res": {"turns": 99')
    return m.payload()


@pytest.mark.parametrize("writer,reader", PAIRINGS, ids=PAIR_IDS)
def test_ledgers_read_across_packages(writer, reader, tmp_path, capsys):
    live = _write_ledger(writer, tmp_path / "usage")
    totals = PKG[reader].acc.read_ledger(str(tmp_path / "usage"))
    want = {p: {k: v for k, v in res.items() if v and k != "over_budget"}
            for p, res in live["principals"].items()}
    assert totals == want
    assert PKG[reader].rep.main(["usage", str(tmp_path / "usage"),
                                 "--json"]) == 0
    bill = json.loads(capsys.readouterr().out)
    assert bill["principals"] == want and bill["sort"] == "flops"
    assert PKG[reader].rep.main(["usage", str(tmp_path / "usage"),
                                 "--sort", "turns"]) == 0
    table = capsys.readouterr().out
    assert "3 principals" in table and "TOTAL" in table


def test_budgets_mark_over_budget_alike():
    got = []
    for P in PKG.values():
        m = P.acc.Meter()
        m.set_budgets(flops=1e6, bytes=1000)
        m.charge("a", flops=5e5)
        m.charge("b", flops=2e6)
        m.charge("c", wire_bytes=5000)
        p = m.payload()
        got.append((p["over_budget"], p["budgets"],
                    {k: v["over_budget"] for k, v in p["principals"].items()}))
        m.forget("b")
        got.append(m.payload()["over_budget"])
        m.close()
    assert got[:2] == got[2:]
    assert got[0][0] == ["b", "c"]


# --- the cost price -------------------------------------------------------


@pytest.mark.parametrize("rule,layout,per_word,planes", [
    ("B3/S23", "packed", 12, 1), ("B36/S23", "packed", 12, 1),
    ("B2/S/C3", "packed", 12, 2), ("B2/S345/C4", "packed", 15, 3),
    ("B3/S23", "dense", 9, None),
])
def test_cost_of_counts_the_ports_operations(rule, layout, per_word,
                                             planes):
    c = tdev.cost_of(256, 128, rule, layout=layout, boards=3)
    cells = 256 * 128 * 3
    if layout == "dense":
        assert c["flops"] == per_word * cells / 4
        assert c["bytes_accessed"] == 2 * cells
    else:
        assert c["flops"] == per_word * cells / 32
        assert c["bytes_accessed"] == 2 * 4 * planes * cells / 32
    assert c["argument_bytes"] == c["output_bytes"] == c["bytes_accessed"] / 2
    assert "error" in tdev.cost_of(64, 64, "B3/S23", layout="sparse")


def test_bucket_charge_is_price_times_turns_and_conserved(tmp_path,
                                                          monkeypatch):
    """A bucket built with the probes on publishes its "bucket.step"
    price; after pumping, its tenants' FLOPs sum to price x turns, each
    share the split rule's, and the conservation check never fires."""
    from gol_tpu_torch.analysis.invariants import violations_total
    from gol_tpu_torch.sessions import SessionManager

    m = tacc.Meter()
    monkeypatch.setattr(tacc, "_METER", m)
    monkeypatch.setattr(tdev, "_COST_PROBES", True)
    before = violations_total()
    mgr = SessionManager(out_dir=str(tmp_path), bucket_capacity=4,
                         device="cpu")
    for i in range(3):
        mgr.create(f"s{i}", width=64, height=64, seed=i + 1)
    mgr.pump(40, chunk=20)
    price = tdev.cost_of(64, 64, "B3/S23", boards=4)["flops"]
    (key,) = [k for k in m._prices if k.startswith("bucket.step:")]
    assert m.price_flops(key) == price == m.price_flops("bucket.step")
    shares = [m.totals(f"s{i}")["flops"] for i in range(3)]
    assert sum(shares) == pytest.approx(price * 40, rel=1e-12)
    assert all(t > 0 for t in shares)
    assert [m.totals(f"s{i}")["turns"] for i in range(3)] == [40] * 3
    assert violations_total() == before
    from gol_tpu_torch import obs

    g = obs.registry().prometheus_text()
    assert f'gol_tpu_device_cost_flops{{program="bucket.step"}} {price:g}' \
        in g.replace(".0\n", "\n")


def test_engine_charge_is_price_times_turns(tmp_path, golden_root,
                                            monkeypatch):
    from gol_tpu_torch import FinalTurnComplete, Params
    from gol_tpu_torch.engine.distributor import Engine

    m = tacc.Meter()
    monkeypatch.setattr(tacc, "_METER", m)
    monkeypatch.setattr(tdev, "_COST_PROBES", True)
    p = Params(turns=50, image_width=64, image_height=64,
               image_dir=str(golden_root / "images"),
               out_dir=str(tmp_path), tick_seconds=60.0)
    eng = Engine(p, device="cpu", emit_flips=False)
    eng.start()
    for ev in eng.events:
        if isinstance(ev, FinalTurnComplete):
            break
    eng.join(timeout=WAIT)
    price = tdev.cost_of(64, 64, "B3/S23")["flops"]
    assert m.price_flops("engine.step") == price
    assert m.totals(tacc.LEGACY)["flops"] == price * 50
    assert m.totals(tacc.LEGACY)["turns"] == 50


# --- the history plane ----------------------------------------------------


def _fill(P, root, n=12, source="e1"):
    db = P.ts.TSDB(str(root))
    for i in range(n):
        db.append(source, 1000.0 + i,
                  [("turns_total", 5.0 * i), ("age_s", 0.25 * (i % 3))])
    db.close()


@pytest.mark.parametrize("writer,reader", PAIRINGS, ids=PAIR_IDS)
def test_tsdb_segments_read_across_packages(writer, reader, tmp_path):
    W, R = PKG[writer], PKG[reader]
    _fill(W, tmp_path / "tsdb")
    (_, path), = R.ts.scan_segments(str(tmp_path / "tsdb"))
    whole = list(R.ts.read_records(path))
    assert whole == list(W.ts.read_records(path)) and len(whole) == 13
    # Every truncation point reads as a clean prefix in the reader.
    blob = open(path, "rb").read()
    cut = tmp_path / "cut.tlog"
    for n in range(0, len(blob) + 1, 7):
        cut.write_bytes(blob[:n])
        got = list(R.ts.read_records(str(cut)))
        assert got == whole[:len(got)]
    db = R.ts.TSDB(str(tmp_path / "tsdb"), resume=True)
    try:
        assert db.sources() == ["e1"]
        assert db.latest("e1")["turns_total"] == 55.0
        for agg in ("rate", "max", "delta", "avg"):
            fam = "turns_total" if agg in ("rate", "delta") else "age_s"
            pts = R.ts.eval_expr(db, agg, fam, 1002.0, 1011.0, 3.0)
            ref = W.ts.TSDB(str(tmp_path / "tsdb"), resume=True)
            try:
                want = W.ts.eval_expr(ref, agg, fam, 1002.0, 1011.0, 3.0)
            finally:
                ref.close()
            assert pts == want and any(v is not None for _, v in pts)
    finally:
        db.close()
    # A torn tail: the reader's resume drops only the last record.
    _fill(W, tmp_path / "torn")
    (_, path), = R.ts.scan_segments(str(tmp_path / "torn"))
    torn = open(path, "rb").read()[:-7]
    open(path, "wb").write(torn)
    db = R.ts.TSDB(str(tmp_path / "torn"), resume=True)
    try:
        assert db.latest("e1")["turns_total"] == 50.0
    finally:
        db.close()


@pytest.mark.parametrize("writer,collector", PAIRINGS,
                         ids=[f"{a}-writer-{b}-collector"
                              for a, b in PAIRINGS])
def test_remote_write_into_the_other_packages_collector(writer, collector,
                                                        tmp_path):
    W, C = PKG[writer], PKG[collector]
    reg = W.Registry()
    c = reg.counter("gol_tpu_engine_turns_total", "t")
    g = reg.gauge("gol_tpu_relay_depth", "d")
    g.set(2.0)
    db = C.ts.TSDB(str(tmp_path / "tsdb"))
    srv = C.col.CollectorServer("127.0.0.1", 0, db, secret="s3").start()
    side = C.http.MetricsServer(port=0, registry=C.Registry(),
                                tsdb=db).start()
    rw = W.col.RemoteWriter(f"127.0.0.1:{srv.address[1]}",
                            source="eng:1", registry=reg, secret="s3")
    try:
        t0 = time.time()
        for i in range(4):
            c.inc(100)
            assert rw.push_once(now=t0 + i)
            _wait(lambda: (db.latest("eng:1") or {}).get(
                "gol_tpu_engine_turns_total") == 100.0 * (i + 1),
                "the collector to ingest the push")
        assert db.latest("eng:1")["gol_tpu_relay_depth"] == 2.0
        status, body = _get(side.address,
                            "/query?expr=max(gol_tpu_relay_depth)"
                            "&start=-120&end=-0&step=5")
        assert status == 200 and body["expr"] == "max(gol_tpu_relay_depth)"
        (series,) = body["series"]
        assert any(v == 2.0 for _, v in series["points"])
        status, hist = _get(side.address, "/history?since=120")
        assert status == 200 and "eng:1" in json.dumps(hist)
    finally:
        rw.close()
        side.close()
        srv.close()


# --- the console and the report -------------------------------------------


def _node(P, listen, upstream=None, depth=None, peers=0, turns=None):
    r = P.Registry()
    if upstream is None:
        r.gauge("gol_tpu_server_listen_addr", labels={"addr": listen}).set(1)
        r.gauge("gol_tpu_server_peers").set(peers)
        r.gauge("gol_tpu_engine_committed_turn").set(turns or 0)
        r.counter("gol_tpu_engine_turns_total",
                  labels={"kind": "diffs"}).inc(turns or 0)
    else:
        r.gauge("gol_tpu_relay_node_info",
                labels={"listen": listen, "upstream": upstream}).set(1)
        r.gauge("gol_tpu_relay_depth").set(depth)
        r.gauge("gol_tpu_relay_peers").set(peers)
        r.gauge("gol_tpu_relay_upstream_rtt_seconds").set(0.004)
    return r


FLEET = [("10.0.0.1:8030", None, None, 2, 5000),
         ("10.0.0.1:9001", "10.0.0.1:8030", 1, 250, None),
         ("10.0.0.1:9002", "10.0.0.1:9001", 2, 40, None)]


def _strip(v):
    """A snapshot without its wall-clock and per-endpoint address
    parts."""
    if isinstance(v, dict):
        return {k: _strip(x) for k, x in v.items()
                if k not in ("ts", "endpoint", "scraped_at", "age_s")}
    if isinstance(v, list):
        return [_strip(x) for x in v]
    return v


@pytest.mark.parametrize("sidecar,console", PAIRINGS,
                         ids=[f"{a}-sidecars-{b}-console"
                              for a, b in PAIRINGS])
def test_console_renders_the_other_packages_fleet(sidecar, console):
    S, C = PKG[sidecar], PKG[console]
    servers = [S.http.MetricsServer(port=0, registry=_node(S, *spec))
               .start() for spec in FLEET]
    try:
        eps = [C.con.Endpoint(f"127.0.0.1:{s.address[1]}") for s in servers]
        snap = C.con.fleet_snapshot(eps)
        out = io.StringIO()
        C.con.render(snap, out=out)
        text = out.getvalue()
        ref = PKG["gol_tpu"].con.fleet_snapshot(
            [PKG["gol_tpu"].con.Endpoint(f"127.0.0.1:{s.address[1]}")
             for s in servers])
    finally:
        for s in servers:
            s.close()
    assert snap["down"] == []
    assert _strip(snap["tree"]) == _strip(ref["tree"])
    (root,) = snap["tree"]
    assert root["listen"] == "10.0.0.1:8030"
    assert root["children"][0]["children"][0]["depth"] == 2
    assert "fan-out tree:" in text and "10.0.0.1:9002" in text


def _trace(label, pid, offset, spans):
    return {"traceEvents": [
        {"name": n, "cat": "turn", "ph": ph, "ts": ts, "dur": 5,
         "pid": pid, "tid": 1, "args": args} for n, ph, ts, args in spans],
        "metadata": {"process_label": label, "pid": pid,
                     "clock_offset_s": offset}}


def _record(out_dir):
    """A port session recording (inline manager), as the replay tests
    make one."""
    from gol_tpu_torch.replay.log import SegmentLog, replay_dir
    from gol_tpu_torch.replay.recorder import RecorderSink
    from gol_tpu_torch.sessions import SessionManager

    m = SessionManager(out_dir=str(out_dir), bucket_capacity=4,
                       device="cpu")
    m.create("s1", width=64, height=64, seed=7)
    d = replay_dir(os.path.join(str(out_dir), "sessions", "s1"))
    rec = RecorderSink(m, "s1", 64, 64, SegmentLog(d, keyframe_turns=32))
    m.attach("s1", rec)
    m.pump(90, chunk=30)
    board = m.fetch_board("s1").copy()
    m.detach("s1", rec)
    rec.on_close("s1", "done")
    return d, board


def test_report_merge_output_equal(tmp_path, capsys):
    server = _trace("serve", 11, 0.0, [
        ("turn.emit", "i", 1_000_000, {"turn": 5}),
        ("wire.encode", "X", 1_000_010, {}),
        ("turn.emit", "i", 2_000_000, {"turn": 6})])
    client = _trace("connect", 22, 0.25, [
        ("turn.apply", "i", 1_250_900, {"turn": 5}),
        ("turn.apply", "i", 2_251_000, {"turn": 6})])
    paths = []
    for name, dump in (("s.json", server), ("c.json", client)):
        (tmp_path / name).write_text(json.dumps(dump))
        paths.append(str(tmp_path / name))
    log_dir, board = _record(tmp_path / "rec")
    merged = []
    for P in PKG.values():
        out = tmp_path / f"merged-{P.rep.__name__}.json"
        assert P.rep.main(["merge", *paths, "-o", str(out), "--hops",
                           "--replay-to", "60", "--replay-log",
                           log_dir]) == 0
        merged.append(json.loads(out.read_text()))
    capsys.readouterr()
    assert merged[0] == merged[1]
    rp = merged[1]["metadata"]["replay"]
    assert rp["turn"] <= 60 and "error" not in rp
    summary = trep.replay_summary(log_dir, 90)
    assert summary["alive"] == int((board != 0).sum())


def test_report_render_equal(tmp_path, capsys):
    from gol_tpu_torch.obs import flight

    flight.note("test.render", reason="x", n=3)
    dump = flight.payload() if hasattr(flight, "payload") else None
    if dump is None:
        from gol_tpu_torch.obs.flight import RECORDER

        dump = RECORDER.payload()
    (tmp_path / "f.json").write_text(json.dumps(dump))
    text = []
    for P in PKG.values():
        assert P.rep.main([str(tmp_path / "f.json")]) == 0
        text.append(capsys.readouterr().out)
    assert text[0] == text[1] and "test.render" in text[1]


# --- the canary through the port's WebSocket gateway ----------------------


@pytest.mark.parametrize("pkg", NAMES)
def test_ws_canary_reports_a_turn_age_through_the_port_relay(pkg, tmp_path):
    from gol_tpu_torch.distributed import EngineServer
    from gol_tpu_torch.params import Params
    from gol_tpu_torch.relay import RelayNode

    rng = np.random.default_rng(3)
    world = (rng.random((64, 64)) < 0.3).astype(np.uint8) * 255
    srv = EngineServer(Params(turns=10 ** 9, image_width=64,
                              image_height=64, out_dir=str(tmp_path),
                              tick_seconds=60.0),
                       port=0, heartbeat_secs=0.5, initial_world=world,
                       device="cpu").start()
    relay = RelayNode(srv.address, port=0, heartbeat_secs=0.5,
                      ws_port=0).start()
    try:
        assert relay.synced.wait(WAIT)
        out = io.StringIO()
        rc = PKG[pkg].can.run_canary(
            f"{relay.ws_address[0]}:{relay.ws_address[1]}",
            interval=0.2, duration=1.5, max_age=5.0, use_ws=True,
            as_json=True, out=out)
        assert rc == 0, out.getvalue()
        summary = json.loads(out.getvalue())
        assert summary["transport"] == "ws" and summary["ok"]
        assert summary["applied_turn"] > 0 and summary["age"]["samples"] > 0
    finally:
        relay.shutdown()
        srv.shutdown()
