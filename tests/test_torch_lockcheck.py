"""The port's tracked lock (`gol_tpu_torch.analysis.concurrency.lockcheck`)
on gol_tpu's lockcheck unit cases: a plain lock when off, the runtime
order graph reporting an AB/BA cycle before it can hang, re-entrant
locks that close no cycle, the held-too-long watchdog, the resource
census behind `testing.leaks`, and every serving-plane lock of the port
built through the factory. Each case runs against both packages."""

import pathlib
import re
import socket
import threading
import time

import pytest
import torch

from gol_tpu.analysis.concurrency import lockcheck as jlock
from gol_tpu.testing import leaks as jleaks
from gol_tpu_torch.analysis.concurrency import lockcheck as tlock
from gol_tpu_torch.testing import leaks as tleaks

REPO = pathlib.Path(__file__).resolve().parent.parent

PKGS = {"gol_tpu": (jlock, jleaks), "gol_tpu_torch": (tlock, tleaks)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_make_lock_is_plain_when_lockcheck_off(pkg, monkeypatch):
    lockcheck, _ = PKGS[pkg]
    monkeypatch.delenv("GOL_TPU_LOCKCHECK", raising=False)
    assert not lockcheck.lockcheck_enabled()
    assert isinstance(lockcheck.make_lock("Off.lock"), type(threading.Lock()))
    assert isinstance(lockcheck.make_rlock("Off.rlock"),
                      type(threading.RLock()))
    lockcheck.enable()
    try:
        assert lockcheck.lockcheck_enabled()
    finally:
        lockcheck.enable(False)
    assert not lockcheck.lockcheck_enabled()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_runtime_order_cycle_is_reported_not_hung(pkg, monkeypatch):
    lockcheck, _ = PKGS[pkg]
    monkeypatch.setenv("GOL_TPU_LOCKCHECK", "1")
    a = lockcheck.make_lock(f"CycleT{pkg}.A")
    b = lockcheck.make_lock(f"CycleT{pkg}.B")
    before = lockcheck.reports_total()

    def ab():
        with a:
            with b:
                pass

    t = threading.Thread(target=ab)
    t.start()
    t.join(10)
    assert not t.is_alive()
    with b:       # the reversed order: closes the cycle, reported
        with a:   # BEFORE this acquire (which succeeds — t is done)
            pass
    assert lockcheck.reports_total() - before == 1
    last = lockcheck.reports()[-1]
    assert last["kind"] == "lock-order"
    assert f"CycleT{pkg}.A" in last["msg"] and f"CycleT{pkg}.B" in last["msg"]
    # The same cycle again is not a new report.
    with b:
        with a:
            pass
    assert lockcheck.reports_total() - before == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_reentrant_rlock_is_not_a_cycle(pkg, monkeypatch):
    lockcheck, _ = PKGS[pkg]
    monkeypatch.setenv("GOL_TPU_LOCKCHECK", "1")
    r = lockcheck.make_rlock(f"ReentT{pkg}.R")
    before = lockcheck.reports_total()
    with r:
        with r:
            pass
    assert lockcheck.reports_total() == before


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_held_too_long_watchdog_fires(pkg, monkeypatch):
    lockcheck, _ = PKGS[pkg]
    monkeypatch.setenv("GOL_TPU_LOCKCHECK", "1")
    monkeypatch.setenv("GOL_TPU_LOCKCHECK_MAX_HELD_SECS", "0.05")
    lk = lockcheck.make_lock(f"SlowT{pkg}.lock")
    before = lockcheck.reports_total()
    with lk:
        time.sleep(0.3)
    assert lockcheck.reports_total() - before >= 1
    tail = [r for r in lockcheck.reports()
            if r["kind"] == "held-too-long" and f"SlowT{pkg}.lock" in r["msg"]]
    assert tail, "neither the watchdog nor the release check reported"


def test_reports_count_into_the_port_registry(monkeypatch):
    """The port's reports land in its own registry under gol_tpu's
    metric name, and in no counter of gol_tpu's."""
    from gol_tpu_torch import obs

    monkeypatch.setenv("GOL_TPU_LOCKCHECK", "1")
    a, b = tlock.make_lock("RegT.A"), tlock.make_lock("RegT.B")
    j_before = jlock.reports_total()
    m = obs.registry().get("gol_tpu_lockcheck_violations_total",
                           {"kind": "lock-order"})
    before = m.value
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert m.value == before + 1
    assert jlock.reports_total() == j_before


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_census_sees_listener_and_leak_assert_clears(pkg):
    _, leaks = PKGS[pkg]
    before = leaks.snapshot()
    srv = socket.create_server(("127.0.0.1", 0))
    try:
        grown = leaks.snapshot()
        new = [s for s in grown["listen_sockets"]
               if s not in before["listen_sockets"]]
        assert new, "census missed a freshly bound listener"
        with pytest.raises(AssertionError, match="resource leak"):
            leaks.assert_no_leaks(before, grace=0.2)
    finally:
        srv.close()
    leaks.assert_no_leaks(before)  # closed: the delta drains within grace


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_census_sees_non_daemon_thread(pkg):
    _, leaks = PKGS[pkg]
    done = threading.Event()
    before = leaks.snapshot()
    t = threading.Thread(target=done.wait, name=f"census-probe-{pkg}",
                         daemon=False)
    t.start()
    try:
        assert f"census-probe-{pkg}" in leaks.snapshot()["non_daemon_threads"]
        with pytest.raises(AssertionError, match="resource leak"):
            leaks.assert_no_leaks(before, grace=0.2)
    finally:
        done.set()
        t.join(10)
    leaks.assert_no_leaks(before)


def test_port_serving_locks_route_through_factory():
    """Every serving-plane lock of the port is built by make_lock /
    make_rlock — a raw threading.Lock() there is invisible to the
    tracked twin."""
    bad = []
    for rel in ("distributed/server.py", "distributed/client.py",
                "relay/writerpool.py", "engine/distributor.py"):
        src = (REPO / "gol_tpu_torch" / rel).read_text()
        for i, line in enumerate(src.splitlines(), 1):
            if re.search(r"=\s*threading\.(R)?Lock\(\)", line):
                bad.append(f"{rel}:{i}: {line.strip()}")
    assert bad == [], "; ".join(bad)
