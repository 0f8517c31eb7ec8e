"""The port's seeded chaos harness (`gol_tpu_torch.testing.chaos`), held
against gol_tpu's (`gol_tpu.testing.chaos`): the recipes' soups, the
unfaulted oracle and the metric parser equal gol_tpu's; a verb storm,
a stalled observer and a mid-storm crash of an in-process CPU
`SessionServer` resumed on the same port end with the ledger equal to
the live set and every board bit-identical to the oracle (gol_tpu's
`tests/test_chaos.py` scenario); and one small `ChaosRunner` run on
the CPU SIGKILLs a real `--serve --sessions` process mid-storm."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from gol_tpu_torch.params import Params
from gol_tpu_torch.testing import chaos as tchaos

torch.set_num_threads(1)


@pytest.mark.parametrize("side,seed,density", [
    (64, 0, 0.25), (64, 77, 0.3), (192, 123456789, 0.31), (96, 5, 0.2),
])
def test_recipe_soup_and_oracle_equal_gol_tpus(side, seed, density):
    from gol_tpu.testing import chaos as jchaos

    kw = {"width": side, "height": side, "seed": seed, "density": density}
    t, j = tchaos.Recipe("s", **kw), jchaos.Recipe("s", **kw)
    np.testing.assert_array_equal(t.board0(), j.board0())
    assert t.create_kwargs() == j.create_kwargs()
    for turn in (0, 1, 37, 3001):
        np.testing.assert_array_equal(tchaos.oracle_board(t, turn),
                                      jchaos.oracle_board(j, turn))


def test_parse_metric_equals_gol_tpus():
    from gol_tpu.testing import chaos as jchaos

    text = "\n".join([
        "# HELP gol_tpu_x_total x",
        'gol_tpu_x_total{a="1"} 3',
        'gol_tpu_x_total{a="2"} 4.5',
        "gol_tpu_x_total_more 100",
        "gol_tpu_x_total 2",
        "gol_tpu_y 7",
        "gol_tpu_x_total{a=\"3\"} nan-ish",
    ])
    for name in ("gol_tpu_x_total", "gol_tpu_y", "gol_tpu_absent",
                 "gol_tpu_x_total_more"):
        assert tchaos.parse_metric(text, name) == jchaos.parse_metric(
            text, name)
    assert tchaos.parse_metric(text, "gol_tpu_x_total") == 9.5


@pytest.fixture
def _invariants_on(monkeypatch):
    monkeypatch.setenv("GOL_TPU_CHECK_INVARIANTS", "1")
    from gol_tpu_torch.analysis.invariants import violations_total

    before = violations_total()
    yield
    assert violations_total() - before == 0, (
        "chaos must never corrupt a protocol invariant"
    )


def _server(tmp_path, port=0, resume=False):
    from gol_tpu_torch.distributed import SessionServer

    p = Params(turns=10 ** 9, threads=1, image_width=64,
               image_height=64, out_dir=str(tmp_path / "out"),
               tick_seconds=60.0, autosave_turns=64)
    return SessionServer(p, port=port, resume=resume,
                         heartbeat_secs=0.5, high_water=64,
                         drain_secs=30.0, device="cpu")


def _hard_kill(srv):
    """Emulate SIGKILL in-process: every socket dies abruptly, the
    listener closes, the engine stops — and NOTHING runs the graceful
    paths (no manager.close, no farewell byes, no final checkpoints):
    the on-disk state is whatever the manifest/tombstones/autosaves
    already made durable."""
    srv._shutdown.set()
    with contextlib.suppress(OSError):
        srv._listener.close()
    with srv._conn_lock:
        conns, srv._conns = list(srv._conns), []
        srv._drivers.clear()
        srv._sinks.clear()
    for c in conns:
        c.close()
    srv.engine.stop()
    srv.engine.join(timeout=60)


@pytest.mark.slow
def test_chaos_storms_crash_resume_inprocess(tmp_path, _invariants_on):
    """Verb storms + a stalled observer + a mid-storm crash + resume on
    the same port: every retried verb converges, the ledger matches the
    live set exactly, destroyed sessions stay dead, and every surviving
    board is bit-identical to the unfaulted oracle.

    Marked slow as gol_tpu marks its own (`tests/test_chaos.py`): the
    in-process crash is an emulation whose outcome depends on thread
    timing, and gol_tpu's copy of it fails intermittently on a CPU box
    (a session acknowledged before the emulated kill is missing after
    the resume). The SIGKILL scenario below is the tier-1 one."""
    from gol_tpu_torch.distributed.client import SessionControl
    from gol_tpu_torch.io.pgm import read_pgm

    srv = _server(tmp_path).start()
    port = srv.address[1]
    address = srv.address
    pinned = tchaos.Recipe("pin", seed=77, density=0.3)
    verb_count = [0]
    lock = threading.Lock()

    def count():
        with lock:
            verb_count[0] += 1

    observers, storms = [], []
    srv2 = None
    try:
        boot = SessionControl(*address, retry_window=30.0, retry_seed=1)
        boot.create(pinned.sid, **pinned.create_kwargs())
        ob = tchaos.ShadowObserver(address, pinned, seed=5,
                                   stall_secs=0.5, stall_every=25)
        ob.start()
        observers.append(ob)
        for i in range(2):
            st = tchaos.VerbStorm(address, seed=100 + i, prefix=f"s{i}",
                                  verbs=10, retry_window=90.0,
                                  on_verb=count)
            st.start()
            storms.append(st)
        # Crash mid-storm: genuinely in-flight verbs get torn.
        deadline = time.monotonic() + 120
        while verb_count[0] < 6 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert verb_count[0] >= 1, "storms never started"
        _hard_kill(srv)
        srv2 = _server(tmp_path, port=port, resume=True).start()
        assert srv2.resumed >= 1  # at least the pinned session

        for st in storms:
            st.join(150)
            assert not st.is_alive(), "storm wedged through the crash"
            assert st.error is None, f"storm failed: {st.error!r}"
        for o in observers:
            o.stop()
        for o in observers:
            o.join(15)

        ctl = SessionControl(*address, retry_window=30.0, retry_seed=2)
        live = {s["id"] for s in ctl.list()}
        expected = {pinned.sid: pinned}
        destroyed = set()
        for st in storms:
            expected.update(st.alive)
            destroyed |= st.destroyed
        destroyed -= set(expected)
        assert live == set(expected), (
            f"live {sorted(live)} != ledger {sorted(expected)}: a "
            "retried verb double-applied or a session was lost"
        )
        assert not (live & destroyed), "destroyed session resurrected"
        for sid in sorted(live):
            cp = ctl.checkpoint(sid)
            got = read_pgm(cp["path"])
            want = tchaos.oracle_board(expected[sid], int(cp["turn"]))
            np.testing.assert_array_equal(
                got != 0, want != 0,
                err_msg=f"{sid} diverges from the unfaulted run",
            )
        for o in observers:
            o.final_check()
            assert o.errors == [], o.errors
        assert observers[0].syncs >= 1
        ctl.close()
        boot.close()
    finally:
        for o in observers:
            o.stop()
        if srv2 is not None:
            srv2.shutdown()
        srv.shutdown()


def test_chaos_sigkill_storm_resume(tmp_path):
    """The full scenario with a REAL SIGKILL on the CPU: a `python -m
    gol_tpu_torch --serve --sessions --platform cpu` process killed at a
    seeded verb count and restarted `--resume latest` on the same port —
    bit-identical boards, a consistent ledger, zero invariant violations
    (asserted inside ChaosRunner.run; the report must show the kill),
    the report's keys gol_tpu's."""
    report = tchaos.ChaosRunner(
        seed=1234, workdir=str(tmp_path), storms=2, verbs_per_storm=8,
        kills=1, platform="cpu",
        image_dir=str(tmp_path),
    )
    got = report.run()
    assert got["kills"] == 1
    assert got["invariant_violations"] == 0
    assert got["lockcheck_violations"] == 0
    assert got["sessions_verified"] >= 2  # the pinned pair at least
    assert sorted(got) == sorted([
        "seed", "kills", "verbs", "sessions_verified", "live", "destroyed",
        "observer_syncs", "observer_stalls", "observer_verified_turn",
        "degradations", "recoveries", "invariant_violations",
        "lockcheck_violations"])
    assert len(report.boot_walls) == 2
    assert len(report.metrics_before_kill) == 1
    assert tchaos.parse_metric(report.metrics_after,
                               "gol_tpu_session_dispatches_total") > 0
