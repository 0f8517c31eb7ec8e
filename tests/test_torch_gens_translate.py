"""The Generations steppers' host translation between gray levels and
states, counted by the port: `gol_tpu_stepper_translate_seconds{entry}`
and a `stepper.translate` span inside the `stepper.put` / `stepper.fetch`
span of the call that makes it. A Generations engine records one put
observation when it places its board and one fetch observation a board
it hands over; a Life engine has no such series; `GOL_TPU_METRICS=0`
builds the bare translation."""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from gol_tpu_torch import Params, obs
from gol_tpu_torch.engine.distributor import Engine
from gol_tpu_torch.events import BoardSync
from gol_tpu_torch.models.rules import get_rule
from gol_tpu_torch.obs import tracing
from gol_tpu_torch.ops import generations as gens
from gol_tpu_torch.parallel import stepper as ts

NAME = "gol_tpu_stepper_translate_seconds"
BRAIN = "B2/S/C3"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def observed(entry: str) -> tuple:
    """(sum, count) of the translate histogram for `entry`; (0, 0) where
    it does not exist."""
    m = obs.registry().get(NAME, {"entry": entry})
    return (0.0, 0) if m is None else (m.sum, m.count)


def spans(n0: int, name: str) -> list:
    n = tracing.TRACER.recorded - n0
    return [r for r in (tracing.TRACER.records[-n:] if n > 0 else [])
            if r[1] == name]


def soup(seed: int = 3) -> np.ndarray:
    return ((np.random.default_rng(seed).random((64, 64)) < 0.3)
            * 255).astype(np.uint8)


def engine(tmp_path, rule: str) -> Engine:
    p = Params(turns=10 ** 9, image_width=64, image_height=64, rule=rule,
               chunk=8, tick_seconds=60.0, cycle_detect=False,
               out_dir=str(tmp_path / "out"),
               image_dir=str(tmp_path / "images"))
    return Engine(p, emit_flips=False, initial_world=soup(), device="cpu")


def run_with_a_sync(e: Engine) -> BoardSync:
    """Start `e`, take one board at a boundary after turn 16, stop it."""
    syncs: queue.Queue = queue.Queue()

    def drain():
        for ev in e.events:
            if isinstance(ev, BoardSync):
                syncs.put(ev)

    drainer = threading.Thread(target=drain, daemon=True)
    drainer.start()
    e.start()
    try:
        deadline = time.monotonic() + 30
        while e.completed_turns < 16:
            assert time.monotonic() < deadline, "the engine did not advance"
            time.sleep(0.01)
        e.request_board_sync(token=5)
        ev = syncs.get(timeout=30)
    finally:
        e.stop()
        e.join(timeout=30)
    drainer.join(timeout=30)
    assert not e._thread.is_alive() and e.error is None
    return ev


def test_a_brain_engine_translates_once_at_put_and_once_a_sync(tmp_path):
    put0, fetch0 = observed("put"), observed("fetch")
    n0 = tracing.TRACER.recorded
    e = engine(tmp_path, BRAIN)
    assert e.stepper.name == "generations-packed-1"
    ev = run_with_a_sync(e)
    assert ev.token == 5 and ev.completed_turns >= 16
    # The board comes back as the rule's gray levels.
    assert set(np.unique(ev.world)) <= set(gens.levels(get_rule(BRAIN)).tolist())
    put, fetch = observed("put"), observed("fetch")
    assert put[1] == put0[1] + 1 and put[0] > put0[0]
    assert fetch[1] == fetch0[1] + 1 and fetch[0] > fetch0[0]
    translate = spans(n0, "stepper.translate")
    assert [r[6] for r in translate] == [{"entry": "put"},
                                          {"entry": "fetch"}]
    # Each inside its stepper.put / stepper.fetch span.
    for t, outer in zip(translate, (spans(n0, "stepper.put")[0],
                                    spans(n0, "stepper.fetch")[0])):
        assert outer[3] <= t[3] and t[3] + t[4] <= outer[3] + outer[4] + 1e-6


@pytest.mark.parametrize("backend", ["packed", "dense"])
def test_each_generations_stepper_times_its_translations(backend):
    s = ts.make_stepper(height=64, width=64, rule=BRAIN, backend=backend,
                        device="cpu")
    put0, fetch0 = observed("put"), observed("fetch")
    n0 = tracing.TRACER.recorded
    world = s.put(soup())
    world, _ = s.step_n(world, 3)
    levels = s.fetch(world)
    assert observed("put")[1] == put0[1] + 1
    assert observed("fetch")[1] == fetch0[1] + 1
    assert len(spans(n0, "stepper.translate")) == 2
    # A diff mask passes through untranslated.
    s.fetch(torch.zeros((64, 64), dtype=torch.bool))
    assert observed("fetch")[1] == fetch0[1] + 1
    rule = get_rule(BRAIN)
    want = gens.levels_from_states(gens.step_n_states(
        torch.from_numpy(gens.states_from_levels(soup(), rule)), 3,
        rule).numpy(), rule)
    np.testing.assert_array_equal(levels, want)


def test_a_life_engine_has_no_translate_series(tmp_path):
    for entry in ("put", "fetch"):
        obs.remove(NAME, {"entry": entry})
    n0 = tracing.TRACER.recorded
    e = engine(tmp_path, "B3/S23")
    assert e.stepper.name == "single-packed"
    run_with_a_sync(e)
    assert obs.registry().get(NAME, {"entry": "put"}) is None
    assert obs.registry().get(NAME, {"entry": "fetch"}) is None
    assert not spans(n0, "stepper.translate")
    assert not any(k.startswith(NAME) for k in obs.registry().snapshot())


@pytest.mark.parametrize("backend", ["packed", "dense"])
def test_with_metrics_off_the_translation_runs_bare(backend):
    put0, fetch0 = observed("put"), observed("fetch")
    obs.set_enabled(False)
    try:
        s = ts.make_stepper(height=64, width=64, rule=BRAIN,
                            backend=backend, device="cpu")
        bare = ts._make_stepper(height=64, width=64, rule=BRAIN,
                                backend=backend, device="cpu")
        world = s.put(soup())
        s.fetch(world)
    finally:
        obs.set_enabled(True)
    assert observed("put") == put0 and observed("fetch") == fetch0
    assert s.put.__qualname__ == bare.put.__qualname__
    assert "instrument_stepper" not in s.put.__qualname__
    # Built with metrics on, the same stepper wraps its translation.
    assert ts._translated("put", len) is not len
    obs.set_enabled(False)
    try:
        assert ts._translated("put", len) is len
    finally:
        obs.set_enabled(True)
