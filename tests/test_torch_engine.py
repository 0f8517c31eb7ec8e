"""The port's engine against gol_tpu's: `gol_tpu_torch.run(P, device="cpu")`
and `gol_tpu.run(P)` on the same inputs must give the same event streams
(types, turn numbers, per-turn flip sets, final alive set) and the same
PGM bytes — plus the reference's golden boards, the TestAlive first-count
contract, the s/q/p/k verbs, autosave and the cycle fast-forward."""

import csv
import queue
import time

import numpy as np
import pytest
import torch

import gol_tpu
import gol_tpu_torch
from gol_tpu_torch.engine.distributor import Engine
from gol_tpu_torch.events import (
    AliveCellsCount,
    FinalTurnComplete,
    State,
    StateChange,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def csv_counts(golden_root, size):
    with open(golden_root / "check" / "alive" / f"{size}.csv") as f:
        return {int(r["completed_turns"]): int(r["alive_cells"])
                for r in csv.DictReader(f)}


def params_kw(golden_root, out, **kw):
    d = dict(image_dir=str(golden_root / "images"), out_dir=str(out),
             tick_seconds=60.0)  # keep the ticker quiet
    d.update(kw)
    return d


def normalize(evs):
    """Package-neutral event tuples (AliveCellsCount is timing-dependent
    and compared separately)."""
    out = []
    for e in evs:
        name = type(e).__name__
        if name == "AliveCellsCount":
            continue
        if name == "CellFlipped":
            payload = tuple(e.cell)
        elif name == "FinalTurnComplete":
            payload = tuple(map(tuple, e.alive))
        elif name == "ImageOutputComplete":
            payload = e.filename
        elif name == "StateChange":
            payload = e.new_state.name
        else:
            payload = None
        out.append((name, e.completed_turns, payload))
    return out


def run_both(golden_root, tmp_path, keys=(), engine_kw=None, **kw):
    """Run both packages on the same Params (and the same pre-queued key
    script); returns the two event lists and output directories."""
    engine_kw = engine_kw or {}
    results = []
    for pkg, tag in ((gol_tpu, "jax"), (gol_tpu_torch, "torch")):
        out = tmp_path / tag
        q: queue.Queue = queue.Queue()
        for k in keys:
            q.put(k)
        extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
        events = pkg.run(pkg.Params(**params_kw(golden_root, out, **kw)),
                         keypresses=q, **extra, **engine_kw)
        results.append((list(events), out))
    return results


def assert_same_outputs(jout, tout):
    jfiles = sorted(p.name for p in jout.glob("*.pgm"))
    assert jfiles == sorted(p.name for p in tout.glob("*.pgm"))
    for name in jfiles:
        assert (jout / name).read_bytes() == (tout / name).read_bytes(), name


@pytest.mark.parametrize("size,turns", [(16, 100), (64, 30)])
def test_event_streams_with_flips_equal(golden_root, tmp_path, size, turns):
    (jevs, jout), (tevs, tout) = run_both(
        golden_root, tmp_path, image_width=size, image_height=size,
        turns=turns, threads=1)
    nj, nt = normalize(jevs), normalize(tevs)
    assert [n for n, *_ in nt].count("TurnComplete") == turns
    assert nj == nt
    assert_same_outputs(jout, tout)


@pytest.mark.parametrize("size,chunk", [(64, 0), (64, 7), (512, 0), (512, 25)])
def test_headless_streams_equal(golden_root, tmp_path, size, chunk):
    (jevs, jout), (tevs, tout) = run_both(
        golden_root, tmp_path, engine_kw={"emit_flips": False},
        image_width=size, image_height=size, turns=100, chunk=chunk)
    assert normalize(jevs) == normalize(tevs)
    assert_same_outputs(jout, tout)
    golden = (golden_root / "check" / "images" / f"{size}x{size}x100.pgm")
    assert (tout / f"{size}x{size}x100.pgm").read_bytes() == golden.read_bytes()


def test_per_turn_events_without_flips_equal(golden_root, tmp_path):
    (jevs, _), (tevs, _) = run_both(
        golden_root, tmp_path,
        engine_kw={"emit_flips": False, "emit_turns": True},
        image_width=64, image_height=64, turns=70, chunk=16)
    assert normalize(jevs) == normalize(tevs)
    assert [n for n, *_ in normalize(tevs)].count("TurnComplete") == 70


@pytest.mark.parametrize("backend", ["dense", "packed", "cuda-packed"])
def test_backends_on_cpu_match_golden(golden_root, tmp_path, backend):
    p = gol_tpu_torch.Params(**params_kw(
        golden_root, tmp_path, image_width=64, image_height=64, turns=100,
        backend=backend))
    engine = Engine(p, emit_flips=False, device="cpu")
    want = {"dense": "single", "packed": "single-packed",
            "cuda-packed": "single-cuda-packed"}[backend]
    assert engine.stepper.name == want
    engine.start()
    list(engine.events)
    assert engine.error is None
    assert ((tmp_path / "64x64x100.pgm").read_bytes()
            == (golden_root / "check" / "images" / "64x64x100.pgm").read_bytes())


def test_first_alive_count_within_5s_matches_csv(golden_root, tmp_path):
    """TestAlive (ref: count_test.go:17-69): the first AliveCellsCount
    arrives within 5 s and every count matches the golden CSV."""
    counts = csv_counts(golden_root, "512x512")
    keys: queue.Queue = queue.Queue()
    p = gol_tpu_torch.Params(**params_kw(
        golden_root, tmp_path, image_width=512, image_height=512,
        turns=100_000_000, tick_seconds=0.25))
    events = gol_tpu_torch.run(p, keypresses=keys, emit_flips=False,
                               device="cpu")
    initial = int(np.count_nonzero(
        gol_tpu_torch.io.read_pgm(golden_root / "images" / "512x512.pgm")))
    good = 0
    ev = events.get(timeout=5.0)
    while good < 5:
        assert ev is not None, "stream closed before 5 alive-count reports"
        if isinstance(ev, AliveCellsCount):
            t = ev.completed_turns
            want = initial if t == 0 else counts[t] if t <= 10000 else (
                5565 if t % 2 == 0 else 5567)
            assert ev.cells_count == want, f"turn {t}"
            good += 1
        ev = events.get(timeout=5.0)
    keys.put("q")
    rest = [ev] + list(events)
    assert any(isinstance(e, StateChange) and e.new_state == State.QUITTING
               for e in rest)
    assert not any(isinstance(e, FinalTurnComplete) for e in rest)


@pytest.mark.parametrize("keys", [("s",), ("p", "p"), ("q",), ("k",),
                                  ("s", "p", "p", "q")])
def test_verbs_emit_the_same_events(golden_root, tmp_path, keys):
    """A key script queued before the run starts is served at the first
    dispatch boundary in both engines: same events, same snapshots. An
    's' snapshot lands from the IO thread, so its ImageOutputComplete
    may interleave with the verbs that follow it: those events are
    compared as a multiset, the rest in order."""
    (jevs, jout), (tevs, tout) = run_both(
        golden_root, tmp_path, keys=keys, engine_kw={"emit_flips": False},
        image_width=64, image_height=64, turns=50, chunk=8)

    def split(evs):
        n = normalize(evs)
        io = sorted(e for e in n if e[0] == "ImageOutputComplete")
        return [e for e in n if e[0] != "ImageOutputComplete"], io

    assert split(jevs) == split(tevs)
    assert_same_outputs(jout, tout)


def test_autosave_snapshots_equal(golden_root, tmp_path):
    (jevs, jout), (tevs, tout) = run_both(
        golden_root, tmp_path, engine_kw={"emit_flips": False},
        image_width=64, image_height=64, turns=100, chunk=16,
        autosave_turns=25)
    assert normalize(jevs) == normalize(tevs)
    assert_same_outputs(jout, tout)
    assert (tout / "64x64x75.pgm").exists()


def test_cycle_detect_skips_equal_turns(tmp_path):
    """A blinker is period 2: the fast-forward collapses an astronomical
    run, and the final board equals gol_tpu's."""
    world = np.zeros((64, 64), np.uint8)
    world[10, 10:13] = 255
    turns = 10**12 + 1
    finals = []
    for pkg, tag in ((gol_tpu, "jax"), (gol_tpu_torch, "torch")):
        p = pkg.Params(turns=turns, image_width=64, image_height=64,
                       chunk=4, cycle_detect=True, out_dir=str(tmp_path / tag),
                       tick_seconds=60.0)
        kw = {"device": "cpu"} if pkg is gol_tpu_torch else {}
        engine = pkg.engine.distributor.Engine(
            p, emit_flips=False, initial_world=world,
            cycle_check_seconds=0.05, **kw)
        engine.start()
        evs = list(engine.events)
        engine.join(30)
        assert engine.error is None and engine.skipped_turns > 0
        finals.append(normalize(evs))
    assert finals[0] == finals[1]
    final = [e for e in finals[1] if e[0] == "FinalTurnComplete"][0]
    assert final[1] == turns
    assert final[2] == ((11, 9), (11, 10), (11, 11))  # odd turn: vertical


def test_engine_error_closes_stream(tmp_path):
    p = gol_tpu_torch.Params(turns=5, image_width=16, image_height=16,
                             image_dir=str(tmp_path / "missing"),
                             out_dir=str(tmp_path / "out"), tick_seconds=60.0)
    engine = Engine(p, emit_flips=False, device="cpu")
    engine.start()
    evs = list(engine.events)
    engine.join(5)
    assert engine.error is not None
    assert not any(isinstance(e, FinalTurnComplete) for e in evs)


def test_stop_api_and_accounting(golden_root, tmp_path):
    """Engine.stop() ends an effectively-infinite run cleanly, and the
    run's dispatches are counted and charged to the legacy tenant."""
    from gol_tpu_torch import obs
    from gol_tpu_torch.obs import accounting

    before = accounting.meter().totals(accounting.LEGACY).get("turns", 0.0)
    chunks = obs.counter("gol_tpu_engine_dispatches_total", labels={"kind": "chunk"})
    chunks_before = chunks.value
    p = gol_tpu_torch.Params(**params_kw(
        golden_root, tmp_path, image_width=16, image_height=16,
        turns=10**9, chunk=4))
    engine = Engine(p, emit_flips=False, device="cpu")
    engine.start()
    deadline = time.monotonic() + 30
    while engine.completed_turns < 8 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert engine.completed_turns >= 8
    turn, count = engine.alive_count_now(timeout=10.0)
    assert turn > 0 and count >= 0
    engine.stop()
    engine.join(30)
    assert not engine._thread.is_alive()
    evs = list(engine.events)
    assert type(evs[-1]).__name__ == "StateChange"
    assert evs[-1].new_state == State.QUITTING
    done = engine.completed_turns
    assert accounting.meter().totals(accounting.LEGACY)["turns"] - before == done
    assert chunks.value - chunks_before == done // 4
