"""The engine thread's and the card's phases, counted by the port
itself: drains (a realised count, a fetched board, the calibration's
realisations) and memory censuses on the engine thread, the fused
chunks' device time, the card's idle gaps between them and the run-ahead
by timing events (faked here, so no card is needed) on the world's
stream, the calibration's part of the set-up, the registry switch that
turns all of it off, and the `--profile-dir` export that puts the
tracer's spans beside the profiler's on one clock."""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from gol_tpu_torch import Params, obs
from gol_tpu_torch.engine import distributor
from gol_tpu_torch.engine.distributor import ChunkClock, Engine
from gol_tpu_torch.obs import device, tracing
from gol_tpu_torch.parallel.stepper import make_stepper

DRAIN = 'gol_tpu_engine_thread_seconds{phase="drain"}'
CENSUS = "gol_tpu_device_census_seconds"
AHEAD = "gol_tpu_engine_run_ahead_seconds"
GAP = 'gol_tpu_engine_device_gap_seconds{after="%s"}'
#: The stream the tests' worlds launch on.
STREAM = object()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def value(series: str):
    """A series' value in the registry's snapshot (a histogram's
    (sum, count)), None where it does not exist."""
    entry = obs.registry().snapshot().get(series)
    if entry is None:
        return None
    v = entry["value"]
    return (v["sum"], v["count"]) if isinstance(v, dict) else v


def since(n0: int) -> list:
    """The tracer's records after its first `n0` (`TRACER.recorded`)."""
    n = tracing.TRACER.recorded - n0
    return tracing.TRACER.records[-n:] if n > 0 else []


def records(name: str, n0: int) -> list:
    return [r for r in since(n0) if r[1] == name]


class HostEvent:
    """A timing event whose device time is the host's clock when it is
    recorded: on the CPU a stepper's launches run as they are called,
    so its chunks' intervals are the host's."""

    made = 0
    #: The streams the events were recorded on, in order.
    streams: list = []

    def __init__(self):
        HostEvent.made += 1
        self.t = None

    def record(self, stream=None):
        HostEvent.streams.append(stream)
        self.t = time.perf_counter()

    def query(self):
        return True

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class Card:
    """A scripted card: each event recorded takes the next device time
    of `stamps`, and is complete once `now` has reached it."""

    def __init__(self, stamps):
        self.stamps = iter(stamps)
        self.now = -1.0

    def event(self):
        card = self

        class Event:
            def record(self, stream=None):
                assert stream is STREAM, "recorded off the world's stream"
                self.t = next(card.stamps)

            def query(self):
                return self.t <= card.now

            def elapsed_time(self, other):
                assert self.query() and other.query(), "not complete"
                return (other.t - self.t) * 1e3

        return Event()


def engine(tmp_path, chunk=8, **kw) -> Engine:
    world = (np.random.default_rng(3).random((64, 64)) < 0.3) * 255
    p = Params(turns=10 ** 9, image_width=64, image_height=64, chunk=chunk,
               tick_seconds=60.0, out_dir=str(tmp_path / "out"),
               image_dir=str(tmp_path / "images"))
    e = Engine(p, emit_flips=False, initial_world=world.astype(np.uint8),
               device="cpu", **kw)
    e.timing_event = HostEvent
    return e


def stopped(e: Engine) -> None:
    e.stop()
    e.join(timeout=30)
    assert not e._thread.is_alive() and e.error is None


def until(e: Engine, turn: int) -> None:
    deadline = time.monotonic() + 30
    while e.completed_turns < turn:
        assert time.monotonic() < deadline, "the engine did not advance"
        time.sleep(0.01)


def test_a_served_count_is_a_drain_with_its_span(tmp_path):
    e = engine(tmp_path)
    e.start()
    try:
        until(e, 64)
        before, n0 = value(DRAIN), tracing.TRACER.recorded
        turn, _ = e.alive_count_now(timeout=10)
        assert turn >= 64
        drains = records("engine.drain", n0)
    finally:
        stopped(e)
    assert drains and drains[0][6] == {"kind": "count"}
    assert value(DRAIN) - before >= drains[0][4] >= 0


def test_a_served_board_sync_is_a_drain_of_kind_sync(tmp_path):
    e = engine(tmp_path)
    e.start()
    try:
        until(e, 64)
        before, n0 = value(DRAIN), tracing.TRACER.recorded
        e.request_board_sync(token=7)
        deadline = time.monotonic() + 30
        while not [r for r in records("engine.drain", n0)
                   if r[6] == {"kind": "sync"}]:
            assert time.monotonic() < deadline, "no sync served"
            time.sleep(0.01)
        (sync,) = [r for r in records("engine.drain", n0)
                   if r[6] == {"kind": "sync"}]
    finally:
        stopped(e)
    assert value(DRAIN) - before >= sync[4] >= 0


def censuses_here(n0: int) -> list:
    """`device.census` spans this thread recorded since `n0`."""
    return [r for r in records("device.census", n0)
            if r[5] == threading.get_ident()]


def test_a_census_adds_to_its_counter_and_records_its_span():
    before, n0 = value(CENSUS), tracing.TRACER.recorded
    seconds = device.observe_memory("cpu", min_interval=0.0)
    assert seconds is not None and seconds >= 0
    assert value(CENSUS) - before >= seconds * (1 - 1e-9)
    (span,) = censuses_here(n0)
    assert span[4] == pytest.approx(seconds)


def test_the_instrumented_stepper_takes_no_census(monkeypatch):
    asked = []
    monkeypatch.setattr(device, "observe_memory",
                        lambda dev=None, min_interval=0.5: asked.append(dev))
    s = make_stepper(height=64, width=64, device="cpu")
    diffs = ('gol_tpu_stepper_dispatches_total'
             f'{{backend="{s.name}",entry="step_n_with_diffs"}}')
    before = value(diffs) or 0
    world = s.put(np.zeros((64, 64), np.uint8))
    world, _ = s.step_n(world, 2)
    s.step_n_with_diffs(world, 2)
    assert asked == []
    # The diff call went through the instrumented wrapper.
    assert value(diffs) == before + 1


@pytest.mark.parametrize("invariants", ["off", "on"])
def test_the_engine_takes_the_census_between_a_chunk_and_the_next(
        tmp_path, monkeypatch, invariants):
    monkeypatch.setenv("GOL_TPU_CHECK_INVARIANTS",
                       "1" if invariants == "on" else "0")
    log = []
    monkeypatch.setattr(device, "observe_memory",
                        lambda dev=None, min_interval=0.5:
                        log.append("census") or 0.0)
    for name in ("begin", "end"):
        real = getattr(ChunkClock, name)
        monkeypatch.setattr(
            ChunkClock, name,
            lambda self, *a, _n=name, _f=real: log.append(_n) or _f(self, *a))
    g0 = value(GAP % "census") or 0.0
    e = engine(tmp_path)
    e.start()
    try:
        until(e, 64)
    finally:
        stopped(e)
    if invariants == "on":
        assert e.stepper.step_n.__qualname__.startswith("checked_stepper")
    assert "census" in log
    # No census between a chunk's two events: each follows an end.
    assert all(log[i - 1] == "end" for i, x in enumerate(log)
               if x == "census")
    assert value(GAP % "census") > g0


def test_a_watched_run_takes_a_census_after_each_diff_chunk(
        tmp_path, monkeypatch):
    log = []
    monkeypatch.setattr(device, "observe_memory",
                        lambda dev=None, min_interval=0.5:
                        log.append(dev) or 0.0)
    world = (np.random.default_rng(3).random((64, 64)) < 0.3) * 255
    p = Params(turns=40, image_width=64, image_height=64, chunk=8,
               tick_seconds=60.0, out_dir=str(tmp_path / "out"),
               image_dir=str(tmp_path / "images"))
    e = Engine(p, initial_world=world.astype(np.uint8), device="cpu")
    series = [obs.registry().counter(
        "gol_tpu_stepper_dispatches_total",
        labels={"backend": e.stepper.name, "entry": d})
        for d in ("step_n_with_diffs", "step_n_with_diffs_sparse",
                  "step_n_with_diffs_compact")]
    before = sum(c.value for c in series)
    e.start()
    for _ in e.events:
        pass
    e.join(60)
    assert not e._thread.is_alive() and e.error is None
    chunks = sum(c.value for c in series) - before
    assert chunks > 0 and len(log) == chunks


def test_without_timing_events_fused_chunks_stay_instant_marks(tmp_path):
    n0 = tracing.TRACER.recorded
    e = engine(tmp_path)
    e.timing_event = None  # a CPU world: no clock
    e.start()
    try:
        until(e, 64)
    finally:
        stopped(e)
    assert e._clock is None
    marks = [r for r in records("engine.dispatch", n0)
             if (r[6] or {}).get("kind") == "chunk"]
    assert marks and all(r[0] == "i" for r in marks)


def test_chunks_before_the_first_anchor_stay_instant_marks(tmp_path):
    n0 = tracing.TRACER.recorded
    e = engine(tmp_path)
    e.start()
    try:
        until(e, 64)
    finally:
        stopped(e)
    chunks = [r for r in records("engine.dispatch", n0)
              if (r[6] or {}).get("kind") == "chunk"]
    # Fixed chunks: nothing drains before the run's end, so no anchor
    # dates a chunk and every one keeps its instant mark.
    assert chunks and all(r[0] == "i" for r in chunks)
    assert {r[6]["turn"] for r in chunks} >= set(range(8, 65, 8))


def test_the_cuda_timing_events_go_on_the_world_cards_stream(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: seen.append(dev) or ("stream", dev))
    world = types.SimpleNamespace(device=torch.device("cuda", 1))
    new_event, stream = distributor._cuda_timing(world)
    assert stream == ("stream", torch.device("cuda", 1))
    assert new_event.keywords == {"enable_timing": True}
    assert distributor._cuda_timing(
        types.SimpleNamespace(device=torch.device("cpu"))) == (None, None)


def test_the_engine_records_every_event_on_the_worlds_stream(
        tmp_path, monkeypatch):
    monkeypatch.setattr(distributor, "_cuda_timing",
                        lambda world: (None, STREAM))
    HostEvent.streams = []
    e = engine(tmp_path)
    e.start()
    try:
        until(e, 64)
        e.alive_count_now(timeout=10)  # an anchor
        until(e, e.completed_turns + 64)
    finally:
        stopped(e)
    assert HostEvent.streams and all(s is STREAM
                                     for s in HostEvent.streams)


def test_chunk_clock_reads_device_time_gaps_and_run_ahead(monkeypatch):
    # Record order: anchor, chunks 1-3 (start, end), anchor, chunk 4,
    # chunk 5; device seconds.
    card = Card([0.0, 0.001, 0.101, 0.111, 0.211, 0.212, 0.312,
                 0.313, 0.320, 0.420, 0.420, 0.520])
    clock = ChunkClock(card.event, STREAM)
    gap = GAP
    g0 = {a: value(gap % a) for a in ("drain", "census", "enqueue")}
    a0 = value(AHEAD)
    n0 = tracing.TRACER.recorded

    clock.drained()
    anchor_wall = clock._anchor[1]
    assert clock.begin() is None and clock.end(100, 100)
    clock.census()
    clock.begin()
    clock.end(200, 100)
    clock.begin()
    clock.end(300, 100)
    clock.poll()  # nothing complete yet
    assert records("engine.dispatch", n0) == []
    assert clock.seconds_per_turn is None
    card.now = 0.315
    clock.poll()
    assert clock.seconds_per_turn == pytest.approx(0.001)
    # Chunk 1 had no chunk before it; 2 followed a census, 3 an enqueue.
    assert value(gap % "drain") - g0["drain"] == 0
    assert value(gap % "census") - g0["census"] == pytest.approx(0.010)
    assert value(gap % "enqueue") - g0["enqueue"] == pytest.approx(0.001)
    spans = records("engine.dispatch", n0)
    assert [s[6] for s in spans] == [
        {"kind": "chunk", "turn": t, "turns": 100} for t in (100, 200, 300)]
    assert all(s[5] == tracing.DEVICE_TID for s in spans)
    # Wall seconds near 1.8e9 hold a double to about 0.2 µs.
    assert [s[3] - anchor_wall for s in spans] == pytest.approx(
        [0.001, 0.111, 0.212], abs=1e-6)
    assert [s[4] for s in spans] == pytest.approx([0.1] * 3)

    clock.drained()
    clock.begin()
    clock.end(400, 100)
    clock.begin()
    clock.end(500, 100)
    # Neither has started: 200 turns of 1 ms queued.
    clock.run_ahead()
    ahead = value(AHEAD)
    assert ahead[1] - a0[1] == 1
    assert ahead[0] - a0[0] == pytest.approx(0.2)
    # Chunk 4 started 7 ms after the drain; 37 ms after it, 30 of its
    # turns are done.
    card.now = 0.330
    wall = clock._anchor[1] + 0.037
    monkeypatch.setattr(distributor, "time", types.SimpleNamespace(
        time=lambda: wall, perf_counter=time.perf_counter))
    clock.run_ahead()
    assert value(AHEAD)[0] - ahead[0] == pytest.approx(0.170)
    card.now = 1.0
    clock.poll()
    assert value(gap % "drain") - g0["drain"] == pytest.approx(0.008)
    assert value(gap % "enqueue") - g0["enqueue"] == pytest.approx(0.001)


def test_no_gap_between_chunks_whose_turns_do_not_follow_on():
    card = Card([0.0, 0.1, 0.5, 0.6])
    clock = ChunkClock(card.event, STREAM)
    g0 = sum(value(f'gol_tpu_engine_device_gap_seconds{{after="{a}"}}')
             for a in ("drain", "census", "enqueue"))
    clock.begin()
    clock.end(100, 100)
    clock.begin()
    clock.end(300, 100)  # turns 100-200 ran on another path
    card.now = 1.0
    clock.poll()
    assert sum(value(f'gol_tpu_engine_device_gap_seconds{{after="{a}"}}')
               for a in ("drain", "census", "enqueue")) == g0


def test_the_outstanding_cap_counts_skipped_chunks():
    card = Card(float(i) for i in range(100))
    clock = ChunkClock(card.event, STREAM, cap=2)
    skipped = "gol_tpu_engine_chunk_events_skipped_total"
    s0 = value(skipped)
    clock.drained()
    timed = []
    for i in range(1, 6):
        clock.begin()
        timed.append(clock.end(10 * i, 10))
    assert value(skipped) - s0 == 3
    # A skipped chunk gets no span: the engine keeps its instant mark.
    assert timed == [True, True, False, False, False]
    card.now = 100.0
    clock.poll()
    clock.begin()
    clock.end(60, 10)
    assert value(skipped) - s0 == 3


def test_with_the_registry_off_no_event_is_made_and_nothing_moves(
        tmp_path):
    HostEvent.made = 0
    tracing.TRACER.clear()
    watched = [DRAIN, CENSUS, AHEAD, GAP % "drain",
               'gol_tpu_engine_setup_seconds{phase="calibrate"}']
    before = [value(s) for s in watched]
    obs.set_enabled(False)
    try:
        e = engine(tmp_path, chunk=0)
        e.start()
        try:
            until(e, 256)
            e.alive_count_now(timeout=10)
        finally:
            stopped(e)
    finally:
        obs.set_enabled(True)
    assert HostEvent.made == 0
    assert tracing.TRACER._ring is None
    assert [value(s) for s in watched] == before


def test_fused_chunks_are_spans_on_the_device_track(tmp_path):
    n0 = tracing.TRACER.recorded
    e = engine(tmp_path)
    e.start()
    try:
        until(e, 64)
        e.alive_count_now(timeout=10)  # an anchor
        until(e, e.completed_turns + 64)
    finally:
        stopped(e)
    chunks = [r for r in since(n0) if r[1] == "engine.dispatch"
              and (r[6] or {}).get("kind") == "chunk"]
    spans = [r for r in chunks if r[0] == "X"]
    marks = [r for r in chunks if r[0] == "i"]
    assert spans and all(r[5] == tracing.DEVICE_TID for r in spans)
    assert all(r[6]["turns"] == 8 and r[4] >= 0 for r in spans)
    # Chunks before the first anchor keep their instant marks; every
    # chunk leaves one record, those that end the run included.
    assert marks and max(r[6]["turn"] for r in marks) < min(
        r[6]["turn"] for r in spans)
    assert sorted(r[6]["turn"] for r in chunks) == list(
        range(8, e.completed_turns + 1, 8))
    assert e._clock.seconds_per_turn is not None
    gaps = value(GAP % "drain")
    assert gaps is not None and gaps > 0


def test_the_calibration_is_a_set_up_phase_and_its_realisations_drains(
        tmp_path):
    series = 'gol_tpu_engine_setup_seconds{phase="calibrate"}'
    before = value(series) or 0.0
    n0 = tracing.TRACER.recorded
    e = engine(tmp_path, chunk=0)
    e.start()
    try:
        deadline = time.monotonic() + 60
        while value(series) in (None, before):
            assert time.monotonic() < deadline, "no convergence"
            time.sleep(0.02)
    finally:
        stopped(e)
    assert value(series) > before
    new = since(n0)
    spans = [r[6]["phase"] for r in new if r[1] == "engine.setup"]
    assert spans == ["calibrate"]
    assert any(r[1] == "engine.drain" and r[6] == {"kind": "calibrate"}
               for r in new)


def test_profile_export_puts_a_thread_span_on_the_capture_clock(tmp_path):
    assert device.start_profile(str(tmp_path), cuda=False)
    try:
        t0 = time.time()
        with torch.profiler.record_function("phases.main_mark"):
            time.sleep(0.05)
        t1 = time.time()
        worker = threading.Thread(
            target=lambda: tracing.add_span("phases.thread_mark", "test",
                                            t0, t1 - t0),
            name="phases-worker")
        worker.start()
        worker.join(timeout=10)
        assert not worker.is_alive()
    finally:
        path = device.stop_profile()
    events = json.load(open(path))["traceEvents"]
    (main,) = [e for e in events if e.get("name") == "phases.main_mark"]
    (span,) = [e for e in events if e.get("name") == "phases.thread_mark"]
    assert span["tid"] == worker.ident != threading.get_ident()
    assert abs(span["ts"] - main["ts"]) < 1000
    assert abs(span["ts"] + span["dur"] - main["ts"] - main["dur"]) < 1000
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert names[worker.ident] == "phases-worker"
