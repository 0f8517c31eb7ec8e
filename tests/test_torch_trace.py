"""The port's `utils.trace` against gol_tpu's: the same runs give the
same Timeline spans (kinds and turns) in both packages — one diff chunk,
the per-turn diff path, fused chunks — the ring keeps the newest spans,
the dump is crash-safe, a fused chunk is realized only under a Timeline,
and `--profile-dir` writes a Chrome trace of the CPU operators with the
run's window marked."""

import dataclasses
import glob
import importlib
import json

import pytest
import torch

import gol_tpu
import gol_tpu_torch
from gol_tpu.engine import distributor as jd
from gol_tpu.parallel import stepper as js
from gol_tpu.utils import trace as jtrace
from gol_tpu_torch import cli as tcli
from gol_tpu_torch.engine import distributor as td
from gol_tpu_torch.obs import tracing as ttracing
from gol_tpu_torch.parallel import stepper as ts
from gol_tpu_torch.utils import trace as ttrace
from gol_tpu_torch.utils.trace import Timeline


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(pkg, golden_root, tmp_path, **kw):
    fields = dict(turns=10, threads=1, image_width=64, image_height=64,
                  image_dir=str(golden_root / "images"),
                  out_dir=str(tmp_path / pkg.__name__), tick_seconds=60.0)
    fields.update(kw)
    return pkg.Params(**fields)


@pytest.mark.parametrize("fields,emit_flips,per_turn,want", [
    (dict(chunk=0), True, False, [(10, 10, "diffs")]),
    (dict(chunk=1), True, True, [(t, 1, "diff") for t in range(1, 11)]),
    (dict(turns=20, chunk=8), False, False,
     [(8, 8, "chunk"), (16, 8, "chunk"), (20, 4, "chunk")]),
], ids=["diff-chunk", "per-turn-diff", "fused-chunks"])
def test_timeline_spans_match_gol_tpu(golden_root, tmp_path, fields,
                                      emit_flips, per_turn, want):
    got = []
    for pkg, eng_mod, steppers, tr in (
            (gol_tpu, jd, js, jtrace), (gol_tpu_torch, td, ts, ttrace)):
        p = _params(pkg, golden_root, tmp_path, **fields)
        extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
        stepper = steppers.make_stepper(threads=1, height=64, width=64,
                                        **extra)
        if per_turn:
            stepper = dataclasses.replace(stepper, step_n_with_diffs=None)
        tl = tr.Timeline()
        engine = eng_mod.Engine(p, emit_flips=emit_flips, stepper=stepper,
                                timeline=tl)
        engine.start()
        engine.join(60)
        assert engine.error is None
        assert all(s.seconds > 0 for s in tl.spans)
        summary = tl.summary()
        assert 0 < summary["busy_seconds"] <= summary["wall_seconds"]
        got.append([(s.turn, s.turns, s.kind) for s in tl.spans])
    assert got[1] == got[0] == want


def test_profile_run_returns_engine_and_timeline(golden_root, tmp_path):
    p = _params(gol_tpu_torch, golden_root, tmp_path, turns=20, chunk=8)
    engine, tl = ttrace.profile_run(p, emit_flips=False, device="cpu")
    assert engine.error is None
    assert tl.summary()["turns"] == 20 and tl.summary()["dispatches"] == 3


class _Count(int):
    """A chunk's alive count that records each realization."""

    realized = 0

    def item(self):
        type(self).realized += 1
        return int(self)


@pytest.mark.parametrize("with_timeline", [False, True])
def test_fused_chunks_realize_only_under_a_timeline(golden_root, tmp_path,
                                                    with_timeline):
    """The events-off fast path adds no realization: without a Timeline
    only the final count is realized; with one, each of the 3 chunks
    is too."""
    bare = ts.make_stepper(height=64, width=64, device="cpu")

    def step_n(world, k):
        world, count = bare.step_n(world, k)
        return world, _Count(int(count))

    stepper = dataclasses.replace(bare, step_n=step_n)
    p = _params(gol_tpu_torch, golden_root, tmp_path, turns=20, chunk=8)
    _Count.realized = 0
    engine = td.Engine(p, emit_flips=False, stepper=stepper,
                       timeline=Timeline() if with_timeline else None)
    engine._ticker = lambda: None  # its count requests realize too
    engine.start()
    engine.join(60)
    assert engine.error is None
    assert _Count.realized == (4 if with_timeline else 1)


def test_timeline_ring_keeps_latest_spans_and_counts_dropped():
    for tr in (ttrace, jtrace):
        tl = tr.Timeline(capacity=3)
        for i in range(5):
            tl.record(i + 1, 2, 0.001, "chunk")
        assert [s.turn for s in tl.spans] == [3, 4, 5]
        s = tl.summary()
        assert (s["dispatches"], s["retained"], s["dropped"], s["turns"]) \
            == (5, 3, 2, 10)
        assert s["busy_seconds"] == pytest.approx(0.005)
        assert tr.Timeline(capacity=10).summary()["dropped"] == 0


def test_timeline_dump_is_crash_safe(tmp_path, monkeypatch):
    """dump() writes temp-then-rename: a failure mid-dump leaves the
    previous artifact byte-intact and no temp litter."""
    obs_registry = importlib.import_module("gol_tpu_torch.obs.registry")
    tl = Timeline()
    tl.record(1, 1, 0.001, "chunk")
    out = tmp_path / "timeline.json"
    tl.dump(str(out))
    first = out.read_text()
    assert json.loads(first)["summary"]["dispatches"] == 1

    def boom(src, dst):
        raise OSError("disk full")

    monkeypatch.setattr(obs_registry.os, "replace", boom)
    tl.record(2, 1, 0.001, "chunk")
    with pytest.raises(OSError):
        tl.dump(str(out))
    monkeypatch.undo()
    assert out.read_text() == first
    assert [p for p in tmp_path.iterdir() if p.suffix == ".tmp"] == []


def test_profile_dir_writes_a_chrome_trace_of_cpu_ops(golden_root, tmp_path):
    """`--profile-dir` on the CPU: a Chrome trace holding the engine
    thread's CPU operators and the run() -> FinalTurnComplete window,
    named in the span tracer's metadata; no CUDA activity."""
    prof = tmp_path / "prof"
    assert tcli.main(["-w", "64", "-h", "64", "-turns", "20", "-noVis",
                      "--platform", "cpu", "--images",
                      str(golden_root / "images"), "--out",
                      str(tmp_path / "out"), "--profile-dir",
                      str(prof)]) == 0
    (path,) = glob.glob(str(prof / "trace-*.json"))
    events = json.load(open(path))["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert "cpu_op" in cats and "kernel" not in cats
    (window,) = [e for e in events if e.get("name") == "gol_tpu_torch.run"]
    assert window["dur"] > 0
    assert (ttracing.TRACER.chrome_trace()["metadata"]["profile_dir"]
            == str(prof))
