"""The `life-512.batch` cell on the CPU at a tiny size: whole runs of its
driver (`drivers/batch_fresh.py`: the batch run, then a fresh soup through
one chunk of the window's length) — a sound run is correct; the control,
a step that returns its state unchanged, one that does so only for
launches longer than 64 turns, and an altered count are not, each on a
number the check compares; no JAX is loaded — and the cell's two
per-layer readers."""

import json
import pathlib
import subprocess
import sys
import time

import pytest

from perfbench import harness
from perfbench import run as bench_run
from perfbench.tests.test_perfbench_runs import (TINY, _altered_count,
                                                 _unchanged, failing)

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "life-512.batch"


def tiny_run(control: bool = False) -> dict:
    """One run of the cell at `test_perfbench_runs.py`'s tiny size (64²,
    chunk 1024) on the CPU; its result."""
    cell = next(c for c in BENCH["workloads"] if c["name"] == CELL)
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{cell['config']}.json").read_text())
    tr = json.loads((ROOT / "perfbench" / "traffic"
                     / f"{cell['traffic']}.json").read_text())
    cfg_over, tr_over = TINY["life-5120.batch"]
    result, _ = bench_run.run_cell(
        BENCH, cell, 2147483901, 2.0, False, "cpu", time.monotonic(),
        config={**cfg, **cfg_over}, traffic={**tr, **tr_over},
        control=control)
    return result


def test_sound_run_is_correct():
    result = tiny_run()
    assert result["correct"] and result["failed"] == 0, result
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"stage_cells", "window_cells",
                                     "count_gap", "fresh_cells"}
    e2e = bench_run.cell_metrics(BENCH, CELL, False)
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert set(result["metrics"]) == {"cell_updates_per_s", "setup_s"}


def test_control_is_not_correct():
    result = tiny_run(control=True)
    assert not result["correct"]
    assert {"stage_cells", "fresh_cells"} <= failing(result)


def _unchanged_past_64(monkeypatch):
    """A step that returns its state unchanged only in launches longer
    than 64 turns: the calibration's first chunks are right, the long
    fused chunks are not."""
    from gol_tpu_torch.ops import bitlife

    real = bitlife.step_n_packed_raw

    def step(p, n, rule=None):
        if n > 64:
            return p.clone()
        return real(p, n) if rule is None else real(p, n, rule)

    monkeypatch.setattr(bitlife, "step_n_packed_raw", step)


@pytest.mark.parametrize("fault, caught", [
    (_unchanged, {"stage_cells", "fresh_cells"}),
    (_unchanged_past_64, {"fresh_cells"}),
    (_altered_count, {"count_gap"}),
])
def test_fault_is_not_correct(monkeypatch, fault, caught):
    fault(monkeypatch)
    result = tiny_run()
    assert not result["correct"]
    assert caught <= failing(result), result["checks"]


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from perfbench.tests import test_perfbench_life512 as t;"
        "from perfbench import run;"
        "assert t.tiny_run()['correct'];"
        "print(run.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def reader(name):
    return bench_run.load(ROOT / "perfbench" / "metrics" / f"{name}.py",
                          f"perfbench_metric_{name}")


TURNS = 'gol_tpu_engine_turns_total{kind="chunk"}'
BLOCKS = 'gol_tpu_stepper_launch_blocks{kernel="bitlife_resident"}'


def life512_seen(trace=True) -> harness.Seen:
    """A window of 10 fused chunks of 65,536 turns, one launch of kernel
    A each, at 50 ms a launch (the least time is 0.3855 ms: 0.771%)."""
    s = harness.Seen({"width": 512, "height": 512}, {})
    s.registry = {
        "before": {TURNS: {"type": "counter", "value": 65536.0},
                   BLOCKS: {"type": "gauge", "value": 8.0}},
        "after": {TURNS: {"type": "counter", "value": 65536.0 * 11},
                  BLOCKS: {"type": "gauge", "value": 8.0}},
    }
    s.launches = {"before": {"bitlife_resident": 40, "bitlife_tiled": 3},
                  "after": {"bitlife_resident": 50, "bitlife_tiled": 5}}
    if trace:
        s.trace = {"window_s": 0.5, "busy_s": 0.5, "device_ops": [],
                   "idle_gaps": [],
                   "kernels": {"void bitlife_resident<0>(unsigned int*)":
                               (10, 10 * 0.05),
                               "void bitlife_tiled<2>(unsigned int*)":
                               (7, 1.0)}}
    return s


@pytest.mark.parametrize("name", ["bitlife_resident_roofline",
                                  "stepper.launch_blocks"])
def test_new_readers_read_nothing_from_an_empty_run(name):
    assert reader(name).read(harness.Seen({"width": 512,
                                           "height": 512}, {})) is None


def test_new_readers_read_their_series():
    s = life512_seen()
    least = 16 * 512 * 65536 * 12 / (132 * 64 * 1980e6)
    assert reader("bitlife_resident_roofline").read(s) == pytest.approx(
        100 * least / 0.05, rel=1e-9)
    assert reader("bitlife_resident_roofline").read(s) == pytest.approx(
        0.771, abs=1e-3)
    assert reader("stepper.launch_blocks").read(s) == 8.0
    assert reader("bitlife_resident_roofline").read(
        life512_seen(False)) is None
    # The parent program: no gauge, no reading.
    s.registry["after"].pop(BLOCKS)
    assert reader("stepper.launch_blocks").read(s) is None
    # The gauge of the kernel the window launched most, not another's.
    s = life512_seen()
    tiled = 'gol_tpu_stepper_launch_blocks{kernel="bitlife_tiled"}'
    s.registry["after"][tiled] = {"type": "gauge", "value": 100.0}
    assert reader("stepper.launch_blocks").read(s) == 8.0
