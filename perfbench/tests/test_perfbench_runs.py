"""Whole runs of each cell's driver on the CPU at a tiny size, with the
look for a card skipped: a sound run comes out correct; the control (the
reference with the torus broken, in the program's place) and each fault
the timed path can have — a step that returns its state unchanged, an
answer altered where it is produced, a count altered where it is
produced — come out not correct, each on a number the check compares;
and nothing the run loads is JAX or the JAX package."""

import json
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from perfbench import run as bench_run

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = {
    "life-5120.batch": ({"width": 64, "height": 64},
                        {"settle_s": 0.3, "chunk": 1024,
                         "reply_timeout_s": 30}),
}


def tiny_run(workload: str, control: bool = False) -> dict:
    """One run of the cell at a tiny size on the CPU; its result."""
    cell = next(c for c in BENCH["workloads"] if c["name"] == workload)
    cfg_over, tr_over = TINY[workload]
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{cell['config']}.json").read_text())
    tr = json.loads((ROOT / "perfbench" / "traffic"
                     / f"{cell['traffic']}.json").read_text())
    result, _ = bench_run.run_cell(
        BENCH, cell, 2147483901, 2.0, False, "cpu", time.monotonic(),
        config={**cfg, **cfg_over}, traffic={**tr, **tr_over},
        control=control)
    return result


def failing(result: dict) -> set:
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("workload", sorted(TINY))
def test_sound_run_is_correct(workload):
    result = tiny_run(workload)
    assert result["correct"] and result["failed"] == 0, result
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    e2e = bench_run.cell_metrics(BENCH, workload, False)
    assert set(result["metrics"]) == {m["name"] for m in e2e}


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_is_not_correct(workload):
    result = tiny_run(workload, control=True)
    assert not result["correct"]
    assert "stage_cells" in failing(result)


def _unchanged(monkeypatch):
    from gol_tpu_torch.ops import bitlife

    monkeypatch.setattr(bitlife, "step_n_packed_raw",
                        lambda p, n, rule=None: p.clone())


def _altered_sync(monkeypatch):
    from gol_tpu_torch import events
    from gol_tpu_torch.engine import distributor

    def altered(turn, world, token=0):
        world = world.copy()
        world[0, 0] ^= 255
        return events.BoardSync(turn, world, token)

    monkeypatch.setattr(distributor, "BoardSync", altered)


def _altered_count(monkeypatch):
    from gol_tpu_torch.ops import bitlife

    real = bitlife.count_packed
    monkeypatch.setattr(bitlife, "count_packed", lambda p: real(p) + 1)


@pytest.mark.parametrize("workload, fault, caught", [
    ("life-5120.batch", _unchanged, {"stage_cells", "window_cells"}),
    ("life-5120.batch", _altered_sync, {"stage_cells", "window_cells"}),
    ("life-5120.batch", _altered_count, {"count_gap"}),
])
def test_fault_is_not_correct(monkeypatch, workload, fault, caught):
    fault(monkeypatch)
    result = tiny_run(workload)
    assert not result["correct"]
    assert failing(result) & caught, result["checks"]


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, sys.argv[1]);"
        "from perfbench.tests import test_perfbench_runs as t;"
        "from perfbench import run;"
        "assert t.tiny_run('life-5120.batch')['correct'];"
        "print(run.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gol_tpu_torch_extra", object())
    assert "gol_tpu" not in bench_run.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert bench_run.banned_modules() == ["jax"]


def test_no_result_without_a_card_or_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "life-5120.batch",
         "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
