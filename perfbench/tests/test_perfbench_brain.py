"""The `brain-5120.batch` cell on the CPU at a tiny size: the Generations
reference (`perfbench/reference/generations.py`) against itself packed
and against the port's plain Generations steps, its frozen level table,
the counted B2/S/C3 form of `yardstick_gens.py`, whole runs of the
cell's driver (a sound run is correct; the control and each fault the
timed path can have are not, each on a number the check compares; no
JAX is loaded), and the cell's two per-layer readers."""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import harness, yardstick, yardstick_gens
from perfbench import run as bench_run
from perfbench.reference import generations as ref
from perfbench.tests.test_perfbench_runs import (_altered_count,
                                                 _altered_sync, failing)

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "brain-5120.batch"
TINY = ({"width": 64, "height": 64},
        {"settle_s": 0.3, "chunk": 1024, "reply_timeout_s": 30})


def states(h: int, w: int, seed: int) -> torch.Tensor:
    """A board of all three states, from a seed."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 3, (h, w), dtype=np.uint8))


def tiny_run(control: bool = False) -> dict:
    """One run of the cell at a tiny size on the CPU; its result."""
    cell = next(c for c in BENCH["workloads"] if c["name"] == CELL)
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{cell['config']}.json").read_text())
    tr = json.loads((ROOT / "perfbench" / "traffic"
                     / f"{cell['traffic']}.json").read_text())
    result, _ = bench_run.run_cell(
        BENCH, cell, 2147483901, 2.0, False, "cpu", time.monotonic(),
        config={**cfg, **TINY[0]}, traffic={**tr, **TINY[1]},
        control=control)
    return result


@pytest.mark.parametrize("shape", [(64, 64), (96, 160)])
@pytest.mark.parametrize("torus", [True, False])
def test_packed_step_equals_dense_step(shape, torus):
    h, w = shape
    dense = states(h, w, h * w + torus)[None]
    packed = ref._pack_states(dense)
    assert torch.equal(ref._unpack_states(packed[0], h), dense[0])
    for _ in range(40):
        dense = ref.step(dense, torus=torus)
        packed = ref.step_packed(packed, torus)
        assert torch.equal(ref._unpack_states(packed[0], h), dense[0])


def test_broken_torus_differs_at_the_edges_only():
    board = ref.to_states(ref.soup(64, 64, 5))
    torus, flat = ref.step(board), ref.step(board, torus=False)
    assert ref.mismatches(torus, flat) > 0
    assert torch.equal(torus[1:-1, 1:-1], flat[1:-1, 1:-1])


@pytest.mark.parametrize("seed", [0, 2147483901])
def test_reference_equals_the_ports_plain_steps(seed):
    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import bitgens
    from gol_tpu_torch.ops import generations as gens

    rule = get_rule("B2/S/C3")
    start = ref.to_states(ref.soup(64, 96, seed))
    turns = [0, 1, 2, 37, 100]
    got = ref.run_to(torch.stack([start] * len(turns)), turns)
    port = torch.from_numpy(gens.states_from_levels(ref.soup(64, 96, seed),
                                                    rule))
    planes = torch.from_numpy(bitgens.pack_states(port, rule).view(np.int32))
    done = 0
    for i, t in enumerate(turns):
        port = gens.step_n_states(port, t - done, rule)
        planes = bitgens.step_n_packed_gens_raw(planes, t - done, rule)
        done = t
        assert torch.equal(got[i], port), t
        np.testing.assert_array_equal(
            bitgens.unpack_states(planes.numpy().view(np.uint32), 64, rule),
            got[i].numpy())
    assert ref.alive(got[-1]) > 0 and (got[-1] == 2).any()


@pytest.mark.parametrize("notation", ["B2/S345/C4", "B36/S23/C5",
                                      "B3/S23/C2"])
def test_dense_step_equals_the_ports_for_other_rules(notation):
    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import generations as gens

    rule = get_rule(notation)
    rng = np.random.default_rng(len(notation))
    a = torch.from_numpy(rng.integers(0, rule.states, (48, 40),
                                      dtype=np.uint8))
    b = a.clone()
    for _ in range(30):
        a, b = ref.step(a, notation), gens.step_states(b, rule)
        assert torch.equal(a, b)
    assert ref.parse(notation)[2] == rule.states


def test_frozen_level_table_is_the_ports():
    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import generations as gens

    assert ref.LEVELS == tuple(gens.levels(get_rule("B2/S/C3")).tolist())
    board = np.array([[0, 255, 170, 1]], np.uint8)
    assert ref.to_states(board).tolist() == [[0, 1, 2, ref.UNKNOWN]]


def test_counted_form_is_brain_in_12_instructions_a_word():
    board = states(128, 96, 3)
    planes = ref._pack_states(board[None])[0]
    nxt, count = yardstick_gens.brain_packed_step_counted(planes)
    assert count == yardstick_gens.BRAIN_OPS_PER_WORD_TURN == 12
    assert torch.equal(ref._unpack_states(nxt, 128), ref.step(board))


def test_brain_roofline_at_the_cells_size():
    words, turns = yardstick.packed_words(5120, 5120), 32
    least = words * turns * 12 / yardstick.INT32_OPS_PER_S
    assert least == pytest.approx(18.81e-6, rel=1e-3)
    share, bound = yardstick_gens.brain_roofline_pct(10, 10 * least * 5,
                                                     words, turns)
    assert bound == "operations" and share == pytest.approx(20.0)
    # One turn a pass: the two planes' bytes bound it.
    share, bound = yardstick_gens.brain_roofline_pct(1, 1.0, words, 1)
    assert bound == "bytes"
    assert share == pytest.approx(100 * 16 * words / 3.35e12)
    assert yardstick_gens.brain_roofline_pct(0, 1.0, words, 32) is None


def test_sound_run_is_correct():
    result = tiny_run()
    assert result["correct"] and result["failed"] == 0, result
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    e2e = bench_run.cell_metrics(BENCH, CELL, False)
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert set(result["metrics"]) == {"cell_updates_per_s", "setup_s"}


def test_control_is_not_correct():
    result = tiny_run(control=True)
    assert not result["correct"]
    assert "stage_cells" in failing(result)


def _unchanged(monkeypatch):
    from gol_tpu_torch.ops import bitgens

    monkeypatch.setattr(bitgens, "step_n_packed_gens_raw",
                        lambda planes, n, rule: planes.clone())


@pytest.mark.parametrize("fault, caught", [
    (_unchanged, {"stage_cells", "window_cells"}),
    (_altered_sync, {"stage_cells", "window_cells"}),
    (_altered_count, {"count_gap"}),
])
def test_fault_is_not_correct(monkeypatch, fault, caught):
    fault(monkeypatch)
    result = tiny_run()
    assert not result["correct"]
    assert failing(result) & caught, result["checks"]


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from perfbench.tests import test_perfbench_brain as t;"
        "from perfbench import run;"
        "assert t.tiny_run()['correct'];"
        "print(run.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import perfbench.reference.generations;"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'gol_tpu', 'gol_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def reader(name):
    return bench_run.load(ROOT / "perfbench" / "metrics" / f"{name}.py",
                          f"perfbench_metric_{name}")


TURNS = 'gol_tpu_engine_turns_total{kind="chunk"}'
PUT = 'gol_tpu_stepper_translate_seconds{entry="put"}'


def brain_seen(trace=True) -> harness.Seen:
    s = harness.Seen({"width": 5120, "height": 5120}, {})
    s.registry = {
        "before": {TURNS: {"type": "counter", "value": 16384.0},
                   PUT: {"type": "histogram", "value": {
                       "buckets": [], "sum": 0.61, "count": 1}}},
        "after": {TURNS: {"type": "counter", "value": 16384.0 * 11},
                  PUT: {"type": "histogram", "value": {
                      "buckets": [], "sum": 0.61, "count": 1}}},
    }
    s.launches = {"before": {"bitgens_tiled": 512},
                  "after": {"bitgens_tiled": 512 * 11}}
    if trace:
        s.trace = {"window_s": 30.0, "busy_s": 29.4, "device_ops": [],
                   "idle_gaps": [],
                   "kernels": {"void bitgens_tiled<0>(unsigned int*)":
                               (4000, 4000 * 94.05e-6),
                               "void bitlife_tiled<0>(unsigned int*)":
                               (7, 1.0)}}
    return s


@pytest.mark.parametrize("name", ["bitgens_tiled_roofline",
                                  "stepper.translate_s"])
def test_new_readers_read_nothing_from_an_empty_run(name):
    assert reader(name).read(harness.Seen({"width": 5120,
                                           "height": 5120}, {})) is None


def test_new_readers_read_their_series():
    s = brain_seen()
    # 32 turns a launch at 94.05 us against an 18.81-us least time.
    assert reader("bitgens_tiled_roofline").read(s) == pytest.approx(
        20.0, rel=1e-3)
    assert reader("stepper.translate_s").read(s) == pytest.approx(0.61)
    assert reader("bitgens_tiled_roofline").read(brain_seen(False)) is None
    # The parent program: no translate series, no share of it.
    s.registry["after"].pop(PUT)
    assert reader("stepper.translate_s").read(s) is None
