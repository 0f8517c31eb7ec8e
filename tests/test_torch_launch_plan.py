"""What the port says about the kernel its packed Life chunks launch,
worked out from the plans with no card: the CUDA wrappers' launch counts
as one registry counter read when the registry is read
(`gol_tpu_stepper_kernel_launches_total{kernel}`), the blocks one launch
occupies (`gol_tpu_stepper_launch_blocks{kernel}`: kernel A's grid at
512², kernel B's 2-D grid at 5120²), the kernel named on the engine's
chunk marks, and the engine on the 512² board through the CUDA packed
backend's route against the benchmark's plain reference."""

import numpy as np
import pytest
import torch

from gol_tpu_torch import Params, obs
from gol_tpu_torch.engine import distributor
from gol_tpu_torch.events import FinalTurnComplete
from gol_tpu_torch.obs import tracing
from gol_tpu_torch.ops import cuda_bitgens, cuda_bitlife, cuda_life
from gol_tpu_torch.parallel.stepper import make_stepper
from perfbench.reference import life as ref

LAUNCHES = "gol_tpu_stepper_kernel_launches_total"
BLOCKS = "gol_tpu_stepper_launch_blocks"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _series(name: str, kernel: str) -> str:
    return f'{name}{{kernel="{kernel}"}}'


def test_launch_counter_reads_the_wrappers_counts(monkeypatch):
    dicts = (cuda_bitlife.LAUNCHES, cuda_bitgens.LAUNCHES,
             cuda_life.LAUNCHES)
    for i, counts in enumerate(dicts):
        for j, kernel in enumerate(counts):
            monkeypatch.setitem(counts, kernel, 1000 * i + 7 * j + 3)
    cuda_bitlife.LAUNCHES["bitlife_resident"] += 5  # a launch counted
    snap = obs.registry().snapshot()
    text = obs.registry().prometheus_text().splitlines()
    for counts in dicts:
        for kernel, n in counts.items():
            entry = snap[_series(LAUNCHES, kernel)]
            assert entry["type"] == "counter" and entry["value"] == n
            assert f"{_series(LAUNCHES, kernel)} {n}" in text
    assert f"# TYPE {LAUNCHES} counter" in text
    assert distributor._METRICS.kernel_launches[0].value == \
        cuda_bitlife.LAUNCHES["bitlife_resident"]


@pytest.mark.parametrize("side, kernel, blocks", [
    (512, "bitlife_resident", 128),
    (5120, "bitlife_tiled", 100),
])
def test_launch_blocks_gauge_is_the_kernels_plan(side, kernel, blocks):
    rows = side // 32
    if kernel == "bitlife_resident":
        want = cuda_bitlife._grid_plan(rows, side).blocks
    else:
        geom = cuda_bitlife._tiled2d_geometry(rows, side, None)
        want = -(-rows // geom.tile_rows) * -(-side // geom.tile_cols)
    assert want == blocks
    assert cuda_bitlife.kernel_plan(rows, side) == (kernel, blocks)
    s = make_stepper(height=side, width=side, device="cpu",
                     backend="cuda-packed")
    assert s.name == "single-cuda-packed" and s.kernel == kernel
    assert obs.registry().snapshot()[_series(BLOCKS, kernel)] == {
        "type": "gauge", "value": float(blocks),
        "help": obs.registry().get(BLOCKS, {"kernel": kernel}).help}


def test_other_backends_name_no_kernel():
    for kw in ({}, {"backend": "packed"}, {"backend": "dense"},
               {"rule": "B2/S/C3", "backend": "cuda-packed"}):
        assert make_stepper(height=64, width=64, device="cpu",
                            **kw).kernel is None


def _run(world: np.ndarray, turns: int, **kw) -> np.ndarray:
    """The engine's board after `turns` turns of `world`, from its
    final alive list."""
    h, w = world.shape
    engine = distributor.Engine(
        Params(turns=turns, image_width=w, image_height=h, **kw),
        emit_flips=False, initial_world=world, device="cpu")
    engine.start()
    final = [ev for ev in engine.events if isinstance(ev, FinalTurnComplete)]
    engine.join(timeout=60)
    assert engine.error is None and len(final) == 1
    board = np.zeros((h, w), np.uint8)
    for c in final[0].alive:
        board[c.y, c.x] = 1
    return board


@pytest.mark.parametrize("chunk", [0, 32])
def test_engine_512_equals_the_plain_reference(tmp_path, chunk):
    soup = ref.soup(512, 512, 2147483901 + chunk)
    n0 = tracing.TRACER.recorded
    got = _run(soup, 128, backend="cuda-packed", chunk=chunk,
               cycle_detect=False, out_dir=str(tmp_path))
    want = ref.run_to(ref.to_bits(soup)[None], [128])[0].numpy()
    assert ref.mismatches(torch.from_numpy(got), torch.from_numpy(want)) == 0
    assert 0 < want.sum() < 512 * 512
    n = tracing.TRACER.recorded - n0
    marks = [r for r in tracing.TRACER.records[-n:]
             if r[1] == "engine.dispatch"]
    assert marks and all(r[6]["kernel"] == "bitlife_resident"
                         for r in marks)
    assert sum(r[6]["turns"] for r in marks) == 128
