"""The port's visualiser against gol_tpu's: board backends, the event-loop
protocol, shadow boards driven by each package's engine (equal at every
TurnComplete, two-state and gray-level), and the native core's windowed
ABI against the fake libSDL2 of `tests/fake_sdl.cpp`.

The protocol contract is the reference's TestSdl invariant (ref:
sdl_test.go:93-128): the flips between consecutive TurnCompletes,
applied to a shadow board, reproduce exactly the cells that changed that
turn. The native core is the port's own copy of `board.cpp`, built into
`build/gol_tpu_torch/`.
"""

import json
import os
import pathlib
import queue
import subprocess
import sys

import numpy as np
import pytest
import torch

import gol_tpu
import gol_tpu_torch
from gol_tpu.engine import distributor as jd
from gol_tpu.visual import board as jboard
from gol_tpu.visual.loop import run_loop as jrun_loop
from gol_tpu_torch.engine import distributor as td
from gol_tpu_torch.events import (
    AliveCellsCount,
    CellFlipped,
    FinalTurnComplete,
    State,
    StateChange,
    TurnComplete,
)
from gol_tpu_torch.io.pgm import read_pgm
from gol_tpu_torch.params import Params
from gol_tpu_torch.utils.cell import Cell
from gol_tpu_torch.visual import board as tboard
from gol_tpu_torch.visual.board import (
    NativeBoard,
    NativeLevelBoard,
    NumpyBoard,
    NumpyLevelBoard,
    native_lib,
)
from gol_tpu_torch.visual.loop import run_loop

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_native_core_builds_into_the_build_dir():
    """The port's native core is its own copy of gol_tpu's board.cpp,
    built under build/gol_tpu_torch/ — never beside either source."""
    assert (tboard.SOURCE.read_bytes()
            == (REPO / "gol_tpu" / "native" / "board.cpp").read_bytes())
    lib = native_lib()
    assert lib is not None
    path = tboard.library_path()
    assert path.exists() and path.parent == REPO / "build" / "gol_tpu_torch"
    assert not list((REPO / "gol_tpu_torch" / "native").glob("*.so"))


def _boards():
    yield NumpyBoard
    yield NativeBoard


@pytest.mark.parametrize("cls", _boards())
def test_board_pixel_ops(cls):
    b = cls(8, 4)
    try:
        b.flip(7, 3)
        b.flip(0, 0)
        b.flip(7, 3)  # flip twice = restore (ref: sdl/window.go:78-88)
        assert b.count() == 1
        assert b.get(0, 0) and not b.get(7, 3)
        b.set(1, 1, True)
        assert b.count() == 2
        b.clear()
        assert b.count() == 0
        for x, y in [(8, 0), (0, 4), (-1, 0), (0, -1)]:
            with pytest.raises(IndexError):
                b.flip(x, y)
        assert b.poll_key() is None
        assert not b.has_window  # no SDL2/display here
        b.render()  # headless no-op must not fail
    finally:
        b.destroy()


@pytest.mark.parametrize("cls", _boards())
def test_board_masks(cls):
    b = cls(8, 4)
    try:
        b.load_mask(np.eye(4, 8, dtype=np.uint8) * 255)
        assert b.count() == 4
        b.flip_mask(np.ones((4, 8), np.uint8))
        assert b.count() == 32 - 4
        b.flip_batch(np.array([[0, 0], [1, 1]]))
        assert b.count() == 32 - 2
        with pytest.raises(ValueError):
            b.load_mask(np.zeros((3, 3), np.uint8))
        with pytest.raises(IndexError):
            b.flip_batch(np.array([[8, 0]]))
    finally:
        b.destroy()


def test_run_loop_protocol_scripted():
    """Flips apply, renders fire on TurnComplete, loggable events print
    in the reference format (ref: sdl/loop.go:36-47), FinalTurnComplete
    ends the loop."""
    events = td.EventQueue()
    p = Params(turns=1, threads=1, image_width=4, image_height=4)
    for c in [Cell(0, 0), Cell(1, 1)]:
        events.put(CellFlipped(0, c))
    events.put(TurnComplete(1))
    events.put(AliveCellsCount(1, 2))
    events.put(quit_ev := StateChange(1, State.QUITTING))
    events.put(FinalTurnComplete(1, [Cell(0, 0), Cell(1, 1)]))
    events.put(CellFlipped(1, Cell(3, 3)))  # after final: must be ignored

    lines: list = []
    turns: list = []
    board = NumpyBoard(4, 4)
    out = run_loop(p, events, board=board,
                   on_turn=lambda t, n: turns.append((t, n)),
                   printer=lines.append)
    assert out is board
    assert turns == [(1, 2)]
    assert board.count() == 2
    assert lines == [
        "Completed Turns 1       2 Cells Alive",
        f"Completed Turns 1       {quit_ev}",
    ]


def test_run_loop_forwards_close_and_keys():
    """A board reporting keys/close feeds the keypress queue
    (ref: sdl/loop.go:14-28)."""

    class KeyBoard(NumpyBoard):
        def __init__(self):
            super().__init__(2, 2)
            self.pending = ["s", "p", "x", "CLOSE"]

        def poll_key(self):
            return self.pending.pop(0) if self.pending else None

    events = td.EventQueue()
    events.put(FinalTurnComplete(0, []))
    keys: queue.Queue = queue.Queue()
    run_loop(Params(turns=0, image_width=2, image_height=2), events,
             keypresses=keys, board=KeyBoard())
    got = [keys.get_nowait() for _ in range(keys.qsize())]
    assert got == ["s", "p", "q"]


def _shadow_frames(pkg, eng_mod, loop, board, world, engine_kw, tmp, **kw):
    """Drive `board` from one package's engine; the board's pixels at
    every TurnComplete."""
    p = pkg.Params(image_width=world.shape[1], image_height=world.shape[0],
                   threads=1, tick_seconds=60.0, out_dir=str(tmp), **kw)
    extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
    engine = eng_mod.Engine(p, events=eng_mod.EventQueue(),
                            initial_world=world, **engine_kw, **extra)
    frames = []
    engine.start()
    try:
        loop(p, engine.events, board=board, printer=lambda s: None,
             on_turn=lambda t, n: frames.append((t, n, board._px.copy())))
    finally:
        engine.join(60)
    assert engine.error is None
    return frames


@pytest.mark.parametrize("engine_kw", [{}, {"emit_flip_batches": True}],
                         ids=["per-cell", "flip-batch"])
def test_shadow_board_tracks_engine_like_gol_tpu(golden_root, tmp_path,
                                                 engine_kw):
    """The TestSdl analog: the port's engine drives its loop's shadow
    board, which equals gol_tpu's shadow board at every TurnComplete and
    the golden board at turn 100."""
    world = read_pgm(golden_root / "images" / "64x64.pgm")
    got = _shadow_frames(gol_tpu_torch, td,
                         run_loop, NumpyBoard(64, 64), world, engine_kw,
                         tmp_path / "t", turns=100, chunk=0)
    want = _shadow_frames(gol_tpu, jd, jrun_loop, jboard.NumpyBoard(64, 64),
                          world, engine_kw, tmp_path / "j", turns=100,
                          chunk=0)
    assert [t for t, _, _ in got] == list(range(1, 101))
    assert [(t, n) for t, n, _ in got] == [(t, n) for t, n, _ in want]
    for (t, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"turn {t}")
    golden = read_pgm(golden_root / "check" / "images" / "64x64x100.pgm")
    np.testing.assert_array_equal(got[-1][2], golden != 0)


def _level_boards():
    yield NumpyLevelBoard
    yield NativeLevelBoard


@pytest.mark.parametrize("cls", _level_boards())
def test_level_board_ops(cls):
    b = cls(8, 4)
    try:
        grid = np.zeros((4, 8), np.uint8)
        grid[1, 2], grid[3, 7] = 255, 170
        b.load_levels(grid)
        assert b.count() == 1           # alive = level 255 only
        assert b.count_level(170) == 1
        assert b.count_level(0) == 30
        assert b.get_level(2, 1) == 255 and b.get_level(7, 3) == 170
        b.update_levels(np.array([[2, 1], [0, 0]]), np.array([85, 255]))
        assert b.get_level(2, 1) == 85 and b.get_level(0, 0) == 255
        assert b.count() == 1 and b.count_level(85) == 1
        b.set_level(0, 0, 0)
        assert b.count() == 0
        b.set_level(3, 2, 170)
        b.flip(3, 2)
        assert b.get_level(3, 2) == 0
        b.flip(3, 2)
        assert b.get_level(3, 2) == 255
        b.flip_batch(np.array([[3, 2], [4, 2]]))
        assert b.get_level(3, 2) == 0 and b.get_level(4, 2) == 255
        assert b.count() == 1
        with pytest.raises(IndexError):
            b.update_levels(np.array([[8, 0]]), np.array([1]))
        with pytest.raises((IndexError, ValueError)):
            b.get_level(9, 9)
        for bad in (-1, 256):
            with pytest.raises(IndexError):
                b.set_level(1, 1, bad)
        b.render()
    finally:
        b.destroy()


def test_gens_gray_level_loop_matches_gol_tpu(golden_root, tmp_path):
    """A Brian's Brain run drives a level-mode shadow board through the
    loop; at every turn its gray grid equals the plain oracle's levels
    and gol_tpu's level board (the multi-state analog of ref:
    sdl_test.go:62-74)."""
    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.ops import generations as gens

    rule = get_rule("B2/S/C3")
    world = read_pgm(golden_root / "images" / "64x64.pgm")
    turns = 8
    states = torch.as_tensor(gens.states_from_levels(world, rule))
    grids = {}
    for t in range(1, turns + 1):
        states = gens.step_states(states, rule)
        grids[t] = gens.levels_from_states(states.numpy(), rule)
    kw = dict(turns=turns, rule="B2/S/C3", chunk=1)
    engine_kw = {"emit_flip_batches": True}
    got = _shadow_frames(gol_tpu_torch, td,
                         run_loop, NumpyLevelBoard(64, 64), world, engine_kw,
                         tmp_path / "t", **kw)
    want = _shadow_frames(gol_tpu, jd, jrun_loop,
                          jboard.NumpyLevelBoard(64, 64), world, engine_kw,
                          tmp_path / "j", **kw)
    got = [f for f in got if f[0] > 0]
    assert [t for t, _, _ in got] == list(range(1, turns + 1))
    for (t, n, a), (tj, nj, b) in zip(got, [f for f in want if f[0] > 0]):
        np.testing.assert_array_equal(a, grids[t], err_msg=f"turn {t}")
        np.testing.assert_array_equal(a, b, err_msg=f"turn {t}")
        assert (t, n) == (tj, nj) and n == int((grids[t] == 255).sum())


# --- the windowed ABI against a fake libSDL2 ------------------------------

DRIVER = """
import json
from gol_tpu_torch.visual.board import NativeBoard

b = NativeBoard(8, 4, want_window=True)
out = {"has_window": b.has_window}
b.set(1, 1, True)
b.set(2, 3, True)
b.flip(2, 3)
b.flip(5, 0)
b.render()
keys = []
for _ in range(16):
    k = b.poll_key()
    if k is None:
        break
    keys.append(k)
    if k == "CLOSE":
        break
out["keys"] = keys
out["count"] = b.count()
b.destroy()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def stub_dir(tmp_path_factory) -> pathlib.Path:
    """The fake libSDL2 builds (full and symbol-less) of the read-only
    tests/fake_sdl.cpp, and the port's native core built once."""
    assert native_lib() is not None
    d = tmp_path_factory.mktemp("fake_sdl")
    src = HERE / "fake_sdl.cpp"
    for soname, extra in [
        ("libSDL2-2.0.so.0", []),
        ("libSDL2-nopoll.so", ["-DGOLVIS_OMIT_POLLEVENT"]),
    ]:
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-shared", "-o", str(d / soname),
             str(src)] + extra,
            check=True,
        )
    return d


def run_driver(stub_dir, tmp_path, *, keys="", fail="", lib_dir=None):
    log = tmp_path / "sdl_calls.log"
    ld = str(lib_dir or stub_dir)
    if os.environ.get("LD_LIBRARY_PATH"):
        ld += ":" + os.environ["LD_LIBRARY_PATH"]
    env = {**os.environ, "PYTHONPATH": str(REPO), "LD_LIBRARY_PATH": ld,
           "GOLVIS_FAKE_SDL_LOG": str(log), "GOLVIS_FAKE_SDL_KEYS": keys}
    env.pop("GOLVIS_FAKE_SDL_FAIL", None)
    if fail:
        env["GOLVIS_FAKE_SDL_FAIL"] = fail
    proc = subprocess.run([sys.executable, "-c", DRIVER], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    calls = log.read_text().splitlines() if log.exists() else []
    return out, calls


def test_windowed_lifecycle_and_keycodes(stub_dir, tmp_path):
    out, calls = run_driver(stub_dir, tmp_path, keys="spqk")
    assert out["has_window"] is True
    assert out["keys"] == ["s", "p", "q", "k", "CLOSE"]
    assert out["count"] == 2
    assert "SDL_UpdateTexture lit=2" in calls
    order = [c for c in calls if not c.startswith("SDL_PollEvent")]
    must = ["SDL_Init", "SDL_CreateWindow", "SDL_CreateRenderer",
            "SDL_CreateTexture", "SDL_UpdateTexture lit=2",
            "SDL_RenderClear", "SDL_RenderCopy", "SDL_RenderPresent",
            "SDL_DestroyTexture", "SDL_DestroyRenderer",
            "SDL_DestroyWindow", "SDL_Quit"]
    idx = -1
    for item in must:
        assert item in order, f"{item} never called; got {order}"
        assert order.index(item) > idx, f"{item} out of order in {order}"
        idx = order.index(item)


@pytest.mark.parametrize("fail,called,not_called", [
    ("init", [], ["SDL_CreateWindow", "SDL_Quit"]),
    ("window", ["SDL_Quit"], ["SDL_CreateRenderer"]),
], ids=["init-failure", "window-failure"])
def test_sdl_failure_falls_back_headless(stub_dir, tmp_path, fail, called,
                                         not_called):
    out, calls = run_driver(stub_dir, tmp_path, fail=fail)
    assert out["has_window"] is False
    assert out["count"] == 2  # headless framebuffer still works
    for name in called:
        assert name in calls
    for name in not_called:
        assert name not in calls


def test_missing_symbol_falls_back_headless(stub_dir, tmp_path):
    d = tmp_path / "nopoll"
    d.mkdir()
    (d / "libSDL2-2.0.so.0").symlink_to(stub_dir / "libSDL2-nopoll.so")
    out, calls = run_driver(stub_dir, tmp_path, lib_dir=d)
    assert out["has_window"] is False
    assert out["count"] == 2
    assert "SDL_Init" not in calls
