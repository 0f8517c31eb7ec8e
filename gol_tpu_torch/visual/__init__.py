"""Visualiser layer: native/headless pixel boards + the event loop."""

from gol_tpu_torch.visual.board import (
    NativeBoard,
    NativeLevelBoard,
    NumpyBoard,
    NumpyLevelBoard,
    make_board,
)
from gol_tpu_torch.visual.loop import run_loop

__all__ = ["NativeBoard", "NativeLevelBoard", "NumpyBoard",
           "NumpyLevelBoard", "make_board", "run_loop"]
