"""Visualiser event loop — the port's copy of `gol_tpu.visual.loop`, the
analog of the reference's SDL loop (ref: sdl/loop.go:9-54).

Consumes the engine's event stream and drives a pixel board:
`CellFlipped` flips a pixel, `TurnComplete` presents a frame,
`FinalTurnComplete` (or stream close) tears the window down; any other
event with a non-empty string form is printed as
`Completed Turns N <event>` (ref: sdl/loop.go:36-47). Window keyboard
events for p/s/q/k are forwarded into the engine's keypress queue
(ref: sdl/loop.go:18-27).

The board is windowed when the native core finds libSDL2 at runtime and
headless (shadow framebuffer) otherwise — headless-with-a-shadow-board
is exactly the protocol harness of the reference's `-noVis` tests
(ref: sdl_test.go:18-90), so the same loop serves interactive use and
protocol testing.
"""

from __future__ import annotations

import queue
from typing import Callable, Optional

from gol_tpu_torch.events import (
    CellFlipped,
    FinalTurnComplete,
    FlipBatch,
    TurnComplete,
)
from gol_tpu_torch.params import Params
from gol_tpu_torch.visual.board import make_board

_KEYS = ("p", "s", "q", "k")


def run_loop(
    params: Params,
    events,
    keypresses: Optional[queue.Queue] = None,
    board=None,
    want_window: bool = True,
    on_turn: Optional[Callable[[int, int], None]] = None,
    printer: Callable[[str], None] = print,
    levels: bool = False,
):
    """Drive `board` from `events` until the run ends; returns the board
    (not yet destroyed when the caller supplied it, for assertions).

    `on_turn(completed_turns, board_count)` fires after each rendered
    turn — the hook the protocol tests use to compare the shadow board
    against expected alive counts (ref: sdl_test.go:62-74,110-116).

    `levels=True` builds a gray-level board (multi-state Generations
    rules, r5): FlipBatch events carrying per-cell levels SET those
    cells; the board's count() is the ALIVE (level-255) count."""
    own_board = board is None
    if own_board:
        board = make_board(params.image_width, params.image_height,
                           want_window, levels=levels)

    try:
        while True:
            # Forward pending window keys (ref: sdl/loop.go:14-28).
            while True:
                key = board.poll_key()
                if key is None:
                    break
                if key == "CLOSE":
                    if keypresses is not None:
                        keypresses.put("q")
                elif key in _KEYS and keypresses is not None:
                    keypresses.put(key)

            # Block briefly so key polling stays live even when the
            # engine is quiet (the Go loop busy-polls instead).
            try:
                ev = events.get(timeout=0.05)
            except queue.Empty:
                continue
            if ev is None:  # stream closed (ref: sdl/loop.go:31-34)
                return board

            if isinstance(ev, CellFlipped):
                board.flip(ev.cell.x, ev.cell.y)
            elif isinstance(ev, FlipBatch):
                if getattr(ev, "levels", None) is not None:
                    # Multi-state batch: SET each cell's gray level.
                    board.update_levels(ev.cells, ev.levels)
                else:
                    # One vectorized XOR per turn (the opt-in batch
                    # form — semantically N CellFlipped events).
                    board.flip_batch(ev.cells)
            elif isinstance(ev, TurnComplete):
                board.render()
                if on_turn is not None:
                    on_turn(ev.completed_turns, board.count())
            elif isinstance(ev, FinalTurnComplete):
                return board
            else:
                s = str(ev)
                if s:
                    # (ref: sdl/loop.go:44-47 format)
                    printer(f"Completed Turns {ev.completed_turns:<8}{s}")
    finally:
        if own_board:
            board.destroy()
