"""ASCII board rendering for test-failure diagnostics — the port's copy
of `gol_tpu.utils.visualise`, the analog of the reference's
side-by-side box-drawing diff (ref: util/visualise.go:21-108).

Given two alive-cell sets (got vs want) of a small board, renders them
side by side with box-drawing borders, marking cells present in only one
set so a failing golden test shows *where* the boards diverge."""

from __future__ import annotations

from typing import Iterable, Sequence

from gol_tpu_torch.utils.cell import Cell

_ALIVE = "█"
_DEAD = " "
_ONLY_HERE = "◆"  # alive here, dead in the other board


def board_lines(
    alive: Iterable[Cell], width: int, height: int, other: Iterable[Cell] | None = None
) -> list[str]:
    """Render one board as a list of strings, one per row, boxed.

    Cells alive in `alive` but not in `other` (when given) are marked
    with a diff glyph (ref: util/visualise.go:50-69 marks mismatches)."""
    alive_set = set(alive)
    other_set = set(other) if other is not None else None
    top = "┌" + "─" * width + "┐"
    bot = "└" + "─" * width + "┘"
    lines = [top]
    for y in range(height):
        row = []
        for x in range(width):
            c = Cell(x, y)
            if c in alive_set:
                if other_set is not None and c not in other_set:
                    row.append(_ONLY_HERE)
                else:
                    row.append(_ALIVE)
            else:
                row.append(_DEAD)
        lines.append("│" + "".join(row) + "│")
    lines.append(bot)
    return lines


def alive_cells_to_string(
    got: Sequence[Cell],
    want: Sequence[Cell],
    width: int,
    height: int,
) -> str:
    """Side-by-side "got | want" ASCII diff (ref: util/visualise.go:21-48,
    used by the golden test on 16x16 failures, ref: gol_test.go:49-56)."""
    left = board_lines(got, width, height, other=want)
    right = board_lines(want, width, height, other=got)
    header = f"{'GOT':^{width + 2}}   {'WANT':^{width + 2}}"
    body = "\n".join(f"{l}   {r}" for l, r in zip(left, right))
    return header + "\n" + body
