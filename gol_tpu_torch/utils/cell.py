"""The test-facing coordinate type (ref: util/cell.go:4-6).

`x` is the column, `y` is the row — the convention of the reference's
`calculateAliveCells` (ref: gol/distributor.go:420-432). This framework
uses that one convention everywhere, eliminating the reference's
axis-swap quirks (SURVEY.md §2 "Known behavioral quirks")."""

from typing import NamedTuple


class Cell(NamedTuple):
    x: int
    y: int


def cells_from_mask(arr) -> "list[Cell]":
    """Coordinates of nonzero entries of a (H, W) array as Cell(x=col, y=row).

    The single conversion point between array indexing (row, col) and the
    test-facing Cell convention — keep it unique so the contract cannot
    diverge between event payloads and fixture loaders."""
    import numpy as np

    ys, xs = np.nonzero(np.asarray(arr))
    return [Cell(int(x), int(y)) for x, y in zip(xs, ys)]


def xy_from_mask(arr) -> "object":
    """Nonzero coordinates of a (H, W) array as an (N, 2) int32 ndarray
    of (x, y) pairs — the vectorized form of `cells_from_mask`, in the
    SAME row-major order (events.FlipBatch payloads)."""
    import numpy as np

    ys, xs = np.nonzero(np.asarray(arr))
    return np.column_stack([xs, ys]).astype(np.int32)
