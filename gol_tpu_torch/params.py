"""Run parameters — the analog of the reference's `gol.Params` quadruple
(ref: gol/gol.go:4-9) plus the knobs of `gol_tpu.params.Params`, with the
same fields and the same checks.

The fields this port does not run yet (`mesh`, `partition_rules`) are
accepted by name and rejected with "not yet ported", so a caller moving
between the two packages gets a clear error instead of a silently
different run.
"""

from __future__ import annotations

import dataclasses

#: Kernel families selectable via Params.backend / make_stepper /
#: --backend. "cuda-packed" is the hand-written CUDA packed family
#: (ops/cuda_bitlife.py, ops/cuda_bitgens.py) in place of gol_tpu's
#: "pallas-packed"; "auto" picks it on a CUDA device whenever the board
#: packs. "cuda-dense" is the dense CUDA kernel (ops/cuda_life.py) in
#: place of gol_tpu's "pallas"; "auto" never picks it.
BACKENDS = ("auto", "packed", "dense", "cuda-packed", "cuda-dense")


def not_yet_ported(what: str) -> NotImplementedError:
    """The one error every unported feature raises."""
    return NotImplementedError(f"{what}: not yet ported to gol_tpu_torch")


@dataclasses.dataclass(frozen=True)
class Params:
    """Parameters of the Game of Life run (see `gol_tpu.params.Params`
    for the meaning of every field). `threads` is accepted for the
    reference contract; this package runs on one device, and results
    are shard-count independent in both packages."""

    turns: int = 10000000000
    threads: int = 8
    image_width: int = 512
    image_height: int = 512

    rule: "str | object" = "B3/S23"
    chunk: int = 1
    tick_seconds: float = 2.0
    backend: str = "auto"
    image_dir: str = "images"
    out_dir: str = "out"
    autosave_turns: int = 0
    autosave_seconds: float = 0.0
    cycle_detect: bool = False
    tile: int = 0
    mesh: str | None = None
    partition_rules: str | None = None

    def __post_init__(self):
        if self.image_width <= 0 or self.image_height <= 0:
            raise ValueError("image dimensions must be positive")
        if self.turns < 0:
            raise ValueError("turns must be >= 0")
        if self.threads < 1:
            raise ValueError("threads must be >= 1")
        if self.chunk < 0:
            raise ValueError("chunk must be >= 1, or 0 for auto")
        if self.tick_seconds <= 0:
            raise ValueError("tick_seconds must be > 0")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.autosave_turns < 0:
            raise ValueError("autosave_turns must be >= 0")
        if self.autosave_seconds < 0:
            raise ValueError("autosave_seconds must be >= 0")
        if self.tile < 0 or (self.tile and self.tile % 32):
            raise ValueError(
                "tile must be 0 (off) or a positive multiple of 32"
            )
        if self.mesh is not None:
            raise not_yet_ported("2-D device meshes (mesh)")
        if self.partition_rules is not None:
            raise not_yet_ported("partition-rule overrides (partition_rules)")

    @property
    def input_name(self) -> str:
        """Input image stem, `<W>x<H>` (ref: gol/distributor.go:39)."""
        return f"{self.image_width}x{self.image_height}"

    def output_name(self, turn: int | None = None) -> str:
        """Output image stem `<W>x<H>x<turns>` (ref: gol/distributor.go:181,
        's'-snapshot variant ref: gol/distributor.go:230)."""
        t = self.turns if turn is None else turn
        return f"{self.image_width}x{self.image_height}x{t}"
