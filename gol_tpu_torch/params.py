"""Run parameters — the analog of the reference's `gol.Params` quadruple
(ref: gol/gol.go:4-9) plus the knobs of `gol_tpu.params.Params`, with the
same fields and the same checks.
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


@dataclasses.dataclass(frozen=True)
class Params:
    """Parameters of the Game of Life run (see `gol_tpu.params.Params`
    for the meaning of every field). `threads` is the reference's shard
    request, capped by the devices the run has (one card: one shard);
    `mesh` ("ROWSxCOLS") selects the 2-D mesh backends and
    `partition_rules` overrides the partition table
    (gol_tpu_torch.parallel.partition). Results are shard-count
    independent in both packages."""

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
            # Fail fast on malformed geometry (make_stepper re-parses;
            # this keeps the error at Params construction, where the
            # CLI can attribute it to the flag).
            from gol_tpu_torch.parallel import partition

            try:
                partition.parse_mesh(self.mesh)
            except partition.PartitionError as e:
                raise ValueError(str(e)) from None
        if self.partition_rules is not None:
            from gol_tpu_torch.parallel import partition

            try:
                partition.parse_overrides(self.partition_rules)
            except partition.PartitionError as e:
                raise ValueError(str(e)) from None

    @property
    def input_name(self) -> str:
        """Input image stem, `<W>x<H>` (ref: gol/distributor.go:39)."""
        return f"{self.image_width}x{self.image_height}"

    def output_name(self, turn: int | None = None) -> str:
        """Output image stem `<W>x<H>x<turns>` (ref: gol/distributor.go:181,
        's'-snapshot variant ref: gol/distributor.go:230)."""
        t = self.turns if turn is None else turn
        return f"{self.image_width}x{self.image_height}x{t}"
