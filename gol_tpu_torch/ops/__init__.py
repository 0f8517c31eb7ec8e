from gol_tpu_torch.ops.life import (
    ALIVE,
    alive_cells,
    alive_count,
    from_bits,
    neighbour_counts,
    step,
    step_n,
    step_with_diff,
    to_bits,
)

__all__ = [
    "ALIVE",
    "alive_cells",
    "alive_count",
    "from_bits",
    "neighbour_counts",
    "step",
    "step_n",
    "step_with_diff",
    "to_bits",
]
