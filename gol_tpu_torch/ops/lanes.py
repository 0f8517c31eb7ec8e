"""Lane-split (width-chunked) packed stepping — the ``lane-coupled``
kernel layout.

The counterpart of `gol_tpu.ops.lanes`: split the packed board into k
width-chunks, ghost-extend each by ONE column from its ring-neighbour
chunks, run one toroidal turn on the extended chunk, and slice the
interior back out — the extended chunk's own lane wrap only corrupts
the ghost columns, which are discarded. The partition layer selects it
as a named layout (``--partition-rule layout=lane-coupled``).

Each extended chunk's turn goes through
`cuda_bitlife.step_n_packed_kernel_raw` at n = 1: on a CUDA tensor one
launch of kernel A (or kernel B's 2-D entry for a chunk too big for
A), on a CPU tensor the plain step. A turn of a k-chunk board is k
launches.
"""

from __future__ import annotations

import torch

from gol_tpu_torch.models.rules import LIFE, Rule


def lane_split_turn(chunks, turn_fn):
    """One bit-exact turn on a width-split board: each lane chunk is
    ghost-extended by ONE column from its ring-neighbour chunks, the
    toroidal `turn_fn` runs on the extended chunk, and the interior is
    sliced back out."""
    k = len(chunks)
    out = []
    for j in range(k):
        ext = torch.cat(
            [chunks[(j - 1) % k][:, -1:], chunks[j],
             chunks[(j + 1) % k][:, :1]], dim=1,
        )
        out.append(turn_fn(ext)[:, 1:-1].contiguous())
    return tuple(out)


def make_lane_coupled(rule: Rule = LIFE, k: int = 2):
    """``(packed, n) -> packed`` multi-turn function stepping the board
    as k lane-coupled width chunks — the entry the partition table's
    ``layout=lane-coupled`` override selects."""
    from gol_tpu_torch.ops import cuda_bitlife as cb

    def turn_fn(ext):
        return cb.step_n_packed_kernel_raw(ext, 1, rule)

    def step_n_raw(p, n):
        if p.shape[1] % k:
            raise ValueError(
                f"lane-coupled layout needs width words divisible by "
                f"k={k}, got {p.shape[1]}"
            )
        c = p.shape[1] // k
        chunks = tuple(p[:, j * c:(j + 1) * c].contiguous()
                       for j in range(k))
        for _ in range(max(int(n), 0)):
            chunks = lane_split_turn(chunks, turn_fn)
        return torch.cat(chunks, dim=1)

    return step_n_raw
