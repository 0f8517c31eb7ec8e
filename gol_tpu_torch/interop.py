"""State carried between gol_tpu and this package, as numpy.

`gol_tpu` keeps packed boards as uint32 (H/32, W); this package keeps the
same bits in int32 tensors. The conversions here are views, never value
casts, so a board crosses bit-identically in both directions.
"""

from __future__ import annotations

import numpy as np
import torch

from gol_tpu_torch.models.rules import get_rule


def world_from_numpy(world, device="cpu") -> torch.Tensor:
    """{0,255} uint8 (H, W) host world -> uint8 tensor on `device`."""
    arr = np.ascontiguousarray(world)
    if arr.dtype != np.uint8 or arr.ndim != 2:
        raise ValueError(f"world must be 2-D uint8, got {arr.dtype} {arr.shape}")
    return torch.from_numpy(arr.copy()).to(device)


def packed_from_numpy(packed, device="cpu") -> torch.Tensor:
    """uint32 (H/32, W) packed board -> int32 tensor on `device`, the
    same 32 bits per word (a view of the buffer, not a value cast)."""
    arr = np.ascontiguousarray(packed)
    if arr.dtype != np.uint32 or arr.ndim != 2:
        raise ValueError(f"packed board must be 2-D uint32, got {arr.dtype} {arr.shape}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def packed_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 packed tensor (any device) -> uint32 host array, bit-identical."""
    if t.dtype != torch.int32:
        raise TypeError(f"packed board must be int32, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.uint32)


def rule_from_spec(spec: str):
    """B/S (or B/S/C) notation -> this package's rule object."""
    return get_rule(spec)
