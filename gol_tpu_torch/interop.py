"""State carried between gol_tpu and this package, as numpy: boards,
packed words and planes, and the sharded worlds of rings and meshes.

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


def _words_from_numpy(words, ndim: int, what: str, device) -> torch.Tensor:
    arr = np.ascontiguousarray(words)
    if arr.dtype != np.uint32 or arr.ndim != ndim:
        raise ValueError(f"{what} must be {ndim}-D uint32, got {arr.dtype} {arr.shape}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def _words_to_numpy(t: torch.Tensor, ndim: int, what: str) -> np.ndarray:
    if t.dtype != torch.int32 or t.dim() != ndim:
        raise TypeError(f"{what} must be a {ndim}-D int32 tensor, got "
                        f"{t.dtype} {tuple(t.shape)}")
    return t.detach().cpu().numpy().view(np.uint32)


def packed_from_numpy(packed, device="cpu") -> torch.Tensor:
    """uint32 (H/32, W) packed board -> int32 tensor on `device`, the
    same 32 bits per word (a view of the buffer, not a value cast)."""
    return _words_from_numpy(packed, 2, "packed board", device)


def packed_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 packed tensor (any device) -> uint32 host array, bit-identical."""
    return _words_to_numpy(t, 2, "packed board")


def planes_from_numpy(planes, device="cpu") -> torch.Tensor:
    """uint32 (C-1, H/32, W) one-hot Generations planes -> int32 tensor
    on `device`, the same 32 bits per word (a view, not a value cast)."""
    return _words_from_numpy(planes, 3, "planes", device)


def planes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 plane stack (any device) -> uint32 host array, bit-identical."""
    return _words_to_numpy(t, 3, "planes")


def rule_from_spec(spec: str):
    """B/S (or B/S/C) notation -> this package's rule object."""
    return get_rule(spec)


def sharded_to_numpy(world) -> np.ndarray:
    """A ring's or mesh's world (`partition.Sharded`) -> its global host
    array in gol_tpu's global layout: packed words and Generations planes
    as uint32, dense boards and state grids as uint8, a balanced split's
    padding rows included — what `np.asarray` gives of gol_tpu's sharded
    world."""
    return world.numpy()


def sharded_from_numpy(array, like):
    """gol_tpu's global sharded world as a host array (`np.asarray` of
    it: packed words, planes or dense rows, padding included) -> a world
    placed as `like` is (same stepper, same shape), so both packages
    can start from the same mid-run state."""
    arr = np.asarray(array)
    if arr.shape != tuple(like.shape):
        raise ValueError(f"global world of shape {arr.shape} does not "
                         f"match the placed shape {tuple(like.shape)}")
    if (arr.dtype == np.uint32) != (like.dtype == torch.int32):
        raise ValueError(f"a {arr.dtype} world cannot be placed as "
                         f"{like.dtype} shards")
    return like.sharding.place(arr)
