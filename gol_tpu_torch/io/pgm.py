"""Byte-exact PGM (P5) codec.

The reference streams pixels one byte per Go-channel send through a
long-lived IO goroutine (ref: gol/io.go:66-74,119-123) — a deliberate
coursework bottleneck. This package does whole-array reads and
writes instead; what is preserved byte-for-byte is the on-disk format:

    P5\n<W> <H>\n255\n<row-major raster, one byte per cell, 0 or 255>

(writer ref: gol/io.go:52-59,76-81; reader validation ref:
gol/io.go:100-116; verified against every fixture under the reference's
images/ and check/images/, vendored in fixtures/).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np

from gol_tpu_torch.utils.cell import Cell, cells_from_mask

MAGIC = b"P5"
MAXVAL = 255


def read_pgm(path: str | os.PathLike) -> np.ndarray:
    """Read a P5 PGM into a (H, W) uint8 array with values in {0, 255}.

    Header validation mirrors the reference reader: magic must be P5 and
    maxval must be 255 (ref: gol/io.go:100-116). Unlike the reference —
    which tokenises the whole file with strings.Fields and would corrupt
    rasters containing whitespace bytes (ref: gol/io.go:98-119, safe there
    only because GoL pixels are 0x00/0xFF) — this parser splits only the
    three header fields and treats the rest as binary raster.
    """
    with open(path, "rb") as f:
        data = f.read()

    # Header is exactly three whitespace-terminated fields: magic,
    # "W H", maxval. Comments (#) are not produced by the reference
    # writer but are legal P5; skip them.
    pos = 0
    fields: list[bytes] = []
    while len(fields) < 4:
        # skip whitespace
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{path}: truncated pgm header")
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    pos += 1  # single whitespace byte after maxval, then raster begins

    magic, w_s, h_s, maxval_s = fields
    if magic != MAGIC:
        raise ValueError(f"{path}: not a P5 pgm (magic={magic!r})")
    width, height = int(w_s), int(h_s)
    if int(maxval_s) != MAXVAL:
        raise ValueError(f"{path}: maxval {maxval_s!r} != 255")

    if len(data) - pos < width * height:
        raise ValueError(f"{path}: truncated raster")
    raster = np.frombuffer(data, dtype=np.uint8, count=width * height, offset=pos)
    return raster.reshape(height, width).copy()


def encode_pgm(world: np.ndarray) -> bytes:
    """Serialise a (H, W) uint8 world to reference-identical P5 bytes
    (header format ref: gol/io.go:52-59)."""
    world = np.asarray(world, dtype=np.uint8)
    h, w = world.shape
    return b"P5\n%d %d\n255\n" % (w, h) + world.tobytes()


def write_pgm(path: str | os.PathLike, world: np.ndarray) -> None:
    """Write the world to `path`, creating parent dirs (the reference
    mkdirs `out/`, ref: gol/io.go:43) and fsyncing (ref: gol/io.go:83).

    The write is crash-atomic: bytes land in a same-directory temp file
    that is `os.replace`d over the target only after the fsync. PGM
    snapshots double as checkpoints (SURVEY.md §5), so a process killed
    mid-write must never leave a truncated board under a name the
    resume path would trust. (The reference writes in place,
    ref: gol/io.go:48-87 — a kill mid-write there corrupts the file.)"""
    path = os.fspath(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(path)}.tmp")
    try:
        with open(tmp, "wb") as f:
            f.write(encode_pgm(world))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # Failed writes (ENOSPC, EIO) must not accumulate orphan temp
        # files across a long autosave run.
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def alive_cells_from_pgm(path: str | os.PathLike) -> list[Cell]:
    """Golden-fixture loader: the alive-cell set of a PGM, as Cell(x, y)
    (the analog of the test harness's readAliveCells,
    ref: gol_test.go:88-129)."""
    return cells_from_mask(read_pgm(path))
