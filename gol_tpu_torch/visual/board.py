"""Pixel-board bindings — ctypes over the native C++ core, with a pure
NumPy shadow board as fallback; the port's copy of `gol_tpu.visual.board`.

The native core (`gol_tpu_torch/native/board.cpp`, a copy of gol_tpu's)
is the analog of the reference's SDL window wrapper (ref:
sdl/window.go); when libSDL2 is present at runtime it opens a real
window, otherwise it is a headless framebuffer — the stand-in the
reference's tests build by hand (ref: sdl_test.go:18-90, the `-noVis`
shadow board). It is built with `g++` at first use into
`build/gol_tpu_torch/` at the repository root (git-ignored), named by a
hash of the source and the flags, as `ops/_build.py` builds the CUDA
kernels — never beside the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

def _batch_mask(cells, width: int, height: int) -> "np.ndarray | None":
    """(N, 2) x,y pairs -> a {0,1} (H, W) flip mask, or None for an
    empty batch; bounds-checked with the same strictness as per-pixel
    flips. (A FlipBatch never contains duplicates — it comes from a
    mask — so one mask XOR equals N pixel flips.)"""
    cells = np.asarray(cells, dtype=np.int64).reshape(-1, 2)
    if len(cells) == 0:
        return None
    xs, ys = cells[:, 0], cells[:, 1]
    if (xs.min() < 0 or ys.min() < 0
            or int(xs.max()) >= width or int(ys.max()) >= height):
        raise IndexError("pixel out of range")
    mask = np.zeros((height, width), np.uint8)
    mask[ys, xs] = 1
    return mask


_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "board.cpp"
BUILD_DIR = _PKG.parent / "build" / "gol_tpu_torch"
#: The flags of `native/Makefile`.
CXX_FLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-shared")
_build_lock = threading.Lock()


def library_path() -> pathlib.Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgolvis-{h.hexdigest()[:16]}.so"


def build_native() -> pathlib.Path:
    """The native core's library, compiled with g++ into BUILD_DIR
    unless the cache holds it; raises when there is no compiler
    (OSError) or the compile fails (CalledProcessError)."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
            tmp = os.path.join(d, "libgolvis.so")
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE), "-ldl"],
                           check=True, capture_output=True)
            os.replace(tmp, path)
    return path


def _load_native() -> ctypes.CDLL | None:
    """Build (once, cached under BUILD_DIR) and load the native core;
    None when no toolchain is available."""
    with _build_lock:
        try:
            lib = ctypes.CDLL(str(build_native()))
        except (OSError, subprocess.CalledProcessError):
            return None
    lib.golvis_create.restype = ctypes.c_void_p
    lib.golvis_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    for fn, res, args in [
        ("golvis_has_window", ctypes.c_int, [ctypes.c_void_p]),
        ("golvis_flip_pixel", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]),
        ("golvis_set_pixel", ctypes.c_int,
         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
        ("golvis_get_pixel", ctypes.c_int, [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]),
        ("golvis_count_pixels", ctypes.c_long, [ctypes.c_void_p]),
        ("golvis_clear", None, [ctypes.c_void_p]),
        ("golvis_load_mask", None, [ctypes.c_void_p, ctypes.c_char_p]),
        ("golvis_flip_mask", None, [ctypes.c_void_p, ctypes.c_char_p]),
        # Gray-level mode (multi-state rules, r5).
        ("golvis_load_levels", None, [ctypes.c_void_p, ctypes.c_char_p]),
        ("golvis_update_levels", None,
         [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]),
        ("golvis_set_level", ctypes.c_int,
         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
        ("golvis_get_level", ctypes.c_int,
         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]),
        ("golvis_count_level", ctypes.c_long, [ctypes.c_void_p, ctypes.c_int]),
        ("golvis_toggle_mask", None, [ctypes.c_void_p, ctypes.c_char_p]),
        ("golvis_render", None, [ctypes.c_void_p]),
        ("golvis_poll_key", ctypes.c_int, [ctypes.c_void_p]),
        ("golvis_destroy", None, [ctypes.c_void_p]),
    ]:
        f = getattr(lib, fn)
        f.restype = res
        f.argtypes = args
    return lib


_native: ctypes.CDLL | None = None
_native_tried = False


def native_lib() -> ctypes.CDLL | None:
    global _native, _native_tried
    if not _native_tried:
        _native = _load_native()
        _native_tried = True
    return _native


class NativeBoard:
    """ctypes handle over the C++ board (windowed or headless)."""

    def __init__(self, width: int, height: int, want_window: bool = False):
        lib = native_lib()
        if lib is None:
            raise RuntimeError("native visualiser core unavailable")
        self._lib = lib
        self.width, self.height = width, height
        self._h = lib.golvis_create(width, height, 1 if want_window else 0)
        if not self._h:
            raise RuntimeError("golvis_create failed")

    @property
    def has_window(self) -> bool:
        return bool(self._lib.golvis_has_window(self._h))

    def _check(self, rc: int) -> None:
        if rc < 0:
            # The reference panics on out-of-range flips (ref: sdl/window.go:80-82).
            raise IndexError("pixel out of range")

    def flip(self, x: int, y: int) -> None:
        self._check(self._lib.golvis_flip_pixel(self._h, x, y))

    def set(self, x: int, y: int, on: bool) -> None:
        self._check(self._lib.golvis_set_pixel(self._h, x, y, 1 if on else 0))

    def get(self, x: int, y: int) -> bool:
        rc = self._lib.golvis_get_pixel(self._h, x, y)
        self._check(rc)
        return bool(rc)

    def count(self) -> int:
        return self._lib.golvis_count_pixels(self._h)

    def clear(self) -> None:
        self._lib.golvis_clear(self._h)

    def load_mask(self, mask: np.ndarray) -> None:
        self._lib.golvis_load_mask(self._h, self._as_bytes(mask))

    def flip_mask(self, mask: np.ndarray) -> None:
        self._lib.golvis_flip_mask(self._h, self._as_bytes(mask))

    def flip_batch(self, cells) -> None:
        """XOR a whole turn's (x, y) flips in one native call
        (events.FlipBatch payloads)."""
        mask = _batch_mask(cells, self.width, self.height)
        if mask is not None:
            self.flip_mask(mask)

    def _as_bytes(self, mask: np.ndarray) -> bytes:
        m = np.ascontiguousarray(mask, dtype=np.uint8)
        if m.shape != (self.height, self.width):
            raise ValueError(f"mask shape {m.shape} != {(self.height, self.width)}")
        return m.tobytes()

    def render(self) -> None:
        self._lib.golvis_render(self._h)

    def poll_key(self) -> str | None:
        """Next pending key as a one-char string, 'CLOSE' on window close,
        None when no events are pending (headless boards never have any)."""
        k = self._lib.golvis_poll_key(self._h)
        if k == -1:
            return "CLOSE"
        if k > 0 and 32 <= k < 127:
            return chr(k)
        return None

    def destroy(self) -> None:
        if self._h:
            self._lib.golvis_destroy(self._h)
            self._h = None


class NumpyBoard:
    """Pure-python shadow board — same surface, zero dependencies."""

    has_window = False

    def __init__(self, width: int, height: int, want_window: bool = False):
        self.width, self.height = width, height
        self._px = np.zeros((height, width), dtype=bool)

    def _check(self, x: int, y: int) -> None:
        if not (0 <= x < self.width and 0 <= y < self.height):
            raise IndexError("pixel out of range")

    def flip(self, x: int, y: int) -> None:
        self._check(x, y)
        self._px[y, x] ^= True

    def set(self, x: int, y: int, on: bool) -> None:
        self._check(x, y)
        self._px[y, x] = on

    def get(self, x: int, y: int) -> bool:
        self._check(x, y)
        return bool(self._px[y, x])

    def count(self) -> int:
        return int(self._px.sum())

    def clear(self) -> None:
        self._px[:] = False

    def load_mask(self, mask: np.ndarray) -> None:
        self._px[:] = self._checked(mask)

    def flip_mask(self, mask: np.ndarray) -> None:
        self._px ^= self._checked(mask)

    def flip_batch(self, cells) -> None:
        """XOR a whole turn's (x, y) flips vectorized
        (events.FlipBatch payloads)."""
        mask = _batch_mask(cells, self.width, self.height)
        if mask is not None:
            self.flip_mask(mask)

    def _checked(self, mask: np.ndarray) -> np.ndarray:
        # Same strictness as NativeBoard._as_bytes — no silent broadcast.
        m = np.asarray(mask)
        if m.shape != (self.height, self.width):
            raise ValueError(f"mask shape {m.shape} != {(self.height, self.width)}")
        return m != 0

    def render(self) -> None:
        pass

    def poll_key(self) -> str | None:
        return None

    def destroy(self) -> None:
        pass


def _level_batch(cells, levels, width: int, height: int):
    """(N, 2) x,y pairs + (N,) gray levels -> (mask, grid) full-board
    byte arrays for the bulk native call, bounds-checked like
    `_batch_mask`; (None, None) for an empty batch."""
    cells = np.asarray(cells, dtype=np.int64).reshape(-1, 2)
    levels = np.asarray(levels, dtype=np.uint8).reshape(-1)
    if len(cells) != len(levels):
        raise ValueError(f"{len(cells)} cells vs {len(levels)} levels")
    if len(cells) == 0:
        return None, None
    xs, ys = cells[:, 0], cells[:, 1]
    if (xs.min() < 0 or ys.min() < 0
            or int(xs.max()) >= width or int(ys.max()) >= height):
        raise IndexError("pixel out of range")
    mask = np.zeros((height, width), np.uint8)
    grid = np.zeros((height, width), np.uint8)
    mask[ys, xs] = 1
    grid[ys, xs] = levels
    return mask, grid


class NativeLevelBoard(NativeBoard):
    """Gray-level mode over the same native core (multi-state rules):
    levels SET cells, `count()` is the ALIVE (level 255) count, and
    `count_level` gives the per-level histogram the protocol tests
    assert on. Two-state events (flip/flip_batch) toggle dead<->alive
    at the LEVEL semantics — never the raw ARGB XOR, which would turn
    grays into invalid encodings — so both level-board variants agree
    on mixed streams."""

    def flip(self, x: int, y: int) -> None:
        self.set_level(x, y, 0 if self.get_level(x, y) else 255)

    def flip_mask(self, mask: np.ndarray) -> None:
        self._lib.golvis_toggle_mask(self._h, self._as_bytes(mask))

    def load_levels(self, grid: np.ndarray) -> None:
        self._lib.golvis_load_levels(self._h, self._as_bytes(grid))

    def update_levels(self, cells, levels) -> None:
        mask, grid = _level_batch(cells, levels, self.width, self.height)
        if mask is not None:
            self._lib.golvis_update_levels(
                self._h, mask.tobytes(), grid.tobytes()
            )

    def set_level(self, x: int, y: int, level: int) -> None:
        self._check(self._lib.golvis_set_level(self._h, x, y, int(level)))

    def get_level(self, x: int, y: int) -> int:
        rc = self._lib.golvis_get_level(self._h, x, y)
        self._check(rc)
        return rc

    def count(self) -> int:
        return self.count_level(255)

    def count_level(self, level: int) -> int:
        n = self._lib.golvis_count_level(self._h, int(level))
        if n < 0:
            raise ValueError(f"bad level {level}")
        return n


class NumpyLevelBoard:
    """Pure-python gray-level shadow board — the NumpyBoard analog for
    multi-state rules. Storage is the uint8 level grid itself.
    Two-state events toggle dead<->alive at level semantics, matching
    NativeLevelBoard on mixed streams."""

    has_window = False

    def __init__(self, width: int, height: int, want_window: bool = False):
        self.width, self.height = width, height
        self._px = np.zeros((height, width), dtype=np.uint8)

    def flip(self, x: int, y: int) -> None:
        self.set_level(x, y, 0 if self.get_level(x, y) else 255)

    def set(self, x: int, y: int, on: bool) -> None:
        self.set_level(x, y, 255 if on else 0)

    def get(self, x: int, y: int) -> bool:
        return self.get_level(x, y) != 0

    def _checked(self, grid) -> np.ndarray:
        g = np.asarray(grid, np.uint8)
        if g.shape != (self.height, self.width):
            raise ValueError(
                f"grid shape {g.shape} != {(self.height, self.width)}"
            )
        return g

    def load_levels(self, grid) -> None:
        self._px[:] = self._checked(grid)

    def update_levels(self, cells, levels) -> None:
        mask, grid = _level_batch(cells, levels, self.width, self.height)
        if mask is not None:
            self._px = np.where(mask != 0, grid, self._px)

    def flip_batch(self, cells) -> None:
        # Two-state batches still arrive (e.g. a Life peer's board-sync
        # replay): toggle between dead and full-level alive.
        mask = _batch_mask(cells, self.width, self.height)
        if mask is not None:
            self.flip_mask(mask)

    def flip_mask(self, mask: np.ndarray) -> None:
        m = np.asarray(mask)
        if m.shape != (self.height, self.width):
            raise ValueError(
                f"mask shape {m.shape} != {(self.height, self.width)}"
            )
        self._px = np.where(
            m != 0,
            np.where(self._px != 0, 0, 255).astype(np.uint8),
            self._px,
        )

    def set_level(self, x: int, y: int, level: int) -> None:
        if not (0 <= x < self.width and 0 <= y < self.height):
            raise IndexError("pixel out of range")
        if not (0 <= int(level) <= 255):
            # Same error contract as NativeLevelBoard, whose C core
            # returns -1 for an out-of-range level exactly as for an
            # out-of-range pixel — without this the variants diverge
            # (numpy raises OverflowError, or silently wraps on older
            # releases).
            raise IndexError(f"level {level} out of range 0..255")
        self._px[y, x] = level

    def get_level(self, x: int, y: int) -> int:
        if not (0 <= x < self.width and 0 <= y < self.height):
            raise IndexError("pixel out of range")
        return int(self._px[y, x])

    def count(self) -> int:
        return self.count_level(255)  # alive cells, not dying grays

    def count_level(self, level: int) -> int:
        return int((self._px == np.uint8(level)).sum())

    def clear(self) -> None:
        self._px[:] = 0

    def render(self) -> None:
        pass

    def poll_key(self) -> "str | None":
        return None

    def destroy(self) -> None:
        pass


def make_board(width: int, height: int, want_window: bool = False,
               levels: bool = False):
    """Best available board: native (windowed if SDL2 + display exist),
    NumPy shadow board otherwise. `GOL_TPU_NO_NATIVE=1` forces the
    fallback (for tests). `levels=True` builds the gray-level variant
    (multi-state Generations rules, r5)."""
    if os.environ.get("GOL_TPU_NO_NATIVE") != "1":
        try:
            if levels:
                return NativeLevelBoard(width, height, want_window)
            return NativeBoard(width, height, want_window)
        except RuntimeError:
            pass
    if levels:
        return NumpyLevelBoard(width, height, want_window)
    return NumpyBoard(width, height, want_window)
