"""Build and load the hand-written CUDA kernels of this package.

`nvcc` compiles each `gol_tpu_torch/csrc/*.cu` into an object file, all
sources at once in parallel (so a cold build takes about as long as its
slowest source, however many sources are added), and links the objects
into one shared library with a plain C interface, loaded with `ctypes`
— no PyTorch headers, so the build takes seconds. The library goes to
`build/gol_tpu_torch/` at the repository root (git-ignored), named by a
hash of the sources, their headers (`csrc/*.cuh`) and the flags, so an
edited source rebuilds and an unchanged one loads from the cache.
Nothing here runs at import: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

from gol_tpu_torch.obs import device

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "gol_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
#: What the last build printed (ptxas register / shared-memory report)
#: and how long it took; empty when the library came from the cache.
build_log = ""
build_seconds = 0.0

_VP, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {
    "bitlife_resident_launch": [_VP, _VP, _I, _I, _I, _I, _U, _U, _I, _I,
                                _I, _I, _I, _I, _VP],
    "bitlife_tiled_launch": [_VP, _VP, _I, _I, _I, _I, _I, _I, _I, _U, _U,
                             _I, _I, _I, _VP],
    "bitgens_resident_launch": [_VP, _VP, _I, _I, _I, _I, _U, _U, _I, _I,
                                _I, _I, _I, _VP],
    "bitgens_tiled_launch": [_VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _U,
                             _U, _I, _I, _VP],
    "life_dense_launch": [_VP, _VP, _VP, _I, _I, _I, _U, _U, _I, _I, _I, _I,
                          _I, _I, _I, _VP, _VP],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of gol_tpu_torch are built from "
            "source at first use"
        )
    return found


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgol_tpu_torch-{h.hexdigest()[:16]}.so"


def _compile(nvcc: str, objdir: str) -> tuple:
    """One `nvcc -c` per source, all started together; then one link.
    Returns (library file, what nvcc printed)."""
    procs = []
    for src in _sources():
        obj = os.path.join(objdir, src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(
            f"nvcc failed building gol_tpu_torch kernels ({failed}):\n"
            + "".join(log)
        )
    lib = os.path.join(objdir, "lib.so")
    link = subprocess.run(
        [nvcc, "-shared", "-o", lib, *(obj for _, obj, _ in procs)],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc failed linking gol_tpu_torch kernels:\n"
                           + link.stdout + link.stderr)
    return lib, "".join(log)


def load() -> ctypes.CDLL:
    """The kernels' library: built on the first call of the process if
    the cache has no library for these sources, then loaded once. The
    load (build included) is what `obs.device`'s compile watcher
    records."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        path = library_path()
        cached = path.exists()
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
                lib, build_log = _compile(nvcc, objdir)
                os.replace(lib, path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.bitlife_error_string.argtypes = [ctypes.c_int]
        lib.bitlife_error_string.restype = ctypes.c_char_p
        device.record_compile(time.perf_counter() - t0, cached)
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        msg = lib.bitlife_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
