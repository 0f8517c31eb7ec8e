"""Device plane — the part of `gol_tpu.obs.device` the port runs:

- `cause()` labels WHY device work happened inside a block (the kernel
  build records it — see ops/_build.py);
- `install_compile_watcher()` records every load of the kernels'
  library (`ops/_build.load`: on a cache miss the `nvcc` build and the
  `ctypes` load, on a hit the load alone) as gol_tpu records a backend
  compile: `gol_tpu_device_compiles_total{cause}`,
  `gol_tpu_device_compile_seconds`, a `device.compile` span with the
  cause and a flight note saying whether the library came from the
  cache (`cached=`);
- `observe_split()` records a dispatch's device-vs-host time split;
- `memory_census()` / `observe_memory()` read the CUDA caching
  allocator's statistics (bytes in use, live blocks, the device's
  total memory) into gauges and a process-peak watermark;
- `start_profile()` / `stop_profile()` drive the opt-in
  `--profile-dir` capture with `torch.profiler` and export it as a
  Chrome trace;
- `device_budget()`, `tile_ext_bytes()`, `max_resident_tiles()` and
  `fits()` answer capacity questions from arithmetic alone — the tiled
  stepper's slab bound and the capacity answer price one per-slot
  constant.

- `enable_cost_probes()` / `cost_of()` / `publish_cost()` price one turn
  of a program ("engine.step", "bucket.step") for the accounting plane
  and the `gol_tpu_device_cost_*` gauges. gol_tpu reads the price from
  XLA's `cost_analysis` of a compiled program; here nothing compiles:
  `cost_of` states the port's own count of the work, the integer
  operations per call (the fewest 32-bit instructions per packed word
  that `chip_smoke.py`'s bound counts: 12 for a Life-like rule, 12 for
  a three-state Generations rule, 15 for more states, 9 per 4-cell word
  of the dense layout) and the bytes of each input read once and each
  output written once. So the two packages' prices differ in value for
  the same board; the mechanism (price x turns, split by the bucket
  rule) is the same.

Host-side only: nothing here synchronises the device (the allocator's statistics and `cudaMemGetInfo` read host state). torch is
imported inside the functions that need it.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import threading
import time
from typing import Optional

from gol_tpu_torch import obs
from gol_tpu_torch.obs import flight, tracing

__all__ = [
    "cause",
    "cost_of",
    "cost_probes_enabled",
    "current_cause",
    "device_budget",
    "enable_cost_probes",
    "fits",
    "install_compile_watcher",
    "max_resident_tiles",
    "memory_census",
    "observe_memory",
    "observe_split",
    "profile_window",
    "profiler",
    "publish_cost",
    "start_profile",
    "stop_profile",
    "tile_ext_bytes",
]

CAUSE_UNATTRIBUTED = "unattributed"

_cause_stack = threading.local()


@contextlib.contextmanager
def cause(label: str):
    """Declare why device work inside this block happened (thread-local,
    nestable — innermost wins)."""
    stack = getattr(_cause_stack, "stack", None)
    if stack is None:
        stack = _cause_stack.stack = []
    stack.append(str(label))
    try:
        yield
    finally:
        stack.pop()


def current_cause() -> str:
    stack = getattr(_cause_stack, "stack", None)
    return stack[-1] if stack else CAUSE_UNATTRIBUTED


_SPLIT = {
    p: obs.histogram(
        "gol_tpu_device_dispatch_split_seconds",
        "Per-dispatch wall seconds split at the synchronisation "
        "boundaries: enqueue (dispatch call returning), sync (fetched "
        "buffers materialising = device work + transfer), host (decode "
        "+ event fan-out)",
        {"phase": p},
    ) for p in ("enqueue", "sync", "host")
}
_DEVICE_FRACTION = obs.gauge(
    "gol_tpu_device_fraction",
    "Last fully-split dispatch's sync share of its wall time "
    "(device work + transfer over enqueue+sync+host)",
)


def observe_split(enqueue_s: Optional[float] = None,
                  sync_s: Optional[float] = None,
                  host_s: Optional[float] = None) -> None:
    """Record one dispatch's device-vs-host time split at the boundaries
    the engine already crosses (no added synchronisation): `enqueue` =
    the dispatch call returning, `sync` = the fetched result
    materialising on the host (device work + transfer), `host` = decode
    + event fan-out. Fused chunks report enqueue only (nothing is
    fetched per chunk); diff chunks report all three, and the fraction
    gauge tracks the last fully-split dispatch."""
    for phase, seconds in (("enqueue", enqueue_s), ("sync", sync_s),
                           ("host", host_s)):
        if seconds is not None:
            _SPLIT[phase].observe(seconds)
    if enqueue_s is not None and sync_s is not None and host_s is not None:
        total = enqueue_s + sync_s + host_s
        if total > 0:
            _DEVICE_FRACTION.set(round(sync_s / total, 5))


# --- compile watcher -----------------------------------------------------

_WATCHER_INSTALLED = False
_compiles: dict = {}
_COMPILE_SECONDS = obs.histogram(
    "gol_tpu_device_compile_seconds",
    "Kernel library build (nvcc, on a cache miss) and load wall seconds "
    "per load",
)


def install_compile_watcher() -> bool:
    """Record every load of the kernels' library from now on (count by
    cause, duration histogram, `device.compile` span, flight note).
    Idempotent; always True (the hook is `ops/_build.load`'s own). The
    record is host-side code at the load — a dispatch boundary — and
    no-ops behind the registry flag when the plane is disabled."""
    global _WATCHER_INSTALLED
    _WATCHER_INSTALLED = True
    return True


def record_compile(seconds: float, cached: bool) -> None:
    """One load of the kernels' library that took `seconds` (`cached`:
    the library came from the build cache, so no `nvcc` ran), under the
    current cause; nothing unless the watcher is installed and the
    registry enabled."""
    if not (_WATCHER_INSTALLED and obs.enabled()):
        return
    why = current_cause()
    c = _compiles.get(why)
    if c is None:
        c = _compiles[why] = obs.counter(
            "gol_tpu_device_compiles_total",
            "Kernel library builds and loads by declared cause",
            {"cause": why},
        )
    c.inc()
    _COMPILE_SECONDS.observe(seconds)
    tracing.add_span("device.compile", "device", time.time() - seconds,
                     seconds, {"cause": why, "cached": cached})
    flight.note("device.compile", cause=why, seconds=round(seconds, 4),
                cached=cached)


# --- cost model ----------------------------------------------------------

#: Cost probes are a real-run concern, as in gol_tpu: the CLI enables
#: them so a live `/metrics` carries the cost model, while library
#: embedders and the tests opt in. Explicit `cost_of` / `publish_cost`
#: calls always work.
_COST_PROBES = False

#: Integer operations per 32-bit word per turn (see the module
#: docstring): packed Life-like, packed Generations by state count, and
#: the dense byte-SIMD form (four cells a word).
OPS_PER_WORD_LIFE = 12
OPS_PER_WORD_GENS3 = 12
OPS_PER_WORD_GENS = 15
OPS_PER_WORD_DENSE = 9


def enable_cost_probes(on: bool = True) -> None:
    global _COST_PROBES
    _COST_PROBES = bool(on)


def cost_probes_enabled() -> bool:
    return _COST_PROBES and obs.enabled()


def cost_of(height: int, width: int, rule, layout: str = "packed",
            boards: int = 1) -> dict:
    """Modelled work of ONE turn of `boards` (height, width) boards under
    `rule` (a rule object or its notation) in `layout` ("packed": int32
    words of 32 cells, one plane per live state; "dense": one byte a
    cell): {"flops": integer operations, "bytes_accessed": input read
    once + output written once, "argument_bytes", "output_bytes"} — the
    keys of gol_tpu's `cost_of`, from arithmetic alone (no compile, no
    device). Returns {"error": ...} for an unknown layout or rule
    instead of raising: the price is advisory."""
    try:
        from gol_tpu_torch.models.rules import GenRule, get_rule

        r = get_rule(rule) if isinstance(rule, str) else rule
        cells = int(height) * int(width) * int(boards)
        if layout == "packed":
            words = -(-cells // 32)
            if isinstance(r, GenRule):
                planes = r.states - 1
                per_word = (OPS_PER_WORD_LIFE if r.states == 2
                            else OPS_PER_WORD_GENS3 if r.states == 3
                            else OPS_PER_WORD_GENS)
            else:
                planes, per_word = 1, OPS_PER_WORD_LIFE
            state_bytes = 4 * words * planes
            ops = per_word * words
        elif layout == "dense":
            state_bytes = cells
            ops = OPS_PER_WORD_DENSE * -(-cells // 4)
        else:
            raise ValueError(f"unknown layout {layout!r}")
        return {
            "flops": float(ops),
            "bytes_accessed": float(2 * state_bytes),
            "argument_bytes": state_bytes,
            "output_bytes": state_bytes,
        }
    except Exception as e:
        return {"error": repr(e)}


def publish_cost(program: str, *args, **kw) -> dict:
    """`cost_of(*args, **kw)`, exported as gol_tpu exports it: the price
    lands in the accounting plane (modelled FLOPs = price x dispatched
    turns), as labeled gauges (`gol_tpu_device_cost_{flops,
    bytes_accessed}{program=...}`), a trace event and a flight note.
    `program` must come from a BOUNDED vocabulary ("engine.step",
    "bucket.step") — it is a label."""
    if not obs.enabled():
        return {}
    out = cost_of(*args, **kw)
    if "error" not in out:
        from gol_tpu_torch.obs import accounting

        m = accounting.meter()
        if m is not None:
            m.set_price(program, out)
        obs.gauge(
            "gol_tpu_device_cost_flops",
            "Modelled integer operations per call of the named program",
            {"program": program},
        ).set(out["flops"])
        obs.gauge(
            "gol_tpu_device_cost_bytes_accessed",
            "Modelled bytes accessed per call of the named program",
            {"program": program},
        ).set(out["bytes_accessed"])
    tracing.event("device.cost", "device", program=program, **{
        k: v for k, v in out.items() if not isinstance(v, str)
    })
    flight.note("device.cost", program=program, **out)
    return out


# --- memory census -------------------------------------------------------

_LIVE_BUFFERS = obs.gauge(
    "gol_tpu_device_live_buffers",
    "Active CUDA caching-allocator blocks at the last census",
)
_LIVE_BYTES = obs.gauge(
    "gol_tpu_device_live_bytes",
    "Bytes allocated by the CUDA caching allocator at the last census",
)
_WATERMARK = obs.gauge(
    "gol_tpu_device_hbm_watermark_bytes",
    "Peak device-memory footprint this process observed (the CUDA "
    "caching allocator's allocated bytes at each census)",
)

_census_lock = threading.Lock()
_last_census = 0.0
_peak_bytes = 0.0


def memory_census(dev=None) -> dict:
    """One census of the memory of device `dev` (a torch device or its
    name), host-side only: the CUDA caching allocator's live blocks
    (`active.all.current`) and bytes (`allocated_bytes.all.current`),
    the device's total memory (`torch.cuda.mem_get_info`) as the limit,
    and the process-peak watermark. A CPU device reports no device
    fields (None), as gol_tpu's CPU census does. Updates the gauges and
    returns the numbers."""
    global _peak_bytes
    import torch

    dev = torch.device("cpu" if dev is None else dev)
    live_buffers = live_bytes = in_use = limit = None
    per_device = {}
    if dev.type == "cuda":
        ms = torch.cuda.memory_stats(dev)
        live_buffers = int(ms.get("active.all.current", 0))
        live_bytes = in_use = int(ms.get("allocated_bytes.all.current", 0))
        limit = int(torch.cuda.mem_get_info(dev)[1])
        per_device[str(dev)] = {
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": limit,
        }
    with _census_lock:
        if in_use is not None:
            _peak_bytes = max(_peak_bytes, float(in_use))
        peak = _peak_bytes
    if in_use is not None:
        _LIVE_BUFFERS.set(live_buffers)
        _LIVE_BYTES.set(live_bytes)
        _WATERMARK.set(peak)
    return {
        "live_buffers": live_buffers,
        "live_bytes": live_bytes,
        "bytes_in_use": in_use,
        "bytes_limit": limit,
        "watermark_bytes": peak,
        "per_device": per_device,
    }


def observe_memory(dev=None, min_interval: float = 0.5) -> None:
    """Rate-limited census for dispatch boundaries: the instrumented
    stepper calls this once per multi-turn dispatch; the census itself
    runs at most every `min_interval` seconds, so a fast fused run pays
    one clock read per dispatch and two censuses per second."""
    global _last_census
    if not obs.enabled():
        return
    now = time.monotonic()
    if now - _last_census < min_interval:
        return
    _last_census = now
    with contextlib.suppress(Exception):
        memory_census(dev)


# --- capacity estimation -------------------------------------------------


def device_budget(device=None) -> Optional[int]:
    """Device-memory budget in bytes: the GOL_TPU_DEVICE_BUDGET_BYTES
    override when set (explicit operator intent always wins), else on a
    CUDA device (`device`; None means the current card when there is
    one) its total memory, or the caching allocator's cap where
    `torch.cuda.set_per_process_memory_fraction` set one, else None (the
    CPU has no meaningful ceiling, and fits() answers None rather than
    inventing one)."""
    env = os.environ.get("GOL_TPU_DEVICE_BUDGET_BYTES")
    if env:
        with contextlib.suppress(ValueError):
            return int(env)
    import torch

    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    total = int(torch.cuda.get_device_properties(dev).total_memory)
    fraction = 1.0
    with contextlib.suppress(Exception):
        fraction = float(torch.cuda.get_per_process_memory_fraction(dev))
    return int(total * min(fraction, 1.0)) or None


#: Working-set multiple over one board's bytes: the scanned diff paths
#: keep the carry board, the new board and the stacked per-turn output
#: alive at once; 3x is the boards' own share (the diff STACK is priced
#: separately — it is chunk-bounded by DIFF_STACK_BUDGET already). Also
#: the per-slot multiple of a resident macro-tile (upload slab + stepped
#: result + interiors).
_BOARD_WORKING_SET = 3


def tile_ext_bytes(tile: int, halo_words: int = 1) -> int:
    """Device bytes of ONE resident macro-tile: the ghost-extended
    packed block the activity-driven stepper uploads per dispatch —
    (TILE/32 + 2g) word-rows by (TILE + 64g) columns of 32-bit words
    (parallel/tiled.py geometry). The ONE constant both `fits()`'s
    `resident_tiles` term and `max_resident_tiles` price, so the
    paging policy and the capacity answer cannot disagree."""
    if tile <= 0 or tile % 32 or halo_words < 1:
        raise ValueError(
            f"tile must be a positive multiple of 32 (got {tile}) "
            f"with halo_words >= 1 (got {halo_words})"
        )
    return (tile // 32 + 2 * halo_words) * (tile + 64 * halo_words) * 4


def max_resident_tiles(tile: int, halo_words: int = 1,
                       device=None) -> Optional[int]:
    """How many ghost-extended macro-tiles one device dispatch slab
    may hold: the budget over `tile_ext_bytes` times the same
    working-set multiple `fits()` charges per resident tile. None when
    there is no budget (the tiled stepper then falls back to its own
    conservative default) — never a guess."""
    budget = device_budget(device)
    if budget is None:
        return None
    return max(1, int(budget)
               // (tile_ext_bytes(tile, halo_words) * _BOARD_WORKING_SET))


def fits(height: int, width: int, *, sessions: int = 1,
         packed: Optional[bool] = None,
         diff_stack_bytes: Optional[int] = None,
         resident_tiles: int = 0, tile: int = 0,
         tile_halo_words: int = 1) -> dict:
    """Will this geometry fit device memory — and how far can it grow?
    gol_tpu's `obs.device.fits`, against `device_budget()`.

    Pure arithmetic (never a device call): one packed board is
    H/32 * W * 4 bytes, a dense one H * W; a bucket of S sessions stacks
    S of them; the working set holds ~3 boards' worth plus the engine's
    diff-stack budget when the caller prices a watched run
    (`diff_stack_bytes`), plus `resident_tiles` ghost-extended
    macro-tile slots of side `tile` at the same per-slot constant as the
    tiled stepper's paging policy. The side terms come off the budget
    first; `max_sessions` and `max_board_side` are answered from the
    remainder. With no budget, `fits` and both maxima are None."""
    if height <= 0 or width <= 0 or sessions < 1:
        raise ValueError("need positive geometry and sessions >= 1")
    if resident_tiles < 0:
        raise ValueError("resident_tiles must be >= 0")
    if resident_tiles and not tile:
        raise ValueError(
            "resident_tiles needs tile= (the macro-tile side) to "
            "price a slot"
        )
    if packed is None:
        packed = height % 32 == 0 and height >= 32  # ops.bitlife.packable
    board = (height // 32) * width * 4 if packed else height * width
    bucket = board * sessions
    tile_bytes = (
        resident_tiles * tile_ext_bytes(tile, tile_halo_words)
        * _BOARD_WORKING_SET if resident_tiles else 0
    )
    side_terms = (diff_stack_bytes or 0) + tile_bytes
    need = bucket * _BOARD_WORKING_SET + side_terms
    budget = device_budget()
    out = {
        "height": height,
        "width": width,
        "sessions": sessions,
        "packed": bool(packed),
        "board_bytes": board,
        "bucket_bytes": bucket,
        "resident_tiles": resident_tiles,
        "resident_tile_bytes": tile_bytes,
        "working_set_bytes": need,
        "budget_bytes": budget,
        "fits": None,
        "max_sessions": None,
        "max_board_side": None,
    }
    if budget is None:
        return out
    usable = budget - side_terms
    out["fits"] = need <= budget
    out["headroom_bytes"] = budget - need
    if board > 0 and usable > 0:
        out["max_sessions"] = max(
            0, usable // (board * _BOARD_WORKING_SET)
        )
    # Largest square single board: bytes/cell is 1/8 packed, 1 dense;
    # side rounded down to the packed layout's 32-row granularity so the
    # answer is actually buildable.
    per_cell = 0.125 if packed else 1.0
    if usable > 0:
        side = int((usable / (_BOARD_WORKING_SET * per_cell)) ** 0.5)
        out["max_board_side"] = side // 32 * 32 if packed else side
    return out


# --- profiler driver (--profile-dir) -------------------------------------

_profile: Optional[tuple] = None  # (torch.profiler.profile, directory)
_profile_lock = threading.Lock()


def profiler(cuda: Optional[bool] = None):
    """A `torch.profiler.profile` (not started) of host operators on
    every thread — the engine steps on its own — and, when `cuda`
    (default: a CUDA device is present), of the card's kernels and
    copies; no shapes, no stacks. Where the installed torch has no
    all-threads switch, only the starting thread's operators are
    recorded (the card's activity is recorded either way)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    return profile(activities=activities, record_shapes=False,
                   with_stack=False, **kw)


def start_profile(directory: str, cuda: Optional[bool] = None) -> bool:
    """Start a `profiler(cuda)` capture for the opt-in `--profile-dir`;
    `stop_profile` exports it into `directory` as a Chrome trace. The
    directory is recorded in the span tracer's export metadata; an
    atexit hook stops and exports the capture on unusual exits, though
    callers stop it themselves while CUDA is still up. Returns False
    when the profiler cannot start."""
    global _profile
    with _profile_lock:
        if _profile is not None:
            return True
        try:
            prof = profiler(cuda)
            prof.start()
        except Exception as e:
            flight.note("device.profile_failed", error=repr(e))
            return False
        _profile = (prof, str(directory))
    tracing.set_metadata("profile_dir", str(directory))
    tracing.event("device.profile", "device", dir=str(directory))
    flight.note("device.profile", dir=str(directory))
    atexit.register(stop_profile)
    return True


def stop_profile() -> Optional[str]:
    """Stop the capture and export it as `<dir>/trace-<pid>.json`;
    returns that path (None when no capture ran). Idempotent."""
    global _profile
    with _profile_lock:
        if _profile is None:
            return None
        prof, directory = _profile
        _profile = None
        prof.stop()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"trace-{os.getpid()}.json")
        prof.export_chrome_trace(path)
    flight.note("device.profile_stopped", path=path)
    return path


def profile_window(name: str):
    """A named range on the capture's host timeline (a
    `torch.profiler.record_function`) while a capture runs, else a
    no-op context: the CLI marks `run()` → `FinalTurnComplete` with it,
    the window a device busy share is taken over."""
    if _profile is None:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)
