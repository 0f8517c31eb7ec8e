"""Device plane — the part of `gol_tpu.obs.device` the port runs:

- `cause()` labels WHY device work happened inside a block (the kernel
  build records it — see ops/_build.py);
- `observe_split()` records a dispatch's device-vs-host time split;
- `memory_census()` / `observe_memory()` read the CUDA caching
  allocator's statistics (bytes in use, live blocks, the device's
  total memory) into gauges and a process-peak watermark;
- `start_profile()` / `stop_profile()` drive the opt-in
  `--profile-dir` capture with `torch.profiler` and export it as a
  Chrome trace.

gol_tpu's compile watcher and XLA cost probes have no counterpart here
yet. Host-side only: nothing here synchronises the device (the
allocator's statistics and `cudaMemGetInfo` read host state). torch is
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
    "current_cause",
    "memory_census",
    "observe_memory",
    "observe_split",
    "profile_window",
    "profiler",
    "start_profile",
    "stop_profile",
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
