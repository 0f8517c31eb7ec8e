"""What every driver shares: the run's inputs (`Bench`), what a run saw
(`Seen`), the measured window with its profiler trace and the program's
counters at both edges (`Window`), and the readings of the card beside
it (`card_info`)."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import time
from typing import Optional

from perfbench import yardstick

#: Host-side trace categories a device gap is attributed to.
_HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation",
              "python_function")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "perfbench.window"


@dataclasses.dataclass
class Bench:
    """One run's inputs, as the command line and the cell's files give
    them."""

    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    #: "cuda:0" on the card; "cpu" only in the CPU tests of the harness.
    device: str
    #: Scratch directory under the run's TMPDIR, removed after the run.
    tmp: pathlib.Path
    #: time.monotonic() when the process started.
    t_proc: float
    #: Put the control in the program's place in the check: the
    #: reference with the torus broken (`perfbench/control.py`).
    control: bool = False


@dataclasses.dataclass
class Check:
    """One number the comparison with the reference reads, beside its
    limit: the run is correct only if value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Seen:
    """What a driver saw in one run; the metric readers read it."""

    config: dict
    traffic: dict
    #: Process start to the window's first synchronised reading.
    setup_s: float = 0.0
    #: Host seconds between the window's two synchronised readings.
    window_s: float = 0.0
    #: Cell updates the card completed between those readings.
    cell_updates: int = 0
    attempted: int = 0
    failed: int = 0
    #: The program's registry ({series: {type, value}}) at the window's
    #: two edges, and its kernel launch counters.
    registry: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    #: `summarize_trace` of the traced window (runs with --trace 1).
    trace: Optional[dict] = None
    memory_peak_bytes: int = 0
    checks: list = dataclasses.field(default_factory=list)
    #: Earlier lines of the run's output (name -> JSON-able value).
    notes: dict = dataclasses.field(default_factory=dict)

    def mark(self, bench: "Bench", name: str) -> None:
        """Note seconds from process start to a point of set-up."""
        self.notes.setdefault("setup_marks_s", {})[name] = (
            time.monotonic() - bench.t_proc)

    def delta(self, series: str) -> Optional[float]:
        """A counter's growth over the window, by its registry series
        name (`name{label="v"}`); for a histogram, its sum's growth."""
        return _delta(self.registry, series)

    def launch_delta(self, kernel: str) -> Optional[int]:
        before = self.launches.get("before", {}).get(kernel)
        after = self.launches.get("after", {}).get(kernel)
        if before is None or after is None:
            return None
        return after - before

    def gcells_per_s(self) -> Optional[float]:
        """Cell updates completed in the window over its length, in
        Gcells/s."""
        if self.window_s <= 0 or self.cell_updates <= 0:
            return None
        return self.cell_updates / self.window_s / 1e9

    def idle_pct(self) -> Optional[float]:
        """Share of the traced window in which nothing ran on the card."""
        t = self.trace
        if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

    def kernel(self, name: str) -> tuple:
        """(launches, seconds) of the traced kernels whose name holds
        `name`; (0, 0.0) without a trace."""
        if not self.trace:
            return 0, 0.0
        n, s = 0, 0.0
        for k, (count, seconds) in self.trace["kernels"].items():
            if name in k:
                n, s = n + count, s + seconds
        return n, s


def _delta(registry: dict, series: str) -> Optional[float]:
    values = []
    for edge in ("before", "after"):
        entry = registry.get(edge, {}).get(series)
        if entry is None:
            return None
        v = entry["value"]
        values.append(v["sum"] if isinstance(v, dict) else v)
    return values[1] - values[0]


def series(name: str, **labels) -> str:
    """The registry's spelling of a series: name{k="v",...}, keys sorted."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def card_info() -> dict:
    """The card's name, power limit and SM clocks, by nvidia-smi; {} where
    there is none."""
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    return dict(zip(("name", "power_limit", "clocks_sm", "clocks_max_sm"),
                    (v.strip() for v in out.split(","))))


class Window:
    """The measured window: the program's counters at both edges and,
    with --trace 1, a `torch.profiler` capture of the card over it,
    marked by a named range so the trace's window is the window's."""

    def __init__(self, bench: Bench, seen: Seen, launches=None):
        self.bench, self.seen = bench, seen
        #: The program's launch counters (a dict kernel -> count), read
        #: at both edges.
        self._launches = launches if launches is not None else {}
        self._prof = None
        self._mark = None
        self.card_before: dict = {}

    def start(self) -> None:
        from gol_tpu_torch import obs

        self.card_before = card_info()
        if self.bench.trace:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available() and self.bench.device != "cpu":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._mark = torch.profiler.record_function(WINDOW_MARK)
            self._mark.__enter__()
        self.seen.registry["before"] = obs.registry().snapshot()
        self.seen.launches["before"] = dict(self._launches)

    def stop(self) -> None:
        from gol_tpu_torch import obs

        self.seen.launches["after"] = dict(self._launches)
        self.seen.registry["after"] = obs.registry().snapshot()
        if self._prof is not None:
            self._mark.__exit__(None, None, None)
            self._prof.stop()
            path = self.bench.tmp / "trace.json"
            t0 = time.monotonic()
            self._prof.export_chrome_trace(str(path))
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            path.unlink()
            self.seen.trace = summarize_trace(events)
            self.seen.notes["trace_read_s"] = time.monotonic() - t0
            self._prof = None
        card_after = card_info()
        self.seen.notes["card"] = {
            f"{k}_{edge}": v
            for edge, info in (("before", self.card_before),
                               ("after", card_after))
            for k, v in info.items() if k != "name"}


def summarize_trace(events: list) -> dict:
    """Reduce a Chrome trace (`traceEvents` of `torch.profiler`) to the
    window the harness marked: the device's busy seconds (the union of
    kernel, copy and memset intervals) against the window's length, the
    seconds and launches of each kernel, the device operations that took
    the most time, and the longest idle gaps named by the innermost host
    operation running at their midpoint."""
    lo = hi = None
    dev, host = [], []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if cat == "user_annotation" and e.get("name") == WINDOW_MARK:
            lo, hi = s, s + d
        elif cat in _DEVICE_CATS:
            dev.append((s, s + d, e.get("name", "?"), cat))
        elif cat in _HOST_CATS:
            host.append((s, s + d, e.get("name", "?")))
    if lo is None:
        raise ValueError(f"the trace has no {WINDOW_MARK!r} range")
    spans = [(s, e) for s, e, _, _ in dev]
    kernels: dict = {}
    ops: dict = {}
    for s, e, name, cat in dev:
        if e <= lo or s >= hi:
            continue
        dur = (min(e, hi) - max(s, lo)) / 1e6
        short = _short(name)
        ops[short] = ops.get(short, 0.0) + dur
        if cat == "kernel":
            n, t = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, t + dur)
    gaps = yardstick.idle_gaps(spans, lo, hi)[:10]
    # Per gap: the innermost host op running at its midpoint, else the
    # host op that ended last before it began.
    cover = [None] * len(gaps)
    before = [None] * len(gaps)
    for s, e, name in host:
        for i, (gs, ge) in enumerate(gaps):
            mid = (gs + ge) / 2
            if s <= mid <= e and (cover[i] is None or e - s < cover[i][0]):
                cover[i] = (e - s, name)
            elif e <= gs and (before[i] is None or e > before[i][0]):
                before[i] = (e, name)
    labels = [c[1] if c else f"after {_short(b[1])}" if b else "no host op"
              for c, b in zip(cover, before)]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": yardstick.union_seconds(spans, lo, hi) / 1e6,
        "kernels": kernels,
        "device_ops": sorted(([k, v] for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[label, (ge - gs) / 1e6]
                      for label, (gs, ge) in zip(labels, gaps)],
    }


def _short(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.removeprefix("void ").strip()[:120]
