"""The readers of the engine thread's and the card's own counters
(`engine.drain_pct`, `engine.census_pct`, `engine.gap_pct`,
`engine.run_ahead_ms`, `engine.calibrate_s`) on hand-built registries:
each reads what its series say, and nothing where a series is
missing (the parent program, or a run with no CUDA events)."""

import pathlib

import pytest

from perfbench import harness
from perfbench import run as bench_run

ROOT = pathlib.Path(__file__).resolve().parents[2]

DRAIN = 'gol_tpu_engine_thread_seconds{phase="drain"}'
CENSUS = "gol_tpu_device_census_seconds"
GAP = "gol_tpu_engine_device_gap_seconds"
AHEAD = "gol_tpu_engine_run_ahead_seconds"
CALIBRATE = 'gol_tpu_engine_setup_seconds{phase="calibrate"}'


def reader(name):
    return bench_run.load(ROOT / "perfbench" / "metrics" / f"{name}.py",
                          f"perfbench_metric_{name}")


def counter(v):
    return {"type": "counter", "value": v}


def histogram(total, count):
    return {"type": "histogram",
            "value": {"buckets": [], "sum": total, "count": count}}


def seen(before: dict, after: dict, window_s: float = 20.0):
    s = harness.Seen({"width": 5120, "height": 5120}, {})
    s.window_s = window_s
    s.registry = {"before": before, "after": after}
    return s


def gaps(drain, census, enqueue):
    return {f'{GAP}{{after="{a}"}}': counter(v)
            for a, v in (("drain", drain), ("census", census),
                         ("enqueue", enqueue))}


FULL = seen(
    {DRAIN: counter(3.0), CENSUS: counter(0.5), **gaps(1.0, 0.2, 0.1),
     AHEAD: histogram(4.0, 40), CALIBRATE: counter(2.25)},
    {DRAIN: counter(4.0), CENSUS: counter(0.54), **gaps(1.2, 0.25, 0.13),
     AHEAD: histogram(5.9, 60), CALIBRATE: counter(2.25)},
)


@pytest.mark.parametrize("name, want", [
    ("engine.drain_pct", 100 * 1.0 / 20),
    ("engine.census_pct", 100 * 0.04 / 20),
    ("engine.gap_pct", 100 * (0.2 + 0.05 + 0.03) / 20),
    ("engine.run_ahead_ms", 1e3 * 1.9 / 20),
    ("engine.calibrate_s", 2.25),
])
def test_each_reader_reads_its_series(name, want):
    assert reader(name).read(FULL) == pytest.approx(want)


@pytest.mark.parametrize("name, missing", [
    ("engine.drain_pct", DRAIN),
    ("engine.census_pct", CENSUS),
    ("engine.gap_pct", GAP),
    ("engine.run_ahead_ms", AHEAD),
    ("engine.calibrate_s", CALIBRATE),
])
def test_each_reader_is_none_without_its_series(name, missing):
    def drop(snap):
        return {k: v for k, v in snap.items() if not k.startswith(missing)}

    s = seen(drop(FULL.registry["before"]), drop(FULL.registry["after"]))
    assert reader(name).read(s) is None


def test_run_ahead_is_none_without_a_boundary_in_the_window():
    s = seen({AHEAD: histogram(4.0, 40)}, {AHEAD: histogram(4.0, 40)})
    assert reader("engine.run_ahead_ms").read(s) is None


def test_gap_is_none_when_a_label_is_missing_at_one_edge():
    before = gaps(1.0, 0.2, 0.1)
    del before[f'{GAP}{{after="census"}}']
    s = seen(before, gaps(1.2, 0.25, 0.13))
    assert reader("engine.gap_pct").read(s) is None
