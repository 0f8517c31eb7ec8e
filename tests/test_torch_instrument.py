"""The port's `instrument_stepper` and memory census against gol_tpu's.

The same Params through both packages' Engine move the per-entry
`gol_tpu_stepper_dispatches_total` counters by the same amounts (a fused
fixed-chunk run and a watched run through the compact diff chunks); each
instrumented call records a `stepper.<entry>` span; the halo series stay
at zero on one device; `GOL_TPU_METRICS=0` builds the bare stepper; and
the memory census reads no device fields on a CPU stepper, and maps the
CUDA allocator's statistics without synchronising.
"""

import numpy as np
import pytest
import torch

import gol_tpu
import gol_tpu_torch
from gol_tpu import obs as jobs
from gol_tpu.engine import distributor as jd
from gol_tpu.parallel import stepper as js
from gol_tpu_torch import obs as tobs
from gol_tpu_torch.engine import distributor as td
from gol_tpu_torch.obs import device as tdevice
from gol_tpu_torch.obs import tracing as ttracing
from gol_tpu_torch.parallel import stepper as ts
from test_torch_diffs import glider_world

WRAPPED = tuple(e.name for e in ts.ENTRY_TABLE if e.wrap is not None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def dispatch_counts(obs_mod, backend: str) -> dict:
    return {e: obs_mod.registry().counter(
        "gol_tpu_stepper_dispatches_total",
        labels={"backend": backend, "entry": e}).value for e in WRAPPED}


@pytest.mark.parametrize("fields,engine_kw", [
    (dict(turns=20, chunk=8), {"emit_flips": False}),
    (dict(turns=40, chunk=7), {}),
], ids=["fused-chunks", "watched-compact"])
def test_dispatch_counters_match_gol_tpu(tmp_path, fields, engine_kw):
    deltas = []
    for pkg, eng_mod, obs_mod, tag in ((gol_tpu, jd, jobs, "jax"),
                                       (gol_tpu_torch, td, tobs, "torch")):
        p = pkg.Params(image_width=64, image_height=64, threads=1,
                       tick_seconds=60.0, out_dir=str(tmp_path / tag),
                       **fields)
        extra = {"device": "cpu"} if pkg is gol_tpu_torch else {}
        engine = eng_mod.Engine(p, initial_world=glider_world(64, 64),
                                **engine_kw, **extra)
        assert engine.stepper.name == "single-packed"
        before = dispatch_counts(obs_mod, engine.stepper.name)
        engine.start()
        for _ in engine.events:
            pass
        engine.join(60)
        assert engine.error is None
        after = dispatch_counts(obs_mod, engine.stepper.name)
        deltas.append({e: after[e] - before[e] for e in WRAPPED})
    assert deltas[1] == deltas[0]
    if "emit_flips" in engine_kw:
        assert deltas[1]["step_n"] == 3  # 8 + 8 + 4
    else:
        assert deltas[1]["step_n_with_diffs_compact"] > 0


def test_instrumented_calls_record_spans_and_no_halo_traffic():
    s = ts.make_stepper(height=64, width=64, backend="packed", device="cpu")
    halo = tobs.registry().counter("gol_tpu_halo_bytes_total",
                                   labels={"backend": s.name})
    h0 = halo.value
    n0 = len([r for r in ttracing.TRACER.records if r[1] == "stepper.step_n"])
    w = s.put(glider_world(64, 64))
    w, count = s.step_n(w, 4)
    w, diffs, count = s.step_n_with_diffs(w, 3)
    assert s.halo_cost is None and halo.value == h0
    names = [r[1] for r in ttracing.TRACER.records]
    assert len([n for n in names if n == "stepper.step_n"]) == n0 + 1
    assert "stepper.put" in names and "stepper.step_n_with_diffs" in names


def test_make_stepper_skips_instrumentation_when_disabled():
    step_c = tobs.registry().counter(
        "gol_tpu_stepper_dispatches_total",
        labels={"backend": "single-packed", "entry": "step_n"})
    tobs.set_enabled(False)
    try:
        s = ts.make_stepper(height=64, width=64, backend="packed",
                            device="cpu")
        bare = ts._make_stepper(height=64, width=64, backend="packed",
                                device="cpu")
        before = step_c.value
        w = s.put(np.zeros((64, 64), np.uint8))
        int(s.step_n(w, 2)[1])
    finally:
        tobs.set_enabled(True)
    assert step_c.value == before  # bare stepper: not even a wrapper
    assert s.step_n.__qualname__ == bare.step_n.__qualname__
    # The same switch in gol_tpu builds its bare stepper too.
    jobs.set_enabled(False)
    try:
        jbare = js.make_stepper(threads=1, height=64, width=64,
                                backend="packed")
    finally:
        jobs.set_enabled(True)
    assert "instrument_stepper" not in jbare.step_n.__qualname__
    assert "instrument_stepper" in ts.make_stepper(
        height=64, width=64, backend="packed",
        device="cpu").step_n.__qualname__


def test_memory_census_on_a_cpu_stepper():
    """A CPU stepper's census reports no device fields, as gol_tpu's CPU
    census reports no allocator stats, and leaves the gauges alone."""
    live = tobs.registry().gauge("gol_tpu_device_live_buffers")
    live.set(7)
    s = ts.make_stepper(height=64, width=64, backend="packed", device="cpu")
    w = s.put(glider_world(64, 64))
    got = tdevice.memory_census(w.device)
    assert got["live_buffers"] is None and got["bytes_in_use"] is None
    assert got["bytes_limit"] is None and got["per_device"] == {}
    assert live.value == 7


def test_memory_census_maps_the_cuda_allocator(monkeypatch):
    """The CUDA branch, with the allocator's statistics faked: live
    blocks, bytes in use and the device's total memory land in the
    census and the gauges, and nothing synchronises the device."""
    stats = {"active.all.current": 5, "allocated_bytes.all.current": 4096,
             "allocated_bytes.all.peak": 8192}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (1 << 20, 1 << 30))

    def no_sync(*a, **k):
        raise AssertionError("the census synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    got = tdevice.memory_census("cuda:0")
    assert got["live_buffers"] == 5 and got["bytes_in_use"] == 4096
    assert got["bytes_limit"] == 1 << 30
    assert got["per_device"]["cuda:0"]["peak_bytes_in_use"] == 8192
    assert got["watermark_bytes"] >= 4096
    reg = tobs.registry()
    assert reg.gauge("gol_tpu_device_live_buffers").value == 5
    assert reg.gauge("gol_tpu_device_live_bytes").value == 4096
    assert reg.gauge("gol_tpu_device_hbm_watermark_bytes").value >= 4096
