"""The port's compile watcher (`gol_tpu_torch.obs.device`), held against
gol_tpu's (`gol_tpu.obs.device.install_compile_watcher`): a load of the
kernels' library (`ops/_build.load`) is the port's compile — on a cache
miss the `nvcc` build plus the `ctypes` load, on a hit the load alone —
and is recorded as gol_tpu records a backend compile: the counter by
cause, the seconds histogram, a `device.compile` span and a flight note
(`cached=` says which). The build is a fake library: `_compile` and
`ctypes.CDLL` patched, the cache in a temporary directory."""

import ctypes
import os

import pytest
import torch

from gol_tpu_torch import obs
from gol_tpu_torch.obs import device, flight, tracing
from gol_tpu_torch.ops import _build

torch.set_num_threads(1)


class _FakeLib:
    """A CDLL stand-in: every attribute a settable function object."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """`_build.load` over a fake nvcc and CDLL, the cache in tmp_path;
    returns the list of builds `_compile` was asked for."""
    builds = []

    def compile_(nvcc, objdir):
        builds.append(objdir)
        lib = os.path.join(objdir, "lib.so")
        with open(lib, "wb") as f:
            f.write(b"fake")
        return lib, "ptxas info: fake"

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: _FakeLib())
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(device, "_WATCHER_INSTALLED", False)
    yield builds
    monkeypatch.setattr(_build, "_lib", None)


def _series(name: str, labels=None) -> float:
    key = name + ("" if not labels else "{" + ",".join(
        f'{k}="{v}"' for k, v in sorted(labels.items())) + "}")
    m = obs.registry().snapshot().get(key)
    return 0 if m is None else m["value"]


def _compile_seconds_count() -> float:
    m = obs.registry().snapshot().get("gol_tpu_device_compile_seconds")
    return 0 if m is None else m["value"]["count"]


def _spans(cause: str) -> list:
    return [r for r in tracing.TRACER.records
            if r[1] == "device.compile" and (r[6] or {}).get("cause") == cause]


def _notes(cause: str) -> list:
    return [f for _, kind, f in flight.FLIGHT.entries
            if kind == "device.compile" and f.get("cause") == cause]


def test_install_is_idempotent_as_gol_tpus():
    from gol_tpu.obs import device as jdevice

    assert device.install_compile_watcher() is True
    assert device.install_compile_watcher() is True
    assert jdevice.install_compile_watcher() is True
    assert jdevice.install_compile_watcher() is True


@pytest.mark.parametrize("cached", [False, True], ids=["miss", "hit"])
def test_load_records_counter_histogram_span_and_note(fake_build, cached):
    cause = f"watch-{'hit' if cached else 'miss'}"
    if cached:  # a library for these sources already in the cache
        path = _build.library_path()
        path.parent.mkdir(parents=True)
        path.write_bytes(b"fake")
    assert device.install_compile_watcher()
    before = _series("gol_tpu_device_compiles_total", {"cause": cause})
    seconds_before = _compile_seconds_count()
    with device.cause(cause):
        lib = _build.load()
        assert _build.load() is lib  # loaded once a process
    assert len(fake_build) == (0 if cached else 1)
    assert _series("gol_tpu_device_compiles_total",
                   {"cause": cause}) == before + 1
    assert _compile_seconds_count() == seconds_before + 1
    spans = _spans(cause)
    assert len(spans) == 1 and spans[0][4] >= 0
    assert spans[0][6]["cached"] is cached
    notes = _notes(cause)
    assert len(notes) == 1 and notes[0]["cached"] is cached
    assert notes[0]["seconds"] >= 0


def test_unattributed_load_and_no_watcher(fake_build):
    """Without the watcher a load records nothing; installed, a load
    outside any `cause` block counts as gol_tpu's "unattributed"."""
    label = {"cause": device.CAUSE_UNATTRIBUTED}
    before = _series("gol_tpu_device_compiles_total", label)
    _build.load()
    assert _series("gol_tpu_device_compiles_total", label) == before
    _build._lib = None
    device.install_compile_watcher()
    _build.load()
    assert _series("gol_tpu_device_compiles_total", label) == before + 1
    assert device.CAUSE_UNATTRIBUTED == "unattributed"
    from gol_tpu.obs import device as jdevice

    assert jdevice.CAUSE_UNATTRIBUTED == device.CAUSE_UNATTRIBUTED


def test_metrics_off_records_nothing(fake_build):
    """GOL_TPU_METRICS=0 (`obs.set_enabled(False)`): the watcher stays
    installed and the load records no series, span or note."""
    cause = "watch-off"
    device.install_compile_watcher()
    seconds_before = _compile_seconds_count()
    obs.set_enabled(False)
    try:
        with device.cause(cause):
            _build.load()
    finally:
        obs.set_enabled(True)
    assert _series("gol_tpu_device_compiles_total", {"cause": cause}) == 0
    assert _compile_seconds_count() == seconds_before
    assert not _spans(cause) and not _notes(cause)


def test_series_names_match_gol_tpus():
    """The port registers gol_tpu's series names: the counter with its
    `cause` label and the seconds histogram, so a scrape or console
    reads either package's."""
    from gol_tpu.obs import device as jdevice

    jdevice._METRICS.compiles("names-check").inc(0)
    device.install_compile_watcher()
    snap = obs.registry().snapshot()
    assert "gol_tpu_device_compile_seconds" in snap
    import gol_tpu.obs as jobs

    jsnap = jobs.registry().snapshot()
    assert "gol_tpu_device_compile_seconds" in jsnap
    assert 'gol_tpu_device_compiles_total{cause="names-check"}' in jsnap
