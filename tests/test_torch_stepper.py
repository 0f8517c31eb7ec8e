"""The port's single-device stepper against gol_tpu's: the capability
table, backend selection, and every core entry (put, fetch, step,
step_n, step_with_diff, alive_count_async) of each backend on the same
boards. The "cuda-packed" backend runs its kernels' plain versions here,
because its tensors lie on the CPU."""

import numpy as np
import pytest
import torch

from gol_tpu.ops import life as jl
from gol_tpu.parallel import stepper as js
from gol_tpu_torch.parallel import stepper as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_entry_table_matches():
    assert ([tuple(vars(e).values()) for e in ts.ENTRY_TABLE]
            == [tuple(vars(e).values()) for e in js.ENTRY_TABLE])
    with pytest.raises(KeyError):
        ts.entry_info("nope")


@pytest.mark.parametrize("backend,h,w,name", [
    ("auto", 64, 64, "single-packed"),
    ("auto", 16, 16, "single"),
    ("dense", 64, 64, "single"),
    ("packed", 64, 64, "single-packed"),
    ("cuda-packed", 64, 64, "single-cuda-packed"),
    ("cuda-packed", 1024, 1024, "single-cuda-packed"),
])
def test_backend_selection_on_cpu(backend, h, w, name):
    s = ts.make_stepper(height=h, width=w, backend=backend, device="cpu")
    assert s.name == name
    offered = [e.name for e in ts.ENTRY_TABLE if s.offers(e.name)]
    # The entries of gol_tpu's counterpart: the core entries, then the
    # diff scans (dense masks; packed rows with sparse and compact).
    counterpart = js.make_stepper(
        threads=1, height=h, width=w,
        backend={"cuda-packed": "packed"}.get(backend, backend))
    assert tuple(offered) == s.capabilities() == counterpart.capabilities()
    core = [e.name for e in js.ENTRY_TABLE if e.kind == "core"]
    assert offered[:len(core)] == core


@pytest.mark.parametrize("backend", ["dense", "packed", "cuda-packed"])
@pytest.mark.parametrize("h,w", [(64, 64), (96, 48)])
@pytest.mark.parametrize("notation", ["B3/S23", "B36/S23"])
def test_core_entries_match_gol_tpu(backend, h, w, notation):
    jax_backend = {"cuda-packed": "packed"}.get(backend, backend)
    jst = js.make_stepper(threads=1, height=h, width=w, rule=notation,
                          backend=jax_backend)
    tst = ts.make_stepper(height=h, width=w, rule=notation, backend=backend,
                          device="cpu")
    world = jl.random_world(h, w, density=0.3, seed=h + w)
    jp, tp = jst.put(world), tst.put(world)
    assert np.array_equal(tst.fetch(tp), jst.fetch(jp))
    assert np.array_equal(tst.fetch(tst.step(tp)), jst.fetch(jst.step(jp)))
    jn, jc = jst.step_n(jp, 37)
    tn, tc = tst.step_n(tp, 37)
    assert np.array_equal(tst.fetch(tn), jst.fetch(jn))
    assert int(tc.item()) == int(jc)
    jw, jm, jc1 = jst.step_with_diff(jn)
    tw, tm, tc1 = tst.step_with_diff(tn)
    assert np.array_equal(tst.fetch(tw), jst.fetch(jw))
    assert np.array_equal(tst.fetch(tm), np.asarray(jm))
    assert int(tc1.item()) == int(jc1)
    assert tst.alive_count(tw) == jst.alive_count(jw)


def test_stepper_never_mutates_its_input():
    """The cycle detector keeps an old world as its anchor, so a step
    must return a new tensor and leave its input as it was."""
    s = ts.make_stepper(height=64, width=64, backend="cuda-packed",
                        device="cpu")
    p = s.put(jl.random_world(64, 64, seed=3))
    keep = p.clone()
    q, _ = s.step_n(p, 40)
    assert q.data_ptr() != p.data_ptr()
    assert (p == keep).all()
