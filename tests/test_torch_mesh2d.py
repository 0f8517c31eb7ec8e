"""The port's 2-D mesh backends (gol_tpu_torch/parallel/mesh2d.py)
against gol_tpu's, on the CPU.

1xN, Nx1, 2x2 and 2x4 meshes (gol_tpu over its forced host devices,
the port over ``["cpu"] * rows * cols``), Life and B2/S/C3, from the
same numpy soup: names, capabilities, boards, counts, the global placed
state, the single-turn masks, the diff scans and `halo_cost` equal;
an operator's replicated world still steps the same board; the mesh
build errors carry gol_tpu's texts. Exact comparisons throughout.
"""

import jax
import numpy as np
import pytest
import torch

from gol_tpu.parallel.stepper import make_stepper as jmake
from gol_tpu_torch import interop
from gol_tpu_torch.parallel import mesh2d as tm
from gol_tpu_torch.parallel.stepper import make_stepper as tmake


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def soup(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w)) < 0.35) * 255).astype(np.uint8)


def host(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a


@pytest.mark.parametrize("mesh", ["1x4", "4x1", "2x2", "2x4"])
@pytest.mark.parametrize("rule", ["B3/S23", "B2/S/C3"])
def test_mesh_matches_gol_tpu(mesh, rule):
    rows, cols = map(int, mesh.split("x"))
    n = rows * cols
    h, w = 256, 64
    j = jmake(height=h, width=w, rule=rule, mesh=mesh,
              devices=jax.devices()[:n])
    t = tmake(height=h, width=w, rule=rule, mesh=mesh, devices=["cpu"] * n)
    assert t.name == j.name and t.shards == j.shards == n
    assert t.capabilities() == j.capabilities()
    world = soup(h, w, seed=n)
    jp, tp = j.put(world), t.put(world)
    for k in (1, 20):
        jp, jc = j.step_n(jp, k)
        tp, tc = t.step_n(tp, k)
        assert int(tc) == int(jc)
        np.testing.assert_array_equal(t.fetch(tp), j.fetch(jp))
        np.testing.assert_array_equal(interop.sharded_to_numpy(tp),
                                      np.asarray(jp))
    jn, jm, _ = j.step_with_diff(jp)
    tn, tmask, _ = t.step_with_diff(tp)
    np.testing.assert_array_equal(t.fetch(tmask), j.fetch(jm))
    np.testing.assert_array_equal(t.fetch(tn), j.fetch(jn))
    for per_turn in (False, True):
        assert t.halo_cost(tp, 7, per_turn) == j.halo_cost(jp, 7, per_turn)
    _, jd, _ = j.step_n_with_diffs(jp, 3)
    _, td, _ = t.step_n_with_diffs(tp, 3)
    np.testing.assert_array_equal(host(t.fetch_diffs(td)),
                                  host(j.fetch_diffs(jd)))
    _, jh, jv, _ = j.step_n_with_diffs_compact(jp, 3, 64)
    _, th, tv, _ = t.step_n_with_diffs_compact(tp, 3, 64)
    np.testing.assert_array_equal(host(th), host(jh))
    np.testing.assert_array_equal(host(tv), host(jv))
    _, jr, _ = j.step_n_with_diffs_sparse(jp, 3, 64)
    _, tr, _ = t.step_n_with_diffs_sparse(tp, 3, 64)
    np.testing.assert_array_equal(host(tr), host(jr))


def test_replicated_override_steps_the_same_board():
    """``world=rows`` leaves the columns unsplit: every mesh column holds
    the whole row block, the ghost columns are the block's own wrap,
    and the count sums one copy of each block."""
    world = soup(128, 64, seed=3)
    base = tmake(height=128, width=64, mesh="2x2", devices=["cpu"] * 4)
    rep = tmake(height=128, width=64, mesh="2x2", devices=["cpu"] * 4,
                partition_rules="world=rows")
    a, ca = base.step_n(base.put(world), 9)
    b, cb = rep.step_n(rep.put(world), 9)
    assert b.parts[0].shape == (2, 64)
    assert int(ca) == int(cb)
    np.testing.assert_array_equal(rep.fetch(b), base.fetch(a))


def test_mesh_errors_match_gol_tpu():
    cases = [
        dict(height=64, width=64, mesh="2x2", tile=32),
        dict(height=64, width=64, mesh="2x2", backend="dense"),
        dict(height=64, width=64, mesh="2x2", rule="B2/S/C3",
             backend="dense"),
        dict(height=96, width=64, mesh="2x2"),
        dict(height=64, width=64, mesh="8x1"),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as je:
            jmake(devices=jax.devices()[:8], **kw)
        with pytest.raises(ValueError) as te:
            tmake(devices=["cpu"] * 8, **kw)
        assert str(te.value) == str(je.value), kw
    with pytest.raises(ValueError, match="splits board rows"):
        tmake(height=64, width=64, mesh="2x2", devices=["cpu"] * 4,
              partition_rules="world=cols,rows")
    # A 1x1 mesh is no mesh: the single-device stepper.
    assert tmake(height=64, width=64, mesh="1x1",
                 device="cpu").name == "single-packed"
    assert not tm.packable_mesh2d(96, 64, 2, 2)
