"""The port's Generations and dense kernel entry points
(ops/cuda_bitgens.py, ops/cuda_life.py) against gol_tpu's Pallas kernels,
run as gol_tpu's own tests run them on the CPU (interpret mode), at the
shapes, overrides and light-cone turn counts of tests/test_generations.py
and tests/test_fast_paths.py. On a CPU tensor each entry point runs its
kernel's plain version through the same host-side pass loop the CUDA
path uses; the kernels themselves run on the card (chip_smoke.py).
Exact comparisons (assert_array_equal): the automaton is
integer-deterministic."""

import importlib.util
import pathlib
import random

import numpy as np
import pytest
import torch

from gol_tpu.models.rules import GenRule as JGenRule
from gol_tpu.models.rules import get_rule as jrule
from gol_tpu.ops import bitgens as jbg
from gol_tpu.ops import life as jl
from gol_tpu.ops import pallas_bitgens as jpg
from gol_tpu.ops import pallas_life as jpl
from gol_tpu_torch import interop
from gol_tpu_torch.models.rules import GenRule as TGenRule
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.ops import bitgens, life
from gol_tpu_torch.ops import cuda_bitgens as cg
from gol_tpu_torch.ops import cuda_life as cl

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def random_planes(notation, h, w, seed):
    """gol_tpu's packed one-hot planes of a random state grid."""
    rule = jrule(notation)
    rng = np.random.default_rng(seed)
    state = rng.integers(0, rule.states, (h, w)).astype(np.uint8)
    return np.asarray(jbg.pack_states(state, rule))


def port(planes):
    return interop.planes_from_numpy(planes)


def back(t):
    return interop.planes_to_numpy(t)


# --- the three gens entry points against gol_tpu's Pallas kernels ---


@pytest.mark.parametrize("notation", ["B2/S/C3", "B2/S345/C4", "B36/S23/C2"])
def test_resident_entry_matches_pallas(notation):
    """256 x 128 at n in {1, 11}: the shapes of gol_tpu's own
    test_pallas_gens_kernel_interpret."""
    planes = random_planes(notation, 256, 128, seed=1)
    for turns in (1, 11):
        want = np.asarray(jpg.step_n_packed_gens_pallas_raw(
            planes, turns, jrule(notation), interpret=True))
        got = cg.step_n_packed_gens_cuda_raw(port(planes), turns,
                                             trule(notation))
        np.testing.assert_array_equal(back(got), want)


@pytest.mark.parametrize("halo,turns", [(1, 33), (2, 64)])
def test_tiled_entry_matches_pallas(halo, turns):
    """768 rows = 24 word rows at strip_rows=8: three strips with
    toroidal seams, every plane carrying the ghost slab."""
    planes = random_planes("B2/S345/C4", 768, 128, seed=2)
    want = np.asarray(jpg.step_n_packed_gens_pallas_tiled_raw(
        planes, turns, jrule("B2/S345/C4"), interpret=True, strip_rows=8,
        halo_words=halo))
    got = cg.step_n_packed_gens_tiled_raw(
        port(planes), turns, trule("B2/S345/C4"), strip_rows=8,
        halo_words=halo)
    np.testing.assert_array_equal(back(got), want)


@pytest.mark.parametrize("turns", [1, 33, 65])
def test_tiled2d_entry_matches_plain(turns):
    """The 2-D entry against gol_tpu's plain planes (its own tests hold
    its 2-D kernel equal to them): 8-row tiles, three passes at 65."""
    planes = random_planes("B2/S/C3", 512, 256, seed=3)
    want = np.asarray(jbg.step_n_packed_gens_raw(planes, turns,
                                                 jrule("B2/S/C3")))
    got = cg.step_n_packed_gens_tiled2d_raw(port(planes), turns,
                                            trule("B2/S/C3"), tile_rows=8)
    np.testing.assert_array_equal(back(got), want)


@pytest.mark.parametrize("seed", range(3))
def test_random_rules_through_every_entry(seed):
    """Random B0-free rules with 2..8 states through all three entry
    points, against gol_tpu's plain planes."""
    rng = random.Random(seed)
    birth = frozenset(rng.sample(range(1, 9), rng.randint(1, 4)))
    survive = frozenset(rng.sample(range(9), rng.randint(0, 4)))
    states = rng.randint(2, 8)
    turns = rng.choice([3, 33, 40])
    jr = JGenRule("r", birth, survive, states)
    tr = TGenRule("r", birth, survive, states)
    rs = np.random.default_rng(seed)
    planes = np.asarray(jbg.pack_states(
        rs.integers(0, states, (256, 64)).astype(np.uint8), jr))
    want = np.asarray(jbg.step_n_packed_gens_raw(planes, turns, jr))
    for got in (cg.step_n_packed_gens_cuda_raw(port(planes), turns, tr),
                cg.step_n_packed_gens_tiled_raw(port(planes), turns, tr,
                                                strip_rows=8),
                cg.step_n_packed_gens_tiled2d_raw(port(planes), turns, tr,
                                                  tile_rows=8)):
        np.testing.assert_array_equal(back(got), want)


# --- override checks (gol_tpu's ValueErrors) ---


@pytest.mark.parametrize("kw", [
    {"strip_rows": 12}, {"strip_rows": 16}, {"strip_rows": 7},
    {"halo_words": 0}, {"halo_words": 9},
])
def test_tiled_override_errors_match(kw):
    planes = random_planes("B2/S/C3", 768, 128, seed=0)  # 24 word rows
    with pytest.raises(ValueError):
        jpg.step_n_packed_gens_pallas_tiled_raw(
            planes, 1, jrule("B2/S/C3"), interpret=True, **kw)
    with pytest.raises(ValueError):
        cg.step_n_packed_gens_tiled_raw(port(planes), 1, trule("B2/S/C3"),
                                        **kw)


@pytest.mark.parametrize("tile_rows", [12, 24, 4])
def test_tiled2d_override_errors_match(tile_rows):
    planes = random_planes("B2/S/C3", 512, 8192, seed=0)  # 16 word rows
    with pytest.raises(ValueError):
        jpg.step_n_packed_gens_pallas_tiled2d_raw(
            planes, 1, jrule("B2/S/C3"), interpret=True, tile_rows=tile_rows)
    with pytest.raises(ValueError):
        cg.step_n_packed_gens_tiled2d_raw(port(planes), 1, trule("B2/S/C3"),
                                          tile_rows=tile_rows)


def test_no_tiling_fits_raises():
    """gol_tpu raises when no 2-D gens plan fits; here, when C copies of
    the smallest tile exceed one block's shared memory."""
    rule = trule("B3/S23/C200")
    planes = torch.zeros((199, 2, 64), dtype=torch.int32)
    assert not cg.fits_cuda_gens_tiled(64, 64, rule)
    with pytest.raises(ValueError, match="shared memory"):
        cg.step_n_packed_gens_tiled2d_raw(planes, 1, rule)


# --- the dense kernel entry against gol_tpu's Pallas kernel ---


@pytest.mark.parametrize("turns", [1, 20])
@pytest.mark.parametrize("notation", ["B3/S23", "B36/S23"])
def test_dense_entry_matches_pallas(turns, notation):
    world = np.asarray(jl.random_world(64, 128, density=0.3, seed=turns))
    want, want_count = jpl.step_n_counted_pallas(
        world, turns, jrule(notation), interpret=True)
    got = cl.step_n_cuda_dense(torch.from_numpy(world), turns,
                               trule(notation))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_c, count = cl.step_n_counted_cuda_dense(torch.from_numpy(world),
                                                turns, trule(notation))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want))
    assert int(count) == int(want_count)


# --- gates, routing and wrapper checks (host-side, no card needed) ---


def test_fits_gates():
    for c in range(2, 8):   # C plane copies of 32 KiB at 512²
        assert cg.fits_cuda_gens(512, 512, trule(f"B2/S/C{c}"))
    assert not cg.fits_cuda_gens(512, 512, trule("B2/S/C8"))
    assert not cg.fits_cuda_gens(48, 512, trule("B2/S/C3"))
    assert cg.fits_cuda_gens_tiled(512, 512, trule("B2/S/C8"))
    assert cg.fits_cuda_gens_tiled(16384, 16384, trule("B2/S/C3"))
    assert not cg.fits_cuda_gens_tiled(48, 512, trule("B2/S/C3"))
    assert cl.fits_cuda_dense(512, 512) and cl.fits_cuda_dense(48, 40)
    assert not cl.fits_cuda_dense(65536, 65536)


@pytest.mark.parametrize("height,width,notation,entry", [
    (512, 512, "B2/S/C3", "step_n_packed_gens_cuda_raw"),
    (512, 512, "B2/S/C8", "step_n_packed_gens_tiled2d_raw"),
    (1024, 1024, "B2/S/C3", "step_n_packed_gens_tiled2d_raw"),
])
def test_cuda_gens_stepper_routes_chunks(monkeypatch, height, width,
                                         notation, entry):
    """The cuda-packed Generations stepper runs its chunks through
    kernel C where every plane fits one block, and through the 2-D entry
    of kernel D past it."""
    from gol_tpu_torch.parallel import make_stepper

    calls = []
    for name in ("step_n_packed_gens_cuda_raw", "step_n_packed_gens_tiled_raw",
                 "step_n_packed_gens_tiled2d_raw"):
        orig = getattr(cg, name)
        monkeypatch.setattr(cg, name, lambda p, n, rule, _o=orig, _n=name:
                            calls.append(_n) or _o(p, n, rule))
    st = make_stepper(height=height, width=width, rule=notation,
                      device="cpu", backend="cuda-packed")
    assert st.name == "generations-cuda-packed-1"
    dense = make_stepper(height=height, width=width, rule=notation,
                         device="cpu", backend="dense")
    world = life.random_world(height, width, seed=3)
    p, count = st.step_n(st.put(world), 2)
    d, dcount = dense.step_n(dense.put(world), 2)
    assert calls == [entry]
    np.testing.assert_array_equal(st.fetch(p), dense.fetch(d))
    assert int(count) == int(dcount)


def test_cuda_dense_stepper_runs_kernel_entry(monkeypatch):
    """Every step of the cuda-dense stepper goes through the kernel
    entry, single turns with n = 1 as in gol_tpu."""
    from gol_tpu_torch.parallel import make_stepper

    calls = []
    orig = cl.step_n_cuda_dense
    monkeypatch.setattr(cl, "step_n_cuda_dense", lambda w, n, rule:
                        calls.append(n) or orig(w, n, rule))
    st = make_stepper(height=64, width=48, backend="cuda-dense", device="cpu")
    assert st.name == "single-cuda-dense"
    world = life.random_world(64, 48, seed=5)
    w = st.put(world)
    w1 = st.step(w)
    w2, mask, c2 = st.step_with_diff(w1)
    w9, c9 = st.step_n(w2, 7)
    assert calls == [1, 1, 7]
    want = np.asarray(jl.step_n(world, 9))
    np.testing.assert_array_equal(st.fetch(w9), want)
    assert int(c9) == int(np.count_nonzero(want))
    np.testing.assert_array_equal(st.fetch(mask), st.fetch(w1) != st.fetch(w2))


def test_pass_plan_counts_turns(monkeypatch):
    """⌈n/k⌉ passes of kernel D, the remainder pass with only the halo
    its light cone needs, never writing the caller's buffer."""
    seen = []
    orig = cg._tiled_pass

    def spy(src, dst, k, rule, geom):
        assert dst.data_ptr() != src.data_ptr()
        assert geom.copies == rule.states
        seen.append((k, geom.halo))
        return orig(src, dst, k, rule, geom)

    monkeypatch.setattr(cg, "_tiled_pass", spy)
    p = port(random_planes("B2/S345/C4", 256, 64, seed=1))
    keep = p.clone()
    cg.step_n_packed_gens_tiled_raw(p, 2 * 96 + 40, trule("B2/S345/C4"),
                                    strip_rows=8, halo_words=3)
    assert seen == [(96, 3), (96, 3), (40, 2)]
    assert torch.equal(p, keep)


def test_tile_geometry_counts_plane_copies():
    g = cg.cb._tiled2d_geometry(512, 16384, None, trule("B2/S/C3").states)
    assert (g.tile_rows, g.tile_cols, g.halo, g.ghost, g.copies) == (
        32, 256, 1, 32, 3)
    assert g.smem_bytes == 3 * 4 * 34 * 320
    g8 = cg.cb._tiled2d_geometry(16, 512, None, trule("B2/S/C8").states)
    assert g8.copies == 8 and g8.smem_bytes <= cg.cb.SMEM_BYTES


def test_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel path, which
    checks it and raises — there is no silent plain-version fallback."""
    rule = trule("B2/S/C3")
    planes = torch.empty((2, 2, 64), dtype=torch.int32, device="meta")
    for fn in (cg.step_n_packed_gens_cuda_raw,
               cg.step_n_packed_gens_tiled_raw,
               cg.step_n_packed_gens_tiled2d_raw):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(planes, 1, rule)
    world = torch.empty((64, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cl.step_n_cuda_dense(world, 1)


# --- chip_smoke.py's bound forms compute the step they count ---


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_bound_form_computes_brians_brain():
    rule = trule("B2/S/C3")
    p = port(random_planes("B2/S/C3", 256, 96, seed=5))
    got, per_word = _smoke().gens_fewest_instructions(p)
    assert torch.equal(got, bitgens.step_packed_gens(p, rule))
    assert per_word == 12


def test_bound_form_computes_dense_life():
    bits = life.to_bits(torch.from_numpy(life.random_world(96, 64, seed=6)))
    got, per_word = _smoke().dense_fewest_instructions(bits)
    assert torch.equal(got, life.step_bits(bits))
    assert per_word == 9
