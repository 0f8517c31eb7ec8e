"""The port's three packed-kernel entry points (ops/cuda_bitlife.py) against
gol_tpu's Pallas kernels, run as gol_tpu's own tests run them on the CPU
(interpret mode), at the shapes, overrides and light-cone turn counts of
tests/test_fast_paths.py. On a CPU tensor each entry point runs its
kernel's plain version through the same host-side pass loop the CUDA
path uses; the kernels themselves run on the card (chip_smoke.py).
Exact comparisons: the automaton is integer-deterministic."""

import random

import numpy as np
import pytest
import torch

from gol_tpu.models.rules import Rule as JRule
from gol_tpu.models.rules import get_rule as jrule
from gol_tpu.ops import bitlife as jb
from gol_tpu.ops import life as jl
from gol_tpu.ops import pallas_bitlife as jp
from gol_tpu_torch import interop
from gol_tpu_torch.models.rules import Rule as TRule
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.ops import cuda_bitlife as cb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def packed(h, w, seed):
    world = jl.random_world(h, w, density=0.3, seed=seed)
    return np.asarray(jb.pack(jl.to_bits(world)))


def port(p):
    return interop.packed_from_numpy(p)


def back(t):
    return interop.packed_to_numpy(t)


@pytest.mark.parametrize("turns", [1, 33, 50])
@pytest.mark.parametrize("notation", ["B3/S23", "B36/S23"])
def test_resident_entry_matches_pallas(turns, notation):
    p = packed(256, 128, seed=turns)
    want = np.asarray(jp.step_n_packed_pallas_raw(
        p, turns, jrule(notation), interpret=True))
    got = cb.step_n_packed_cuda_raw(port(p), turns, trule(notation))
    assert np.array_equal(back(got), want)


@pytest.mark.parametrize("halo,turns", [
    (1, 1), (1, 31), (1, 33), (1, 100),
    (2, 63), (2, 64), (2, 65),
    (4, 127), (4, 128), (4, 129),
    (None, 100),
])
def test_tiled_entry_matches_pallas(halo, turns):
    """768 rows = 24 word rows at strip_rows=8: three strips with
    toroidal seams, across each halo depth's light-cone boundary."""
    p = packed(768, 128, seed=turns)
    want = np.asarray(jp.step_n_packed_pallas_tiled_raw(
        p, turns, interpret=True, strip_rows=8, halo_words=halo))
    got = cb.step_n_packed_tiled_raw(port(p), turns, strip_rows=8,
                                     halo_words=halo)
    assert np.array_equal(back(got), want)


@pytest.mark.parametrize("turns", [1, 33, 127, 128, 130])
def test_tiled2d_entry_matches_pallas(turns):
    """512 x 8192 at tile_rows=8: a 2x2 tile grid in gol_tpu's kernel."""
    p = packed(512, 8192, seed=turns)
    want = np.asarray(jp.step_n_packed_pallas_tiled2d_raw(
        p, turns, interpret=True, tile_rows=8))
    got = cb.step_n_packed_tiled2d_raw(port(p), turns, tile_rows=8)
    assert np.array_equal(back(got), want)


@pytest.mark.parametrize("seed", range(4))
def test_random_rule_entries_match_pallas(seed):
    """Random B0-free rules through all three entry points (the
    tests/test_fast_paths.py:542 sweep)."""
    rng = random.Random(seed)
    birth = frozenset(rng.sample(range(1, 9), rng.randint(1, 4)))
    survive = frozenset(rng.sample(range(9), rng.randint(0, 4)))
    turns = rng.choice([3, 33, 40])
    p = packed(512, 128, seed=seed + 100)
    jr, tr = JRule("r", birth, survive), TRule("r", birth, survive)
    want = np.asarray(jp.step_n_packed_pallas_raw(p, turns, jr, interpret=True))
    for got in (cb.step_n_packed_cuda_raw(port(p), turns, tr),
                cb.step_n_packed_tiled_raw(port(p), turns, tr, strip_rows=8),
                cb.step_n_packed_tiled2d_raw(port(p), turns, tr, tile_rows=8)):
        assert np.array_equal(back(got), want)


def test_world_wrapper_matches(golden_root):
    from gol_tpu_torch.io.pgm import read_pgm

    w = read_pgm(golden_root / "images" / "512x512.pgm")
    golden = read_pgm(golden_root / "check" / "images" / "512x512x100.pgm")
    assert np.array_equal(
        cb.step_n_cuda_packed(torch.from_numpy(w), 100).numpy(), golden)


# --- override checks (gol_tpu's ValueErrors) ---


@pytest.mark.parametrize("kw", [
    {"strip_rows": 12}, {"strip_rows": 16}, {"strip_rows": 7},
    {"halo_words": 0}, {"halo_words": 9},
])
def test_tiled_override_errors_match(kw):
    p = packed(768, 128, seed=0)  # 24 word rows
    with pytest.raises(ValueError):
        jp.step_n_packed_pallas_tiled_raw(p, 1, interpret=True, **kw)
    with pytest.raises(ValueError):
        cb.step_n_packed_tiled_raw(port(p), 1, **kw)


@pytest.mark.parametrize("tile_rows", [12, 24, 4])
def test_tiled2d_override_errors_match(tile_rows):
    p = packed(512, 8192, seed=0)  # 16 word rows
    with pytest.raises(ValueError):
        jp.step_n_packed_pallas_tiled2d_raw(p, 1, interpret=True,
                                            tile_rows=tile_rows)
    with pytest.raises(ValueError):
        cb.step_n_packed_tiled2d_raw(port(p), 1, tile_rows=tile_rows)


# --- gates, geometry and wrapper checks (host-side, no card needed) ---


def test_fits_gates():
    assert cb.fits_cuda_packed(512, 512)   # 16 x 512 words, 64 KiB both copies
    assert cb.fits_cuda_packed(64, 64)
    assert not cb.fits_cuda_packed(1024, 1024)  # 256 KiB > 227 KB
    assert not cb.fits_cuda_packed(48, 512)     # partial words
    assert cb.fits_cuda_packed_tiled(4096, 4000)  # no lane alignment needed
    assert not cb.fits_cuda_packed_tiled(48, 512)


@pytest.mark.parametrize("height,width,entry", [
    (512, 512, "step_n_packed_cuda_raw"),
    (1024, 1024, "step_n_packed_tiled2d_raw"),
    (4096, 256, "step_n_packed_tiled2d_raw"),  # narrow, still past A
])
def test_cuda_stepper_routes_chunks(monkeypatch, height, width, entry):
    """The cuda-packed stepper runs its chunks through kernel A where the
    board fits one block, and through the 2-D entry of kernel B past it."""
    from gol_tpu_torch.parallel import make_stepper

    calls = []
    for name in ("step_n_packed_cuda_raw", "step_n_packed_tiled_raw",
                 "step_n_packed_tiled2d_raw"):
        orig = getattr(cb, name)
        monkeypatch.setattr(cb, name, lambda p, n, rule, _o=orig, _n=name:
                            calls.append(_n) or _o(p, n, rule))
    st = make_stepper(height=height, width=width, device="cpu",
                      backend="cuda-packed")
    world = jl.random_world(height, width, seed=3)
    p, count = st.step_n(st.put(world), 2)
    assert calls == [entry]
    want = np.asarray(jl.step_n(world, 2))
    assert np.array_equal(st.fetch(p), want)
    assert int(count.item()) == int(np.count_nonzero(want))


def test_bound_form_computes_life():
    """chip_smoke.py's bound counts the instructions of a Life step in
    LOP3/SHF form; that form must compute Life exactly."""
    import importlib.util
    import pathlib

    from gol_tpu_torch.ops import bitlife

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    p = port(packed(256, 96, seed=5))
    got, per_word = smoke.life_fewest_instructions(p)
    assert torch.equal(got, bitlife.step_packed(p))
    assert per_word == 12


def test_tile_geometry():
    g = cb._tile_plan(512, 16384, None, None)
    assert (g.tile_rows, g.tile_cols, g.halo, g.ghost, g.turns) == (32, 256, 1, 32, 32)
    for h in range(1, cb.MAX_HALO_WORDS + 1):
        g = cb._tile_plan(512, 16384, 8, h)
        assert g.turns == 32 * h and g.smem_bytes <= cb.SMEM_BYTES
    assert cb._auto_rows(24) == 24 and cb._auto_rows(3) == 3
    assert cb._auto_rows(100) == 32  # ragged last tile


def test_pass_plan_counts_turns(monkeypatch):
    """⌈n/k⌉ passes, the remainder pass with only the halo its light cone
    needs, never writing the caller's buffer."""
    seen = []
    orig = cb._tiled_pass

    def spy(src, dst, k, rule, geom):
        assert dst.data_ptr() != src.data_ptr()
        seen.append((k, geom.halo))
        return orig(src, dst, k, rule, geom)

    monkeypatch.setattr(cb, "_tiled_pass", spy)
    p = port(packed(256, 64, seed=1))
    keep = p.clone()
    cb.step_n_packed_tiled_raw(p, 2 * 96 + 40, strip_rows=8, halo_words=3)
    assert seen == [(96, 3), (96, 3), (40, 2)]
    assert torch.equal(p, keep)


def test_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU goes to the kernel path, which
    checks it and raises — there is no silent plain-version fallback."""
    p = torch.empty((2, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cb.step_n_packed_cuda_raw(p, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        cb.step_n_packed_tiled2d_raw(p, 1)


def test_rule_args():
    assert cb.rule_args(trule("B3/S23")) == (1 << 3, (1 << 2) | (1 << 3), 0)
    assert cb.rule_args(trule("B36/S23"))[2] == cb.COMBINE["general"]
