"""The port's plain PyTorch step functions against gol_tpu: the dense
`ops/life.py` and the packed SWAR `ops/bitlife.py` — int32 storage with
bit 31 set, logical shifts, the popcount, the vertical shifts, single
turns and n-turn runs over named and random B0-free rules. The automaton
is integer-deterministic, so every comparison is exact."""

import numpy as np
import pytest
import torch

from gol_tpu.models.rules import Rule as JRule
from gol_tpu.models.rules import get_rule as jrule
from gol_tpu.ops import bitlife as jb
from gol_tpu.ops import life as jl
from gol_tpu_torch import interop
from gol_tpu_torch.models.rules import Rule as TRule
from gol_tpu_torch.models.rules import get_rule as trule
from gol_tpu_torch.ops import bitlife as tb
from gol_tpu_torch.ops import life as tl

SIZES = [(64, 64), (256, 128), (768, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these boards are tiny, and the suite runs
    beside timing-sensitive tests in other worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def world(h, w, seed, density=0.3):
    return jl.random_world(h, w, density=density, seed=seed)


def seam_world(h, w, seed):
    """A random world with every bit-31 row and both wrap columns dense,
    so word carries and lane wrap are exercised on every turn."""
    out = world(h, w, seed)
    rng = np.random.default_rng(seed + 1)
    for y in range(31, h, 32):
        out[y] = (rng.random(w) < 0.6).astype(np.uint8) * 255
    out[:, 0] = (rng.random(h) < 0.6).astype(np.uint8) * 255
    out[:, -1] = (rng.random(h) < 0.6).astype(np.uint8) * 255
    return out


def jpacked(w):
    return np.asarray(jb.pack(jl.to_bits(w)))


def tpacked(w):
    return tb.pack(tl.to_bits(torch.from_numpy(w)))


def words(t):
    return interop.packed_to_numpy(t)


# --- packing, shifts, popcount ---


@pytest.mark.parametrize("h,w", SIZES)
def test_pack_unpack_match(h, w):
    wd = seam_world(h, w, seed=h)
    want = jpacked(wd)
    assert (want >> 31).any(), "no word has bit 31 set"
    got = tpacked(wd)
    assert np.array_equal(words(got), want)
    assert np.array_equal(words(got), tb.pack_np(wd))
    assert np.array_equal(tb.unpack(got, h).numpy(),
                          np.asarray(jb.unpack(want, h)))
    assert np.array_equal(tb.unpack_np(want, h), jb.unpack_np(want, h))


def test_lsr_is_logical_on_sign_bit():
    raw = np.array([0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 1, 0, 0xDEADBEEF],
                   dtype=np.uint32)
    t = interop.packed_from_numpy(raw[None, :])
    for k in range(1, 32):
        assert np.array_equal(words(tb.lsr(t, k))[0], raw >> np.uint32(k)), k
    # The arithmetic shift alone would sign-extend: the helper is needed.
    assert int((t >> 31)[0, 0]) == -1


@pytest.mark.parametrize("h,w", SIZES)
def test_popcount_and_count_match(h, w):
    wd = seam_world(h, w, seed=w + h)
    want = jpacked(wd)
    got = tpacked(wd)
    per_word = np.unpackbits(want.view(np.uint8)).reshape(*want.shape, 32).sum(-1)
    assert np.array_equal(tb.popcount(got).numpy(), per_word)
    assert int(tb.count_packed(got)) == int(jb.count_packed(want))
    assert int(tb.count_packed(got)) == int(np.count_nonzero(wd))
    allones = interop.packed_from_numpy(np.full((2, 3), 0xFFFFFFFF, np.uint32))
    assert int(tb.count_packed(allones)) == 6 * 32


@pytest.mark.parametrize("h,w", SIZES)
def test_vertical_shifts_match(h, w):
    wd = seam_world(h, w, seed=3)
    want = jpacked(wd)
    got = tpacked(wd)
    assert np.array_equal(words(tb._shift_up(got)), np.asarray(jb._shift_up(want)))
    assert np.array_equal(words(tb._shift_down(got)),
                          np.asarray(jb._shift_down(want)))


# --- packed stepping ---


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("notation", ["B3/S23", "B36/S23"])
def test_step_packed_matches(h, w, notation):
    wd = seam_world(h, w, seed=7)
    want = np.asarray(jb.step_packed(jpacked(wd), jrule(notation)))
    got = tb.step_packed(tpacked(wd), trule(notation))
    assert np.array_equal(words(got), want)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("notation", ["B3/S23", "B36/S23"])
def test_n_turn_runs_match(h, w, notation):
    wd = world(h, w, seed=h + 1)
    want = np.asarray(jb.step_n_packed_raw(jpacked(wd), 40, jrule(notation)))
    got = tb.step_n_packed_raw(tpacked(wd), 40, trule(notation))
    assert np.array_equal(words(got), want)
    assert int(tb.count_packed(got)) == int(jb.count_packed(want))


@pytest.mark.parametrize("seed", range(6))
def test_random_rule_sweep_matches(seed):
    """B0-free random rules (the tests/test_fast_paths.py:542 sweep) on a
    board whose bit-31 rows and wrap columns are dense."""
    import random

    rng = random.Random(seed)
    birth = frozenset(rng.sample(range(1, 9), rng.randint(1, 4)))
    survive = frozenset(rng.sample(range(9), rng.randint(0, 4)))
    turns = rng.choice([3, 33, 40])
    wd = seam_world(512, 128, seed=seed + 100)
    want_dense = np.asarray(jl.step_n(wd, turns, rule=JRule("r", birth, survive)))
    rule = TRule("r", birth, survive)
    got = tb.step_n_packed_raw(tpacked(wd), turns, rule)
    assert np.array_equal(tb.unpack(got, 512).numpy() * 255, want_dense)
    assert np.array_equal(tl.step_n(torch.from_numpy(wd), turns, rule).numpy(),
                          want_dense)


def test_codec_and_golden(golden_root):
    from gol_tpu_torch.io.pgm import read_pgm

    w = read_pgm(golden_root / "images" / "64x64.pgm")
    golden = read_pgm(golden_root / "check" / "images" / "64x64x100.pgm")
    pack_world, unpack_world, fetch = tb.make_codec(64)
    p = pack_world(torch.from_numpy(w))
    assert np.array_equal(fetch(tb.step_n_packed_raw(p, 100)), golden)
    assert p.dtype == torch.int32 and np.array_equal(fetch(p), w)
    assert np.array_equal(unpack_world(p).numpy(), w)
    mask = torch.zeros((64, 64), dtype=torch.bool)
    assert fetch(mask).dtype == np.bool_


def test_packable_gate_matches():
    for h, w in [(512, 512), (64, 17), (16, 512), (48, 512), (32, 1)]:
        assert tb.packable(h, w) == jb.packable(h, w)


# --- dense path ---


@pytest.mark.parametrize("notation", ["B3/S23", "B36/S23", "B2/S"])
def test_dense_ops_match(notation):
    wd = world(48, 40, seed=9)
    t = torch.from_numpy(wd)
    assert np.array_equal(tl.step(t, notation).numpy(),
                          np.asarray(jl.step(wd, notation)))
    assert np.array_equal(tl.step_n(t, 25, notation).numpy(),
                          np.asarray(jl.step_n(wd, 25, notation)))
    wj, cj = jl.step_n_counted(wd, 25, notation)
    wt, ct = tl.step_n_counted(t, 25, notation)
    assert np.array_equal(wt.numpy(), np.asarray(wj)) and int(ct) == int(cj)
    nj, mj, cj = jl.step_with_diff(wd, notation)
    nt, mt, ct = tl.step_with_diff(t, notation)
    assert np.array_equal(nt.numpy(), np.asarray(nj))
    assert np.array_equal(mt.numpy(), np.asarray(mj)) and int(ct) == int(cj)
    assert int(tl.alive_count(t)) == int(jl.alive_count(wd))
    assert np.array_equal(tl.neighbour_counts(tl.to_bits(t)).numpy(),
                          np.asarray(jl.neighbour_counts(jl.to_bits(wd))))


@pytest.mark.parametrize("size", [16, 64, 512])
@pytest.mark.parametrize("turns", [0, 1, 100])
def test_dense_goldens(golden_root, size, turns):
    from gol_tpu_torch.io.pgm import read_pgm

    w = torch.from_numpy(read_pgm(golden_root / "images" / f"{size}x{size}.pgm"))
    golden = read_pgm(golden_root / "check" / "images" / f"{size}x{size}x{turns}.pgm")
    assert np.array_equal(tl.step_n(w, turns).numpy(), golden)


def test_random_world_matches():
    assert np.array_equal(tl.random_world(40, 24, 0.3, seed=4),
                          jl.random_world(40, 24, 0.3, seed=4))
    assert np.array_equal(tl.random_world(16384, 16, seed=0),
                          jl.random_world(16384, 16, seed=0))
