"""The plain reference (`perfbench/reference/life.py`) against the golden
boards, its packed form against its dense form, and its soup against the
port's seeded soup."""

import pathlib

import numpy as np
import pytest
import torch

from perfbench.reference import life as ref

ROOT = pathlib.Path(__file__).resolve().parents[2]
IMAGES = ROOT / "fixtures" / "images"
CHECK = ROOT / "fixtures" / "check" / "images"


@pytest.mark.parametrize("side", [16, 64, 512])
@pytest.mark.parametrize("turns", [1, 100])
def test_reference_equals_golden_boards(side, turns):
    start = ref.to_bits(ref.read_pgm(IMAGES / f"{side}x{side}.pgm"))
    want = ref.to_bits(ref.read_pgm(CHECK / f"{side}x{side}x{turns}.pgm"))
    dense = start[None]
    for _ in range(turns):
        dense = ref.step(dense)
    assert ref.mismatches(dense[0], want) == 0
    # run_to steps packed where the height is whole words.
    assert ref.mismatches(ref.run_to(start[None], [turns])[0], want) == 0


@pytest.mark.parametrize("shape", [(32, 32), (64, 40), (96, 33), (128, 7)])
@pytest.mark.parametrize("torus", [True, False])
def test_packed_step_equals_dense_step(shape, torus):
    h, w = shape
    dense = ref.to_bits(ref.soup(h, w, h * w + torus))[None]
    packed = ref.pack(dense)
    assert torch.equal(ref.unpack(packed, h), dense)
    for _ in range(30):
        dense, packed = ref.step(dense, torus), ref.step_packed(packed, torus)
        assert torch.equal(ref.unpack(packed, h), dense)


def test_broken_torus_differs_at_the_edges_only():
    board = ref.to_bits(ref.soup(64, 64, 5))[None]
    torus, flat = ref.step(board), ref.step(board, torus=False)
    assert ref.mismatches(torus, flat) > 0
    assert torch.equal(torus[..., 1:-1, 1:-1], flat[..., 1:-1, 1:-1])


def test_run_to_keeps_each_board_at_its_own_turn():
    boards = torch.stack([ref.to_bits(ref.soup(64, 48, s)) for s in range(4)])
    turns = [5, 0, 17, 5]
    got = ref.run_to(boards, turns)
    for i, t in enumerate(turns):
        x = boards[i:i + 1]
        for _ in range(t):
            x = ref.step(x)
        assert torch.equal(got[i], x[0])


@pytest.mark.parametrize("seed", [0, 7, 2147483901, 2**40 + 3])
def test_soup_is_the_ports_seeded_soup(seed):
    from gol_tpu_torch.sessions.manager import seeded_board

    np.testing.assert_array_equal(ref.soup(96, 64, seed),
                                  seeded_board(96, 64, seed))
    assert (ref.soup(96, 64, seed) != ref.soup(96, 64, seed + 1)).any()


def test_read_pgm_skips_comments(tmp_path):
    board = ref.soup(8, 16, 1)
    path = tmp_path / "b.pgm"
    path.write_bytes(b"P5\n# a comment\n16 8\n255\n" + board.tobytes())
    np.testing.assert_array_equal(ref.read_pgm(path), board)
