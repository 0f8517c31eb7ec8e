"""On the card: the reference's graph-replayed packed steps equal its
plain steps, and each cell runs a short window at its own size and comes
out correct. Skips without a CUDA card; on the card:
`python -m pytest perfbench/tests -q`."""

import json
import pathlib
import time

import pytest
import torch

from perfbench import run as bench_run
from perfbench.reference import life as ref

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("torus", [True, False])
def test_graph_replay_equals_plain_steps(card, torus):
    board = ref.to_bits(ref.soup(512, 512, 11))[None].to(card)
    got = ref.unpack(ref.run_packed(ref.pack(board), 300, torus), 512)
    want = board
    for _ in range(300):
        want = ref.step(want, torus)
    assert ref.mismatches(got, want) == 0


@pytest.mark.card
@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_is_correct_on_the_card(card, cell):
    result, _ = bench_run.run_cell(BENCH, cell, 2147489999, 3.0, False, card,
                                   time.monotonic())
    assert result["correct"], result
    assert result["device"]["platform"] == "gpu"
