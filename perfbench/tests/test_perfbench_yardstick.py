"""The frozen yardstick: the counted Life form computes Life in 12
instructions a word, the counts follow the shapes, and the busy and
idle time of a trace come out as a synthetic trace's known gaps."""

import pytest
import torch

from perfbench import harness, yardstick
from perfbench.reference import life as ref


def test_counted_form_is_life_in_12_instructions_a_word():
    board = ref.to_bits(ref.soup(128, 96, 3))
    packed = ref.pack(board[None])[0]
    nxt, count = yardstick.life_packed_step_counted(packed)
    assert count == yardstick.LIFE_OPS_PER_WORD_TURN == 12
    assert torch.equal(ref.unpack(nxt, 128), ref.step(board))


def test_counts_follow_the_shapes():
    assert yardstick.packed_words(5120, 5120) == 160 * 5120
    assert yardstick.packed_words(512, 512, 256) == 256 * 16 * 512
    words, turns = 160 * 5120, 32
    ops = words * turns * 12
    secs = ops / yardstick.INT32_OPS_PER_S
    share, bound = yardstick.life_roofline_pct(10, 10 * secs * 4, words,
                                               turns)
    assert bound == "operations" and share == pytest.approx(25.0)
    # One turn a pass: the bytes bound it.
    share, bound = yardstick.life_roofline_pct(1, 1.0, words, 1)
    assert bound == "bytes"
    assert share == pytest.approx(100 * 8 * words / 3.35e12)
    assert yardstick.life_roofline_pct(0, 1.0, words, 1) is None
    assert yardstick.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)


def test_union_and_gaps():
    spans = [(1, 3), (2, 4), (6, 7), (9, 12)]
    assert yardstick.union_seconds(spans, 0, 10) == 3 + 1 + 1
    assert yardstick.idle_gaps(spans, 0, 10) == [(4, 6), (7, 9), (0, 1)]
    assert yardstick.union_seconds([], 0, 10) == 0
    assert yardstick.idle_gaps([], 0, 10) == [(0, 10)]


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_trace_on_known_gaps():
    events = [
        _x("user_annotation", harness.WINDOW_MARK, 1000, 1000),
        _x("kernel", "void bitlife_tiled<0>(unsigned int const*, int)",
           900, 300),                               # clipped to 1000..1200
        _x("kernel", "void bitlife_tiled<0>(unsigned int const*, int)",
           1300, 400),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1650, 100),
        _x("kernel", "void other(int)", 1900, 200),   # clipped to ..2000
        _x("cuda_runtime", "cudaStreamSynchronize", 1210, 80),
        _x("cpu_op", "aten::copy_", 1735, 10),
        _x("kernel", "void outside(int)", 2500, 10),
    ]
    t = harness.summarize_trace(events)
    assert t["window_s"] == pytest.approx(1000e-6)
    # Busy: 1000-1200, 1300-1750, 1900-2000.
    assert t["busy_s"] == pytest.approx(750e-6)
    name = "void bitlife_tiled<0>(unsigned int const*, int)"
    n, secs = t["kernels"][name]
    assert n == 2 and secs == pytest.approx(600e-6)
    assert "void outside(int)" not in t["kernels"]
    assert t["device_ops"][0] == ["bitlife_tiled<0>", pytest.approx(600e-6)]
    # Gaps, longest first: 1750-1900 after aten::copy_ ended, then
    # 1200-1300 with the synchronize running at its midpoint.
    assert t["idle_gaps"] == [["after aten::copy_", pytest.approx(150e-6)],
                              ["cudaStreamSynchronize",
                               pytest.approx(100e-6)]]


def test_summarize_trace_needs_the_window_mark():
    with pytest.raises(ValueError):
        harness.summarize_trace([_x("kernel", "k", 0, 1)])
