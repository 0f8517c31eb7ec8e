"""The port's wire codec against gol_tpu's, byte for byte.

For every frame kind — board, flips, final, level-flips, delta-sparse,
k-turn batch (`fbatch`), metric samples (`msamples`), heartbeat — and
every JSON fallback, the two packages' encoders produce identical bytes
on the same seeded numpy inputs, and each package's decoder reads the
other's frames to an equal dict. The bounded-decompression and
truncation cases of gol_tpu's own wire tests run against both decoders,
one case per parameter.
"""

import dataclasses
import json
import socket
import struct
import zlib

import numpy as np
import pytest
import torch

from gol_tpu import events as jev
from gol_tpu.distributed import wire as jw
from gol_tpu.utils.cell import Cell as JCell
from gol_tpu_torch import events as tev
from gol_tpu_torch.distributed import wire as tw
from gol_tpu_torch.utils.cell import Cell as TCell

WIRES = {"gol_tpu": jw, "gol_tpu_torch": tw}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _norm(v):
    """A decoded message or event in a package-neutral form: arrays as
    (dtype, shape, bytes), events as (class name, fields), cells as
    tuples."""
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if dataclasses.is_dataclass(v):
        return (type(v).__name__,
                {f.name: _norm(getattr(v, f.name))
                 for f in dataclasses.fields(v)})
    if hasattr(v, "name") and hasattr(v, "value"):  # State enums
        return ("enum", v.name)
    return v


def _cells(rng, n, w=512, h=512):
    return np.stack([rng.integers(0, w, n), rng.integers(0, h, n)],
                    axis=1).astype(np.int32)


def _world(rng, h, w, p=0.3):
    return ((rng.random((h, w)) < p).astype(np.uint8) * 255)


def _sparse_chunk(rng, k, w, h, settle_from=None):
    """A chunk in the device compact layout: per-turn counts, changed-
    word bitmaps and ascending word masks; turns past `settle_from`
    repeat the previous turn exactly (a settled board's case)."""
    total, nb = jw.grid_words(w, h)
    counts, bms, vals = [], [], []
    prev = None
    for t in range(k):
        if settle_from is not None and t >= settle_from and prev is not None:
            c, bm, v = prev
        else:
            idx = np.sort(rng.choice(total, rng.integers(0, 12),
                                     replace=False))
            v = rng.integers(1, 1 << 32, idx.size, dtype=np.uint64
                             ).astype(np.uint32)
            bm = jw._indices_to_bitmap(idx, nb)
            c = idx.size
        prev = (c, bm, v)
        counts.append(c)
        bms.append(bm)
        vals.append(v)
    return (np.array(counts, np.int64), np.stack(bms),
            np.concatenate(vals).astype(np.uint32), total, nb)


def _frames(w, seed):
    """(kind, bytes) of every binary frame kind from wire module `w`,
    on inputs made from `seed`."""
    rng = np.random.default_rng(seed)
    cells = _cells(rng, 500)
    world = _world(rng, 48, 64)
    levels = rng.integers(0, 256, len(cells)).astype(np.uint8)
    out = [
        ("flips", w.flips_to_frame(11, cells)),
        ("board", w.board_to_frame(33, world, token=7)),
        ("final", w.final_to_frame(99, [JCell(int(x), int(y))
                                        for x, y in cells[:200]])),
        ("lflips", w.level_flips_to_frame(12, cells, levels)),
        ("hb", w.heartbeat_to_frame(12345)),
        ("msamples", w.samples_to_frame(
            1700000000.25, [("gol_tpu_engine_turns_total", 42.0),
                            ('gol_tpu_x{peer="3"}', float(seed))],
            full=bool(seed & 1), meta={"alerts": []} if seed & 2 else None)),
    ]
    total, nb = w.grid_words(64, 96)
    xy = _cells(rng, 300, 64, 96)
    bitmap, words = w.coords_to_words(xy, 64, 96)
    prev = np.zeros(nb, np.uint32)
    prev[: nb // 2] = rng.integers(0, 1 << 32, nb // 2, dtype=np.uint64)
    out.append(("dflips", w.delta_flips_to_frame(5, bitmap ^ prev, words)))
    counts, bms, vals, total, nb = _sparse_chunk(rng, 9, 64, 96,
                                                 settle_from=4)
    for a, b in ((0, 9), (0, 4), (3, 9)):
        dc, dbm, dw = w.chunk_deltas(counts, bms, vals, a, b, total)
        out.append((f"fbatch{a}-{b}",
                    w.flip_batch_to_frame(100 + a, nb, dc, dbm, dw, 3.5)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_every_frame_kind_is_byte_identical(seed):
    ours, theirs = _frames(tw, seed), _frames(jw, seed)
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (kind, a), (_, b) in zip(ours, theirs):
        assert a == b, kind
        # Length-prefixed framing too.
        assert tw.frame_bytes(a) == jw.frame_bytes(b)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("encoder,decoder",
                         [("gol_tpu", "gol_tpu_torch"),
                          ("gol_tpu_torch", "gol_tpu")])
def test_decoders_read_each_others_frames(seed, encoder, decoder):
    enc, dec = WIRES[encoder], WIRES[decoder]
    for kind, frame in _frames(enc, seed):
        got = dec._parse_frame(frame)
        ref = enc._parse_frame(frame)
        assert _norm(got) == _norm(ref), kind
        if got["t"] in ("flips", "ev"):
            assert (_norm(dec.msg_to_events(got))
                    == _norm(enc.msg_to_events(ref))), kind


@pytest.mark.parametrize("seed", [0, 5])
def test_chunk_deltas_and_words_identical(seed):
    rng = np.random.default_rng(seed)
    counts, bms, vals, total, nb = _sparse_chunk(rng, 12, 96, 64,
                                                 settle_from=6)
    for a, b in ((0, 12), (2, 7), (6, 12), (11, 12)):
        ours = tw.chunk_deltas(counts, bms, vals, a, b, total)
        theirs = jw.chunk_deltas(counts, bms, vals, a, b, total)
        assert _norm(list(ours)) == _norm(list(theirs))
    xy = _cells(rng, 400, 96, 64)
    bm, words = tw.coords_to_words(xy, 96, 64)
    jbm, jwords = jw.coords_to_words(xy, 96, 64)
    assert bm.tobytes() == jbm.tobytes()
    assert words.tobytes() == jwords.tobytes()
    back = tw.words_to_coords(bm, words, 96, 64)
    assert back.tobytes() == jw.words_to_coords(jbm, jwords, 96, 64).tobytes()
    assert (sorted(map(tuple, back.tolist()))
            == sorted(set(map(tuple, xy.tolist()))))


def _events(ev, cell):
    return [
        ev.AliveCellsCount(7, 42),
        ev.ImageOutputComplete(8, "64x64x8"),
        ev.StateChange(9, ev.State.PAUSED),
        ev.StateChange(10, ev.State.QUITTING),
        ev.TurnComplete(10),
        ev.FinalTurnComplete(11, [cell(1, 2), cell(3, 4), cell(63, 0)]),
        ev.CellFlipped(12, cell(5, 6)),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_json_fallbacks_identical(seed):
    rng = np.random.default_rng(seed)
    world = _world(rng, 40, 72)
    cells = _cells(rng, 300)
    levels = rng.integers(0, 256, len(cells)).astype(np.uint8)
    pairs = [
        (tw.board_to_msg(3, world, token=9), jw.board_to_msg(3, world,
                                                            token=9)),
        (tw.flips_to_msg(4, cells), jw.flips_to_msg(4, cells)),
        (tw.flips_to_msg(4, cells, levels), jw.flips_to_msg(4, cells,
                                                           levels)),
    ]
    pairs += [(tw.event_to_msg(a), jw.event_to_msg(b))
              for a, b in zip(_events(tev, TCell), _events(jev, JCell))]
    for ours, theirs in pairs:
        assert json.dumps(ours) == json.dumps(theirs)
    for ours, theirs in pairs:
        for dec, enc in ((tw, jw), (jw, tw)):
            msg = json.loads(json.dumps(ours))
            if msg["t"] == "board":
                t1, b1 = dec.msg_to_board(msg)
                t2, b2 = enc.msg_to_board(msg)
                assert t1 == t2 and b1.tobytes() == b2.tobytes()
                np.testing.assert_array_equal(b1, world)
            else:
                assert (_norm(dec.msg_to_events(msg))
                        == _norm(enc.msg_to_events(msg)))
                if msg["t"] == "flips":
                    lv = dec.msg_flips_levels(msg)
                    ref = enc.msg_flips_levels(msg)
                    assert _norm(lv) == _norm(ref)


@pytest.mark.parametrize("sender,receiver",
                         [("gol_tpu", "gol_tpu_torch"),
                          ("gol_tpu_torch", "gol_tpu")])
def test_socket_framing_crossed(sender, receiver):
    snd, rcv = WIRES[sender], WIRES[receiver]
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    try:
        rng = np.random.default_rng(3)
        cells = _cells(rng, 1000)
        snd.send_frame(a, snd.flips_to_frame(9, cells))
        turn, coords = rcv.msg_flips_array(rcv.recv_msg(b))
        assert turn == 9
        np.testing.assert_array_equal(coords, cells)
        snd.send_msg(a, {"t": "ev", "k": "turn", "turn": 3})
        assert rcv.recv_msg(b) == {"t": "ev", "k": "turn", "turn": 3}
        snd.send_frame(a, bytes([17]) + b"future")
        assert rcv.recv_msg(b)["t"] == "bin17"
        snd.send_frame(a, snd.heartbeat_to_frame(77))
        assert rcv.recv_msg(b) == {"t": "hb", "turn": 77}
        # A control-only receiver refuses bulk frames without inflating.
        snd.send_frame(a, snd.board_to_frame(1, np.zeros((8, 8), np.uint8)))
        with pytest.raises(rcv.WireError):
            rcv.recv_msg(b, allow_binary=False)
    finally:
        a.close()
        b.close()


def _bomb_cases():
    """(name, callable(wire)) — every bounded-decompression and
    truncation case of gol_tpu's own wire tests."""
    blob = zlib.compress(bytes(1 << 20), 1)

    def bomb_over_limit(w):
        w._decompress(blob, limit=1 << 10)

    def truncated_stream(w):
        w._decompress(blob[:-4])

    def board_lies_small(w):
        msg = w.board_to_msg(1, np.zeros((256, 256), np.uint8))
        msg["height"] = msg["width"] = 4
        w.msg_to_board(msg)

    def board_negative(w):
        w.msg_to_board({"t": "board", "turn": 0, "height": -1, "width": 8,
                        "data": ""})

    def binary_board_lies_small(w):
        frame = w.board_to_frame(1, np.zeros((256, 256), np.uint8))
        lie = w._BOARD_HDR.pack(w._TAG_BOARD, 1, 4, 4, 0)
        w._parse_frame(lie + frame[w._BOARD_HDR.size:])

    def coords_not_multiple_of_8(w):
        w._parse_frame(w._FLIPS_HDR.pack(w._TAG_FLIPS, 2)
                       + zlib.compress(b"abc", 1))

    def fbatch_counts_lie(w):
        counts = np.array([2, 0], np.uint32)
        bms = np.array([[0b11, 0]], np.uint32)
        words = np.array([1, 2], np.uint32)
        frame = bytearray(w.flip_batch_to_frame(1, 2, counts, bms,
                                                words, 0.0))
        # Claim 3 turns where the counts blob carries 2.
        struct.pack_into("<I", frame, 9, 3)
        w._parse_frame(bytes(frame))

    def fbatch_popcount_lie(w):
        counts = np.array([2], np.uint32)
        bms = np.array([[0b111, 0]], np.uint32)
        words = np.array([1, 2], np.uint32)
        w._parse_frame(w.flip_batch_to_frame(1, 2, counts, bms, words, 0.0))

    def dflips_words_lie(w):
        frame = bytearray(w.delta_flips_to_frame(
            1, np.zeros(4, np.uint32), np.arange(1, 5, dtype=np.uint32)))
        struct.pack_into("<I", frame, 9, 2)
        w._parse_frame(bytes(frame))

    def msamples_count_lie(w):
        frame = bytearray(w.samples_to_frame(1.0, [("a", 1.0)]))
        struct.pack_into("<I", frame, 9, 2)
        w._parse_frame(bytes(frame))

    def lflips_overrun(w):
        frame = bytearray(w.level_flips_to_frame(
            1, np.zeros((3, 2), np.int32), np.zeros(3, np.uint8)))
        struct.pack_into("<I", frame, 9, 1 << 20)
        w._parse_frame(bytes(frame))

    cases = [bomb_over_limit, truncated_stream, board_lies_small,
             board_negative, binary_board_lies_small,
             coords_not_multiple_of_8, fbatch_counts_lie,
             fbatch_popcount_lie, dflips_words_lie, msamples_count_lie,
             lflips_overrun]
    for payload in (b"", b"\x01", b"\x01\x07", b"\x02\x00",
                    jw._FLIPS_HDR.pack(jw._TAG_FLIPS, 1) + b"notzlib"):
        def short(w, payload=payload):
            w._parse_frame(payload)
        short.__name__ = f"short_frame_{payload[:3].hex() or 'empty'}"
        cases.append(short)
    return [(c.__name__, c) for c in cases]


@pytest.mark.parametrize("name,case", _bomb_cases(),
                         ids=[n for n, _ in _bomb_cases()])
def test_bounded_decode_rejects_in_both(name, case):
    for w in (tw, jw):
        with pytest.raises(w.WireError):
            case(w)


def test_decompression_within_limit_agrees():
    blob = zlib.compress(bytes(1 << 20), 1)
    assert tw._decompress(blob, limit=1 << 20) == bytes(1 << 20)
    assert tw.MAX_FRAME == jw.MAX_FRAME and tw.MAX_RAW == jw.MAX_RAW
    assert tw.FBATCH_MAX_TURNS == jw.FBATCH_MAX_TURNS
    assert tw.FBATCH_ZLIB_MAX == jw.FBATCH_ZLIB_MAX
