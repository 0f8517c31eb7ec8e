"""Bit-packed Game of Life — 32 cells per word, SWAR stepping, plain PyTorch.

The counterpart of `gol_tpu.ops.bitlife`, and the plain version every
CUDA kernel of `ops/cuda_bitlife.py` is held against. Packing 32
vertically-adjacent cells into each word turns the stencil into bitwise
arithmetic on a 32x-smaller array: the 8 neighbour bitboards come from
word shifts (vertical, with cross-word carries) and column rolls
(horizontal), and the neighbour count is computed in bit slices with a
carry-save adder tree.

Layout: `packed[r, x]` holds rows `32r .. 32r+31` of column `x`; bit `i`
(LSB first) is row `32r + i` — bit-identical to gol_tpu's layout.

Storage is int32, not uint32: torch's uint32 lacks `>>`, `<<` and `~` on
the CPU. The bits are the same (`interop.packed_from_numpy` is a view),
but `int32 >> k` sign-extends, so every right shift that must be logical
goes through `lsr`, and the popcount works on 16-bit halves so no
intermediate overflows. Left shifts wrap modulo 2**32 in torch, which is
exactly the uint32 behaviour.

Rule-generic: the 4 count bits feed masks minimized by `ops/rulecomp.py`
(B3/S23 is the reference rule, ref: gol/distributor.go:325-342).
"""

from __future__ import annotations

import numpy as np
import torch

from gol_tpu_torch.models.rules import LIFE, Rule
from gol_tpu_torch.ops import rulecomp
from gol_tpu_torch.ops.life import from_bits, to_bits

WORD = 32

#: int32 bit pattern of bit 31 (uint32 0x80000000).
_BIT31 = -(1 << 31)


def packable(height: int, width: int) -> bool:
    """The packed path needs whole words per column strip."""
    del width
    return height % WORD == 0 and height >= WORD


def pack_np(world) -> np.ndarray:
    """Host-side pack: {0,255} (H, W) uint8 -> uint32 (H/32, W)."""
    bits = (np.asarray(world) != 0).astype(np.uint32)
    h, w = bits.shape
    words = bits.reshape(h // WORD, WORD, w)
    weights = (np.uint32(1) << np.arange(WORD, dtype=np.uint32))[None, :, None]
    return (words * weights).sum(axis=1, dtype=np.uint32)


def unpack_np(packed, height: int) -> np.ndarray:
    """Host-side unpack: uint32 (H/32, W) -> {0,255} uint8 (H, W)."""
    packed = np.asarray(packed)
    shifts = np.arange(WORD, dtype=np.uint32)[None, :, None]
    words = (packed[:, None, :] >> shifts) & np.uint32(1)
    return (words.reshape(height, packed.shape[1]) * np.uint8(255)).astype(
        np.uint8
    )


def pack(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} (H, W) -> int32 (H/32, W), bit i of word r = row 32r+i.
    Bits 0..30 sum without overflow; bit 31 is set as the int32 sign
    pattern, never through an overflowing cast."""
    h, w = bits.shape
    words = bits.reshape(h // WORD, WORD, w).to(torch.int32)
    out = torch.zeros((h // WORD, w), dtype=torch.int32, device=bits.device)
    for i in range(WORD - 1):
        out |= words[:, i, :] << i
    return out | (words[:, WORD - 1, :] * _BIT31)


def unpack(packed: torch.Tensor, height: int) -> torch.Tensor:
    """int32 (H/32, W) -> {0,1} uint8 (H, W). `(p >> i) & 1` reads bit i
    whatever the sign extension put above it."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=packed.device)
    words = (packed[:, None, :] >> shifts[None, :, None]) & 1
    return words.reshape(height, packed.shape[1]).to(torch.uint8)


def lsr(p: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words by 1 <= k <= 31 (the uint32
    `>>`): the arithmetic shift, with the sign-extended bits masked."""
    return (p >> k) & ((1 << (WORD - k)) - 1)


def _shift_up(p: torch.Tensor) -> torch.Tensor:
    """result[y] = orig[y-1] (toroidal): bits move up one row index.
    Word-rows are the second-to-last dim, so a (B, rows, cols) stack
    shifts each board alone."""
    carry = lsr(torch.roll(p, 1, -2), WORD - 1)
    return (p << 1) | carry


def _shift_down(p: torch.Tensor) -> torch.Tensor:
    """result[y] = orig[y+1] (toroidal)."""
    carry = torch.roll(p, -1, -2) << (WORD - 1)
    return lsr(p, 1) | carry


#: Sentinel for an all-ones mask (a cover containing the care-nothing
#: implicant); compared with `is`.
ONE = object()


def rule_masks(p: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
               plan: rulecomp.RulePlan, roll=None) -> tuple:
    """(survive, birth) masks of the compiled plan over the CSA
    neighbour count — each a tensor, None (identically zero), or the
    `ONE` sentinel (identically ones).

    Column-sum form: the 8-neighbour count is (left column sum) +
    (right column sum) + (up + down), where each column sum is the
    2-bit CSA of a vertical triple. `roll(x, 1, -1)` is the LEFT column
    (result[..., x] = x[..., x-1]); columns are the last dim, so a
    (B, rows, cols) stack rolls each board alone. Count bit-slices are
    materialized only if some minimized implicant reads them."""
    if roll is None:
        roll = torch.roll
    need = plan.needed
    # Vertical triple (up + p + down) as 2 bit slices.
    upd = up ^ down
    pc = up & down
    vs = upd ^ p
    vc = pc | (p & upd)
    ls, lc = roll(vs, 1, -1), roll(vc, 1, -1)
    w = p.shape[-1]
    rs, rc = roll(vs, w - 1, -1), roll(vc, w - 1, -1)
    # count = (ls,lc) + (rs,rc) + (up+down as (upd, pc)).
    x = ls ^ rs
    k0 = (ls & rs) | (upd & x)           # carry out of bit 0
    y = lc ^ rc
    t1 = y ^ pc                          # sum of the bit-1 slices
    k1 = (lc & rc) | (pc & y)            # their carry into bit 2
    bits: dict = {}
    if 0 in need:
        bits[0] = x ^ upd
    if 1 in need:
        bits[1] = t1 ^ k0
    if 2 in need or 3 in need:
        k2 = t1 & k0
        if 2 in need:
            bits[2] = k1 ^ k2
        if 3 in need:
            bits[3] = k1 & k2
    cache: dict = {}

    def mask(cover):
        if rulecomp.is_full(cover):
            return ONE
        return rulecomp.emit_mask(cover, bits, cache)

    return mask(plan.survive), mask(plan.birth)


def resolve_mask(m, like: torch.Tensor) -> torch.Tensor:
    """Materialize a rule_masks result as a tensor (for callers that
    cannot exploit the zero/ones sentinels structurally)."""
    if m is None:
        return like ^ like
    if m is ONE:
        return ~(like ^ like)
    return m


def _combine_masks(p: torch.Tensor, plan: rulecomp.RulePlan,
                   survive, birth) -> torch.Tensor:
    """Final combine of the minimized survive/birth masks with the
    current board, in the cheapest form the plan classified."""

    def AND(x, m):
        if m is None:
            return None
        if m is ONE:
            return x
        return x & m

    def OR(a, b):
        if a is None:
            return b
        if b is None:
            return a
        if a is ONE or b is ONE:
            return ONE
        return a | b

    if plan.combine == "b_subset":
        out = OR(birth, AND(p, survive))
    elif plan.combine == "s_subset":
        out = OR(survive, AND(~p, birth))
    else:
        out = OR(AND(p, survive), AND(~p, birth))
    if out is None:
        return p ^ p
    if out is ONE:
        return ~(p ^ p)
    return out


def combine_packed(p: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                   rule: Rule, roll=None) -> torch.Tensor:
    """Horizontal rolls + CSA count + rule combine, given the two
    vertically-shifted bitboards — the single definition of the packed
    rule engine's arithmetic in this package."""
    plan = rulecomp.compile_rule(rule)
    survive, birth = rule_masks(p, up, down, plan, roll)
    return _combine_masks(p, plan, survive, birth)


def step_packed(p: torch.Tensor, rule: Rule = LIFE) -> torch.Tensor:
    """One turn on a packed board, or on each board of a (B, rows, cols)
    stack."""
    return combine_packed(p, _shift_up(p), _shift_down(p), rule)


def step_n_packed_raw(p: torch.Tensor, n: int,
                      rule: Rule = LIFE) -> torch.Tensor:
    """`n` turns, packed in / packed out — the plain version of every
    kernel in `ops/cuda_bitlife.py`. A (B, rows, cols) stack steps each
    board alone (gol_tpu's `jax.vmap` of this function), the plain
    version of the batched entry `step_n_packed_batch_cuda_raw`."""
    for _ in range(n):
        p = step_packed(p, rule)
    return p


def step_n_packed(world: torch.Tensor, n: int,
                  rule: Rule = LIFE) -> torch.Tensor:
    """`n` turns on a {0,255} uint8 world via the packed representation —
    drop-in for `ops.life.step_n` when `packable(H, W)`."""
    world = torch.as_tensor(world)
    p = step_n_packed_raw(pack(to_bits(world)), n, rule)
    return from_bits(unpack(p, world.shape[0]))


def step_n_counted_packed(world: torch.Tensor, n: int,
                          rule: Rule = LIFE) -> tuple:
    """`n` turns + alive count (popcount over the packed words)."""
    world = torch.as_tensor(world)
    p = step_n_packed_raw(pack(to_bits(world)), n, rule)
    return from_bits(unpack(p, world.shape[0])), count_packed(p)


def _popcount16(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of values in [0, 65536) — nothing can overflow."""
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def popcount(p: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 words, bit 31 included."""
    return _popcount16(p & 0xFFFF) + _popcount16((p >> 16) & 0xFFFF)


def count_packed(p: torch.Tensor) -> torch.Tensor:
    """Alive count of a packed board (int32 device scalar)."""
    return torch.sum(popcount(p), dtype=torch.int32)


def make_codec(height: int):
    """(pack_world, unpack_world, fetch) shared by the packed stepper
    backends: pack a {0,255} device world to words, unpack words back,
    and a host `fetch` that unpacks packed int32 worlds and passes
    anything else (dense worlds, bool diff masks) through."""

    def pack_world(world):
        return pack(to_bits(world))

    def unpack_world(p):
        return from_bits(unpack(p, height))

    def fetch(arr):
        if arr.dtype == torch.int32:
            return unpack_world(arr).cpu().numpy()
        return arr.cpu().numpy()

    return pack_world, unpack_world, fetch
