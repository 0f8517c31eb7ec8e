"""Exact cycle fast-forward for astronomically long runs.

The counterpart of `gol_tpu.engine.cycles`. Finite Life boards are
eventually periodic, and periodicity makes fast-forward bit-exact: if
`world(t) == world(a)` then `world(t + k) == world(a + k)` for all k, so
the remaining turns collapse modulo `m = t - a`. Equality is a full
device-side compare (`Tensor.equal`, or a ring's `Sharded.equal` shard
by shard, one scalar a tensor comes back) — a hit can never be
spurious.

Detection is a Brent-style anchor walk at dispatch granularity: hold an
anchor state, compare the committed world against it at a wall-clock
cadence, and double the anchor's lease each refresh so some anchor
eventually lands inside the cycle with a lease long enough to see a
full period.
"""

from __future__ import annotations

import time

import torch


class CycleDetector:
    """Feed `observe(turn, world)` after each committed dispatch; it
    returns a period multiple `m` once `world` provably equals an
    earlier committed state `m` turns back, else None. The anchor is a
    reference to a committed world, so it needs steppers that return a
    new world each dispatch: the tiled stepper updates its host world in
    place, and the engine runs no detector on it."""

    def __init__(self, interval_seconds: float = 2.0):
        self.interval = interval_seconds
        self._anchor = None
        self._anchor_turn = -1
        self._lease = 1  # compares until the anchor is replaced
        self._used = 0
        self._next_check = time.monotonic() + interval_seconds

    def observe(self, turn: int, world: torch.Tensor) -> int | None:
        # In a multi-process job every exchange of a sharded world needs
        # every process, and the workers replay only the stepper's
        # dispatches (parallel/multihost.py): the compare below is not
        # one of them, so it would strand them — no detection there, as
        # in gol_tpu.
        from gol_tpu_torch.parallel import multihost

        if multihost.process_count() > 1:
            return None
        now = time.monotonic()
        if now < self._next_check:
            return None
        self._next_check = now + self.interval
        if self._anchor is None:
            self._anchor, self._anchor_turn = world, turn
            return None
        # One scalar realization; the compare itself runs on the device.
        if self._anchor.equal(world):
            return turn - self._anchor_turn
        self._used += 1
        if self._used >= self._lease:
            # Brent doubling: a longer-lived anchor further along the orbit.
            self._anchor, self._anchor_turn = world, turn
            self._lease *= 2
            self._used = 0
        return None
