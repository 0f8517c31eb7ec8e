"""Cellular-automaton rule models.

The reference hard-codes Conway's B3/S23 in two places (worker path ref:
gol/distributor.go:325-342, serial path ref: gol/distributor.go:350-379).
Here the rule is a *model*: a (birth, survival) pair over the
8-neighbour count in standard B/S notation. The step kernel unrolls the
sets into fused compare/or terms at trace time (ops/life.py:apply_rule),
so Conway Life costs exactly the same as any other life-like rule and no
lookup happens at runtime.
"""

from __future__ import annotations

import dataclasses
import re

_RULE_RE = re.compile(r"^B(?P<birth>[0-8]*)/S(?P<survive>[0-8]*)$", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Rule:
    """A life-like rule: dead cell with n neighbours becomes alive iff
    n ∈ birth; live cell stays alive iff n ∈ survive (B3/S23 semantics
    ref: gol/distributor.go:325-342)."""

    name: str
    birth: frozenset
    survive: frozenset

    @classmethod
    def parse(cls, notation: str) -> "Rule":
        m = _RULE_RE.match(notation.strip())
        if not m:
            raise ValueError(f"bad B/S rule notation: {notation!r}")
        return cls(
            name=notation.upper(),
            birth=frozenset(int(c) for c in m.group("birth")),
            survive=frozenset(int(c) for c in m.group("survive")),
        )

    def __str__(self) -> str:
        return self.name


LIFE = Rule.parse("B3/S23")


_GEN_RULE_RE = re.compile(
    r"^B(?P<birth>[0-8]*)/S(?P<survive>[0-8]*)/C(?P<states>\d+)$",
    re.IGNORECASE,
)


@dataclasses.dataclass(frozen=True)
class GenRule:
    """A Generations rule — the multi-state extension of the life-like
    family (B/S/C notation): cell states are 0 (dead), 1 (alive),
    2..states-1 (dying). An alive cell with n ∈ survive stays alive,
    else starts dying; a dead cell with n ∈ birth is born; a dying cell
    ages by one each turn until it wraps to dead. Only state-1 cells
    count as neighbours. C=2 has no dying states and reduces exactly to
    the life-like `Rule` with the same B/S sets (asserted in tests).

    No reference analog — the reference hard-codes two-state B3/S23;
    this is the `models/` axis generalized one step further (classic
    members: Brian's Brain B2/S/C3, Star Wars B2/S345/C4)."""

    name: str
    birth: frozenset
    survive: frozenset
    states: int

    @classmethod
    def parse(cls, notation: str) -> "GenRule":
        m = _GEN_RULE_RE.match(notation.strip())
        if not m:
            raise ValueError(f"bad B/S/C generations notation: {notation!r}")
        states = int(m.group("states"))
        if not 2 <= states <= 255:
            # Above 255 the uint8 state grid overflows and the gray-
            # level PGM mapping loses injectivity (ops/generations.py).
            raise ValueError(
                f"generations rule needs 2 <= states <= 255: {notation!r}"
            )
        return cls(
            name=notation.upper(),
            birth=frozenset(int(c) for c in m.group("birth")),
            survive=frozenset(int(c) for c in m.group("survive")),
            states=states,
        )

    def __str__(self) -> str:
        return self.name


#: A few well-known model variants, usable via Params(rule=...).
RULES = {
    "B3/S23": LIFE,  # Conway's Game of Life — the reference's model
    "B36/S23": Rule.parse("B36/S23"),  # HighLife
    "B3678/S34678": Rule.parse("B3678/S34678"),  # Day & Night
    "B1357/S1357": Rule.parse("B1357/S1357"),  # Replicator
    "B2/S": Rule.parse("B2/S"),  # Seeds
    "B2/S/C3": GenRule.parse("B2/S/C3"),  # Brian's Brain
    "B2/S345/C4": GenRule.parse("B2/S345/C4"),  # Star Wars
}


def get_rule(notation: str):
    """Resolve B/S (life-like `Rule`) or B/S/C (`GenRule`) notation."""
    notation = notation.strip()  # both parsers strip; the named lookup
    # must too, or ' B3/S23 ' would return a fresh non-identical Rule
    named = RULES.get(notation.upper())
    if named is not None:
        return named
    if _GEN_RULE_RE.match(notation.strip()):
        return GenRule.parse(notation)
    return Rule.parse(notation)
