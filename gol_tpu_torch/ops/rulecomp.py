"""Rule compiler — minimized boolean masks for packed stepping (a copy
of `gol_tpu.ops.rulecomp`; the two must give equal `RulePlan`s).

The packed engine (`ops/bitlife.py`) evaluates the B/S rule on 4 count
bit-slices. The naive form ORs one 4-literal minterm per count in the
birth/survive sets (~15 bitwise ops for B3/S23). But an 8-neighbour
count can never exceed 8, so the bit patterns 9..15 are *don't-cares* —
a Quine-McCluskey minimization over them collapses the masks
dramatically (B3/S23's survive mask {2,3} becomes the single implicant
`b1 & ~b2`).

Everything here runs on static python rule data: the compiled plan is
pure structure (implicant tuples), and `emit_mask` replays it as
bitwise ops on whatever array type the caller passes (torch tensors in
this package).

The compiler also reports which count bits the minimized masks actually
read (`RulePlan.needed`), so the carry-save adder can skip materializing
unused slices (B3/S23 never needs bit 3), and classifies the
birth/survive relationship so the final combine can use the cheaper
`B | (p & S)` form when birth ⊆ survive instead of the generic
`(p & S) | (~p & B)`.

The reference hard-codes B3/S23 as per-cell comparisons
(ref: gol/distributor.go:325-342); here any life-like rule compiles to
a near-minimal fused bitwise expression.
"""

from __future__ import annotations

import dataclasses
import functools

from gol_tpu_torch.models.rules import Rule

#: Number of count bit-slices (8 neighbours -> counts 0..8 need 4 bits).
NBITS = 4

#: Bit patterns a neighbour count can actually take.
_REACHABLE = frozenset(range(9))

#: ... and the patterns it cannot (the minimizer's don't-care set).
DONT_CARES = frozenset(range(9, 1 << NBITS))

#: An implicant: (value, care) bit masks over the NBITS count bits —
#: it covers count c iff (c & care) == value. care == 0 covers all.
Implicant = tuple


def _covers(imp: Implicant, m: int) -> bool:
    value, care = imp
    return (m & care) == value


def _prime_implicants(terms: frozenset) -> set:
    """All prime implicants of the given minterm set (Quine-McCluskey
    combine passes: merge pairs differing in exactly one cared bit)."""
    primes: set = set()
    cur = {(m, (1 << NBITS) - 1) for m in terms}
    while cur:
        merged: set = set()
        used: set = set()
        lst = sorted(cur)
        for i, (v1, c1) in enumerate(lst):
            for v2, c2 in lst[i + 1:]:
                if c1 != c2:
                    continue
                d = (v1 ^ v2) & c1
                if d and (d & (d - 1)) == 0:  # differ in exactly one bit
                    merged.add((v1 & ~d, c1 & ~d))
                    used.add((v1, c1))
                    used.add((v2, c2))
        primes |= cur - used
        cur = merged
    return primes


def _select_cover(primes: set, minterms: frozenset) -> tuple:
    """Minimal-ish prime cover of the minterms: essential implicants
    first, then greedy by coverage (4 variables — greedy is exact or
    within one term on everything life-like; determinism matters more)."""
    remaining = set(minterms)
    ordered = sorted(primes)
    chosen: list = []
    while remaining:
        essential = None
        for m in sorted(remaining):
            cov = [p for p in ordered if _covers(p, m)]
            if len(cov) == 1:
                essential = cov[0]
                break
        if essential is None:
            essential = max(
                ordered,
                key=lambda p: (
                    sum(1 for m in remaining if _covers(p, m)),
                    -bin(p[1]).count("1"),
                    (-p[0], -p[1]),  # deterministic tie-break
                ),
            )
        if essential not in chosen:
            chosen.append(essential)
        remaining -= {m for m in remaining if _covers(essential, m)}
    return tuple(sorted(chosen))


def minimize_counts(counts: frozenset) -> tuple:
    """Minimized implicant cover of `counts` ⊆ {0..8}, free to behave
    arbitrarily on the unreachable patterns 9..15."""
    counts = frozenset(counts) & _REACHABLE
    if not counts:
        return ()
    primes = _prime_implicants(counts | DONT_CARES)
    return _select_cover(primes, counts)


@dataclasses.dataclass(frozen=True)
class RulePlan:
    """A compiled rule: minimized survive/birth implicant covers, the
    count bits they read, and the cheapest final-combine form."""

    survive: tuple
    birth: tuple
    needed: frozenset  # count-bit indices any implicant cares about
    combine: str  # 'b_subset' | 's_subset' | 'general'

    def mask_cost(self) -> int:
        """Op count of both masks exactly as emitted: replays
        `emit_mask` (shared cache and all) over counting stand-ins for
        the bit slices, so it cannot drift from the real emission."""
        ops = [0]

        class _Bit:
            def __and__(self, other):
                ops[0] += 1
                return _Bit()

            __or__ = __and__

            def __invert__(self):
                ops[0] += 1
                return _Bit()

        bits = {i: _Bit() for i in range(NBITS)}
        cache: dict = {}
        for cover in (self.survive, self.birth):
            if cover and not is_full(cover):
                emit_mask(cover, bits, cache)
        return ops[0]


def _literals(imp: Implicant) -> tuple:
    """Cared literals, high bit first: life-like rules constrain the
    high count bits the same way in birth and survive (a board cell has
    ≤8 neighbours, so masks mostly say "count < 4, then..."), so this
    order maximizes shared product prefixes between the two masks."""
    value, care = imp
    return tuple(
        (i, bool(value & (1 << i)))
        for i in range(NBITS - 1, -1, -1)
        if care & (1 << i)
    )


@functools.lru_cache(maxsize=None)
def compile_rule(rule: Rule) -> RulePlan:
    survive = minimize_counts(rule.survive)
    birth = minimize_counts(rule.birth)
    needed = frozenset(
        i for cover in (survive, birth) for imp in cover
        for i, _ in _literals(imp)
    )
    b, s = frozenset(rule.birth) & _REACHABLE, frozenset(rule.survive) & _REACHABLE
    if b <= s:
        combine = "b_subset"  # next = B | (p & S)
    elif s <= b:
        combine = "s_subset"  # next = S | (~p & B)
    else:
        combine = "general"  # next = (p & S) | (~p & B)
    return RulePlan(survive=survive, birth=birth, needed=needed,
                    combine=combine)


def emit_mask(cover: tuple, bits: dict, cache: dict):
    """Build the OR-of-products array for an implicant cover.

    `bits` maps count-bit index -> bit-slice array; `cache` memoizes
    NOT-literals and product prefixes so terms shared between the
    survive and birth masks (pass the same dict) are computed once —
    an eager backend does not CSE across expressions, so the
    sharing is done here, structurally.

    Returns None for an empty cover (mask identically 0); a full-ones
    mask (care == 0 implicant) comes back as ~(b & ~b)-free: the caller
    checks `cover == ((0, 0),)` via `is_full` instead, since no
    all-ones constant exists without knowing the array shape.
    """
    terms = []
    for imp in cover:
        lits = _literals(imp)
        if not lits:  # covers everything; caller must special-case
            raise ValueError("full cover has no array form; use is_full")
        prefix: tuple = ()
        acc = None
        for lit in lits:
            prefix += (lit,)
            if prefix in cache:
                acc = cache[prefix]
                continue
            idx, positive = lit
            if positive:
                literal = bits[idx]
            elif ("~", idx) in cache:
                literal = cache[("~", idx)]
            else:
                literal = ~bits[idx]
                cache[("~", idx)] = literal
            acc = literal if acc is None else acc & literal
            cache[prefix] = acc
        terms.append(acc)
    if not terms:
        return None
    out = terms[0]
    for t in terms[1:]:
        out = out | t
    return out


def is_full(cover: tuple) -> bool:
    """True iff the cover contains the care-nothing implicant (mask is
    identically all-ones on reachable counts)."""
    return any(care == 0 for _, care in cover)


def evaluate_cover(cover: tuple, count: int) -> bool:
    """Reference evaluator (tests): does the minimized cover accept this
    count pattern?"""
    return any(_covers(imp, count) for imp in cover)
