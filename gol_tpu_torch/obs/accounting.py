"""Usage accounting — the part of `gol_tpu.obs.accounting` the engine,
the servers and the session manager call: a process-global `Meter` that
attributes each dispatch's resources, and each peer's wire bytes, to a
principal (the singleton engine's tenant is `LEGACY`, a peer's
`peer:<token>`, a session's its id), and the bucket split
(`split_shares`, `check_conservation`, `Meter.charge_bucket`) that
divides one shared session-bucket dispatch among its tenants.

Host-side and stdlib-only. `GOL_TPU_ACCOUNTING=0` turns the plane off:
`meter()` then answers None and every call site skips metering.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence

# The module, not the `obs.registry()` accessor the package exports
# under the same name.
_reg = importlib.import_module("gol_tpu_torch.obs.registry")

__all__ = ["LEGACY", "Meter", "RESOURCES", "charge", "check_conservation",
           "meter", "split_shares"]

#: The metered resource vocabulary.
RESOURCES = ("dispatch_seconds", "flops", "host_seconds", "wire_bytes",
             "queue_frame_seconds", "turns")

#: The anonymous singleton-engine tenant.
LEGACY = "legacy"

#: Conservation tolerance: shares are forced to sum exactly, so any
#: residual past float noise is a split-rule bug, not rounding.
_CONSERVE_TOL = 1e-6


def split_shares(total: float, weights: Optional[Sequence[float]],
                 n: Optional[int] = None) -> List[float]:
    """Split `total` into shares proportional to `weights` (equal
    shares when weights are absent or sum to zero). The LAST share
    absorbs the floating-point remainder, so the shares sum to `total`
    exactly — the conservation invariant holds by construction."""
    if weights is None:
        if not n:
            return []
        weights = [1.0] * n
    k = len(weights)
    if k == 0:
        return []
    total = float(total)
    wsum = float(sum(weights))
    if wsum <= 0.0:
        shares = [total / k] * k
    else:
        shares = [total * (float(w) / wsum) for w in weights]
    shares[-1] = total - sum(shares[:-1])
    return shares


def check_conservation(total: float, shares: Iterable[float],
                       what: str = "bucket") -> bool:
    """Check that attributed shares sum to the measured total. Returns
    True when conserved; a breach increments the invariant-violation
    counter (and raises under GOL_TPU_CHECK_INVARIANTS=1)."""
    err = abs(float(total) - float(sum(shares)))
    if err <= _CONSERVE_TOL * max(1.0, abs(float(total))):
        return True
    _VIOLATIONS.inc()
    msg = (f"accounting split of {what} lost {err:g} of {total:g} — "
           "attributed shares must sum to the measured bucket total")
    from gol_tpu_torch.obs import flight

    flight.note("invariant.violation", checker="accounting-conservation",
                msg=msg)
    if os.environ.get("GOL_TPU_CHECK_INVARIANTS", "") == "1":
        from gol_tpu_torch.analysis.invariants import InvariantViolation

        raise InvariantViolation(msg)
    return False


_VIOLATIONS = _reg.counter(
    "gol_tpu_invariant_violations_total",
    "Distributed-protocol invariant violations observed at runtime",
    {"checker": "accounting-conservation"},
)


class Meter:
    """Per-principal resource totals under one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: Dict[str, Dict[str, float]] = {}

    def charge(self, principal: str, **amounts: float) -> None:
        """Attribute resources to one principal; unknown resource names
        are rejected (the vocabulary is the contract)."""
        with self._lock:
            tot = self._totals.get(principal)
            if tot is None:
                tot = self._totals[principal] = dict.fromkeys(RESOURCES, 0.0)
            for res, v in amounts.items():
                if res not in tot:
                    raise ValueError(f"unknown resource {res!r}")
                tot[res] += float(v)

    def charge_bucket(self, principals: Sequence[str],
                      weights: Optional[Sequence[float]], *,
                      seconds: float = 0.0, flops: float = 0.0,
                      turns: int = 0, what: str = "bucket") -> None:
        """Split ONE measured shared dispatch (S tenants, one bucket
        launch) across its tenants: activity-weighted when `weights`
        are given (per-slot changed-word counts), equal shares
        otherwise. Turns are NOT split — lockstep buckets advance
        every tenant by the full chunk. Conservation-checked."""
        if not principals:
            return
        sec_shares = split_shares(seconds, weights, len(principals))
        flop_shares = split_shares(flops, weights, len(principals))
        check_conservation(seconds, sec_shares, what)
        check_conservation(flops, flop_shares, what)
        for p, ds, fl in zip(principals, sec_shares, flop_shares):
            self.charge(p, dispatch_seconds=ds, flops=fl, turns=turns)

    def price_flops(self, program: str) -> float:
        """Modeled FLOPs per call of `program`. gol_tpu prices programs
        from XLA's cost analysis; this package has no cost model yet, so
        every price is 0 — no modeled FLOPs, never a guess."""
        del program
        return 0.0

    def forget(self, principal: str) -> None:
        """Drop one principal's totals (a peer detached, a session
        destroyed or parked)."""
        with self._lock:
            self._totals.pop(principal, None)

    def totals(self, principal: str) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals.get(principal, {}))


_METER: Optional[Meter] = (
    Meter() if os.environ.get("GOL_TPU_ACCOUNTING", "1") != "0" else None
)


def meter() -> Optional[Meter]:
    return _METER


def charge(principal: str, **amounts: float) -> None:
    m = _METER
    if m is not None:
        m.charge(principal, **amounts)
