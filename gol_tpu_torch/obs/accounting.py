"""Usage accounting — the part of `gol_tpu.obs.accounting` the engine
and the server call: a process-global `Meter` that attributes each
dispatch's resources, and each peer's wire bytes, to a principal (the
singleton engine's tenant is `LEGACY`, a peer's `peer:<token>`).

Host-side and stdlib-only. `GOL_TPU_ACCOUNTING=0` turns the plane off:
`meter()` then answers None and every call site skips metering.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

__all__ = ["LEGACY", "Meter", "RESOURCES", "charge", "meter"]

#: The metered resource vocabulary.
RESOURCES = ("dispatch_seconds", "flops", "host_seconds", "wire_bytes",
             "queue_frame_seconds", "turns")

#: The anonymous singleton-engine tenant.
LEGACY = "legacy"


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

    def price_flops(self, program: str) -> float:
        """Modeled FLOPs per call of `program`. gol_tpu prices programs
        from XLA's cost analysis; this package has no cost model yet, so
        every price is 0 — no modeled FLOPs, never a guess."""
        del program
        return 0.0

    def forget(self, principal: str) -> None:
        """Drop one principal's totals (a peer detached)."""
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
