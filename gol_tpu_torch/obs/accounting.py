"""Accounting plane — per-principal resource attribution + usage ledger
(the port of `gol_tpu.obs.accounting`; same ledger records, metric
names and `/usage` payload).

Every resource the serving plane spends is attributed to a
**principal**: a session id (the bucketed multi-tenant path), a peer
token (`peer:<token>`, wire-level clients that never attached a
session), or the anonymous singleton engine (`legacy`). Metered
resources, one vocabulary everywhere (live series, ledger, `/usage`,
the console's TOP view):

- ``dispatch_seconds``  host-blocking device dispatch time;
- ``flops``             modeled operations — the device plane's
                        `cost_of` program price × dispatched turns (0
                        until a price is published: the CLI enables
                        the cost probes, library embedders opt in).
                        The port's price is its own operation count,
                        not XLA's `cost_analysis`, so the two
                        packages' ledgers agree in shape, not in this
                        column's values;
- ``host_seconds``      host encode/decode time at the span
                        boundaries (wire.encode_*);
- ``wire_bytes``        frame payload bytes enqueued to the peer, at
                        every tier (EngineServer, SessionServer,
                        relay, WS — all sends pass one `_Conn` hook);
- ``queue_frame_seconds`` writer-queue occupancy — queued frames
                        integrated over the heartbeat sweep interval;
- ``turns``             turns advanced on behalf of the principal.

The hard case is the bucketed session path: S tenants share ONE
bucket dispatch (one launch of kernel A for a packable bucket), so `charge_bucket` splits each measured bucket total
by a declared rule — activity-weighted (per-slot changed-word counts
from the diff/compact headers) when the dispatch produced them, equal
turn-weighted shares otherwise — with a **conservation invariant**:
the shares sum EXACTLY to the measured total (the last share absorbs
the float remainder; any residual increments
`gol_tpu_invariant_violations_total{checker="accounting-conservation"}`
and raises under `GOL_TPU_CHECK_INVARIANTS=1`).

Usage is exposed three ways:

- live bounded-cardinality series: one `TopKGauge` per resource
  (`gol_tpu_usage_<resource>{principal=...}`), children evicted at
  session destroy / peer detach through the registry's shared
  `evict_entity` helper;
- a crash-atomic append-only **ledger**: JSONL delta records in
  size-rolled segments (`usage-<pid>-*.jsonl`), append+flush per
  batch from a dedicated thread (never under a serving lock), torn
  tails tolerated by the reader — `python -m gol_tpu_torch.obs.report
  usage DIR` aggregates segments across processes/incarnations;
- the `/usage` endpoint on every metrics sidecar (`payload()`), which
  `obs.console` joins into the fleet TOP-by-cost view.

Soft budgets (`--session-budget-flops/-bytes`) mark principals
over-budget in the payload and on the `gol_tpu_usage_over_budget`
gauge (alert-rule food) — deliberately NOT enforced: this plane is
the substrate placement/rate-limit decisions will act on, not the
enforcer.

`GOL_TPU_ACCOUNTING=0` disables everything: `meter()` answers None,
so every call site's one-branch guard skips metering entirely — zero
wrappers, zero ledger I/O. Stdlib only, like the registry below it;
all metering is host-side at dispatch/event granularity, never inside
a kernel.
"""

from __future__ import annotations

import contextlib
import importlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

# The obs package re-binds the NAME `gol_tpu_torch.obs.registry` to its
# same-named convenience FUNCTION (the tracing.py idiom), so the
# submodule must be imported by path.
_reg = importlib.import_module("gol_tpu_torch.obs.registry")

__all__ = [
    "LEGACY",
    "LedgerWriter",
    "Meter",
    "RESOURCES",
    "charge",
    "check_conservation",
    "configure",
    "enabled",
    "ledger_close",
    "meter",
    "payload",
    "read_ledger",
    "set_enabled",
    "split_shares",
]

#: The metered resource vocabulary — ledger records, live series and
#: `/usage` payloads all key by exactly these.
RESOURCES = ("dispatch_seconds", "flops", "host_seconds", "wire_bytes",
             "queue_frame_seconds", "turns")

#: The anonymous singleton-engine tenant (pre-session serving tier).
LEGACY = "legacy"

#: Live-series cardinality bound (the TopKGauge cap) — the top
#: spenders an operator wants named; the ledger keeps everyone.
USAGE_TOPK = 16

_HELP = {
    "dispatch_seconds": "Attributed device dispatch seconds per principal",
    "flops": "Attributed modeled FLOPs (cost_of price x turns) per "
             "principal",
    "host_seconds": "Attributed host encode/decode seconds per principal",
    "wire_bytes": "Attributed wire payload bytes per principal",
    "queue_frame_seconds": "Writer-queue occupancy (queued frames x "
                           "sweep seconds) per principal",
    "turns": "Turns advanced per principal",
}

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
    """Assert attributed shares sum to the measured total. Returns
    True when conserved; a breach increments the invariant-violation
    counter (and raises under GOL_TPU_CHECK_INVARIANTS=1) — the
    invariant checker's idiom, applied to money instead of stream order."""
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


# --- the ledger ----------------------------------------------------------

#: Disambiguates same-millisecond writers within one process (tests,
#: meter reconfiguration) — part of each writer's segment stamp.
_WRITER_SEQ = itertools.count()


class LedgerWriter:
    """Crash-safe append-only usage ledger: JSONL delta records in
    size-rolled segments under `directory`, written by a DEDICATED
    daemon thread (ledger I/O never runs under a serving lock — the
    drain callable swaps the pending map under the meter's own lock
    and the file write happens lock-free). Discipline matches the
    replay recorder: append + flush per batch, rollover past
    `max_segment_bytes` onto a fresh segment, torn tails are the
    reader's job (`read_ledger` skips them, never raises)."""

    def __init__(self, directory: str, drain,
                 max_segment_bytes: int = 4 << 20,
                 flush_secs: float = 1.0):
        self.directory = directory
        self.max_segment_bytes = int(max_segment_bytes)
        self.flush_secs = float(flush_secs)
        self._drain = drain
        self._seq = 0
        self._rec_seq = 0
        self._file = None
        self._stop = threading.Event()
        os.makedirs(directory, exist_ok=True)
        #: Segment names carry pid + a per-boot stamp (wall millis +
        #: a per-process writer counter): one writer per file, so
        #: concurrent processes, incarnations after a SIGKILL restart,
        #: and same-millisecond writers in one process never
        #: interleave within a segment.
        self._stamp = (f"{os.getpid()}-"
                       f"{int(time.time() * 1000) & 0xFFFFFF:06x}"
                       f"{next(_WRITER_SEQ) & 0xFF:02x}")
        self._thread = threading.Thread(
            target=self._run, name="gol-usage-ledger", daemon=True,
        )
        self._thread.start()

    def _segment_path(self) -> str:
        return os.path.join(
            self.directory, f"usage-{self._stamp}-{self._seq:04d}.jsonl"
        )

    def _rollover_if_needed(self) -> None:
        if self._file is None:
            self._file = open(self._segment_path(), "ab")
            return
        try:
            if self._file.tell() < self.max_segment_bytes:
                return
            self._file.close()
        except (OSError, ValueError):
            pass
        self._seq += 1
        self._file = open(self._segment_path(), "ab")

    def flush_once(self) -> int:
        """Drain pending deltas and append one record per principal;
        returns records written. Failures are swallowed — the ledger
        is best-effort forensics, never a serving-path hazard."""
        pending = self._drain()
        if not pending:
            return 0
        n = 0
        try:
            self._rollover_if_needed()
            for principal in sorted(pending):
                res = {k: v for k, v in pending[principal].items() if v}
                if not res:
                    continue
                self._rec_seq += 1
                line = json.dumps({
                    "ts": round(time.time(), 3),
                    "pid": os.getpid(),
                    "seq": self._rec_seq,
                    "principal": principal,
                    "res": res,
                }, sort_keys=True)
                self._file.write(line.encode() + b"\n")
                n += 1
            self._file.flush()
        except (OSError, ValueError):
            pass
        return n

    def _run(self) -> None:
        while not self._stop.wait(self.flush_secs):
            self.flush_once()
        self.flush_once()  # final drain on close

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        if self._file is not None:
            with contextlib.suppress(OSError, ValueError):
                self._file.close()
            self._file = None


def read_ledger(directory: str) -> Dict[str, Dict[str, float]]:
    """Aggregate every `usage-*.jsonl` segment under `directory` into
    per-principal resource totals. Tolerant by contract: unreadable
    files, torn tails, half-written or interleaved garbage lines are
    skipped — the totals are the sum of every INTACT record, and this
    never raises on hostile trees (fuzzed by tests/test_accounting.py).
    """
    totals: Dict[str, Dict[str, float]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return totals
    for name in names:
        if not (name.startswith("usage-") and name.endswith(".jsonl")):
            continue
        try:
            with open(os.path.join(directory, name), "rb") as f:
                blob = f.read()
        except OSError:
            continue
        for raw in blob.split(b"\n"):
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
                principal = rec["principal"]
                res = rec["res"]
                items = [(str(k), float(v)) for k, v in res.items()]
            except (ValueError, KeyError, TypeError, AttributeError):
                continue  # torn tail / corrupt record: skip, never raise
            if not isinstance(principal, str):
                continue
            t = totals.setdefault(principal, {})
            for k, v in items:
                t[k] = t.get(k, 0.0) + v
    return totals


# --- the meter -----------------------------------------------------------


class Meter:
    """Process-global usage meter: `charge` accumulates per-principal
    resource totals (live TopK series + pending ledger deltas) under
    one lock; `charge_bucket` splits a shared bucket dispatch across
    its tenants conservation-checked. All methods are cheap, host-side
    and callable from any thread; the ledger thread is the only file
    writer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: Dict[str, Dict[str, float]] = {}
        self._pending: Dict[str, Dict[str, float]] = {}
        self._grand: Dict[str, float] = dict.fromkeys(RESOURCES, 0.0)
        self._prices: Dict[str, Dict[str, float]] = {}
        self._budgets: Dict[str, Optional[float]] = {
            "flops": None, "bytes": None,
        }
        self._over: set = set()
        self._ledger: Optional[LedgerWriter] = None
        self._gauges = {
            res: _reg.REGISTRY.topk_gauge(
                f"gol_tpu_usage_{res}", _HELP[res],
                label="principal", cap=USAGE_TOPK,
            ) for res in RESOURCES
        }
        self._over_gauge = _reg.gauge(
            "gol_tpu_usage_over_budget",
            "Principals currently past a soft usage budget (never "
            "enforced; alert-rule food)",
        )
        _reg.REGISTRY.track_entity_series(
            "principal", *(f"gol_tpu_usage_{r}" for r in RESOURCES),
            topk=True,
        )

    # -- charging --

    def charge(self, principal: str, **amounts: float) -> None:
        """Attribute resources to one principal. Unknown keyword keys
        are rejected loudly (the vocabulary is the contract every
        surface shares)."""
        updated = {}
        with self._lock:
            tot = self._totals.get(principal)
            if tot is None:
                tot = self._totals[principal] = dict.fromkeys(
                    RESOURCES, 0.0)
            pend = self._pending.setdefault(principal, {})
            for res, v in amounts.items():
                if res not in tot:
                    raise ValueError(f"unknown resource {res!r}")
                v = float(v)
                if not v:
                    continue
                tot[res] += v
                pend[res] = pend.get(res, 0.0) + v
                self._grand[res] += v
                updated[res] = tot[res]
            over_n = self._update_budget_locked(principal, tot)
        for res, v in updated.items():
            self._gauges[res].set_child(principal, v)
        if over_n is not None:
            self._over_gauge.set(over_n)

    def _update_budget_locked(self, principal: str,
                              tot: Dict[str, float]) -> Optional[int]:
        bf, bb = self._budgets["flops"], self._budgets["bytes"]
        over = ((bf is not None and tot["flops"] > bf)
                or (bb is not None and tot["wire_bytes"] > bb))
        if over == (principal in self._over):
            return None
        if over:
            self._over.add(principal)
        else:
            self._over.discard(principal)
        return len(self._over)

    def charge_bucket(self, principals: Sequence[str],
                      weights: Optional[Sequence[float]], *,
                      seconds: float = 0.0, flops: float = 0.0,
                      turns: int = 0, what: str = "bucket") -> None:
        """Split ONE measured shared dispatch (S tenants, one bucket
        program) across its tenants: activity-weighted when `weights`
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

    # -- prices (the cost model) --

    def set_price(self, program: str, cost: dict) -> None:
        """Record one program's `cost_of` result as the per-call price
        used for modeled-FLOPs attribution (`publish_cost` feeds this;
        bucket programs key as `bucket.step:<WxH/rule>`)."""
        if not cost or "error" in cost:
            return
        with self._lock:
            self._prices[program] = {
                "flops": float(cost.get("flops", 0.0)),
                "bytes_accessed": float(cost.get("bytes_accessed", 0.0)),
            }

    def price_flops(self, program: str) -> float:
        """Modeled FLOPs per call of `program`; a bucket-specific key
        falls back to the generic program family, then 0 (no cost
        probes = no modeled FLOPs, never a guess)."""
        with self._lock:
            p = self._prices.get(program)
            if p is None and ":" in program:
                p = self._prices.get(program.split(":", 1)[0])
        return p["flops"] if p else 0.0

    # -- budgets --

    def set_budgets(self, flops: Optional[float] = None,
                    bytes: Optional[float] = None) -> None:
        with self._lock:
            self._budgets["flops"] = (
                float(flops) if flops is not None else None)
            self._budgets["bytes"] = (
                float(bytes) if bytes is not None else None)

    # -- lifecycle --

    def forget(self, principal: str) -> None:
        """Drop one principal's live view (session destroyed / peer
        detached): evicts its TopK children through the registry's
        shared helper and its totals row from `/usage`. Pending
        ledger deltas survive — the final flush still persists them;
        history stays in the ledger."""
        with self._lock:
            self._totals.pop(principal, None)
            self._over.discard(principal)
            over_n = len(self._over)
        _reg.REGISTRY.evict_entity("principal", principal)
        self._over_gauge.set(over_n)

    def totals(self, principal: str) -> Dict[str, float]:
        """One principal's live totals (empty once forgotten)."""
        with self._lock:
            return dict(self._totals.get(principal, {}))

    def configure_ledger(self, directory: str, *,
                         max_segment_bytes: int = 4 << 20,
                         flush_secs: float = 1.0) -> None:
        """Arm the crash-safe ledger (CLI serve paths: <out>/usage).
        Idempotent per directory; replaces a previous writer."""
        if self._ledger is not None:
            self._ledger.close()
        self._ledger = LedgerWriter(
            directory, self._drain_pending,
            max_segment_bytes=max_segment_bytes, flush_secs=flush_secs,
        )

    def _drain_pending(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            pending, self._pending = self._pending, {}
        return pending

    def close(self) -> None:
        if self._ledger is not None:
            self._ledger.close()
            self._ledger = None

    # -- exposition --

    def payload(self) -> dict:
        """The `/usage` JSON: per-principal totals (+ over_budget
        flag), process grand totals (include forgotten principals —
        the conservation acceptance compares these against the
        process-level metrics), budgets, pid."""
        with self._lock:
            principals = {p: dict(t) for p, t in self._totals.items()}
            grand = dict(self._grand)
            budgets = dict(self._budgets)
            over = set(self._over)
        for p, t in principals.items():
            t["over_budget"] = p in over
        return {
            "enabled": True,
            "pid": os.getpid(),
            "principals": principals,
            "totals": grand,
            "budgets": budgets,
            "over_budget": sorted(over),
        }


# --- module plane --------------------------------------------------------

#: One attribute read gates every call site: `meter()` answers None
#: when the plane is off (`GOL_TPU_ACCOUNTING=0`) — zero wrappers.
_METER: Optional[Meter] = (
    Meter() if os.environ.get("GOL_TPU_ACCOUNTING", "1") != "0" else None
)


def enabled() -> bool:
    return _METER is not None


def meter() -> Optional[Meter]:
    return _METER


def set_enabled(on: bool = True) -> None:
    """Programmatic switch (the bench's meter-on/off A/B): enabling
    creates a fresh meter; disabling closes the ledger and drops it —
    call sites see None and skip all metering."""
    global _METER
    if on and _METER is None:
        _METER = Meter()
    elif not on and _METER is not None:
        _METER.close()
        _METER = None


def charge(principal: str, **amounts: float) -> None:
    m = _METER
    if m is not None:
        m.charge(principal, **amounts)


def configure(out_dir: Optional[str] = None,
              budget_flops: Optional[float] = None,
              budget_bytes: Optional[float] = None) -> None:
    """CLI arming: ledger under `<out_dir>/usage`, soft budgets. A
    no-op when the plane is disabled (zero ledger I/O). The ledger's
    final drain is registered atexit, so a graceful shutdown persists
    the last partial flush window (a SIGKILL loses at most it — the
    crash-safety acceptance)."""
    m = _METER
    if m is None:
        return
    if budget_flops is not None or budget_bytes is not None:
        m.set_budgets(flops=budget_flops, bytes=budget_bytes)
    if out_dir is not None:
        m.configure_ledger(os.path.join(out_dir, "usage"))
        import atexit

        atexit.register(ledger_close)


def ledger_close() -> None:
    m = _METER
    if m is not None:
        m.close()


def payload() -> dict:
    """The `/usage` endpoint body; an explicit disabled shape when the
    plane is off (a scraper must tell 'disabled' from 'idle')."""
    m = _METER
    if m is None:
        return {"enabled": False}
    return m.payload()
