"""Control plane — the reconciling fleet controller (docs/CONTROL.md).

The freshness plane turns staleness into SLOs and alerts and the
accounting plane attributes every device-second, but neither ACTS
when a relay dies or an engine saturates. This package (the port of
`gol_tpu.control`, byte-compatible manifests) closes the loop with the same stdlib-sidecar idiom the obs
planes use: a controller process (`python -m gol_tpu_torch --control
SPEC.json`) owns fleet topology as a declarative desired-state spec
and runs a level-triggered reconcile loop over observed state — the
`gol_tpu_torch.obs.scrape` fleet join it shares with the console.

Verbs (docs/CONTROL.md "Reconcile rules"):

- **heal** — a dead or turn-age-alerting relay is replaced by a fresh
  `--relay` spawn; its orphaned downstream subtree is re-pointed
  (`RelayNode.repoint`) at the replacement. Leaf clients ride the
  client's reconnect/backoff + BoardSync resume, so healing is bit-exact
  by construction.
- **scale** — observer-count thresholds grow/shrink the relay tree;
  retire is drain-then-kill (children re-pointed first, the retiree
  killed only once its peer count is OBSERVED at zero), never
  kill-then-hope.
- **migrate** — park on engine A, adopt on engine B, destroy the
  parked record on A, flip the serving endpoint: a two-phase record
  in the crash-atomic controller manifest makes a controller SIGKILL
  mid-migration resume or abort, never duplicate (every leg verb is
  idempotent under retry, state-based).
- **roll** — drain/restart managed engines one at a time behind
  coalesced BoardSync, `--resume latest` covering the gap.

Every action is seeded-jitter backed-off, budget-capped per reconcile
round, and refused outright when the observed state backing it is
stale (`FleetSpec.stale_secs`).
"""

from gol_tpu_torch.control.spec import FleetSpec, SpecError, load_spec
from gol_tpu_torch.control.manifest import ControllerManifest
from gol_tpu_torch.control.controller import Controller, repoint_relay

__all__ = [
    "Controller",
    "ControllerManifest",
    "FleetSpec",
    "SpecError",
    "load_spec",
    "repoint_relay",
]
