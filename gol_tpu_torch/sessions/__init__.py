"""gol_tpu_torch.sessions — the multi-tenant session layer: S boards, one
launch. The port of `gol_tpu.sessions`, with the same verbs, files, wire
and metric names:

- **buckets** — sessions with the same (height, width, rule) stack
  into one `(S, H/32, W)` packed device tensor stepped together
  (`parallel.stepper.make_batch_stepper`): on the card a packable
  bucket's k-turn chunk is ONE launch of kernel A's batched entry,
  whatever its occupancy, so S tenants share one launch's fixed cost;
- **padding / slot reuse** — free slots are zero boards stepped along
  with the tenants; create/destroy inside a warm bucket only write a
  slot, so joins and leaves allocate no new stack (pinned by the
  census test);
- **per-session diff streams** — watched buckets ride the compact
  encoding per session; each session's decoded flip rows feed the
  wire encodings unchanged;
- **lifecycle verbs** — create / destroy / checkpoint / list / park /
  adopt, exposed over the wire by `distributed.server.SessionServer`
  (CLI: `--serve --sessions`) and driven by
  `distributed.client.SessionControl`; watching peers attach with
  `Controller(session="id")`;
- **checkpoint/resume** — per-session PGM snapshots under
  `out/sessions/<id>/` with a `session.json` sidecar and the manifest;
  `--resume latest` restores every session;
- **bounded observability** — per-session metric labels
  (`gol_tpu_session_turns_total{session=...}`) are EVICTED at destroy,
  so the registry cannot grow without bound under churn.

Model: docs/SESSIONS.md.
"""

from gol_tpu_torch.sessions.manager import (
    Session,
    SessionError,
    SessionManager,
    Sink,
    valid_session_id,
)
from gol_tpu_torch.sessions.engine import SessionEngine

__all__ = [
    "Session",
    "SessionEngine",
    "SessionError",
    "SessionManager",
    "Sink",
    "valid_session_id",
]
