"""Command-line entry — the analog of the reference's process entry
(ref: main.go:13-68), for the PyTorch / CUDA port.

The reference flags with the reference spelling (`-t 8 -w 512 -h 512
-turns N -noVis`, ref: main.go:17-46), plus gol_tpu's
extensions — `--rule`, `--backend`, `--chunk`, `--images`, `--out`,
`--tick`, `--autosave-turns`, `--autosave-secs`, `--tile`, `--mesh`,
`--partition-rule`, `--cycle-detect`,
`--resume SNAPSHOT.pgm|latest`, `--check-invariants` and
`--profile-dir` (a `torch.profiler` capture of the whole run, written
as a Chrome trace) — and `--platform {gpu,cpu}` (gpu by default;
without a card the run fails instead of moving to the CPU).

Without `-noVis` the event stream drives the visualiser loop
(`gol_tpu_torch.visual`) on per-turn `FlipBatch` arrays — gray levels
for a Generations rule — on a real window when the native core finds
libSDL2 and a display, otherwise on a headless shadow board that still
prints non-empty events the way the SDL loop does (ref:
sdl/loop.go:44-47). With `-noVis` the stream is drained silently until
`FinalTurnComplete` (ref: main.go:58-67).

Keyboard verbs p/s/q/k are forwarded from the window when visualising
(ref: sdl/loop.go:18-27) or from a raw-mode stdin reader when stdin is
a terminal.

Serving, as in gol_tpu: `--serve [HOST:]PORT` runs the engine headless
on the card behind an `EngineServer`; `--connect HOST:PORT` attaches a
controller (visualised, or printing events with `-noVis`), read-only
with `--observe`; `--secret` / `$GOL_SECRET`, the liveness, overload and
batching knobs and `--no-reconnect` / `--reconnect-secs` keep gol_tpu's
names and defaults. `--metrics-port` serves `/metrics`, `/healthz`,
`/vars`, `/trace`, `/flightrecorder`, `/alerts` and `/usage` for every
mode; `--alert-rules FILE` arms the turn-age / SLO evaluator inside
it and `--remote-write HOST:PORT` pushes its registry to a collector.
Engines and serving tiers keep a usage ledger under <out>/usage
(`GOL_TPU_ACCOUNTING=0` turns it off) and publish the port's cost
price (`obs.device.cost_of`, its own operation count, not XLA's);
`--session-budget-flops` / `--session-budget-bytes` set the soft
per-tenant budgets of `--serve --sessions`.

Sessions and the replay plane, as in gol_tpu: `--serve --sessions`
serves many named boards (`SessionServer`; same-shape boards share one
bucket, a packable bucket's chunk one launch of kernel A), with
`--bucket-capacity`, `--park-idle-secs`, `--max-sessions` and `--resume
latest`; `--record` tapes every session under out/sessions/<id>/replay/
(`--keyframe-turns`, `--record-max-bytes`); `--connect --session ID`
watches or drives one session; `--replay LOG-DIR --serve PORT` serves
recordings with no engine (`--replay-rate`).

The broadcast tier, the history plane and the fleet controller, as in
gol_tpu: `--relay HOST:PORT --serve PORT` re-serves an upstream's
stream to any number of observers, forwarding its frame bytes with no
re-encode (`--ws-port` adds the WebSocket gateway); `--collector PORT`
stores remote-written telemetry under <out>/tsdb and answers `/query`
and `/history`; `--control SPEC.json` reconciles a fleet toward its
spec, spawning `python -m gol_tpu_torch --relay` processes.

Which processes need the card: every mode that steps or serves boards —
local runs, `--serve` (with or without `--sessions`), `--replay` and
`--relay` — runs on the card unless `--platform cpu`, and fails without
one instead of moving to the CPU. `--connect`, `--collector` and
`--control` step nothing, on any device, and need no card (nor do
`python -m gol_tpu_torch.obs.console`, `.obs.report` and
`.obs.canary`). gol_tpu's multi-host flags are absent.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import sys
import threading
from typing import Optional

from gol_tpu_torch.params import BACKENDS, Params

#: --platform names -> torch device types.
PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gol_tpu_torch",
        description="Game of Life on one NVIDIA GPU (PyTorch / CUDA)",
        allow_abbrev=False,
        add_help=False,  # -h is image height (ref: main.go:29-33); use --help
    )
    ap.add_argument("-t", type=int, default=8, metavar="N",
                    help="number of worker shards (default 8), capped "
                         "by the CUDA cards the run has: one card runs "
                         "one shard, results are identical")
    ap.add_argument("-w", type=int, default=512, metavar="W",
                    help="image width (default 512)")
    ap.add_argument("-h", type=int, default=512, metavar="H",
                    help="image height (default 512)")
    ap.add_argument("-turns", type=int, default=10000000000,
                    help="turns to process (default 10000000000)")
    ap.add_argument("-noVis", action="store_true", dest="novis",
                    help="disable visualisation; drain events silently")
    ap.add_argument("--help", action="help",
                    help="show this help message and exit")
    ap.add_argument("--rule", default="B3/S23",
                    help="cellular-automaton rule: life-like B/S notation "
                         "(B3/S23) or Generations B/S/C notation (B2/S/C3)")
    ap.add_argument("--backend", default="auto", choices=BACKENDS,
                    help="kernel family (default auto: the CUDA packed "
                         "kernels on the GPU when the grid packs; "
                         "cuda-dense is the dense CUDA kernel)")
    ap.add_argument("--chunk", type=int, default=0, metavar="K",
                    help="turns fused per device dispatch; 0 (default) "
                         "auto-calibrates to ~0.1s per dispatch")
    ap.add_argument("--images", default="images", metavar="DIR",
                    help="input image directory (default images/)")
    ap.add_argument("--out", default="out", metavar="DIR",
                    help="output image directory (default out/)")
    ap.add_argument("--tick", type=float, default=2.0, metavar="SEC",
                    help="AliveCellsCount cadence in seconds (default 2)")
    ap.add_argument("--autosave-turns", type=int, default=0, metavar="N",
                    help="auto-checkpoint the board to out/ every N "
                         "completed turns (0 = off)")
    ap.add_argument("--autosave-secs", type=float, default=0.0,
                    metavar="SEC",
                    help="auto-checkpoint the board to out/ every SEC "
                         "seconds (0 = off)")
    ap.add_argument("--mesh", default=None, metavar="ROWSxCOLS",
                    help="force a 2-D device mesh (e.g. 2x4): the "
                         "packed board shards over word-rows AND word-"
                         "columns with mesh-generic halo exchange "
                         "(parallel/mesh2d.py); per-host halo bytes "
                         "stay flat as the column count grows. "
                         "Packed-only; exclusive with --tile")
    ap.add_argument("--partition-rule", default=None, dest="partition_rule",
                    metavar="RULES",
                    help="partition-table overrides, prepended to the "
                         "backend family's defaults (first match wins): "
                         "'PATTERN=AXES;...' with AXES a comma list of "
                         "rows/cols/* or '-' for replicated, plus "
                         "'layout=NAME' to select a registered kernel "
                         "layout (e.g. layout=lane-coupled). See "
                         "gol_tpu_torch/parallel/partition.py")
    ap.add_argument("--tile", type=int, default=0, metavar="T",
                    help="activity-driven tiled stepping: split the "
                         "board into T x T macro-tiles (T a multiple "
                         "of 32 dividing both axes) and dispatch only "
                         "tiles a change's light cone touched; the "
                         "board stays host-resident, so size stops "
                         "being a device-memory bound (0 = off; -t does "
                         "not apply — the dispatch set is the "
                         "parallelism; see gol_tpu_torch/parallel/"
                         "tiled.py)")
    ap.add_argument("--cycle-detect", action="store_true",
                    dest="cycle_detect",
                    help="exact cycle fast-forward: once the board "
                         "provably revisits a state, collapse the "
                         "remaining turns modulo the period (bit-exact; "
                         "makes the 10^10-turn default run finish). "
                         "Only active on headless fused runs: pass "
                         "-noVis")
    ap.add_argument("--profile-dir", default=None, dest="profile_dir",
                    metavar="DIR",
                    help="capture a torch.profiler trace of the whole run "
                         "(host operators and, on the GPU, the card's "
                         "kernels and copies) and write it to "
                         "DIR/trace-<pid>.json as a Chrome trace at exit "
                         "(opt-in: profiling taxes the dispatch path)")
    ap.add_argument("--check-invariants", action="store_true",
                    dest="check_invariants",
                    help="assert protocol invariants at runtime "
                         "(dispatch linearity of the stepper — "
                         "gol_tpu_torch.analysis.invariants); cheap "
                         "host-side identity checks, also switchable "
                         "via GOL_TPU_CHECK_INVARIANTS=1")
    ap.add_argument("--resume", default=None, metavar="SNAPSHOT.pgm",
                    help="resume from an out/ snapshot, continuing at "
                         "the turn encoded in its filename; 'latest' "
                         "picks the newest matching snapshot in --out")
    ap.add_argument("--platform", default="gpu", choices=sorted(PLATFORMS),
                    help="device to run on (default gpu)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    dest="metrics_port", metavar="PORT",
                    help="serve live observability on "
                         "127.0.0.1:PORT — /metrics (Prometheus text), "
                         "/vars (JSON snapshot), /healthz (liveness); "
                         "0 picks an ephemeral port (printed). Works "
                         "for every mode")
    ap.add_argument("--metrics-host", default="127.0.0.1", metavar="HOST",
                    help="bind address for --metrics-port (default "
                         "loopback; non-loopback exposure should sit "
                         "behind the same controls as --serve)")
    ap.add_argument("--alert-rules", default=None, dest="alert_rules",
                    metavar="FILE",
                    help="with --metrics-port: SLO alert rules evaluated "
                         "inside the sidecar (gol_tpu_torch.obs."
                         "freshness), one per line, e.g. 'age: "
                         "p99(gol_tpu_server_turn_age_seconds) > 2 for "
                         "30s'; state served at /alerts, transitions "
                         "counted and noted in the flight recorder; a "
                         "parse error is a STARTUP error, never a "
                         "runtime crash")
    ap.add_argument("--remote-write", default=None, dest="remote_write",
                    metavar="HOST:PORT",
                    help="with --metrics-port: push this sidecar's "
                         "registry (plus alert transitions and span "
                         "digests) to the history-plane collector at "
                         "HOST:PORT; a slow or dead collector SHEDS "
                         "samples, never wedges this process")
    ap.add_argument("--collector", default=None, metavar="[HOST:]PORT",
                    help="run as the HISTORY-PLANE COLLECTOR "
                         "(gol_tpu_torch.obs.collector): ingest "
                         "--remote-write telemetry into crash-atomic "
                         "segment logs under <out>/tsdb and serve range "
                         "queries (/query, /history) from its own "
                         "--metrics-port sidecar; --resume latest "
                         "replays the store; --alert-rules evaluate "
                         "FLEET-WIDE over collected series. Needs no "
                         "card")
    ap.add_argument("--session-budget-flops", type=float, default=None,
                    dest="session_budget_flops", metavar="FLOPS",
                    help="with --serve --sessions: soft per-tenant "
                         "modelled-operations budget (accounting plane) "
                         "— over-budget tenants raise "
                         "gol_tpu_usage_over_budget and show BUDG=OVER "
                         "in obs.console; deliberately never enforced")
    ap.add_argument("--session-budget-bytes", type=float, default=None,
                    dest="session_budget_bytes", metavar="BYTES",
                    help="with --serve --sessions: soft per-tenant "
                         "wire-bytes budget — same advisory semantics "
                         "as --session-budget-flops")
    # Serving (gol_tpu_torch.distributed).
    ap.add_argument("--serve", default=None, metavar="[HOST:]PORT",
                    help="run as a headless engine server on this address")
    ap.add_argument("--sessions", action="store_true",
                    help="with --serve: multi-tenant session mode "
                         "(gol_tpu_torch.sessions) — no singleton board; "
                         "peers create/destroy/checkpoint named "
                         "sessions over the wire and attach with "
                         "hello.session; same-shape sessions share one "
                         "bucket dispatch. -w/-h set the geometry "
                         "CAP for wire-driven creates' sanity bound "
                         "only; see docs/SESSIONS.md")
    ap.add_argument("--bucket-capacity", type=int, default=16,
                    dest="bucket_capacity", metavar="S",
                    help="with --sessions: initial slots per "
                         "shape/rule bucket (a full bucket doubles; "
                         "churn within capacity never reallocates; "
                         "default 16)")
    ap.add_argument("--park-idle-secs", type=float, default=None,
                    dest="park_idle_secs", metavar="SEC",
                    help="with --serve --sessions: HIBERNATE sessions "
                         "idle (no watcher, no driver) this long — "
                         "checkpoint via the session manifest, free "
                         "the device slot, rehydrate bit-exactly on "
                         "the next attach; 0 parks at the first idle "
                         "sweep (default: never park; see "
                         "docs/SESSIONS.md 'Hibernation')")
    ap.add_argument("--max-sessions", type=int, default=None,
                    dest="max_sessions", metavar="N",
                    help="with --serve --sessions: creates past N "
                         "live sessions are rejected 'max-sessions' "
                         "with a retry_after hint (default: "
                         "unbounded)")
    ap.add_argument("--record", action="store_true",
                    help="with --serve --sessions: tape every "
                         "session's encoded wire stream (FBATCH "
                         "frames + periodic BoardSync keyframes, "
                         "verbatim bytes) into an append-only segment "
                         "log under out/sessions/<id>/replay/ — the "
                         "seekable recording the seek verb and "
                         "--replay serve from (docs/REPLAY.md)")
    ap.add_argument("--keyframe-turns", type=int, default=None,
                    dest="keyframe_turns", metavar="N",
                    help="with --record: turns between BoardSync "
                         "keyframes = seek granularity and per-attach "
                         "catch-up cost (default 256)")
    ap.add_argument("--record-max-bytes", type=int, default=None,
                    dest="record_max_bytes", metavar="BYTES",
                    help="with --record: per-session recording size "
                         "bound — oldest segments are evicted past it "
                         "(default: unbounded)")
    ap.add_argument("--replay", default=None, metavar="LOG-DIR",
                    dest="replay",
                    help="run as a STATIC REPLAY SERVER "
                         "(gol_tpu_torch.replay): serve the recordings "
                         "under LOG-DIR (a --record run's "
                         "out/sessions tree, one session's dir, or a "
                         "bare replay/ dir) on --serve [HOST:]PORT to "
                         "any number of observers with ZERO engine "
                         "dispatches — recorded bytes forwarded "
                         "verbatim, paced by the recorded timestamps "
                         "or --replay-rate (docs/REPLAY.md)")
    ap.add_argument("--replay-rate", type=float, default=None,
                    dest="replay_rate", metavar="TURNS/S",
                    help="with --replay: playback pacing in turns/s "
                         "(0 = as fast as the observers drain; "
                         "default: the recorded wall-clock timing)")
    ap.add_argument("--relay", default=None, metavar="HOST:PORT",
                    help="run as a RELAY NODE (gol_tpu_torch.relay): "
                         "attach to the upstream server/relay at "
                         "HOST:PORT as one batching binary client and "
                         "re-serve its stream on --serve [HOST:]PORT to "
                         "any number of observers, forwarding identical "
                         "frame bytes with zero re-encode; reconnect and "
                         "clock sync compose per hop. Steps no board; "
                         "--platform gpu still needs the card")
    ap.add_argument("--ws-port", type=int, default=None,
                    dest="ws_port", metavar="PORT",
                    help="with --relay: also serve browser observers "
                         "over RFC-6455 WebSocket on this port — the "
                         "identical binary frames inside WS binary "
                         "messages (subprotocol gol-tpu-wire)")
    ap.add_argument("--writer-pool-threads", type=int, default=2,
                    dest="writer_pool_threads", metavar="N",
                    help="with --serve/--relay: selector event-loop "
                         "threads draining every peer's outbound "
                         "frames (default 2; 0 = one writer thread per "
                         "connection)")
    ap.add_argument("--control", default=None, metavar="SPEC.json",
                    help="run as the FLEET CONTROLLER "
                         "(gol_tpu_torch.control): own the declarative "
                         "topology in SPEC.json and reconcile observed "
                         "state toward it — heal dead relays (spawn + "
                         "re-point the orphaned subtree), grow/shrink "
                         "the relay tree, migrate sessions between "
                         "engines, roll managed engines behind --resume "
                         "latest. Needs no card")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="run as a controller attached to a remote engine")
    ap.add_argument("--session", default=None, metavar="ID",
                    help="with --connect: watch/drive the named session "
                         "on a --serve --sessions server instead of the "
                         "singleton board (docs/SESSIONS.md)")
    ap.add_argument("--observe", action="store_true",
                    help="with --connect: attach read-only (board sync "
                         "+ events; steering verbs rejected) — any "
                         "number of observers may watch alongside the "
                         "one driving controller")
    ap.add_argument("--secret", default=os.environ.get("GOL_SECRET"),
                    metavar="TOKEN",
                    help="shared secret for --serve/--connect: a serving "
                         "engine rejects attaches whose hello carries a "
                         "different token (defaults to $GOL_SECRET; unset "
                         "means unauthenticated)")
    ap.add_argument("--hb-secs", type=float, default=2.0, metavar="SEC",
                    dest="hb_secs",
                    help="with --serve: heartbeat cadence into idle "
                         "peer streams; silent heartbeat-capable peers "
                         "are evicted after --evict-secs (0 disables "
                         "the liveness plane; default 2)")
    ap.add_argument("--evict-secs", type=float, default=None,
                    metavar="SEC", dest="evict_secs",
                    help="with --serve: idle-eviction deadline for "
                         "peers that stop answering heartbeats "
                         "(default 3x --hb-secs)")
    ap.add_argument("--max-peers", type=int, default=None,
                    dest="max_peers", metavar="N",
                    help="with --serve: admission budget — attaches "
                         "past N live peers are rejected "
                         "'at-capacity' with a retry_after hint "
                         "(default: unbounded)")
    ap.add_argument("--high-water", type=int, default=None,
                    dest="high_water", metavar="FRAMES",
                    help="with --serve: writer-queue depth at which a "
                         "slow peer is DEGRADED (stream frames shed, "
                         "coalesced BoardSync on drain) instead of "
                         "evicted (default 256)")
    ap.add_argument("--drain-secs", type=float, default=None,
                    dest="drain_secs", metavar="SEC",
                    help="with --serve: how long a degraded peer may "
                         "stay wedged before eviction — peers that "
                         "drain inside the deadline are resynced and "
                         "keep watching (default 10)")
    ap.add_argument("--batch-turns", type=int, default=None,
                    dest="batch_turns", metavar="K",
                    help="with --serve: ceiling on a peer's hello "
                         "\"batch\" max-k (turns per flip-batch wire "
                         "frame; default 1024, 0 disables batching). "
                         "With --connect: request k-turn batch frames "
                         "— the watched-path throughput mode")
    ap.add_argument("--no-reconnect", action="store_true",
                    dest="no_reconnect",
                    help="with --connect: die on the first link "
                         "failure instead of re-dialing with backoff "
                         "and resuming via board sync")
    ap.add_argument("--reconnect-secs", type=float, default=60.0,
                    metavar="SEC", dest="reconnect_secs",
                    help="with --connect: total re-dial window after a "
                         "link failure — long enough to ride out a "
                         "server crash-restart with --resume "
                         "(default 60)")
    return ap


def _stdin_keys(keypresses: queue.Queue, stop: threading.Event) -> None:
    """Stdin reader forwarding the p/s/q/k verbs."""
    while not stop.is_set():
        ch = sys.stdin.read(1)
        if ch in ("p", "s", "q", "k"):
            keypresses.put(ch)
        if ch in ("q", "k") or not ch:
            return


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.check_invariants:
        # Env-var form on purpose: spawned processes inherit the opt-in
        # with the environment.
        from gol_tpu_torch.analysis.invariants import enable

        enable()

    from gol_tpu_torch.models.rules import GenRule, get_rule
    from gol_tpu_torch.obs import device, flight, tracing

    # Observability bootstrap, as in gol_tpu: label this process for
    # merged timelines, arm the flight recorder's dump directory, and
    # dump the black box when SIGTERM lands (the handler then raises
    # KeyboardInterrupt, so every mode's graceful shutdown still runs).
    tracing.set_process_label(
        "control" if args.control is not None
        else "collector" if args.collector is not None
        else "relay" if args.relay is not None
        else "replay" if args.replay is not None
        else "serve" if args.serve is not None
        else "connect" if args.connect is not None else "local"
    )
    flight.configure(args.out)
    flight.install_sigterm_handler()
    # Every real run publishes its programs' price (the port's own
    # operation count; library embedders opt in).
    device.enable_cost_probes()
    if args.profile_dir:
        if device.start_profile(args.profile_dir,
                                cuda=args.platform == "gpu"):
            print(f"torch profiler capturing to {args.profile_dir}")
        else:
            print("warning: torch profiler capture could not start "
                  f"in {args.profile_dir}", file=sys.stderr)

    # Banner (ref: main.go:48-50).
    print("Threads:", args.t)
    print("Width:", args.w)
    print("Height:", args.h)

    try:
        rule = get_rule(args.rule)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    # Multi-state rules visualise as gray levels.
    vis_levels = isinstance(rule, GenRule)

    try:
        params = Params(
            turns=args.turns,
            threads=args.t,
            image_width=args.w,
            image_height=args.h,
            rule=rule,
            backend=args.backend,
            chunk=args.chunk,
            tick_seconds=args.tick,
            image_dir=args.images,
            out_dir=args.out,
            autosave_turns=args.autosave_turns,
            autosave_seconds=args.autosave_secs,
            cycle_detect=args.cycle_detect,
            tile=args.tile,
            mesh=args.mesh,
            partition_rules=args.partition_rule,
        )
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"error: {e}") from None

    # The mode guards, in gol_tpu's order and with its messages.
    # Checkpoint restart (local or --serve): boot from a snapshot,
    # continuing at the turn in its filename. A controller holds no
    # board state, so --connect cannot resume.
    resume_path = args.resume
    if resume_path is not None and args.connect is not None:
        raise SystemExit(
            "error: --resume applies to the engine (local or --serve), "
            "not to a --connect controller"
        )
    if args.session is not None and args.connect is None \
            and args.relay is None:
        raise SystemExit("error: --session requires --connect "
                         "(or --relay, to fan a named session out)")
    if args.relay is not None and args.sessions:
        raise SystemExit(
            "error: --relay attaches to a session server with "
            "--session ID; --sessions starts one"
        )
    if args.ws_port is not None and args.relay is None:
        # A silently ignored WS port would leave an operator believing
        # browsers are served.
        raise SystemExit(
            "error: --ws-port requires --relay (a root engine serves "
            "browsers through a co-located relay: start one with "
            "--relay HOST:PORT --serve PORT --ws-port N)"
        )
    if args.collector is not None:
        # The history-plane collector is its own process mode: it stores
        # telemetry ABOUT serving processes rather than being one, and
        # --resume latest replays its own segment logs.
        if (args.serve is not None or args.sessions
                or args.relay is not None or args.connect is not None
                or args.replay is not None or args.control is not None):
            raise SystemExit(
                "error: --collector is its own mode — it cannot "
                "combine with --serve/--sessions/--relay/--connect/"
                "--replay/--control"
            )
        if resume_path not in (None, "latest"):
            raise SystemExit(
                "error: a collector resumes its own segment logs "
                "under <out>/tsdb; use --resume latest (or none)"
            )
        _arm_accounting(args)
        return _collector(args, resume_path == "latest")
    if args.remote_write is not None and args.metrics_port is None:
        # A silently ignored remote-write target would leave an operator
        # believing telemetry is being collected.
        raise SystemExit(
            "error: --remote-write requires --metrics-port (the "
            "writer rides the metrics sidecar, and the sidecar "
            "address is its source label)"
        )
    if args.control is not None:
        # The fleet controller is its own process mode: it OWNS serving
        # processes rather than being one, and it applies --resume
        # latest to the engines it rolls, never to itself.
        if (args.serve is not None or args.sessions
                or args.relay is not None or args.connect is not None
                or args.replay is not None):
            raise SystemExit(
                "error: --control is its own mode — it cannot combine "
                "with --serve/--sessions/--relay/--connect/--replay"
            )
        if resume_path is not None:
            raise SystemExit(
                "error: --resume applies to an engine; the controller "
                "itself holds no board state (it rolls engines with "
                "--resume latest on their behalf)"
            )
        _arm_accounting(args)
        return _control_plane(args)
    if args.park_idle_secs is not None and not args.sessions:
        raise SystemExit(
            "error: --park-idle-secs applies to --serve --sessions "
            "(hibernation is a session-plane policy)"
        )
    if (args.session_budget_flops is not None
            or args.session_budget_bytes is not None) \
            and not args.sessions:
        # A silently ignored budget would leave an operator believing
        # tenants are being watched.
        raise SystemExit(
            "error: --session-budget-flops/--session-budget-bytes "
            "apply to --serve --sessions (per-tenant accounting)"
        )
    if args.record and not args.sessions:
        raise SystemExit(
            "error: --record applies to --serve --sessions (the "
            "replay log is a session-plane recording; docs/REPLAY.md)"
        )
    if not args.record and (args.keyframe_turns is not None
                            or args.record_max_bytes is not None):
        # A silently ignored recording knob would leave an operator
        # believing a cadence/bound is in force.
        raise SystemExit(
            "error: --keyframe-turns/--record-max-bytes require "
            "--record"
        )
    if args.replay_rate is not None and args.replay is None:
        raise SystemExit("error: --replay-rate requires --replay")
    if args.replay is not None:
        if args.sessions or args.relay is not None \
                or args.connect is not None:
            raise SystemExit(
                "error: --replay is its own serving mode — it cannot "
                "combine with --sessions/--relay/--connect"
            )
        if args.tile:
            # A replay server owns no board to tile.
            raise SystemExit(
                "error: --tile applies to single-board engines, not "
                "a replay server"
            )
        if args.serve is None:
            raise SystemExit(
                "error: --replay needs --serve [HOST:]PORT for its "
                "listener"
            )
        if resume_path is not None:
            raise SystemExit(
                "error: --resume applies to an engine, not a replay "
                "server"
            )
        return _with_card(args, _replay_serve, args)
    if args.tile and (args.sessions or args.relay is not None):
        # Buckets step whole stacks and relays own no board: a silently
        # ignored --tile would leave an operator believing a large
        # geometry runs activity-driven when it would run dense.
        raise SystemExit(
            "error: --tile applies to single-board engines (local or "
            "--serve), not --sessions buckets or relays"
        )
    if args.sessions:
        # Multi-tenant serve mode: state lives per session under
        # out/sessions/, so the singleton snapshot discovery below
        # does not apply — resume means "restore every session".
        if args.serve is None:
            raise SystemExit("error: --sessions requires --serve")
        if resume_path not in (None, "latest"):
            raise SystemExit(
                "error: --sessions resumes per-session checkpoints; "
                "use --resume latest (or none)"
            )
        return _with_card(args, _serve_sessions, args, params,
                          resume_path == "latest")
    if args.relay is not None:
        # Relay node: no engine of its own — resume/snapshot flags make
        # no sense here, and the downstream address is --serve.
        if args.serve is None:
            raise SystemExit(
                "error: --relay needs --serve [HOST:]PORT for its "
                "downstream listener"
            )
        if resume_path is not None:
            raise SystemExit(
                "error: --resume applies to an engine, not a relay"
            )
        return _with_card(args, _relay, args)
    if resume_path == "latest":
        from gol_tpu_torch.checkpoint import latest_snapshot

        resume_path = latest_snapshot(args.out, args.w, args.h)
        if resume_path is None:
            raise SystemExit(
                f"error: no {args.w}x{args.h} snapshot found in {args.out}/"
            )
    resume_turn = 0
    if resume_path is not None:
        from gol_tpu_torch.checkpoint import snapshot_turn

        try:
            resume_turn = snapshot_turn(resume_path)
        except ValueError as e:
            raise SystemExit(
                f"error: {e} — snapshots are named <W>x<H>x<TURN>.pgm"
            ) from None
        if resume_turn > args.turns:
            raise SystemExit(
                f"error: snapshot is at turn {resume_turn}, beyond "
                f"-turns {args.turns}"
            )

    try:
        if args.serve is not None:
            return _with_card(args, _serve, args, params, resume_path)
        if args.connect is not None:
            # A controller spends on the server's bill, not its own.
            return _interactive(args, params, resume_path, resume_turn,
                                vis_levels)
        return _with_card(args, _interactive, args, params, resume_path,
                          resume_turn, vis_levels)
    finally:
        # Exported here, while the CUDA context is up; the atexit hook
        # would find an empty capture after teardown.
        trace = device.stop_profile()
        if trace is not None:
            print(f"torch profiler trace written to {trace}")


def _with_card(args, mode, *mode_args) -> int:
    """Run a mode that steps or serves boards: on the card (resolved
    here, so that a run without one fails before it writes anything)
    unless --platform cpu, with the usage ledger under <out>/usage."""
    from gol_tpu_torch.parallel.stepper import resolve_device

    try:
        resolve_device(PLATFORMS[args.platform])
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    _arm_accounting(args)
    return mode(*mode_args)


def _arm_accounting(args) -> None:
    """The accounting plane, as gol_tpu's CLI arms it: a crash-safe
    usage ledger under <out>/usage and the soft budgets. A no-op under
    GOL_TPU_ACCOUNTING=0 (no ledger I/O)."""
    from gol_tpu_torch.obs import accounting

    accounting.configure(
        out_dir=args.out,
        budget_flops=args.session_budget_flops,
        budget_bytes=args.session_budget_bytes,
    )


def _interactive(args, params: Params, resume_path: Optional[str],
                 resume_turn: int, vis_levels: bool) -> int:
    """A local engine run, or a --connect controller: both take verbs
    from a raw-mode stdin when stdin is a terminal."""
    keypresses: queue.Queue = queue.Queue()
    stop_keys = threading.Event()
    saved_termios = None
    if sys.stdin.isatty():
        import termios
        import tty

        saved_termios = termios.tcgetattr(sys.stdin.fileno())
        tty.setcbreak(sys.stdin.fileno())
        threading.Thread(
            target=_stdin_keys, args=(keypresses, stop_keys),
            name="gol-keys", daemon=True,
        ).start()
    try:
        if args.connect is not None:
            return _control(args, params, keypresses)
        return _local(args, params, keypresses, resume_path, resume_turn,
                      vis_levels)
    finally:
        stop_keys.set()
        if saved_termios is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                              saved_termios)


def _local(args, params: Params, keypresses: queue.Queue,
           resume_path: Optional[str], resume_turn: int,
           vis_levels: bool) -> int:
    from gol_tpu_torch.engine.distributor import Engine
    from gol_tpu_torch.events import FinalTurnComplete
    from gol_tpu_torch.obs import device, flight

    engine_kwargs = {}
    if resume_path is not None:
        from gol_tpu_torch.checkpoint import record_resume_turn
        from gol_tpu_torch.io.pgm import read_pgm

        engine_kwargs = {"initial_world": read_pgm(resume_path),
                         "start_turn": resume_turn}
        record_resume_turn(resume_turn)
    if params.cycle_detect and not args.novis:
        print("warning: --cycle-detect only engages on headless "
              "fused runs; pass -noVis for it to fire", file=sys.stderr)
    try:
        # The built-in visualiser applies flips vectorized, so the local
        # watched run uses per-turn FlipBatch arrays (library consumers
        # of gol_tpu_torch.run() keep the per-cell reference contract).
        engine = Engine(params, keypresses=keypresses,
                        emit_flips=not args.novis,
                        emit_flip_batches=not args.novis,
                        device=PLATFORMS[args.platform], **engine_kwargs)
    except (ValueError, RuntimeError, NotImplementedError) as e:
        raise SystemExit(f"error: {e}") from None
    # Sidecar BEFORE the engine thread: a failed port bind aborts a run
    # that hasn't started anything needing cleanup yet.
    metrics = _start_metrics(args, health=engine.health)
    flight.set_state_provider(engine.health)
    try:
        # The profile's window, run() -> FinalTurnComplete.
        with device.profile_window("gol_tpu_torch.run"):
            engine.start()
            if args.novis:
                # Silent drain until the final turn (ref: main.go:58-67).
                for ev in engine.events:
                    if isinstance(ev, FinalTurnComplete):
                        break
            else:
                from gol_tpu_torch.visual import run_loop

                run_loop(params, engine.events, keypresses,
                         levels=vis_levels)
    except KeyboardInterrupt:
        keypresses.put("q")
    finally:
        engine.join(timeout=60)
        if metrics is not None:
            metrics.close()

    if engine.error is not None:
        print(f"engine error: {engine.error!r}", file=sys.stderr)
        return 1
    if engine.skipped_turns:
        print(f"cycle fast-forward: skipped {engine.skipped_turns} "
              "turns (proven state revisit; result is bit-exact)")
    return 0


def _start_metrics(args, health=None, tsdb=None, series_source=None):
    """Opt-in observability sidecar (gol_tpu_torch.obs.http): serve the
    process registry and a health probe whenever --metrics-port is
    given. With --alert-rules, the freshness plane's SLO evaluator runs
    inside the sidecar (served at /alerts) — rule-file parse errors
    abort AT STARTUP with the offending line, so a typo can never take
    a serving process down at runtime. With --remote-write, a
    history-plane RemoteWriter rides the sidecar too, pushing this
    registry to the collector. Returns the MetricsServer (the caller
    closes it — evaluator and writer ride its lifecycle) or None."""
    if args.alert_rules is not None and args.metrics_port is None:
        raise SystemExit(
            "error: --alert-rules requires --metrics-port (the "
            "evaluator runs inside the metrics sidecar)"
        )
    if args.remote_write is not None and args.metrics_port is None:
        raise SystemExit(
            "error: --remote-write requires --metrics-port (the "
            "writer rides the metrics sidecar, and the sidecar "
            "address is its source label)"
        )
    if args.metrics_port is None:
        return None
    from gol_tpu_torch.obs.http import MetricsServer

    alerts = None
    if args.alert_rules is not None:
        from gol_tpu_torch.obs.freshness import AlertEvaluator, load_rules

        try:
            rules = load_rules(args.alert_rules)
        except OSError as e:
            raise SystemExit(f"error: cannot read --alert-rules: {e}") \
                from None
        except ValueError as e:
            raise SystemExit(f"error: {e}") from None
        alerts = AlertEvaluator(rules, series_source=series_source)
        print(f"alert evaluator armed: {len(rules)} rule(s) from "
              f"{args.alert_rules}")
    srv = MetricsServer(args.metrics_host, args.metrics_port,
                        health=health, alerts=alerts, tsdb=tsdb)
    if args.remote_write is not None:
        from gol_tpu_torch.obs.collector import RemoteWriter

        # The sidecar's own bound address is the source label: unique per
        # process on a host, and how the console and the controller
        # already name this endpoint.
        srv.remote = RemoteWriter(
            args.remote_write,
            source=f"{srv.address[0]}:{srv.address[1]}",
            alerts=alerts, secret=args.secret,
        )
        print(f"remote-write to {args.remote_write} "
              f"(source {srv.remote.source})")
    srv.start()
    print(f"metrics serving on http://{srv.address[0]}:{srv.address[1]}"
          "/metrics", flush=True)
    return srv


def _addr(spec: str, default_host: str = "127.0.0.1") -> tuple[str, int]:
    host, _, port = spec.rpartition(":")
    try:
        return (host or default_host, int(port))
    except ValueError:
        raise SystemExit(
            f"error: bad address {spec!r} — expected [HOST:]PORT"
        ) from None


def _serve(args, params: Params, resume_path: Optional[str] = None) -> int:
    """Headless engine server (the reference's AWS-side node,
    ref: README.md:157-175), its engine on the card unless
    --platform cpu.

    Binds loopback unless an explicit HOST is given, and --secret (or
    $GOL_SECRET) authenticates attaches — without it any peer that can
    connect may pull board state or send the 'k' kill verb, so non-
    loopback exposure should pair `--serve 0.0.0.0:8030` with a
    secret."""
    from gol_tpu_torch.distributed import EngineServer
    from gol_tpu_torch.obs import flight

    host, port = _addr(args.serve, default_host="127.0.0.1")
    try:
        server = EngineServer(
            params, host, port, resume_from=resume_path,
            secret=args.secret,
            heartbeat_secs=args.hb_secs,
            evict_secs=args.evict_secs,
            max_peers=args.max_peers,
            high_water=args.high_water,
            drain_secs=args.drain_secs,
            batch_turns=(args.batch_turns
                         if args.batch_turns is not None else 1024),
            writer_pool_threads=args.writer_pool_threads,
            device=PLATFORMS[args.platform],
        )
    except (ValueError, RuntimeError, NotImplementedError) as e:
        raise SystemExit(f"error: {e}") from None
    print(f"engine serving on {server.address[0]}:{server.address[1]}",
          flush=True)
    # Sidecar BEFORE the engine/broadcast threads: a failed port bind
    # aborts while nothing needing teardown is running.
    try:
        metrics = _start_metrics(args, health=server.health)
    except OSError:
        server.shutdown()
        raise
    flight.set_state_provider(server.health)
    server.start()
    try:
        while not server.wait(timeout=1.0):
            pass
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        if metrics is not None:
            metrics.close()
    _print_launches()
    if server.engine.error is not None:
        print(f"engine error: {server.engine.error!r}", file=sys.stderr)
        return 1
    return 0


def _serve_sessions(args, params: Params, resume: bool) -> int:
    """Multi-tenant session server (gol_tpu_torch.sessions; the
    `--serve --sessions` mode), its buckets on the card unless
    --platform cpu. Same exposure rules as --serve: loopback unless an
    explicit HOST, --secret gates every attach AND every session
    verb."""
    from gol_tpu_torch.distributed import SessionServer
    from gol_tpu_torch.obs import flight

    host, port = _addr(args.serve, default_host="127.0.0.1")
    try:
        server = SessionServer(
            params, host, port, secret=args.secret,
            heartbeat_secs=args.hb_secs,
            evict_secs=args.evict_secs,
            resume=resume,
            bucket_capacity=args.bucket_capacity,
            max_peers=args.max_peers,
            max_sessions=args.max_sessions,
            high_water=args.high_water,
            drain_secs=args.drain_secs,
            batch_turns=(args.batch_turns
                         if args.batch_turns is not None else 1024),
            writer_pool_threads=args.writer_pool_threads,
            park_idle_secs=args.park_idle_secs,
            record=args.record,
            keyframe_turns=(args.keyframe_turns
                            if args.keyframe_turns is not None else 256),
            record_max_bytes=args.record_max_bytes,
            device=PLATFORMS[args.platform],
        )
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"error: {e}") from None
    print(f"session engine serving on "
          f"{server.address[0]}:{server.address[1]}", flush=True)
    if resume:
        print(f"resumed {server.resumed} session(s) from "
              f"{params.out_dir}/sessions/", flush=True)
    try:
        metrics = _start_metrics(args, health=server.health)
    except OSError:
        server.shutdown()
        raise
    flight.set_state_provider(server.health)
    server.start()
    try:
        while not server.wait(timeout=1.0):
            if not server.engine.running():
                # A fatal dispatch-loop error takes the server down with
                # it, so the listener never accepts onto a dead engine.
                server.shutdown()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        if metrics is not None:
            metrics.close()
    _print_launches()
    if server.engine.error is not None:
        print(f"session engine error: {server.engine.error!r}",
              file=sys.stderr)
        return 1
    return 0


def _print_launches() -> None:
    """A serving process's kernel launches by kernel, printed as it
    ends (all 0 on the CPU, where the plain versions run)."""
    import json

    from gol_tpu_torch.ops import cuda_bitgens, cuda_bitlife, cuda_life

    counts = {**cuda_bitlife.LAUNCHES, **cuda_bitgens.LAUNCHES,
              **cuda_life.LAUNCHES}
    print(f"kernel launches: {json.dumps(counts)}", flush=True)


def _replay_serve(args) -> int:
    """Static replay server (gol_tpu_torch.replay): serve the recordings
    under --replay LOG-DIR with zero engine dispatches. The decode is
    host work, but a gpu run still needs the card (resolved by the
    caller, the CLI's rule for every mode that serves boards). Same
    exposure rules as --serve: loopback unless an explicit HOST,
    --secret authenticates every attach."""
    from gol_tpu_torch.obs import flight
    from gol_tpu_torch.replay import ReplayServer

    host, port = _addr(args.serve, default_host="127.0.0.1")
    try:
        server = ReplayServer(
            args.replay, host, port,
            secret=args.secret,
            replay_rate=args.replay_rate,
            heartbeat_secs=args.hb_secs,
            evict_secs=args.evict_secs,
            max_peers=args.max_peers,
            high_water=args.high_water,
            drain_secs=args.drain_secs,
            batch_turns=(args.batch_turns
                         if args.batch_turns is not None else 1024),
            writer_pool_threads=args.writer_pool_threads,
        )
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"error: {e}") from None
    n = len(server._recordings)
    print(f"replay serving on {server.address[0]}:{server.address[1]} "
          f"({n} recording{'s' if n != 1 else ''} from {args.replay})",
          flush=True)
    metrics = _start_metrics(args, health=server.health)
    flight.set_state_provider(server.health)
    server.start()
    try:
        while not server.wait(timeout=1.0):
            pass
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        if metrics is not None:
            metrics.close()
    return 0


def _relay(args) -> int:
    """Relay node (gol_tpu_torch.relay): attach upstream as one batching
    binary client, re-serve the stream to N observers (TCP on --serve,
    browsers on --ws-port) with zero re-encode. It steps no board; the
    card was resolved by the caller, the CLI's rule for every mode that
    serves boards. Same exposure rules as --serve: loopback unless an
    explicit HOST, --secret authenticates the upstream attach AND every
    downstream."""
    from gol_tpu_torch.obs import flight
    from gol_tpu_torch.relay import RelayNode

    up = _addr(args.relay)
    host, port = _addr(args.serve, default_host="127.0.0.1")
    try:
        relay = RelayNode(
            up, host, port,
            secret=args.secret,
            session=args.session,
            batch_turns=(args.batch_turns
                         if args.batch_turns is not None else 1024),
            heartbeat_secs=args.hb_secs,
            evict_secs=args.evict_secs,
            max_peers=args.max_peers,
            high_water=args.high_water,
            drain_secs=args.drain_secs,
            writer_pool_threads=args.writer_pool_threads,
            ws_port=args.ws_port,
            reconnect_window=args.reconnect_secs,
        )
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    print(f"relay serving on {relay.address[0]}:{relay.address[1]} "
          f"(upstream {up[0]}:{up[1]})", flush=True)
    if relay.ws_address is not None:
        print(f"websocket gateway on "
              f"{relay.ws_address[0]}:{relay.ws_address[1]}", flush=True)
    try:
        metrics = _start_metrics(args, health=relay.health)
    except (OSError, SystemExit):
        relay.shutdown()
        raise
    flight.set_state_provider(relay.health)
    relay.start()
    try:
        while not relay.wait(timeout=1.0):
            pass
    except KeyboardInterrupt:
        relay.shutdown()
    finally:
        if metrics is not None:
            metrics.close()
    return 0


def _control_plane(args) -> int:
    """Fleet controller (gol_tpu_torch.control): load the declarative
    spec (a parse error aborts AT STARTUP, the --alert-rules
    discipline), then reconcile forever. Host-side only: it steps
    nothing and needs no card. The sidecar serves the controller's own
    metrics and /healthz, so the console — and another controller — can
    observe the observer."""
    from gol_tpu_torch.control import Controller, SpecError, load_spec
    from gol_tpu_torch.obs import flight

    try:
        spec = load_spec(args.control)
        ctl = Controller(spec, out_dir=args.out)
    except SpecError as e:
        raise SystemExit(f"error: {e}") from None
    print(f"controller reconciling {args.control} "
          f"(root {spec.root}, {len(spec.engines)} engine(s), "
          f"relays {spec.relay_min}..{spec.relay_max})", flush=True)
    metrics = _start_metrics(args, health=ctl.health)
    flight.set_state_provider(ctl.health)
    ctl.start()
    try:
        while not ctl.wait(timeout=1.0):
            pass
    except KeyboardInterrupt:
        ctl.shutdown()
    finally:
        if metrics is not None:
            metrics.close()
    return 0


def _collector(args, resume: bool) -> int:
    """History-plane collector (gol_tpu_torch.obs.collector + .tsdb):
    ingest remote-write telemetry from every sidecar into crash-atomic
    segment logs under <out>/tsdb and serve range queries (/query,
    /history) from its own metrics sidecar. Host-side only: it needs no
    card. Same exposure rules as --serve: loopback unless an explicit
    HOST, --secret gates every remote-write attach.

    --alert-rules here evaluate FLEET-WIDE: the evaluator reads the
    collected series (each key tagged src="SOURCE") instead of the
    collector's own registry, and after --resume latest the `for:`
    clocks are seeded from stored history — a restart cannot reset a
    breach that was already pending."""
    import time as _time

    from gol_tpu_torch.obs import flight
    from gol_tpu_torch.obs.collector import CollectorServer
    from gol_tpu_torch.obs.tsdb import TSDB, eval_expr

    host, port = _addr(args.collector, default_host="127.0.0.1")
    root = os.path.join(args.out, "tsdb")
    db = TSDB(root, resume=resume)
    if resume:
        print(f"resumed {len(db.sources())} source(s) from {root}/")
    server = CollectorServer(host, port, db, secret=args.secret)
    print(f"collector serving on "
          f"{server.address[0]}:{server.address[1]} (store {root}/)",
          flush=True)

    def health():
        last = db.last_sample_time()
        return {
            "status": "ok", "mode": "collector",
            "sources": len(db.sources()),
            "last_sample_age_s": (None if last is None
                                  else round(_time.time() - last, 3)),
        }

    def fleet_series():
        # Merged latest values across every source, each key tagged
        # src="..." — `max(family)` in a rule means "worst source".
        merged = {}
        now = _time.time()
        for src in db.sources():
            for key, value in db.latest(src, max_age=60.0,
                                        now=now).items():
                name, brace, rest = key.partition("{")
                if brace:
                    merged[f'{name}{{src="{src}",{rest}'] = value
                else:
                    merged[f'{name}{{src="{src}"}}'] = value
        return merged

    # One try from here down: a SIGINT landing anywhere after the banner
    # (even mid-seeding) must still reach the graceful close (final
    # segment flushed), not escape as an uncaught interrupt.
    metrics = None
    try:
        metrics = _start_metrics(args, health=health, tsdb=db,
                                 series_source=fleet_series)
        if metrics is not None and metrics.alerts is not None \
                and resume:
            ev = metrics.alerts
            now_wall = _time.time()

            def stored_values(rule):
                # Ages relative to now, one point per evaluator interval
                # over the trailing 2x `for:` window.
                window = max(10.0, 2.0 * rule.for_secs)
                step = max(1.0, ev.interval)
                pts = eval_expr(db, rule.agg, rule.family,
                                now_wall - window, now_wall, step)
                return [(now_wall - t, v) for t, v in pts
                        if v is not None]

            seeded = ev.seed_history(stored_values)
            if seeded:
                print(f"seeded {seeded} for: rule(s) pending from "
                      "stored history")
        flight.set_state_provider(health)
        server.start()
        while True:
            _time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        if metrics is not None:
            metrics.close()
        server.close()  # closes the TSDB (final segment flushed)
    return 0


def _control(args, params: Params, keypresses: queue.Queue) -> int:
    """Controller attached to a remote engine (ref: README.md:177-183).
    Host-side only: it steps nothing, so it needs no card."""
    from gol_tpu_torch.distributed import Controller
    from gol_tpu_torch.models.rules import GenRule
    from gol_tpu_torch.obs import flight

    host, port = _addr(args.connect)
    vis_levels = isinstance(params.rule, GenRule)
    # batch=True: the visualiser applies each turn's flips as one
    # vectorized XOR (events.FlipBatch) instead of per-cell objects;
    # levels follows the rule family (gray-level Generations batches).
    ctl = Controller(host, port, want_flips=not args.novis,
                     secret=args.secret, batch=not args.novis,
                     batch_turns=args.batch_turns,
                     levels=vis_levels and not args.novis,
                     observe=args.observe,
                     session=args.session,
                     reconnect=not args.no_reconnect,
                     reconnect_window=args.reconnect_secs)

    def _ctl_health() -> dict:
        return {
            "status": "ok" if not ctl.events.closed else "detached",
            "state": ctl.state,
            "synced": ctl.synced.is_set(),
            "sync_turn": ctl.sync_turn,
            "reconnects": ctl.reconnects,
            "detached": ctl.detached.is_set(),
        }

    metrics = None

    class _WireKeys:
        """queue.Queue-shaped sink that forwards verbs over the wire —
        lets the visualiser loop and the stdin pump share one path."""

        def put(self, key):
            try:
                ctl.send_key(key)
            except (OSError, ConnectionError):
                pass

    wire_keys = _WireKeys()

    def pump():  # local stdin verbs → remote engine
        while True:
            try:
                wire_keys.put(keypresses.get(timeout=0.2))
            except queue.Empty:
                if ctl.detached.is_set() or ctl.events.closed:
                    return  # detached, lost, or run over

    threading.Thread(target=pump, name="gol-ctl-keys", daemon=True).start()
    try:
        # Inside the try: a failed sidecar bind must still detach the
        # controller (ctl.close() in the finally frees the driver slot).
        metrics = _start_metrics(args, health=_ctl_health)
        flight.set_state_provider(_ctl_health)
        if args.novis:
            for ev in ctl.events:
                s = str(ev)
                if s:
                    print(f"Completed Turns {ev.completed_turns:<8}{s}")
            if ctl.lost.is_set():
                print("error: connection to the engine lost "
                      "(reconnect budget exhausted)", file=sys.stderr)
                return 1
            if ctl.board is None and not ctl.detached.is_set():
                print("engine run ended before the attach completed",
                      file=sys.stderr)
        else:
            from gol_tpu_torch.visual import run_loop

            # The engine's board size wins over local -w/-h flags: the
            # attach sync carries the authoritative dimensions.
            if not (ctl.wait_sync() and ctl.board is not None):
                print("error: no board sync from the engine (attach "
                      "failed or run already over)", file=sys.stderr)
                return 1
            h, w = ctl.board.shape
            params = dataclasses.replace(
                params, image_width=w, image_height=h
            )
            run_loop(params, ctl.events, wire_keys, levels=vis_levels)
            if ctl.lost.is_set():
                print("error: connection to the engine lost "
                      "(reconnect budget exhausted)", file=sys.stderr)
                return 1
        return 0
    finally:
        ctl.close()
        if metrics is not None:
            metrics.close()
