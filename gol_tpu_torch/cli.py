"""Command-line entry — the analog of the reference's process entry
(ref: main.go:13-68), for the PyTorch / CUDA port.

The reference flags with the reference spelling (`-t 8 -w 512 -h 512
-turns N -noVis`, ref: main.go:17-46), plus gol_tpu's single-device
extensions — `--rule`, `--backend`, `--chunk`, `--images`, `--out`,
`--tick`, `--autosave-turns`, `--autosave-secs`, `--tile`, `--cycle-detect`,
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
a terminal. gol_tpu's serving, session, relay, replay, collector and
metrics flags belong to later slices of the port and are absent.
"""

from __future__ import annotations

import argparse
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
                    help="number of worker shards (default 8; one device "
                         "runs one shard, results are identical)")
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

    from gol_tpu_torch.engine.distributor import Engine
    from gol_tpu_torch.events import FinalTurnComplete
    from gol_tpu_torch.models.rules import GenRule, get_rule
    from gol_tpu_torch.obs import device, flight

    try:
        rule = get_rule(args.rule)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    # Multi-state rules visualise as gray levels.
    vis_levels = isinstance(rule, GenRule)
    flight.configure(args.out)
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
        )
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"error: {e}") from None

    # Checkpoint restart: boot from a snapshot, continuing at the turn in
    # its filename.
    resume_path = args.resume
    if resume_path == "latest":
        from gol_tpu_torch.checkpoint import latest_snapshot

        resume_path = latest_snapshot(args.out, args.w, args.h)
        if resume_path is None:
            raise SystemExit(
                f"error: no {args.w}x{args.h} snapshot found in {args.out}/"
            )
    engine_kwargs = {}
    if resume_path is not None:
        from gol_tpu_torch.checkpoint import record_resume_turn, snapshot_turn
        from gol_tpu_torch.io.pgm import read_pgm

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
        engine_kwargs = {"initial_world": read_pgm(resume_path),
                         "start_turn": resume_turn}
        record_resume_turn(resume_turn)
    if params.cycle_detect and not args.novis:
        print("warning: --cycle-detect only engages on headless "
              "fused runs; pass -noVis for it to fire", file=sys.stderr)

    keypresses: queue.Queue = queue.Queue()
    try:
        # The built-in visualiser applies flips vectorized, so the local
        # watched run uses per-turn FlipBatch arrays (library consumers
        # of gol_tpu_torch.run() keep the per-cell reference contract).
        engine = Engine(params, keypresses=keypresses,
                        emit_flips=not args.novis,
                        emit_flip_batches=not args.novis,
                        device=PLATFORMS[args.platform], **engine_kwargs)
    except (ValueError, RuntimeError, NotImplementedError) as e:
        device.stop_profile()
        raise SystemExit(f"error: {e}") from None

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
        stop_keys.set()
        if saved_termios is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                              saved_termios)
        # Exported here, while the CUDA context is up; the atexit hook
        # would find an empty capture after teardown.
        trace = device.stop_profile()
        if trace is not None:
            print(f"torch profiler trace written to {trace}")

    if engine.error is not None:
        print(f"engine error: {engine.error!r}", file=sys.stderr)
        return 1
    if engine.skipped_turns:
        print(f"cycle fast-forward: skipped {engine.skipped_turns} "
              "turns (proven state revisit; result is bit-exact)")
    return 0
