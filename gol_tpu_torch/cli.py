"""Command-line entry — the analog of the reference's process entry
(ref: main.go:13-68), for the PyTorch / CUDA port.

The reference flags with the reference spelling (`-t 8 -w 512 -h 512
-turns N -noVis`, ref: main.go:17-46), plus `--rule`, `--backend`,
`--chunk`, `--images`, `--out`, `--cycle-detect` and `--platform
{gpu,cpu}` (gpu by default; without a card the run fails instead of
moving to the CPU). With `-noVis` the event stream is drained silently
until `FinalTurnComplete` (ref: main.go:58-67); the visualiser is not
ported yet, so a run without `-noVis` exits with an error.

Keyboard verbs p/s/q/k come from a raw-mode stdin reader when stdin is
a terminal.
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
    ap.add_argument("--cycle-detect", action="store_true",
                    dest="cycle_detect",
                    help="exact cycle fast-forward: once the board "
                         "provably revisits a state, collapse the "
                         "remaining turns modulo the period (bit-exact)")
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
    if not args.novis:
        raise SystemExit("error: visualiser not yet ported; pass -noVis")

    from gol_tpu_torch.engine.distributor import Engine
    from gol_tpu_torch.events import FinalTurnComplete
    from gol_tpu_torch.models.rules import get_rule
    from gol_tpu_torch.obs import flight

    try:
        rule = get_rule(args.rule)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    flight.configure(args.out)

    # Banner (ref: main.go:48-50).
    print("Threads:", args.t)
    print("Width:", args.w)
    print("Height:", args.h)

    keypresses: queue.Queue = queue.Queue()
    try:
        params = Params(
            turns=args.turns,
            threads=args.t,
            image_width=args.w,
            image_height=args.h,
            rule=rule,
            backend=args.backend,
            chunk=args.chunk,
            image_dir=args.images,
            out_dir=args.out,
            cycle_detect=args.cycle_detect,
        )
        engine = Engine(params, keypresses=keypresses, emit_flips=False,
                        device=PLATFORMS[args.platform])
    except (ValueError, RuntimeError, NotImplementedError) as e:
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
    engine.start()
    try:
        # Silent drain until the final turn (ref: main.go:58-67).
        for ev in engine.events:
            if isinstance(ev, FinalTurnComplete):
                break
    except KeyboardInterrupt:
        keypresses.put("q")
    finally:
        engine.join(timeout=60)
        stop_keys.set()
        if saved_termios is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                              saved_termios)

    if engine.error is not None:
        print(f"engine error: {engine.error!r}", file=sys.stderr)
        return 1
    if engine.skipped_turns:
        print(f"cycle fast-forward: skipped {engine.skipped_turns} "
              "turns (proven state revisit; result is bit-exact)")
    return 0
