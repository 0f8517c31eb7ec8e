"""The batch user's path for a Generations (B/S/C) rule: one headless
run of the engine on one board — `gol_tpu_torch`'s `Engine` as
`run(Params)` and the CLI's `-noVis` build it (no flips, no per-turn
events, the ticker's counts, fused auto-sized chunks) — measured for a
window and stopped after it. `drivers/batch.py`'s run step for step,
checked with the Generations reference and launches of kernels C and D.

Set-up makes the soup from the seed, starts the engine, takes its board
at the first dispatch boundary after turn 0 (the check's start: the
reference steps the soup to it), and waits until the auto-chunk
calibration has stopped growing the chunk. The window's edges are
`Engine.alive_count_now()` readings, each a realised (turn, count of
alive cells) pair, so only turns the card finished count. After the
window the engine hands over its board at one boundary, and its board
and count at the next; the reference steps the first board across the
dispatch between them (a converged chunk) and counts its alive cells.
Boards come as gray levels and are compared as states, mapped back
through the reference's frozen table. The reference runs on the card
once the engine has stopped and its memory is freed.
"""

from __future__ import annotations

import queue
import threading
import time

from perfbench import harness
from perfbench.reference import generations as ref


def run(bench: harness.Bench) -> harness.Seen:
    import torch

    from gol_tpu_torch import Params
    from gol_tpu_torch.engine.distributor import Engine
    from gol_tpu_torch.events import BoardSync
    from gol_tpu_torch.ops import _build, cuda_bitgens

    cfg, tr = bench.config, bench.traffic
    h, w = cfg["height"], cfg["width"]
    timeout = tr["reply_timeout_s"]
    seen = harness.Seen(cfg, tr)
    seen.mark(bench, "imported")
    soup = ref.soup(h, w, bench.seed, cfg["density"])
    seen.mark(bench, "soup")
    params = Params(turns=tr["turns"], image_width=w, image_height=h,
                    rule=cfg["rule"], chunk=tr["chunk"],
                    tick_seconds=tr["tick_seconds"], cycle_detect=False,
                    out_dir=str(bench.tmp / "out"),
                    image_dir=str(bench.tmp / "images"))
    engine = Engine(params, emit_flips=False, initial_world=soup,
                    device=bench.device)
    syncs: queue.Queue = queue.Queue()

    def drain():
        for ev in engine.events:
            if isinstance(ev, BoardSync):
                syncs.put(ev)

    def board_sync(token: int, requested: bool = False) -> tuple:
        """(turn, board) at the next dispatch boundary the engine
        serves."""
        if not requested:
            engine.request_board_sync(token=token)
        while True:
            ev = syncs.get(timeout=timeout)
            if ev.token == token:
                return ev.completed_turns, ev.world

    def reading() -> tuple:
        """(turn, host instant) of a count the engine realised."""
        turn, _ = engine.alive_count_now(timeout=timeout)
        return turn, time.monotonic()

    drainer = threading.Thread(target=drain, name="perfbench-drain",
                               daemon=True)
    drainer.start()
    engine.request_board_sync(token=0)  # served at turn 0
    engine.start()
    try:
        token = 0
        stage_turn, stage_board = board_sync(token, requested=True)
        while stage_turn == 0:
            token += 1
            stage_turn, stage_board = board_sync(token)
        seen.mark(bench, "stage")

        # Warm-up: the auto-chunk calibration has converged once the
        # chunk has not grown for settle_s.
        t_warm = time.monotonic()
        chunk, since = engine.effective_chunk, time.monotonic()
        while time.monotonic() - since < tr["settle_s"]:
            if engine.error is not None:
                raise RuntimeError(f"engine error: {engine.error!r}")
            if time.monotonic() - t_warm > tr["warmup_limit_s"]:
                raise RuntimeError("the auto-chunk calibration did not "
                                   f"settle in {tr['warmup_limit_s']} s")
            time.sleep(0.02)
            if engine.effective_chunk != chunk:
                chunk, since = engine.effective_chunk, time.monotonic()
        seen.notes["warmup_s"] = time.monotonic() - t_warm

        window = harness.Window(bench, seen, cuda_bitgens.LAUNCHES)
        window.start()
        t_a, at_a = reading()
        seen.setup_s = at_a - bench.t_proc
        time.sleep(max(0.0, at_a + bench.seconds - time.monotonic()))
        t_b, at_b = reading()
        window.stop()
        seen.window_s = at_b - at_a
        seen.cell_updates = (t_b - t_a) * h * w
        seen.attempted = int(seen.delta(harness.series(
            "gol_tpu_engine_dispatches_total", kind="chunk")) or 0)
        if torch.cuda.is_available() and bench.device != "cpu":
            seen.memory_peak_bytes = torch.cuda.max_memory_allocated(
                bench.device)

        # The program's board at one boundary, then its board and count
        # at the next (a count and a board requested together can land
        # on two boundaries: then the later board starts again).
        t1, board1 = board_sync(1000)
        for token in range(1001, 1011):
            engine.request_board_sync(token=token)
            count_turn, count = engine.alive_count_now(timeout=timeout)
            t2, board2 = board_sync(token, requested=True)
            if t2 == count_turn:
                break
            t1, board1 = t2, board2
        seen.notes.update(effective_chunk=engine.effective_chunk,
                          stage_turns=stage_turn, window_turns=t2 - t1,
                          kernel_build_s=_build.build_seconds)
    finally:
        engine.stop()
        engine.join(timeout=timeout)
    if engine.error is not None:
        seen.failed = 1
    drainer.join(timeout=timeout)
    del engine
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    t_ref = time.monotonic()
    with torch.no_grad():
        rule = cfg["rule"]
        inputs = torch.stack([ref.to_states(soup),
                              ref.to_states(board1)]).to(bench.device)
        turns = [stage_turn, t2 - t1]
        want = ref.run_to(inputs, turns, rule).cpu()
        if bench.control:
            got = ref.run_to(inputs, turns, rule, torus=False).cpu()
            count = ref.alive(got[1])
        else:
            got = torch.stack([ref.to_states(stage_board),
                               ref.to_states(board2)])
        seen.checks = [
            harness.Check("stage_cells", ref.mismatches(want[0], got[0]), 0),
            harness.Check("window_cells", ref.mismatches(want[1], got[1]),
                          0),
            harness.Check("count_gap", abs(int(count) - ref.alive(want[1]))
                          + abs(t2 - count_turn), 0),
        ]
    seen.notes["reference_s"] = time.monotonic() - t_ref
    return seen
