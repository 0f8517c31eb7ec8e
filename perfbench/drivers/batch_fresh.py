"""The batch user's path on a board that settles before the window:
`drivers/batch.py`'s run, unchanged, and one more check, `fresh_cells`.

A 0.25 soup on a small torus (512²) is ash within tens of thousands of
turns, and the warm-up alone runs millions: still lifes, period-2
oscillators and gliders whose period divides a power-of-two chunk. So a
fused chunk that handed its board back unstepped, or dropped turns
modulo a power of two, would pass `window_cells`, and `stage_cells`
sees only the first 64-turn launch. After the batch run (its engine
stopped, its reference done), a second `Engine` steps a fresh soup, from
the seed plus the traffic's `fresh_seed_offset`, with `Params.chunk`
fixed at the window's chunk (`effective_chunk`). Its board at its first
dispatch boundary after turn 0 — one fused chunk of the window's length
on an active board — is held against the reference stepped as far on
the card.
"""

from __future__ import annotations

import queue
import threading
import time

from perfbench import harness
from perfbench.drivers import batch
from perfbench.reference import life as ref


def run(bench: harness.Bench) -> harness.Seen:
    import torch

    seen = batch.run(bench)
    cfg, tr = bench.config, bench.traffic
    t0 = time.monotonic()
    soup = ref.soup(cfg["height"], cfg["width"],
                    bench.seed + tr["fresh_seed_offset"], cfg["density"])
    turn, board, error = _first_boundary(bench, soup,
                                         seen.notes["effective_chunk"])
    if error is not None:
        seen.failed += 1
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    with torch.no_grad():
        start = ref.to_bits(soup)[None].to(bench.device)
        want = ref.run_to(start, [turn]).cpu()[0]
        if bench.control:
            got = ref.run_to(start, [turn], torus=False).cpu()[0]
        else:
            got = ref.to_bits(board)
    seen.checks.append(harness.Check("fresh_cells",
                                     ref.mismatches(want, got), 0))
    seen.notes.update(fresh_turns=turn, fresh_s=time.monotonic() - t0)
    return seen


def _first_boundary(bench: harness.Bench, soup, chunk: int) -> tuple:
    """(turn, board, engine error) of a fresh engine on `soup`, with
    the batch run's settings but a fixed `chunk`, at its first dispatch
    boundary after turn 0; the engine is stopped before this returns."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.engine.distributor import Engine
    from gol_tpu_torch.events import BoardSync

    cfg, tr = bench.config, bench.traffic
    timeout = tr["reply_timeout_s"]
    params = Params(turns=tr["turns"], image_width=cfg["width"],
                    image_height=cfg["height"], rule=cfg["rule"],
                    chunk=chunk, tick_seconds=tr["tick_seconds"],
                    cycle_detect=False, out_dir=str(bench.tmp / "fresh"),
                    image_dir=str(bench.tmp / "images"))
    engine = Engine(params, emit_flips=False, initial_world=soup,
                    device=bench.device)
    syncs: queue.Queue = queue.Queue()

    def drain():
        for ev in engine.events:
            if isinstance(ev, BoardSync):
                syncs.put(ev)

    drainer = threading.Thread(target=drain, name="perfbench-fresh-drain",
                               daemon=True)
    drainer.start()
    token = 0
    engine.request_board_sync(token=token)  # served at turn 0
    engine.start()
    try:
        while True:
            ev = syncs.get(timeout=timeout)
            if ev.token != token:
                continue
            if ev.completed_turns > 0:
                break
            token += 1
            engine.request_board_sync(token=token)
    finally:
        engine.stop()
        engine.join(timeout=timeout)
    drainer.join(timeout=timeout)
    return ev.completed_turns, ev.world, engine.error
