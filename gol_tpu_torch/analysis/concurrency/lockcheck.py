"""lockcheck — the lock factory of `gol_tpu.analysis.concurrency.lockcheck`.

The port creates its locks through `make_lock` so that each keeps its
static name, as in gol_tpu. gol_tpu's runtime order graph and
held-too-long watchdog are not ported: the port's engine holds a single
lock (`Engine._req_lock`), and one lock can close no order cycle.
"""

from __future__ import annotations

import threading

__all__ = ["make_lock"]


def make_lock(name: str):
    """A plain `threading.Lock`. `name` is the lock's static identity
    (`Engine._req_lock`)."""
    return threading.Lock()
