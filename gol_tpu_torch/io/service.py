"""Asynchronous storage I/O service — the analog of the reference's
long-lived IO goroutine (ref: gol/io.go:129-149).

The reference streams pixels one byte per channel send and offers three
verbs: output, input, check-idle (ref: gol/io.go:35-39). This service
keeps the architecture — I/O off the engine thread, an idle handshake
before shutdown (ref: gol/distributor.go:200-203) — but moves whole
arrays at once, so a 512×512 snapshot is one file write instead of
262,144 channel sends. Writes are async (the turn loop never stalls on
disk); reads are synchronous.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Callable, Optional

import numpy as np

from gol_tpu_torch.io.pgm import read_pgm, write_pgm


class IOService:
    """Background thread executing read/write commands from a queue
    (command-queue architecture ref: gol/io.go:12-19,129-149)."""

    def __init__(self, image_dir: str = "images", out_dir: str = "out"):
        self.image_dir = image_dir
        self.out_dir = out_dir
        self._cmds: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loop, name="gol-io", daemon=True)
        self._thread.start()

    # --- verbs (ref: gol/io.go ioCommand enum) ---

    def read(self, name: str) -> np.ndarray:
        """Synchronous image load from `<image_dir>/<name>.pgm`
        (ref: gol/io.go:90-126)."""
        reply: queue.Queue = queue.Queue()
        self._cmds.put(("read", name, reply))
        result = reply.get()
        if isinstance(result, BaseException):
            raise result
        return result

    def write(
        self,
        name: str,
        world: np.ndarray,
        on_complete: Optional[Callable[[str, Optional[BaseException]], None]] = None,
    ) -> None:
        """Asynchronous image write to `<out_dir>/<name>.pgm`
        (ref: gol/io.go:42-87). `on_complete(name, exc)` fires on the IO
        thread once the bytes are synced (exc=None) or the write failed —
        the hook the engine uses to emit `ImageOutputComplete` without
        blocking the turn loop."""
        self._cmds.put(("write", name, np.asarray(world, dtype=np.uint8), on_complete))

    def check_idle(self) -> bool:
        """Block until all queued commands have drained — the shutdown
        handshake (ref: gol/distributor.go:200-203, gol/io.go:144-147)."""
        reply: queue.Queue = queue.Queue()
        self._cmds.put(("idle", reply))
        return reply.get()

    def stop(self) -> None:
        self._cmds.put(("stop",))
        self._thread.join(timeout=5)

    # --- internals ---

    def _loop(self) -> None:
        while True:
            cmd = self._cmds.get()
            verb = cmd[0]
            if verb == "read":
                _, name, reply = cmd
                try:
                    reply.put(read_pgm(os.path.join(self.image_dir, f"{name}.pgm")))
                except BaseException as e:  # surfaced on the caller thread
                    reply.put(e)
            elif verb == "write":
                _, name, world, on_complete = cmd
                exc: Optional[BaseException] = None
                try:
                    write_pgm(os.path.join(self.out_dir, f"{name}.pgm"), world)
                except BaseException as e:
                    # The service must survive ENOSPC/EROFS etc. — a dead
                    # IO thread would hang every later read/check_idle.
                    exc = e
                if on_complete is not None:
                    try:
                        on_complete(name, exc)
                    except BaseException:
                        # A raising callback must not kill the service —
                        # but it must not vanish without a trace either.
                        logging.getLogger(__name__).exception(
                            "IO on_complete callback failed for %r", name
                        )
            elif verb == "idle":
                cmd[1].put(True)
            elif verb == "stop":
                return
