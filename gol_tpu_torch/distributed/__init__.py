"""Distributed split: engine server ⇄ controller client over TCP — the
serving modes of `gol_tpu.distributed` with the same wire: one engine
(`EngineServer`, `Controller`; `--serve`, `--connect`, `--observe`) and
many named sessions (`SessionServer`, `SessionControl`; `--serve
--sessions`, `--connect --session ID`)."""

from gol_tpu_torch.distributed.client import (
    ConnectionLost,
    Controller,
    EngineClient,
    ServerBusyError,
    SessionControl,
    UnauthorizedError,
    UnknownSessionError,
)
from gol_tpu_torch.distributed.server import (
    EngineServer,
    SessionServer,
    snapshot_turn,
)

__all__ = [
    "ConnectionLost",
    "Controller",
    "EngineClient",
    "EngineServer",
    "ServerBusyError",
    "SessionControl",
    "SessionServer",
    "UnauthorizedError",
    "UnknownSessionError",
    "snapshot_turn",
]
