"""Distributed split: engine server ⇄ controller client over TCP — the
one-engine serving modes of `gol_tpu.distributed` (`--serve`,
`--connect`, `--observe`) with the same wire. `SessionServer` and
`SessionControl` are not ported yet."""

from gol_tpu_torch.distributed.client import (
    ConnectionLost,
    Controller,
    EngineClient,
    ServerBusyError,
    UnauthorizedError,
    UnknownSessionError,
)
from gol_tpu_torch.distributed.server import (
    EngineServer,
    snapshot_turn,
)

__all__ = [
    "ConnectionLost",
    "Controller",
    "EngineClient",
    "EngineServer",
    "ServerBusyError",
    "UnauthorizedError",
    "UnknownSessionError",
    "snapshot_turn",
]
