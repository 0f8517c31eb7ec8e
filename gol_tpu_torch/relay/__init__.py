"""gol_tpu_torch.relay — the broadcast tier's writer event loop
(`writerpool`), which both servers' peers ride. The relay node and the
WebSocket gateway of `gol_tpu.relay` are not ported yet."""

from gol_tpu_torch.relay.writerpool import PoolFull, WriterPool

__all__ = ["PoolFull", "WriterPool"]
