"""gol_tpu_torch.relay — the broadcast tier (the port of `gol_tpu.relay`;
docs/RELAY.md).

Three legs turn the one-server serving plane into a fan-out tree:

- `writerpool`: a selectors-based writer event loop — thousands of
  non-blocking peer sockets per pool thread with bounded per-peer byte
  queues, replacing the thread-per-connection writers in both
  `distributed.server` servers (the degradation machinery
  operates on the pool's queues unchanged);
- `node`: a store-and-forward relay (`--relay upstream:port`) that
  attaches upstream as ONE batching binary client and re-serves N
  downstream observers by forwarding identical FBATCH/BoardSync bytes
  with zero re-encode — reconnect and clock sync compose per hop;
- `ws`: a stdlib RFC-6455 WebSocket edge gateway riding the same
  relay abstraction — browser observers get the identical binary
  frames inside WS binary messages.
"""

from gol_tpu_torch.relay.writerpool import PoolFull, WriterPool


def __getattr__(name):
    # RelayNode pulls in the whole serving plane (distributed.server);
    # importing it lazily keeps `from gol_tpu_torch.relay import WriterPool`
    # light for the servers themselves (no import cycle).
    if name == "RelayNode":
        from gol_tpu_torch.relay.node import RelayNode

        return RelayNode
    raise AttributeError(name)


__all__ = ["PoolFull", "RelayNode", "WriterPool"]
