from gol_tpu_torch.engine.distributor import (
    Engine,
    EventQueue,
    register_live_engine,
    run,
)

__all__ = ["Engine", "EventQueue", "register_live_engine", "run"]
