"""gol_tpu_torch — the PyTorch / CUDA port of gol_tpu, on one NVIDIA H100.

The same public surface as `gol_tpu`, mirroring the reference's single
exported entry point `gol.Run(p, events, keyPresses)`
(ref: gol/gol.go:12-41):

    from gol_tpu_torch import Params, run
    events = run(Params(turns=100, image_width=512, image_height=512))
    for ev in events: ...

Entry points run on the CUDA card unless the caller asks for the CPU
(`run(..., device="cpu")`, `--platform cpu`); without a card they raise.
The kernels are hand-written CUDA (`gol_tpu_torch/csrc/`: packed Life,
packed Generations planes, dense Life), built with nvcc at first use —
so importing this package needs neither a compiler nor a card.
"""

from gol_tpu_torch.params import Params
from gol_tpu_torch.events import (
    AliveCellsCount,
    CellFlipped,
    Event,
    FinalTurnComplete,
    FlipBatch,
    ImageOutputComplete,
    State,
    StateChange,
    TurnComplete,
)

__all__ = [
    "Params",
    "Event",
    "AliveCellsCount",
    "ImageOutputComplete",
    "StateChange",
    "CellFlipped",
    "FlipBatch",
    "TurnComplete",
    "FinalTurnComplete",
    "State",
    "run",
]

#: The version of gol_tpu whose contract this port implements.
__version__ = "0.4.0"


def run(params, keypresses=None, events=None, device=None, **kwargs):
    """Start the engine; returns the event queue (see engine.distributor).
    `device` None means the CUDA card; pass "cpu" for the CPU."""
    from gol_tpu_torch.engine.distributor import run as _run

    return _run(params, keypresses=keypresses, events=events,
                device=device, **kwargs)
