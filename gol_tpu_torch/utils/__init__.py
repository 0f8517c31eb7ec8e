from gol_tpu_torch.utils.cell import Cell, cells_from_mask, xy_from_mask
from gol_tpu_torch.utils.check import check

__all__ = ["Cell", "cells_from_mask", "check", "xy_from_mask"]
