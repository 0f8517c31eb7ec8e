from gol_tpu_torch.utils.cell import Cell, cells_from_mask, xy_from_mask

__all__ = ["Cell", "cells_from_mask", "xy_from_mask"]
