from gol_tpu_torch.io.pgm import read_pgm, write_pgm, alive_cells_from_pgm

__all__ = ["read_pgm", "write_pgm", "alive_cells_from_pgm"]
