from gol_tpu_torch.parallel.stepper import Stepper, make_stepper

__all__ = ["Stepper", "make_stepper"]
