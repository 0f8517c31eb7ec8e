from gol_tpu_torch.models.rules import Rule, LIFE, RULES

__all__ = ["Rule", "LIFE", "RULES"]
