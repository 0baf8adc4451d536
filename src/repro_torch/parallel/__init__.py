"""Collectives of the port over ``torch.distributed``."""
