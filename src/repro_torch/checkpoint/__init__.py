"""Checkpoints the JAX package and the port both read and write."""
from repro_torch.checkpoint.npz import list_checkpoints, load_checkpoint, save_checkpoint

__all__ = ["list_checkpoints", "load_checkpoint", "save_checkpoint"]
