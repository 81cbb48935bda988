"""Registered model configurations (each module registers one)."""
from repro_torch.configs import smollm_135m  # noqa: F401
