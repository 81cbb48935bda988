"""Registered model configurations (each module registers one)."""
from repro_torch.configs import granite_3_2b, internlm2_20b, smollm_135m  # noqa: F401
