"""Registered model configurations (each module registers one)."""
from repro_torch.configs import (  # noqa: F401
    granite_3_2b,
    hubert_xlarge,
    internlm2_20b,
    jamba_v0_1_52b,
    mixtral_8x7b,
    phi_3_vision_4_2b,
    qwen3_32b,
    qwen3_moe_235b_a22b,
    smollm_135m,
    xlstm_125m,
)

ASSIGNED_ARCHS = [
    "qwen3-moe-235b-a22b",
    "mixtral-8x7b",
    "xlstm-125m",
    "hubert-xlarge",
    "smollm-135m",
    "phi-3-vision-4.2b",
    "qwen3-32b",
    "granite-3-2b",
    "internlm2-20b",
    "jamba-v0.1-52b",
]
