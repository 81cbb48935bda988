"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = register_arch(
    ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        source="arXiv:2401.04088",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        moe_d_ff=14336,
        vocab_size=32000,
        num_experts=8,
        experts_per_token=2,
        sliding_window=4096,
        rope_theta=1_000_000.0,
        moe_group_size=4096,
        moe_capacity_factor=1.25,
    )
)
