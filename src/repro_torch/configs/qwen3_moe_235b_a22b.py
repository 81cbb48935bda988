"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = register_arch(
    ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment sheet)",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        moe_d_ff=1536,
        vocab_size=151936,
        num_experts=128,
        experts_per_token=8,
        qk_norm=True,
        rope_theta=1_000_000.0,
        moe_group_size=2048,
        moe_capacity_factor=1.25,
    )
)
