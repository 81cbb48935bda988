"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; Mamba:attention 7:1 interleave (1 attn per 8 layers), MoE 16
experts top-2 on every other layer [arXiv:2403.19887]."""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = register_arch(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        source="arXiv:2403.19887",
        ssm_kind="mamba",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        moe_d_ff=14336,
        vocab_size=65536,
        num_experts=16,
        experts_per_token=2,
        attn_every=8,
        moe_every=2,
        ssm_state_dim=16,
        ssm_conv_dim=4,
        ssm_expand=2,
        ssm_chunk=256,
        moe_group_size=4096,
    )
)
