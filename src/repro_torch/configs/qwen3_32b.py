"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk-norm [hf:Qwen/Qwen3-8B family, scaled per sheet]."""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = register_arch(
    ModelConfig(
        name="qwen3-32b",
        family="dense",
        source="hf:Qwen/Qwen3-8B (scaled per assignment sheet)",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )
)
