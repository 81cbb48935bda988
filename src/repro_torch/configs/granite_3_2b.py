"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = register_arch(
    ModelConfig(
        name="granite-3-2b",
        family="dense",
        source="hf:ibm-granite/granite-3.0-2b-base",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49155,
        tie_embeddings=True,
    )
)
