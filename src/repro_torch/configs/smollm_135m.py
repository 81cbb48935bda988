"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152, llama-arch small, tied embeddings
[hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = register_arch(
    ModelConfig(
        name="smollm-135m",
        family="dense",
        source="hf:HuggingFaceTB/SmolLM-135M",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab_size=49152,
        tie_embeddings=True,
    )
)
