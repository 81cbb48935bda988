"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H d_ff=8192 vocab=32064;
phi3-mini text decoder + CLIP ViT-L/14-336 vision frontend
[hf:microsoft/Phi-3-vision-128k-instruct]. The ViT is a stub: the batch
provides 576 precomputed 1024-dim patch embeddings (24×24 grid), which the
in-model projector maps to d_model."""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = register_arch(
    ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        source="hf:microsoft/Phi-3-vision-128k-instruct",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        frontend="vision",
        frontend_dim=1024,
        num_prefix_tokens=576,
        rope_theta=10000.0,
    )
)
