"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504
(masked-prediction codebook), encoder-only (same trunk as wav2vec2)
[arXiv:2106.07447]. The conv feature extractor is a stub: the batch
provides 512-dim frame features; no decode (encoder-only)."""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = register_arch(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        source="arXiv:2106.07447",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        act="gelu",
        frontend="audio",
        frontend_dim=512,
        num_prefix_tokens=1,
    )
)
