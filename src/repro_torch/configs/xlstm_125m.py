"""xlstm-125m [ssm] — 12L d_model=768 4 heads vocab=50304; mLSTM blocks
with one sLSTM block per 4 (the paper's mixed [m:s] stacking)
[arXiv:2405.04517]. d_ff=0: xLSTM blocks carry their own projections."""
from repro_torch.config.model import ModelConfig
from repro_torch.config.registry import register_arch

CONFIG = register_arch(
    ModelConfig(
        name="xlstm-125m",
        family="ssm",
        source="arXiv:2405.04517",
        ssm_kind="xlstm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        slstm_every=4,
        xlstm_heads=4,
        ssm_expand=2,
        tie_embeddings=True,
    )
)
