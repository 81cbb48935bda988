"""Model configuration of the distilled server LM (the port's copy of
``repro.config.model``, dense family).

The port serves the dense decoder family: every field a dense config uses
keeps its JAX name and default. The other families (MoE, SSM, hybrid,
audio, VLM) are not ported yet; :meth:`ModelConfig.validate` refuses them.
One ``backend`` knob ("auto" | "cuda" | "ref", see
:mod:`repro_torch.kernels.dispatch`) routes both attention ops: ``"attn"``
(train/prefill flash attention) and ``"decode"`` (paged Sq=1 decode).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.kernels.dispatch import check_backend

PORTED_FAMILIES = ("dense",)


@dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------------
    name: str
    family: str = "dense"
    source: str = ""  # citation for the assigned config

    # trunk ------------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"  # silu (SwiGLU); gelu is not ported yet

    # attention --------------------------------------------------------------
    rope_theta: float = 10000.0
    qk_norm: bool = False  # True is not ported yet
    causal: bool = True
    sliding_window: int = 0  # 0 = full attention
    attn_logit_softcap: float = 0.0

    # kernel backend for the dispatched attention ops ("attn", "decode")
    backend: str = "auto"

    # numerics -----------------------------------------------------------------
    dtype: str = "bfloat16"  # activations
    param_dtype: str = "float32"
    logit_dtype: str = "float32"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def validate(self) -> None:
        if self.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{self.name}: family {self.family!r} is not ported yet (the port serves {PORTED_FAMILIES})"
            )
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads {self.num_heads} not divisible by kv {self.num_kv_heads}")
        if self.act != "silu":
            raise NotImplementedError(f"{self.name}: act {self.act!r} is not ported yet (the port has SwiGLU)")
        if self.qk_norm:
            raise NotImplementedError(f"{self.name}: qk_norm is not ported yet")
        check_backend(self.backend)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced_variant(cfg: ModelConfig) -> ModelConfig:
    """The CPU-smoke-test variant: 2 layers, d_model <= 128, <= 4 heads,
    head_dim 32 — the same code paths (the JAX ``reduced_variant``, dense
    fields)."""
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return cfg.replace(
        num_layers=2,
        d_model=min(cfg.d_model, 128),
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=min(cfg.d_ff, 256) or 0,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        name=cfg.name + "-smoke",
    )
