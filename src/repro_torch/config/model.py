"""Model configuration of the distilled server LM (the port's copy of
``repro.config.model``: every family of the reference).

The port serves the dense and MoE decoder families, with or without
qk-norm, the recurrent SSM family (xLSTM's mLSTM/sLSTM blocks, Mamba), the
hybrid one (Mamba with one attention layer per ``attn_every``), the
encoder-only audio family (hubert: frame features in, a codebook head out,
non-causal attention, the tanh-GELU MLP) and the VLM family (a decoder fed
a projected prefix of patch embeddings before its tokens): every field
they use keeps its JAX name and default. The reference's ``scan_layers``
is left out on purpose: it bounds the size of a compiled XLA program, and
the eager port has no such program.
A :class:`~repro_torch.kernels.dispatch.BackendPolicy` in ``backend``
routes the two attention ops, ``"attn"`` (train/prefill flash attention)
and ``"decode"`` (paged Sq=1 decode), each to ``"auto" | "cuda" | "ref"``
(:mod:`repro_torch.kernels.dispatch`); ``backend_for(op)`` reads it. A
plain string given as ``backend`` means that value for both ops.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.kernels.dispatch import BackendPolicy, as_policy

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
ACTS = ("silu", "gelu")
SSM_KINDS = ("mamba", "xlstm")
MOE_IMPLS = ("einsum", "scatter")


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
    act: str = "silu"  # silu (SwiGLU) | gelu (plain two-matrix MLP, tanh GELU; hubert)

    # attention --------------------------------------------------------------
    rope_theta: float = 10000.0
    qk_norm: bool = False
    causal: bool = True
    sliding_window: int = 0  # 0 = full attention
    attn_logit_softcap: float = 0.0

    # MoE --------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # expert hidden dim; 0 => d_ff
    router_aux_coef: float = 0.01
    moe_impl: str = "einsum"  # einsum (GShard dispatch) | scatter (index_add into the capacity buffer)
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 0  # tokens per dispatch group; 0 => one group per sequence

    # SSM / hybrid -----------------------------------------------------------
    ssm_kind: str = ""  # "" | mamba | xlstm
    ssm_state_dim: int = 16  # mamba N
    ssm_conv_dim: int = 4  # mamba depthwise conv width
    ssm_expand: int = 2  # mamba / xLSTM inner expansion
    ssm_chunk: int = 128  # scan chunk length (checkpoint unit; mamba's parallel block)
    dt_rank: int = 0  # mamba dt low-rank; 0 => ceil(d_model / 16)
    attn_every: int = 0  # hybrid: one attention layer per this many (jamba=8)
    moe_every: int = 0  # hybrid: MoE MLP every this many layers (jamba=2)
    slstm_every: int = 0  # xlstm: one sLSTM block per this many (rest mLSTM)
    xlstm_heads: int = 4

    # modality frontend stub ---------------------------------------------------
    frontend: str = ""  # "" | vision | audio
    frontend_dim: int = 0  # raw patch/frame embedding dim fed to the projector
    num_prefix_tokens: int = 0  # patch/frame embeddings the batch provides

    # backend policy for the dispatched ops this model touches ("attn":
    # train/prefill flash attention; "decode": paged Sq=1 decode); a string
    # is coerced to BackendPolicy(default=s)
    backend: BackendPolicy = BackendPolicy()

    # numerics -----------------------------------------------------------------
    dtype: str = "bfloat16"  # activations
    param_dtype: str = "float32"
    remat: bool = True  # recompute each layer in the backward pass of a training step
    logit_dtype: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "backend", as_policy(self.backend))

    def backend_for(self, op: str) -> str:
        """The requested backend for ``op`` (``"attn"`` or ``"decode"``)."""
        return self.backend.for_op(op)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_encoder_only(self) -> bool:
        return self.family == "audio"

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can decode at 500k+ context (SSM/hybrid state or SWA)."""
        return self.ssm_kind != "" or self.sliding_window > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, -(-self.d_model // 16))

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def validate(self) -> None:
        if self.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{self.name}: family {self.family!r} is not ported yet (the port serves {PORTED_FAMILIES})"
            )
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads {self.num_heads} not divisible by kv {self.num_kv_heads}")
        if self.act not in ACTS:
            raise ValueError(f"{self.name}: act {self.act!r} is not one of {ACTS}")
        if self.family == "moe" and not (self.num_experts > 0 and self.experts_per_token > 0):
            raise ValueError(f"{self.name}: a moe config needs num_experts > 0 and experts_per_token > 0")
        if self.family == "hybrid" and not (self.ssm_kind and self.attn_every > 0):
            raise ValueError(f"{self.name}: a hybrid config needs ssm_kind and attn_every > 0")
        if self.family == "ssm" and self.ssm_kind not in SSM_KINDS:
            raise ValueError(f"{self.name}: ssm_kind {self.ssm_kind!r} is not one of {SSM_KINDS}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"{self.name}: moe_impl {self.moe_impl!r} is not one of {MOE_IMPLS}")
        if self.frontend and self.num_prefix_tokens <= 0:
            raise ValueError(f"{self.name}: a {self.frontend} frontend needs num_prefix_tokens > 0")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """The parameter estimate of the reference's ``param_count`` (for
        MODEL_FLOPS = 6 N D): attention, MLP or experts, the recurrent
        mixers and norms a layer, the embedding, the head (an encoder's
        codebook head counts even where a decoder's would be tied) and the
        final norm. Like the reference's, it leaves out the frontend
        projectors and counts an embedding for the encoder too."""
        d, h = self.d_model, self.head_dim_
        attn = d * h * self.num_heads + 2 * d * h * self.num_kv_heads + self.num_heads * h * d
        mlp_dense = (3 if self.act == "silu" else 2) * d * self.d_ff
        mamba = 2 * d * self.ssm_inner + self.ssm_inner * self.ssm_conv_dim
        mamba += self.ssm_inner * (2 * self.ssm_state_dim + 1) + self.ssm_inner * d
        total = 0
        for i in range(self.num_layers):
            hybrid_ssm = self.family == "hybrid" and self.attn_every and i % self.attn_every != self.attn_every - 1
            if self.family == "ssm" and self.ssm_kind == "mamba" or hybrid_ssm:
                layer = mamba
            elif self.family == "ssm" and self.ssm_kind == "xlstm":
                inner = self.ssm_inner
                layer = 2 * d * inner + 4 * inner * inner // max(self.xlstm_heads, 1) + inner * d
            else:
                layer = attn
            use_moe = self.num_experts > 0 and (
                self.family == "moe"
                or (self.family == "hybrid" and self.moe_every and i % self.moe_every == self.moe_every - 1)
            )
            if use_moe:
                e = self.experts_per_token if active_only else self.num_experts
                layer += e * 3 * d * self.expert_d_ff + d * self.num_experts
            elif self.family != "ssm":
                layer += mlp_dense
            total += layer + 2 * d  # norms
        head = self.vocab_size * d if self.is_encoder_only or not self.tie_embeddings else 0
        return total + self.vocab_size * d + head + d


def reduced_variant(cfg: ModelConfig) -> ModelConfig:
    """The CPU-smoke-test variant: 2 layers (one interleave group of
    ``attn_every`` layers for a hybrid, ``max(2, slstm_every)`` for xLSTM,
    with at most 4 xLSTM heads), d_model <= 128, <= 4 heads, head_dim 32,
    <= 4 experts, top <= 2, <= 16 prefix tokens, scan chunk 16, no remat —
    the same code paths (the JAX ``reduced_variant``, on the fields the
    port has)."""
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    kw = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 128),
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=min(cfg.d_ff, 256) or 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        moe_d_ff=min(cfg.moe_d_ff, 128) if cfg.moe_d_ff else 0,
        num_prefix_tokens=min(cfg.num_prefix_tokens, 16) if cfg.num_prefix_tokens else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        ssm_chunk=16,
        moe_group_size=0,
        remat=False,
        name=cfg.name + "-smoke",
    )
    if cfg.family == "hybrid":
        kw.update(num_layers=cfg.attn_every, attn_every=cfg.attn_every, moe_every=cfg.moe_every)
    if cfg.family == "ssm" and cfg.ssm_kind == "xlstm" and cfg.slstm_every:
        kw.update(num_layers=max(2, cfg.slstm_every), xlstm_heads=min(cfg.xlstm_heads, 4))
    return cfg.replace(**kw)
