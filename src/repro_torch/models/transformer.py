"""The LM (the port's copy of ``repro.models.transformer``: the training
and serving paths), for all six families of the reference: the dense,
MoE, SSM and hybrid decoders, the audio encoder and the VLM decoder.

A model is a stack of blocks ``(mixer, ffn)``: a pre-norm mixer and a
pre-norm FFN, each with a residual. The mixer is attention, Mamba
(:mod:`repro_torch.models.mamba`) or an xLSTM block, mLSTM or sLSTM
(:mod:`repro_torch.models.xlstm`); the FFN is the SwiGLU ``mlp``, the
``moe`` of :mod:`repro_torch.models.moe` (whose router loss every block
returns and the stack sums), or none (an xLSTM block carries its own
projections, and has no ``norm2``). :func:`layer_kinds` derives the
per-layer pattern from the config; it repeats every
:func:`group_period` layers (jamba's attention layer sits at
``i % attn_every == attn_every // 2``). The JAX package stacks layers by
group (``params["groups"]``, leading axis the group) and scans over them;
the port keeps one dict per layer in ``params["layers"]`` and loops
(:mod:`repro_torch.convert` moves weights between the two). Weights keep
the JAX einsum layouts.

The input of the trunk (:func:`_embed_inputs`) is the embedded
``batch["tokens"]`` for a decoder; for the encoder-only audio family
(hubert) ``batch["frames"]`` (B, S, frontend_dim), projected to d_model by
``frames_proj`` (the stub frontend: frame features come precomputed), with
a codebook head ``pred_head`` in place of the embedding and ``lm_head``;
for the VLM family a ``batch["prefix"]`` (B, P, frontend_dim) of patch
embeddings, projected by ``prefix_proj`` and put before the tokens. Prefill
feeds the prefix too (decode positions then start at the prompt's length
plus P), and :func:`lm_loss` drops the prefix positions' logits.

Training (:func:`lm_loss`) differentiates the f32 parameter leaves
directly: weights are cast to the activation dtype where they are used,
and nothing autograd saved is written in place. With ``cfg.remat`` (the
reference's default) each layer of a training forward runs under
``torch.utils.checkpoint`` when gradients are on, so the backward pass
recomputes it instead of keeping its activations; the recurrent mixers
also checkpoint each scan chunk inside it. :func:`cast_weights` is for
serving only.

The decode state keeps one entry per leaf kind, stacked on a leading axis
over the layers of that kind, with the slot axis at dim 1: the attention
caches over the attention layers only, ``{"k", "v"}`` of shape
``(L_attn, B, cache_len, KH, hd)`` for the dense per-slot layout or
``{"k_pages", "v_pages"}`` of shape ``(L_attn, P, page_size, KH, hd)`` for
the paged one; each recurrent carry over the layers of its mixer,
``"mlstm.C"``, ``"mlstm.n"``, ``"mlstm.m"``, ``"slstm.h"``, ``"slstm.c"``,
``"slstm.n"``, ``"slstm.m"``, ``"mamba.conv"`` and ``"mamba.h"``, each
``(L_mixer, B, ...)`` and per slot in either layout. Prefill and decode
write the state **in place** (layer ``l`` works on views of its rows) and
return it. Prefill starts every recurrent carry from zeros, never from the
rows it overwrites.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import apply_mlp, dense_init, embed_init, init_mlp, rms_norm
from repro_torch.sharding.partition import _mesh_axes, constrain, is_dtensor, replicated, whole

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def layer_kinds(cfg) -> List[Tuple[str, Optional[str]]]:
    """Per-layer (mixer, ffn) pattern of the whole network. Refuses,
    through ``cfg.validate``, what the port does not run yet."""
    cfg.validate()
    kinds: List[Tuple[str, Optional[str]]] = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":
            if cfg.ssm_kind == "mamba":
                kinds.append(("mamba", None))
            elif cfg.slstm_every and i % cfg.slstm_every == cfg.slstm_every - 1:
                kinds.append(("slstm", None))  # xlstm: sLSTM every `slstm_every`, the rest mLSTM
            else:
                kinds.append(("mlstm", None))
        elif cfg.family == "hybrid":
            mixer = "attn" if i % cfg.attn_every == cfg.attn_every // 2 else "mamba"
            moe = cfg.moe_every and i % cfg.moe_every == cfg.moe_every - 1 and cfg.num_experts
            kinds.append((mixer, "moe" if moe else "mlp"))
        elif cfg.family == "moe":
            kinds.append(("attn", "moe"))
        else:
            kinds.append(("attn", "mlp"))
    return kinds


def group_period(cfg) -> int:
    """The pattern's period: 1 for dense and MoE models, ``attn_every``
    (grown to a multiple of ``moe_every``) for a hybrid, ``slstm_every``
    for xLSTM."""
    if cfg.family == "hybrid":
        period = cfg.attn_every
        if cfg.moe_every:
            while period % cfg.moe_every:
                period += cfg.attn_every
        return period
    if cfg.family == "ssm" and cfg.ssm_kind == "xlstm" and cfg.slstm_every:
        return cfg.slstm_every
    return 1


def group_pattern(cfg) -> List[Tuple[str, Optional[str]]]:
    """The (mixer, ffn) pattern of one group of :func:`group_period` layers."""
    return layer_kinds(cfg)[: group_period(cfg)]


def num_groups(cfg) -> int:
    p = group_period(cfg)
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a whole number of groups of {p}")
    return cfg.num_layers // p


_MIXER_KEY = {"attn": "attn", "mamba": "mamba", "mlstm": "xlstm", "slstm": "xlstm"}
_MIXER_INIT = {
    "attn": attn_lib.init_attention,
    "mamba": mamba_lib.init_mamba,
    "mlstm": xlstm_lib.init_mlstm,
    "slstm": xlstm_lib.init_slstm,
}
#: Leaves kept in their own dtype by :func:`cast_weights`: those the model
#: uses without a cast (the f32 router, xLSTM gates and recurrence, Mamba's
#: dt bias, A and skip), beside the norm scales.
_KEEP_DTYPE = ("router", "gates", "r", "dt_bias", "A_log", "D")


# ---------------------------------------------------------------------------
# init


def init_lm(cfg, gen: torch.Generator, param_dtype=None) -> Dict:
    """Random weights from ``gen`` (on the device the params live on): one
    dict a layer, by its kind."""
    dtype = dtype_of(param_dtype or cfg.param_dtype)
    kinds = layer_kinds(cfg)
    num_groups(cfg)
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
    layers = []
    for mixer, ffn in kinds:
        layer = {_MIXER_KEY[mixer]: _MIXER_INIT[mixer](gen, cfg, dtype), "norm1": {"scale": zeros()}}
        if ffn is not None:
            layer[ffn] = (moe_lib.init_moe if ffn == "moe" else init_mlp)(gen, cfg, dtype)
            layer["norm2"] = {"scale": zeros()}
        layers.append(layer)
    params = {
        "layers": layers,
        "final_norm": {"scale": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)},
    }
    if cfg.is_encoder_only:
        params["frames_proj"] = {"projector": {"kernel": dense_init(gen, cfg.frontend_dim, (cfg.d_model,), dtype)}}
        params["pred_head"] = {"kernel": dense_init(gen, cfg.d_model, (cfg.vocab_size,), dtype)}
    else:
        params["embed"] = {"table": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)}
        if not cfg.tie_embeddings:
            params["lm_head"] = {"kernel": dense_init(gen, cfg.d_model, (cfg.vocab_size,), dtype)}
    if cfg.frontend == "vision":
        params["prefix_proj"] = {"projector": {"kernel": dense_init(gen, cfg.frontend_dim, (cfg.d_model,), dtype)}}
    return params


def cast_weights(params, cfg) -> Dict:
    """``params`` with every weight the model casts to the activation dtype
    where it uses it (the attention, MLP, expert, xLSTM and Mamba
    projections, the conv, the embedding, the heads, the frontend
    projectors) cast once, ahead of time; norm scales (the qk-norm
    ``q_norm``/``k_norm`` too) and the leaves of ``_KEEP_DTYPE`` keep their
    dtype. The model computes the same values either way; a serving loop
    saves a cast of every weight at every step."""
    dtype = dtype_of(cfg.dtype)
    out = {k: v for k, v in params.items() if k != "layers"}
    if "embed" in params:
        out["embed"] = {"table": params["embed"]["table"].to(dtype)}
    for name in ("lm_head", "pred_head"):
        if name in params:
            out[name] = {"kernel": params[name]["kernel"].to(dtype)}
    for name in ("frames_proj", "prefix_proj"):
        if name in params:
            out[name] = {"projector": {"kernel": params[name]["projector"]["kernel"].to(dtype)}}

    def cast(leaves):
        return {k: (w if k.endswith("_norm") or k in _KEEP_DTYPE else w.to(dtype)) for k, w in leaves.items()}

    out["layers"] = [
        {**layer, **{n: cast(layer[n]) for n in ("attn", "mlp", "moe", "xlstm", "mamba") if n in layer}}
        for layer in params["layers"]
    ]
    return out


# ---------------------------------------------------------------------------
# embedding / head


def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    # (an embedding lookup, which DTensor shards by vocab rows; the ids go
    # in whole, tiny beside the rows they select)
    return F.embedding(whole(tokens), params["embed"]["table"]).to(dtype_of(cfg.dtype))


def _project(x, proj, dtype) -> torch.Tensor:
    """A frontend projector: ``einsum("bsf,fd->bsd")`` in the activation dtype."""
    return x.to(dtype) @ proj["projector"]["kernel"].to(dtype)


def _embed_inputs(params, cfg, batch) -> torch.Tensor:
    """The trunk's input: ``batch["embeds"]`` (B, S, d), synthetic
    embedding-space sequences of the LM-scale Co-Boosting generator path,
    cast to the activation dtype with no token embedding; for an encoder,
    the projected ``batch["frames"]``; else the embedded
    ``batch["tokens"]``, after the projected ``batch["prefix"]`` where a
    vision config is given one.

    The reference constrains it to ``("batch", "seq", None)``; here the
    sequence stays whole on every rank: every projection flattens (B, S)
    into a matmul's rows, which DTensor cannot do from a sequence split
    without a gather (torch 2.11 refuses the op outright), and the kernels
    take whole sequences anyway."""
    dtype = dtype_of(cfg.dtype)
    if "embeds" in batch:
        return constrain(batch["embeds"].to(dtype), "batch", None, None)
    if cfg.is_encoder_only:
        return constrain(_project(batch["frames"], params["frames_proj"], dtype), "batch", None, None)
    x = embed_tokens(params, cfg, batch["tokens"])
    if cfg.frontend == "vision" and "prefix" in batch:
        x = torch.cat([_project(batch["prefix"], params["prefix_proj"], dtype), x], dim=1)
    return constrain(x, "batch", None, None)


def head_matrix(params, cfg) -> torch.Tensor:
    """The (d, V) output projection (an encoder's codebook head)."""
    if cfg.is_encoder_only:
        return params["pred_head"]["kernel"]
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["kernel"]


def lm_logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Final norm and head in the activation dtype, then cast to the logit
    dtype (f32)."""
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = (x @ head_matrix(params, cfg).to(x.dtype)).to(dtype_of(cfg.logit_dtype))
    # Shard the (B, S, V) logits over the model axis by vocab when it
    # divides, else by SEQUENCE (granite's odd 49155 vocab), as the
    # reference does.
    model = _mesh_axes().get("model", 1)
    if model > 1 and cfg.vocab_size % model and logits.shape[1] > 1:
        return constrain(logits, "batch", "seq", None)
    return constrain(logits, "batch", None, "vocab")


# ---------------------------------------------------------------------------
# blocks


#: The carry leaves of each recurrent mixer, in the decode state as
#: ``"{mixer}.{leaf}"``.
RECURRENT_LEAVES = {"mlstm": ("C", "n", "m"), "slstm": ("h", "c", "n", "m"), "mamba": ("conv", "h")}
_ATTN_LEAVES = ("k", "v", "k_pages", "v_pages")


def layer_slots(cfg) -> List[Tuple[str, Optional[str], int]]:
    """Per layer: its mixer, its ffn and its index among the layers of that
    mixer (the row of the decode state's leaves it owns)."""
    seen: Dict[str, int] = {}
    out = []
    for mixer, ffn in layer_kinds(cfg):
        out.append((mixer, ffn, seen.get(mixer, 0)))
        seen[mixer] = seen.get(mixer, 0) + 1
    return out


def _layer_cache(state, mixer: str, j: int):
    """Layer ``j`` of ``mixer``'s views of the decode state."""
    if mixer == "attn":
        return {name: state[name][j] for name in _ATTN_LEAVES if name in state}
    return {leaf: state[f"{mixer}.{leaf}"][j] for leaf in RECURRENT_LEAVES[mixer]}


def _apply_mixer(p, h, cfg, mixer: str, mode: str, cache, pos, page_table):
    """mode: train | prefill | decode | extend. A recurrent mixer writes its
    final carry into ``cache`` (prefill from zeros, decode from ``cache``)."""
    if mixer == "attn":
        if mode == "train":
            return attn_lib.attn_train(p["attn"], h, cfg)
        if mode == "prefill":
            return attn_lib.attn_prefill(p["attn"], h, cfg, cache)[0]
        if mode == "extend":
            return attn_lib.attn_extend(p["attn"], h, cfg, cache, pos, page_table)[0]
        return attn_lib.attn_decode(p["attn"], h, cfg, cache, pos, page_table=page_table)[0]
    if mode == "extend":
        # a recurrent carry has no per-position cache to continue from: the
        # engine keeps ssm and hybrid archs off the prefix-cache and
        # speculative paths
        raise ValueError(f"extend mode requires attention mixers, got {mixer!r}")
    if mixer == "mamba":
        fwd, wp = mamba_lib.mamba_forward, p["mamba"]
    else:
        fwd, wp = (xlstm_lib.mlstm_forward if mixer == "mlstm" else xlstm_lib.slstm_forward), p["xlstm"]
    if mode == "train":
        return fwd(wp, h, cfg)
    y, new = fwd(wp, h, cfg, state=cache if mode == "decode" else None, return_state=True)
    for leaf, t in new.items():
        attn_lib.write_rows(cache[leaf], (slice(None),), t)
    return y


def _apply_block(p, x, cfg, mixer: str, mode: str, cache, pos, page_table):
    """One block; returns ``(x, aux)``, aux the block's router loss (None
    for a block without a MoE)."""
    x = x + _apply_mixer(p, rms_norm(x, p["norm1"]["scale"], cfg.norm_eps), cfg, mixer, mode, cache, pos, page_table)
    if "norm2" not in p:
        return x, None
    h = rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_lib.moe_apply(p["moe"], h, cfg)
        return x + y, aux
    return x + apply_mlp(p["mlp"], h, cfg), None


def _run_blocks(params, cfg, x, mode: str, state=None, pos=None, page_table=None):
    """Every layer in turn; returns ``(x, the router losses summed over the
    layers)``, None where no layer has a router. A training forward with
    ``cfg.remat`` and gradients on checkpoints each layer (its router loss
    among the checkpointed outputs; the blocks draw no random numbers, so
    no RNG state is kept); the serving modes never do, since they write the
    state in place."""
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    aux = None
    for p, (mixer, _, j) in zip(params["layers"], layer_slots(cfg)):
        if remat:
            x, a = checkpoint(_apply_block, p, x, cfg, mixer, mode, None, pos, page_table,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            cache = None if state is None else _layer_cache(state, mixer, j)
            x, a = _apply_block(p, x, cfg, mixer, mode, cache, pos, page_table)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _aux_or_zero(aux, x) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux


def lm_forward(params, cfg, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, the router loss summed over
    the layers; 0 for a dense model)."""
    x, aux = _run_blocks(params, cfg, _embed_inputs(params, cfg, batch), "train")
    return lm_logits(params, cfg, x), _aux_or_zero(aux, x)


def lm_features(params, cfg, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Post-final-norm trunk features (B, S, d): the LM head factored out,
    so vocab-sized tensors can be made a chunk at a time (the chunked
    distillation loss, ``core.distributed.coboost_distill_loss``)."""
    x, aux = _run_blocks(params, cfg, _embed_inputs(params, cfg, batch), "train")
    return rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps), _aux_or_zero(aux, x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in f32. logits (B, S, V) of any float dtype;
    labels (B, S) int; ``mask`` (B, S) weights the positions (the mean is
    over its sum, at least 1)."""
    logits = logits.float()
    if is_dtensor(logits):
        nll = _nll_sharded(logits, labels)
    else:
        nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _nll_sharded(logits, labels) -> torch.Tensor:
    """Per-position NLL (B, S) of DTensor logits: vocab-parallel
    (``loss_parallel``: the log-sum-exp and the label's logit reduced across
    the model axis, no rank holding the whole vocab) where the vocab dim is
    sharded, DTensor's own cross-entropy otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.parallel import loss_parallel

    b, s, v = logits.shape
    flat = logits.reshape(b * s, v)
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in flat.placements]
    target = replicated(labels.reshape(-1).long(), flat.device_mesh).redistribute(flat.device_mesh, rows)
    nll = lambda: F.cross_entropy(flat, target, reduction="none")
    if any(isinstance(p, Shard) and p.dim == 1 for p in flat.placements):
        with loss_parallel():
            return nll().reshape(b, s)
    return nll().reshape(b, s)


def lm_loss(params, cfg, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(ce + router_aux_coef · aux, {"ce", "moe_aux"})``: CE of the
    logits against ``batch["labels"]`` (masked by ``batch["mask"]`` where
    given) plus the weighted router loss; a dense model's aux is 0, so its
    total is its CE. A VLM's loss is on the text positions only: the
    prefix positions' logits are dropped."""
    logits, aux = lm_forward(params, cfg, batch)
    if cfg.frontend == "vision" and "prefix" in batch:
        logits = logits[:, batch["prefix"].shape[1]:]
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + cfg.router_aux_coef * aux, {"ce": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# decode state


def init_lm_state(cfg, batch: int, max_seq: int, dtype=None, *, kv_pages: int = 0, kv_page_size: int = 0, device="cpu"):
    """The decode state: the attention caches stacked over the attention
    layers (the dense per-slot layout, or with ``kv_pages > 0`` a shared
    pool of that many ``kv_page_size``-token pages: the engine's paged
    layout, whose decode needs the engine's page table), and each
    recurrent carry stacked over the layers of its mixer, ``batch`` rows a
    layer in either layout."""
    dtype = dtype_of(dtype or cfg.dtype)
    counts: Dict[str, int] = {}
    for mixer, _ in layer_kinds(cfg):
        counts[mixer] = counts.get(mixer, 0) + 1
    state: Dict[str, torch.Tensor] = {}
    for mixer, n in counts.items():
        if mixer == "attn":
            if kv_pages > 0:
                one = attn_lib.init_paged_cache(cfg, kv_pages, kv_page_size, dtype, device)
            else:
                one = attn_lib.init_cache(cfg, batch, max_seq, dtype, device)
        elif mixer == "mamba":
            one = {f"mamba.{k}": v for k, v in mamba_lib.init_mamba_state(cfg, batch, dtype, device).items()}
        else:
            init = xlstm_lib.init_mlstm_state if mixer == "mlstm" else xlstm_lib.init_slstm_state
            one = {f"{mixer}.{k}": v for k, v in init(cfg, batch, device).items()}
        state.update({name: leaf[None].repeat(n, *([1] * leaf.dim())) for name, leaf in one.items()})
    return state


def shard_lm_state(state):
    """Apply the decode-state sharding constraints (dense KV caches
    sequence-sharded, as :func:`repro_torch.sharding.decode_state_specs`
    places them) to a state's attention caches, as copies. The paged pool
    leaves have no batch dim and keep their placement. The identity without
    a mesh."""
    return {
        name: constrain(leaf, None, "batch", "seq", None, None) if name in ("k", "v") and leaf.dim() == 5 else leaf
        for name, leaf in state.items()
    }


def lm_prefill(params, cfg, batch, state, last_index=None):
    """Consume the whole prompt (a VLM's prefix before its tokens), fill
    ``state`` (in place), return the logits (B, 1, V) of position
    ``last_index`` — an int or a per-row (B,) vector (the engine pads
    ragged prompts to a bucket and needs each row's true last prompt
    token) — or of the last position when ``None``. A recurrent carry
    absorbs every position it is fed, pad included: the engine prefills a
    recurrent arch to its exact prompt length."""
    x, _ = _run_blocks(params, cfg, _embed_inputs(params, cfg, batch), "prefill", state=state)
    if last_index is None:
        x_last = x[:, -1:]
    else:
        idx = torch.as_tensor(last_index, device=x.device).long().reshape(-1).expand(x.shape[0])
        x_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    return lm_logits(params, cfg, x_last), state


def lm_extend(params, cfg, tokens, state, pos, page_table):
    """Multi-token continuation against a paged state: consume ``tokens``
    (B, S) starting at per-row positions ``pos`` (B,), write their K/V into
    the pages (in place) and return the logits of every fed position
    ((B, S, V)) and the state. The primitive behind prefix-cache tail
    prefill (the tokens the splice did not cover; the true last row's
    logits) and speculative verify (every draft's predecessor logits)."""
    x = constrain(embed_tokens(params, cfg, tokens), "batch", None, None)
    x, _ = _run_blocks(params, cfg, x, "extend", state=state, pos=pos, page_table=page_table)
    return lm_logits(params, cfg, x), state


def lm_decode(params, cfg, token, state, pos, page_table=None):
    """One decode step. token: (B, 1); ``pos``: scalar (absolute) or (B,)
    per-row positions. ``page_table`` ((B, W) int32) switches a paged state
    onto the page-table view. Returns (logits (B, 1, V), state)."""
    x = constrain(embed_tokens(params, cfg, token), "batch", None, None)
    x, _ = _run_blocks(params, cfg, x, "decode", state=state, pos=pos, page_table=page_table)
    return lm_logits(params, cfg, x), state
