"""The decoder LM, dense family (the port's copy of
``repro.models.transformer``: the training and serving paths).

A model is a stack of blocks ``(attn, mlp)``: pre-norm attention and a
pre-norm MLP, each with a residual. The JAX package stacks layers by group
(``params["groups"]``, leading axis the layer) and scans over them; the
port keeps one dict per layer in ``params["layers"]`` and loops
(:mod:`repro_torch.convert` moves weights between the two). Weights keep
the JAX einsum layouts.

Training (:func:`lm_loss`) differentiates the f32 parameter leaves
directly: weights are cast to the activation dtype where they are used,
and nothing autograd saved is written in place. :func:`cast_weights` is for
serving only.

The decode state stacks every layer's cache on a leading axis, as the JAX
state does: ``{"k", "v"}`` of shape ``(L, B, cache_len, KH, hd)`` for the
dense per-slot layout, or ``{"k_pages", "v_pages"}`` of shape
``(L, P, page_size, KH, hd)`` for the paged one. Prefill and decode write
the state **in place** (layer ``l`` works on the views ``state[...][l]``)
and return it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_mlp, dense_init, embed_init, init_mlp, rms_norm

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def group_pattern(cfg) -> List[Tuple[str, Optional[str]]]:
    """Per-group (mixer, ffn) pattern; a dense model repeats every layer.
    Refuses, through ``cfg.validate``, what the port does not run yet."""
    cfg.validate()
    return [("attn", "mlp")]


# ---------------------------------------------------------------------------
# init


def init_lm(cfg, gen: torch.Generator, param_dtype=None) -> Dict:
    """Random weights from ``gen`` (on the device the params live on)."""
    dtype = dtype_of(param_dtype or cfg.param_dtype)
    group_pattern(cfg)
    layers = []
    for _ in range(cfg.num_layers):
        zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
        layers.append({
            "attn": attn_lib.init_attention(gen, cfg, dtype),
            "norm1": {"scale": zeros()},
            "mlp": init_mlp(gen, cfg, dtype),
            "norm2": {"scale": zeros()},
        })
    params = {
        "layers": layers,
        "final_norm": {"scale": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)},
        "embed": {"table": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": dense_init(gen, cfg.d_model, (cfg.vocab_size,), dtype)}
    return params


def cast_weights(params, cfg) -> Dict:
    """``params`` with every weight the model casts to the activation dtype
    where it uses it (the attention and MLP projections, the embedding, the
    head) cast once, ahead of time; norm scales keep their dtype. The model
    computes the same values either way; a serving loop saves a cast of
    every weight at every step."""
    dtype = dtype_of(cfg.dtype)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["embed"] = {"table": params["embed"]["table"].to(dtype)}
    if "lm_head" in params:
        out["lm_head"] = {"kernel": params["lm_head"]["kernel"].to(dtype)}
    out["layers"] = [
        {**layer, "attn": {k: (w if k.endswith("_norm") else w.to(dtype)) for k, w in layer["attn"].items()},
         "mlp": {k: w.to(dtype) for k, w in layer["mlp"].items()}}
        for layer in params["layers"]
    ]
    return out


# ---------------------------------------------------------------------------
# embedding / head


def embed_tokens(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    return params["embed"]["table"][tokens].to(dtype_of(cfg.dtype))


def _embed_inputs(params, cfg, batch) -> torch.Tensor:
    """The trunk's input: ``batch["embeds"]`` (B, S, d), synthetic
    embedding-space sequences of the LM-scale Co-Boosting generator path,
    cast to the activation dtype with no token embedding; else the embedded
    ``batch["tokens"]``."""
    if "embeds" in batch:
        return batch["embeds"].to(dtype_of(cfg.dtype))
    return embed_tokens(params, cfg, batch["tokens"])


def head_matrix(params, cfg) -> torch.Tensor:
    """The (d, V) output projection."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["kernel"]


def lm_logits(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Final norm and head in the activation dtype, then cast to the logit
    dtype (f32)."""
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return (x @ head_matrix(params, cfg).to(x.dtype)).to(dtype_of(cfg.logit_dtype))


# ---------------------------------------------------------------------------
# blocks


def _layer_cache(state, i: int):
    return {name: leaf[i] for name, leaf in state.items()}


def _apply_block(p, x, cfg, mode: str, cache, pos, page_table):
    h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    if mode == "train":
        y = attn_lib.attn_train(p["attn"], h, cfg)
    elif mode == "prefill":
        y, _ = attn_lib.attn_prefill(p["attn"], h, cfg, cache)
    else:
        y, _ = attn_lib.attn_decode(p["attn"], h, cfg, cache, pos, page_table=page_table)
    x = x + y
    return x + apply_mlp(p["mlp"], rms_norm(x, p["norm2"]["scale"], cfg.norm_eps), cfg)


def _run_blocks(params, cfg, x, mode: str, state=None, pos=None, page_table=None):
    for i, p in enumerate(params["layers"]):
        cache = None if state is None else _layer_cache(state, i)
        x = _apply_block(p, x, cfg, mode, cache, pos, page_table)
    return x


def lm_forward(params, cfg, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, aux loss = 0 for dense)."""
    x = _run_blocks(params, cfg, _embed_inputs(params, cfg, batch), "train")
    return lm_logits(params, cfg, x), torch.zeros((), device=x.device)


def lm_features(params, cfg, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Post-final-norm trunk features (B, S, d): the LM head factored out,
    so vocab-sized tensors can be made a chunk at a time (the chunked
    distillation loss, ``core.distributed.coboost_distill_loss``)."""
    x = _run_blocks(params, cfg, _embed_inputs(params, cfg, batch), "train")
    return rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps), torch.zeros((), device=x.device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in f32. logits (B, S, V) of any float dtype;
    labels (B, S) int; ``mask`` (B, S) weights the positions (the mean is
    over its sum, at least 1)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def lm_loss(params, cfg, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, {"ce", "moe_aux"})``: CE of the logits against
    ``batch["labels"]`` (masked by ``batch["mask"]`` where given); a dense
    model has no router loss, so the total is the CE."""
    logits, aux = lm_forward(params, cfg, batch)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss, {"ce": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# decode state


def init_lm_state(cfg, batch: int, max_seq: int, dtype=None, *, kv_pages: int = 0, kv_page_size: int = 0, device="cpu"):
    """Every layer's cache stacked on a leading axis: the dense per-slot
    layout, or with ``kv_pages > 0`` a shared pool of that many
    ``kv_page_size``-token pages (the engine's paged layout; decode then
    needs the engine's page table)."""
    dtype = dtype_of(dtype or cfg.dtype)
    group_pattern(cfg)
    if kv_pages > 0:
        one = attn_lib.init_paged_cache(cfg, kv_pages, kv_page_size, dtype, device)
    else:
        one = attn_lib.init_cache(cfg, batch, max_seq, dtype, device)
    return {name: leaf[None].repeat(cfg.num_layers, *([1] * leaf.dim())) for name, leaf in one.items()}


def lm_prefill(params, cfg, batch, state, last_index=None):
    """Consume the whole prompt, fill ``state`` (in place), return the
    logits (B, 1, V) of position ``last_index`` — an int or a per-row (B,)
    vector (the engine pads ragged prompts to a bucket and needs each row's
    true last prompt token) — or of the last position when ``None``."""
    x = _run_blocks(params, cfg, embed_tokens(params, cfg, batch["tokens"]), "prefill", state=state)
    if last_index is None:
        x_last = x[:, -1:]
    else:
        idx = torch.as_tensor(last_index, device=x.device).long().reshape(-1).expand(x.shape[0])
        x_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    return lm_logits(params, cfg, x_last), state


def lm_decode(params, cfg, token, state, pos, page_table=None):
    """One decode step. token: (B, 1); ``pos``: scalar (absolute) or (B,)
    per-row positions. ``page_table`` ((B, W) int32) switches a paged state
    onto the page-table view. Returns (logits (B, 1, V), state)."""
    x = _run_blocks(params, cfg, embed_tokens(params, cfg, token), "decode", state=state, pos=pos, page_table=page_table)
    return lm_logits(params, cfg, x), state
