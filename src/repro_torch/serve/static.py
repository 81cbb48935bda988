"""Static-batch generation: the serving baseline (the port's copy of
``repro.serve.static``).

Prefill, then ``gen - 1`` decode steps with on-device sampling; the tokens
cross to the host once at the end. The static path always decodes against
the dense per-slot cache (scalar positions, small-SDPA attention), so it is
the cross-layout parity oracle the paged engine's tokens are held against.
It is also the path a VLM is served by (the engine refuses one): its
``batch["prefix"]`` is fed at prefill, so the cache holds P more
positions and decode positions start at the prompt's length plus P.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.transformer import init_lm_state, lm_decode, lm_prefill
from repro_torch.serve.engine import sample_tokens, shard_state
from repro_torch.sharding.partition import mesh_context


def static_generate(
    params,
    cfg,
    batch: Dict[str, torch.Tensor],
    gen: int,
    *,
    temperature: float = 0.0,
    max_seq: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> torch.Tensor:
    """``batch["tokens"]``: (B, L) int; a VLM's ``batch["prefix"]``: (B, P,
    frontend_dim). Returns (B, gen) int32 on the tokens' device. With a
    ``mesh``, ``params`` are DTensors on it (``engine.shard_params``) and
    the cache is placed by the engine state's rules."""
    with torch.inference_mode() if mesh is None else torch.no_grad(), mesh_context(mesh):
        return _generate(params, cfg, batch, gen, temperature, max_seq, generator, mesh)


def _generate(params, cfg, batch, gen, temperature, max_seq, generator, mesh) -> torch.Tensor:
    tokens = batch["tokens"]
    b, prompt_len = tokens.shape
    prefix = batch["prefix"].shape[1] if "prefix" in batch else 0
    base = prompt_len + prefix  # the first decode position
    state = shard_state(init_lm_state(cfg, b, (max_seq or (prompt_len + gen)) + prefix, device=tokens.device), mesh)
    logits, state = lm_prefill(params, cfg, batch, state)
    tok = sample_tokens(logits[:, -1], generator, temperature)
    out = [tok]
    for i in range(gen - 1):
        logits, state = lm_decode(params, cfg, tok[:, None], state, base + i)
        tok = sample_tokens(logits[:, -1], generator, temperature)
        out.append(tok)
    return torch.stack(out, dim=1)
