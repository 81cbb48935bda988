"""Static-batch generation: the serving baseline (the port's copy of
``repro.serve.static``).

Prefill, then ``gen - 1`` decode steps with on-device sampling; the tokens
cross to the host once at the end. The static path always decodes against
the dense per-slot cache (scalar positions, small-SDPA attention), so it is
the cross-layout parity oracle the paged engine's tokens are held against.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.transformer import init_lm_state, lm_decode, lm_prefill
from repro_torch.serve.engine import sample_tokens


@torch.inference_mode()
def static_generate(
    params,
    cfg,
    batch: Dict[str, torch.Tensor],
    gen: int,
    *,
    temperature: float = 0.0,
    max_seq: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``batch["tokens"]``: (B, L) int. Returns (B, gen) int32 on the
    tokens' device."""
    tokens = batch["tokens"]
    b, prompt_len = tokens.shape
    state = init_lm_state(cfg, b, max_seq or (prompt_len + gen), device=tokens.device)
    logits, state = lm_prefill(params, cfg, batch, state)
    tok = sample_tokens(logits[:, -1], generator, temperature)
    out = [tok]
    for i in range(gen - 1):
        logits, state = lm_decode(params, cfg, tok[:, None], state, prompt_len + i)
        tok = sample_tokens(logits[:, -1], generator, temperature)
        out.append(tok)
    return torch.stack(out, dim=1)
