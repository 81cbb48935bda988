"""Diverse hard-sample construction (DHS, Eq. 9–10).

One backward step through the ensemble seeks the input-space direction that
maximizes ``uᵀA_w(x)`` for a random u ~ Unif[−1,1]^C, then perturbs the
sample by ε along the L2-normalized gradient:

    x̃ = x + ε · ∇_x(uᵀA_w(x)) / ‖∇_x(uᵀA_w(x))‖₂

The gradient is plain autograd through the client CNNs; no kernel is
involved. ``u`` comes from the caller's draw seam
(:mod:`repro_torch.utils.prng`).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.ensemble import ensemble_logits


def diversify(
    logits_all_fn: Callable,
    client_params: Any,
    w: torch.Tensor,
    x: torch.Tensor,
    u: torch.Tensor,
    epsilon: float,
) -> torch.Tensor:
    """Apply Eq. 10 to a batch x (B, ...) with direction u (B, C). Returns x̃
    of the same shape and dtype, detached."""
    with torch.enable_grad():
        x_in = x.detach().requires_grad_()
        ens = ensemble_logits(logits_all_fn(client_params, x_in), w.detach())
        (g,) = torch.autograd.grad(torch.sum(u * ens), x_in)
    flat = g.reshape(g.shape[0], -1).float()
    norm = torch.linalg.vector_norm(flat, dim=-1)[:, None]
    direction = (flat / torch.clamp(norm, min=1e-12)).reshape(g.shape)
    return (x.float() + epsilon * direction).to(x.dtype).detach()
