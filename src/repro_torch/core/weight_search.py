"""Ensemble-enhancement weight search (EE, Eq. 11–12).

One sign-gradient step on the ensembling weights per synthetic batch:

    w ← Normalize(w − μ · sign(∇_w L_w(w)))

where L_w is the CE of the weighted ensemble on the (hard) synthetic batch
and Normalize clips to [0, 1] and renormalizes to the simplex. L_w and its
``w`` gradient run through the fused ``ghm_ce`` op with ``weighted=False``;
the ``w`` cotangent comes straight from its backward kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ghm_ce


def normalize_weights(w: torch.Tensor) -> torch.Tensor:
    w = torch.clamp(w, 0.0, 1.0)
    return w / torch.clamp(torch.sum(w), min=1e-12)


def weight_loss(w, logits_all, labels, backend: str = "auto") -> torch.Tensor:
    """L_w (Eq. 11) on precomputed client logits (K, B, C)."""
    return torch.mean(ghm_ce(logits_all, labels, w, weighted=False, backend=backend))


def weight_grad(w, logits_all, labels, backend: str = "auto") -> torch.Tensor:
    """∇_w L_w."""
    with torch.enable_grad():
        w_in = w.detach().requires_grad_()
        (g,) = torch.autograd.grad(weight_loss(w_in, logits_all.detach(), labels, backend), w_in)
    return g


def update_weights(w, logits_all, labels, mu: float, backend: str = "auto") -> torch.Tensor:
    """One Eq. 12 step. ``mu`` is the paper's step size (0.1/n by default)."""
    g = weight_grad(w, logits_all, labels, backend)
    return normalize_weights(w - mu * torch.sign(g))
