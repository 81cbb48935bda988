"""The hard-sample-enhanced generator loss (Eq. 5–8) over the client stack.

Both terms run through the fused loss ops, so neither pass materializes
A_w on the kernel backends: L_H through ``ghm_ce`` with the difficulty
weight held constant (GHM usage), L_A through ``ensemble_kl``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ensemble_kl, ghm_ce


def ghs_loss(logits_all, w, labels, use_ghs: bool = True, backend: str = "auto") -> torch.Tensor:
    """L_H (Eq. 6): difficulty-weighted CE of A_w, the difficulty
    d = 1 − σ(A_w)_y (Eq. 5) held constant. With ``use_ghs=False`` the plain
    CE of Eq. 3."""
    return torch.mean(
        ghm_ce(logits_all, labels, w, weighted=use_ghs, backend=backend, stop_difficulty_grad=True)
    )


def adversarial_loss(logits_all, w, server_logits, temperature: float = 1.0, backend: str = "auto") -> torch.Tensor:
    """L_A (Eq. 7): −KL(A_w(x) ‖ f_S(x)) — the generator *maximizes* the
    ensemble/server disagreement."""
    return -torch.mean(ensemble_kl(logits_all, server_logits, w, temperature=temperature, backend=backend))


def generator_loss(
    logits_all: torch.Tensor,
    w: torch.Tensor,
    server_logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    beta: float = 1.0,
    use_ghs: bool = True,
    use_adv: bool = True,
    kl_temperature: float = 1.0,
    backend: str = "auto",
) -> torch.Tensor:
    """L(θ_G) = L_H + β·L_A (Eq. 8)."""
    loss = ghs_loss(logits_all, w, labels, use_ghs, backend)
    if use_adv:
        loss = loss + beta * adversarial_loss(logits_all, w, server_logits, kl_temperature, backend)
    return loss
