"""The client ensemble A_w (Eq. 2).

Clients are (apply_fn, params) pairs; ``make_logits_all`` builds the
function producing the (K, B, C) stack of client logits that every
downstream component (generator loss, DHS perturbation, EE weight search,
distillation) consumes. It loops over the clients: the ``"looped"`` engine,
kept as the parity baseline. The default engine is the grouped
:class:`repro_torch.core.client_bank.ClientBank`; the method drivers build
either through :func:`repro_torch.core.client_bank.make_ensemble`.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

# The stack dtype every consumer of logits_all sees.
ENSEMBLE_DTYPE = torch.float32


def uniform_weights(n: int, device=None) -> torch.Tensor:
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


def make_logits_all(apply_fns: List[Callable]) -> Callable:
    """Returns f(client_params_list, x) -> (K, B, C) stacked client logits."""

    def logits_all(client_params: Sequence[Any], x: torch.Tensor) -> torch.Tensor:
        outs = [f(p, x).to(ENSEMBLE_DTYPE) for f, p in zip(apply_fns, client_params)]
        return torch.stack(outs, dim=0)

    return logits_all


def ensemble_logits(logits_all: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A_w(x) = Σ_k w_k f_k(x). logits_all: (K, B, C); w: (K,)."""
    return torch.einsum("k,k...->...", w.float(), logits_all.float())
