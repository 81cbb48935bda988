"""The client ensemble A_w (Eq. 2).

Clients are (apply_fn, params) pairs; ``make_logits_all`` builds the
function producing the (K, B, C) stack of client logits that every
downstream component (generator loss, DHS perturbation, EE weight search,
distillation) consumes. It loops over the clients: the ``"looped"`` engine,
kept as the parity baseline. The default engine is the grouped
:class:`repro_torch.core.client_bank.ClientBank`; the method drivers build
either through :func:`repro_torch.core.client_bank.make_ensemble`.
``make_logits_all_stacked`` is the homogeneous form: one
``torch.func.vmap`` over a stacked param tree.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from repro_torch.sharding.partition import is_dtensor, replicated
from repro_torch.utils.trees import vmap_dims

# The stack dtype every consumer of logits_all sees.
ENSEMBLE_DTYPE = torch.float32


def uniform_weights(n: int, device=None) -> torch.Tensor:
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


def data_amount_weights(sizes: Sequence[int], device=None) -> torch.Tensor:
    """w_k ∝ n_k: each client weighted by its share of the data."""
    s = torch.as_tensor(sizes, dtype=torch.float32, device=device)
    return s / torch.sum(s)


def make_logits_all(apply_fns: List[Callable]) -> Callable:
    """Returns f(client_params_list, x) -> (K, B, C) stacked client logits."""

    def logits_all(client_params: Sequence[Any], x: torch.Tensor) -> torch.Tensor:
        outs = [f(p, x).to(ENSEMBLE_DTYPE) for f, p in zip(apply_fns, client_params)]
        return torch.stack(outs, dim=0)

    return logits_all


def make_logits_all_stacked(apply_fn: Callable) -> Callable:
    """Homogeneous fast path: returns f(stacked_params, x) -> (K, B, C), one
    ``torch.func.vmap`` of ``apply_fn`` over a param tree whose tensor
    leaves carry the clients on axis 0 (``tree_stack``; non-tensor leaves,
    a block's ``"stride"``, are shared)."""

    def logits_all(stacked_params: Any, x: torch.Tensor) -> torch.Tensor:
        dims = (vmap_dims(stacked_params), None)
        return torch.func.vmap(apply_fn, in_dims=dims)(stacked_params, x).to(ENSEMBLE_DTYPE)

    return logits_all


def ensemble_logits(logits_all: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A_w(x) = Σ_k w_k f_k(x). logits_all: (K, B, C); w: (K,). A stack
    split over the clients (a DTensor, the grouped bank's under a mesh)
    gives a partial sum on each rank, made whole: a plain tensor, the same
    on every rank, for the plain generator and DHS that read it."""
    if is_dtensor(logits_all):
        w = replicated(w.float(), logits_all.device_mesh)
        return torch.einsum("k,k...->...", w, logits_all.float()).full_tensor()
    return torch.einsum("k,k...->...", w.float(), logits_all.float())


def ensemble_accuracy(logits_all: torch.Tensor, w: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The share of rows whose A_w argmax is the label (a 0-d f32 tensor)."""
    pred = torch.argmax(ensemble_logits(logits_all, w), dim=-1)
    return (pred == torch.as_tensor(labels, device=pred.device)).float().mean()
