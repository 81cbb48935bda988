"""Plain PyTorch versions of the fused GHM-weighted CE kernels.

``ghm_ce_ref`` is the oracle the ``"ref"`` backend differentiates with plain
autograd. ``ghm_ce_fwd_ref`` and ``ghm_ce_bwd_ref`` compute what the
forward and backward kernels compute; the wrappers use them for CPU tensors
and ``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

import torch


def _ensemble(client_logits, w):
    return torch.einsum("k,kbv->bv", w.float(), client_logits.float())


def ghm_ce_ref(
    client_logits: torch.Tensor,
    labels: torch.Tensor,
    w: torch.Tensor,
    weighted: bool = True,
    stop_difficulty_grad: bool = False,
) -> torch.Tensor:
    """client_logits: (K, B, V); labels: (B,); w: (K,). Per-sample d·CE
    (Eq. 5–6), or plain CE with ``weighted=False``. ``stop_difficulty_grad``
    treats d(x) as a constant under autograd (the Eq. 6 generator-loss
    convention)."""
    t = _ensemble(client_logits, w)
    lse = torch.logsumexp(t, dim=-1)
    ly = torch.gather(t, 1, labels.long()[:, None])[:, 0]
    nll = lse - ly
    if not weighted:
        return nll
    d = 1.0 - torch.exp(ly - lse)
    if stop_difficulty_grad:
        d = d.detach()
    return d * nll


def ghm_ce_fwd_ref(client_logits, labels, w, weighted: bool = True):
    """``(out, lse, ly)``, each (B,) f32: the loss, the ensemble logsumexp
    and the label logit."""
    t = _ensemble(client_logits, w)
    lse = torch.logsumexp(t, dim=-1)
    ly = torch.gather(t, 1, labels.long()[:, None])[:, 0]
    nll = lse - ly
    if weighted:
        nll = (1.0 - torch.exp(ly - lse)) * nll
    return nll, lse, ly


def ghm_ce_bwd_ref(client_logits, labels, w, g, lse, ly, weighted: bool = True, stop_difficulty_grad: bool = False):
    """``(g_client, g_w)`` for the per-sample cotangent ``g`` (B,):
    ``g_t = g·coeff·(p − onehot)`` with ``coeff`` 1 (plain CE), ``1 − p_y``
    (difficulty held constant) or ``1 − p_y + p_y·nll`` (full gradient);
    ``g_client = w_k·g_t``, ``g_w = ⟨g_t, client_k⟩``."""
    t = _ensemble(client_logits, w)
    p = torch.exp(t - lse[:, None])
    onehot = torch.nn.functional.one_hot(labels.long(), t.shape[-1]).float()
    if not weighted:
        coeff = torch.ones_like(lse)
    else:
        py = torch.exp(ly - lse)
        coeff = 1.0 - py
        if not stop_difficulty_grad:
            coeff = coeff + py * (lse - ly)
    g_t = (g.float() * coeff)[:, None] * (p - onehot)
    g_cl = w.float()[:, None, None] * g_t[None]
    g_w = torch.einsum("kbv,bv->k", client_logits.float(), g_t)
    return g_cl.to(client_logits.dtype), g_w.to(w.dtype)
