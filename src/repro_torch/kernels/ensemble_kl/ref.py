"""Plain PyTorch versions of the fused ensemble-KL kernels.

``ensemble_kl_ref`` is the oracle the ``"ref"`` backend differentiates with
plain autograd. ``ensemble_kl_fwd_ref`` and ``ensemble_kl_bwd_ref`` compute
what the forward and backward kernels compute (outputs, residuals and
cotangents in the kernels' dtypes); the wrappers use them for CPU tensors
and ``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

import torch


def _teacher_student(client_logits, student_logits, w, temperature):
    t = torch.einsum("k,kbv->bv", w.float(), client_logits.float()) / temperature
    s = student_logits.float() / temperature
    return t, s


def ensemble_kl_ref(
    client_logits: torch.Tensor, student_logits: torch.Tensor, w: torch.Tensor, temperature: float = 1.0
) -> torch.Tensor:
    """client_logits: (K, B, V); student_logits: (B, V); w: (K,).
    Returns per-sample KL(softmax(A_w/T) ‖ softmax(s/T))·T², shape (B,)."""
    t, s = _teacher_student(client_logits, student_logits, w, temperature)
    lt = torch.log_softmax(t, dim=-1)
    ls = torch.log_softmax(s, dim=-1)
    return torch.sum(torch.exp(lt) * (lt - ls), dim=-1) * (temperature**2)


def ensemble_kl_fwd_ref(client_logits, student_logits, w, temperature: float = 1.0):
    """``(out, lse_t, lse_s)``, each (B,) f32: the KL·T² and the teacher and
    student logsumexps over the T-scaled logits."""
    t, s = _teacher_student(client_logits, student_logits, w, temperature)
    lse_t = torch.logsumexp(t, dim=-1)
    lse_s = torch.logsumexp(s, dim=-1)
    lt, ls = t - lse_t[:, None], s - lse_s[:, None]
    out = torch.sum(torch.exp(lt) * (lt - ls), dim=-1) * (temperature**2)
    return out, lse_t, lse_s


def ensemble_kl_bwd_ref(
    client_logits, student_logits, w, g, out, lse_t, lse_s, temperature: float = 1.0, needs=(True, True, True)
):
    """``(g_client, g_student, g_w)`` for the per-sample cotangent ``g`` (B,):

        g_ens     = T·g·p ⊙ ((t − lse_t) − (s − lse_s) − out/T²)
        g_client  = w_k · g_ens
        g_student = T·g·(q − p)
        g_w       = ⟨g_ens, client_k⟩

    in the dtypes of client_logits, student_logits and w; each ``None`` where
    ``needs`` (three flags, in that order) leaves it out."""
    want_cl, want_st, want_w = needs
    t, s = _teacher_student(client_logits, student_logits, w, temperature)
    lt, ls = t - lse_t[:, None], s - lse_s[:, None]
    p, q = torch.exp(lt), torch.exp(ls)
    g_t = (g.float() * temperature)[:, None]
    kl_u = (out / (temperature * temperature))[:, None]
    g_ens = g_t * (p * (lt - ls - kl_u))
    g_cl = (w.float()[:, None, None] * g_ens[None]).to(client_logits.dtype) if want_cl else None
    g_st = (g_t * (q - p)).to(student_logits.dtype) if want_st else None
    g_w = torch.einsum("kbv,bv->k", client_logits.float(), g_ens).to(w.dtype) if want_w else None
    return g_cl, g_st, g_w
