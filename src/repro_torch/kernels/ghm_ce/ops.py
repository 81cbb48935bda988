"""Differentiable public wrapper for the fused GHM-weighted CE kernels.

``backend`` (see :mod:`repro_torch.kernels.dispatch`) covers both passes.
Under ``"auto"``/``"cuda"`` the op is a ``torch.autograd.Function`` whose
forward is the forward kernel, saving the ensemble logsumexp ``lse`` and the
label logit ``ly`` as residuals, and whose backward is the backward kernel,
emitting only the cotangents autograd asks for (``ctx.needs_input_grad``):
the client cotangent for the generator's steps (Eq. 6), the ``w``
cotangent for the EE step (Eq. 12); labels are integer and get none.
``"ref"`` is plain autograd of :func:`ghm_ce_ref`.

With ``t = A_w``, ``p = softmax(t)``, ``p_y`` the label probability,
``nll`` the CE and ``e`` the one-hot label, d(out)/dt is ``coeff·(p − e)``:

    coeff = 1                   (weighted=False — plain CE, Eq. 11)
          = 1 − p_y             (weighted, difficulty held constant — Eq. 6)
          = 1 − p_y + p_y·nll   (weighted, full gradient)
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import resolve
from repro_torch.kernels.ghm_ce.kernel import ghm_ce_bwd, ghm_ce_fwd
from repro_torch.kernels.ghm_ce.ref import ghm_ce_ref


class GhmCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, client_logits, labels, w, weighted, stop_difficulty_grad):
        out, lse, ly = ghm_ce_fwd(client_logits, labels, w, weighted)
        ctx.save_for_backward(client_logits, labels, w, lse, ly)
        ctx.weighted = weighted
        ctx.stop_difficulty_grad = stop_difficulty_grad
        return out

    @staticmethod
    def backward(ctx, g):
        client_logits, labels, w, lse, ly = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_cl, g_w = ghm_ce_bwd(
            client_logits, labels, w, g.float().contiguous(), lse, ly, ctx.weighted, ctx.stop_difficulty_grad,
            needs=(need[0], need[2]),
        )
        return g_cl, None, g_w, None, None


def ghm_ce(
    client_logits: torch.Tensor,
    labels: torch.Tensor,
    w: torch.Tensor,
    weighted: bool = True,
    backend: str = "auto",
    stop_difficulty_grad: bool = False,
) -> torch.Tensor:
    """Per-sample difficulty-weighted CE of the weighted ensemble (Eq. 6)."""
    if resolve("loss", backend, client_logits.device) == "ref":
        return ghm_ce_ref(client_logits, labels, w, weighted, stop_difficulty_grad)
    return GhmCE.apply(
        client_logits.contiguous(), labels.contiguous(), w.contiguous(),
        bool(weighted), bool(stop_difficulty_grad),
    )
