"""Differentiable public wrapper for the fused ensemble-KL kernels.

``backend`` (see :mod:`repro_torch.kernels.dispatch`) covers both passes.
Under ``"auto"``/``"cuda"`` the op is a ``torch.autograd.Function`` whose
forward is the forward kernel, saving ``out``, ``lse_t`` and ``lse_s`` (the
kernel's online-softmax statistics) as residuals, and whose backward is the
backward kernel, emitting in one pass only the cotangents autograd asks for
(``ctx.needs_input_grad``). The student cotangent drives server
distillation (Eq. 4) and the generator's adversarial term (Eq. 7); the
client cotangent reaches the generator through the client CNNs; on the
Co-Boosting path nothing differentiates ``w`` through this op. ``"ref"`` is plain autograd of
:func:`ensemble_kl_ref`.

A client stack that is a DTensor (the grouped bank's logits under a mesh)
takes the same kernels on each rank's rows, the K clients whole
(:func:`repro_torch.kernels.dispatch.on_row_split`); the output comes back
whole on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import on_row_split, resolve
from repro_torch.kernels.ensemble_kl.kernel import ensemble_kl_bwd, ensemble_kl_fwd
from repro_torch.kernels.ensemble_kl.ref import ensemble_kl_ref
from repro_torch.sharding.partition import is_dtensor


class EnsembleKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, client_logits, student_logits, w, temperature):
        out, lse_t, lse_s = ensemble_kl_fwd(client_logits, student_logits, w, temperature)
        ctx.save_for_backward(client_logits, student_logits, w, out, lse_t, lse_s)
        ctx.temperature = temperature
        return out

    @staticmethod
    def backward(ctx, g):
        client_logits, student_logits, w, out, lse_t, lse_s = ctx.saved_tensors
        g_cl, g_st, g_w = ensemble_kl_bwd(
            client_logits, student_logits, w, g.float().contiguous(), out, lse_t, lse_s, ctx.temperature,
            needs=ctx.needs_input_grad[:3],
        )
        return g_cl, g_st, g_w, None


def ensemble_kl(
    client_logits: torch.Tensor,
    student_logits: torch.Tensor,
    w: torch.Tensor,
    temperature: float = 1.0,
    backend: str = "auto",
) -> torch.Tensor:
    """Per-sample KL(A_w ‖ student)·T², shape (B,). client_logits: (K, B, V)."""
    ref = resolve("loss", backend, client_logits.device) == "ref"

    def local(cl, st, w):
        if ref:
            return ensemble_kl_ref(cl, st, w, temperature)
        return EnsembleKL.apply(cl.contiguous(), st.contiguous(), w.contiguous(), float(temperature))

    if is_dtensor(client_logits):
        return on_row_split("ensemble_kl", local, client_logits, (student_logits,), w)
    return local(client_logits, student_logits, w)
