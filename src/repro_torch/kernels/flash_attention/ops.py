"""Public wrapper of the flash-attention op.

``backend`` (see :mod:`repro_torch.kernels.dispatch`): ``"auto"`` and
``"cuda"`` run :func:`flash_attention_fwd` inside a
``torch.autograd.Function`` whose backward is :func:`flash_attention_bwd`
(the dq and dk/dv kernels, the port of the JAX package's
``flash_attention_bwd_pallas``), recomputing the probabilities from the
forward's saved lse: the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors. There is no fallback: on CUDA tensors the
backward launches its kernels or raises. ``"ref"`` is plain autograd of
:func:`flash_attention_ref`.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.dispatch import resolve
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), **ctx.masks)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0, backend: str = "auto"):
    """Blocked causal/SWA attention. q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd)."""
    if resolve("attn", backend, q.device) == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), bool(causal), int(window), float(softcap))
