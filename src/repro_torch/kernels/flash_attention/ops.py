"""Public wrapper of the flash-attention op.

``backend`` (see :mod:`repro_torch.kernels.dispatch`): ``"auto"`` and
``"cuda"`` run :func:`flash_attention_fwd` (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors) inside a
``torch.autograd.Function`` whose backward raises: the backward kernels of
the JAX package (``flash_attention_bwd_pallas``, kernels #6 and #7) are not
ported yet, and the op never differentiates the plain version in their
place. ``"ref"`` is plain autograd of :func:`flash_attention_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import resolve
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        return flash_attention_fwd(q, k, v, causal=causal, window=window, softcap=softcap)[0]

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "flash_attention: the backward kernels (the JAX package's flash_attention_bwd_pallas, "
            "kernels #6 dq and #7 dk/dv) are not ported yet; differentiate with backend='ref'"
        )


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0, backend: str = "auto"):
    """Blocked causal/SWA attention. q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd)."""
    if resolve("attn", backend, q.device) == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), bool(causal), int(window), float(softcap))
