"""Public wrapper of paged flash-decode attention, the op the paged
:func:`repro_torch.models.attention.attn_decode` calls.

``backend`` (see :mod:`repro_torch.kernels.dispatch`): ``"auto"`` and
``"cuda"`` run :func:`flash_decode_fwd` (the CUDA kernel for CUDA tensors,
its plain version for CPU tensors); ``"ref"`` the plain version.

**Inference-only**, as in the JAX package: decode serves frozen weights,
so the op claims no backward and differentiating it raises, whatever the
backend.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import resolve
from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd
from repro_torch.kernels.flash_decode.ref import flash_decode_ref


class FlashDecode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k_pages, v_pages, page_table, pos, window, softcap, cache_len, impl):
        fn = flash_decode_ref if impl == "ref" else flash_decode_fwd
        return fn(q, k_pages, v_pages, page_table, pos, window=window, softcap=softcap, cache_len=cache_len)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "flash_decode is inference-only: it claims no backward (decode serves frozen "
            "weights). Gradients flow through the train/prefill path (flash_attention), "
            "never the paged decode cache."
        )


def flash_decode(q, k_pages, v_pages, page_table, pos, *, window: int = 0, softcap: float = 0.0,
                 cache_len: int = 0, backend: str = "auto"):
    """Paged Sq=1 attention. q: (B, H, hd); k_pages/v_pages: (P, ps, KH, hd);
    page_table: (B, W); pos: (B,) per-row positions. ``cache_len`` is the
    slot's logical cache length (the SWA ring length); 0 means W·ps."""
    impl = resolve("decode", backend, q.device)
    pos = torch.as_tensor(pos, device=q.device).to(torch.int32).reshape(-1).expand(q.shape[0]).contiguous()
    return FlashDecode.apply(
        q.contiguous(), k_pages, v_pages, page_table.to(torch.int32).contiguous(), pos,
        int(window), float(softcap), int(cache_len), impl,
    )
