"""Paged flash-decode (Sq=1) attention: the CUDA kernel, its plain version
and the inference-only op (no backward; differentiating raises)."""
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import flash_decode_ref, page_mask

__all__ = ["flash_decode", "flash_decode_ref", "page_mask"]
