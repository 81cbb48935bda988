"""Paged flash-decode (Sq = 1) attention for Hopper, in CUDA C++
(``flash_decode.cu`` beside this file), and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_decode/kernel.py``
``flash_decode_pallas`` (``_kernel``): one query token per slot against the
paged KV cache of :class:`repro_torch.serve.kv_pool.KVPool`, gathered
through the per-slot page table.

What bounds it on the H100: bytes — every live K/V page is read once for
a few flops per element — and, at the serving shapes (8 slots, a few
hundred positions, 30 layers), the launch.

What the design does about it: the TPU's scalar-prefetched page gather
becomes a page-id load and pointer arithmetic in the kernel; one block per
(kv head, row) stages each live page in shared memory once for all G query
heads (one warp each), skips pages no valid index lies on (the JAX
``page_live`` predicate), and zero-fills masked positions so scratch-page
entries never leak into the result.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import LAUNCHES, check_cuda, check_launch, cuda_library, stream_ptr
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

SOURCE = Path(__file__).with_name("flash_decode.cu")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 32  # one warp per query head of a kv head


def _lib():
    """The launcher of the built library, with its C signature."""
    lib = cuda_library(SOURCE)
    fn = lib.flash_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, page_table, pos):
    check_cuda("flash_decode", q, k_pages, v_pages, page_table, pos)
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"flash_decode: q and the pages must share one of {tuple(DTYPE_CODES)}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("flash_decode: page_table and pos must be int32")
    b, h, hd = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or k_pages.shape[3] != hd:
        raise ValueError(f"flash_decode: pages (P,ps,KH,{hd}); got {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    kh = k_pages.shape[2]
    if h % kh or h // kh > MAX_GROUP:
        raise ValueError(f"flash_decode: {h} query heads over {kh} kv heads (at most {MAX_GROUP} per kv head)")
    if page_table.dim() != 2 or page_table.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(f"flash_decode: page_table (B,W) and pos (B,) for B={b}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {hd} not in {HEAD_DIMS}")


def flash_decode_fwd(q, k_pages, v_pages, page_table, pos, *, window: int = 0, softcap: float = 0.0, cache_len: int = 0):
    """(B, H, hd) in q's dtype. Launches the CUDA kernel for CUDA tensors;
    computes the plain version for CPU tensors. ``cache_len`` 0 means the
    table extent W·ps."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_pages, v_pages, page_table, pos, window=window, softcap=softcap, cache_len=cache_len)
    _check(q, k_pages, v_pages, page_table, pos)
    b, h, hd = q.shape
    ps, kh = k_pages.shape[1], k_pages.shape[2]
    w = page_table.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    err = _lib()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        b, h, kh, hd, ps, w, int(cache_len or w * ps), int(window), float(softcap), DTYPE_CODES[q.dtype],
        stream_ptr(q),
    )
    check_launch("flash_decode", err)
    LAUNCHES["flash_decode"] += 1
    return out
