"""Paged flash-decode (Sq = 1) attention for Hopper, in CUDA C++
(``flash_decode.cu`` beside this file), and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_decode/kernel.py``
``flash_decode_pallas`` (``_kernel``): one query token per slot against the
paged KV cache of :class:`repro_torch.serve.kv_pool.KVPool`, gathered
through the per-slot page table.

What bounds it on the H100: bytes — every live K/V page is read once for
a few flops per element — and, at the serving shapes (8 slots, a few
hundred positions, 30 layers), the latency of a launch and of one trip to
memory.

What the design does about it (split-KV decode, "flash-decoding"): the
grid is (S, KH, B), where :func:`decode_splits` derives the S splits from
B, KH and W alone so that the blocks cover the card's SMs. Each block
reads its row's position on the device, takes the s-th of S near-equal
shares of the row's live table entries (:func:`live_entries`,
:func:`split_range`: the same arithmetic as the kernel), and puts all of
its pages' K and V rows in flight at once (``cp.async``), zero-filling
masked positions so scratch-page entries never leak into the result. A
second kernel, launched by the same call, combines the splits' partial
softmax statistics in a fixed order, so a second call gives the same bits.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import SMS, LAUNCHES, check_cuda, check_launch, cuda_library, stream_ptr
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

SOURCE = Path(__file__).with_name("flash_decode.cu")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 96, 128)
MAX_GROUP = 32  # query heads per kv head one block holds


def decode_splits(b: int, kh: int, w: int) -> int:
    """S, the number of splits of each (row, kv head)'s live table entries:
    enough that the B·KH·S blocks cover the card's SMs, and at most one
    split per table entry. A function of the shapes alone, so the grid never
    waits for the positions."""
    return max(1, min(w, -(-SMS // max(1, b * kh))))


def live_entries(pos: int, ps: int, w: int, cache_len: int) -> int:
    """The table entries of a row at position ``pos`` that can hold a valid
    index (the JAX ``page_live`` predicate): those up to ⌈(pos+1)/ps⌉, or,
    once a ring of ``cache_len`` has wrapped, all ⌈cache_len/ps⌉; never more
    than W. The kernel computes the same on the device."""
    return max(0, min(w, -(-min(pos + 1, cache_len) // ps)))


def split_range(n_live: int, splits: int, s: int) -> tuple[int, int]:
    """The table entries ``[lo, hi)`` split ``s`` of ``splits`` takes: the
    s-th of near-equal shares of the ``n_live`` live entries, in order."""
    return s * n_live // splits, (s + 1) * n_live // splits


def _lib():
    """The launcher of the built library, with its C signature."""
    lib = cuda_library(SOURCE)
    fn = lib.flash_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 8 + [ctypes.c_float, i, i, p]
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
    """(B, H, hd) in q's dtype. Launches the CUDA kernels for CUDA tensors
    (a call is two kernels: the splits, then their combine, unless S = 1;
    it counts as one launch); computes the plain version for CPU tensors.
    ``cache_len`` 0 means the table extent W·ps."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_pages, v_pages, page_table, pos, window=window, softcap=softcap, cache_len=cache_len)
    _check(q, k_pages, v_pages, page_table, pos)
    b, h, hd = q.shape
    ps, kh = k_pages.shape[1], k_pages.shape[2]
    w = page_table.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    for t in (k_pages, v_pages):  # cp.async copies 16-byte pieces
        if t.data_ptr() % 16:
            raise ValueError("flash_decode: the pages must start at a 16-byte-aligned address")
    splits = decode_splits(b, kh, w)
    part = torch.empty(b * h * splits * (hd + 2), dtype=torch.float32, device=q.device) if splits > 1 else None
    err = _lib()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, b, h, kh, hd, ps, w, int(cache_len or w * ps), int(window),
        float(softcap), splits, DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check_launch("flash_decode", err)
    LAUNCHES["flash_decode"] += 1
    return out
