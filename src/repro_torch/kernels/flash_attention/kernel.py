"""Blocked online-softmax attention forward for Hopper, in CUDA C++
(``flash_attention.cu`` beside this file), and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
``flash_attention_pallas`` (``_kernel``): causal / sliding-window / softcap
attention with GQA, returning ``out`` and the per-row logsumexp.

What bounds it on the H100: on the serving path (prefill of up to 8
prompts of a few hundred tokens, hd = 64) a few hundred MFLOP, so launch
and latency; at long context it is the score and P·V products, which this
first version computes in f32 on the CUDA cores, far below the tensor
cores' rate (``wgmma`` tiles come later).

What the design does about it: one block per (q tile, kv head, batch row),
so each K/V tile is staged in shared memory once for all G query heads of
its kv head; (m, l, acc) stay in registers across the kv sweep; tiles that
the causal or window mask hides from the whole block are skipped; the Sq
and Sk tails are masked instead of padded to the TPU's (8, 128) tiles; q,
k and v are read in their JAX layouts, with no transposes on the host.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import LAUNCHES, check_cuda, check_launch, cuda_library, stream_ptr
from repro_torch.kernels.flash_attention.ref import flash_attention_ref_lse

SOURCE = Path(__file__).with_name("flash_attention.cu")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 64  # query heads per kv head one block holds


def _lib():
    """The launcher of the built library, with its C signature."""
    lib = cuda_library(SOURCE)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p] + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    check_cuda("flash_attention_fwd", q, k, v)
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd: q, k, v must share one of {tuple(DTYPE_CODES)}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd: q (B,Sq,H,hd), k/v (B,Sk,KH,hd); got {q.shape}, {k.shape}, {v.shape}")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2] or h // k.shape[2] > MAX_GROUP:
        raise ValueError(f"flash_attention_fwd: incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} not in {HEAD_DIMS}")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """``(out, lse)``: out (B, Sq, H, hd) in q's dtype, lse (B, Sq, H) f32.
    Launches the CUDA kernel for CUDA tensors; computes the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref_lse(q, k, v, causal=causal, window=window, softcap=softcap)
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, sq, sk, h, kh, hd, int(causal), int(window), float(softcap), DTYPE_CODES[q.dtype], stream_ptr(q),
    )
    check_launch("flash_attention_fwd", err)
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse
