"""Blocked online-softmax attention for Hopper, in CUDA C++, and the
wrappers of its kernels: the forward (``flash_attention.cu`` beside this
file) and the two backward passes (``flash_attention_bwd.cu``, whose
header note says what bounds them and what their design does about it).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
``flash_attention_pallas`` (``_kernel``): causal / sliding-window / softcap
attention with GQA, returning ``out`` and the per-row logsumexp.

What bounds the forward on the H100: on the serving path (prefill of up to 8
prompts of a few hundred tokens, hd = 64) a few hundred MFLOP, so launch
and latency; at long context it is the score and P·V products, which this
first version computes in f32 on the CUDA cores, far below the tensor
cores' rate (``wgmma`` tiles come later).

What the forward's design does about it: one block per (q tile, kv head,
batch row), so each K/V tile is staged in shared memory once for all G
query heads of its kv head; (m, l, acc) stay in registers across the kv sweep; tiles that
the causal or window mask hides from the whole block are skipped; the Sq
and Sk tails are masked instead of padded to the TPU's (8, 128) tiles; q,
k and v are read in their JAX layouts, with no transposes on the host.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import LAUNCHES, check_cuda, check_launch, cuda_library, stream_ptr
from repro_torch.kernels.flash_attention.ref import (
    attention_delta,
    flash_attention_bwd_dkv_ref,
    flash_attention_bwd_dq_ref,
    flash_attention_ref_lse,
)

SOURCE = Path(__file__).with_name("flash_attention.cu")
BWD_SOURCE = Path(__file__).with_name("flash_attention_bwd.cu")
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


def _bwd_lib(name: str):
    """A backward launcher of the built library, with its C signature."""
    fn = getattr(cuda_library(BWD_SOURCE), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        outs = 1 if name == "flash_attention_bwd_dq" else 2
        fn.argtypes = [p] * (6 + outs) + [i] * 8 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, q, k, v, *rest):
    check_cuda(name, q, k, v, *rest)
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k, v must share one of {tuple(DTYPE_CODES)}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q (B,Sq,H,hd), k/v (B,Sk,KH,hd); got {q.shape}, {k.shape}, {v.shape}")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2] or h // k.shape[2] > MAX_GROUP:
        raise ValueError(f"{name}: incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")


def _check_bwd(name, q, k, v, dout, lse, delta):
    """The forward's checks, plus dout like q and lse, delta (B, Sq, H) f32."""
    _check(name, q, k, v, dout, lse, delta)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{name}: dout must match q ({tuple(q.shape)} {q.dtype}), got {tuple(dout.shape)} {dout.dtype}")
    for t in (lse, delta):
        if tuple(t.shape) != tuple(q.shape[:3]) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and delta must be {tuple(q.shape[:3])} float32, got {tuple(t.shape)} {t.dtype}")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """``(out, lse)``: out (B, Sq, H, hd) in q's dtype, lse (B, Sq, H) f32.
    Launches the CUDA kernel for CUDA tensors; computes the plain version
    for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref_lse(q, k, v, causal=causal, window=window, softcap=softcap)
    _check("flash_attention_fwd", q, k, v)
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


def _bwd_args(q, k, causal, window, softcap):
    b, sq, h, hd = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], hd, int(causal), int(window), float(softcap),
            DTYPE_CODES[q.dtype], stream_ptr(q))


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The dq pass: dq (B, Sq, H, hd) in q's dtype. Launches the CUDA kernel
    for CUDA tensors; computes the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, dout, lse, delta, causal=causal, window=window, softcap=softcap)
    _check_bwd("flash_attention_bwd_dq", q, k, v, dout, lse, delta)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    err = _bwd_lib("flash_attention_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_bwd_args(q, k, causal, window, softcap),
    )
    check_launch("flash_attention_bwd_dq", err)
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The dk/dv pass: ``(dk, dv)``, each (B, Sk, KH, hd) in k's dtype, the
    GQA group summed in the kernel. Launches the CUDA kernel for CUDA
    tensors; computes the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, dout, lse, delta, causal=causal, window=window, softcap=softcap)
    _check_bwd("flash_attention_bwd_dkv", q, k, v, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dk.zero_(), dv.zero_()
    err = _bwd_lib("flash_attention_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_bwd_args(q, k, causal, window, softcap),
    )
    check_launch("flash_attention_bwd_dkv", err)
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """``(dq, dk, dv)`` of the attention whose forward gave ``out`` and
    ``lse``, for the output cotangent ``dout``: delta, then the dq pass and
    the dk/dv pass (each a kernel launch on CUDA tensors)."""
    delta = attention_delta(out, dout)
    kw = dict(causal=causal, window=window, softcap=softcap)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv
