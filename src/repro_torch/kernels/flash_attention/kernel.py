"""Blocked online-softmax attention for Hopper, in CUDA C++, and the
wrappers of its kernels. Each source's header note says what the TPU
kernel it replaces is, what bounds it on the H100 and what its design does
about that:

* ``flash_attention_sm90.cu``: the forward and both backward passes (dq
  and dk/dv) on the tensor cores (bf16 ``wgmma`` tiles fed by TMA through
  a 2-stage mbarrier ring, one producer warp and one consumer warpgroup).
  They serve bf16 inputs, the main paths' dtype; at the training shape
  they are bound by bytes, and the design keeps every score tile in
  registers.
* ``flash_attention.cu`` (forward) and ``flash_attention_bwd.cu`` (the dq
  and dk/dv passes): f32 arithmetic on the CUDA cores, bound by that
  arithmetic. They serve f32 inputs, whose checks need f32 products, not
  bf16 ones, and bf16 inputs only when a caller names them.

Replaces the Pallas TPU kernels of ``repro/kernels/flash_attention/kernel.py``:
``flash_attention_pallas`` (``_kernel``) and both passes of
``flash_attention_bwd_pallas``: causal / sliding-window / softcap attention
with GQA, returning ``out`` and the per-row logsumexp, and its gradients
recomputed from that logsumexp.

:func:`attention_variant` picks the kernel from the dtype and nothing else:
there is no fallback from one kernel to another, and a launch that fails
raises.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import LAUNCHES, check_cuda, check_launch, cuda_library, record_meta_call, stream_ptr
from repro_torch.kernels.flash_attention.ref import (
    attention_delta,
    flash_attention_bwd_dkv_ref,
    flash_attention_bwd_dq_ref,
    flash_attention_ref_lse,
)
from repro_torch.kernels.kernel_cost import attention_bwd_work, attention_fwd_work

SOURCE = Path(__file__).with_name("flash_attention.cu")
BWD_SOURCE = Path(__file__).with_name("flash_attention_bwd.cu")
SM90_SOURCE = Path(__file__).with_name("flash_attention_sm90.cu")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 96, 128)
MAX_GROUP = 64  # query heads per kv head one block holds
VARIANTS = ("sm90", "cuda_core")

# Each launcher: its source, its count of pointer arguments and whether it
# takes a dtype code. All take the pointers, then B, Sq, Sk, H, KH, hd,
# causal, window, softcap, [dtype,] stream.
_LAUNCHER_SPECS = {
    "flash_attention_fwd": (SOURCE, 5, True),
    "flash_attention_bwd_dq": (BWD_SOURCE, 7, True),
    "flash_attention_bwd_dkv": (BWD_SOURCE, 8, True),
    "flash_attention_fwd_sm90": (SM90_SOURCE, 5, False),
    "flash_attention_bwd_dq_sm90": (SM90_SOURCE, 7, False),
    "flash_attention_bwd_dkv_sm90": (SM90_SOURCE, 8, False),
}
_LAUNCHERS = {}


def attention_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel the wrappers launch for inputs of this dtype and head
    dim: ``"sm90"`` (the tensor-core kernels of ``flash_attention_sm90.cu``)
    for bf16, ``"cuda_core"`` (f32 arithmetic on the CUDA cores) for f32.
    Raises for a head dim or dtype no kernel takes."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "sm90"
    if dtype == torch.float32:
        return "cuda_core"
    raise ValueError(f"dtype {dtype} not in {tuple(DTYPE_CODES)}")


def _pick(name, q, variant):
    """The variant to launch: by dtype, unless the caller names one
    (``chip_smoke.py`` times the CUDA-core kernels on bf16 inputs beside
    the tensor-core ones)."""
    choice = attention_variant(q.dtype, q.shape[3])
    if variant is None:
        return choice
    if variant not in VARIANTS or (variant == "sm90" and choice != "sm90"):
        raise ValueError(f"{name}: variant {variant!r} does not take {q.dtype} (variants {VARIANTS})")
    return variant


def _launcher(name: str):
    """A launcher of a built library with its C signature, looked up once
    per process (the lookup would otherwise cost a call several µs)."""
    fn = _LAUNCHERS.get(name)
    if fn is None:
        source, ptrs, takes_dtype = _LAUNCHER_SPECS[name]
        fn = getattr(cuda_library(source), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * ptrs + [i] * 8 + [ctypes.c_float] + ([i] if takes_dtype else []) + [p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[name] = fn
    return fn


def _check_aligned(name, *tensors):
    """TMA reads from 16-byte-aligned addresses."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} must start at a 16-byte-aligned address")


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


def _shape_args(q, k, causal, window, softcap):
    """The launchers' scalar arguments after the pointers: B, Sq, Sk, H,
    KH, hd, causal, window, softcap."""
    b, sq, h, hd = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], hd, int(causal), int(window), float(softcap))


def _record(name, variant, work, q, k, causal, window):
    """A call on ``meta`` tensors: recorded under the counters the card's
    launch would bump, with its work at these shapes; nothing launches."""
    b, sq, h, hd = q.shape
    names = (name, f"{name}_sm90") if variant == "sm90" else (name,)
    nbytes, flops = work(b, sq, k.shape[1], h, k.shape[2], hd, q.element_size(), bool(causal), int(window))
    record_meta_call(names, nbytes, flops, q.dtype)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0, variant=None):
    """``(out, lse)``: out (B, Sq, H, hd) in q's dtype, lse (B, Sq, H) f32.
    Launches a CUDA kernel for CUDA tensors (:func:`attention_variant`
    picks it, unless ``variant`` names one); computes the plain version for
    CPU tensors; on ``meta`` tensors returns the outputs' shapes and
    records the call (:func:`repro_torch.kernels.build.record_meta_call`)."""
    if q.device.type == "cpu":
        return flash_attention_ref_lse(q, k, v, causal=causal, window=window, softcap=softcap)
    _check("flash_attention_fwd", q, k, v)
    variant = _pick("flash_attention_fwd", q, variant)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.is_meta:
        _record("flash_attention_fwd", variant, attention_fwd_work, q, k, causal, window)
        return out, lse
    if q.numel() == 0:
        return out, lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    shape = _shape_args(q, k, causal, window, softcap)
    if variant == "sm90":
        _check_aligned("flash_attention_fwd", q, k, v)
        err = _launcher("flash_attention_fwd_sm90")(*ptrs, *shape, stream_ptr(q))
        check_launch("flash_attention_fwd_sm90", err)
        LAUNCHES["flash_attention_fwd_sm90"] += 1
    else:
        err = _launcher("flash_attention_fwd")(*ptrs, *shape, DTYPE_CODES[q.dtype], stream_ptr(q))
        check_launch("flash_attention_fwd", err)
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bwd_dq(
    q, k, v, dout, lse, delta, *, causal: bool = True, window: int = 0, softcap: float = 0.0, variant=None
):
    """The dq pass: dq (B, Sq, H, hd) in q's dtype. Launches a CUDA kernel
    for CUDA tensors (:func:`attention_variant` picks it, unless
    ``variant`` names one); computes the plain version for CPU tensors;
    records the call on ``meta`` tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, dout, lse, delta, causal=causal, window=window, softcap=softcap)
    _check_bwd("flash_attention_bwd_dq", q, k, v, dout, lse, delta)
    variant = _pick("flash_attention_bwd_dq", q, variant)
    dq = torch.empty_like(q)
    if q.is_meta:
        _record("flash_attention_bwd_dq", variant, functools.partial(attention_bwd_work, "dq"), q, k, causal, window)
        return dq
    if q.numel() == 0:
        return dq
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    shape = _shape_args(q, k, causal, window, softcap)
    if variant == "sm90":
        _check_aligned("flash_attention_bwd_dq", q, k, v, dout)
        err = _launcher("flash_attention_bwd_dq_sm90")(*ptrs, *shape, stream_ptr(q))
        check_launch("flash_attention_bwd_dq_sm90", err)
        LAUNCHES["flash_attention_bwd_dq_sm90"] += 1
    else:
        err = _launcher("flash_attention_bwd_dq")(*ptrs, *shape, DTYPE_CODES[q.dtype], stream_ptr(q))
        check_launch("flash_attention_bwd_dq", err)
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def flash_attention_bwd_dkv(
    q, k, v, dout, lse, delta, *, causal: bool = True, window: int = 0, softcap: float = 0.0, variant=None
):
    """The dk/dv pass: ``(dk, dv)``, each (B, Sk, KH, hd) in k's dtype, the
    GQA group summed in the kernel. Launches a CUDA kernel for CUDA tensors
    (:func:`attention_variant` picks it, unless ``variant`` names one);
    computes the plain version for CPU tensors; records the call on
    ``meta`` tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, dout, lse, delta, causal=causal, window=window, softcap=softcap)
    _check_bwd("flash_attention_bwd_dkv", q, k, v, dout, lse, delta)
    variant = _pick("flash_attention_bwd_dkv", q, variant)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.is_meta:
        _record("flash_attention_bwd_dkv", variant, functools.partial(attention_bwd_work, "dkv"), q, k, causal, window)
        return dk, dv
    if q.numel() == 0 or k.numel() == 0:
        return dk.zero_(), dv.zero_()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    shape = _shape_args(q, k, causal, window, softcap)
    if variant == "sm90":
        _check_aligned("flash_attention_bwd_dkv", q, k, v, dout)
        err = _launcher("flash_attention_bwd_dkv_sm90")(*ptrs, *shape, stream_ptr(q))
        check_launch("flash_attention_bwd_dkv_sm90", err)
        LAUNCHES["flash_attention_bwd_dkv_sm90"] += 1
    else:
        err = _launcher("flash_attention_bwd_dkv")(*ptrs, *shape, DTYPE_CODES[q.dtype], stream_ptr(q))
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
