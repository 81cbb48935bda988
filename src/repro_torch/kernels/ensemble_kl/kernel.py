"""Fused weighted-ensemble + temperature-KL kernels for Hopper, both in CUDA
C++ (``ensemble_kl_fwd.cu`` and ``ensemble_kl_bwd.cu`` beside this file),
and their wrappers.

Replaces the Pallas TPU kernels ``repro/kernels/ensemble_kl/kernel.py``
``ensemble_kl_pallas`` (forward, ``_kernel``) and ``ensemble_kl_bwd_pallas``
(backward, ``_bwd_kernel``).

What they compute, per row b of the batch, with ``t = Σ_k w_k·client_k / T``
and ``s = student / T``:

* forward: ``KL(softmax(t) ‖ softmax(s))·T²`` plus ``lse_t`` and ``lse_s``,
  with the K-way weighted combine done on the fly, so ``A_w`` never reaches
  device memory, and online max/sum statistics over V;
* backward: from ``g``, ``out``, ``lse_t``, ``lse_s``, the cotangents
  ``g_client = w_k·g_ens``, ``g_student = T·g·(q − p)`` and
  ``g_w = ⟨g_ens, client_k⟩`` with ``g_ens = T·g·p⊙((t−lse_t)−(s−lse_s)−out/T²)``,
  each only when the caller asks for it.

What bounds them on the H100: bytes. There is no matrix product: the
combine is a K-step fma, and each element of the client stack is read once
for a handful of flops, far below the ~20 flop/byte the card needs before
arithmetic would matter. At the main path's K=5, B=128, V=10 the forward
reads about 31 KB, about 9 ns at 3.35 TB/s, so the launch itself dominates.

What the design does about it: each is one launch whose grid follows
from the shapes alone. In the forward, threads own rows (a group of lanes
of one warp for narrow rows, a block, or a few blocks over column ranges,
for wide ones), keep the online statistics in registers and merge them in
a fixed order, masking the B and V tails instead of padding them to the
TPU's (8, 128) tiles; ``ensemble_kl_fwd.cu`` says how. The backward is an
elementwise grid over the (B, V) plane that computes only the wanted
cotangents and combines ``g_w`` across blocks in the same launch;
``ensemble_kl_bwd.cu`` says how. Neither uses float atomics. Both compute
in f32 and store in the input dtypes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import (
    FLOAT_DTYPES,
    LAUNCHES,
    check_cuda,
    check_launch,
    check_rows,
    cuda_library,
    loss_bwd_geometry,
    loss_fwd_geometry,
    loss_scratch,
    record_meta_call,
    stream_ptr,
)
from repro_torch.kernels.ensemble_kl.ref import ensemble_kl_bwd_ref, ensemble_kl_fwd_ref
from repro_torch.kernels.kernel_cost import loss_work

FWD_SOURCE = Path(__file__).with_name("ensemble_kl_fwd.cu")
BWD_SOURCE = Path(__file__).with_name("ensemble_kl_bwd.cu")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_inputs(name, client_logits, student_logits, w):
    check_cuda(name, client_logits, student_logits, w)
    if client_logits.dim() != 3 or tuple(student_logits.shape) != tuple(client_logits.shape[1:]):
        raise ValueError(
            f"{name}: want client (K, B, V) and student (B, V), got "
            f"{tuple(client_logits.shape)} and {tuple(student_logits.shape)}"
        )
    if tuple(w.shape) != (client_logits.shape[0],) or w.dtype != torch.float32:
        raise ValueError(f"{name}: w must be ({client_logits.shape[0]},) float32, got {tuple(w.shape)} {w.dtype}")
    for x in (client_logits, student_logits):
        if x.dtype not in FLOAT_DTYPES:
            raise ValueError(f"{name}: logits dtype {x.dtype} not in {FLOAT_DTYPES}")


@functools.cache
def _fwd_lib():
    """The forward's launcher in the built library, with its C signature."""
    fn = cuda_library(FWD_SOURCE).ensemble_kl_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 3 + [ctypes.c_float] + [i] * 7 + [p]
    fn.restype = ctypes.c_int
    return fn


def ensemble_kl_fwd(client_logits, student_logits, w, temperature: float = 1.0):
    """``(out, lse_t, lse_s)``, each (B,) f32 (the rows of one (3, B)
    tensor). Launches the CUDA kernel, once, for CUDA tensors; computes the
    plain version for CPU tensors; on ``meta`` tensors returns the outputs'
    shapes and records the call for the dry-run's counter."""
    if client_logits.device.type == "cpu":
        return ensemble_kl_fwd_ref(client_logits, student_logits, w, temperature)
    _check_inputs("ensemble_kl_fwd", client_logits, student_logits, w)
    k, b, v = client_logits.shape
    res = torch.empty((3, b), dtype=torch.float32, device=w.device)
    if w.is_meta:
        work = loss_work("ensemble_kl_fwd", k, b, v, client_logits.element_size())
        record_meta_call(("ensemble_kl_fwd",), *work, torch.float32)
        return res[0], res[1], res[2]
    cl_p, st_p = client_logits.data_ptr(), student_logits.data_ptr()
    itemsize = max(client_logits.element_size(), student_logits.element_size())
    geo = loss_fwd_geometry(b, v, itemsize, (cl_p | st_p) % 16 == 0)
    part = ticket = None
    if geo.splits > 1:
        part, ticket = (t.data_ptr() for t in loss_scratch(w.device, 5 * b * geo.splits))
    err = _fwd_lib()(
        cl_p, st_p, w.data_ptr(), res.data_ptr(), part, ticket, k, b, v, float(temperature),
        DTYPE_CODES[client_logits.dtype], DTYPE_CODES[student_logits.dtype], geo.vec, geo.lanes, geo.splits,
        geo.span, geo.blocks, stream_ptr(w),
    )
    check_launch("ensemble_kl_fwd", err)
    LAUNCHES["ensemble_kl_fwd"] += 1
    return res[0], res[1], res[2]


def _check_bwd(client_logits, student_logits, w, g, out, lse_t, lse_s):
    _check_inputs("ensemble_kl_bwd", client_logits, student_logits, w)
    check_cuda("ensemble_kl_bwd", client_logits, g, out, lse_t, lse_s)
    check_rows("ensemble_kl_bwd", client_logits.shape[1], g, out, lse_t, lse_s)


@functools.cache
def _bwd_lib():
    """The backward's launcher in the built library, with its C signature."""
    fn = cuda_library(BWD_SOURCE).ensemble_kl_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 12 + [i] * 3 + [ctypes.c_float] + [i] * 4 + [p]
    fn.restype = ctypes.c_int
    return fn


def ensemble_kl_bwd(
    client_logits, student_logits, w, g, out, lse_t, lse_s, temperature: float = 1.0, needs=(True, True, True)
):
    """``(g_client, g_student, g_w)`` in the dtypes of the inputs, each
    ``None`` where ``needs`` (three flags, in that order) leaves it out.
    Launches the CUDA kernel, once, for CUDA tensors; computes the plain
    version for CPU tensors; records the call on ``meta`` tensors."""
    if client_logits.device.type == "cpu":
        return ensemble_kl_bwd_ref(client_logits, student_logits, w, g, out, lse_t, lse_s, temperature, needs)
    _check_bwd(client_logits, student_logits, w, g, out, lse_t, lse_s)
    k, b, v = client_logits.shape
    want_cl, want_st, want_w = (bool(x) for x in needs)
    g_cl = torch.empty_like(client_logits) if want_cl else None
    g_st = torch.empty_like(student_logits) if want_st else None
    g_w = torch.empty(k, dtype=torch.float32, device=w.device) if want_w else None
    if w.is_meta:
        work = loss_work("ensemble_kl_bwd", k, b, v, client_logits.element_size(), (want_cl, want_st, want_w))
        record_meta_call(("ensemble_kl_bwd",), *work, torch.float32)
        return g_cl, g_st, g_w
    itemsize = max(client_logits.element_size(), student_logits.element_size())
    aligned = client_logits.data_ptr() % 16 == 0 and student_logits.data_ptr() % 16 == 0
    blocks, vec, rows = loss_bwd_geometry(b * v, itemsize, aligned)
    part, ticket = loss_scratch(w.device, k * rows) if want_w and rows else (None, None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = _bwd_lib()(
        client_logits.data_ptr(), student_logits.data_ptr(), w.data_ptr(), g.data_ptr(), out.data_ptr(),
        lse_t.data_ptr(), lse_s.data_ptr(), ptr(g_cl), ptr(g_st), ptr(g_w), ptr(part), ptr(ticket), k, b, v, float(temperature), DTYPE_CODES[client_logits.dtype], DTYPE_CODES[student_logits.dtype], vec,
        blocks, stream_ptr(w),
    )
    check_launch("ensemble_kl_bwd", err)
    LAUNCHES["ensemble_kl_bwd"] += 1
    return g_cl, g_st, g_w
