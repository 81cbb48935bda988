"""Fused GHM-difficulty-weighted cross-entropy kernels for Hopper, both in
CUDA C++ (``ghm_ce_fwd.cu`` and ``ghm_ce_bwd.cu`` beside this file), and
their wrappers.

Replaces the Pallas TPU kernels ``repro/kernels/ghm_ce/kernel.py``
``ghm_ce_pallas`` (forward, ``_kernel``) and ``ghm_ce_bwd_pallas``
(backward, ``_bwd_kernel``).

What they compute, per row b, over the weighted ensemble
``t = Σ_k w_k·client_k``:

* forward: ``lse`` (online over V), the label logit ``ly`` (picked up in the
  chunk that holds the label) and ``(1 − e^{ly−lse})·(lse − ly)`` (Eq. 5–6),
  or the plain CE ``lse − ly`` with ``weighted=False`` (Eq. 11);
* backward: ``g_t = g·coeff·(p − onehot)`` with ``coeff`` 1 (plain CE),
  ``1 − p_y`` (``stop_difficulty_grad``, the Eq. 6 generator loss) or
  ``1 − p_y + p_y·nll``; ``g_client = w_k·g_t`` and ``g_w = ⟨g_t, client_k⟩``
  (the Eq. 12 EE step reads ``g_w``), each only when the caller asks for
  it. Labels carry no gradient.

What bounds them on the H100: bytes, as for ``ensemble_kl``: a K-step fma
and a row reduction per element, no matrix product. At K=5, B=128, V=10 the
forward reads about 26 KB, under 10 ns at 3.35 TB/s, so the launch
dominates.

What the design does about it: each is one launch whose grid follows from
the shapes alone. The forward owns rows as ``ensemble_kl``'s does (a group
of lanes of one warp, a block, or a few blocks over column ranges), with
the statistics in registers, merged in a fixed order, and the label logit
picked up by the one lane that holds it; ``ghm_ce_fwd.cu`` says how. The
backward is an elementwise grid over the (B, V) plane that computes only
the wanted cotangents and combines ``g_w`` across blocks in the same
launch, in a fixed order with no float atomics (the TPU kernel's revisited
accumulator block relies on in-order grids, which a GPU does not have);
``ghm_ce_bwd.cu`` says how.
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
    stream_ptr,
)
from repro_torch.kernels.ghm_ce.ref import ghm_ce_bwd_ref, ghm_ce_fwd_ref

FWD_SOURCE = Path(__file__).with_name("ghm_ce_fwd.cu")
BWD_SOURCE = Path(__file__).with_name("ghm_ce_bwd.cu")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LABEL_CODES = {torch.int32: 0, torch.int64: 1}


def _check_inputs(name, client_logits, labels, w):
    check_cuda(name, client_logits, labels, w)
    if client_logits.dim() != 3 or tuple(labels.shape) != (client_logits.shape[1],):
        raise ValueError(
            f"{name}: want client (K, B, V) and labels (B,), got "
            f"{tuple(client_logits.shape)} and {tuple(labels.shape)}"
        )
    if labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: labels must be int32 or int64, got {labels.dtype}")
    if tuple(w.shape) != (client_logits.shape[0],) or w.dtype != torch.float32:
        raise ValueError(f"{name}: w must be ({client_logits.shape[0]},) float32, got {tuple(w.shape)} {w.dtype}")
    if client_logits.dtype not in FLOAT_DTYPES:
        raise ValueError(f"{name}: logits dtype {client_logits.dtype} not in {FLOAT_DTYPES}")


@functools.cache
def _fwd_lib():
    """The forward's launcher in the built library, with its C signature."""
    fn = cuda_library(FWD_SOURCE).ghm_ce_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 11 + [p]
    fn.restype = ctypes.c_int
    return fn


def ghm_ce_fwd(client_logits, labels, w, weighted: bool = True):
    """``(out, lse, ly)``, each (B,) f32 (the rows of one (3, B) tensor).
    Launches the CUDA kernel, once, for CUDA tensors; computes the plain
    version for CPU tensors."""
    if client_logits.device.type == "cpu":
        return ghm_ce_fwd_ref(client_logits, labels, w, weighted)
    _check_inputs("ghm_ce_fwd", client_logits, labels, w)
    k, b, v = client_logits.shape
    res = torch.empty((3, b), dtype=torch.float32, device=w.device)
    cl_p = client_logits.data_ptr()
    geo = loss_fwd_geometry(b, v, client_logits.element_size(), cl_p % 16 == 0)
    part = ticket = None
    if geo.splits > 1:
        part, ticket = (t.data_ptr() for t in loss_scratch(w.device, 3 * b * geo.splits))
    err = _fwd_lib()(
        cl_p, labels.data_ptr(), w.data_ptr(), res.data_ptr(), part, ticket, k, b, v, int(bool(weighted)),
        DTYPE_CODES[client_logits.dtype], LABEL_CODES[labels.dtype], geo.vec, geo.lanes, geo.splits, geo.span,
        geo.blocks, stream_ptr(w),
    )
    check_launch("ghm_ce_fwd", err)
    LAUNCHES["ghm_ce_fwd"] += 1
    return res[0], res[1], res[2]


def _check_bwd(client_logits, labels, w, g, lse, ly):
    _check_inputs("ghm_ce_bwd", client_logits, labels, w)
    check_cuda("ghm_ce_bwd", client_logits, g, lse, ly)
    check_rows("ghm_ce_bwd", client_logits.shape[1], g, lse, ly)


@functools.cache
def _bwd_lib():
    """The backward's launcher in the built library, with its C signature."""
    fn = cuda_library(BWD_SOURCE).ghm_ce_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 10 + [i] * 8 + [p]
    fn.restype = ctypes.c_int
    return fn


def ghm_ce_bwd(
    client_logits, labels, w, g, lse, ly, weighted: bool = True, stop_difficulty_grad: bool = False,
    needs=(True, True),
):
    """``(g_client, g_w)`` in the dtypes of the inputs, each ``None`` where
    ``needs`` (two flags, in that order) leaves it out. Launches the CUDA
    kernel, once, for CUDA tensors; computes the plain version for CPU
    tensors."""
    if client_logits.device.type == "cpu":
        return ghm_ce_bwd_ref(client_logits, labels, w, g, lse, ly, weighted, stop_difficulty_grad, needs)
    _check_bwd(client_logits, labels, w, g, lse, ly)
    k, b, v = client_logits.shape
    want_cl, want_w = (bool(x) for x in needs)
    g_cl = torch.empty_like(client_logits) if want_cl else None
    g_w = torch.empty(k, dtype=torch.float32, device=w.device) if want_w else None
    blocks, vec, rows = loss_bwd_geometry(b * v, client_logits.element_size(), client_logits.data_ptr() % 16 == 0)
    part, ticket = loss_scratch(w.device, k * rows) if want_w and rows else (None, None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    mode = 0 if not weighted else (1 if stop_difficulty_grad else 2)  # the coefficient's three forms
    err = _bwd_lib()(
        client_logits.data_ptr(), labels.data_ptr(), w.data_ptr(), g.data_ptr(), lse.data_ptr(), ly.data_ptr(),
        ptr(g_cl), ptr(g_w), ptr(part), ptr(ticket), k, b, v, mode, DTYPE_CODES[client_logits.dtype],
        LABEL_CODES[labels.dtype], vec, blocks, stream_ptr(w),
    )
    check_launch("ghm_ce_bwd", err)
    LAUNCHES["ghm_ce_bwd"] += 1
    return g_cl, g_w
