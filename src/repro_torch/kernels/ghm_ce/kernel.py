"""Fused GHM-difficulty-weighted cross-entropy kernels for Hopper, in Triton.

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
  (the Eq. 12 EE step reads ``g_w``). Labels carry no gradient.

What bounds them on the H100: bytes, as for ``ensemble_kl``: a K-step fma
and a row reduction per element, no matrix product. At K=5, B=128, V=10 the
forward reads about 26 KB, under 10 ns at 3.35 TB/s, so the launch
dominates.

What the design does about it: the forward runs one program per block of
rows, looping over V in ``BLOCK_V`` chunks with the statistics in
registers; the backward, whose tiles are independent once ``lse`` and
``ly`` are saved, runs one program per (row block, V chunk) tile. Both
mask the B and V tails. The mode (``weighted``, ``stop_difficulty_grad``)
is a compile-time flag. ``g_w`` is written as per-program partials and
summed by a second one-program launch in a fixed order (the TPU kernel's
revisited accumulator block relies on in-order grids, which a GPU does not
have).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (
    FLOAT_DTYPES,
    LAUNCHES,
    check_cuda,
    check_rows,
    jit,
    next_pow2,
    reduce_partials,
    row_blocks,
)
from repro_torch.kernels.ghm_ce.ref import ghm_ce_bwd_ref, ghm_ce_fwd_ref


# triton.language; build.jit binds it before the first build, so this module
# imports where Triton is not installed
tl = None


def _fwd_body(
    w_ptr, cl_ptr, lab_ptr, out_ptr, lse_ptr, ly_ptr, K, B, V, stride_k,
    WEIGHTED: tl.constexpr, BLOCK_B: tl.constexpr, BLOCK_V: tl.constexpr,
):
    rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
    rmask = rows < B
    rbase = rows.to(tl.int64) * V
    lab = tl.load(lab_ptr + rows, mask=rmask, other=0)
    m = tl.full([BLOCK_B], -1e30, tl.float32)
    d = tl.zeros([BLOCK_B], tl.float32)
    ly = tl.zeros([BLOCK_B], tl.float32)
    for v0 in range(0, V, BLOCK_V):
        cols = v0 + tl.arange(0, BLOCK_V)
        cmask = cols < V
        mask = rmask[:, None] & cmask[None, :]
        offs = rbase[:, None] + cols[None, :]
        t = tl.zeros([BLOCK_B, BLOCK_V], tl.float32)
        for k in range(K):
            wk = tl.load(w_ptr + k)
            c = tl.load(cl_ptr + k.to(tl.int64) * stride_k + offs, mask=mask, other=0.0)
            t += wk * c.to(tl.float32)
        t = tl.where(cmask[None, :], t, -1e30)
        m_new = tl.maximum(m, tl.max(t, axis=1))
        d = d * tl.exp(m - m_new) + tl.sum(tl.exp(t - m_new[:, None]), axis=1)
        m = m_new
        hit = cols[None, :] == lab[:, None]
        ly += tl.sum(tl.where(hit, t, 0.0), axis=1)
    lse = tl.log(d) + m
    nll = lse - ly
    if WEIGHTED:
        nll = (1.0 - tl.exp(ly - lse)) * nll
    tl.store(out_ptr + rows, nll, mask=rmask)
    tl.store(lse_ptr + rows, lse, mask=rmask)
    tl.store(ly_ptr + rows, ly, mask=rmask)


def _bwd_body(
    w_ptr, cl_ptr, lab_ptr, g_ptr, lse_ptr, ly_ptr, gcl_ptr, part_ptr, K, B, V, stride_k,
    WEIGHTED: tl.constexpr, STOP_GRAD: tl.constexpr,
    BLOCK_B: tl.constexpr, BLOCK_V: tl.constexpr, BLOCK_K: tl.constexpr,
):
    """One (row block, V chunk) tile per program: the residuals make the
    tiles independent, so the backward needs no loop over V."""
    rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
    cols = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
    rmask = rows < B
    mask = rmask[:, None] & (cols < V)[None, :]
    offs = rows.to(tl.int64)[:, None] * V + cols[None, :]
    # rows past B carry a zero cotangent, so every gradient they touch is 0
    lab = tl.load(lab_ptr + rows, mask=rmask, other=0)
    lse = tl.load(lse_ptr + rows, mask=rmask, other=0.0)
    ly = tl.load(ly_ptr + rows, mask=rmask, other=0.0)
    g = tl.load(g_ptr + rows, mask=rmask, other=0.0)
    if WEIGHTED:
        py = tl.exp(ly - lse)
        if STOP_GRAD:
            coeff = 1.0 - py
        else:
            coeff = 1.0 - py + py * (lse - ly)
        gc = g * coeff
    else:
        gc = g
    t = tl.zeros([BLOCK_B, BLOCK_V], tl.float32)
    for k in range(K):
        wk = tl.load(w_ptr + k)
        c = tl.load(cl_ptr + k.to(tl.int64) * stride_k + offs, mask=mask, other=0.0)
        t += wk * c.to(tl.float32)
    p = tl.exp(t - lse[:, None])
    onehot = tl.where(cols[None, :] == lab[:, None], 1.0, 0.0)
    g_t = tl.where(mask, gc[:, None] * (p - onehot), 0.0)
    kk = tl.arange(0, BLOCK_K)
    gw = tl.zeros([BLOCK_K], tl.float32)
    for k in range(K):
        wk = tl.load(w_ptr + k)
        koff = k.to(tl.int64) * stride_k + offs
        c = tl.load(cl_ptr + koff, mask=mask, other=0.0).to(tl.float32)
        tl.store(gcl_ptr + koff, (wk * g_t).to(gcl_ptr.dtype.element_ty), mask=mask)
        gw = tl.where(kk == k, gw + tl.sum(tl.sum(c * g_t, axis=1), axis=0), gw)
    pid = tl.program_id(0) * tl.num_programs(1) + tl.program_id(1)
    tl.store(part_ptr + pid * BLOCK_K + kk, gw, mask=kk < K)


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


def ghm_ce_fwd(client_logits, labels, w, weighted: bool = True):
    """``(out, lse, ly)``, each (B,) f32. Launches the Triton kernel for CUDA
    tensors; computes the plain version for CPU tensors."""
    if client_logits.device.type == "cpu":
        return ghm_ce_fwd_ref(client_logits, labels, w, weighted)
    _check_inputs("ghm_ce_fwd", client_logits, labels, w)
    k, b, v = client_logits.shape
    out, lse, ly = (torch.empty(b, dtype=torch.float32, device=w.device) for _ in range(3))
    block_b, block_v = row_blocks(b, v)
    jit(_fwd_body)[(-(-b // block_b),)](
        w, client_logits, labels, out, lse, ly, k, b, v, b * v,
        WEIGHTED=bool(weighted), BLOCK_B=block_b, BLOCK_V=block_v, num_warps=4,
    )
    LAUNCHES["ghm_ce_fwd"] += 1
    return out, lse, ly


def ghm_ce_bwd(client_logits, labels, w, g, lse, ly, weighted: bool = True, stop_difficulty_grad: bool = False):
    """``(g_client, g_w)`` in the dtypes of the inputs. Launches the Triton
    kernel (and its fixed-order ``g_w`` reduction) for CUDA tensors;
    computes the plain version for CPU tensors."""
    if client_logits.device.type == "cpu":
        return ghm_ce_bwd_ref(client_logits, labels, w, g, lse, ly, weighted, stop_difficulty_grad)
    _check_inputs("ghm_ce_bwd", client_logits, labels, w)
    k, b, v = client_logits.shape
    check_cuda("ghm_ce_bwd", client_logits, g, lse, ly)
    check_rows("ghm_ce_bwd", b, g, lse, ly)
    g_cl = torch.empty_like(client_logits)
    block_b, block_v = row_blocks(b, v)
    block_k = max(2, next_pow2(k))
    grid = (-(-b // block_b), -(-v // block_v))
    partials = torch.empty((grid[0] * grid[1], block_k), dtype=torch.float32, device=w.device)
    jit(_bwd_body)[grid](
        w, client_logits, labels, g, lse, ly, g_cl, partials, k, b, v, b * v,
        WEIGHTED=bool(weighted), STOP_GRAD=bool(stop_difficulty_grad),
        BLOCK_B=block_b, BLOCK_V=block_v, BLOCK_K=block_k, num_warps=4,
    )
    g_w = reduce_partials(partials, k)
    LAUNCHES["ghm_ce_bwd"] += 1
    return g_cl, g_w
