"""Fused weighted-ensemble + temperature-KL kernels for Hopper, in Triton.

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
  ``g_w = ⟨g_ens, client_k⟩`` with ``g_ens = T·g·p⊙((t−lse_t)−(s−lse_s)−out/T²)``.

What bounds them on the H100: bytes. There is no matrix product: the
combine is a K-step fma, and each element of the client stack is read once
(twice in the backward, the second time from L1/L2) for a handful of flops,
far below the ~20 flop/byte the card needs before arithmetic would matter.
At the main path's K=5, B=128, V=10 the forward reads about 31 KB, about
9 ns at 3.35 TB/s, so the launch itself dominates.

What the design does about it: in the forward, one program per block of
rows walks V in ``BLOCK_V`` chunks (the TPU's vocab-minor grid becomes this
loop) and keeps the online statistics in registers. The backward needs no
loop: with ``lse_t``/``lse_s`` saved, every (row block, V chunk) tile is
independent, so it runs one program per tile over a 2-D grid. Both mask
the B and V tails instead of padding them to the TPU's (8, 128) tiles. The
TPU backward accumulates ``g_w`` in an output block every grid step
revisits, which is safe only because TPU grids run in order; here each
program writes its own ``(K,)`` f32 partial and a second one-program
launch sums the partials in a fixed order, with no float atomics, so
``g_w`` is the same on every run. The backward computes in f32 and stores
in the input dtypes.
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
from repro_torch.kernels.ensemble_kl.ref import ensemble_kl_bwd_ref, ensemble_kl_fwd_ref


# triton.language; build.jit binds it before the first build, so this module
# imports where Triton is not installed
tl = None


def _fwd_body(
    w_ptr, cl_ptr, st_ptr, out_ptr, lset_ptr, lses_ptr, K, B, V, stride_k,
    T: tl.constexpr, BLOCK_B: tl.constexpr, BLOCK_V: tl.constexpr,
):
    rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
    rmask = rows < B
    rbase = rows.to(tl.int64) * V
    mt = tl.full([BLOCK_B], -1e30, tl.float32)
    dt = tl.zeros([BLOCK_B], tl.float32)
    nt = tl.zeros([BLOCK_B], tl.float32)
    ms = tl.full([BLOCK_B], -1e30, tl.float32)
    ds = tl.zeros([BLOCK_B], tl.float32)
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
        t = t / T
        s = tl.load(st_ptr + offs, mask=mask, other=0.0).to(tl.float32) / T
        t = tl.where(cmask[None, :], t, -1e30)
        s_l = tl.where(cmask[None, :], s, -1e30)
        diff = tl.where(cmask[None, :], t - s, 0.0)
        # online teacher statistics
        mt_new = tl.maximum(mt, tl.max(t, axis=1))
        corr = tl.exp(mt - mt_new)
        p = tl.exp(t - mt_new[:, None])
        dt = dt * corr + tl.sum(p, axis=1)
        nt = nt * corr + tl.sum(p * diff, axis=1)
        mt = mt_new
        # online student logsumexp
        ms_new = tl.maximum(ms, tl.max(s_l, axis=1))
        ds = ds * tl.exp(ms - ms_new) + tl.sum(tl.exp(s_l - ms_new[:, None]), axis=1)
        ms = ms_new
    lse_t = tl.log(dt) + mt
    lse_s = tl.log(ds) + ms
    kl = nt / dt - lse_t + lse_s
    tl.store(out_ptr + rows, kl * (T * T), mask=rmask)
    tl.store(lset_ptr + rows, lse_t, mask=rmask)
    tl.store(lses_ptr + rows, lse_s, mask=rmask)


def _bwd_body(
    w_ptr, cl_ptr, st_ptr, g_ptr, out_ptr, lset_ptr, lses_ptr, gcl_ptr, gst_ptr, part_ptr,
    K, B, V, stride_k,
    T: tl.constexpr, BLOCK_B: tl.constexpr, BLOCK_V: tl.constexpr, BLOCK_K: tl.constexpr,
):
    """One (row block, V chunk) tile per program: the residuals make the
    tiles independent, so the backward needs no loop over V."""
    rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
    cols = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
    rmask = rows < B
    mask = rmask[:, None] & (cols < V)[None, :]
    offs = rows.to(tl.int64)[:, None] * V + cols[None, :]
    # rows past B carry a zero cotangent, so every gradient they touch is 0
    lse_t = tl.load(lset_ptr + rows, mask=rmask, other=0.0)
    lse_s = tl.load(lses_ptr + rows, mask=rmask, other=0.0)
    g_t = tl.load(g_ptr + rows, mask=rmask, other=0.0) * T
    kl_u = tl.load(out_ptr + rows, mask=rmask, other=0.0) / (T * T)
    t = tl.zeros([BLOCK_B, BLOCK_V], tl.float32)
    for k in range(K):
        wk = tl.load(w_ptr + k)
        c = tl.load(cl_ptr + k.to(tl.int64) * stride_k + offs, mask=mask, other=0.0)
        t += wk * c.to(tl.float32)
    lt = t / T - lse_t[:, None]
    ls = tl.load(st_ptr + offs, mask=mask, other=0.0).to(tl.float32) / T - lse_s[:, None]
    p = tl.exp(lt)
    q = tl.exp(ls)
    g_ens = tl.where(mask, g_t[:, None] * (p * (lt - ls - kl_u[:, None])), 0.0)
    g_st = g_t[:, None] * (q - p)
    tl.store(gst_ptr + offs, g_st.to(gst_ptr.dtype.element_ty), mask=mask)
    kk = tl.arange(0, BLOCK_K)
    gw = tl.zeros([BLOCK_K], tl.float32)
    for k in range(K):
        wk = tl.load(w_ptr + k)
        koff = k.to(tl.int64) * stride_k + offs
        c = tl.load(cl_ptr + koff, mask=mask, other=0.0).to(tl.float32)
        tl.store(gcl_ptr + koff, (wk * g_ens).to(gcl_ptr.dtype.element_ty), mask=mask)
        gw = tl.where(kk == k, gw + tl.sum(tl.sum(c * g_ens, axis=1), axis=0), gw)
    pid = tl.program_id(0) * tl.num_programs(1) + tl.program_id(1)
    tl.store(part_ptr + pid * BLOCK_K + kk, gw, mask=kk < K)


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


def ensemble_kl_fwd(client_logits, student_logits, w, temperature: float = 1.0):
    """``(out, lse_t, lse_s)``, each (B,) f32. Launches the Triton kernel
    for CUDA tensors; computes the plain version for CPU tensors."""
    if client_logits.device.type == "cpu":
        return ensemble_kl_fwd_ref(client_logits, student_logits, w, temperature)
    _check_inputs("ensemble_kl_fwd", client_logits, student_logits, w)
    k, b, v = client_logits.shape
    out, lse_t, lse_s = (torch.empty(b, dtype=torch.float32, device=w.device) for _ in range(3))
    block_b, block_v = row_blocks(b, v)
    grid = (-(-b // block_b),)
    jit(_fwd_body)[grid](
        w, client_logits, student_logits, out, lse_t, lse_s, k, b, v, b * v,
        T=float(temperature), BLOCK_B=block_b, BLOCK_V=block_v, num_warps=4,
    )
    LAUNCHES["ensemble_kl_fwd"] += 1
    return out, lse_t, lse_s


def ensemble_kl_bwd(client_logits, student_logits, w, g, out, lse_t, lse_s, temperature: float = 1.0):
    """``(g_client, g_student, g_w)`` in the dtypes of the inputs. Launches
    the Triton kernel (and its fixed-order ``g_w`` reduction) for CUDA
    tensors; computes the plain version for CPU tensors."""
    if client_logits.device.type == "cpu":
        return ensemble_kl_bwd_ref(client_logits, student_logits, w, g, out, lse_t, lse_s, temperature)
    _check_inputs("ensemble_kl_bwd", client_logits, student_logits, w)
    k, b, v = client_logits.shape
    check_cuda("ensemble_kl_bwd", client_logits, g, out, lse_t, lse_s)
    check_rows("ensemble_kl_bwd", b, g, out, lse_t, lse_s)
    g_cl = torch.empty_like(client_logits)
    g_st = torch.empty_like(student_logits)
    block_b, block_v = row_blocks(b, v)
    block_k = max(2, next_pow2(k))
    grid = (-(-b // block_b), -(-v // block_v))
    partials = torch.empty((grid[0] * grid[1], block_k), dtype=torch.float32, device=w.device)
    jit(_bwd_body)[grid](
        w, client_logits, student_logits, g, out, lse_t, lse_s, g_cl, g_st, partials,
        k, b, v, b * v,
        T=float(temperature), BLOCK_B=block_b, BLOCK_V=block_v, BLOCK_K=block_k, num_warps=4,
    )
    g_w = reduce_partials(partials, k)
    LAUNCHES["ensemble_kl_bwd"] += 1
    return g_cl, g_st, g_w
