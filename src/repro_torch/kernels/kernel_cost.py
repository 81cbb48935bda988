"""The work of each hand kernel at its call's shapes: the bytes it must
move (each input read once, each output written once) and the operations
it does, and the least time the H100 could take for them.

One set of formulas serves two readers: ``chip_smoke.py``'s kernel table
(the ``bound_ms`` of every kernel it times) and the dry-run, where each
wrapper called on ``meta`` tensors reports the work these functions give
for its shapes (:func:`repro_torch.kernels.build.record_meta_call`).

Each ``*_work`` function returns ``(nbytes, flops)``. The loss kernels
(#1–#4) compute in f32 on the CUDA cores whatever their input dtype; the
attention kernels (#5–#8) do their products in their inputs' dtype (bf16
on the tensor cores, f32 on the CUDA cores), and :func:`peak_flops` gives
the rate of either.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

def peak_flops(dtype) -> float:
    """The card's peak rate for ``dtype``'s operations: the H100 SXM figures
    of :mod:`repro_torch.config.mesh` (f32 outside the tensor cores, bf16
    and other 16-bit types on them, dense)."""
    from repro_torch.config.mesh import PEAK_FLOPS_BF16, PEAK_FLOPS_F32  # not at import: the kernels import this

    return PEAK_FLOPS_F32 if dtype in (torch.float32, torch.float64) else PEAK_FLOPS_BF16


def bound_ms(nbytes, flops, peak=None):
    """``(ms, "bytes" | "operations")``: the larger of the bytes over the
    card's memory rate and the operations over ``peak`` (the f32 peak by
    default), and which of the two it is."""
    from repro_torch.config.mesh import HBM_BW, PEAK_FLOPS_F32

    t_bytes = nbytes / HBM_BW
    t_ops = flops / (PEAK_FLOPS_F32 if peak is None else peak)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def loss_work(name, k, b, v, itemsize, needs=None):
    """Kernels #1–#4 on K client rows of (B, V) logits of ``itemsize``
    bytes: per (b, v) element a K-step fma combine (2K) plus ~10 ops of
    scaling, exponentials and sums in the forward; the backward rebuilds the
    combine and forms the cotangents in ``needs`` (K multiplies for
    g_client, 2K for the g_w dot products, ~4 for g_student) plus ~8 ops,
    and writes only those."""
    n = b * v
    if name == "ensemble_kl_fwd":
        return (k * n + n) * itemsize + 4 * k + 3 * 4 * b, n * (2 * k + 10)
    if name == "ghm_ce_fwd":
        return k * n * itemsize + 4 * k + 8 * b + 3 * 4 * b, n * (2 * k + 6)
    if name == "ensemble_kl_bwd":
        cl, st, gw = needs
        written = (k * n * cl + n * st) * itemsize + 4 * k * gw
        return (k * n + n) * itemsize + 4 * k + 4 * 4 * b + written, n * (2 * k + 8 + k * cl + 4 * st + 2 * k * gw)
    if name != "ghm_ce_bwd":
        raise ValueError(f"not a loss kernel: {name!r}")
    cl, gw = needs
    written = k * n * itemsize * cl + 4 * k * gw
    return k * n * itemsize + 4 * k + 8 * b + 3 * 4 * b + written, n * (2 * k + 8 + k * cl + 2 * k * gw)


@functools.lru_cache(maxsize=256)
def visible_pairs(sq: int, sk: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs the attention masks leave visible, positions
    from 0 on both sides: key j is seen by query i when ``j <= i``
    (causal) and ``j > i - window`` (a window > 0)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i + 1, sk) if causal else np.full(sq, sk, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attention_fwd_work(b, sq, sk, h, kh, hd, itemsize, causal=True, window=0):
    """Kernel #5: q, k, v read once, out written once, lse in f32; the QK^T
    and PV products over the visible pairs."""
    q, kv = b * sq * h * hd, b * sk * kh * hd
    nbytes = (2 * q + 2 * kv) * itemsize + 4 * b * sq * h
    return nbytes, 4 * b * h * visible_pairs(sq, sk, causal, window) * hd


def attention_bwd_work(which, b, sq, sk, h, kh, hd, itemsize, causal=True, window=0):
    """Kernels #6 (``which="dq"``: inputs q k v dout lse delta, output dq;
    the s, dp and dq products) and #7 (``"dkv"``: outputs dk dv; the s, dp,
    dv and dk products), over the visible pairs."""
    q, kv = b * sq * h * hd, b * sk * kh * hd
    rows = 2 * 4 * b * sq * h  # lse and delta, f32
    pairs = visible_pairs(sq, sk, causal, window)
    if which == "dq":
        return (3 * q + 2 * kv) * itemsize + rows, 3 * 2 * b * h * pairs * hd
    if which == "dkv":
        return (2 * q + 4 * kv) * itemsize + rows, 4 * 2 * b * h * pairs * hd
    raise ValueError(f"which must be 'dq' or 'dkv', got {which!r}")


def decode_work(b, h, kh, hd, keys, table_entries, itemsize):
    """Kernel #8: the K and V rows of the ``keys`` cached positions it reads
    (summed over the B rows), q read and out written, the int32 page table
    and positions; QK^T and PV over those keys for every query head."""
    nbytes = 2 * keys * kh * hd * itemsize + 2 * b * h * hd * itemsize + 4 * (table_entries + b)
    return nbytes, 4 * keys * h * hd
