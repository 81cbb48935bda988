"""Plain PyTorch versions of the flash-attention forward (the port's copy of
``repro.kernels.flash_attention.ref.flash_attention_ref``, plus the per-row
logsumexp the Pallas kernel returns with ``return_lse=True``) and of its
backward (the recompute from lse that ``flash_attention_bwd_pallas``
computes, written out in plain torch, not autograd).

They materialise the (Sq, Sk) scores: the CPU path and the tests use them,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.

A fully-masked row (possible with a window when Sq > Sk + window) gets
out = 0 and lse = 1e30, the contract the CUDA kernel keeps so that a
recompute backward's ``p = exp(s - lse)`` is exactly 0 there. The JAX
kernel's comment states the same contract, but on such rows the JAX kernel
returns lse = -1e30 and the mean of V over its padded block, and
``flash_attention_ref`` the mean of V.
"""
from __future__ import annotations

import torch

NEG_LSE = 1e30


def _visible(sq: int, sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query sees (positions from 0)."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    return ok


def _grouped(t: torch.Tensor, kh: int) -> torch.Tensor:
    """(B, Sq, H, hd) → (B, Sq, KH, G, hd) in f32: head h = kh·G + g."""
    b, sq, h, hd = t.shape
    return t.reshape(b, sq, kh, h // kh, hd).float()


def _rows(t: torch.Tensor, kh: int) -> torch.Tensor:
    """Per-row (B, Sq, H) → (B, KH, G, Sq, 1), the score layout's rows."""
    b, sq, h = t.shape
    return t.reshape(b, sq, kh, h // kh).permute(0, 2, 3, 1)[..., None]


def flash_attention_ref_lse(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd). Returns ``(out, lse)``:
    out (B, Sq, H, hd) in q's dtype, lse (B, Sq, H) f32. Computes in f32."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qg = _grouped(q, kh) / (hd**0.5)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = s.masked_fill(~_visible(sq, sk, causal, window, q.device), float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    l = e.sum(-1)  # (B, KH, G, Sq)
    p = e / l.clamp_min(1e-30)[..., None]
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float()).reshape(b, sq, h, hd).to(q.dtype)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-30)), torch.full_like(l, NEG_LSE))
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, h).contiguous()


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd). Returns (B, Sq, H, hd)."""
    return flash_attention_ref_lse(q, k, v, causal=causal, window=window, softcap=softcap)[0]


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = Σ_hd dout·out per (row, head): (B, Sq, H) f32. As in the
    reference, an elementwise-and-sum outside the kernels."""
    return (dout.float() * out.float()).sum(-1)


def _probs(q, k, v, dout, lse, delta, causal, window, softcap):
    """The backward's recompute: ``(qs, do, p, du)`` with qs = q·scale and
    do = dout grouped (B, Sq, KH, G, hd) f32, and the (B, KH, G, Sq, Sk)
    tiles p = exp(s − lse) (0 where masked, and on rows whose lse is 1e30)
    and du = p·(dp − delta)·dact."""
    sq, hd = q.shape[1], q.shape[3]
    sk, kh = k.shape[1], k.shape[2]
    qs = _grouped(q, kh) / (hd**0.5)
    do = _grouped(dout, kh)
    u = torch.einsum("bqkgh,bskh->bkgqs", qs, k.float())
    if softcap > 0:
        t = torch.tanh(u / softcap)
        s, dact = t * softcap, 1.0 - t * t
    else:
        s, dact = u, 1.0
    s = s.masked_fill(~_visible(sq, sk, causal, window, q.device), float("-inf"))
    p = torch.exp(s - _rows(lse, kh))
    dp = torch.einsum("bqkgh,bskh->bkgqs", do, v.float())
    du = p * (dp - _rows(delta, kh)) * dact
    return qs, do, p, du


def flash_attention_bwd_dq_ref(q, k, v, dout, lse, delta, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The dq pass: dq = scale·du·k, (B, Sq, H, hd) in q's dtype."""
    hd = q.shape[3]
    _, _, _, du = _probs(q, k, v, dout, lse, delta, causal, window, softcap)
    dq = torch.einsum("bkgqs,bskh->bqkgh", du, k.float()) / (hd**0.5)
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, dout, lse, delta, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """The dk/dv pass: dk = duᵀ·(q·scale) and dv = pᵀ·dout, summed over the
    G query heads of each kv head in f32, then cast to k's and v's dtype."""
    qs, do, p, du = _probs(q, k, v, dout, lse, delta, causal, window, softcap)
    dk = torch.einsum("bkgqs,bqkgh->bskh", du, qs)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, do)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """``(dq, dk, dv)`` from the forward's ``out`` and ``lse`` and the output
    cotangent ``dout``: delta = Σ_hd dout·out, then both passes."""
    delta = attention_delta(out, dout)
    kw = dict(causal=causal, window=window, softcap=softcap)
    dq = flash_attention_bwd_dq_ref(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv
