"""Plain PyTorch version of the flash-attention forward (the port's copy of
``repro.kernels.flash_attention.ref.flash_attention_ref``, plus the per-row
logsumexp the Pallas kernel returns with ``return_lse=True``).

It materialises the (Sq, Sk) scores: the CPU path and the tests use it,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.

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


def flash_attention_ref_lse(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd). Returns ``(out, lse)``:
    out (B, Sq, H, hd) in q's dtype, lse (B, Sq, H) f32. Computes in f32."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd).float() / (hd**0.5)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    l = e.sum(-1)  # (B, KH, G, Sq)
    p = e / l.clamp_min(1e-30)[..., None]
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float()).reshape(b, sq, h, hd).to(q.dtype)
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-30)), torch.full_like(l, NEG_LSE))
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, h)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd). Returns (B, Sq, H, hd)."""
    return flash_attention_ref_lse(q, k, v, causal=causal, window=window, softcap=softcap)[0]
