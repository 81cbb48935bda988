"""Plain PyTorch version of paged flash-decode (the port's copy of
``repro.kernels.flash_decode.ref``).

The logical cache of a slot is its pages concatenated in page-table order:
logical index ``j`` lives at ``(page_table[b, j // ps], j % ps)``. This
version gathers every table entry and applies one masked softmax; the
reference's page-by-page scan computes the same function. Masked positions
contribute exactly nothing, even where a page holds garbage (the engine's
scratch page), as in the CUDA kernel.
"""
from __future__ import annotations

import torch


def page_mask(j: torch.Tensor, p: torch.Tensor, cache_len: int, window: int) -> torch.Tensor:
    """Validity of logical in-ring index ``j`` for a row at position ``p``:
    without a window ``j`` is the absolute position; with one, the ring of
    ``cache_len`` slots holds the last ``cache_len`` positions and ``j``'s
    absolute position is rebuilt from the write head ``p % cache_len``.
    ``j >= cache_len`` (page padding past the ring) is never valid."""
    if window > 0:
        slot_w = p % cache_len
        wrap = (p // cache_len) * cache_len
        k_pos = torch.where(j <= slot_w, wrap + j, wrap - cache_len + j)
        valid = (k_pos >= 0) & (k_pos <= p) & (k_pos > p - window)
    else:
        valid = j <= p
    return valid & (j < cache_len)


def flash_decode_ref(q, k_pages, v_pages, page_table, pos, *, window: int = 0, softcap: float = 0.0, cache_len: int = 0):
    """Sq=1 paged attention. q: (B, H, hd); k_pages/v_pages: (P, ps, KH, hd);
    page_table: (B, W) int; pos: (B,) int. Returns (B, H, hd) in q's dtype;
    computes in f32."""
    b, h, hd = q.shape
    ps, kh = k_pages.shape[1], k_pages.shape[2]
    w = page_table.shape[1]
    cl = cache_len or w * ps
    g = h // kh
    table = page_table.long()
    k = k_pages[table].reshape(b, w * ps, kh, hd).float()  # (B, W·ps, KH, hd)
    v = v_pages[table].reshape(b, w * ps, kh, hd).float()
    j = torch.arange(w * ps, device=q.device)[None, :]
    valid = page_mask(j, pos.reshape(-1, 1).long(), cl, window)  # (B, W·ps)
    k = torch.where(valid[:, :, None, None], k, 0.0)
    v = torch.where(valid[:, :, None, None], v, 0.0)
    qf = q.reshape(b, kh, g, hd).float() * (1.0 / float(hd) ** 0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    return out.reshape(b, h, hd).to(q.dtype)
