"""Grouped-query attention with RoPE, optional qk-norm, sliding window and
a KV cache for decode (the port's copy of ``repro.models.attention``,
serving path).

Entry points:

* :func:`attn_train`   — full-sequence attention (no cache);
* :func:`attn_prefill` — the same, and fills the cache;
* :func:`attn_decode`  — one token against the cache: the dense per-slot
  layout attends through :func:`_sdpa_small` (plain PyTorch), the paged
  layout through the flash-decode op.

Full-sequence attention goes through the flash-attention op
(:mod:`repro_torch.kernels.flash_attention`), paged decode through the
flash-decode op; ``cfg.backend`` routes both.

Unlike the reference, whose arrays are immutable, the caches are updated
**in place**: ``attn_prefill`` and ``attn_decode`` write the new K/V into
the tensors they are given (views of the model state) and return them.
A serving state is written every decode step, and a copy per step would
double its memory traffic.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, dtype):
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    params = {
        "wq": dense_init(gen, d, (h, hd), dtype),
        "wk": dense_init(gen, d, (k, hd), dtype),
        "wv": dense_init(gen, d, (k, hd), dtype),
        "wo": dense_init(gen, h * hd, (d,), dtype).reshape(h, hd, d),
    }
    return params


def _proj(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    d, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * hd)).unflatten(-1, (h, hd))


def _out_proj(o, wo):
    """``einsum("bshk,hkd->bsd")``."""
    h, hd, d = wo.shape
    return o.flatten(-2) @ wo.to(o.dtype).reshape(h * hd, d)


def _project_qkv(params, x, cfg, positions):
    q, k, v = _proj(x, params["wq"]), _proj(x, params["wk"]), _proj(x, params["wv"])
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta), v


def _attn_mix(q, k, v, cfg):
    return flash_attention(
        q, k, v, causal=cfg.causal, window=cfg.sliding_window,
        softcap=cfg.attn_logit_softcap, backend=cfg.backend,
    )


def _sdpa_small(q, k, v, bias, cfg):
    """Unblocked attention for decode (Sq == 1). q: (B, Sq, H, hd);
    k, v: (B, Sk, KH, hd); ``bias`` is per batch row, ``(B, Sq, Sk)`` or
    right-aligned broadcastable to it, like the engine's ``(B, 1, Sk)``."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    q = q.reshape(b, sq, kh, h // kh, hd)
    scale = 1.0 / torch.tensor(float(hd)).sqrt().to(q.dtype)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q * scale, k).float()
    if cfg.attn_logit_softcap > 0:
        c = cfg.attn_logit_softcap
        scores = torch.tanh(scores / c) * c
    scores = scores + bias[:, None, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v).reshape(b, sq, h, hd)


def attn_train(params, x, cfg, positions=None):
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    return _out_proj(_attn_mix(q, k, v, cfg), params["wo"])


# ---------------------------------------------------------------------------
# KV cache


def cache_len(cfg, max_seq: int) -> int:
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def init_cache(cfg, batch: int, max_seq: int, dtype, device="cpu") -> Dict[str, torch.Tensor]:
    shape = (batch, cache_len(cfg, max_seq), cfg.num_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg, n_pages: int, page_size: int, dtype, device="cpu") -> Dict[str, torch.Tensor]:
    """Paged decode cache: a pool of fixed-size pages shared by all slots
    (:class:`repro_torch.serve.kv_pool.KVPool` hands out the page ids; the
    per-slot page table lives in the engine's decode state)."""
    shape = (n_pages, page_size, cfg.num_kv_heads, cfg.head_dim_)
    return {
        "k_pages": torch.zeros(shape, dtype=dtype, device=device),
        "v_pages": torch.zeros(shape, dtype=dtype, device=device),
    }


def attn_prefill(params, x, cfg, cache):
    """Full-sequence attention that also fills ``cache`` (in place). The
    cache keeps its allocated length ``cl``; when the prompt is longer than
    ``cl`` (a sliding-window ring), the kept tail lands on its ring slots
    (slot = position % cl) so :func:`attn_decode`'s position math holds."""
    s = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, torch.arange(s, device=x.device))
    out = _out_proj(_attn_mix(q, k, v, cfg), params["wo"])
    ck, cv = cache["k"], cache["v"]
    cl = ck.shape[1]
    if s < cl:
        ck[:, :s] = k.to(ck.dtype)
        cv[:, :s] = v.to(cv.dtype)
    else:
        tail_pos = torch.arange(s - cl, s, device=x.device)
        slots = tail_pos % cl if cfg.sliding_window > 0 else torch.arange(cl, device=x.device)
        ck[:, slots] = k[:, -cl:].to(ck.dtype)
        cv[:, slots] = v[:, -cl:].to(cv.dtype)
    return out, cache


def _positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (an int, a 0-d tensor or a (B,) tensor) as a (B,) int32 vector."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.reshape(-1).expand(b) if pos.dim() else pos.expand(b)


def attn_decode(params, x, cfg, cache, pos, page_table=None):
    """One-token decode. x: (B, 1, d); ``pos``: the index of this token, a
    scalar or a (B,) vector of per-row positions.

    The dense per-slot cache (``{"k", "v"}``, a ring buffer for SWA) attends
    through :func:`_sdpa_small`; a paged cache (``{"k_pages", "v_pages"}``
    plus ``page_table``) through the flash-decode op. Both layouts use the
    same ring/mask math, so they are token-for-token interchangeable."""
    b = x.shape[0]
    posv = _positions(pos, b, x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, posv[:, None])
    if "k_pages" in cache:
        return _attn_decode_paged(params, q, k_new, v_new, cfg, cache, posv, page_table)
    ck, cv = cache["k"], cache["v"]
    cl = ck.shape[1]
    slot = posv % cl if cfg.sliding_window > 0 else torch.clamp(posv, max=cl - 1)
    rows = torch.arange(b, device=x.device)
    ck[rows, slot] = k_new[:, 0].to(ck.dtype)
    cv[rows, slot] = v_new[:, 0].to(cv.dtype)
    ring_idx = torch.arange(cl, dtype=torch.int32, device=x.device)[None, :]
    p = posv[:, None]
    if cfg.sliding_window > 0:
        wrap = (p // cl) * cl
        k_pos = torch.where(ring_idx <= slot[:, None], wrap + ring_idx, wrap - cl + ring_idx)
        valid = (k_pos >= 0) & (k_pos <= p) & (k_pos > p - cfg.sliding_window)
    else:
        valid = ring_idx <= p
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(valid, zero, NEG_INF)[:, None, :]  # (B, 1, cl)
    out = _sdpa_small(q, ck, cv, bias, cfg)
    return _out_proj(out, params["wo"]), cache


def _attn_decode_paged(params, q, k_new, v_new, cfg, cache, posv, page_table):
    """Paged decode: write the new K/V onto the write position's page, then
    attend through the flash-decode op. The logical cache length comes back
    from the table extent W·ps: for full attention it is ``max_seq``
    (``EngineConfig`` keeps ``max_seq`` a multiple of the page size), and an
    SWA ring of ``min(window, max_seq)`` slots has cl <= W·ps < cl + ps, so
    ``min(window, W·ps)`` recovers cl in every case."""
    if page_table is None:
        raise ValueError("paged KV cache requires a page_table (see repro_torch.serve.kv_pool)")
    kp, vp = cache["k_pages"], cache["v_pages"]
    b = posv.shape[0]
    ps = kp.shape[1]
    extent = page_table.shape[1] * ps
    if cfg.sliding_window > 0:
        cl = min(cfg.sliding_window, extent)
        slot = posv % cl
    else:
        cl = extent
        slot = torch.clamp(posv, max=cl - 1)
    rows = torch.arange(b, device=posv.device)
    pid = page_table[rows, slot // ps]
    off = slot % ps
    # rows re-aimed at the scratch page may write one offset together: that
    # page is never read unmasked, so the order of those writes is moot
    kp[pid, off] = k_new[:, 0].to(kp.dtype)
    vp[pid, off] = v_new[:, 0].to(vp.dtype)
    out = flash_decode(
        q[:, 0], kp, vp, page_table, posv,
        window=cfg.sliding_window, softcap=cfg.attn_logit_softcap,
        cache_len=cl, backend=cfg.backend,
    )
    return _out_proj(out, params["wo"])[:, None], cache
