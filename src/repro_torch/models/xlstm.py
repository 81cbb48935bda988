"""xLSTM blocks (the port's copy of ``repro.models.xlstm``): mLSTM (matrix
memory, stabilised exponential gating) and sLSTM (scalar memory with a
per-head hidden-to-hidden recurrence), per arXiv:2405.04517.

Both cells are true recurrences, run as a loop over time through
:func:`repro_torch.utils.scan.chunked_scan` (checkpointed a chunk at a time
when gradients are on). The mLSTM carry is the per-head matrix state (C:
hd×hd, n: hd, m: scalar), the sLSTM carry (h, c, n, m); every carry is f32.
Decode runs the same cell one step at a time from the given state.

Weights keep the JAX einsum layouts: mLSTM ``in_proj`` (d, 2·inner),
``wq``/``wk``/``wv`` (inner, H, hd), ``gates`` (inner, 2H) f32,
``out_proj`` (inner, d); sLSTM ``w`` (d, 4d), ``r`` (4, H, hd, hd) f32,
``out_proj`` (d, d). ``gates`` and ``r`` are used in f32 without a cast.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.attention import flatten_heads, split_heads, whole_where_cut
from repro_torch.models.layers import dense_init
from repro_torch.sharding.partition import constrain, is_dtensor
from repro_torch.utils.scan import chunked_scan, local_scan


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bs i, i ... -> bs ...")``: contract x's last axis with w's
    first, in x's dtype (a (heads, hd) weight through the attention's
    flatten and split, which keep a DTensor's heads whole)."""
    if w.dim() == 3:
        return split_heads(x @ flatten_heads(w.to(x.dtype), 1), *w.shape[1:])
    return x @ w.to(x.dtype)


def _log_sigmoid(f_pre: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-f_pre)


# ---------------------------------------------------------------------------
# mLSTM


def init_mlstm(gen: torch.Generator, cfg, dtype):
    d, inner, h = cfg.d_model, cfg.ssm_inner, cfg.xlstm_heads
    hd = inner // h
    return {
        "in_proj": dense_init(gen, d, (2 * inner,), dtype),
        "wq": dense_init(gen, inner, (h, hd), dtype),
        "wk": dense_init(gen, inner, (h, hd), dtype),
        "wv": dense_init(gen, inner, (h, hd), dtype),
        "gates": dense_init(gen, inner, (2 * h,), torch.float32),  # i, f pre-activations
        "out_proj": dense_init(gen, inner, (d,), dtype),
    }


def _mlstm_cell(carry, qkvif):
    """One time step, vectorised over (B, H). carry: C (B, H, hd, hd), n
    (B, H, hd), m (B, H); q, k, v (B, H, hd) and i_pre, f_pre (B, H), f32."""
    c, n, m = carry
    q, k, v, i_pre, f_pre = qkvif
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g[..., None, None] * c + i_g[..., None, None] * (v[..., :, None] * k[..., None, :])
    n_new = f_g[..., None] * n + i_g[..., None] * k
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n_new, q)), torch.exp(-m_new))
    h_out = torch.einsum("bhde,bhe->bhd", c_new, q) / denom[..., None]
    return (c_new, n_new, m_new), h_out


def mlstm_forward(params, x, cfg, state: Optional[Dict] = None, return_state: bool = False):
    """x: (B, S, d). ``state`` (``{"C", "n", "m"}``) continues a sequence;
    None starts from zeros (the stabiliser ``m`` at 0)."""
    b, s, _ = x.shape
    h, inner = cfg.xlstm_heads, cfg.ssm_inner
    hd = inner // h
    xin, z = _mm(x, params["in_proj"]).chunk(2, dim=-1)
    xin = constrain(xin, "batch", None, "tp")
    scale = 1.0 / torch.tensor(float(hd), device=x.device).sqrt()
    q = _mm(xin, params["wq"]).float() * scale
    k = _mm(xin, params["wk"]).float() * scale
    v = _mm(xin, params["wv"]).float()
    i_pre, f_pre = (xin.float() @ params["gates"]).chunk(2, dim=-1)  # (B, S, H) each
    if state is None:
        st = init_mlstm_state(cfg, b, x.device)
        carry = (st["C"], st["n"], st["m"])
    else:
        carry = (state["C"], state["n"], state["m"])
    tfirst = lambda t: t.transpose(0, 1)  # (S, B, ...)
    xs = (tfirst(q), tfirst(k), tfirst(v), tfirst(i_pre), tfirst(f_pre))
    scan = lambda c, n, m, *xs: chunked_scan(_mlstm_cell, (c, n, m), xs, chunk=cfg.ssm_chunk)
    if is_dtensor(q):  # each rank scans its own heads
        step, gate = (None, "batch", "heads", None), (None, "batch", "heads")
        carry_lg = (("batch", "heads", None, None), ("batch", "heads", None), ("batch", "heads"))
        (c_f, n_f, m_f), hs = local_scan(
            scan, (*carry, *xs), (*carry_lg, step, step, step, gate, gate),
            (*((c.shape, lg) for c, lg in zip(carry, carry_lg)), (xs[0].shape, step)),
        )
    else:
        (c_f, n_f, m_f), hs = scan(*carry, *xs)
    hs = flatten_heads(hs.transpose(0, 1), 2).to(x.dtype)  # (B, S, inner)
    out = constrain((hs * F.silu(z)) @ params["out_proj"].to(x.dtype), "batch", None, None)
    if return_state:
        return out, {"C": c_f, "n": n_f, "m": m_f}
    return out


def init_mlstm_state(cfg, batch: int, device="cpu") -> Dict[str, torch.Tensor]:
    h = cfg.xlstm_heads
    hd = cfg.ssm_inner // h
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"C": zeros(batch, h, hd, hd), "n": zeros(batch, h, hd), "m": zeros(batch, h)}


# ---------------------------------------------------------------------------
# sLSTM


def init_slstm(gen: torch.Generator, cfg, dtype):
    d, h = cfg.d_model, cfg.xlstm_heads
    hd = d // h
    return {
        # input projections of the 4 gates (z, i, f, o), fused
        "w": dense_init(gen, d, (4 * d,), dtype),
        # block-diagonal (per-head) recurrence of the 4 gates, (4, H, hd, hd)
        "r": dense_init(gen, hd, (4, h, hd), torch.float32, scale=0.5).permute(1, 2, 0, 3).contiguous(),
        "out_proj": dense_init(gen, d, (d,), dtype),
    }


def _slstm_cell(r, carry, wx):
    """carry: h, c, n (B, H, hd), m (B, H). wx: (B, 4, H, hd) input
    pre-activations."""
    h, c, n, m = carry
    pre = wx + torch.einsum("ghde,bhe->bghd", r, h)
    z_pre, i_pre, f_pre, o_pre = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    log_f = _log_sigmoid(f_pre)
    # a per-head scalar stabiliser: the max over the head's gate pre-activations
    i_max = torch.amax(i_pre, dim=-1)
    f_shift = torch.amax(log_f, dim=-1) + m
    m_new = torch.maximum(f_shift, i_max)
    i_g = torch.exp(i_pre - m_new[..., None])
    f_g = torch.exp(log_f + (m - m_new)[..., None])
    c_new = f_g * c + i_g * torch.tanh(z_pre)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new), h_new


def slstm_forward(params, x, cfg, state: Optional[Dict] = None, return_state: bool = False):
    """x: (B, S, d). ``state`` (``{"h", "c", "n", "m"}``) continues a
    sequence; None starts from zeros."""
    b, s, d = x.shape
    h = cfg.xlstm_heads
    hd = d // h
    wx = whole_where_cut((x @ params["w"].to(x.dtype)).float(), 2, 4).reshape(b, s, 4, h, hd)
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    carry = (state["h"], state["c"], state["n"], state["m"])
    scan = lambda r, wx, *carry: chunked_scan(
        lambda cr, w_t: _slstm_cell(r, cr, w_t), carry, wx, chunk=cfg.ssm_chunk
    )
    wx = wx.transpose(0, 1)  # (S, B, 4, H, hd)
    if is_dtensor(wx):  # each rank scans its own heads
        row = ("batch", "heads", None)
        carry_lg = (row, row, row, ("batch", "heads"))
        (h_f, c_f, n_f, m_f), hs = local_scan(
            scan, (params["r"], wx, *carry), ((None, "heads", None, None), (None, "batch", None, "heads", None), *carry_lg),
            (*((c.shape, lg) for c, lg in zip(carry, carry_lg)), ((s, b, h, hd), (None, "batch", "heads", None))),
        )
    else:
        (h_f, c_f, n_f, m_f), hs = scan(params["r"], wx, *carry)
    hs = flatten_heads(hs.transpose(0, 1), 2).to(x.dtype)  # (B, S, d)
    out = constrain(hs @ params["out_proj"].to(x.dtype), "batch", None, None)
    if return_state:
        return out, {"h": h_f, "c": c_f, "n": n_f, "m": m_f}
    return out


def init_slstm_state(cfg, batch: int, device="cpu") -> Dict[str, torch.Tensor]:
    h = cfg.xlstm_heads
    hd = cfg.d_model // h
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"h": zeros(batch, h, hd), "c": zeros(batch, h, hd), "n": zeros(batch, h, hd), "m": zeros(batch, h)}
