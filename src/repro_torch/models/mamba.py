"""Mamba (S6) selective state-space mixer (the port's copy of
``repro.models.mamba``).

The recurrence ``h_t = a_t * h_{t-1} + b_t`` runs as a chunked scan: a
loop over chunks of ``cfg.ssm_chunk`` steps carrying the (B, inner, N)
state, and inside each chunk a log-depth scan over the chunk axis: the
recursion of ``jax.lax.associative_scan`` (⌈log2 Q⌉ levels of the
reference's combine, in its order, so the rounding follows the
reference's). A
sequence that is not a multiple of the chunk is zero-padded: a padded step
has dt = 0, so its decay is 1 and its input 0, and the carry passes through
unchanged. When gradients are on, each chunk runs under
``torch.utils.checkpoint``, so the backward pass keeps only the chunk
boundary states.

Decode is the same forward over one token from the state {conv tail, h}.
``dt_bias``, ``A_log`` and ``D`` are f32 leaves; the conv state is in the
activation dtype, ``h`` in f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import dense_init
from repro_torch.sharding.partition import constrain, is_dtensor
from repro_torch.utils.scan import local_scan


def init_mamba(gen: torch.Generator, cfg, dtype):
    d, inner, n, r = cfg.d_model, cfg.ssm_inner, cfg.ssm_state_dim, cfg.dt_rank_
    dev = gen.device
    # A initialised to -[1..N] per channel (S4D-real), stored as its log
    a_init = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[None, :].repeat(inner, 1)
    return {
        "in_proj": dense_init(gen, d, (2 * inner,), dtype),
        "conv": dense_init(gen, cfg.ssm_conv_dim, (inner,), dtype, scale=1.0),
        "x_proj": dense_init(gen, inner, (r + 2 * n,), dtype),
        "dt_proj": dense_init(gen, r, (inner,), dtype),
        "dt_bias": torch.log(torch.expm1(torch.full((inner,), 1e-2, dtype=torch.float32, device=dev))),
        "A_log": torch.log(a_init),
        "D": torch.ones((inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, inner, (d,), dtype),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B, S, inner); w: (K, inner); ``state``:
    (B, K-1, inner), the tail of the previous segment, or None for zero
    history. Returns (y, the new tail)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i : i + x.shape[1]] * w[i][None, None, :] for i in range(k))
    return y, xp[:, -(k - 1):] if k > 1 else torch.zeros_like(state)


def _ssm_params(params, xc, cfg):
    """xc: (B, S, inner) post-conv activations → (dt, B_ssm, C_ssm, A)."""
    n, r = cfg.ssm_state_dim, cfg.dt_rank_
    # the scan's splits (channels over "tp", the projections' partial sums
    # reduced), before the nonlinearity: DTensor would otherwise split a
    # partial sum over the sequence, which the scan's chunks cannot take
    dbc = constrain(xc @ params["x_proj"].to(xc.dtype), "batch", None, None)
    dt, b_ssm, c_ssm = dbc.split([r, n, n], dim=-1)
    dt = constrain(dt @ params["dt_proj"].to(xc.dtype), "batch", None, "tp")
    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])  # (inner, N)
    return dt, b_ssm.float(), c_ssm.float(), a


def _combine(a1, b1, a2, b2):
    """The reference's ``associative_scan`` combine of two steps of
    ``h -> a·h + b``, the earlier first."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """Merge along axis 1: even[0], odd[0], even[1], … (``even`` is as long
    as ``odd`` or one longer)."""
    n = odd.shape[1]
    merged = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([merged, even[:, n:]], dim=1) if even.shape[1] > n else merged


def _associative_scan(a, b):
    """Inclusive scan of ``h_t = a_t · h_{t-1} + b_t`` over axis 1 (from
    h = 0), by the recursion of ``jax.lax.associative_scan``: combine
    adjacent pairs, scan the half-length sequence, then combine it with the
    even steps and interleave. Log depth (⌈log2 Q⌉ levels, a few tensor ops
    each), O(Q) work, and the reference's order of the combines. Returns
    the scanned ``(a, b)``; ``b`` is h."""
    q = a.shape[1]
    if q < 2:
        return a, b
    odd_a, odd_b = _associative_scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]))
    if q % 2 == 0:
        even_a, even_b = _combine(odd_a[:, :-1], odd_b[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        even_a, even_b = _combine(odd_a, odd_b, a[:, 2::2], b[:, 2::2])
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_b = torch.cat([b[:, :1], even_b], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _chunk_scan(dt, b_ssm, c_ssm, a, xc, h0):
    """The selective scan over one chunk. dt: (B, Q, inner) f32; b_ssm,
    c_ssm: (B, Q, N); a: (inner, N); xc: (B, Q, inner); h0: (B, inner, N).
    Returns (y (B, Q, inner) f32, h_Q)."""
    da = torch.exp(dt[..., None] * a[None, None])  # (B, Q, inner, N) decay
    db = dt[..., None] * b_ssm[:, :, None, :] * xc.float()[..., None]
    # the carry folds into the first step: h_1 = da_1 h0 + db_1
    db = torch.cat([db[:, :1] + (da[:, 0] * h0)[:, None], db[:, 1:]], dim=1)
    _, h = _associative_scan(da, db)
    y = torch.einsum("bqin,bqn->bqi", h, c_ssm)
    return y, h[:, -1]


def mamba_forward(params, x, cfg, state: Optional[Dict] = None, return_state: bool = False):
    """x: (B, S, d). Returns y (B, S, d) [, the new state]."""
    b, s, _ = x.shape
    xin, z = (x @ params["in_proj"].to(x.dtype)).chunk(2, dim=-1)
    xin = constrain(xin, "batch", None, "tp")
    conv_state = None if state is None else state["conv"]
    xc, conv_tail = _causal_conv(xin, params["conv"].to(x.dtype), conv_state)
    xc = F.silu(xc)
    dt, b_ssm, c_ssm, a = _ssm_params(params, xc, cfg)
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    if pad:
        dt, b_ssm, c_ssm, xc = (F.pad(t, (0, 0, 0, pad)) for t in (dt, b_ssm, c_ssm, xc))
    inner, n = a.shape
    h = torch.zeros((b, inner, n), dtype=torch.float32, device=x.device) if state is None else state["h"]

    def scan(dt, b_ssm, c_ssm, a, xc, h):
        remat = torch.is_grad_enabled()
        ys = []
        for start in range(0, dt.shape[1], q):
            blk = tuple(t[:, start : start + q] for t in (dt, b_ssm, c_ssm))
            xq = xc[:, start : start + q]
            if remat:
                # only the chunk-boundary states are kept; the backward pass
                # recomputes one chunk's (B, Q, inner, N) tensors at a time
                y, h = checkpoint(_chunk_scan, *blk, a, xq, h, use_reentrant=False, preserve_rng_state=False)
            else:
                y, h = _chunk_scan(*blk, a, xq, h)
            ys.append(y)
        return torch.cat(ys, dim=1), h

    if is_dtensor(xc):  # each rank scans its own channels
        chan, row = ("batch", None, "tp"), ("batch", None, None)
        y, h = local_scan(
            scan, (dt, b_ssm, c_ssm, a, xc, h), (chan, row, row, ("tp", None), chan, ("batch", "tp", None)),
            ((dt.shape, chan), (h.shape, ("batch", "tp", None))),
        )
    else:
        y, h = scan(dt, b_ssm, c_ssm, a, xc, h)
    y = y[:, :s] + xc[:, :s].float() * params["D"]
    y = y.to(x.dtype) * F.silu(z)
    out = constrain(y @ params["out_proj"].to(x.dtype), "batch", None, None)
    if return_state:
        return out, {"conv": conv_tail, "h": h}
    return out


def init_mamba_state(cfg, batch: int, dtype, device="cpu") -> Dict[str, torch.Tensor]:
    inner, n = cfg.ssm_inner, cfg.ssm_state_dim
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_dim - 1, inner), dtype=dtype, device=device),
        "h": torch.zeros((batch, inner, n), dtype=torch.float32, device=device),
    }


def mamba_decode(params, x, cfg, state):
    """One-token step. x: (B, 1, d)."""
    return mamba_forward(params, x, cfg, state=state, return_state=True)
