"""Shared layers of the LM (the port's copy of ``repro.models.layers``).

Params are nested dicts of tensors in the JAX package's einsum layouts:
an MLP's ``wi``/``wg`` are ``(d, f)`` and its ``wo`` is ``(f, d)``, so a
weight crosses from JAX without a transpose. Weights are cast to the
activation dtype where they are used, as the reference does.

The MLP is SwiGLU (``act="silu"``: ``wi``, ``wg``, ``wo``) or, for
``act="gelu"`` (hubert), two matrices around a GELU in its tanh form, the
default of the reference's ``jax.nn.gelu`` (``F.gelu``'s default is the
exact erf form, up to about 1e-3 away); :func:`apply_mlp` tells them apart
by the presence of ``wg``, as the reference does.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.partition import constrain


def dense_init(gen: torch.Generator, in_dim: int, out_shape: Tuple[int, ...], dtype, scale: float = 1.0):
    """Fan-in scaled normal; ``out_shape`` may be multi-dim (``(H, hd)``)."""
    w = torch.randn((in_dim, *out_shape), generator=gen, device=gen.device)
    return (w * (scale / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype):
    return (torch.randn((vocab, dim), generator=gen, device=gen.device) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the ``1 + scale`` affine, computed in f32."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dtype)


@functools.lru_cache(maxsize=16)
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """The rotary frequencies (computed once per head dim, theta, device)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, split-half (not interleaved). x: (B, S, H, hd);
    positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# Under a mesh an MLP's output has its tensor-parallel partial sums reduced,
# as the attention's has: added to the residual stream unreduced, DTensor
# would split the stream over the sequence.


def swiglu(x, wi, wg, wo):
    h = x @ wi.to(x.dtype)
    g = x @ wg.to(x.dtype)
    return constrain(constrain(h * F.silu(g), "batch", None, "tp") @ wo.to(x.dtype), "batch", None, None)


def gelu_mlp(x, wi, wo):
    h = constrain(F.gelu(x @ wi.to(x.dtype), approximate="tanh"), "batch", None, "tp")
    return constrain(h @ wo.to(x.dtype), "batch", None, None)


def init_mlp(gen: torch.Generator, cfg, dtype):
    """SwiGLU's three matrices, or GELU's two (``wi`` then ``wo``, in the
    reference's draw order, which skips the gate's key)."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":
        return {
            "wi": dense_init(gen, d, (f,), dtype),
            "wg": dense_init(gen, d, (f,), dtype),
            "wo": dense_init(gen, f, (d,), dtype),
        }
    return {"wi": dense_init(gen, d, (f,), dtype), "wo": dense_init(gen, f, (d,), dtype)}


def apply_mlp(params, x, cfg):
    if "wg" in params:
        return swiglu(x, params["wi"], params["wg"], params["wo"])
    return gelu_mlp(x, params["wi"], params["wo"])
