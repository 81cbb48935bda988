"""The paper's label-conditional image generator (the port of
``repro.models.generator.image_generator``): a latent-to-image decoder
(dense → 2× upsample conv stack → tanh); and the embedding-space generator
of LM-scale Co-Boosting (``embedding_generator``): tokens are discrete, so
for token models the generator synthesizes (B, S, d_model) sequences that
the client ensemble reads in place of embedded tokens.

Normalization is batch norm over (B, H, W) computed on the fly from batch
statistics with the biased variance — the generator only ever runs in
training mode — and the affine is ``x·(1 + scale) + bias`` with
zero-initialised parameters, as in the reference. Images come out NHWC.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.cnn import _conv_init, _dense_init, conv2d


def _bn(x, scale, bias, eps=1e-5):
    """Batch norm of an NCHW tensor over (B, H, W) with batch statistics."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, correction=0)
    x = (x - mean) * torch.rsqrt(var + eps)
    return x * (1 + scale.view(1, -1, 1, 1)) + bias.view(1, -1, 1, 1)


def _bn_params(c, device):
    return {"scale": torch.zeros((c,), device=device), "bias": torch.zeros((c,), device=device)}


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def init_image_generator(
    gen: torch.Generator, latent_dim: int, num_classes: int, out_shape: Tuple[int, int, int],
    base: int = 64, device=None,
) -> Dict:
    h, w, c = out_shape
    if h % 4 or w % 4:
        raise ValueError(f"image sides must be divisible by 4, got {out_shape}")
    device = device if device is not None else gen.device
    h0, w0 = h // 4, w // 4
    return {
        "label_embed": torch.randn((num_classes, latent_dim), generator=gen, device=device) * 0.1,
        "fc": _dense_init(gen, 2 * latent_dim, h0 * w0 * 2 * base, device),
        "bn0": _bn_params(2 * base, device),
        "conv1": _conv_init(gen, 3, 2 * base, 2 * base, device),
        "bn1": _bn_params(2 * base, device),
        "conv2": _conv_init(gen, 3, 2 * base, base, device),
        "bn2": _bn_params(base, device),
        "conv3": _conv_init(gen, 3, base, c, device),
    }


def image_generator(params: Dict, z: torch.Tensor, y: torch.Tensor, out_shape: Tuple[int, int, int], base: int = 64) -> torch.Tensor:
    """z: (B, nz); y: (B,) int labels. Returns images in [-1, 1], NHWC.
    The dense output is laid out NHWC, as the reference reshapes it."""
    h0, w0, c0 = out_shape[0] // 4, out_shape[1] // 4, 2 * base
    emb = params["label_embed"][y]
    x = torch.cat([z, emb], dim=-1)
    x = F.linear(x, params["fc"]).reshape(-1, h0, w0, c0).permute(0, 3, 1, 2)
    x = _bn(x, **params["bn0"])
    x = _upsample2(x)
    x = F.leaky_relu(_bn(conv2d(x, params["conv1"]), **params["bn1"]), 0.2)
    x = _upsample2(x)
    x = F.leaky_relu(_bn(conv2d(x, params["conv2"]), **params["bn2"]), 0.2)
    x = torch.tanh(conv2d(x, params["conv3"]))
    return x.permute(0, 2, 3, 1)


def init_embedding_generator(
    gen: torch.Generator, latent_dim: int, num_classes: int, seq_len: int, d_model: int, hidden: int = 256,
    device=None,
) -> Dict:
    """Dense weights in the ``nn.Linear`` layout (out, in); the reference's
    are (in, out) (:mod:`repro_torch.convert` carries them across)."""
    device = device if device is not None else gen.device
    dh = min(d_model, hidden)
    return {
        "label_embed": torch.randn((num_classes, latent_dim), generator=gen, device=device) * 0.1,
        "fc1": _dense_init(gen, 2 * latent_dim, hidden, device),
        "fc2": _dense_init(gen, hidden, seq_len * dh, device),
        "proj": _dense_init(gen, dh, d_model, device),
    }


def embedding_generator(params: Dict, z: torch.Tensor, y: torch.Tensor, seq_len: int, hidden: int = 256) -> torch.Tensor:
    """z: (B, nz); y: (B,) int labels. Returns (B, S, d_model) synthetic
    embeddings."""
    dh = params["proj"].shape[1]
    x = torch.cat([z, params["label_embed"][y]], dim=-1)
    x = F.relu(F.linear(x, params["fc1"]))
    x = torch.tanh(F.linear(x, params["fc2"]).reshape(-1, seq_len, dh))
    return F.linear(x, params["proj"])
