"""The paper's client model zoo: small image classifiers (the port of
``repro.models.cnn``).

All models share one functional interface, with NHWC images as in the JAX
package:

    params = init_cnn(generator, arch, num_classes, in_shape, device)
    logits = cnn_apply(arch, params, images)        # images: (B, H, W, C)

Layouts (see :mod:`repro_torch.convert`): conv weights are OIHW, dense
weights ``(dout, din)`` as ``nn.Linear`` keeps them. Inside a model the
NHWC input is viewed as NCHW (``permute``, no copy: the tensor is simply
channels-last), and the first dense layer reads its features flattened in
NHWC order, exactly as the JAX models flatten them, so dense weights carry
over with a transpose and no row permutation.

Two numerical details follow the reference exactly: "SAME" padding is
XLA's (at stride 2 an even input pads (0, 1), not PyTorch's symmetric
``padding=1``), and GroupNorm uses the biased variance and the affine
``x·(1 + scale) + bias`` with zero-initialised parameters.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

CNN_ARCHS = ("lenet5", "cnn5", "cnn2", "miniresnet", "mlp")


def _conv_init(gen, k, cin, cout, device):
    std = math.sqrt(2.0 / (k * k * cin))
    return torch.randn((cout, cin, k, k), generator=gen, device=device) * std


def _dense_init(gen, din, dout, device):
    std = math.sqrt(2.0 / din)
    return torch.randn((dout, din), generator=gen, device=device) * std


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA "SAME" padding (low, high) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """"SAME" convolution of an NCHW tensor with OIHW weights."""
    k = w.shape[-1]
    top, bottom = _same_pads(x.shape[2], k, stride)
    left, right = _same_pads(x.shape[3], k, stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def max_pool(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    return F.max_pool2d(x, k)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes of NHWC ``x``: (B, H, W, C) -> (B, C)."""
    return x.mean(dim=(1, 2))


def group_norm(x, scale, bias, groups=8, eps=1e-5):
    b, c, h, w = x.shape
    g = min(groups, c)
    while c % g:
        g -= 1
    # statistics in f32 at least (float64 stays float64: an exact reference)
    xg = x.reshape(b, g, c // g, h, w).to(torch.promote_types(x.dtype, torch.float32))
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    x = xg.reshape(b, c, h, w)
    return x * (1 + scale.view(1, c, 1, 1)) + bias.view(1, c, 1, 1)


def _gn_params(c, device):
    return {"scale": torch.zeros((c,), device=device), "bias": torch.zeros((c,), device=device)}


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _flatten_nhwc(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# architectures


def _init_lenet5(gen, num_classes, in_shape, device):
    h, w, c = in_shape
    fh, fw = h // 4, w // 4  # two 2x2 pools
    return {
        "c1": _conv_init(gen, 5, c, 6, device),
        "c2": _conv_init(gen, 5, 6, 16, device),
        "f1": _dense_init(gen, fh * fw * 16, 120, device),
        "f2": _dense_init(gen, 120, 84, device),
        "out": _dense_init(gen, 84, num_classes, device),
    }


def _apply_lenet5(p, x):
    x = max_pool(torch.tanh(conv2d(_nchw(x), p["c1"])))
    x = max_pool(torch.tanh(conv2d(x, p["c2"])))
    x = _flatten_nhwc(x)
    x = torch.tanh(F.linear(x, p["f1"]))
    x = torch.tanh(F.linear(x, p["f2"]))
    return F.linear(x, p["out"])


def _init_cnn5(gen, num_classes, in_shape, device):
    """McMahan et al. 5-layer CNN: 2 conv + 3 fc."""
    h, w, c = in_shape
    fh, fw = h // 4, w // 4
    return {
        "c1": _conv_init(gen, 5, c, 32, device),
        "c2": _conv_init(gen, 5, 32, 64, device),
        "f1": _dense_init(gen, fh * fw * 64, 512, device),
        "f2": _dense_init(gen, 512, 128, device),
        "out": _dense_init(gen, 128, num_classes, device),
    }


def _apply_relu_cnn(p, x):
    """cnn5 and cnn2: two relu conv + pool stages, three dense layers."""
    x = max_pool(F.relu(conv2d(_nchw(x), p["c1"])))
    x = max_pool(F.relu(conv2d(x, p["c2"])))
    x = _flatten_nhwc(x)
    x = F.relu(F.linear(x, p["f1"]))
    x = F.relu(F.linear(x, p["f2"]))
    return F.linear(x, p["out"])


def _init_cnn2(gen, num_classes, in_shape, device):
    """PyTorch-tutorial CNN: conv6/conv16 + 3 fc."""
    h, w, c = in_shape
    fh, fw = h // 4, w // 4
    return {
        "c1": _conv_init(gen, 5, c, 6, device),
        "c2": _conv_init(gen, 5, 6, 16, device),
        "f1": _dense_init(gen, fh * fw * 16, 120, device),
        "f2": _dense_init(gen, 120, 84, device),
        "out": _dense_init(gen, 84, num_classes, device),
    }


def _init_resblock(gen, cin, cout, stride, device):
    p = {
        "c1": _conv_init(gen, 3, cin, cout, device),
        "n1": _gn_params(cout, device),
        "c2": _conv_init(gen, 3, cout, cout, device),
        "n2": _gn_params(cout, device),
        "stride": stride,
    }
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, cin, cout, device)
    return p


def _apply_resblock(p, x):
    s = p["stride"]
    h = F.relu(group_norm(conv2d(x, p["c1"], stride=s), p["n1"]["scale"], p["n1"]["bias"]))
    h = group_norm(conv2d(h, p["c2"]), p["n2"]["scale"], p["n2"]["bias"])
    sc = conv2d(x, p["proj"], stride=s) if "proj" in p else x
    return F.relu(h + sc)


def _init_miniresnet(gen, num_classes, in_shape, device):
    _, _, c = in_shape
    return {
        "stem": _conv_init(gen, 3, c, 32, device),
        "stem_n": _gn_params(32, device),
        "b1": _init_resblock(gen, 32, 32, 1, device),
        "b2": _init_resblock(gen, 32, 64, 2, device),
        "b3": _init_resblock(gen, 64, 128, 2, device),
        "out": _dense_init(gen, 128, num_classes, device),
    }


def _apply_miniresnet(p, x):
    x = F.relu(group_norm(conv2d(_nchw(x), p["stem"]), p["stem_n"]["scale"], p["stem_n"]["bias"]))
    x = _apply_resblock(p["b1"], x)
    x = _apply_resblock(p["b2"], x)
    x = _apply_resblock(p["b3"], x)
    return F.linear(x.mean(dim=(2, 3)), p["out"])


def _init_mlp(gen, num_classes, in_shape, device):
    h, w, c = in_shape
    return {
        "f1": _dense_init(gen, h * w * c, 256, device),
        "f2": _dense_init(gen, 256, 128, device),
        "out": _dense_init(gen, 128, num_classes, device),
    }


def _apply_mlp(p, x):
    x = x.reshape(x.shape[0], -1)
    x = F.relu(F.linear(x, p["f1"]))
    x = F.relu(F.linear(x, p["f2"]))
    return F.linear(x, p["out"])


_ARCHS = {
    "lenet5": (_init_lenet5, _apply_lenet5),
    "cnn5": (_init_cnn5, _apply_relu_cnn),
    "cnn2": (_init_cnn2, _apply_relu_cnn),
    "miniresnet": (_init_miniresnet, _apply_miniresnet),
    "mlp": (_init_mlp, _apply_mlp),
}


def init_cnn(gen: torch.Generator, arch: str, num_classes: int, in_shape: Tuple[int, int, int], device=None) -> Dict:
    """He-normal init drawn from ``gen`` (on ``gen``'s device by default)."""
    init, _ = _ARCHS[arch]
    return init(gen, num_classes, in_shape, device if device is not None else gen.device)


def cnn_apply(arch: str, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (B, num_classes) of NHWC images ``x``."""
    _, apply = _ARCHS[arch]
    return apply(params, x)


def make_cnn(arch: str, num_classes: int, in_shape: Tuple[int, int, int]):
    """Returns (init_fn(generator, device=None) -> params, apply_fn(params,
    images) -> logits); the reference's init takes a key where this one
    takes a ``torch.Generator``."""
    _, apply = _ARCHS[arch]

    def init(gen: torch.Generator, device=None) -> Dict:
        return init_cnn(gen, arch, num_classes, in_shape, device)

    return init, apply
