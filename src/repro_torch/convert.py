"""Carry parameters between the JAX package and the port.

A JAX parameter tree travels as numpy arrays, either nested or flattened
to ``a/b/c`` paths (:func:`repro_torch.utils.trees.flatten_dict`). The
layouts differ only in the weights:

* conv weights: JAX HWIO → port OIHW;
* dense weights: JAX ``(din, dout)`` → port ``(dout, din)``, the
  ``nn.Linear`` layout;
* the generator's ``label_embed`` table ``(num_classes, latent)`` keeps its
  layout (it is indexed, not multiplied);
* 1-D leaves (norm scales and biases) are unchanged;
* non-array leaves (``"stride"`` of a residual block) stay plain Python
  values.

The first dense layer of ``lenet5``, ``cnn5`` and ``cnn2`` reads features
flattened from NHWC; the port flattens in NHWC order too
(:mod:`repro_torch.models.cnn`), so its rows need no permutation.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.cnn import CNN_ARCHS
from repro_torch.utils.trees import flatten_dict, unflatten_dict

GENERATOR = "image_generator"
ARCHS = CNN_ARCHS + (GENERATOR,)

_KEEP_LAYOUT = {GENERATOR: ("label_embed",)}


def _check_arch(arch: str) -> None:
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")


def _to_port(path: str, a: np.ndarray, keep: bool) -> np.ndarray:
    if keep or a.ndim <= 1:
        return a
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if a.ndim == 2:
        return a.T  # (din, dout) -> (dout, din)
    raise ValueError(f"{path}: no port layout for a {a.ndim}-D weight")


def _to_jax(path: str, a: np.ndarray, keep: bool) -> np.ndarray:
    if keep or a.ndim <= 1:
        return a
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if a.ndim == 2:
        return a.T
    raise ValueError(f"{path}: no JAX layout for a {a.ndim}-D weight")


def params_from_jax(arch: str, tree: Dict[str, Any], device="cpu", dtype=torch.float32) -> Dict[str, Any]:
    """JAX params of ``arch`` (a CNN arch or ``"image_generator"``) as numpy
    arrays → the port's nested dict of tensors on ``device``."""
    _check_arch(arch)
    keep = _KEEP_LAYOUT.get(arch, ())
    out = {}
    for path, leaf in flatten_dict(tree).items():
        if isinstance(leaf, (int, float, bool, str)):
            out[path] = leaf
            continue
        a = np.asarray(leaf)
        if a.ndim == 0:
            out[path] = a.item()
            continue
        out[path] = torch.tensor(_to_port(path, a, path in keep), dtype=dtype, device=device)
    return unflatten_dict(out)


def params_to_jax(arch: str, params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: nested dict of numpy arrays
    in the JAX layouts."""
    _check_arch(arch)
    keep = _KEEP_LAYOUT.get(arch, ())
    out = {}
    for path, leaf in flatten_dict(params).items():
        if not torch.is_tensor(leaf):
            out[path] = leaf
            continue
        a = leaf.detach().cpu().numpy()
        out[path] = np.ascontiguousarray(_to_jax(path, a, path in keep))
    return unflatten_dict(out)
