"""Parameter-tree utilities.

Params in the port are nested ``dict``s of tensors, as in the JAX package;
non-tensor leaves (``"stride"`` in a residual block) stay plain Python
values and pass through every map untouched. Paths are "/"-joined key
strings (e.g. ``"b2/c1"``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch


def flatten_dict(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Flatten a nested dict into {"a/b/c": leaf}."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, key))
        else:
            out[key] = v
    return out


def unflatten_dict(d: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_dict`."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        parts = k.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def tree_map(fn: Callable[..., torch.Tensor], tree: Dict[str, Any], *rest: Dict[str, Any]) -> Dict[str, Any]:
    """Map ``fn`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``); non-tensor leaves of ``tree`` are kept as they are."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = tree_map(fn, v, *(r[k] for r in rest))
        elif torch.is_tensor(v):
            out[k] = fn(v, *(r[k] for r in rest))
        else:
            out[k] = v
    return out


def value_and_grad(fn: Callable[..., torch.Tensor], params: Dict[str, Any], *args) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``(fn(params, *args), d fn / d params)``: the loss (detached) and a
    tree of gradients shaped like ``params``. Only the tensor leaves of
    ``params`` are differentiated; a leaf the loss does not reach gets a zero
    gradient, as ``jax.grad`` gives it."""
    flat = flatten_dict(params)
    keys = [k for k, v in flat.items() if torch.is_tensor(v)]
    leaves = {k: flat[k].detach().requires_grad_() for k in keys}
    loss = fn(unflatten_dict({**flat, **leaves}), *args)
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
    gflat = {
        k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(keys, grads)
    }
    return loss.detach(), unflatten_dict({**flat, **gflat})
