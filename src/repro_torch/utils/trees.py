"""Parameter-tree utilities.

Params in the port are nested ``dict``s of tensors, as in the JAX package
(the LM keeps a ``list`` of per-layer dicts, which the maps walk too);
non-tensor leaves (``"stride"`` in a residual block) stay plain Python
values and pass through every map untouched. Paths are "/"-joined key
strings (e.g. ``"b2/c1"``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

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


def tree_leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensor leaves of ``tree``, in its key order (lists of dicts, like
    the LM's ``params["layers"]``, included)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def tree_map(fn: Callable[..., torch.Tensor], tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``), through dicts and lists; non-tensor leaves of ``tree`` are
    kept as they are."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    return tree


def tree_stack(trees: List[Any]) -> Any:
    """Stack identically structured trees along a new leading axis 0. A
    non-tensor leaf (a block's ``"stride"``) must be equal in every tree and
    stays one unstacked value."""
    t0 = trees[0]
    if isinstance(t0, dict):
        if any(set(t) != set(t0) for t in trees[1:]):
            raise ValueError(f"trees to stack have different keys: {[sorted(t) for t in trees]}")
        return {k: tree_stack([t[k] for t in trees]) for k in t0}
    if isinstance(t0, list):
        if any(len(t) != len(t0) for t in trees[1:]):
            raise ValueError(f"lists to stack have different lengths: {[len(t) for t in trees]}")
        return [tree_stack([t[i] for t in trees]) for i in range(len(t0))]
    if torch.is_tensor(t0):
        return torch.stack(trees)
    if any(t != t0 for t in trees[1:]):
        raise ValueError(f"non-tensor leaves differ across the trees to stack: {trees}")
    return t0


def tree_unstack(tree: Any, n: int) -> List[Any]:
    """Inverse of :func:`tree_stack`: ``n`` trees, the i-th of every tensor
    leaf's rows; non-tensor leaves are shared."""
    return [tree_map(lambda x, i=i: x[i], tree) for i in range(n)]


def vmap_dims(tree: Any) -> Any:
    """``torch.func.vmap``'s ``in_dims`` for a stacked tree: 0 at every
    tensor leaf, ``None`` at every non-tensor leaf."""
    if isinstance(tree, dict):
        return {k: vmap_dims(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [vmap_dims(v) for v in tree]
    return 0 if torch.is_tensor(tree) else None


def value_and_grad(fn: Callable[..., torch.Tensor], params: Any, *args) -> Tuple[torch.Tensor, Any]:
    """``(fn(params, *args), d fn / d params)``: the loss (detached) and a
    tree of gradients shaped like ``params``. Only the tensor leaves of
    ``params`` are differentiated; a leaf the loss does not reach gets a zero
    gradient, as ``jax.grad`` gives it."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    loss = fn(tree_map(lambda _: next(it), params), *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)
