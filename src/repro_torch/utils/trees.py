"""Parameter-tree utilities.

Params in the port are nested ``dict``s of tensors, as in the JAX package
(the LM keeps a ``list`` of per-layer dicts, which the maps walk too);
non-tensor leaves (``"stride"`` in a residual block) stay plain Python
values and pass through every map untouched. Paths are "/"-joined key
strings (e.g. ``"b2/c1"``), a list index standing as its number; the path
walks (:func:`tree_paths`, :func:`iter_leaves_with_path`) visit a dict's
keys sorted and count every leaf, tensor or not, as JAX flattens a pytree,
so their paths and order are the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

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


def tree_size(tree: Any) -> int:
    """Total number of scalar elements over the tensor leaves (a DTensor
    counts its global shape)."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    """Total bytes over the tensor leaves, by their dtypes (``meta`` tensors
    too; a DTensor counts its global shape)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


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


def tree_map_with_path(fn: Callable[[str, torch.Tensor], Any], tree: Any) -> Any:
    """Map ``fn(path_str, leaf)`` over the tensor leaves of ``tree``;
    non-tensor leaves are kept as they are."""

    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(_join(prefix, k), v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(_join(prefix, i), v) for i, v in enumerate(node)]
        return fn(prefix, node) if torch.is_tensor(node) else node

    return walk("", tree)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def iter_leaves_with_path(tree: Any) -> Iterator[Tuple[str, Any]]:
    """``(path_str, leaf)`` for every leaf (``None`` is no leaf, as in JAX),
    a dict's keys in sorted order."""

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(_join(prefix, k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(_join(prefix, i), v)
        elif node is not None:
            yield prefix, node

    return walk("", tree)


def tree_paths(tree: Any) -> List[str]:
    """The "/"-joined path of every leaf, in the reference's order."""
    return [p for p, _ in iter_leaves_with_path(tree)]


def tree_index(tree: Any, i) -> Any:
    """Index every tensor leaf's axis 0."""
    return tree_map(lambda x: x[i], tree)


def tree_zeros_like(tree: Any) -> Any:
    return tree_map(torch.zeros_like, tree)


def tree_cast(tree: Any, dtype) -> Any:
    """Cast the floating-point tensor leaves to ``dtype``; integer leaves
    stay."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_scale(tree: Any, s) -> Any:
    return tree_map(lambda x: x * s, tree)


def tree_l2_norm(tree: Any) -> torch.Tensor:
    """The global L2 norm over the tensor leaves, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


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
