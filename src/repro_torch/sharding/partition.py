"""Divisibility-aware parameter/activation partitioning (the port's copy of
``repro.sharding.partition``).

The framework uses *logical* axis names in rules and resolves them against
whatever mesh is in context:

=============  =====================================================
logical axis   mesh axes it maps to
=============  =====================================================
``batch``      ``("pod", "data")`` — data parallel (pod folds in)
``fsdp``       ``("pod", "data")`` — fully-sharded parameter dim
``tp``         ``("model",)``     — tensor-parallel dim
``experts``    ``("model",)``     — expert-parallel dim (MoE)
``seq``        ``("model",)``     — sequence-sharded KV cache (decode)
=============  =====================================================

Resolution checks divisibility of the array dim against the mesh-axis-size
product; when it does not divide, it retries progressively smaller axis
subsets and finally falls back to replication. This single mechanism is what
lets one rule set serve smollm's 9 heads and qwen3's 64 heads, mixtral's 8
experts and qwen3-moe's 128, granite's 49155 vocab and qwen's 151936.

Rules are matched on parameter *path suffixes*. The port keeps one dict a
layer (``layers/i/attn/wq``, no leading group dim) where the reference
stacks ``groups/pJ/attn/wq`` over a leading G dim; the same suffix rules
serve both, and extra leading dims are padded with ``None``. The decode and
engine state rules are written for the port's flat state names
(``k_pages``, ``mamba.conv``, ``mlstm.C``, ...), each dim keeping the
logical axis the reference gives its counterpart.

A spec is a :class:`PartitionSpec`: one entry a tensor dim, ``None``, a
mesh axis name or a tuple of them (major first). On a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
:func:`to_placements` turns it into DTensor placements: a dim named with
one mesh axis is ``Shard(dim)`` on that mesh dim, a dim named with a tuple
``("pod", "data")`` is ``Shard(dim)`` on both, and every other mesh dim is
``Replicate()``. :func:`constrain` is the analogue of
``with_sharding_constraint``: under a mesh (:func:`mesh_context`) it
redistributes a DTensor to the resolved spec, and without one it is the
identity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

LogicalSpec = Tuple[Optional[str], ...]


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s shape: a tuple of ``None | str |
    tuple[str, ...]``, one entry a dim (missing trailing entries mean
    replicated); equal entry by entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

_LOGICAL_TO_MESH: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    # stacked client axis of a grouped ClientBank (core/client_bank.py):
    # clients within a homogeneous group data-parallelize across the mesh
    "clients": ("pod", "data"),
    "tp": ("model",),
    "experts": ("model",),
    "seq": ("model",),
    "heads": ("model",),
    "vocab": ("model",),
}

# (path regex, [candidate logical specs in preference order])
LOGICAL_RULES: List[Tuple[str, List[LogicalSpec]]] = [
    (r"embed/table$", [("vocab", "fsdp"), (None, "fsdp")]),
    (r"lm_head/kernel$", [("fsdp", "vocab"), ("fsdp", None)]),
    (r"pred_head/kernel$", [("fsdp", "vocab"), ("fsdp", None)]),
    # attention
    (r"attn/w[qkv]$", [("fsdp", "heads", None), ("fsdp", None, None)]),
    (r"attn/wo$", [("heads", None, "fsdp"), (None, None, "fsdp")]),
    (r"attn/[qk]_norm$", [(None,)]),
    # dense MLP
    (r"mlp/w[ig]$", [("fsdp", "tp")]),
    (r"mlp/wo$", [("tp", "fsdp")]),
    # MoE
    (r"moe/router$", [("fsdp", None)]),
    (r"moe/w[ig]$", [("experts", "fsdp", None), (None, "fsdp", "tp")]),
    (r"moe/wo$", [("experts", None, "fsdp"), (None, "tp", "fsdp")]),
    # mamba
    (r"mamba/in_proj$", [("fsdp", "tp")]),
    (r"mamba/conv$", [(None, "tp")]),
    (r"mamba/x_proj$", [("tp", None)]),
    (r"mamba/dt_proj$", [(None, "tp")]),
    (r"mamba/A_log$", [("tp", None)]),
    (r"mamba/D$", [("tp",)]),
    (r"mamba/out_proj$", [("tp", "fsdp")]),
    # xlstm
    (r"xlstm/in_proj$", [("fsdp", "tp")]),
    (r"xlstm/w[qkv]$", [("fsdp", "heads", None), ("fsdp", None, None)]),
    (r"xlstm/gates$", [("fsdp", None)]),
    (r"xlstm/out_proj$", [("tp", "fsdp")]),
    (r"xlstm/r[zifo]$", [("heads", None, None), (None, None, None)]),
    # vision / audio frontend projector stubs
    (r"projector/kernel$", [("fsdp", "tp")]),
    # norms, biases, scalars
    (r"(scale|bias|b)$", [(None,)]),
]


# ---------------------------------------------------------------------------
# the mesh in context

_MESHES: List[Any] = []


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or None for no mesh) the one that
    :func:`constrain` and :func:`_mesh_axes` read, for the ``with`` body.
    Under a mesh, a plain tensor that meets a DTensor in an op counts as
    replicated (DTensor's ``implicit_replication``): the positions, masks
    and page tables the models make are computed the same on every rank."""
    _MESHES.append(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The mesh in context, or None."""
    return _MESHES[-1] if _MESHES else None


def mesh_axes_of(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``{}`` for None)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh_axes() -> Dict[str, int]:
    return mesh_axes_of(current_mesh())


# ---------------------------------------------------------------------------
# resolution


def resolve_rule(
    logical: LogicalSpec,
    shape: Sequence[int],
    mesh_axes: Dict[str, int],
) -> P:
    """Resolve one logical spec against a concrete shape + mesh.

    For each dim, keep the largest prefix-product of candidate mesh axes that
    divides the dim size; axes already used by an earlier dim are skipped
    (a mesh axis may appear at most once in a PartitionSpec).
    """
    used: set = set()
    out: List[Any] = []
    ndims = len(shape)
    # pad leading Nones for stacked/scanned extra dims
    spec = (None,) * (ndims - len(logical)) + tuple(logical)
    for dim, name in zip(shape, spec):
        if name is None:
            out.append(None)
            continue
        cands = [a for a in _LOGICAL_TO_MESH[name] if a in mesh_axes and a not in used]
        chosen: List[str] = []
        prod = 1
        for a in cands:
            if dim % (prod * mesh_axes[a]) == 0:
                chosen.append(a)
                prod *= mesh_axes[a]
        if not chosen:
            out.append(None)
        else:
            used.update(chosen)
            out.append(tuple(chosen) if len(chosen) > 1 else chosen[0])
    return P(*out)


def logical_to_pspec(logical: LogicalSpec, shape: Sequence[int]) -> P:
    return resolve_rule(logical, shape, _mesh_axes())


def _match(path: str) -> Optional[List[LogicalSpec]]:
    for pattern, candidates in LOGICAL_RULES:
        if re.search(pattern, path):
            return candidates
    return None


def _score(spec: P) -> int:
    n = 0
    for s in spec:
        if s is None:
            continue
        n += len(s) if isinstance(s, tuple) else 1
    return n


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and not isinstance(x, (dict, list, tuple))


def map_with_path(fn, tree: Any, prefix: str = "", is_leaf=_is_leaf) -> Any:
    """``fn(path, leaf)`` over the leaves of a tree of dicts, lists, tuples
    and dataclasses (a :class:`~repro_torch.serve.engine.DecodeState`),
    paths "/"-joined (list items by index, dataclass fields by name). A
    leaf is what ``is_leaf`` says (by default anything with a ``shape``);
    other values are kept."""
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if is_leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, join(k), is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, join(i), is_leaf) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: map_with_path(fn, getattr(tree, f.name), join(f.name), is_leaf)
                             for f in dataclasses.fields(tree)})
    return tree


def infer_param_specs(params: Any, mesh_axes: Optional[Dict[str, int]] = None) -> Any:
    """Build a PartitionSpec tree for a param tree (of tensors, meta tensors
    or anything with a ``shape``). Resolves against the mesh currently in
    context unless ``mesh_axes`` is given explicitly — a fleet shards each
    replica against ITS mesh slice without entering N mesh contexts."""
    mesh_axes = _mesh_axes() if mesh_axes is None else dict(mesh_axes)

    def infer(path: str, leaf) -> P:
        if not mesh_axes:
            return P()
        candidates = _match(path)
        if candidates is None:
            return P(*([None] * len(leaf.shape)))
        best = None
        for logical in candidates:
            spec = resolve_rule(logical, leaf.shape, mesh_axes)
            if best is None or _score(spec) > _score(best):
                best = spec
        return best

    return map_with_path(infer, params)


def batch_pspec(batch_size: int, extra_dims: int = 1) -> P:
    """PartitionSpec for a batched activation: shard dim0 over data axes if
    divisible, remaining dims replicated."""
    mesh_axes = _mesh_axes()
    if not mesh_axes:
        return P()
    spec = resolve_rule(("batch",), (batch_size,), mesh_axes)
    return P(spec[0], *([None] * extra_dims))


def activation_pspec(shape: Sequence[int], logical: LogicalSpec) -> P:
    return resolve_rule(logical, shape, _mesh_axes())


# The port's decode state is flat: attention caches "k", "v" (L_attn, B, S,
# KH, hd) or "k_pages", "v_pages", and recurrent carries "<mixer>.<leaf>"
# (L_mixer, B, ...). Each rule gives the dims the logical axes of the
# reference's counterpart ((G, B, ...) under groups/pJ/).
_STATE_RULES: List[Tuple[str, LogicalSpec]] = [
    # attention KV cache (L, B, S, K, hd): batch over data, seq over model
    (r"(^|/)(k|v)$", (None, "batch", "seq", None, None)),
    # mamba conv tail (L, B, K-1, inner) and state h (L, B, inner, N); the
    # sLSTM's h (L, B, H, hd) takes the same rule, as in the reference
    (r"(^|[/.])conv$", (None, "batch", None, "tp")),
    (r"(^|[/.])h$", (None, "batch", "tp", None)),
    # mLSTM / sLSTM per-head states
    (r"(^|[/.])C$", (None, "batch", "heads", None, None)),
    (r"(^|[/.])(n|c)$", (None, "batch", "heads", None)),
    (r"(^|[/.])m$", (None, "batch", "heads")),
]


def _state_specs(state: Any, rules, mesh_axes: Dict[str, int], scalar_whole: bool) -> Any:
    def infer(path: str, leaf) -> P:
        ndim = len(leaf.shape)
        if not mesh_axes or (scalar_whole and ndim == 0):
            return P()
        for pattern, logical in rules:
            if re.search(pattern, path):
                spec = logical[-ndim:] if len(logical) >= ndim else logical
                return resolve_rule(spec, leaf.shape, mesh_axes)
        return P(*([None] * ndim))

    return map_with_path(infer, state)


def decode_state_specs(state: Any, mesh_axes: Optional[Dict[str, int]] = None) -> Any:
    """PartitionSpec tree for a decode/prefill state (KV caches are
    sequence-sharded over the model axis; SSM states channel-sharded)."""
    mesh_axes = _mesh_axes() if mesh_axes is None else dict(mesh_axes)
    return _state_specs(state, _STATE_RULES, mesh_axes, scalar_whole=False)


# Serving-engine state (repro_torch.serve.engine.DecodeState). Unlike the
# training/prefill state above, the batch dim here is SLOTS — requests land
# on arbitrary slots at arbitrary times, so the slot dim stays replicated
# and parallelism comes from the heads/channel dims (tensor-parallel decode:
# every model shard serves every slot, holding only its heads' pages).
_ENGINE_STATE_RULES: List[Tuple[str, LogicalSpec]] = [
    # paged KV pools (L, pool_pages, page, KH, hd): heads over the model
    # axis — each shard holds EVERY page's slice of ITS kv-heads, so page
    # ids (and the host free list) stay global and the handoff scatter is
    # shard-local. Never shard the page dim: ids are data, not layout. A
    # sealed handoff (L, N, n_alloc, page, KH, hd) right-aligns onto it.
    (r"(^|/)(k|v)_pages$", (None, None, None, "heads", None)),
    # dense engine KV (L, slots, cache_len, KH, hd): same heads split
    (r"(^|/)(k|v)$", (None, None, None, "heads", None)),
    # recurrent carries, per-slot dense: channel-sharded like training state
    (r"(^|[/.])conv$", (None, None, None, "tp")),
    (r"(^|[/.])h$", (None, None, "tp", None)),
    (r"(^|[/.])C$", (None, None, "heads", None, None)),
    (r"(^|[/.])(n|c)$", (None, None, "heads", None)),
    (r"(^|[/.])m$", (None, None, "heads")),
]


def shard_engine_state(state: Any, mesh_axes: Optional[Dict[str, int]] = None) -> Any:
    """PartitionSpec tree for a serving-engine ``DecodeState``: KV page
    pools / dense caches sharded along the heads axis, recurrent carries
    channel-sharded, and every slot-bookkeeping leaf (positions, budgets,
    output rows, page tables) replicated — the host mutates those by slot
    id and the numbers must read the same from every shard.

    The rules match on path SUFFIXES, so they apply to any tree that nests
    a cache under an extra prefix — the speculative drafter's dense state
    (``{"draft": ...}``) picks up the same ``k``, ``v`` heads split as the
    target's dense engine state without a drafter-specific rule."""
    mesh_axes = _mesh_axes() if mesh_axes is None else dict(mesh_axes)
    return _state_specs(state, _ENGINE_STATE_RULES, mesh_axes, scalar_whole=True)


# ---------------------------------------------------------------------------
# DTensor placement


def to_placements(spec: Sequence, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim: a tensor
    dim named with a mesh axis (alone or in a tuple, major first) is
    ``Shard(dim)`` on that mesh dim; every other mesh dim is
    ``Replicate()``. A tuple must name its axes in the mesh's order, which
    is how DTensor nests shards (the first mesh dim outermost). A mesh dim
    of size 1 holds the whole dim either way and is ``Replicate()``: a mesh
    of size 1 places every leaf whole."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = list(mesh.shape)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {tuple(names)}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def logical_placements(shape: Sequence[int], logical: LogicalSpec, mesh) -> Tuple:
    """The placements of a tensor of ``shape`` under ``logical`` on
    ``mesh`` (what :func:`constrain` redistributes to)."""
    return to_placements(resolve_rule(tuple(logical), shape, mesh_axes_of(mesh)), mesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicated(x: torch.Tensor, mesh):
    """A plain tensor every rank holds the same value of, as a replicated
    DTensor on ``mesh`` (no communication); a DTensor is kept."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor on every rank (redistributed
    to ``Replicate()`` first), so that every rank takes the same host
    decision from it; a plain tensor is kept."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim).to_local()


def place(tree: Any, specs: Any, mesh) -> Any:
    """Distribute every tensor leaf of ``tree`` over ``mesh`` by the
    matching spec of ``specs`` (from :func:`infer_param_specs` or
    :func:`decode_state_specs`). Every rank passes the same values; each
    keeps only its shard."""
    from torch.distributed.tensor import distribute_tensor

    flat: Dict[str, Any] = {}
    map_with_path(lambda path, s: flat.__setitem__(path, s), specs, is_leaf=lambda s: isinstance(s, PartitionSpec))

    def put(path, leaf):
        if not torch.is_tensor(leaf):
            return leaf
        return distribute_tensor(leaf, mesh, to_placements(flat[path], mesh))

    return map_with_path(put, tree)


def shard_whole(tree: Any, specs: Any, mesh) -> Any:
    """As :func:`place`, for values every rank of ``mesh`` already holds
    whole (received, or computed the same everywhere): each rank keeps its
    own shard, with no communication."""
    flat: Dict[str, Any] = {}
    map_with_path(lambda path, s: flat.__setitem__(path, s), specs, is_leaf=lambda s: isinstance(s, PartitionSpec))

    def put(path, leaf):
        if not torch.is_tensor(leaf):
            return leaf
        return replicated(leaf, mesh).redistribute(mesh, to_placements(flat[path], mesh))

    return map_with_path(put, tree)


def shard_params(params: Any, mesh) -> Any:
    """The params as DTensors on ``mesh``, placed by
    :func:`infer_param_specs` against ITS axes (the reference's
    ``_shard_params``): FSDP over the data axes, tensor/expert parallel over
    ``model``."""
    return place(params, infer_param_specs(params, mesh_axes=mesh_axes_of(mesh)), mesh)


class _Constrained(torch.autograd.Function):
    """``x`` redistributed to ``placements``, whose gradient is brought to
    the same placements before it flows on (as a sharding constraint's
    cotangent is constrained in the reference): DTensor would otherwise
    give it whatever split its backward ops pick (a sequence split, say,
    which a later flatten cannot take)."""

    @staticmethod
    def forward(ctx, x, placements):
        from torch.distributed.tensor import Replicate

        ctx.placements = placements
        ctx.in_placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        out = x.redistribute(x.device_mesh, placements)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        g = g.redistribute(g.device_mesh, ctx.placements)
        return g.redistribute(g.device_mesh, ctx.in_placements), None


def as_placed(w: torch.Tensor) -> torch.Tensor:
    """``w`` for one of several uses of a parameter (the tied embedding's
    lookup and head): each use's gradient takes the parameter's placements
    before autograd sums them, so the sum never meets two placements (a
    lookup's partial sums and a product's split, which torch 2.11's
    DTensor cannot add). The identity off a mesh."""
    if is_dtensor(w) and w.requires_grad and torch.is_grad_enabled():
        return _Constrained.apply(w, tuple(w.placements))
    return w


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Sharding-constrain an activation by logical axis names: under a mesh,
    ``x`` redistributed to the resolved spec (a plain tensor counts as
    replicated: every rank computed the same value), and its gradient too
    where it has one. The identity when no mesh is in context (unit tests /
    single-device runs)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    placements = logical_placements(x.shape, logical, mesh)
    x = replicated(x, mesh)
    if x.requires_grad and torch.is_grad_enabled():
        return _Constrained.apply(x, placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)
