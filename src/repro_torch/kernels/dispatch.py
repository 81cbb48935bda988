"""Kernel backend dispatch for the port's ops (the counterpart of
``repro.kernels.dispatch``): which implementation of a kernel-backed op
runs.

A backend covers BOTH passes of a differentiable op. The unified entry
point is :func:`resolve`, keyed by *op*:

* ``"loss"``   — the Eq. 4/6/11-12 fused losses (``ensemble_kl`` / ``ghm_ce``)
* ``"attn"``   — train/prefill flash attention (``flash_attention``)
* ``"decode"`` — paged Sq=1 decode attention (``flash_decode``)

and by *backend* value:

* ``"auto"`` — the fused op (a ``torch.autograd.Function`` whose forward and
  backward are the hand kernels): each wrapper launches its Hopper kernel
  for CUDA tensors and computes its plain PyTorch version for CPU tensors.
* ``"cuda"`` — the hand kernels only; CPU tensors raise.
* ``"ref"``  — the plain PyTorch oracle under plain autograd.

There is no fallback: a kernel that fails to compile or launch raises.

:class:`BackendPolicy` bundles one choice per op (plus a shared default)
and is the one configuration surface for all of them: ``OFLConfig.backend``
and ``ModelConfig.backend`` carry one, and ``cfg.backend_for(op)`` reads
it. A plain string (the launchers' ``--backend``) means that value for
every op.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

KERNEL_BACKENDS = ("auto", "cuda", "ref")

#: The ops the dispatch layer routes; each has one slot on BackendPolicy.
BACKEND_OPS = ("loss", "attn", "decode")


def check_backend(backend: str, what: str = "kernel backend") -> None:
    if backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown {what} {backend!r}; expected one of {KERNEL_BACKENDS}")


def _check_op(op: str) -> None:
    if op not in BACKEND_OPS:
        raise ValueError(f"unknown backend op {op!r}; expected one of {BACKEND_OPS}")


@dataclass(frozen=True)
class BackendPolicy:
    """One backend choice per dispatched op, with a shared default.

    Empty per-op fields fall back to ``default``; every field takes the
    :data:`KERNEL_BACKENDS` values."""

    default: str = "auto"
    loss: str = ""  # ensemble_kl / ghm_ce (the OFL epoch losses)
    attn: str = ""  # train/prefill flash attention
    decode: str = ""  # paged Sq=1 decode attention

    def __post_init__(self):
        check_backend(self.default)
        for op in BACKEND_OPS:
            if getattr(self, op):
                check_backend(getattr(self, op), f"{op} kernel backend")

    def for_op(self, op: str) -> str:
        """The requested (unresolved) backend for ``op``."""
        _check_op(op)
        return getattr(self, op) or self.default


def as_policy(backend) -> BackendPolicy:
    """A config's ``backend`` field as a policy: a plain string means that
    value for every op, a :class:`BackendPolicy` is kept."""
    if isinstance(backend, BackendPolicy):
        return backend
    if isinstance(backend, str):
        return BackendPolicy(default=backend)
    raise TypeError(f"backend must be a BackendPolicy or a string, got {type(backend).__name__}")


def resolve(op: str, backend: str, device) -> str:
    """Map (op, requested backend, device of the op's tensors) to
    ``"fused"`` (the autograd.Function over the kernel wrappers) or
    ``"ref"`` (autograd of the plain oracle)."""
    _check_op(op)
    check_backend(backend)
    if backend == "ref":
        return "ref"
    if backend == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(
            f"{op} backend 'cuda' requires CUDA tensors (got {device}); "
            "use 'auto' or 'ref' on the CPU"
        )
    return "fused"


# ---------------------------------------------------------------------------
# the sharded route: kernels and strategy-less ops on local shards

#: Calls of each op run on every rank's local shards through ``local_map``
#: (the ops DTensor has no sharding strategy for, and the hand kernels),
#: counted where the call is made; tests and ``chip_smoke.py`` read them.
LOCAL_MAP_CALLS = {
    "flash_attention": 0,  # kernels #5–#7 (forward and, under autograd, both backward passes)
    "flash_decode": 0,  # kernel #8
    "kv_scatter": 0,  # in-place cache / page-pool / carry writes
    "page_gather": 0,  # the page-table view of a paged pool
    "moe_dispatch": 0,  # routing, capacity positions and the index_add fill
    "recurrent_scan": 0,  # the Mamba, mLSTM and sLSTM recurrences
    "client_bank": 0,  # a client group's vmapped forward on each rank's own clients
    "ensemble_kl": 0,  # kernels #1 and #2 on each rank's rows of a sharded client stack
    "ghm_ce": 0,  # kernels #3 and #4, the same
    "vocab_ce": 0,  # the cross-entropy's per-rank statistics over a vocabulary slice
    "vocab_kl": 0,  # the distillation KL's, the same
}


def reset_local_map_calls() -> None:
    for k in LOCAL_MAP_CALLS:
        LOCAL_MAP_CALLS[k] = 0


def on_local_shards(op: str, fn, args, in_placements, out_placements):
    """``fn(*args)`` on each rank's local shards (``local_map``): every
    DTensor argument is first redistributed to its entry of
    ``in_placements`` (None for a plain argument, which every rank holds
    whole), and each tensor ``fn`` returns is wrapped with its entry of
    ``out_placements``. Differentiable: an argument replicated over a mesh
    dim that another argument is sharded on is used by each rank only
    against its own shard, so its gradient comes back as a partial sum
    over that mesh dim; every other gradient takes its argument's
    placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    LOCAL_MAP_CALLS[op] += 1
    in_placements = tuple(None if p is None else tuple(p) for p in in_placements)
    sharded = {i for p in in_placements if p is not None for i, q in enumerate(p) if isinstance(q, Shard)}
    grad_placements = tuple(
        None if p is None else tuple(Partial() if i in sharded and isinstance(q, Replicate) else q
                                     for i, q in enumerate(p))
        for p in in_placements
    )
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=grad_placements, redistribute_inputs=True)(*args)


def on_row_split(op: str, fn, stack, per_row, w):
    """A loss kernel (#1–#4) on a client stack ``stack`` (K, B, V) that is
    a DTensor, e.g. the grouped bank's logits split over the clients: every
    row needs all K clients, so the stack is redistributed from its client
    split to a split of the B rows over the data axes (whole where they do
    not divide B), and ``fn(stack, *per_row, w)`` runs on each rank's rows
    with K whole (``on_local_shards``, counted under ``op``). ``per_row``
    ((B, ...) tensors: the student's logits, the labels) and ``w`` (K,) are
    plain tensors every rank holds whole. The per-row output, split
    ``Shard(0)``, is made whole, so the caller (the server, the generator)
    sees a plain tensor; through it every cotangent comes back whole and
    equal on every rank: the stack's split as it came, the rows'
    gathered, and ``w``'s a partial sum over the ranks, reduced."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.partition import logical_placements, replicated

    mesh = stack.device_mesh
    rows = logical_placements((stack.shape[1],), ("batch",), mesh)
    stack_rows = tuple(Shard(1) if isinstance(p, Shard) else p for p in rows)
    args = [stack] + [replicated(t, mesh) for t in per_row] + [replicated(w, mesh)]
    whole = (Replicate(),) * mesh.ndim
    out = on_local_shards(op, fn, args, (stack_rows, *([rows] * len(per_row)), whole), [*rows])
    return out.full_tensor()
