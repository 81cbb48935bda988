"""Chunk-checkpointed scan for recurrent mixers (the port's copy of
``repro.utils.scan``).

Backpropagation through a loop over time keeps every step's residuals: for
mLSTM the carry is the (B, H, hd, hd) matrix memory, so a T-step sequence
keeps O(T · B · d²) of them. :func:`chunked_scan` splits the loop into
chunks and, when gradients are on, runs each chunk under
``torch.utils.checkpoint``: only the chunk-boundary carries are kept, and
the backward pass recomputes one chunk's steps at a time. Memory:
O(T/chunk · |carry| + chunk · |step residuals|).

On ``meta`` tensors (the dry-run) a loop runs its first two steps or
chunks and counts the second for the rest (:func:`counted_times`): every
step has the same shapes, and ``meta`` has no values.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.build import META_LISTENERS


@contextlib.contextmanager
def _times(n: int):
    """Every count of the listening counters taken ``n`` times in the body."""
    active = list(META_LISTENERS)
    for counter in active:
        counter.scale *= n
    try:
        yield
    finally:
        for counter in active:
            counter.scale //= n


class _Times(torch.autograd.Function):
    """The identity on a repeated step's outputs (``up``) and inputs, whose
    backward counts the step's backward ``n`` times: autograd runs the
    outputs' marker, then every op of the step's backward (each has a
    sequence number between the two markers'), then the inputs' marker,
    which adds ``n - 1`` times what the counters took in between. Nested
    loops nest their markers. The outputs' marker saves a tensor, so that
    inside a checkpoint the recompute (counted by its own forward) runs
    before the marker's count starts."""

    @staticmethod
    def forward(ctx, token, up, *ts):
        ctx.token, ctx.up = token, up
        if up:  # inside a checkpoint, unpacking it recomputes the region first
            ctx.save_for_backward(ts[0])
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        token = ctx.token
        if ctx.up:
            ctx.saved_tensors  # a checkpoint's recompute, counted as the forward it is, before the snapshot
            token["since"] = {counter: counter.snapshot() for counter in META_LISTENERS}
        else:
            for counter, snap in token.pop("since", {}).items():
                counter.add_since(snap, token["n"] - 1)
        return (None, None, *grads)


def _marked(token, up: bool, tree):
    flat, spec = tree_flatten(tree)
    at = [i for i, t in enumerate(flat) if isinstance(t, torch.Tensor) and t.requires_grad]
    if not at:
        return tree
    for i, t in zip(at, _Times.apply(token, up, *(flat[i] for i in at))):
        flat[i] = t
    return tree_unflatten(flat, spec)


def counted_times(n: int, fn: Callable, *args):
    """``fn(*args)``, run once and counted ``n`` times by the counters
    listening to :data:`repro_torch.kernels.build.META_LISTENERS` (the
    dry-run's ``OpCounter``: its ``scale``, ``snapshot`` and ``add_since``),
    its backward too where a gradient reaches its inputs (a step whose
    gradient reaches only a weight it closes over has its backward counted
    once)."""
    grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(args))
    token = {"n": n}
    if grad:
        args = _marked(token, False, args)
    with _times(n):
        out = fn(*args)
    return _marked(token, True, out) if grad else out


def _step_slice(xs, i):
    return tuple(x[i] for x in xs) if isinstance(xs, tuple) else xs[i]


def _stack(ys):
    if isinstance(ys[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*ys))
    return torch.stack(ys)


def _steps(step: Callable, carry: Any, n: int) -> Tuple[Any, list]:
    """``step(carry, i) -> (carry, y_i)`` for i in range(n), the ``y_i`` in a
    list; on ``meta`` steps 0 and 1 only, step 1 counted for steps 1..n-1
    and its outputs standing for theirs."""
    if n > 2 and any(torch.is_tensor(t) and t.is_meta for t in (carry if isinstance(carry, tuple) else (carry,))):
        carry, y0 = step(carry, 0)
        carry, y1 = counted_times(n - 1, step, carry, 1)
        return carry, [y0] + [y1] * (n - 1)
    ys = []
    for i in range(n):
        carry, y = step(carry, i)
        ys.append(y)
    return carry, ys


def _loop(cell: Callable, carry: Any, xs: Any) -> Tuple[Any, Any]:
    """``lax.scan(cell, carry, xs)``: ``cell(carry, x_t) -> (carry, y_t)``
    for each step of the leading axis, the ``y_t`` stacked on it."""
    t = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
    carry, ys = _steps(lambda c, i: cell(c, _step_slice(xs, i)), carry, t)
    return carry, _stack(ys)


def chunked_scan(cell: Callable, carry: Any, xs: Any, chunk: int, use_checkpoint: bool = True):
    """Like ``lax.scan(cell, carry, xs)`` but checkpointed at chunk
    boundaries. ``xs`` is a tensor or a tuple of tensors with leading time
    axis T, ``carry`` a tuple of tensors. A plain loop when T is not a
    multiple of ``chunk`` or one chunk covers it; otherwise a loop over
    chunks, each chunk's loop under a non-reentrant checkpoint when
    ``use_checkpoint`` and gradients are on."""
    t = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
    chunk = min(chunk, t)
    if t % chunk or chunk == t:
        return _loop(cell, carry, xs)
    remat = use_checkpoint and torch.is_grad_enabled()

    def one_chunk(carry, i):
        sl = slice(i * chunk, (i + 1) * chunk)
        xs_c = tuple(x[sl] for x in xs) if isinstance(xs, tuple) else xs[sl]
        if remat:
            return checkpoint(_loop, cell, carry, xs_c, use_reentrant=False, preserve_rng_state=False)
        return _loop(cell, carry, xs_c)

    carry, ys = _steps(one_chunk, carry, t // chunk)
    if isinstance(ys[0], tuple):
        return carry, tuple(torch.cat(parts) for parts in zip(*ys))
    return carry, torch.cat(ys)


def local_scan(fn: Callable, args, in_logical, out_logical):
    """``fn(*args)`` for a recurrence over DTensor ``args`` (the Mamba,
    mLSTM and sLSTM scans), run on each rank's local shards: a step's ops
    are per channel or per head, so each rank scans its own channels or
    heads with no communication. ``in_logical`` gives each argument's
    logical axes and ``out_logical`` each (flattened) output's as
    ``(shape, logical)``; the placements come from
    :func:`repro_torch.sharding.partition.logical_placements`, so inputs
    and outputs that share a dim share its split."""
    from repro_torch.kernels.dispatch import on_local_shards
    from repro_torch.sharding.partition import logical_placements, replicated

    mesh = next(a.device_mesh for a in args if hasattr(a, "device_mesh"))
    # a plain argument (a zero initial carry) is the same on every rank
    args = tuple(replicated(a, mesh) for a in args)
    in_pl = [logical_placements(a.shape, lg, mesh) for a, lg in zip(args, in_logical)]
    out_pl = tuple(logical_placements(shape, lg, mesh) for shape, lg in out_logical)
    return on_local_shards("recurrent_scan", fn, args, in_pl, out_pl)
