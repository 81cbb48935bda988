"""Chunk-checkpointed scan for recurrent mixers (the port's copy of
``repro.utils.scan``).

Backpropagation through a loop over time keeps every step's residuals: for
mLSTM the carry is the (B, H, hd, hd) matrix memory, so a T-step sequence
keeps O(T · B · d²) of them. :func:`chunked_scan` splits the loop into
chunks and, when gradients are on, runs each chunk under
``torch.utils.checkpoint``: only the chunk-boundary carries are kept, and
the backward pass recomputes one chunk's steps at a time. Memory:
O(T/chunk · |carry| + chunk · |step residuals|).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def _step_slice(xs, i):
    return tuple(x[i] for x in xs) if isinstance(xs, tuple) else xs[i]


def _stack(ys):
    if isinstance(ys[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*ys))
    return torch.stack(ys)


def _loop(cell: Callable, carry: Any, xs: Any) -> Tuple[Any, Any]:
    """``lax.scan(cell, carry, xs)``: ``cell(carry, x_t) -> (carry, y_t)``
    for each step of the leading axis, the ``y_t`` stacked on it."""
    t = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
    ys = []
    for i in range(t):
        carry, y = cell(carry, _step_slice(xs, i))
        ys.append(y)
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
    ys = []
    for start in range(0, t, chunk):
        sl = slice(start, start + chunk)
        xs_c = tuple(x[sl] for x in xs) if isinstance(xs, tuple) else xs[sl]
        if remat:
            carry, y = checkpoint(_loop, cell, carry, xs_c, use_reentrant=False, preserve_rng_state=False)
        else:
            carry, y = _loop(cell, carry, xs_c)
        ys.append(y)
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
