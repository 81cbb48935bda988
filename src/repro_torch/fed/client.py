"""Client-side local training (the phase that happens *before* the single
communication round — Co-Boosting never touches it, per the model-market
constraint)."""
from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.train import TrainConfig
from repro_torch.core.losses import ce_loss, ce_per_sample
from repro_torch.data.loader import batch_iterator
from repro_torch.optim.optimizers import apply_updates, clip_by_global_norm, make_optimizer
from repro_torch.utils.trees import flatten_dict, tree_leaves, tree_map, unflatten_dict, value_and_grad, vmap_dims


def local_train(
    apply_fn: Callable,
    params: Any,
    x: np.ndarray,
    y: np.ndarray,
    tc: TrainConfig,
    epochs: int,
) -> Any:
    """SGD-momentum local training on one client's shard (paper App. B.1:
    lr=0.01, momentum=0.9), on the device of ``params``. Batches follow
    :func:`repro_torch.data.loader.batch_iterator` and the gradient is
    clipped where ``tc.grad_clip_norm > 0``, as in the reference."""
    device = next(v for v in params.values() if torch.is_tensor(v)).device
    opt = make_optimizer(tc)
    opt_state = opt.init(params)

    def loss_fn(p, xb, yb):
        return ce_loss(apply_fn(p, xb), yb)

    for i, (xb, yb) in enumerate(batch_iterator(x, y, tc.batch_size, seed=tc.seed, epochs=epochs)):
        xb = torch.as_tensor(xb, device=device)
        yb = torch.as_tensor(yb, device=device).long()
        _, grads = value_and_grad(loss_fn, params, xb, yb)
        grads = clip_by_global_norm(grads, tc.grad_clip_norm)
        updates, opt_state = opt.update(grads, opt_state, params, i)
        params = apply_updates(params, updates)
    return params


def _group_schedule(
    shard_sizes: Sequence[int], batch_size: int, seed: int, epochs: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side replica of every group member's ``batch_iterator`` walk.

    For each client: per-epoch ``RandomState(seed+e)`` shuffle, contiguous
    batches, partial last batch kept (padded up to ``batch_size`` and
    masked). Clients with fewer steps than the group max get invalid
    (masked-out) trailing steps. Returns ``(idx, m, valid)`` with shapes
    ``(S, G, B)``, ``(S, G, B)``, ``(S, G)``, step-major so that one step
    slices the whole group at a time.
    """
    G, B = len(shard_sizes), batch_size
    steps = [epochs * -(-n // B) for n in shard_sizes]
    S = max(steps)
    idx = np.zeros((G, S, B), np.int32)
    m = np.zeros((G, S, B), np.float32)
    valid = np.zeros((G, S), bool)
    for k, n in enumerate(shard_sizes):
        t = 0
        for e in range(epochs):
            order = np.random.RandomState(seed + e).permutation(n)
            for i in range(0, n, B):
                b = order[i : i + B]
                idx[k, t, : len(b)] = b
                m[k, t, : len(b)] = 1.0
                valid[k, t] = True
                t += 1
    return idx.swapaxes(0, 1), m.swapaxes(0, 1), valid.swapaxes(0, 1)


def local_train_group(
    apply_fn: Callable,
    stacked_params: Any,
    shards: Sequence[Tuple[np.ndarray, np.ndarray]],
    tc: TrainConfig,
    epochs: int,
) -> Any:
    """Local training of one homogeneous client group at once, on the device
    of ``stacked_params`` (the group's inits, clients on the leading axis;
    ``shards``: one ``(x_k, y_k)`` pair per client, any sizes).

    A Python loop over the steps; each step takes every client's gradient
    in one ``torch.func.vmap(torch.func.grad(...))`` and one optimizer update
    of the stacked tree (the port's optimizers are elementwise). The same
    semantics as per-client :func:`local_train`: each client's
    ``batch_iterator`` batches (replicated by :func:`_group_schedule`), the
    masked-mean CE on a partial batch (``sum(ce·mask)/count``, the per-batch
    mean), the gradient clipped per client where ``tc.grad_clip_norm > 0``,
    and a client whose shard has run out keeps its params and its optimizer
    state. The schedule lives on the device, so no step reads the host.
    Non-tensor leaves (a block's ``"stride"``) are held out of the
    differentiation and passed through."""
    opt = make_optimizer(tc)
    G = len(shards)
    device = tree_leaves(stacked_params)[0].device
    sizes = [len(x) for x, _ in shards]
    x0 = np.asarray(shards[0][0])
    X = np.zeros((G, max(sizes), *x0.shape[1:]), x0.dtype)
    Y = np.zeros((G, max(sizes)), np.int64)
    for k, (xk, yk) in enumerate(shards):
        X[k, : sizes[k]] = xk
        Y[k, : sizes[k]] = yk
    idx, m, valid = _group_schedule(sizes, tc.batch_size, tc.seed, epochs)
    X, Y = torch.as_tensor(X, device=device), torch.as_tensor(Y, device=device)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=device)
    m, valid = torch.as_tensor(m, device=device), torch.as_tensor(valid, device=device)
    rows = torch.arange(G, device=device)[:, None]

    # differentiate the tensor leaves only; the tree is rebuilt around them
    flat = flatten_dict(stacked_params)
    params = {k: v.detach() for k, v in flat.items() if torch.is_tensor(v)}

    def masked_ce(p, xb, yb, mb):
        ce = ce_per_sample(apply_fn(unflatten_dict({**flat, **p}), xb), yb)
        return torch.sum(ce * mb) / torch.clamp(torch.sum(mb), min=1.0)

    def client_grad(p, xb, yb, mb):
        return clip_by_global_norm(torch.func.grad(masked_ce)(p, xb, yb, mb), tc.grad_clip_norm)

    group_grad = torch.func.vmap(client_grad, in_dims=(vmap_dims(params), 0, 0, 0))
    opt_state = opt.init(params)
    for s in range(idx.shape[0]):
        grads = group_grad(params, X[rows, idx[s]], Y[rows, idx[s]], m[s])
        updates, new_state = opt.update(grads, opt_state, params, s)
        new_params = apply_updates(params, updates)

        def keep(old, new, v=valid[s]):
            return torch.where(v.view(-1, *([1] * (old.ndim - 1))), new, old)

        params, opt_state = tree_map(keep, params, new_params), tree_map(keep, opt_state, new_state)
    return unflatten_dict({**flat, **params})


@torch.no_grad()
def evaluate_cnn(apply_fn: Callable, params: Any, x: np.ndarray, y: np.ndarray, batch_size: int = 512) -> float:
    """Top-1 accuracy."""
    device = next(v for v in params.values() if torch.is_tensor(v)).device
    correct = 0
    for i in range(0, len(x), batch_size):
        pred = torch.argmax(apply_fn(params, torch.as_tensor(x[i : i + batch_size], device=device)), dim=-1)
        correct += int((pred.cpu().numpy() == y[i : i + batch_size]).sum())
    return correct / len(x)
