"""Client-side local training (the phase that happens *before* the single
communication round — Co-Boosting never touches it, per the model-market
constraint)."""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.config.train import TrainConfig
from repro_torch.core.losses import ce_loss
from repro_torch.data.loader import batch_iterator
from repro_torch.optim.optimizers import apply_updates, make_optimizer
from repro_torch.utils.trees import value_and_grad


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
    :func:`repro_torch.data.loader.batch_iterator`, as in the reference."""
    device = next(v for v in params.values() if torch.is_tensor(v)).device
    opt = make_optimizer(tc)
    opt_state = opt.init(params)

    def loss_fn(p, xb, yb):
        return ce_loss(apply_fn(p, xb), yb)

    for i, (xb, yb) in enumerate(batch_iterator(x, y, tc.batch_size, seed=tc.seed, epochs=epochs)):
        xb = torch.as_tensor(xb, device=device)
        yb = torch.as_tensor(yb, device=device).long()
        _, grads = value_and_grad(loss_fn, params, xb, yb)
        updates, opt_state = opt.update(grads, opt_state, params, i)
        params = apply_updates(params, updates)
    return params


@torch.no_grad()
def evaluate_cnn(apply_fn: Callable, params: Any, x: np.ndarray, y: np.ndarray, batch_size: int = 512) -> float:
    """Top-1 accuracy."""
    device = next(v for v in params.values() if torch.is_tensor(v)).device
    correct = 0
    for i in range(0, len(x), batch_size):
        pred = torch.argmax(apply_fn(params, torch.as_tensor(x[i : i + batch_size], device=device)), dim=-1)
        correct += int((pred.cpu().numpy() == y[i : i + batch_size]).sum())
    return correct / len(x)
