"""Runtime steps of the LM (the port of ``repro.runtime.steps``). Each
``make_*_step(cfg, ...)`` returns a plain function; PyTorch runs it
eagerly, so there is nothing to compile.

* ``train_step``   — next-token CE training, with optional gradient
  micro-batching (a Python loop in place of the reference's ``lax.scan``),
  a gradient dtype and global-norm clipping;
* ``distill_step`` — Co-Boosting server distillation at LM scale (Eq. 4
  over the K client LMs);
* ``prefill_step`` / ``decode_step`` — serving.

Every step returns new parameter and optimizer-state trees; metrics are
device tensors, so a step reads nothing back to the host.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.config.train import TrainConfig
from repro_torch.core.distributed import coboost_distill_loss
from repro_torch.models.transformer import lm_decode, lm_loss, lm_prefill
from repro_torch.optim.optimizers import DTYPES, apply_updates, clip_by_global_norm, make_optimizer
from repro_torch.utils.trees import tree_map, value_and_grad


def _finish(opt, tc: TrainConfig, params, opt_state, grads, step_idx):
    """Gradient dtype, clipping, the optimizer update and its application."""
    if tc.grad_dtype:
        grads = tree_map(lambda g: g.to(DTYPES[tc.grad_dtype]), grads)
    if tc.grad_clip_norm > 0:
        grads = clip_by_global_norm(grads, tc.grad_clip_norm)
    updates, opt_state = opt.update(grads, opt_state, params, step_idx)
    return apply_updates(params, updates), opt_state


def make_train_step(cfg, tc: TrainConfig) -> Callable:
    """Returns step(params, opt_state, batch, step_idx) -> (params,
    opt_state, metrics). With ``tc.microbatches > 1`` the batch is split on
    its leading axis and the gradients of the pieces are averaged."""
    opt = make_optimizer(tc)

    def grads_of(params, batch):
        metrics = {}

        def loss_fn(p):
            loss, m = lm_loss(p, cfg, batch)
            metrics.update({k: v.detach() for k, v in m.items()})
            return loss

        loss, grads = value_and_grad(loss_fn, params)
        return loss, metrics, grads

    def step(params, opt_state, batch, step_idx):
        n = tc.microbatches
        if n > 1:
            if any(v.shape[0] % n for v in batch.values()):
                raise ValueError(f"microbatches={n} does not divide the batch")
            micro = [{k: v.chunk(n, dim=0)[i] for k, v in batch.items()} for i in range(n)]
            loss, grads = None, None
            for mb in micro:
                l_i, _, g_i = grads_of(params, mb)
                loss = l_i if loss is None else loss + l_i
                grads = g_i if grads is None else tree_map(torch.add, grads, g_i)
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
            metrics = {"ce": loss}
        else:
            loss, metrics, grads = grads_of(params, batch)
        params, opt_state = _finish(opt, tc, params, opt_state, grads, step_idx)
        return params, opt_state, dict(metrics, loss=loss)

    step.optimizer = opt
    return step


def make_distill_step_lm(cfg, tc: TrainConfig, temperature: float = 4.0, kl_chunk: int = 0) -> Callable:
    """Returns step(server_params, opt_state, client_params, w, batch,
    step_idx) -> (server_params, opt_state, {"kd": loss}): the LM-scale
    Co-Boosting distillation step. ``client_params`` is a list of K param
    dicts; ``kl_chunk`` enables the chunked-logits memory lever."""
    opt = make_optimizer(tc)

    def step(server_params, opt_state, client_params, w, batch, step_idx):
        loss, grads = value_and_grad(
            lambda p: coboost_distill_loss(p, client_params, w, cfg, batch, temperature, kl_chunk), server_params
        )
        server_params, opt_state = _finish(opt, tc, server_params, opt_state, grads, step_idx)
        return server_params, opt_state, {"kd": loss}

    step.optimizer = opt
    return step


def make_prefill_step(cfg) -> Callable:
    def step(params, batch: Dict, state):
        return lm_prefill(params, cfg, batch, state)

    return step


def make_decode_step(cfg) -> Callable:
    def step(params, token, state, pos):
        return lm_decode(params, cfg, token, state, pos)

    return step
