"""Co-Boosting (Algorithm 1) — the paper's primary contribution.

Each global epoch:
  1. *Data boosting* — ``T_G`` generator steps on Eq. 8 (difficulty-weighted
     CE against the current ensemble + adversarial server disagreement),
     then the fresh batch joins the synthetic buffer D_S.
  2. *DHS* — samples drawn from D_S are diversified on the fly by the
     one-step input perturbation of Eq. 10.
  3. *Ensemble boosting (EE)* — one sign-gradient step (Eq. 12) on the
     ensembling weights w over the hard samples.
  4. *Distillation* — SGD-momentum steps on the temperature-KL between the
     re-weighted ensemble and the server (Eq. 4).

Component toggles (``use_ghs`` / ``use_dhs`` / ``use_ee`` / ``use_adv``)
reproduce the Table 7 ablation. The epoch is :mod:`repro_torch.core.epoch`'s
``make_coboost_epoch`` (the reference's fused epoch). Each epoch records
what the reference's fused driver records (:mod:`repro_torch.obs`): the
``ofl.epoch`` span, ``ofl.epoch.step_s`` and the ``ofl.*`` step counters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.config.train import OFLConfig
from repro_torch.core.buffer import ReplayBuffer, buffer_as_lists, buffer_init
from repro_torch.core.client_bank import make_ensemble
from repro_torch.core.ensemble import uniform_weights
from repro_torch.core.epoch import distill_schedule, make_coboost_epoch
from repro_torch.models.generator import image_generator, init_image_generator
from repro_torch.utils.logging import get_logger
from repro_torch.utils.trees import tree_map

log = get_logger("coboosting")


@dataclasses.dataclass
class OFLState:
    """Python-side state of the OFL run."""

    server_params: Any
    gen_params: Any
    weights: torch.Tensor
    buffer_x: List[torch.Tensor]  # the ring's batches oldest first, filled at the end of a run
    buffer_y: List[torch.Tensor]
    history: List[Dict[str, float]]
    buffer: Optional[ReplayBuffer] = None
    dispatch_count: int = 0  # calls of the epoch function, one an epoch


def init_synth_buffer(gen_apply: Callable, gen_params: Any, cfg: OFLConfig, device=None) -> ReplayBuffer:
    """Preallocate the ring from the generator's output shape, found on the
    meta device (no forward runs)."""
    meta = tree_map(lambda v: v.to("meta"), gen_params)
    z = torch.empty((cfg.batch_size, cfg.latent_dim), device="meta")
    y = torch.empty((cfg.batch_size,), dtype=torch.int64, device="meta")
    xs = gen_apply(meta, z, y)
    return buffer_init(cfg.buffer_batches, xs.shape, xs.dtype, device=device)


def run_coboosting(
    client_applies: List[Callable],
    client_params: List[Any],
    server_apply: Callable,
    server_params: Any,
    gen_apply: Callable,
    gen_params: Any,
    cfg: OFLConfig,
    num_classes: int,
    draws,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 50,
    init_weights: Optional[torch.Tensor] = None,
) -> OFLState:
    """Algorithm 1. ``draws`` is the epoch's draw seam
    (:class:`repro_torch.utils.prng.Draws`); the run uses its device.
    ``init_weights`` (K,) starts the ensembling weights in place of the
    uniform ones (``data_amount_weights(sizes)``, say).
    ``eval_fn(server_params, w) -> dict`` is called every ``eval_every``
    epochs and after the last one for history logging. The client ensemble
    is ``cfg.ensemble_impl``'s (:func:`repro_torch.core.client_bank.make_ensemble`)."""
    n = len(client_applies)
    device = draws.device
    logits_all_fn, client_params = make_ensemble(
        client_applies, client_params, impl=cfg.ensemble_impl, scan_chunk=cfg.ensemble_scan_chunk
    )
    if init_weights is None:
        w = uniform_weights(n, device)
    else:
        w = torch.as_tensor(init_weights, dtype=torch.float32, device=device)
    epoch_step, gen_opt, srv_opt = make_coboost_epoch(
        logits_all_fn, server_apply, gen_apply, cfg, n, num_classes
    )
    gen_opt_state = gen_opt.init(gen_params)
    srv_opt_state = srv_opt.init(server_params)
    buf = init_synth_buffer(gen_apply, gen_params, cfg, device)
    state = OFLState(server_params, gen_params, w, [], [], [])
    srv_steps = 0
    t0, t_eval = time.perf_counter(), 0.0
    for epoch in range(cfg.epochs):
        slot_order, n_valid = distill_schedule(epoch, cfg.buffer_batches)
        # the span and the timer bracket the host's enqueueing of the eager epoch
        # and add no device sync (the span's args are host values): step_s
        # is the device's epoch time only where the host waits on the device
        t_step = time.perf_counter()
        with obs.span("ofl.epoch", epoch=epoch, driver="fused"):
            (
                state.server_params, srv_opt_state, state.gen_params, gen_opt_state,
                state.weights, buf, srv_steps, gloss, dmean,
            ) = epoch_step(
                state.server_params, srv_opt_state, state.gen_params, gen_opt_state,
                state.weights, buf, draws, srv_steps, slot_order, n_valid, client_params,
            )
        state.dispatch_count += 1
        obs.observe("ofl.epoch.step_s", time.perf_counter() - t_step, driver="fused")
        obs.inc("ofl.epoch.count")
        # one a call of the epoch function, as the reference's fused driver
        # counts its one dispatch an epoch (the port's epoch launches its
        # kernels eagerly, so this is not a count of launches)
        obs.inc("ofl.epoch.dispatches")
        obs.inc("ofl.gen.steps", cfg.gen_iters)
        if cfg.use_ee:
            obs.inc("ofl.ee.steps")
        obs.inc("ofl.kd.steps", n_valid)
        if eval_fn is not None and ((epoch + 1) % eval_every == 0 or epoch == cfg.epochs - 1):
            # reading the losses waits for the device, so ``elapsed`` is the
            # wall time of the epochs run so far, evaluation excluded
            gloss, dmean = float(gloss), float(dmean)
            t_done = time.perf_counter()
            elapsed = t_done - t0 - t_eval
            metrics = eval_fn(state.server_params, state.weights)
            t_eval += time.perf_counter() - t_done
            metrics.update(epoch=epoch, gen_loss=gloss, distill_loss=dmean)
            state.history.append(metrics)
            log.info(
                "epoch %d t=%.2fs gen=%.4f distill=%.4f %s",
                epoch, elapsed, gloss, dmean,
                {k: round(v, 4) for k, v in metrics.items() if isinstance(v, float)},
            )
    state.buffer = buf
    state.buffer_x, state.buffer_y = buffer_as_lists(buf)
    return state


def default_image_setup(
    gen: torch.Generator, cfg: OFLConfig, num_classes: int, image_shape: Tuple[int, int, int]
) -> Tuple[Callable, Any]:
    """The paper's DCGAN-style generator (params drawn from ``gen``, on its
    device) and its apply fn."""
    gen_params = init_image_generator(gen, cfg.latent_dim, num_classes, image_shape)
    gen_apply = lambda p, z, y: image_generator(p, z, y, image_shape)
    return gen_apply, gen_params
