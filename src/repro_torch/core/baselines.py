"""One-shot FL baselines the paper compares against (Table 1), the port of
``repro.core.baselines``.

* FedAvg  — parameter averaging (homogeneous archs only).
* FedENS  — the uniform-weight logit ensemble, no distillation
  (:func:`repro_torch.launch.ofl.run_method` evaluates it directly).
* FedDF   — ensemble distillation on an available (validation) dataset.
* F-DAFL  — data-free KD: generator trained with CE + information entropy
            (the DAFL losses), uniform ensemble, then distill.
* F-ADI   — data-free KD: DeepInversion-style direct noise optimization
            with CE + TV/L2 image priors, uniform ensemble, then distill.
* DENSE   — generator trained with CE + a batch-diversity term, uniform
            ensemble, then distill.

All reuse the epochs of :mod:`repro_torch.core.epoch`; the only differences
from Co-Boosting are the synthesis objective and the fixed uniform weights,
which is exactly the contrast the paper draws (no co-boosting of data and
ensemble). Each runner builds its ensemble with ``cfg.ensemble_impl``
(:func:`repro_torch.core.client_bank.make_ensemble`); ``fedavg`` keeps the
per-client list. Every distillation sweep here (DENSE, F-DAFL, F-ADI, FedDF) runs
the Eq. 4 loss through the ``ensemble_kl`` op under ``cfg.backend_for("loss")``, its
forward and backward kernels on the card. Each runner takes the draw seam
(:mod:`repro_torch.utils.prng`) where the reference takes a key.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.train import OFLConfig
from repro_torch.core.buffer import buffer_as_lists, buffer_init
from repro_torch.core.coboosting import OFLState, init_synth_buffer
from repro_torch.core.client_bank import make_ensemble
from repro_torch.core.ensemble import ensemble_logits, uniform_weights
from repro_torch.core.epoch import distill_schedule, make_adi_epoch, make_coboost_epoch, make_feddf_epoch
from repro_torch.core.losses import ce_loss, entropy
from repro_torch.utils.logging import get_logger
from repro_torch.utils.trees import flatten_dict, tree_map

log = get_logger("baselines")


def _should_eval(eval_fn, epoch: int, cfg: OFLConfig, eval_every: int) -> bool:
    return eval_fn is not None and ((epoch + 1) % eval_every == 0 or epoch == cfg.epochs - 1)


def _log_metrics(method: str, epoch: int, metrics: Dict[str, Any]) -> None:
    log.info("[%s] epoch %d %s", method, epoch, {k: round(v, 4) for k, v in metrics.items() if isinstance(v, float)})


# ---------------------------------------------------------------------------
# FedAvg


def fedavg(client_params: List[Any], sizes: Optional[Sequence[int]] = None, archs: Optional[Sequence[str]] = None) -> Any:
    """Data-amount-weighted parameter average in f32, each leaf cast back to
    its dtype (homogeneous archs only). Non-tensor leaves (a block's
    ``"stride"``) pass through. Clients whose trees differ raise a
    ``ValueError`` naming ``archs`` (one per client) where given."""
    n = len(client_params)
    flats = [flatten_dict(p) for p in client_params]
    shapes = [{k: tuple(v.shape) if torch.is_tensor(v) else v for k, v in f.items()} for f in flats]
    if any(s != shapes[0] for s in shapes[1:]):
        who = f"archs {list(archs)}" if archs is not None else f"{n} clients"
        raise ValueError(f"fedavg averages one architecture; the clients' parameter trees differ ({who})")
    ws = np.full((n,), 1.0 / n) if sizes is None else np.asarray(sizes, np.float64) / np.sum(sizes)
    w = torch.tensor(ws, dtype=torch.float32)

    def avg(leaf, *rest):
        stacked = torch.stack([leaf.float(), *(r.float() for r in rest)])
        return torch.tensordot(w.to(leaf.device), stacked, dims=1).to(leaf.dtype)

    return tree_map(avg, client_params[0], *client_params[1:])


# ---------------------------------------------------------------------------
# generator objectives for the data-free baselines


def _dafl_loss(ens, y, x):
    """DAFL: one-hot CE + information entropy (encourage class balance)."""
    return ce_loss(ens, y) - 5.0 * entropy(torch.mean(ens, dim=0, keepdim=True))


def _dense_loss(ens, y, x):
    """DENSE: CE + batch diversity (push samples apart in pixel space)."""
    b = x.shape[0]
    flat = x.reshape(b, -1)
    d2 = torch.sum(torch.square(flat[:, None] - flat[None, :]), dim=-1)
    div = -torch.mean(d2) / flat.shape[-1]
    return ce_loss(ens, y) + 0.1 * div


def _tv_l2(x):
    """Total variation over the two spatial axes of NHWC images plus a
    small L2 prior."""
    tv = torch.mean(torch.abs(x[:, 1:] - x[:, :-1])) + torch.mean(torch.abs(x[:, :, 1:] - x[:, :, :-1]))
    return tv + 1e-3 * torch.mean(torch.square(x))


GEN_OBJECTIVES: Dict[str, Callable] = {
    "f_dafl": _dafl_loss,
    "dense": _dense_loss,
}


def run_generator_baseline(
    method: str,
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
) -> OFLState:
    """F-DAFL / DENSE: two-stage synth→distill with a fixed uniform
    ensemble (the Co-Boosting epoch with the method's generator objective,
    no EE and no DHS). ``draws`` is the draw seam; the run uses its
    device."""
    objective = GEN_OBJECTIVES[method]
    n = len(client_applies)
    device = draws.device
    logits_all_fn, client_params = make_ensemble(
        client_applies, client_params, impl=cfg.ensemble_impl, scan_chunk=cfg.ensemble_scan_chunk
    )
    w = uniform_weights(n, device)
    epoch_step, gen_opt, srv_opt = make_coboost_epoch(
        logits_all_fn, server_apply, gen_apply, cfg, n, num_classes,
        gen_objective=objective, use_ee=False, distill_dhs=False,
    )
    gen_opt_state = gen_opt.init(gen_params)
    srv_opt_state = srv_opt.init(server_params)
    buf = init_synth_buffer(gen_apply, gen_params, cfg, device)
    state = OFLState(server_params, gen_params, w, [], [], [])
    srv_steps = 0
    for epoch in range(cfg.epochs):
        slot_order, n_valid = distill_schedule(epoch, cfg.buffer_batches)
        (
            state.server_params, srv_opt_state, state.gen_params, gen_opt_state,
            w, buf, srv_steps, gloss, dmean,
        ) = epoch_step(
            state.server_params, srv_opt_state, state.gen_params, gen_opt_state,
            w, buf, draws, srv_steps, slot_order, n_valid, client_params,
        )
        state.dispatch_count += 1
        if _should_eval(eval_fn, epoch, cfg, eval_every):
            metrics = eval_fn(state.server_params, w)
            metrics.update(epoch=epoch, gen_loss=float(gloss), distill_loss=float(dmean))
            state.history.append(metrics)
            _log_metrics(method, epoch, metrics)
    state.buffer = buf
    state.buffer_x, state.buffer_y = buffer_as_lists(buf)
    return state


def run_adi_baseline(
    client_applies: List[Callable],
    client_params: List[Any],
    server_apply: Callable,
    server_params: Any,
    image_shape: Tuple[int, int, int],
    cfg: OFLConfig,
    num_classes: int,
    draws,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 50,
) -> OFLState:
    """F-ADI: optimize pixel batches directly (DeepInversion without BN
    statistics — the clients are GroupNorm, so only image priors apply)."""
    n = len(client_applies)
    device = draws.device
    logits_all_fn, client_params = make_ensemble(
        client_applies, client_params, impl=cfg.ensemble_impl, scan_chunk=cfg.ensemble_scan_chunk
    )
    w = uniform_weights(n, device)

    def inv_loss(x, y, cp):
        ens = ensemble_logits(logits_all_fn(cp, x), w)
        return ce_loss(ens, y) + 2.5e-2 * _tv_l2(x)

    epoch_step, srv_opt = make_adi_epoch(logits_all_fn, server_apply, image_shape, cfg, num_classes, inv_loss)
    srv_opt_state = srv_opt.init(server_params)
    buf = buffer_init(cfg.buffer_batches, (cfg.batch_size, *image_shape), device=device)
    state = OFLState(server_params, None, w, [], [], [])
    srv_steps = 0
    for epoch in range(cfg.epochs):
        slot_order, n_valid = distill_schedule(epoch, cfg.buffer_batches)
        state.server_params, srv_opt_state, buf, srv_steps, _ = epoch_step(
            state.server_params, srv_opt_state, w, buf, draws, srv_steps, slot_order, n_valid, client_params,
        )
        state.dispatch_count += 1
        if _should_eval(eval_fn, epoch, cfg, eval_every):
            metrics = eval_fn(state.server_params, w)
            metrics["epoch"] = epoch
            state.history.append(metrics)
            _log_metrics("f_adi", epoch, metrics)
    state.buffer = buf
    state.buffer_x, state.buffer_y = buffer_as_lists(buf)
    return state


def run_feddf(
    client_applies: List[Callable],
    client_params: List[Any],
    server_apply: Callable,
    server_params: Any,
    val_x,
    cfg: OFLConfig,
    draws,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 50,
) -> OFLState:
    """FedDF: distill the uniform ensemble on real validation data (the
    paper marks this baseline as impractical — it needs data). ``val_x``
    (NHWC images, numpy or a tensor) is cut to whole batches and stacked on
    the device of ``draws`` once; the batches are visited in
    ``np.random.RandomState(epoch).permutation`` order, FedDF's only
    randomness, so nothing is drawn from ``draws``."""
    n = len(client_applies)
    device = draws.device
    logits_all_fn, client_params = make_ensemble(
        client_applies, client_params, impl=cfg.ensemble_impl, scan_chunk=cfg.ensemble_scan_chunk
    )
    w = uniform_weights(n, device)
    nb = len(val_x) // cfg.batch_size
    epoch_step, srv_opt = make_feddf_epoch(logits_all_fn, server_apply, cfg)
    srv_opt_state = srv_opt.init(server_params)
    val = torch.as_tensor(val_x[: nb * cfg.batch_size], dtype=torch.float32, device=device)
    val_batches = val.reshape(nb, cfg.batch_size, *val.shape[1:])
    state = OFLState(server_params, None, w, [], [], [])
    srv_steps = 0
    for epoch in range(cfg.epochs):
        order = np.random.RandomState(epoch).permutation(nb)
        state.server_params, srv_opt_state, srv_steps, _ = epoch_step(
            state.server_params, srv_opt_state, srv_steps, order, val_batches, w, client_params
        )
        state.dispatch_count += 1
        if _should_eval(eval_fn, epoch, cfg, eval_every):
            metrics = eval_fn(state.server_params, w)
            metrics["epoch"] = epoch
            state.history.append(metrics)
            _log_metrics("feddf", epoch, metrics)
    return state
