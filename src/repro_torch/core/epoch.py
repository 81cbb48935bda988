"""One OFL epoch of each method (the port of ``repro.core.epoch``).

The Co-Boosting epoch runs the reference's fused program step for step,
eagerly: generator phase → buffer append → EE step → distillation sweep
over the replay ring. With another generator objective and neither EE nor
DHS it is the DENSE / F-DAFL epoch; the F-ADI epoch optimizes a pixel batch
in place of a generator, and the FedDF epoch distills on real batches.
Losses stay on the device; the host reads them only at eval boundaries.

Contract with the reference (held by the CPU parity tests):

  * the same draws in the same order, through one seam
    (:mod:`repro_torch.utils.prng`): ``z, y`` for the generator, the EE
    step's DHS direction, then one direction per distillation slot;
  * the same batch visit order — :func:`distill_schedule` replays
    ``np.random.RandomState(epoch).permutation(size)`` over the ring;
  * the same optimizer-step indexing — the generator's Adam step index
    restarts at 0 every epoch while its moments carry over, and the server
    step counter advances once per valid slot.

The sweep visits only the ``n_valid`` filled slots, where the reference
scans all slots and masks the empty ones; the draws of the masked slots
come after the valid ones there, so the two agree.

The Eq. 4 / Eq. 6–8 / Eq. 11–12 losses route through the fused kernels
(:mod:`repro_torch.kernels`) according to ``cfg.backend_for("loss")``, for both passes:
every distillation sweep (Co-Boosting and all four distilling baselines)
runs Eq. 4 through ``ensemble_kl``. The baselines' synthesis objectives
are plain PyTorch, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.config.train import OFLConfig
from repro_torch.core.buffer import ReplayBuffer, buffer_append, buffer_get
from repro_torch.core.ensemble import ensemble_logits
from repro_torch.core.hard_samples import diversify
from repro_torch.core.hardness import generator_loss
from repro_torch.core.weight_search import update_weights
from repro_torch.kernels import ensemble_kl
from repro_torch.optim.optimizers import adam, apply_updates, sgdm
from repro_torch.optim.schedules import constant_schedule
from repro_torch.utils.trees import value_and_grad


def distill_schedule(epoch: int, capacity: int) -> Tuple[np.ndarray, int]:
    """The per-epoch sweep schedule: after epoch ``epoch``'s append the ring
    holds ``min(epoch+1, capacity)`` batches and ``ptr == (epoch+1) %
    capacity``; the sweep visits logical indices in
    ``np.random.RandomState(epoch).permutation(size)`` order. Returns the
    ``(capacity,)`` slot order (valid slots first, zero padding after) and
    the valid count."""
    size = min(epoch + 1, capacity)
    ptr = (epoch + 1) % capacity
    perm = np.random.RandomState(epoch).permutation(size)
    order = np.zeros((capacity,), np.int32)
    order[:size] = (ptr - size + perm) % capacity
    return order, size


def make_kd_loss(logits_all_fn: Callable, server_apply: Callable, temperature: float, backend: str = "auto"):
    """Eq. 4: temperature-KL between the re-weighted ensemble and the server,
    through the fused ``ensemble_kl`` op. The client logits carry no
    gradient, so they are computed outside autograd."""

    def loss_fn(server_params, x, client_params, w):
        with torch.no_grad():
            la = logits_all_fn(client_params, x)
        s_logits = server_apply(server_params, x)
        return torch.mean(ensemble_kl(la, s_logits, w, temperature=temperature, backend=backend))

    return loss_fn


def make_distill_sweep(
    logits_all_fn: Callable, server_apply: Callable, srv_opt, cfg: OFLConfig, num_classes: int, use_dhs: bool
):
    """The distillation sweep: one server step per valid ring slot, in
    ``slot_order``, each on a freshly diversified batch when ``use_dhs``."""
    loss_fn = make_kd_loss(logits_all_fn, server_apply, cfg.kd_temperature, cfg.backend_for("loss"))

    def sweep(server_params, srv_opt_state, buf: ReplayBuffer, draws, w, client_params, slot_order, n_valid, srv_step0):
        sp, st, step = server_params, srv_opt_state, int(srv_step0)
        dsum = torch.zeros((), dtype=torch.float32, device=w.device)
        for pos in range(n_valid):
            x, _ = buffer_get(buf, int(slot_order[pos]))
            if use_dhs:
                u = draws.direction((x.shape[0], num_classes))
                x = diversify(logits_all_fn, client_params, w, x, u, cfg.epsilon)
            loss, grads = value_and_grad(loss_fn, sp, x, client_params, w)
            updates, st = srv_opt.update(grads, st, sp, step)
            sp = apply_updates(sp, updates)
            dsum = dsum + loss
            step += 1
        return sp, st, step, dsum / max(n_valid, 1)

    return sweep


def make_coboost_epoch(
    logits_all_fn: Callable,
    server_apply: Callable,
    gen_apply: Callable,
    cfg: OFLConfig,
    num_clients: int,
    num_classes: int,
    gen_objective: Optional[Callable] = None,
    use_ee: Optional[bool] = None,
    distill_dhs: Optional[bool] = None,
):
    """One Algorithm-1 epoch. With ``gen_objective`` set (a
    ``f(ens, y, x) -> loss``, computed in plain PyTorch) and ``use_ee=False``
    this is also the DENSE / F-DAFL epoch: the contrast the paper draws is
    which generator objective runs and whether the ensemble weights move.
    ``use_ee`` and ``distill_dhs`` default to ``cfg.use_ee`` and
    ``cfg.use_dhs``. Returns ``(epoch_step, gen_opt, srv_opt)``;
    ``epoch_step`` maps

        (server_params, srv_opt_state, gen_params, gen_opt_state, w, buf,
         draws, srv_step0, slot_order, n_valid, client_params)
        -> (server_params, srv_opt_state, gen_params, gen_opt_state, w, buf,
            srv_steps, gloss, dmean)

    ``buf`` is written in place; ``gloss`` and ``dmean`` are device
    scalars."""
    gen_opt = adam(constant_schedule(cfg.gen_lr))
    srv_opt = sgdm(constant_schedule(cfg.server_lr), momentum=0.9)
    use_ee = cfg.use_ee if use_ee is None else use_ee
    distill_dhs = cfg.use_dhs if distill_dhs is None else distill_dhs
    mu = cfg.mu / num_clients

    def gen_loss(x, y, client_params, w, server_params):
        la = logits_all_fn(client_params, x)
        if gen_objective is not None:
            return gen_objective(ensemble_logits(la, w), y, x)
        s_logits = server_apply(server_params, x) if cfg.use_adv else None
        return generator_loss(
            la, w, s_logits, y,
            beta=cfg.beta, use_ghs=cfg.use_ghs, use_adv=cfg.use_adv,
            kl_temperature=cfg.gen_kl_temperature, backend=cfg.backend_for("loss"),
        )

    def gen_loss_fn(gp, z, y, client_params, w, server_params):
        return gen_loss(gen_apply(gp, z, y), y, client_params, w, server_params)

    sweep = make_distill_sweep(logits_all_fn, server_apply, srv_opt, cfg, num_classes, distill_dhs)

    def epoch_step(
        server_params, srv_opt_state, gen_params, gen_opt_state, w, buf,
        draws, srv_step0, slot_order, n_valid, client_params,
    ):
        # record_function names each Algorithm-1 phase (the reference's
        # jax.named_scope): a --profile-dir trace attributes the kernels
        # launched inside to the phase (repro_torch.obs.phases); without a
        # profiler a range costs a few microseconds.
        # 1. generator phase (Algorithm 1 lines 5-9): T_G Adam steps on Eq. 8,
        # the step index restarting at 0 every epoch as in the reference
        with record_function("ofl.gen.boost"):
            z, y = draws.zy(cfg.batch_size, cfg.latent_dim, num_classes)
            for i in range(cfg.gen_iters):
                _, grads = value_and_grad(gen_loss_fn, gen_params, z, y, client_params, w, server_params)
                updates, gen_opt_state = gen_opt.update(grads, gen_opt_state, gen_params, i)
                gen_params = apply_updates(gen_params, updates)
            with torch.no_grad():
                x_new = gen_apply(gen_params, z, y)
                gloss = gen_loss(x_new, y, client_params, w, server_params)
            buf = buffer_append(buf, x_new, y)

        # 2-3. EE on the (diversified) fresh hard batch (lines 11-14)
        if use_ee:
            with record_function("ofl.ee.weight_search"):
                xe = x_new
                if cfg.use_dhs:
                    u = draws.direction((x_new.shape[0], num_classes))
                    xe = diversify(logits_all_fn, client_params, w, x_new, u, cfg.epsilon)
                with torch.no_grad():
                    la = logits_all_fn(client_params, xe)
                w = update_weights(w, la, y, mu, backend=cfg.backend_for("loss"))

        # 4. server distillation over the replay ring (lines 16-18)
        with record_function("ofl.kd"):
            server_params, srv_opt_state, srv_steps, dmean = sweep(
                server_params, srv_opt_state, buf, draws, w, client_params, slot_order, n_valid, srv_step0
            )
        return (
            server_params, srv_opt_state, gen_params, gen_opt_state, w, buf,
            srv_steps, gloss, dmean,
        )

    return epoch_step, gen_opt, srv_opt


def make_adi_epoch(
    logits_all_fn: Callable,
    server_apply: Callable,
    image_shape: Tuple[int, int, int],
    cfg: OFLConfig,
    num_classes: int,
    inv_loss: Callable,
):
    """The F-ADI epoch: ``cfg.gen_iters`` Adam steps (rate 0.05, a fresh
    state every epoch, the step index from 0) on a pixel batch that starts
    from half the drawn unit noise, a clip to [-1, 1], then the same append
    and distillation sweep as Co-Boosting, without DHS. ``inv_loss(x, y,
    client_params)`` is the synthesis objective. Returns ``(epoch_step,
    srv_opt)``; ``epoch_step`` maps

        (server_params, srv_opt_state, w, buf, draws, srv_step0, slot_order,
         n_valid, client_params)
        -> (server_params, srv_opt_state, buf, srv_steps, dmean)"""
    synth_opt = adam(constant_schedule(0.05))
    srv_opt = sgdm(constant_schedule(cfg.server_lr), momentum=0.9)
    sweep = make_distill_sweep(logits_all_fn, server_apply, srv_opt, cfg, num_classes, use_dhs=False)

    def epoch_step(server_params, srv_opt_state, w, buf, draws, srv_step0, slot_order, n_valid, client_params):
        y, noise = draws.inversion(cfg.batch_size, image_shape, num_classes)
        x = noise * 0.5
        st = synth_opt.init(x)
        for i in range(cfg.gen_iters):
            _, g = value_and_grad(inv_loss, x, y, client_params)
            updates, st = synth_opt.update(g, st, x, i)
            x = apply_updates(x, updates)
        buf = buffer_append(buf, torch.clamp(x, -1.0, 1.0), y)
        server_params, srv_opt_state, srv_steps, dmean = sweep(
            server_params, srv_opt_state, buf, draws, w, client_params, slot_order, n_valid, srv_step0
        )
        return server_params, srv_opt_state, buf, srv_steps, dmean

    return epoch_step, srv_opt


def make_feddf_epoch(logits_all_fn: Callable, server_apply: Callable, cfg: OFLConfig):
    """The FedDF epoch: one server step on Eq. 4 per real batch, in the
    host's ``order``, over ``val_batches`` stacked on the device (no ring,
    no mask). Returns ``(epoch_step, srv_opt)``; ``epoch_step`` maps

        (server_params, srv_opt_state, srv_step0, order, val_batches, w,
         client_params)
        -> (server_params, srv_opt_state, srv_steps, mean loss)"""
    srv_opt = sgdm(constant_schedule(cfg.server_lr), momentum=0.9)
    loss_fn = make_kd_loss(logits_all_fn, server_apply, cfg.kd_temperature, cfg.backend_for("loss"))

    def epoch_step(server_params, srv_opt_state, srv_step0, order, val_batches, w, client_params):
        sp, st, step = server_params, srv_opt_state, int(srv_step0)
        lsum = torch.zeros((), dtype=torch.float32, device=w.device)
        for bi in order:
            loss, grads = value_and_grad(loss_fn, sp, val_batches[int(bi)], client_params, w)
            updates, st = srv_opt.update(grads, st, sp, step)
            sp = apply_updates(sp, updates)
            lsum = lsum + loss
            step += 1
        return sp, st, step, lsum / max(len(order), 1)

    return epoch_step, srv_opt
