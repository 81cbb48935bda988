"""The paper's contribution: Co-Boosting one-shot federated distillation.

Eq. 2        -> :mod:`repro_torch.core.ensemble`, :mod:`repro_torch.core.client_bank`
Eq. 5-8      -> :mod:`repro_torch.core.hardness`
Eq. 9-10     -> :mod:`repro_torch.core.hard_samples`
Eq. 11-12    -> :mod:`repro_torch.core.weight_search`
Algorithm 1  -> :mod:`repro_torch.core.coboosting`
Baselines    -> :mod:`repro_torch.core.baselines`
LM-scale     -> :mod:`repro_torch.core.distributed`
Replay ring  -> :mod:`repro_torch.core.buffer`
Fused epochs -> :mod:`repro_torch.core.epoch`

The reference's legacy-driver pieces (``make_generator_phase``,
``make_distill_step``, ``make_ee_step``) are not ported: the legacy
driver is deprecated and fails its own parity pin.
"""
from repro_torch.core.losses import ce_loss, ce_per_sample, entropy, kl_loss, kl_per_sample
from repro_torch.core.buffer import (
    ReplayBuffer,
    buffer_append,
    buffer_as_lists,
    buffer_get,
    buffer_init,
    logical_to_slot,
)
from repro_torch.core.epoch import (
    distill_schedule,
    make_adi_epoch,
    make_coboost_epoch,
    make_distill_sweep,
    make_feddf_epoch,
    make_kd_loss,
)
from repro_torch.core.ensemble import (
    data_amount_weights,
    ensemble_accuracy,
    ensemble_logits,
    make_logits_all,
    make_logits_all_stacked,
    uniform_weights,
)
from repro_torch.core.client_bank import ENSEMBLE_IMPLS, ClientBank, make_ensemble
from repro_torch.core.hardness import adversarial_loss, generator_loss, ghs_loss, sample_difficulty
from repro_torch.core.hard_samples import diversify
from repro_torch.core.weight_search import normalize_weights, update_weights, weight_grad, weight_loss
from repro_torch.core.coboosting import OFLState, default_image_setup, init_synth_buffer, run_coboosting
from repro_torch.core.baselines import (
    GEN_OBJECTIVES,
    fedavg,
    run_adi_baseline,
    run_feddf,
    run_generator_baseline,
)
from repro_torch.core.distributed import (
    client_lm_logits,
    coboost_distill_loss,
    coboost_distill_step,
    dhs_embeds,
    ee_update_lm,
    ensemble_lm_logits,
)

__all__ = [
    "ce_loss",
    "ce_per_sample",
    "kl_loss",
    "kl_per_sample",
    "entropy",
    "uniform_weights",
    "data_amount_weights",
    "make_logits_all",
    "make_logits_all_stacked",
    "ensemble_logits",
    "ensemble_accuracy",
    "ClientBank",
    "ENSEMBLE_IMPLS",
    "make_ensemble",
    "sample_difficulty",
    "ghs_loss",
    "adversarial_loss",
    "generator_loss",
    "diversify",
    "normalize_weights",
    "weight_loss",
    "update_weights",
    "ReplayBuffer",
    "buffer_init",
    "buffer_append",
    "buffer_get",
    "buffer_as_lists",
    "logical_to_slot",
    "distill_schedule",
    "make_distill_sweep",
    "make_coboost_epoch",
    "make_adi_epoch",
    "make_feddf_epoch",
    "OFLState",
    "run_coboosting",
    "init_synth_buffer",
    "default_image_setup",
    "fedavg",
    "run_generator_baseline",
    "run_adi_baseline",
    "run_feddf",
    "ensemble_lm_logits",
    "client_lm_logits",
    "dhs_embeds",
    "ee_update_lm",
    "coboost_distill_loss",
    "coboost_distill_step",
    # the port's own: the KD loss of the distillation sweep, the EE gradient, the baselines' objectives
    "make_kd_loss",
    "weight_grad",
    "GEN_OBJECTIVES",
]
