"""The paper's contribution: Co-Boosting one-shot federated distillation.

Eq. 2        -> :mod:`repro_torch.core.ensemble`, :mod:`repro_torch.core.client_bank`
Eq. 5-8      -> :mod:`repro_torch.core.hardness`
Eq. 9-10     -> :mod:`repro_torch.core.hard_samples`
Eq. 11-12    -> :mod:`repro_torch.core.weight_search`
Algorithm 1  -> :mod:`repro_torch.core.coboosting`
Baselines    -> :mod:`repro_torch.core.baselines`
Replay ring  -> :mod:`repro_torch.core.buffer`
Fused epochs -> :mod:`repro_torch.core.epoch`
"""
from repro_torch.core.losses import ce_loss, ce_per_sample, entropy, kl_loss, kl_per_sample
from repro_torch.core.buffer import ReplayBuffer, buffer_append, buffer_get, buffer_init
from repro_torch.core.epoch import (
    distill_schedule,
    make_adi_epoch,
    make_coboost_epoch,
    make_distill_sweep,
    make_feddf_epoch,
    make_kd_loss,
)
from repro_torch.core.ensemble import ensemble_logits, make_logits_all, uniform_weights
from repro_torch.core.client_bank import ENSEMBLE_IMPLS, ClientBank, make_ensemble
from repro_torch.core.hardness import adversarial_loss, generator_loss, ghs_loss
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
