"""The paper's contribution: Co-Boosting one-shot federated distillation.

Eq. 2        -> :mod:`repro_torch.core.ensemble`
Eq. 5-8      -> :mod:`repro_torch.core.hardness`
Eq. 9-10     -> :mod:`repro_torch.core.hard_samples`
Eq. 11-12    -> :mod:`repro_torch.core.weight_search`
Algorithm 1  -> :mod:`repro_torch.core.coboosting`
Replay ring  -> :mod:`repro_torch.core.buffer`
Fused epochs -> :mod:`repro_torch.core.epoch`
"""
