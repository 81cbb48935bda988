"""Training / OFL run configuration dataclasses (the port's copy of
``repro.config.train``)."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels.dispatch import check_backend

# the client ensemble engines (repro_torch.core.client_bank.make_ensemble)
ENSEMBLE_IMPLS = ("grouped", "looped")


@dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs (client local training, server distillation and LM
    training reuse this)."""

    optimizer: str = "sgdm"  # sgd | sgdm | adam | adamw
    learning_rate: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip_norm: float = 0.0
    schedule: str = "constant"  # constant | cosine | linear_warmup_cosine
    warmup_steps: int = 0
    total_steps: int = 1000
    batch_size: int = 128
    seed: int = 0
    microbatches: int = 1  # grad accumulation inside a train step
    state_dtype: str = ""  # optimizer slot dtype override (e.g. "bfloat16")
    grad_dtype: str = ""  # cast grads before the optimizer (e.g. "bfloat16")


@dataclass(frozen=True)
class OFLConfig:
    """One-shot federated learning pipeline configuration (the paper's
    hyperparameters from Appendix B.1)."""

    num_clients: int = 10
    partition: str = "dirichlet"  # dirichlet | c_cls | iid
    alpha: float = 0.1  # Dir(alpha)
    c_cls: int = 2  # classes per client under c_cls partition
    lognormal_sigma: float = 0.0  # >0 => unbalanced client sizes

    # local client training
    local_epochs: int = 300
    local_lr: float = 0.01
    local_momentum: float = 0.9
    local_batch_size: int = 128

    # Co-Boosting (Algorithm 1)
    epochs: int = 500  # T, global epochs
    gen_iters: int = 30  # T_G
    gen_lr: float = 1e-3  # eta_G (Adam)
    server_lr: float = 0.01  # eta_S (SGD momentum 0.9)
    batch_size: int = 128  # b, synthetic batch per epoch
    latent_dim: int = 100
    kd_temperature: float = 4.0  # server distillation temperature
    gen_kl_temperature: float = 1.0  # temperature in the generator's KL term
    beta: float = 1.0  # scale on the adversarial generator loss (Eq. 8)
    epsilon: float = 8.0 / 255.0  # DHS perturbation strength (Eq. 10)
    mu: float = 0.1  # EE step size, divided by n (Appendix: 0.1/n)
    buffer_batches: int = 8  # replay window over D_S

    # component toggles (Table 7 ablation)
    use_ghs: bool = True  # hard-sample generator loss (Eq. 6)
    use_dhs: bool = True  # on-the-fly diverse hard samples (Eq. 10)
    use_ee: bool = True  # ensemble enhancement (Eq. 12)
    use_adv: bool = True  # adversarial term (Eq. 7)

    # client ensemble forward engine: "grouped" (ClientBank: clients grouped
    # by arch, one vmapped forward per group, O(#groups) launches) or
    # "looped" (one forward per client, kept as the parity baseline)
    ensemble_impl: str = "grouped"
    # >0: a group larger than this runs as a loop over vmapped chunks of
    # this many clients (bounds live activations at many clients); 0 = one
    # vmap per group
    ensemble_scan_chunk: int = 0

    # loss-kernel backend (repro_torch.kernels.dispatch): auto | cuda | ref
    backend: str = "auto"

    seed: int = 0

    def __post_init__(self):
        check_backend(self.backend)
        if self.ensemble_impl not in ENSEMBLE_IMPLS:
            raise ValueError(f"unknown ensemble impl {self.ensemble_impl!r}; expected one of {ENSEMBLE_IMPLS}")
        if self.ensemble_scan_chunk < 0:
            raise ValueError(f"ensemble_scan_chunk must be >= 0, got {self.ensemble_scan_chunk}")
