"""PyTorch/CUDA port of the Co-Boosting one-shot federated learning system.

The package mirrors :mod:`repro` module for module
(``repro_torch.core.epoch`` is the counterpart of ``repro.core.epoch``) and
runs on an NVIDIA Hopper GPU. The Pallas TPU kernels become hand-written
Hopper kernels under :mod:`repro_torch.kernels`: the loss forwards
(``ensemble_kl`` and ``ghm_ce``) in Triton, the loss backwards and the
attention kernels in CUDA C++; everything else is plain PyTorch. Public functions keep the JAX package's layouts: images are NHWC
and client logits are ``(K, B, C)``.

This package imports ``torch`` and never ``jax`` or ``repro``.
"""
