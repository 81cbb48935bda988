"""Hand-written Hopper kernels for the port's hot path.

* :mod:`repro_torch.kernels.ensemble_kl` — fused weighted-ensemble + KL
  (Eq. 4 / Eq. 7), forward (Triton) and backward (CUDA C++, only the wanted
  cotangents)
* :mod:`repro_torch.kernels.ghm_ce`      — fused GHM-difficulty CE
  (Eq. 5–6, Eq. 11), forward (Triton) and backward (CUDA C++, only the
  wanted cotangents)
* :mod:`repro_torch.kernels.flash_attention` — blocked causal / SWA /
  softcap attention with GQA, forward and backward (dq and dk/dv passes;
  CUDA C++, train/prefill; the forward and the dk/dv pass on the tensor
  cores for bf16, on the CUDA cores for f32)
* :mod:`repro_torch.kernels.flash_decode` — paged Sq=1 decode attention
  (CUDA C++, inference-only)

The loss forwards are Triton; the loss backwards and the attention kernels
are CUDA C++ sources (``*.cu``) built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`).
Each subpackage: ``kernel.py`` (the kernels' wrappers),
``ops.py`` (the differentiable ``torch.autograd.Function``), ``ref.py``
(the plain PyTorch versions). :mod:`repro_torch.kernels.dispatch` maps the
``backend`` knob ("auto" | "cuda" | "ref") to an implementation.
"""
from repro_torch.kernels.build import launch_counts, reset_launch_counts
from repro_torch.kernels.dispatch import KERNEL_BACKENDS, resolve
from repro_torch.kernels.ensemble_kl import ensemble_kl, ensemble_kl_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.ghm_ce import ghm_ce, ghm_ce_ref

__all__ = [
    "KERNEL_BACKENDS",
    "resolve",
    "launch_counts",
    "reset_launch_counts",
    "ensemble_kl",
    "ensemble_kl_ref",
    "flash_attention",
    "flash_attention_ref",
    "flash_decode",
    "flash_decode_ref",
    "ghm_ce",
    "ghm_ce_ref",
]
