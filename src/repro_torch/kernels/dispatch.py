"""Kernel backend dispatch for the port's ops (the counterpart of
``repro.kernels.dispatch``): which implementation of a kernel-backed op
runs.

A backend covers BOTH passes of a differentiable op. The unified entry
point is :func:`resolve`, keyed by *op*:

* ``"loss"``   — the Eq. 4/6/11-12 fused losses (``ensemble_kl`` / ``ghm_ce``)
* ``"attn"``   — train/prefill flash attention (``flash_attention``)
* ``"decode"`` — paged Sq=1 decode attention (``flash_decode``)

and by *backend* value:

* ``"auto"`` — the fused op (a ``torch.autograd.Function`` whose forward and
  backward are the hand kernels): each wrapper launches its Hopper kernel
  for CUDA tensors and computes its plain PyTorch version for CPU tensors.
* ``"cuda"`` — the hand kernels only; CPU tensors raise.
* ``"ref"``  — the plain PyTorch oracle under plain autograd.

There is no fallback: a kernel that fails to compile or launch raises.

:class:`BackendPolicy` bundles one choice per op (plus a shared default)
and is the one configuration surface for all of them: ``OFLConfig.backend``
and ``ModelConfig.backend`` carry one, and ``cfg.backend_for(op)`` reads
it. A plain string (the launchers' ``--backend``) means that value for
every op.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

KERNEL_BACKENDS = ("auto", "cuda", "ref")

#: The ops the dispatch layer routes; each has one slot on BackendPolicy.
BACKEND_OPS = ("loss", "attn", "decode")


def check_backend(backend: str, what: str = "kernel backend") -> None:
    if backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown {what} {backend!r}; expected one of {KERNEL_BACKENDS}")


def _check_op(op: str) -> None:
    if op not in BACKEND_OPS:
        raise ValueError(f"unknown backend op {op!r}; expected one of {BACKEND_OPS}")


@dataclass(frozen=True)
class BackendPolicy:
    """One backend choice per dispatched op, with a shared default.

    Empty per-op fields fall back to ``default``; every field takes the
    :data:`KERNEL_BACKENDS` values."""

    default: str = "auto"
    loss: str = ""  # ensemble_kl / ghm_ce (the OFL epoch losses)
    attn: str = ""  # train/prefill flash attention
    decode: str = ""  # paged Sq=1 decode attention

    def __post_init__(self):
        check_backend(self.default)
        for op in BACKEND_OPS:
            if getattr(self, op):
                check_backend(getattr(self, op), f"{op} kernel backend")

    def for_op(self, op: str) -> str:
        """The requested (unresolved) backend for ``op``."""
        _check_op(op)
        return getattr(self, op) or self.default


def as_policy(backend) -> BackendPolicy:
    """A config's ``backend`` field as a policy: a plain string means that
    value for every op, a :class:`BackendPolicy` is kept."""
    if isinstance(backend, BackendPolicy):
        return backend
    if isinstance(backend, str):
        return BackendPolicy(default=backend)
    raise TypeError(f"backend must be a BackendPolicy or a string, got {type(backend).__name__}")


def resolve(op: str, backend: str, device) -> str:
    """Map (op, requested backend, device of the op's tensors) to
    ``"fused"`` (the autograd.Function over the kernel wrappers) or
    ``"ref"`` (autograd of the plain oracle)."""
    _check_op(op)
    check_backend(backend)
    if backend == "ref":
        return "ref"
    if backend == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(
            f"{op} backend 'cuda' requires CUDA tensors (got {device}); "
            "use 'auto' or 'ref' on the CPU"
        )
    return "fused"
