"""Kernel backend dispatch for the port's ops (the counterpart of
``repro.kernels.dispatch.resolve``): the loss kernels (``"loss"``),
train/prefill flash attention (``"attn"``) and paged decode
(``"decode"``).

A backend covers BOTH passes of a differentiable op:

* ``"auto"`` — the fused op (a ``torch.autograd.Function`` whose forward and
  backward are the hand kernels): each wrapper launches its Hopper kernel
  for CUDA tensors and computes its plain PyTorch version for CPU tensors.
* ``"cuda"`` — the hand kernels only; CPU tensors raise.
* ``"ref"``  — the plain PyTorch oracle under plain autograd.

There is no fallback: a kernel that fails to compile or launch raises.
"""
from __future__ import annotations

import torch

KERNEL_BACKENDS = ("auto", "cuda", "ref")

#: The ops the dispatch layer routes.
BACKEND_OPS = ("loss", "attn", "decode")


def check_backend(backend: str) -> None:
    if backend not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; expected one of {KERNEL_BACKENDS}")


def resolve(op: str, backend: str, device) -> str:
    """Map (op, requested backend, device of the op's tensors) to
    ``"fused"`` (the autograd.Function over the kernel wrappers) or
    ``"ref"`` (autograd of the plain oracle)."""
    if op not in BACKEND_OPS:
        raise ValueError(f"unknown backend op {op!r}; expected one of {BACKEND_OPS}")
    check_backend(backend)
    if backend == "ref":
        return "ref"
    if backend == "cuda" and torch.device(device).type != "cuda":
        raise ValueError(
            f"{op} backend 'cuda' requires CUDA tensors (got {device}); "
            "use 'auto' or 'ref' on the CPU"
        )
    return "fused"
