"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def get_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    the CPU. Asking for ``cuda`` where no GPU is present raises; nothing
    falls back to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def disable_tf32() -> None:
    """Full f32 matmuls and convolutions, as the JAX reference computes.
    cuDNN convolutions default to TF32 on Hopper."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
