"""Device selection for the port's entry points, and the device-time
profile they log on request."""
from __future__ import annotations

import time

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


def profiled(fn, log):
    """Run ``fn`` under ``torch.profiler`` (device activity only, which
    keeps the host's pace); log the kernels by device time and return
    ``(fn(), seconds the device spent in kernels and copies, wall seconds
    of fn)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    log.info("profile:\n%s", events.table(sort_by="self_cuda_time_total", row_limit=15))
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, sum(e.self_device_time_total for e in on_device) / 1e6, wall
