"""Building the hand kernels: where the compiled kernels are cached, and
the launch counters.

Triton kernels: Triton is imported only inside :func:`triton_modules`,
which the kernel wrappers call the first time they launch, so every module
of the package imports on a machine without Triton. They compile on first
use into ``build/triton`` at the root of the checkout (listed in
``.gitignore``); ``TRITON_CACHE_DIR`` / ``TRITON_HOME``, when set, take
precedence.

CUDA C++ kernels: each ``.cu`` source beside its wrapper exports plain
``extern "C"`` launchers. :func:`cuda_library` compiles it with ``nvcc``
for ``sm_90a`` into ``build/cuda/<name>-<hash of source and flags>.so`` at
first use and loads it with ``ctypes``; nothing includes PyTorch's headers,
so a build takes seconds. A file lock serialises concurrent builds
(``pytest -n``). A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

#: Logit dtypes the kernels read (they compute in f32 and store cotangents
#: in the input dtype).
FLOAT_DTYPES = (torch.float32, torch.bfloat16)

#: Launches of each hand kernel since the last :func:`reset_launch_counts`.
#: A wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {
    "ensemble_kl_fwd": 0,
    "ensemble_kl_bwd": 0,
    "ghm_ce_fwd": 0,
    "ghm_ce_bwd": 0,
    "flash_attention_fwd": 0,  # every launch of the op, either variant
    "flash_attention_fwd_sm90": 0,  # of those, the tensor-core kernel's
    "flash_attention_bwd_dq": 0,  # every launch of the op, either variant
    "flash_attention_bwd_dq_sm90": 0,  # of those, the tensor-core kernel's
    "flash_attention_bwd_dkv": 0,
    "flash_attention_bwd_dkv_sm90": 0,
    "flash_decode": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def triton_modules():
    """``(triton, triton.language)``, with the kernel cache in the checkout."""
    os.environ.setdefault("TRITON_HOME", str(BUILD_DIR))
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    return triton, tl


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device (got {t.device} and {dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} must be contiguous")


def check_rows(name: str, b: int, *rows: torch.Tensor) -> None:
    """Per-row vectors (cotangents, residuals): each ``(b,)`` float32."""
    for r in rows:
        if tuple(r.shape) != (b,) or r.dtype != torch.float32:
            raise ValueError(f"{name}: row vectors must be ({b},) float32, got {tuple(r.shape)} {r.dtype}")


def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def row_blocks(b: int, v: int) -> tuple[int, int]:
    """``(BLOCK_B, BLOCK_V)`` for a (B, V) row reduction: ``BLOCK_V`` a power
    of two ≥ 16 that covers V up to 1024 (V=10 is one masked chunk), and
    enough rows per program to make a tile of about 4096 elements."""
    block_v = max(16, min(next_pow2(v), 1024))
    block_b = max(1, min(next_pow2(b), 4096 // block_v))
    return block_b, block_v


# triton.language; jit() binds it before the first build
tl = None


def _gw_reduce_body(part_ptr, gw_ptr, NB, K, BLOCK_R: tl.constexpr, BLOCK_K: tl.constexpr):
    """Sum the ``(NB, BLOCK_K)`` per-program ``g_w`` partials over programs,
    in a fixed order (one program; no atomics, so the result is the same on
    every run)."""
    kk = tl.arange(0, BLOCK_K)
    acc = tl.zeros([BLOCK_R, BLOCK_K], tl.float32)
    for r0 in range(0, NB, BLOCK_R):
        r = r0 + tl.arange(0, BLOCK_R)
        acc += tl.load(part_ptr + r[:, None] * BLOCK_K + kk[None, :], mask=(r < NB)[:, None], other=0.0)
    tl.store(gw_ptr + kk, tl.sum(acc, axis=0), mask=kk < K)


_JITTED = {}


def jit(body):
    """The Triton kernel of a kernel body defined at the top of a module of
    this package. The body's module gets ``tl`` bound at its first build, so
    the body's source needs no Triton at import time."""
    if body not in _JITTED:
        triton, tl = triton_modules()
        body.__globals__["tl"] = tl
        _JITTED[body] = triton.jit(body)
    return _JITTED[body]


def reduce_partials(partials: torch.Tensor, k: int) -> torch.Tensor:
    """Second pass of a backward kernel's ``g_w``: ``(NB, BLOCK_K)`` f32
    partials → ``(k,)`` f32."""
    nb, block_k = partials.shape
    gw = torch.empty(k, dtype=torch.float32, device=partials.device)
    jit(_gw_reduce_body)[(1,)](partials, gw, nb, k, BLOCK_R=64, BLOCK_K=block_k, num_warps=4)
    return gw


# ---------------------------------------------------------------------------
# CUDA C++ kernels

CUDA_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
_LIBS: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built from source at first use")


def cuda_library(source: Path) -> ctypes.CDLL:
    """The shared library built from ``source`` (a ``.cu`` file): compiled
    on first use into a file named by the hash of its text and the flags,
    then loaded once per process."""
    source = Path(source)
    if source not in _LIBS:
        text = source.read_bytes()
        digest = hashlib.sha256(text + " ".join(CUDA_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / "cuda" / f"{source.stem}-{digest}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out.parent / f"{source.stem}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc_path(), *CUDA_FLAGS, "-o", str(tmp), str(source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {source.name} ({' '.join(cmd)}):\n{proc.stderr[-4000:]}")
                os.replace(tmp, out)
            fcntl.flock(lock, fcntl.LOCK_UN)
        _LIBS[source] = ctypes.CDLL(str(out))
    return _LIBS[source]


def build_cuda_libraries(sources) -> None:
    """Build several CUDA sources at once, one ``nvcc`` each (set-up time
    of a run that will launch them all)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        list(pool.map(cuda_library, sources))


def check_launch(name: str, err: int) -> None:
    """Raise when a launcher returned a CUDA error (``cudaGetLastError``
    after the launch): a refused launch never runs, and a later
    synchronise would not report it."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
