"""Building the hand kernels: where the compiled kernels are cached, the
launch counters, and the loss kernels' launch geometry and scratch.

Each ``.cu`` source beside its wrapper exports plain ``extern "C"``
launchers. :func:`cuda_library` compiles it with ``nvcc`` for ``sm_90a``
into ``build/cuda/<name>-<hash of source and flags>.so`` at the root of the
checkout (listed in ``.gitignore``) at first use and loads it with
``ctypes``; nothing includes PyTorch's headers, so a build takes seconds. A
file lock serialises concurrent builds (``pytest -n``). A missing ``nvcc``
or a failed build raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, Iterable, List, NamedTuple

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


#: Listeners told of every hand-kernel call on ``meta`` tensors, which
#: launches nothing and leaves :data:`LAUNCHES` alone: the dry-run's
#: per-op counter (``repro_torch.roofline.op_cost.OpCounter``) subscribes
#: while it counts. A listener has ``kernel(names, nbytes, flops, dtype)``,
#: and the ``scale``, ``snapshot`` and ``add_since`` through which
#: ``repro_torch.utils.scan.counted_times`` counts one step of a loop for
#: many.
META_LISTENERS: List[Any] = []


def record_meta_call(names: Iterable[str], nbytes: int, flops: int, dtype: torch.dtype) -> None:
    """A wrapper's call on ``meta`` tensors, told to every listener:
    ``names`` are the launch counters the card's launch would bump (the
    first is the op's), ``nbytes`` and ``flops`` its work
    (:mod:`repro_torch.kernels.kernel_cost`), ``dtype`` the peak its
    operations run at."""
    for listener in META_LISTENERS:
        listener.kernel(tuple(names), nbytes, flops, dtype)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device, or every one on ``meta`` (where a
    wrapper records its call for the dry-run's counter instead of
    launching), and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if not (t.is_cuda or t.is_meta) or t.device != dev:
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
    """The raw handle of the current stream of ``t``'s device, the value
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives (also inside a
    CUDA-graph capture), without building a ``Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


# ---------------------------------------------------------------------------
# the loss backward kernels (ensemble_kl_bwd.cu, ghm_ce_bwd.cu)

SMS = 132  # streaming multiprocessors of an H100 SXM
#: Threads of a block of the loss backward kernels, and the blocks each SM
#: keeps resident at once (their ``__launch_bounds__``).
LOSS_BWD_THREADS = 256
LOSS_BWD_BLOCKS_PER_SM = 3


def loss_bwd_geometry(n: int, itemsize: int, aligned: bool) -> tuple[int, int, int]:
    """``(blocks, vec, scratch_rows)`` of a loss backward launch over the
    ``n`` elements of the (B, V) plane, ``itemsize`` the widest logit dtype's.

    ``vec``: the elements a thread moves per access, 16 bytes' worth when
    ``aligned`` (every plane starts 16-byte aligned) and ``n`` is a multiple
    of it, else 1 (the thread then takes 8 bytes' worth of single elements a
    block width apart). ``blocks``: enough that each thread takes at least
    two steps of the grid-stride loop (one block at the main path's K=5,
    B=128, V=10), at most what the card keeps resident at once.
    ``scratch_rows``: the columns of the ``g_w`` partials a launch writes,
    one per block; 0 for one block, which writes ``g_w`` itself."""
    vec = 16 // itemsize
    if not aligned or n % vec:
        vec = 1
    per_step = LOSS_BWD_THREADS * max(vec, 8 // itemsize)
    blocks = max(1, min(-(-n // (2 * per_step)), SMS * LOSS_BWD_BLOCKS_PER_SM))
    return blocks, vec, blocks if blocks > 1 else 0


# ---------------------------------------------------------------------------
# the loss forward kernels (ensemble_kl_fwd.cu, ghm_ce_fwd.cu)

#: Threads of a block of the loss forward kernels and the blocks each SM
#: keeps resident at once (their ``__launch_bounds__``); the widest row a
#: group of at most 32 lanes owns; the fewest columns a split of a row takes.
LOSS_FWD_THREADS = 256
LOSS_FWD_BLOCKS_PER_SM = 3
LOSS_FWD_LANE_MAX_V = 1024
LOSS_FWD_SPLIT_MIN = 1024


class LossFwdGeometry(NamedTuple):
    lanes: int  # threads that own a row together: a power of two up to 32, or the whole block
    rows: int  # rows a block takes at once
    splits: int  # contiguous column ranges a row is cut into, one block each
    span: int  # columns of a split, a multiple of vec
    blocks: int
    vec: int  # elements a thread moves per access


@functools.cache
def loss_fwd_geometry(b: int, v: int, itemsize: int, aligned: bool) -> LossFwdGeometry:
    """The launch of a loss forward over a (B, V) logit plane, from the
    shapes alone; ``itemsize`` is the widest logit dtype's.

    ``vec``: 16 bytes' worth of elements per access when ``aligned`` (the
    logit tensors start 16-byte aligned) and V is a multiple of it, so every
    plane and row starts aligned; else 1. Rows of at most
    ``LOSS_FWD_LANE_MAX_V`` columns are owned by a group of ``lanes`` lanes
    of one warp, a power of two that covers the row's accesses up to 32 (two
    rows of 16 lanes a warp at V=10), ``THREADS / lanes`` rows a block, at
    most as many blocks as the card keeps resident, which loop over the
    rest. Wider rows are owned by a block each; when B such blocks cannot
    put two on every SM, each row is cut into ``splits`` contiguous ranges
    of ``span`` columns, at least ``LOSS_FWD_SPLIT_MIN`` each and at most as
    many blocks in all as are resident at once, none empty."""
    vec = 16 // itemsize
    if not aligned or v % vec:
        vec = 1
    cap = SMS * LOSS_FWD_BLOCKS_PER_SM
    if v <= LOSS_FWD_LANE_MAX_V:
        lanes = min(32, next_pow2(-(-v // vec)))
        rows = LOSS_FWD_THREADS // lanes
        return LossFwdGeometry(lanes, rows, 1, v, min(-(-b // rows), cap), vec)
    splits = max(1, min(cap // b, v // LOSS_FWD_SPLIT_MIN)) if b < 2 * SMS else 1
    units = -(-v // vec)
    per_split = -(-units // splits)
    splits = -(-units // per_split)
    return LossFwdGeometry(LOSS_FWD_THREADS, 1, splits, per_split * vec, min(b * splits, cap), vec)


_SCRATCH: Dict[torch.device, tuple] = {}
_OUTGROWN: list = []


def loss_scratch(device: torch.device, floats: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(partials, ticket)`` on ``device`` for a loss kernel launch that
    combines across blocks (a backward's ``g_w``, a forward's split rows):
    at least ``floats`` f32 partials, and the integer ticket the last block
    takes, zeroed once (every launch leaves it at 0). One pair per device,
    shared by the four loss kernels, which run on one stream. The partials
    grow only outside a CUDA-graph capture, and an outgrown buffer stays
    alive, since a captured graph may still point at it."""
    cur = _SCRATCH.get(device)
    if cur is None or cur[0].numel() < floats:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the loss kernels' scratch cannot grow during a CUDA-graph capture: make the same call once "
                "before capturing"
            )
        if cur is not None:
            _OUTGROWN.append(cur[0])
        ticket = cur[1] if cur is not None else torch.zeros(1, dtype=torch.int32, device=device)
        cur = (torch.empty(max(floats, 4096), dtype=torch.float32, device=device), ticket)
        _SCRATCH[device] = cur
    return cur
