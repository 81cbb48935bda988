#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. Environment: torch / CUDA / Triton versions and the card's name and power
   limit (``nvidia-smi``). No CUDA device, or no ``src/repro_torch`` beside
   this script, fails here. The six CUDA C++ sources are then built from
   the checkout, one ``nvcc`` each, all started together.
2. Kernel vs plain: each of the four loss kernels (``ensemble_kl`` and
   ``ghm_ce``: the forwards in Triton, the backwards in CUDA C++) is built
   from the checkout's sources and held against its plain PyTorch version
   on the card, in every mode and, for the backwards, for every non-empty
   subset of the cotangents they can compute, at the main path's shapes
   (K=5, B=128, V=10, f32), at a wide tail case (K=5, B=37, V=32003, f32
   and bf16) and at 20 clients on 100 classes (K=20, B=256, V=100, f32);
   at the first two a second backward call and a CUDA-graph replay must
   give the eager call's bits. Then the CUDA C++ attention
   kernels, in f32 (the CUDA-core kernels) and bf16 (the tensor-core
   kernels of ``flash_attention_sm90.cu``, ``_sm90`` below, and the
   CUDA-core ones named by the caller): ``flash_attention_fwd`` at the
   smollm-135m prefill shape (8 prompts × 128 tokens, 9 heads over 3 kv
   heads, hd 64, causal), at its training shape (8 × 256 tokens), at tail
   cases (Sq = Sk = 37, hd 32, with and without window and softcap) and at
   a non-causal windowed case with Sq > Sk, hd 128 and fully-masked rows;
   ``flash_decode`` at the smollm-135m decode shape (8 slots, 16-token
   pages, 12 table entries) and in a windowed ring case.
   ``flash_decode`` (the split kernel and its combine) also at ragged
   positions from 0 to the last slot, at hd 128 with one query head per kv
   head, and with a table far wider than the live pages; a second call
   must give the same bits. Tolerance, elementwise:
   ``|got − want| ≤ tol·(|want| + max(1, max|want|))`` with tol = 1e-4 for
   f32 outputs and 2^-7 (one bf16 rounding step) for outputs stored in bf16.
   Then the two flash-attention backward kernels (``flash_attention_bwd_dq``
   and ``flash_attention_bwd_dkv``) against ``flash_attention_bwd_ref``, in
   f32 and bf16 (both passes in bf16 through both variants): at the
   smollm-135m training shape (8 × 256 tokens, 9 heads over 3 kv heads,
   hd 64, causal), a tail case (Sq = Sk = 37, hd 32, window 16, softcap
   30) and two non-causal cases with Sq ≠ Sk and hd 128, one windowed with
   fully-masked rows; a second call must give the same bits.
   Times: CUDA events around back-to-back calls of the wrapper (``ms``,
   the table's), and in bf16 also the device alone: calls captured in a
   CUDA graph and replayed (``device_ms``); the four loss kernels at the
   main shape and the two backwards also at the wide one in f32 and bf16,
   each backward in the generator's mode (g_client and g_student, and
   g_client), ``flash_attention_fwd`` in both
   variants at the prefill and the training shapes, both backward passes in
   both variants at the training shape and ``flash_decode`` at the decode
   shape. Beside them PyTorch's
   ``scaled_dot_product_attention`` on the same inputs, its forward for the
   forward, its backward (forward+backward less forward) for the backward
   passes: the library times, which the port never calls.
3. Small-input agreement: at a small size, the gradients of the generator
   loss, the distillation loss and the EE loss through the kernels (backend
   "cuda") agree with plain autograd (backend "ref") at the tolerance above;
   one epoch per backend runs to finite losses, and its parameter gaps are
   printed. Then the reduced smollm-135m in f32: the gradients of one
   ``lm_loss`` through the attention kernels agree with plain autograd; the
   run must have gone through the CUDA-core kernels only.
4. Training path: ``repro_torch.launch.ofl`` at the paper's image width
   (5×cnn5 clients, cnn5 server, 32×32×3, 10 classes, synthetic batch 128,
   gen_iters 30) for a few epochs, with the launch counters reset just
   before and read just after; every loss kernel must have launched, the
   losses must be finite and ``server_acc`` / ``ensemble_acc`` present.
5. Serving path: smollm-135m at full width (30 layers, d_model 576,
   random weights from a seed). First an f32 check: 4 requests × 16 tokens
   through the paged engine give the same greedy tokens as the static
   dense-cache path (same prefill kernel; its top-2 logit margins must
   exceed 1e-3), through the CUDA-core forward only. Then
   ``repro_torch.launch.serve`` in bf16: continuous batching, paged KV, 16
   requests, prompt 128, 64 new tokens, 8 slots, page size 16, with the
   launch counters reset just before and read just after; both attention
   kernels must have launched, every prefill through the tensor-core
   forward, every request must
   come back with its 64 tokens, and tok/s and p50/p95 latency are printed.
   The run is then repeated under ``torch.profiler`` (device activity
   only) for the device's busy and idle share.
6. LM training path: one step of smollm-135m at full width, whose
   gradients through the kernels are held against plain autograd: in f32
   through the CUDA-core kernels (the largest gap relative to each leaf's
   largest gradient is printed, and must stay below 1e-3), then in bf16
   through the tensor-core ones (the gap is printed, and must stay within
   2× the gap between plain autograd in bf16 and in f32: the kernels round
   P and dS to bf16, which may move the gradients no more than bf16
   activations do); then
   ``repro_torch.launch.train`` at full width in bf16 with AdamW (batch 8,
   seq 256, 30 steps), with the launch counters reset just before and read
   just after: the attention forward and both backward kernels must each
   launch 30 layers × 30 steps times, all on the tensor cores, every loss
   must be finite and the last-10 mean below the first-10 mean; s/step,
   tokens/s after the first step and the peak device memory are printed.
7. LM distillation path: ``repro_torch.launch.distill_llm`` at full width
   (K = 3 clients, 8 epochs of DHS, EE and distillation): ``kd`` finite at
   every epoch, ``w`` summing to 1, and both backward kernels launched (DHS
   differentiates the clients, distillation the server), all on the
   tensor cores.
8. Summary: a ``kernels: {...}`` line, the JSON kernel table, and last the
   ``{"ok": true, "device": {...}}`` line.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense

MAIN = dict(k=5, b=128, v=10)
WIDE = dict(k=5, b=37, v=32003)
CLIENTS20 = dict(k=20, b=256, v=100)  # the paper's client sweep goes to 20
REPLACES = {
    "ensemble_kl_fwd": "src/repro/kernels/ensemble_kl/kernel.py:217",
    "ensemble_kl_bwd": "src/repro/kernels/ensemble_kl/kernel.py:144",
    "ghm_ce_fwd": "src/repro/kernels/ghm_ce/kernel.py:211",
    "ghm_ce_bwd": "src/repro/kernels/ghm_ce/kernel.py:143",
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:335",
    "flash_attention_fwd_sm90": "src/repro/kernels/flash_attention/kernel.py:335",
    "flash_attention_bwd_dq": "src/repro/kernels/flash_attention/kernel.py:295",
    "flash_attention_bwd_dq_sm90": "src/repro/kernels/flash_attention/kernel.py:295",
    "flash_attention_bwd_dkv": "src/repro/kernels/flash_attention/kernel.py:314",
    "flash_attention_bwd_dkv_sm90": "src/repro/kernels/flash_attention/kernel.py:314",
    "flash_decode": "src/repro/kernels/flash_decode/kernel.py:109",
}
LOSS_KERNELS = ("ensemble_kl_fwd", "ensemble_kl_bwd", "ghm_ce_fwd", "ghm_ce_bwd")
# the op counters (every launch of the op) and their tensor-core variants,
# which serve bf16; the CUDA-core kernels serve f32
SM90 = {
    "flash_attention_fwd": "flash_attention_fwd_sm90",
    "flash_attention_bwd_dq": "flash_attention_bwd_dq_sm90",
    "flash_attention_bwd_dkv": "flash_attention_bwd_dkv_sm90",
}
ATTN_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_sm90", "flash_decode")
BWD_KERNELS = (
    "flash_attention_bwd_dq", "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_sm90",
)
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_sm90") + BWD_KERNELS
SOURCES = {
    "ensemble_kl_fwd": "src/repro_torch/kernels/ensemble_kl/kernel.py",
    "ensemble_kl_bwd": "src/repro_torch/kernels/ensemble_kl/ensemble_kl_bwd.cu",
    "ghm_ce_fwd": "src/repro_torch/kernels/ghm_ce/kernel.py",
    "ghm_ce_bwd": "src/repro_torch/kernels/ghm_ce/ghm_ce_bwd.cu",
    "flash_attention_fwd": "src/repro_torch/kernels/flash_attention/flash_attention.cu",
    "flash_attention_fwd_sm90": "src/repro_torch/kernels/flash_attention/flash_attention_sm90.cu",
    "flash_attention_bwd_dq": "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu",
    "flash_attention_bwd_dq_sm90": "src/repro_torch/kernels/flash_attention/flash_attention_sm90.cu",
    "flash_attention_bwd_dkv": "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu",
    "flash_attention_bwd_dkv_sm90": "src/repro_torch/kernels/flash_attention/flash_attention_sm90.cu",
    "flash_decode": "src/repro_torch/kernels/flash_decode/flash_decode.cu",
}
ROUTES = {n: "triton" if n in ("ensemble_kl_fwd", "ghm_ce_fwd") else "cuda" for n in REPLACES}

# serving: smollm-135m at full width
SERVE = dict(requests=16, prompt=128, gen=64, slots=8, page=16)
# LM training: smollm-135m at full width
TRAIN = dict(batch=8, seq=256, steps=30, layers=30)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phase 1


def environment():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.build import triton_modules

    triton, _ = triton_modules()  # points Triton's cache at build/ in the checkout first
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton {triton.__version__}")
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    from repro_torch.utils.device import disable_tf32

    disable_tf32()
    from repro_torch.kernels.build import build_cuda_libraries
    from repro_torch.kernels.ensemble_kl.kernel import BWD_SOURCE as KL_BWD_SOURCE
    from repro_torch.kernels.flash_attention.kernel import BWD_SOURCE as FA_BWD_SOURCE
    from repro_torch.kernels.flash_attention.kernel import SM90_SOURCE as FA_SM90_SOURCE
    from repro_torch.kernels.flash_attention.kernel import SOURCE as FA_SOURCE
    from repro_torch.kernels.flash_decode.kernel import SOURCE as FD_SOURCE
    from repro_torch.kernels.ghm_ce.kernel import BWD_SOURCE as CE_BWD_SOURCE

    t0 = time.perf_counter()
    build_cuda_libraries([FA_SOURCE, FA_BWD_SOURCE, FA_SM90_SOURCE, FD_SOURCE, KL_BWD_SOURCE, CE_BWD_SOURCE])
    print(f"built the CUDA kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    return smi


# ---------------------------------------------------------------------------
# phase 2


def _case(k, b, v, dtype, seed, device):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    cl = (torch.randn((k, b, v), generator=g) * 2).to(dtype)
    st = (torch.randn((b, v), generator=g) * 2).to(dtype)
    w = torch.softmax(torch.randn((k,), generator=g), 0)
    labels = torch.randint(0, v, (b,), generator=g)
    ct = torch.randn((b,), generator=g)
    return [t.to(device) for t in (cl, st, w, labels, ct)]


def _err(name, got, want):
    """Largest abs error; fails past the stated tolerance."""
    import torch

    tol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-4
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output not finite")
    diff = (got - want).abs()
    bound = tol * (want.abs() + max(1.0, float(want.abs().max())))
    if not bool((diff <= bound).all()):
        fail(f"{name}: max abs err {float(diff.max()):.3e} beyond tolerance {tol:g}")
    return float(diff.max())


def _time_ms(fn, iters=200, warmup=20):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, reps=20, iters=10):
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed ``iters`` times between CUDA events, so the host's cost per
    call (Python, checks, the launch itself) is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graph asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _host_ms(fn, iters=2000):
    """Host time per call: the host clock around back-to-back calls (the
    device keeps up with a few-microsecond kernel), then a synchronise."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def loss_bwd_host_split(cl, st, w, labels, ct, out, lse_t, lse_s, lse, ly):
    """Where the host's time goes in one call of each loss backward wrapper
    in the generator's mode at the main shape: the argument checks, the
    output allocations, the stream lookup and the ``ctypes`` launch, each
    timed alone, beside the whole call."""
    import torch

    from repro_torch.kernels.build import loss_bwd_geometry, stream_ptr
    from repro_torch.kernels.ensemble_kl import kernel as klk
    from repro_torch.kernels.ghm_ce import kernel as cek

    k, b, v = cl.shape
    blocks, vec, _ = loss_bwd_geometry(b * v, cl.element_size(), True)
    g_cl, g_st = torch.empty_like(cl), torch.empty_like(st)
    kl_args = (cl.data_ptr(), st.data_ptr(), w.data_ptr(), ct.data_ptr(), out.data_ptr(), lse_t.data_ptr(),
               lse_s.data_ptr(), g_cl.data_ptr(), g_st.data_ptr(), None, None, None, k, b, v, 4.0, 0, 0, vec, blocks)
    ce_args = (cl.data_ptr(), labels.data_ptr(), w.data_ptr(), ct.data_ptr(), lse.data_ptr(), ly.data_ptr(),
               g_cl.data_ptr(), None, None, None, k, b, v, 1, 0, cek.LABEL_CODES[labels.dtype], vec, blocks)
    stream = stream_ptr(w)
    kl_fn, ce_fn = klk._bwd_lib(), cek._bwd_lib()
    parts = {
        "ensemble_kl_bwd": {
            "call": lambda: klk.ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, 4.0, needs=(True, True, False)),
            "checks": lambda: klk._check_bwd(cl, st, w, ct, out, lse_t, lse_s),
            "outputs": lambda: (torch.empty_like(cl), torch.empty_like(st)),
            "stream": lambda: stream_ptr(w),
            "launch": lambda: kl_fn(*kl_args, stream),
        },
        "ghm_ce_bwd": {
            "call": lambda: cek.ghm_ce_bwd(cl, labels, w, ct, lse, ly, True, True, needs=(True, False)),
            "checks": lambda: cek._check_bwd(cl, labels, w, ct, lse, ly),
            "outputs": lambda: torch.empty_like(cl),
            "stream": lambda: stream_ptr(w),
            "launch": lambda: ce_fn(*ce_args, stream),
        },
    }
    for name, fns in parts.items():
        t = {part: _host_ms(fn) for part, fn in fns.items()}
        t["rest"] = t["call"] - sum(t[p] for p in ("checks", "outputs", "stream", "launch"))
        print(f"host split {name} (generator's mode, main shape), ms per call: " + json.dumps(t), flush=True)


def _bound_ms(nbytes, flops, peak=F32_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _work(name, k, b, v, itemsize, needs=None):
    """Bytes each kernel must move (each input read once, each output
    written once) and f32 operations it does: per (b, v) element a K-step
    fma combine (2K) plus ~10 ops of scaling, exponentials and sums in the
    forward; the backward rebuilds the combine and forms the cotangents in
    ``needs`` (K multiplies for g_client, 2K for the g_w dot products, ~4 for
    g_student) plus ~8 ops, and writes only those."""
    n = b * v
    if name == "ensemble_kl_fwd":
        return (k * n + n) * itemsize + 4 * k + 3 * 4 * b, n * (2 * k + 10)
    if name == "ghm_ce_fwd":
        return k * n * itemsize + 4 * k + 8 * b + 3 * 4 * b, n * (2 * k + 6)
    if name == "ensemble_kl_bwd":
        cl, st, gw = needs
        written = (k * n * cl + n * st) * itemsize + 4 * k * gw
        return (k * n + n) * itemsize + 4 * k + 4 * 4 * b + written, n * (2 * k + 8 + k * cl + 4 * st + 2 * k * gw)
    cl, gw = needs
    written = k * n * itemsize * cl + 4 * k * gw
    return k * n * itemsize + 4 * k + 8 * b + 3 * 4 * b + written, n * (2 * k + 8 + k * cl + 2 * k * gw)


def _same_bits(name, a, b):
    import torch

    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{name}: gave other bits")


def _replayed(fn):
    """``(eager outputs, outputs of the same call captured in a CUDA graph
    and replayed twice)``."""
    import torch

    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return eager, captured


def kernels_vs_plain():
    """The four loss kernels against their plain versions: the forwards in
    every mode, the backwards in every mode and for every non-empty subset
    of the cotangents they can compute, at the main shape, at the wide
    vocabulary in f32 and bf16, and at 20 clients on 100 classes; at the
    main shape and the wide one a second backward call and a CUDA-graph
    replay must give the eager call's bits. Times per call and on the device
    alone, the backwards in the mode the main path calls them in most (the
    generator's: g_client and g_student, g_client)."""
    import torch

    from repro_torch.kernels.ensemble_kl.kernel import ensemble_kl_bwd, ensemble_kl_fwd
    from repro_torch.kernels.ensemble_kl.ref import ensemble_kl_bwd_ref, ensemble_kl_fwd_ref
    from repro_torch.kernels.ghm_ce.kernel import ghm_ce_bwd, ghm_ce_fwd
    from repro_torch.kernels.ghm_ce.ref import ghm_ce_bwd_ref, ghm_ce_fwd_ref

    dev = torch.device("cuda")
    errs = {n: 0.0 for n in LOSS_KERNELS}
    timing = {}
    subsets_kl = [(a, b, c) for a in (False, True) for b in (False, True) for c in (False, True) if a or b or c]
    subsets_ce = [(True, False), (False, True), (True, True)]
    shapes = [(MAIN, torch.float32), (WIDE, torch.float32), (WIDE, torch.bfloat16), (CLIENTS20, torch.float32)]
    for si, (shape, dtype) in enumerate(shapes):
        k, b, v = shape["k"], shape["b"], shape["v"]
        cl, st, w, labels, ct = _case(k, b, v, dtype, seed=si, device=dev)
        tag = f"K={k} B={b} V={v} {str(dtype).replace('torch.', '')}"
        for temp in (1.0, 4.0):
            got = ensemble_kl_fwd(cl, st, w, temp)
            want = ensemble_kl_fwd_ref(cl, st, w, temp)
            for name_o, a, r in zip(("out", "lse_t", "lse_s"), got, want):
                e = _err(f"ensemble_kl_fwd {tag} T={temp} {name_o}", a, r)
                errs["ensemble_kl_fwd"] = max(errs["ensemble_kl_fwd"], e)
            out, lse_t, lse_s = want
            want = ensemble_kl_bwd_ref(cl, st, w, ct, out, lse_t, lse_s, temp)
            for needs in subsets_kl:
                got = ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, temp, needs=needs)
                for name_o, a, r, x in zip(("g_client", "g_student", "g_w"), got, want, needs):
                    if (a is None) == x:
                        fail(f"ensemble_kl_bwd {tag} T={temp} needs={needs}: {name_o} is {a is None and 'None'}")
                    if x:
                        e = _err(f"ensemble_kl_bwd {tag} T={temp} needs={needs} {name_o}", a, r)
                        errs["ensemble_kl_bwd"] = max(errs["ensemble_kl_bwd"], e)
        for weighted in (True, False):
            got = ghm_ce_fwd(cl, labels, w, weighted)
            want = ghm_ce_fwd_ref(cl, labels, w, weighted)
            for name_o, a, r in zip(("out", "lse", "ly"), got, want):
                e = _err(f"ghm_ce_fwd {tag} weighted={weighted} {name_o}", a, r)
                errs["ghm_ce_fwd"] = max(errs["ghm_ce_fwd"], e)
            _, lse, ly = want
            for stop in ((True, False) if weighted else (False,)):
                want = ghm_ce_bwd_ref(cl, labels, w, ct, lse, ly, weighted, stop)
                for needs in subsets_ce:
                    got = ghm_ce_bwd(cl, labels, w, ct, lse, ly, weighted, stop, needs=needs)
                    for name_o, a, r, x in zip(("g_client", "g_w"), got, want, needs):
                        if (a is None) == x:
                            fail(f"ghm_ce_bwd {tag} weighted={weighted} stop={stop} needs={needs}: {name_o} wrong")
                        if x:
                            e = _err(f"ghm_ce_bwd {tag} weighted={weighted} stop={stop} needs={needs} {name_o}", a, r)
                            errs["ghm_ce_bwd"] = max(errs["ghm_ce_bwd"], e)
        torch.cuda.synchronize()
        print(f"kernels agree with plain versions at {tag}", flush=True)

        out, lse_t, lse_s = ensemble_kl_fwd_ref(cl, st, w, 4.0)
        _, lse, ly = ghm_ce_fwd_ref(cl, labels, w, True)
        if shape is not CLIENTS20 and dtype == torch.float32:
            # every cotangent (g_w across blocks at the wide shape): a second
            # call and a graph replay give the eager call's bits
            kl_all = lambda: ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, 4.0)
            ce_all = lambda: ghm_ce_bwd(cl, labels, w, ct, lse, ly, True, False)
            for name, fn in (("ensemble_kl_bwd", kl_all), ("ghm_ce_bwd", ce_all)):
                first = fn()
                _same_bits(f"{name} {tag}, a second call", first, fn())
                _same_bits(f"{name} {tag}, a CUDA-graph replay", *_replayed(fn))
            print(f"loss backward kernels at {tag}: a second call and a graph replay give the same bits", flush=True)
        if shape is CLIENTS20:
            continue

        # times: ensemble_kl at T=4, ghm_ce weighted with the difficulty held
        # constant; the backwards in the generator's mode
        gen_kl, gen_ce = (True, True, False), (True, False)
        calls = {
            "ensemble_kl_fwd": (lambda: ensemble_kl_fwd(cl, st, w, 4.0), lambda: ensemble_kl_fwd_ref(cl, st, w, 4.0),
                                None),
            "ensemble_kl_bwd": (
                lambda: ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, 4.0, needs=gen_kl),
                lambda: ensemble_kl_bwd_ref(cl, st, w, ct, out, lse_t, lse_s, 4.0, needs=gen_kl),
                gen_kl,
            ),
            "ghm_ce_fwd": (lambda: ghm_ce_fwd(cl, labels, w, True), lambda: ghm_ce_fwd_ref(cl, labels, w, True), None),
            "ghm_ce_bwd": (
                lambda: ghm_ce_bwd(cl, labels, w, ct, lse, ly, True, True, needs=gen_ce),
                lambda: ghm_ce_bwd_ref(cl, labels, w, ct, lse, ly, True, True, needs=gen_ce),
                gen_ce,
            ),
        }
        if shape is MAIN:
            loss_bwd_host_split(cl, st, w, labels, ct, out, lse_t, lse_s, lse, ly)
        for name, (kern, plain, needs) in calls.items():
            if shape is not MAIN and needs is None:
                continue  # the forwards at the main shape only, as before
            nbytes, flops = _work(name, k, b, v, cl.element_size(), needs)
            bound, bound_by = _bound_ms(nbytes, flops)
            timing[(name, tag)] = {
                "ms": _time_ms(kern), "plain_ms": _time_ms(plain),
                "bound_ms": bound, "bound_by": bound_by, "device_ms": _graph_ms(kern),
            }
    for (name, tag), t in timing.items():
        print(f"time {name} {tag}: " + json.dumps(t), flush=True)
    main_tag = f"K={MAIN['k']} B={MAIN['b']} V={MAIN['v']} float32"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    return errs, {n: {k: timing[(n, main_tag)][k] for k in keys} for n in LOSS_KERNELS}


# ---------------------------------------------------------------------------
# phase 2, the attention kernels


def _attn_case(b, sq, sk, h, kh, hd, dtype, seed, device):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    shapes = ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd))
    return [torch.randn(shape, generator=g).to(dtype).to(device) for shape in shapes]


def _decode_case(b, h, kh, hd, ps, w, window, pos, dtype, seed, device):
    """Pages of a full serving pool (every row owns the pages its positions
    cover, the rest of its table points at a scratch page holding NaN).
    Also returns the count of valid cached positions over all rows."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    n_pages = b * w + 1
    kp = torch.randn((n_pages, ps, kh, hd), generator=g)
    vp = torch.randn((n_pages, ps, kh, hd), generator=g)
    kp[-1] = float("nan")
    vp[-1] = float("nan")
    cl = min(window, w * ps) if window else w * ps
    table = torch.full((b, w), n_pages - 1, dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=g).to(torch.int32)
    live = [-(-min(p + 1, cl) // ps) for p in pos]
    for r in range(b):
        table[r, : live[r]] = perm[r * w : r * w + live[r]]
    q = torch.randn((b, h, hd), generator=g)
    ft = lambda t: t.to(dtype).to(device)
    kw = dict(window=window, cache_len=cl)
    keys = sum(min(p + 1, cl) for p in pos)  # the valid positions: all the function reads
    return ft(q), ft(kp), ft(vp), table.to(device), torch.tensor(pos, dtype=torch.int32, device=device), kw, keys


def _lse_err(name, got, want):
    """lse: fully-masked rows are exactly 1e30 in both; the rest as _err."""
    if not bool(((got == 1e30) == (want == 1e30)).all()):
        fail(f"{name}: fully-masked rows differ")
    keep = want != 1e30
    return _err(name, got[keep], want[keep]) if bool(keep.any()) else 0.0


def _sdpa(q, k, v):
    """PyTorch's fused attention on the same inputs, in its (B, H, S, hd)
    layout (transposed views), causal, GQA."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)


def _attn_fwd_bound(q, k, v, shape, peak):
    """The forward's bound: bytes (q, k, v read once, out written once, lse
    f32) and the causal half of the QK^T and PV products."""
    b, sq, sk, h, kh, hd = shape
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size() + 4 * b * sq * h
    flops = 4 * b * h * sq * sk * hd // 2
    return _bound_ms(nbytes, flops, peak)


def attention_kernels_vs_plain():
    """``flash_attention_fwd`` and ``flash_decode`` against their plain
    versions, f32 and bf16. bf16 goes to the tensor-core forward (``_sm90``)
    and, named, to the CUDA-core one as well; f32 to the CUDA-core one.
    Times at the serving prefill and the training shapes: the two variants
    of the forward side by side with SDPA's forward on the same inputs,
    per wrapper call (CUDA events) and on the device alone (CUDA graph)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref_lse
    from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    dev = torch.device("cuda")
    errs = {n: 0.0 for n in ATTN_KERNELS}
    timing = {}
    n_pre, lb = SERVE["slots"], SERVE["prompt"]
    timed = {"smollm prefill": "prefill", "smollm train": "train"}
    attn_cases = [
        ("smollm prefill", (n_pre, lb, lb, 9, 3, 64), dict(causal=True)),
        ("smollm train", (TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], 9, 3, 64), dict(causal=True)),
        ("tail", (2, 37, 37, 4, 2, 32), dict(causal=True)),
        ("tail window+softcap", (2, 37, 37, 4, 2, 32), dict(causal=True, window=8, softcap=30.0)),
        # Sq > Sk, non-causal, window: the rows past the keys + window see none of them
        ("cross hd128 window", (1, 70, 33, 4, 1, 128), dict(causal=False, window=16)),
    ]
    w_pages = (SERVE["prompt"] + SERVE["gen"]) // SERVE["page"]
    mid = SERVE["prompt"] + SERVE["gen"] // 2
    ragged = [i * (w_pages * SERVE["page"] - 1) // (SERVE["slots"] - 1) for i in range(SERVE["slots"])]  # 0 .. max_seq-1
    decode_cases = [
        ("smollm decode", (SERVE["slots"], 9, 3, 64, SERVE["page"], w_pages, 0, [mid] * SERVE["slots"])),
        ("smollm decode ragged", (SERVE["slots"], 9, 3, 64, SERVE["page"], w_pages, 0, ragged)),
        ("ring", (3, 4, 2, 32, 8, 5, 16, [3, 20, 37])),
        ("hd128 one head per kv head", (2, 8, 8, 128, 64, 3, 0, [0, 150])),
        # max_seq far beyond the positions reached: 11 live entries of 256
        ("smollm decode wide table", (SERVE["slots"], 9, 3, 64, SERVE["page"], 256, 0, [mid] * SERVE["slots"])),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
        # bf16: the tensor-core kernel (picked by dtype) and the CUDA-core one (named)
        variants = {None: "flash_attention_fwd"} if dtype == torch.float32 else {
            None: "flash_attention_fwd_sm90", "cuda_core": "flash_attention_fwd"}
        for ci, (tag, shape, kw) in enumerate(attn_cases):
            q, k, v = _attn_case(*shape, dtype, seed=ci, device=dev)
            want_o, want_lse = flash_attention_ref_lse(q, k, v, **kw)
            if tag == "cross hd128 window" and not bool((want_lse == 1e30).any()):
                fail("the cross hd128 window case has no fully-masked row")
            for variant, name in variants.items():
                reset_launch_counts()
                out, lse = flash_attention_fwd(q, k, v, variant=variant, **kw)
                torch.cuda.synchronize()
                if launch_counts()["flash_attention_fwd_sm90"] != int(name == "flash_attention_fwd_sm90"):
                    fail(f"flash_attention_fwd {tag} {dname} variant {variant}: launched {launch_counts()}")
                label = f"{name} {tag} {dname}"
                errs[name] = max(errs[name], _err(label + " out", out, want_o), _lse_err(label + " lse", lse, want_lse))
            if tag not in timed or (dtype == torch.float32 and tag != "smollm prefill"):
                continue
            bound, bound_by = _attn_fwd_bound(q, k, v, shape, peak)
            plain_ms = _time_ms(lambda: flash_attention_ref_lse(q, k, v, **kw), iters=50)
            library = _sdpa(q, k, v)
            on_device = dtype == torch.bfloat16  # device times for the main paths' dtype
            library_ms, library_dev = _time_ms(library), _graph_ms(library) if on_device else None
            for variant, name in variants.items():
                call = lambda: flash_attention_fwd(q, k, v, variant=variant, **kw)
                timing[(name, timed[tag], dname)] = {
                    "ms": _time_ms(call), "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": library_ms, "device_ms": _graph_ms(call) if on_device else None,
                    "library_device_ms": library_dev,
                }
        for ci, (tag, args) in enumerate(decode_cases):
            q, kp, vp, table, pos, kw, keys = _decode_case(*args, dtype, seed=10 + ci, device=dev)
            out = flash_decode_fwd(q, kp, vp, table, pos, **kw)
            want = flash_decode_ref(q, kp, vp, table, pos, **kw)
            torch.cuda.synchronize()
            errs["flash_decode"] = max(errs["flash_decode"], _err(f"flash_decode {tag} {dname}", out, want))
            if not torch.equal(flash_decode_fwd(q, kp, vp, table, pos, **kw), out):
                fail(f"flash_decode {tag} {dname}: a second call gave other bits")
            if ci == 0:
                b, h, kh, hd = args[:4]
                nbytes = 2 * keys * kh * hd * kp.element_size() + 2 * q.numel() * q.element_size() + 4 * (table.numel() + b)
                flops = 4 * keys * (h // kh) * kh * hd
                bound, bound_by = _bound_ms(nbytes, flops, peak)
                call = lambda: flash_decode_fwd(q, kp, vp, table, pos, **kw)
                timing[("flash_decode", "decode", dname)] = {
                    "ms": _time_ms(call),
                    "plain_ms": _time_ms(lambda: flash_decode_ref(q, kp, vp, table, pos, **kw)),
                    "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
                    "device_ms": _graph_ms(call) if dtype == torch.bfloat16 else None,
                }
        print(f"attention kernels agree with plain versions in {dname}", flush=True)
    # the host's cost of a wrapper call: the tensor-core forward at a toy
    # shape (one block), per call by CUDA events and on the device alone
    q, k, v = _attn_case(1, 64, 64, 1, 1, 64, torch.bfloat16, seed=9, device=dev)
    toy = lambda: flash_attention_fwd(q, k, v)
    print(f"time flash_attention_fwd_sm90 at 1 x 64 tokens, 1 head (the wrapper's host floor): per call "
          f"{_time_ms(toy):.6f} ms, device {_graph_ms(toy):.6f} ms", flush=True)
    for (name, where, dname), t in timing.items():
        print(f"time {name} {where} shape {dname}: " + json.dumps(t), flush=True)
    # the main paths run in bf16: the table takes the forward at the training
    # shape (where its launches are counted) and flash_decode at the decode shape
    table = {n: timing[(n, "train", "bfloat16")] for n in ("flash_attention_fwd", "flash_attention_fwd_sm90")}
    table["flash_decode"] = timing[("flash_decode", "decode", "bfloat16")]
    return errs, {n: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")} for n, t in table.items()}


def _sdpa_bwd(q, k, v, dout):
    """PyTorch's fused attention backward on the same inputs (causal, GQA):
    ``(forward+backward, forward)`` callables, timed only."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dt = dout.transpose(1, 2)
    fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    both = lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dt)
    return both, fwd


def attention_bwd_kernels_vs_plain():
    """``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` against
    their plain versions, f32 and bf16 (both passes in bf16 through the
    tensor-core kernels, picked by dtype, and the CUDA-core ones, named), a
    second call bitwise equal; times at the training shape, per wrapper
    call and on the device alone, beside SDPA's backward."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_dkv, flash_attention_bwd_dq
    from repro_torch.kernels.flash_attention.ref import (
        _visible,
        attention_delta,
        flash_attention_bwd_dkv_ref,
        flash_attention_bwd_dq_ref,
        flash_attention_ref_lse,
    )

    dev = torch.device("cuda")
    errs = {n: 0.0 for n in BWD_KERNELS}
    timing = {}
    cases = [
        ("smollm train", (TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], 9, 3, 64), dict(causal=True)),
        ("tail window+softcap", (2, 37, 37, 4, 2, 32), dict(causal=True, window=16, softcap=30.0)),
        ("cross hd128", (2, 70, 45, 8, 2, 128), dict(causal=False)),
        ("cross hd128 window", (1, 70, 33, 4, 1, 128), dict(causal=False, window=16)),  # fully-masked rows
    ]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
        # bf16: the tensor-core kernels (picked by dtype) and the CUDA-core ones (named)
        passes = {"dq": {None: "flash_attention_bwd_dq"}, "dkv": {None: "flash_attention_bwd_dkv"}}
        if dtype == torch.bfloat16:
            passes = {w: {None: f"flash_attention_bwd_{w}_sm90", "cuda_core": f"flash_attention_bwd_{w}"} for w in passes}
        fns = {"dq": (flash_attention_bwd_dq, flash_attention_bwd_dq_ref),
               "dkv": (flash_attention_bwd_dkv, flash_attention_bwd_dkv_ref)}
        for ci, (tag, shape, kw) in enumerate(cases):
            q, k, v = _attn_case(*shape, dtype, seed=20 + ci, device=dev)
            g = torch.Generator(device="cpu").manual_seed(30 + ci)
            dout = torch.randn(q.shape, generator=g).to(dtype).to(dev)
            out, lse = flash_attention_ref_lse(q, k, v, **kw)
            delta = attention_delta(out, dout)
            args = (q, k, v, dout, lse, delta)
            name = f"{tag} {dname}"
            for w, variants in passes.items():
                kern, plain = fns[w]
                outs = ("dq",) if w == "dq" else ("dk", "dv")
                as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
                want = as_tuple(plain(*args, **kw))
                for variant, kname in variants.items():
                    reset_launch_counts()
                    got = as_tuple(kern(*args, variant=variant, **kw))
                    torch.cuda.synchronize()
                    if launch_counts()[f"flash_attention_bwd_{w}_sm90"] != int(kname.endswith("_sm90")):
                        fail(f"flash_attention_bwd_{w} {name} variant {variant}: launched {launch_counts()}")
                    for out_name, a, r in zip(outs, got, want):
                        errs[kname] = max(errs[kname], _err(f"{kname} {name} {out_name}", a, r))
                    again = as_tuple(kern(*args, variant=variant, **kw))
                    if not all(torch.equal(a, b) for a, b in zip(again, got)):
                        fail(f"{kname} {name}: a second call gave other bits")
            if ci != 0:
                continue
            b, sq, sk, h, kh, hd = shape
            pairs = int(_visible(sq, sk, True, 0, "cpu").sum())  # the causal (query, key) pairs
            its = q.element_size()
            rows = 2 * 4 * b * sq * h  # lse and delta, f32
            work = {
                # s, dp, dq; inputs q k v dout lse delta, output dq
                "dq": ((3 * q.numel() + 2 * k.numel()) * its + rows, 3 * 2 * b * h * pairs * hd),
                # s, dp, dv, dk; outputs dk dv
                "dkv": ((2 * q.numel() + 4 * k.numel()) * its + rows, 4 * 2 * b * h * pairs * hd),
            }
            both, fwd = _sdpa_bwd(q, k, v, dout)
            library = _time_ms(both, iters=50) - _time_ms(fwd, iters=50)
            on_device = dtype == torch.bfloat16  # device times for the main paths' dtype
            library_dev = _graph_ms(both) - _graph_ms(fwd) if on_device else None
            calls = {}
            for w, variants in passes.items():
                kern, plain = fns[w]
                for variant, kname in variants.items():
                    calls[kname] = (w, lambda kern=kern, variant=variant: kern(*args, variant=variant, **kw),
                                    lambda plain=plain: plain(*args, **kw))
            for n, (w, kern, plain) in calls.items():
                bound, bound_by = _bound_ms(*work[w], peak)
                timing[(n, dname)] = {
                    "ms": _time_ms(kern, iters=50), "plain_ms": _time_ms(plain, iters=20),
                    "bound_ms": bound, "bound_by": bound_by, "library_ms": library,
                    "device_ms": _graph_ms(kern) if on_device else None, "library_device_ms": library_dev,
                }
        print(f"attention backward kernels agree with plain versions in {dname}, bitwise on a second call", flush=True)
    for (name, dname), t in timing.items():
        print(f"time {name} training shape {dname}: " + json.dumps(t), flush=True)
    # the training path runs in bf16: its times go in the table
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return errs, {n: {k: timing[(n, "bfloat16")][k] for k in keys} for n in BWD_KERNELS}


def _check_variants(where, counts, dtype):
    """The attention launches of a run in ``dtype``: bf16 runs go through the
    tensor-core kernels only (their counters equal the op counters), f32
    runs through the CUDA-core kernels only; the forward ran at least once."""
    if counts["flash_attention_fwd"] == 0:
        fail(f"{where}: the attention forward never launched")
    for op, variant in SM90.items():
        want = counts[op] if dtype == "bfloat16" else 0
        if counts[variant] != want:
            fail(f"{where} ({dtype}): {variant} launched {counts[variant]} times, expected {want} of {counts[op]} {op}")


# ---------------------------------------------------------------------------
# phase 3


def small_input_agreement():
    """At a small input, every gradient an Algorithm-1 step takes through
    the kernels (backend "cuda") agrees with plain autograd of the plain ops
    (backend "ref"): the generator's (Eq. 8, through the clients, the server
    and both loss kernels), the server's (Eq. 4 on a DHS batch) and the
    ensembling weights' (Eq. 12). Then one whole epoch per backend, whose
    parameter gaps are printed: Adam's first steps and the EE sign step act
    on the signs of gradient components, so rounding-level differences can
    move a parameter by a whole step there, and the epoch is held only to
    finite losses."""
    import dataclasses
    from functools import partial

    import torch

    from repro_torch.config.train import OFLConfig
    from repro_torch.core.buffer import buffer_init
    from repro_torch.core.ensemble import make_logits_all
    from repro_torch.core.epoch import distill_schedule, make_coboost_epoch, make_kd_loss
    from repro_torch.core.hard_samples import diversify
    from repro_torch.core.hardness import generator_loss
    from repro_torch.core.weight_search import weight_grad
    from repro_torch.models.cnn import cnn_apply, init_cnn
    from repro_torch.models.generator import image_generator, init_image_generator
    from repro_torch.utils.prng import Draws
    from repro_torch.utils.trees import flatten_dict, value_and_grad

    dev = torch.device("cuda")
    classes, shape, k, batch, latent = 4, (16, 16, 3), 3, 16, 8
    g = torch.Generator(device=dev).manual_seed(0)
    clients = [init_cnn(g, "cnn5", classes, shape) for _ in range(k)]
    server = init_cnn(g, "cnn5", classes, shape)
    gen0 = init_image_generator(g, latent, classes, shape)
    w = torch.softmax(torch.randn((k,), generator=g, device=dev), 0)
    logits_all = make_logits_all([partial(cnn_apply, "cnn5")] * k)
    server_apply = partial(cnn_apply, "cnn5")
    gen_apply = lambda p, z, y: image_generator(p, z, y, shape)
    draws = Draws(1, dev)
    z, y = draws.zy(batch, latent, classes)
    with torch.no_grad():
        x = gen_apply(gen0, z, y)
    xd = diversify(logits_all, clients, w, x, draws.direction((batch, classes)), 8.0 / 255.0)
    with torch.no_grad():
        la = logits_all(clients, xd)

    def gen_loss(gp, backend):
        xg = gen_apply(gp, z, y)
        return generator_loss(logits_all(clients, xg), w, server_apply(server, xg), y, backend=backend)

    got = {}
    for backend in ("cuda", "ref"):
        lg, g_gen = value_and_grad(gen_loss, gen0, backend)
        lk, g_srv = value_and_grad(make_kd_loss(logits_all, server_apply, 4.0, backend), server, xd, clients, w)
        got[backend] = {"gen_loss": lg, "kd_loss": lk, "g_w": weight_grad(w, la, y, backend)}
        got[backend].update({f"g_gen {p}": v for p, v in flatten_dict(g_gen).items()})
        got[backend].update({f"g_srv {p}": v for p, v in flatten_dict(g_srv).items()})
    worst = max(_err(f"small input {name}", got["cuda"][name], want) for name, want in got["ref"].items())
    print(f"small input: kernel gradients vs plain autograd, largest abs err {worst:.3e}", flush=True)

    cfg = OFLConfig(num_clients=k, gen_iters=3, batch_size=batch, latent_dim=latent, buffer_batches=2)
    runs = []
    for backend in ("cuda", "ref", "ref"):
        c = dataclasses.replace(cfg, backend=backend)
        step, gen_opt, srv_opt = make_coboost_epoch(logits_all, server_apply, gen_apply, c, k, classes)
        buf = buffer_init(c.buffer_batches, (batch, *shape), device=dev)
        order, n_valid = distill_schedule(0, c.buffer_batches)
        sp, _, gp, _, w1, buf, _, gloss, dmean = step(
            server, srv_opt.init(server), gen0, gen_opt.init(gen0), torch.full((k,), 1.0 / k, device=dev),
            buf, Draws(2, dev), 0, order, n_valid, clients,
        )
        if not (math.isfinite(float(gloss)) and math.isfinite(float(dmean))):
            fail(f"small epoch ({backend}): non-finite loss")
        runs.append((flatten_dict(sp), flatten_dict(gp), w1, buf.x[0].clone()))

    def gaps(a, b):
        diff = lambda d1, d2: max(float((d1[p] - d2[p]).abs().max()) for p in d2 if torch.is_tensor(d2[p]))
        return {
            "server": diff(a[0], b[0]), "generator": diff(a[1], b[1]),
            "w": float((a[2] - b[2]).abs().max()), "buffer": float((a[3] - b[3]).abs().max()),
        }

    print("small epoch gaps, cuda vs ref: " + json.dumps(gaps(runs[0], runs[1])), flush=True)
    print("small epoch gaps, ref vs ref:  " + json.dumps(gaps(runs[2], runs[1])), flush=True)


def _lm_grads(cfg, params, batch):
    """``lm_loss`` and its gradients (flattened) through the kernels
    (backend "cuda") and through plain autograd (backend "ref")."""
    from repro_torch.models.transformer import lm_loss
    from repro_torch.utils.trees import flatten_dict, value_and_grad

    out = {}
    for backend in ("cuda", "ref"):
        c = cfg.replace(backend=backend)
        loss, grads = value_and_grad(lambda p: lm_loss(p, c, batch)[0], params)
        layers = grads.pop("layers")
        flat = flatten_dict(grads)
        for i, layer in enumerate(layers):
            flat.update({f"layers/{i}/{p}": g for p, g in flatten_dict(layer).items()})
        out[backend] = {"loss": loss, **flat}
    return out["cuda"], out["ref"]


def lm_small_input_agreement():
    """Reduced smollm-135m in f32: the gradients of one ``lm_loss`` through
    the attention kernels agree with plain autograd."""
    import torch

    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(3))
    batch = {n: torch.as_tensor(a, device=dev) for n, a in make_token_stream(3, cfg.vocab_size, 4, 64).items()}
    reset_launch_counts()
    got, want = _lm_grads(cfg, params, batch)
    _check_variants("reduced lm_loss", launch_counts(), "float32")
    worst = max(_err(f"reduced lm_loss {name}", got[name], w) for name, w in want.items())
    print(f"small input: reduced smollm-135m lm_loss gradients, kernels vs plain autograd, largest abs err {worst:.3e}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 4


def main_path():
    import time

    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import ofl

    argv = [
        "--method", "coboosting", "--clients", "5", "--classes", "10", "--image", "32",
        "--batch", "128", "--gen-iters", "30", "--epochs", "3", "--local-epochs", "2",
        "--per-class", "500", "--server-arch", "cnn5", "--device", "cuda",
    ]
    reset_launch_counts()
    t0 = time.perf_counter()
    result = ofl.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: launch_counts()[n] for n in LOSS_KERNELS}
    print(f"training path ({wall:.1f} s): {json.dumps(result)}", flush=True)
    for name, n in counts.items():
        if n == 0:
            fail(f"training path never launched {name}")
    for key in ("server_acc", "ensemble_acc", "gen_loss", "distill_loss"):
        if key not in result or not math.isfinite(result[key]):
            fail(f"main path result lacks a finite {key}: {result}")
    return counts


# ---------------------------------------------------------------------------
# phase 5


def serving_parity_f32():
    """Full width in f32: the paged engine's greedy tokens equal the static
    dense-cache path's (same prefill kernel, decode through the plain
    small-SDPA) for 4 requests x 16 tokens. As in the CPU serving test, the
    tied embedding is scaled by 10 to widen the random model's top-2 logit
    margins, and the static path's smallest margin must exceed 1e-3, so
    that no near-tie decides a token."""
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import init_lm, lm_forward
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine, static_generate

    dev = torch.device("cuda")
    cfg = get_arch("smollm-135m").replace(dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    params["embed"]["table"] *= 10.0
    n, gen, prompt = 4, 16, SERVE["prompt"]
    tokens = make_token_stream(1, cfg.vocab_size, n, prompt)["tokens"]
    ecfg = EngineConfig(max_slots=n, max_seq=prompt + gen, max_new=gen, page_size=SERVE["page"], kv_layout="paged")
    reset_launch_counts()
    comps = ContinuousScheduler(ServeEngine(cfg, params, ecfg), clock=ManualClock()).run(
        [Request(rid=i, tokens=tokens[i], max_new_tokens=gen) for i in range(n)]
    )
    prompts = torch.as_tensor(tokens, device=dev)
    want = static_generate(params, cfg, {"tokens": prompts}, gen)
    _check_variants("f32 serving", launch_counts(), "float32")
    with torch.inference_mode():  # the logits behind each static token, teacher-forced
        logits, _ = lm_forward(params, cfg, {"tokens": torch.cat([prompts, want[:, :-1].to(prompts.dtype)], 1)})
    top2 = logits[:, prompt - 1 :].topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    if margin <= 1e-3:
        fail(f"f32 serving: the static path has a near-tie (top-2 margin {margin:.2e}), the comparison cannot decide")
    want = want.cpu().numpy()
    got = np.stack([c.tokens for c in comps])
    if not np.array_equal(got, want):
        fail(f"f32 serving: paged engine tokens {got.tolist()} != static dense-cache path {want.tolist()}")
    print(f"serving f32 at full width: paged engine == static dense-cache path (same prefill kernel) on {n}x{gen} "
          f"tokens, smallest top-2 margin {margin:.3e}", flush=True)


def serving_path():
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve

    argv = [
        "--arch", "smollm-135m", "--engine", "continuous", "--kv-layout", "paged",
        "--requests", str(SERVE["requests"]), "--prompt-len", str(SERVE["prompt"]), "--gen", str(SERVE["gen"]),
        "--max-slots", str(SERVE["slots"]), "--page-size", str(SERVE["page"]), "--device", "cuda",
    ]
    reset_launch_counts()
    t0 = time.perf_counter()
    result = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: launch_counts()[n] for n in ATTN_KERNELS}
    _check_variants("serving path", launch_counts(), "bfloat16")
    comps = result["completions"]
    summary = {k: result[k] for k in ("tok_per_s", "tokens", "p50_s", "p95_s", "ttft_p50_s", "ttft_p95_s", "wall_s")}
    print(f"serving path ({wall:.1f} s with set-up): {json.dumps(summary)}", flush=True)
    for name, n in counts.items():
        if n == 0:
            fail(f"serving path never launched {name}")
    if len(comps) != SERVE["requests"] or any(len(c.tokens) != SERVE["gen"] for c in comps):
        fail(f"serving path: expected {SERVE['requests']} completions of {SERVE['gen']} tokens")
    if any(int(t) < 0 or int(t) >= 49152 for c in comps for t in c.tokens):
        fail("serving path: token id out of the vocabulary")
    # the same run again under torch.profiler (device activity only): the
    # device's busy and idle share; its times are not the ones above
    prof = serve.main(argv + ["--profile"])
    busy, pwall = prof["device_busy_s"], prof["wall_s"]
    print(f"serving path profiled: device busy {busy:.3f} s of {pwall:.3f} s wall, idle share {1 - busy / pwall:.3f}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phases 6 and 7


def lm_training_path():
    import numpy as np
    import torch

    from repro_torch.config.registry import get_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    # one step at full width (f32 params), with f32 and then bf16 activations:
    # kernel gradients against plain autograd
    cfg = get_arch("smollm-135m")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(5))
    batch = {n: torch.as_tensor(a, device=dev) for n, a in make_token_stream(5, cfg.vocab_size, 2, TRAIN["seq"]).items()}
    def gaps(got, want):
        """Each leaf's largest gap relative to its largest gradient:
        ``(largest over leaves, its leaf, median over leaves)``."""
        rel = {n: float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30) for n, w in want.items()}
        worst = max(rel, key=rel.get)
        return rel[worst], worst, float(np.median(list(rel.values())))

    plain, kernels = {}, {}
    for dtype in ("float32", "bfloat16"):
        reset_launch_counts()
        kernels[dtype], plain[dtype] = _lm_grads(cfg.replace(dtype=dtype), params, batch)
        got = kernels[dtype]
        _check_variants(f"{dtype} full-width step", launch_counts(), dtype)
        for name, g in got.items():
            if not bool(torch.isfinite(g).all()):
                fail(f"{dtype} full-width step: gradient {name} not finite")
        gap, leaf, median = gaps(got, plain[dtype])
        print(f"{dtype} full-width lm_loss step, kernels vs plain autograd: loss {float(got['loss']):.6f} (plain "
              f"{float(plain[dtype]['loss']):.6f}); largest gradient gap relative to the leaf's largest gradient "
              f"{gap:.3e} ({leaf}), median over leaves {median:.3e}", flush=True)
        if dtype == "float32" and gap > 1e-3:
            fail(f"f32 full-width step: gradient gap {gap:.3e} at {leaf} beyond 1e-3")
    gap, leaf, median = gaps(plain["bfloat16"], plain["float32"])
    print(f"yardstick, plain autograd in bf16 vs in f32 activations: largest gradient gap {gap:.3e} ({leaf}), "
          f"median over leaves {median:.3e}", flush=True)
    # the gate on the kernels' bf16 rounding (P and dS rounded to bf16 for
    # the tensor cores): no further from the f32 gradients than twice what
    # bf16 activations alone move them
    kgap, kleaf, kmedian = gaps(kernels["bfloat16"], plain["float32"])
    print(f"bf16 kernels vs plain autograd in f32 activations: largest gradient gap {kgap:.3e} ({kleaf}), median "
          f"over leaves {kmedian:.3e}; limit 2 x {gap:.3e}", flush=True)
    if kgap > 2 * gap:
        fail(f"bf16 full-width step: the kernels' gradient gap to f32 {kgap:.3e} at {kleaf} beyond 2 x {gap:.3e}")
    del params, plain, kernels

    argv = ["--arch", "smollm-135m", "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
            "--steps", str(TRAIN["steps"]), "--optimizer", "adamw", "--device", "cuda"]
    reset_launch_counts()
    t0 = time.perf_counter()
    result = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: launch_counts()[n] for n in TRAIN_KERNELS}
    _check_variants("LM training path", launch_counts(), "bfloat16")
    losses = result["losses"]
    summary = {k: result[k] for k in ("first10", "last10", "s_per_step", "tok_per_s", "max_memory_bytes", "params")}
    print(f"LM training path ({wall:.1f} s with set-up): {json.dumps(summary)}; launches {json.dumps(counts)}", flush=True)
    want_n = TRAIN["layers"] * TRAIN["steps"]
    for name, n in counts.items():
        if n != want_n:
            fail(f"LM training path launched {name} {n} times, expected {want_n}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"LM training path: non-finite loss in {losses}")
    if not result["last10"] < result["first10"]:
        fail(f"LM training path: loss did not fall (first-10 {result['first10']:.4f}, last-10 {result['last10']:.4f})")
    print(f"LM training: {result['s_per_step']:.4f} s/step, {result['tok_per_s']:.1f} tokens/s after the first step, "
          f"max_memory_allocated {result['max_memory_bytes']} bytes, loss {np.mean(losses[:10]):.4f} -> "
          f"{np.mean(losses[-10:]):.4f}", flush=True)
    return counts


def lm_distill_path():
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import distill_llm

    reset_launch_counts()
    t0 = time.perf_counter()
    result = distill_llm.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: launch_counts()[n] for n in TRAIN_KERNELS}
    _check_variants("LM distillation path", launch_counts(), "bfloat16")
    print(f"LM distillation path ({wall:.1f} s with set-up): kd {result['kd']}, final w {result['w'][-1]}; "
          f"launches {json.dumps(counts)}", flush=True)
    if len(result["kd"]) != 8 or not all(math.isfinite(x) for x in result["kd"]):
        fail(f"LM distillation path: kd not finite at every epoch: {result['kd']}")
    for w in result["w"]:
        if abs(sum(w) - 1.0) > 1e-5:
            fail(f"LM distillation path: w {w} does not sum to 1")
    for name, n in counts.items():
        if n == 0:
            fail(f"LM distillation path never launched {name}")


def main() -> None:
    environment()
    import torch

    errs, timing = kernels_vs_plain()
    attn_errs, attn_timing = attention_kernels_vs_plain()
    errs.update(attn_errs)
    timing.update(attn_timing)
    bwd_errs, bwd_timing = attention_bwd_kernels_vs_plain()
    errs.update(bwd_errs)
    timing.update(bwd_timing)
    small_input_agreement()
    lm_small_input_agreement()
    counts = main_path()
    serving_parity_f32()
    serving = serving_path()
    counts.update(serving)
    counts.update(lm_training_path())
    print(f"flash_attention_fwd launches: serving path {serving['flash_attention_fwd']} (tensor cores "
          f"{serving['flash_attention_fwd_sm90']}), LM training path {counts['flash_attention_fwd']} (tensor cores "
          f"{counts['flash_attention_fwd_sm90']}; the table's)", flush=True)
    lm_distill_path()
    print("kernels: " + json.dumps({n: {"launches": counts[n], "max_abs_err": errs[n]} for n in REPLACES}))
    table = [
        {
            "name": n, "route": ROUTES[n], "source": SOURCES[n], "replaces": REPLACES[n],
            "launches": counts[n], "max_abs_err": errs[n], "library_ms": None, **timing[n],
        }
        for n in REPLACES
    ]
    print(json.dumps({"kernels": table}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
