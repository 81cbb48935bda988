"""LM training entry point (the port of ``repro.launch.train``).

    # smollm-135m at full width on the GPU (bf16 activations, f32 params)
    python -m repro_torch.launch.train --arch smollm-135m --steps 30 --batch 8 --seq 256

    # the reduced variant in f32 on the CPU
    python -m repro_torch.launch.train --arch smollm-135m --reduced --device cpu --steps 40

Data is the seeded hidden-Markov token stream of the reference
(``make_token_stream(seed·10000 + step, ...)``, bitwise the same batches),
made for every step before the first one; loss falls below the uniform
floor log(V) within a few dozen steps. Weights are random, made from
``--seed``. AdamW (by default) with linear warm-up over ``steps // 20``
steps and a cosine decay, weight decay 0, as the reference configures it.
Attention runs through the flash-attention op (forward and both backward
passes as CUDA kernels on the card; ``--backend ref`` is plain autograd).
Runs on ``cuda`` unless ``--device cpu`` is given. ``--mesh host`` (the
default) trains on one device without a mesh; ``--mesh production``
(``multipod``) shards the params, the AdamW moments and the batch over the
16x16 (2x16x16) mesh of a 256- (512-) rank ``torchrun`` world, FSDP over
``data`` and tensor parallel over ``model``, and exits before any
allocation in any other world::

    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train --mesh production

A VLM (phi-3-vision-4.2b) trains on the same text
with a prefix of patch embeddings for step ``i`` from
``RandomState(i).randn(batch, P, frontend_dim) · 0.02``, as the reference
makes it (made with the token batches, before the first step); the loss is
on the text positions. The audio encoder is refused,
as the reference refuses it: hubert trains through ``lm_loss`` on frames.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.config.train import TrainConfig
from repro_torch.convert import lm_params_to_jax
from repro_torch.data.synthetic import make_token_stream
from repro_torch.kernels.dispatch import KERNEL_BACKENDS
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.models.transformer import init_lm
from repro_torch.runtime.steps import make_train_step
from repro_torch.sharding.partition import is_dtensor, mesh_context, shard_params
from repro_torch.utils.device import disable_tf32, get_device, profiled
from repro_torch.utils.logging import get_logger
from repro_torch.utils.trees import tree_leaves, tree_map

log = get_logger("train")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--optimizer", default="adamw")
    p.add_argument("--reduced", action="store_true", help="smoke-scale variant, in f32")
    p.add_argument("--mesh", default="host", choices=("host", "production", "multipod"))
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="auto", choices=KERNEL_BACKENDS,
                   help="attention kernels: auto (CUDA kernels for CUDA tensors, plain versions on the CPU) | cuda | ref")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--profile", action="store_true",
                   help="trace the steps after the first with torch.profiler and log the device's busy share and "
                        "the kernels by device time (the tracing slows the run down)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    if args.steps < 1 or args.batch < 1 or args.seq < 1:
        raise SystemExit("--steps, --batch and --seq must be >= 1")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_variant(cfg).replace(dtype="float32", param_dtype="float32")
    if cfg.is_encoder_only:
        raise SystemExit("use launch.train for LM archs; hubert trains via lm_loss on frames")
    cfg = cfg.replace(backend=args.backend)
    tc = TrainConfig(
        optimizer=args.optimizer,
        learning_rate=args.lr,
        schedule="linear_warmup_cosine",
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
        seed=args.seed,
    )
    device = get_device(args.device)
    mesh = launcher_mesh(args.mesh, device)  # None for host; exits on a wrong world first
    disable_tf32()
    data = [make_token_stream(args.seed * 10_000 + i, cfg.vocab_size, args.batch, args.seq) for i in range(args.steps)]
    if cfg.family == "vlm":  # the reference's prefix of step i
        for i, d in enumerate(data):
            d["prefix"] = np.random.RandomState(i).randn(args.batch, cfg.num_prefix_tokens, cfg.frontend_dim).astype(
                np.float32) * 0.02

    params = init_lm(cfg, torch.Generator(device=device).manual_seed(args.seed))
    if mesh is not None:
        params = shard_params(params, mesh)
    step_fn = make_train_step(cfg, tc)
    opt_state = step_fn.optimizer.init(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log.info("arch=%s params=%.1fM device=%s dtype=%s mesh=%s", cfg.name, n_params / 1e6, device, cfg.dtype,
             None if mesh is None else tuple(mesh.shape))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    tokens_per_step = args.batch * args.seq
    losses = []
    t0 = t_first = time.perf_counter()

    def run(i0, i1):
        nonlocal params, opt_state, t_first
        for i in range(i0, i1):
            batch = {k: torch.as_tensor(v, device=device) for k, v in data[i].items()}
            with mesh_context(mesh):
                params, opt_state, metrics = step_fn(params, opt_state, batch, i)
            losses.append(float(metrics["loss"]))  # a host read: the step has finished
            now = time.perf_counter()
            if i == 0:
                t_first = now
            if (i + 1) % args.log_every == 0 or i == 0:
                tok_s = i * tokens_per_step / (now - t_first) if i else float("nan")
                log.info(
                    "step %4d loss=%.4f (avg10=%.4f) %.2fs/step %.0f tok/s",
                    i, losses[-1], float(np.mean(losses[-10:])), (now - t0) / (i + 1), tok_s,
                )

    run(0, 1)  # builds the kernels
    busy = None
    if args.profile and args.steps > 1:
        _, busy, pwall = profiled(lambda: run(1, args.steps), log)
        log.info("profile: device busy %.3fs of %.3fs wall (%.1f%% idle)", busy, pwall, 100.0 * (1 - busy / pwall))
    else:
        run(1, args.steps)
    wall = time.perf_counter() - t0
    first10, last10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    log.info(
        "done: first-10 avg=%.4f last-10 avg=%.4f (uniform floor=%.4f)", first10, last10, math.log(cfg.vocab_size)
    )
    result = {
        "losses": losses,
        "first10": first10,
        "last10": last10,
        "s_per_step": wall / args.steps,
        # throughput after the first step (which builds the kernels)
        "tok_per_s": (args.steps - 1) * tokens_per_step / (wall - (t_first - t0)) if args.steps > 1 else float("nan"),
        "params": n_params,
        "max_memory_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "device_busy_s": busy,
    }
    if device.type == "cuda":
        log.info("%.3f s/step, %.0f tok/s after the first step, peak device memory %.2f GiB",
                 result["s_per_step"], result["tok_per_s"], result["max_memory_bytes"] / 2**30)
    if args.ckpt_dir:
        whole = tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, params)  # gathered to save
        path = save_checkpoint(args.ckpt_dir, args.steps, lm_params_to_jax(cfg, whole), {"arch": cfg.name})
        log.info("checkpoint saved: %s", path)
        result["checkpoint"] = path
    return result


if __name__ == "__main__":
    main()
