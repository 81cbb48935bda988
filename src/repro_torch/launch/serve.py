"""Serving entry point for the distilled server LM: the continuous-batching
engine (default) or the static-batch baseline, on the GPU.

    # continuous batching through the paged KV pool and the flash-decode
    # kernel, at full width (smollm-135m: 30 layers, d_model 576)
    python -m repro_torch.launch.serve --arch smollm-135m --engine continuous \\
        --kv-layout paged --requests 16 --prompt-len 128 --gen 64 --max-slots 8

    # a reduced model on the CPU (f32, 2 layers)
    python -m repro_torch.launch.serve --arch smollm-135m --reduced --device cpu \\
        --requests 6 --max-slots 3 --prompt-len 24 --gen 12

    # static baseline: one batch, prefill then decode on the dense cache
    python -m repro_torch.launch.serve --reduced --device cpu --engine static \\
        --batch 3 --prompt-len 24 --gen 12

Weights are random, made from ``--seed``. Full width serves in the
config's bf16 activations with f32 params; ``--reduced`` runs the reduced
variant in f32, as the JAX launcher does. Runs on ``cuda`` unless
``--device cpu`` is given. Arguments are checked, and the engine and KV
pool configuration built on the host, before anything touches the device.

Telemetry (:mod:`repro_torch.obs`), off by default: ``--metrics-out``
routes the engine's and the router's stats into the shared registry and
dumps it at exit (JSONL plus a ``.prom`` sibling), ``--trace-out`` dumps the
host spans as Chrome trace-event JSON, ``--profile-dir`` writes a
``torch.profiler`` trace with every span as a ``record_function`` range.
``python -m repro_torch.obs.validate`` checks the first two.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.data.synthetic import make_token_stream
from repro_torch.kernels.dispatch import KERNEL_BACKENDS
from repro_torch.models.transformer import cast_weights, init_lm
from repro_torch.serve import (
    ContinuousScheduler,
    EngineConfig,
    KVPool,
    Request,
    ServeEngine,
    latency_summary,
    static_generate,
)
from repro_torch.utils.device import disable_tf32, get_device, profiled
from repro_torch.utils.logging import get_logger

log = get_logger("serve")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--engine", default="continuous", choices=("continuous", "static"))
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--backend", default="auto", choices=KERNEL_BACKENDS,
                   help="attention kernels (prefill and paged decode): auto (CUDA kernels for "
                        "CUDA tensors, plain versions on the CPU) | cuda | ref")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # static arm
    p.add_argument("--batch", type=int, default=4)
    # continuous arm
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--request-rate", type=float, default=0.0, help="arrivals per second (0 = all at t=0)")
    p.add_argument("--max-slots", type=int, default=4)
    p.add_argument("--decode-chunk", type=int, default=8)
    p.add_argument("--kv-layout", default="paged", choices=("paged", "dense"),
                   help="paged: KVPool + flash-decode; dense: per-slot rectangle + SDPA")
    p.add_argument("--page-size", type=int, default=16, help="tokens per KV page (power of two)")
    p.add_argument("--pool-pages", type=int, default=0, help="KV pool capacity in pages (0 = full per-slot capacity)")
    p.add_argument("--profile", action="store_true",
                   help="trace the timed run with torch.profiler and log the device's busy share and the "
                        "kernels by device time (the tracing slows the run down)")
    # telemetry (repro_torch.obs) — off by default, zero-cost when off
    p.add_argument("--metrics-out", default=None, metavar="PATH.jsonl",
                   help="dump the metrics registry as JSONL (plus a .prom "
                        "Prometheus-text sibling) at exit; also routes every "
                        "replica's stats into one shared registry with "
                        "replica labels")
    p.add_argument("--trace-out", default=None, metavar="PATH.json",
                   help="record host-side spans (route/admit/prefill/handoff/"
                        "decode-chunk/...) and dump Chrome trace-event JSON "
                        "(Perfetto-loadable) at exit")
    p.add_argument("--profile-dir", default=None,
                   help="also run a torch.profiler trace into this directory, "
                        "bridging every span to a record_function range so host "
                        "and device timelines line up")
    return p


def _finalize_telemetry(args, engines=()) -> None:
    """Publish end-of-run KV pool gauges and dump the artifacts the flags
    asked for (:mod:`repro_torch.obs.validate` checks them)."""
    for eng in engines:
        eng.publish_gauges()
    if args.profile_dir:
        log.info("profile -> %s", obs.stop_torch_profile(obs.tracer()))
    if args.metrics_out:
        obs.registry().dump(args.metrics_out)
        log.info("metrics snapshot -> %s (+ .prom)", args.metrics_out)
    if args.trace_out:
        obs.tracer().dump(args.trace_out)
        log.info("trace -> %s (%d events)", args.trace_out, len(obs.tracer()))


def continuous_engine_config(args) -> EngineConfig:
    max_seq = args.prompt_len + args.gen
    if args.kv_layout == "paged":
        # the page-table extent must recover the logical cache length exactly
        max_seq = -(-max_seq // args.page_size) * args.page_size
    return EngineConfig(
        max_slots=args.max_slots,
        max_seq=max_seq,
        max_new=args.gen,
        decode_chunk=args.decode_chunk,
        temperature=args.temperature,
        seed=args.seed,
        kv_layout=args.kv_layout,
        page_size=args.page_size,
        pool_pages=args.pool_pages,
    )


def validate_args(args, cfg) -> None:
    """Fail fast, with a clear message, before any device allocation."""
    if args.prompt_len < 1 or args.gen < 1:
        raise SystemExit(f"--prompt-len ({args.prompt_len}) and --gen ({args.gen}) must be >= 1")
    if args.profile and args.profile_dir:
        raise SystemExit("--profile and --profile-dir each run torch.profiler, and one process runs one: pick one")
    if args.engine == "static":
        if args.batch < 1:
            raise SystemExit(f"--batch must be >= 1, got {args.batch}")
        return
    for flag, value, low in (("--max-slots", args.max_slots, 1), ("--requests", args.requests, 1),
                             ("--decode-chunk", args.decode_chunk, 1), ("--pool-pages", args.pool_pages, 0)):
        if value < low:
            raise SystemExit(f"{flag} must be >= {low}, got {value}")
    if args.request_rate < 0:
        raise SystemExit(f"--request-rate must be >= 0, got {args.request_rate}")
    try:
        ecfg = continuous_engine_config(args)
        if args.kv_layout == "paged":
            KVPool(cfg, ecfg)
    except ValueError as ex:
        raise SystemExit(str(ex))


def run_static(args, cfg, params, device) -> dict:
    data = make_token_stream(args.seed, cfg.vocab_size, args.batch, args.prompt_len)
    batch = {"tokens": torch.as_tensor(data["tokens"][:, : args.prompt_len], device=device)}
    gen = torch.Generator(device=device)
    run = lambda: static_generate(
        params, cfg, batch, args.gen, temperature=args.temperature, generator=gen.manual_seed(args.seed)
    ).cpu()
    run()  # builds the kernels and warms the allocator
    t0 = time.perf_counter()
    out = run().numpy()
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    log.info("static: %d tokens in %.3fs (%.1f tok/s)", toks, dt, toks / max(dt, 1e-9))
    log.info("sample continuation (seq 0): %s", out[0, :16].tolist())
    _finalize_telemetry(args)
    return {"tokens": float(toks), "wall_s": dt, "tok_per_s": toks / max(dt, 1e-9), "sample": out[0].tolist()}


def run_continuous(args, cfg, params) -> dict:
    dt = 1.0 / args.request_rate if args.request_rate > 0 else 0.0
    data = make_token_stream(args.seed, cfg.vocab_size, args.requests, args.prompt_len)
    requests = [
        Request(rid=i, tokens=data["tokens"][i, : args.prompt_len].astype(np.int32), max_new_tokens=args.gen, arrival=i * dt)
        for i in range(args.requests)
    ]
    # with --metrics-out the engine's stats land in the process-global
    # registry under its replica label; without it the engine keeps its
    # private always-on registry
    registry = obs.registry() if args.metrics_out else None
    engine = ServeEngine(cfg, params, continuous_engine_config(args), registry=registry)
    sched = ContinuousScheduler(engine)
    # every admission size and the decode chunk run once before timing
    engine.warmup(requests[0].tokens, min(2, args.gen))
    busy = None
    if args.profile:
        completions, busy, wall = profiled(lambda: sched.run(requests), log)
        log.info("profile: device busy %.3fs of %.3fs wall (%.1f%% idle)", busy, wall, 100.0 * (1 - busy / wall))
    else:
        t0 = time.perf_counter()
        completions = sched.run(requests)
        wall = time.perf_counter() - t0
    s = latency_summary(completions, wall)
    log.info(
        "fleet[1]: %d reqs, %d tokens in %.3fs (%.1f tok/s) "
        "p50=%.3fs p95=%.3fs queue-wait p50=%.3fs p95=%.3fs",
        len(completions), int(s["tokens"]), wall, s["tok_per_s"],
        s["p50_s"], s["p95_s"], s["queue_wait_p50_s"], s["queue_wait_p95_s"],
    )
    log.info(
        "replica 0: %d reqs, %d decode chunks, %d host syncs, %d prefills, %d handoffs",
        len(completions), engine.stats["decode_chunks"], engine.stats["host_syncs"],
        engine.stats["prefill_dispatches"], engine.stats["handoffs"],
    )
    if engine.pool is not None:
        log.info(
            "replica 0 kv pool: %d pages x %d tokens (%s layout), %d decode-time appends",
            engine.pool.n_pages, engine.pool.page_size, engine.layout, engine.stats["page_appends"],
        )
    log.info("sample continuation (rid 0): %s", completions[0].tokens[:16].tolist())
    _finalize_telemetry(args, [engine])
    return {**s, "wall_s": wall, "device_busy_s": busy, "stats": dict(engine.stats), "completions": completions}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_variant(cfg).replace(dtype="float32", param_dtype="float32")
    cfg = cfg.replace(backend=args.backend)
    validate_args(args, cfg)  # before any device work
    device = get_device(args.device)
    disable_tf32()
    obs.configure(
        metrics=bool(args.metrics_out),
        trace=bool(args.trace_out),
        profile_dir=args.profile_dir,
        device=device,
    )
    # weights in the activation dtype once, not at every step
    params = cast_weights(init_lm(cfg, torch.Generator(device=device).manual_seed(args.seed)), cfg)
    if args.engine == "static":
        return run_static(args, cfg, params, device)
    return run_continuous(args, cfg, params)


if __name__ == "__main__":
    main()
