"""Serving entry point for the distilled server LM: the continuous-batching
engine (default) or the static-batch baseline, on the GPU.

    # continuous batching through the paged KV pool and the flash-decode
    # kernel, at full width (smollm-135m: 30 layers, d_model 576)
    python -m repro_torch.launch.serve --arch smollm-135m --engine continuous \\
        --kv-layout paged --requests 16 --prompt-len 128 --gen 64 --max-slots 8

    # a reduced model on the CPU (f32, 2 layers)
    python -m repro_torch.launch.serve --arch smollm-135m --reduced --device cpu \\
        --requests 6 --max-slots 3 --prompt-len 24 --gen 12

    # shared-prefix serving: half the prompts open with one common head; the
    # radix prefix cache splices its resident pages, and a drafter proposes
    # --spec-k tokens a round that the target verifies in one extend
    python -m repro_torch.launch.serve --arch smollm-135m --engine continuous \\
        --kv-layout paged --prefix-cache --spec-decode --hot-fraction 0.5

    # serving fleet: N engine replicas behind the least-loaded router (on
    # one card the replicas share the device)
    python -m repro_torch.launch.serve --arch smollm-135m --engine continuous \\
        --replicas 2 --requests 16 --prompt-len 128 --gen 64 --max-slots 8

    # static baseline: one batch, prefill then decode on the dense cache
    python -m repro_torch.launch.serve --reduced --device cpu --engine static \\
        --batch 3 --prompt-len 24 --gen 12

    # one engine over the 16x16 production mesh: 256 ranks under torchrun,
    # params and KV tensor-parallel over "model" (DTensors)
    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.serve --mesh production

    # a sharded fleet: 2 replicas over 4 ranks, each replica's prefill and
    # decode workers on one rank each behind the router every rank runs
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --replicas 2 --disagg

    # a VLM (phi-3-vision-4.2b) serves through the static path only, with
    # a seeded prefix of 576 patch embeddings before each prompt
    python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --engine static \
        --batch 8 --prompt-len 128 --gen 64

Weights are random, made from ``--seed`` (the drafter's from ``--seed``
+ 1: a different random model, so its drafts are rarely accepted; the
tokens are the target's either way), and so is a VLM's prefix
(``RandomState(seed).randn(B, P, frontend_dim) · 0.02``, as the reference
makes it). An encoder-only arch (hubert-xlarge) has nothing to decode and
is refused. ``--mesh host`` (the default) serves on one device without a
mesh; ``--mesh production`` runs one engine (or the static batch) sharded
over the 16x16 mesh of a 256-rank ``torchrun`` world and exits, before any
allocation, in any other world. A fleet (more than one effective replica,
or ``--disagg``; ``--mesh multipod`` doubles ``--replicas``, one replica
group a pod) takes no global mesh, as the reference's: in a world of
several ranks with several replicas, whatever ``--mesh`` names, each
replica shards its engine over its slice of
``make_fleet_mesh(replicas)`` (``--disagg`` halves each slice into its
prefill and decode workers' meshes) and every rank runs the router, which
shares the clock and the readbacks; in a world of one the replicas and
the pair colocate meshless on the device. ``--mesh multipod`` static
serving is refused, and so are ``--disagg`` with the dense layout or with
an arch without attention. Full width serves in the
config's bf16 activations with f32 params; ``--reduced`` runs the reduced
variant in f32, as the JAX launcher does. Runs on ``cuda`` unless
``--device cpu`` is given. Arguments are checked, and the engine and KV
pool configuration built on the host, before anything touches the device.

Telemetry (:mod:`repro_torch.obs`), off by default: ``--metrics-out``
routes every replica's and the router's stats into the shared registry and
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
from repro_torch.launch.mesh import (
    disagg_submeshes, init_distributed, launcher_mesh, make_fleet_mesh, replica_meshes, world_size,
)
from repro_torch.models.transformer import cast_weights, group_pattern, init_lm
from repro_torch.serve import (
    ContinuousScheduler,
    EngineConfig,
    FleetRouter,
    KVPool,
    Request,
    ServeEngine,
    hot_prefix_stream,
    latency_summary,
    static_generate,
)
from repro_torch.serve.engine import check_accelerations, engine_layout
from repro_torch.sharding.partition import shard_params
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
    # fleet topology (continuous arm)
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas behind the least-loaded router (on one device they share it)")
    p.add_argument("--mesh", default="host", choices=("host", "production", "multipod"),
                   help="host: one device, no mesh; production: one engine sharded over the 16x16 mesh of a "
                        "256-rank torchrun world")
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated prefill/decode: each replica's mesh slice split into a prefill half "
                        "and a decode half, sealed KV pages handed across (paged layout only; on one "
                        "device the pair colocates)")
    p.add_argument("--kv-layout", default="paged", choices=("paged", "dense"),
                   help="paged: KVPool + flash-decode; dense: per-slot rectangle + SDPA")
    p.add_argument("--page-size", type=int, default=16, help="tokens per KV page (power of two)")
    p.add_argument("--pool-pages", type=int, default=0, help="KV pool capacity in pages (0 = full per-slot capacity)")
    # prefix cache and speculative decoding (continuous arm)
    p.add_argument("--prefix-cache", action="store_true",
                   help="radix prefix cache over refcounted KV pages: hot admissions splice resident "
                        "prompt pages and prefill only the uncovered tail (paged layout only)")
    p.add_argument("--spec-decode", action="store_true",
                   help="speculative decoding: a drafter proposes --spec-k tokens a round, the target "
                        "verifies them in one batched forward (temperature 0 only)")
    p.add_argument("--drafter", default="smollm-135m",
                   help="registry arch drafting for --spec-decode (reduced alongside --reduced; must share "
                        "the target's vocabulary and be attention-only with a full cache)")
    p.add_argument("--spec-k", type=int, default=4, help="draft tokens per verify round for --spec-decode")
    p.add_argument("--hot-fraction", type=float, default=0.0,
                   help="fraction of requests sharing a hot prompt prefix (exercises --prefix-cache; "
                        "0 = fully cold traffic)")
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
        prefix_cache=args.prefix_cache,
        spec_k=args.spec_k if args.spec_decode else 0,
    )


def drafter_config(args):
    """The drafter's ModelConfig for --spec-decode: reduced alongside the
    target (a full-size drafter against a reduced target would be slower
    than what it accelerates)."""
    dcfg = get_arch(args.drafter)
    if args.reduced:
        dcfg = reduced_variant(dcfg).replace(dtype="float32", param_dtype="float32")
    return dcfg


def validate_args(args, cfg) -> None:
    """Fail fast, with a clear message, before any device allocation."""
    if cfg.is_encoder_only:
        raise SystemExit(
            f"{cfg.name} is encoder-only: no autoregressive decode, nothing to "
            "serve. Pick a decoder arch."
        )
    if args.mesh == "multipod" and args.engine == "static":
        raise SystemExit(
            "--mesh multipod is not supported for static serving: the fused "
            "static program is single-pod (the pod axis is data-parallel "
            "replication). Use --engine continuous, which runs one engine "
            "replica group per pod behind the fleet router."
        )
    if args.prompt_len < 1 or args.gen < 1:
        raise SystemExit(f"--prompt-len ({args.prompt_len}) and --gen ({args.gen}) must be >= 1")
    if args.profile and args.profile_dir:
        raise SystemExit("--profile and --profile-dir each run torch.profiler, and one process runs one: pick one")
    if args.replicas < 1:
        raise SystemExit(f"--replicas must be >= 1, got {args.replicas}")
    if (args.replicas > 1 or args.disagg) and args.engine != "continuous":
        raise SystemExit(
            "--replicas/--disagg describe the continuous serving fleet; the static "
            "baseline is a single fused program. Use --engine continuous."
        )
    if args.engine == "static":
        if args.batch < 1:
            raise SystemExit(f"--batch must be >= 1, got {args.batch}")
        return
    if cfg.frontend == "vision":
        raise SystemExit(
            f"{cfg.name} is a vlm: the continuous engine does not thread "
            "per-request vision prefix embeddings through admission yet — "
            "use --engine static (which feeds the prefix at prefill)."
        )
    for flag, value, low in (("--max-slots", args.max_slots, 1), ("--requests", args.requests, 1),
                             ("--decode-chunk", args.decode_chunk, 1), ("--pool-pages", args.pool_pages, 0)):
        if value < low:
            raise SystemExit(f"{flag} must be >= {low}, got {value}")
    if args.request_rate < 0:
        raise SystemExit(f"--request-rate must be >= 0, got {args.request_rate}")
    if args.disagg and args.kv_layout == "dense":
        raise SystemExit(
            "--disagg requires --kv-layout paged: the prefill->decode handoff moves sealed "
            "KV PAGES between worker pools, and the dense per-slot rectangle has no page "
            "units to hand off."
        )
    if args.prefix_cache and args.kv_layout == "dense":
        raise SystemExit(
            "--prefix-cache requires --kv-layout paged: prefix sharing IS page-table "
            "splicing — the dense per-slot rectangle has no page units to share."
        )
    if not 0.0 <= args.hot_fraction <= 1.0:
        raise SystemExit(f"--hot-fraction must be in [0, 1], got {args.hot_fraction}")
    if args.spec_decode:
        if args.spec_k < 1:
            raise SystemExit(f"--spec-k must be >= 1, got {args.spec_k}")
        if args.kv_layout != "paged":
            raise SystemExit(
                "--spec-decode requires --kv-layout paged: the batched verify is an "
                "extend over the page-table cache view."
            )
        if args.temperature > 0.0:
            raise SystemExit(
                "--spec-decode requires --temperature 0: the accept-longest-greedy-run "
                "verify is a greedy parity contract."
            )
    try:
        # the engine's own refusals (a recurrent arch has no attention KV to
        # splice or roll back), before the drafter's
        check_accelerations(cfg, continuous_engine_config(args))
    except ValueError as ex:
        raise SystemExit(str(ex))
    if args.spec_decode:
        try:
            dcfg = drafter_config(args)
        except (KeyError, NotImplementedError) as ex:
            raise SystemExit(f"--drafter: {ex.args[0]}")
        non_attn = sorted({m for m, _ in group_pattern(dcfg) if m != "attn"})
        if non_attn:
            raise SystemExit(
                f"--drafter {dcfg.name} has {non_attn} mixers: a recurrent carry cannot roll "
                "back past a rejected draft. Draft with an attention-only arch."
            )
        if dcfg.sliding_window > 0:
            raise SystemExit(
                f"--drafter {dcfg.name} uses a sliding window ({dcfg.sliding_window}): the "
                "ring cache cannot roll back rejected drafts (stale writes alias earlier "
                "positions). Draft with a full-attention arch."
            )
        if dcfg.vocab_size != cfg.vocab_size:
            raise SystemExit(
                f"--drafter {dcfg.name} vocab ({dcfg.vocab_size}) does not match "
                f"{cfg.name} ({cfg.vocab_size}): drafted token ids would be meaningless "
                "to the verifier."
            )
    try:
        ecfg = continuous_engine_config(args)
        if args.disagg and engine_layout(cfg, ecfg) != "paged":
            raise ValueError(
                f"{cfg.name} has no attention layers: its serving state degrades to the dense "
                "layout, which has no page units to hand off — --disagg needs an attention arch."
            )
        if engine_layout(cfg, ecfg) == "paged":  # an arch without attention runs dense
            KVPool(cfg, ecfg)
    except ValueError as ex:
        raise SystemExit(str(ex))


def run_static(args, cfg, params, device, mesh=None) -> dict:
    data = make_token_stream(args.seed, cfg.vocab_size, args.batch, args.prompt_len)
    batch = {"tokens": torch.as_tensor(data["tokens"][:, : args.prompt_len], device=device)}
    if cfg.family == "vlm":
        rng = np.random.RandomState(args.seed)
        prefix = rng.randn(args.batch, cfg.num_prefix_tokens, cfg.frontend_dim).astype(np.float32) * 0.02
        batch["prefix"] = torch.as_tensor(prefix, device=device)
    gen = torch.Generator(device=device)
    run = lambda: static_generate(
        params, cfg, batch, args.gen, temperature=args.temperature, generator=gen.manual_seed(args.seed),
        mesh=mesh,
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


def effective_replicas(args) -> int:
    """``--mesh multipod`` serves one fleet a pod: a decode engine is a
    single-pod program (the pod axis is the slow boundary), so each of the
    two pods carries its own replica group behind the shared router."""
    return args.replicas * (2 if args.mesh == "multipod" else 1)


def is_fleet(args) -> bool:
    """A continuous run with several effective replicas or ``--disagg``:
    the replicas place themselves, with no global mesh."""
    return args.engine == "continuous" and (effective_replicas(args) > 1 or args.disagg)


def build_fleet(args, cfg, params, mesh=None) -> list:
    """The engine replicas, ids 0..N-1 (N = :func:`effective_replicas`).
    In a world of several ranks with several replicas each replica shards
    over its slice of ``make_fleet_mesh(N)`` (the world's ranks split
    ``replicas × (data=1) × model``), and ``--disagg`` halves each slice
    into its prefill and decode workers' meshes (``disagg_submeshes``; a
    one-rank slice colocates); otherwise every replica sits on ``mesh``
    (None: the parameters' device; on one device the replicas colocate,
    with their own pools and slots, as the reference's do). One drafter
    (``--spec-decode``) serves every replica; with ``--metrics-out`` every
    replica's stats land in the process-global registry under its replica
    label, without it each engine keeps its private always-on registry."""
    replicas = effective_replicas(args)
    ecfg = continuous_engine_config(args)
    drafter = None
    if args.spec_decode:
        dcfg = drafter_config(args).replace(backend=cfg.backend)
        device = params["embed"]["table"].device
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        drafter = (dcfg, cast_weights(init_lm(dcfg, gen), dcfg))
    registry = obs.registry() if args.metrics_out else None
    if world_size() > 1 and replicas > 1:
        device_type = params["embed"]["table"].device.type
        subs = replica_meshes(make_fleet_mesh(replicas, device_type=device_type))
    else:
        subs = [mesh] * replicas
    engines = []
    for i, sub in enumerate(subs):
        pmesh, dmesh = disagg_submeshes(sub) if args.disagg and sub is not None else (sub, sub)
        engines.append(ServeEngine(cfg, params, ecfg, mesh=dmesh, prefill_mesh=pmesh, drafter=drafter,
                                   registry=registry, replica=i))
    return engines


def run_continuous(args, cfg, params, mesh=None) -> dict:
    dt = 1.0 / args.request_rate if args.request_rate > 0 else 0.0
    if args.hot_fraction > 0:
        # every request asks for --gen tokens, so the stream's budgets go
        # unused; they are drawn after the prompts, so budget_min=1 (valid
        # for any --gen) leaves the prompts the reference's
        prompts, _ = hot_prefix_stream(
            cfg.vocab_size, args.requests, args.prompt_len, args.gen, seed=args.seed,
            budget_min=1, shared_fraction=args.hot_fraction,
        )
    else:
        data = make_token_stream(args.seed, cfg.vocab_size, args.requests, args.prompt_len)
        prompts = [data["tokens"][i, : args.prompt_len].astype(np.int32) for i in range(args.requests)]
    requests = [Request(rid=i, tokens=p, max_new_tokens=args.gen, arrival=i * dt) for i, p in enumerate(prompts)]
    engines = build_fleet(args, cfg, params, mesh)
    sched = ContinuousScheduler(engines[0]) if len(engines) == 1 else FleetRouter(engines)
    # every admission size and the decode chunk run once on every replica
    # before timing
    for eng in engines:
        eng.warmup(requests[0].tokens, min(2, args.gen))
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
        "fleet[%d%s]: %d reqs, %d tokens in %.3fs (%.1f tok/s) "
        "p50=%.3fs p95=%.3fs queue-wait p50=%.3fs p95=%.3fs",
        len(engines), "+disagg" if args.disagg else "", len(completions), int(s["tokens"]), wall, s["tok_per_s"],
        s["p50_s"], s["p95_s"], s["queue_wait_p50_s"], s["queue_wait_p95_s"],
    )
    for i, eng in enumerate(engines):
        st = eng.stats
        log.info(
            "replica %d: %d reqs, %d decode chunks, %d host syncs, %d prefills, %d handoffs",
            i, sum(1 for c in completions if c.replica == i), st["decode_chunks"], st["host_syncs"],
            st["prefill_dispatches"], st["handoffs"],
        )
        if eng.pool is not None:
            log.info(
                "replica %d kv pool: %d pages x %d tokens (%s layout), %d decode-time appends",
                i, eng.pool.n_pages, eng.pool.page_size, eng.layout, st["page_appends"],
            )
        if args.prefix_cache:
            admitted = max(st["admitted"], 1)
            log.info(
                "replica %d prefix cache: %d/%d admissions spliced (hit rate %.0f%%), %d pages reused, %d CoW copies",
                i, st["spliced_admissions"], st["admitted"], 100.0 * st["spliced_admissions"] / admitted,
                st["spliced_pages"], st["cow_copies"],
            )
        if args.spec_decode:
            proposed = max(st["draft_proposed"], 1)
            log.info(
                "replica %d spec decode: %d verify steps, %d/%d drafts accepted (%.0f%%)",
                i, st["spec_steps"], st["draft_accepted"], st["draft_proposed"],
                100.0 * st["draft_accepted"] / proposed,
            )
    if len(engines) > 1:
        log.info(
            "router: %d routed, %d requeued-on-defer, %d prefix-affinity hits",
            sched.stats["routed"], sched.stats["requeued"], sched.stats["affinity_hits"],
        )
    log.info("sample continuation (rid 0): %s", completions[0].tokens[:16].tolist())
    _finalize_telemetry(args, engines)
    replicas = [dict(eng.stats) for eng in engines]
    # the fleet's totals, key for key (one replica: its own stats)
    stats = {k: sum(r[k] for r in replicas) for k in replicas[0]}
    drafter_prefills = sum(eng.spec.prefill_dispatches for eng in engines if eng.spec is not None)
    return {**s, "wall_s": wall, "device_busy_s": busy, "stats": stats, "completions": completions,
            "drafter_prefills": drafter_prefills, "replicas": replicas, "router": dict(sched.stats)}


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
    if is_fleet(args):
        # no global mesh: each replica shards against its own slice of the
        # world (build_fleet), which needs the process group under torchrun
        if world_size() > 1:
            init_distributed(device)
        mesh = None
    else:
        mesh = launcher_mesh(args.mesh, device)  # None for host; exits on a wrong world first
    # weights in the activation dtype once, not at every step
    params = cast_weights(init_lm(cfg, torch.Generator(device=device).manual_seed(args.seed)), cfg)
    if args.engine == "static":
        if mesh is not None:
            params = shard_params(params, mesh)
        return run_static(args, cfg, params, device, mesh)
    return run_continuous(args, cfg, params, mesh)


if __name__ == "__main__":
    main()
