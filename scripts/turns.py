#!/usr/bin/env python3
"""Two trees of the port on one card, in turns: the kernels that a change
redesigned, Co-Boosting, LM training and serving.

    python3 scripts/turns.py PARENT_DIR [--order parent,change,change,parent]
                             [--parts losses,kernels,ofl,baselines,train,serve] [--serve-runs N] [--epochs N]
                             [--out DIR]

``PARENT_DIR`` is an unpacked checkout of the commit to compare with
(``git archive <commit> | tar -x -C PARENT_DIR``); "change" is the checkout
this script lies in. Each turn runs in a fresh process on one tree, which
builds that tree's kernels into its own ``build/`` and then measures:

* the four loss kernels, the forwards (``ensemble_kl_fwd`` at T=4,
  ``ghm_ce_fwd`` weighted) and the backwards (``ensemble_kl_bwd`` and
  ``ghm_ce_bwd``) in the generator's mode (g_client and g_student;
  g_client), per wrapper call and on the device alone, at the Co-Boosting
  shape (K=5, B=128, V=10, f32) and at a wide vocabulary (K=5, B=37,
  V=32003, f32), on the device also in bf16 there, and the forwards on the
  device at 20 clients on 100 classes (K=20, B=256, V=100, f32); a tree
  whose backward wrappers take no ``needs`` computes every cotangent;
* in bf16 at the LM paths' shapes, the dq pass (``flash_attention_bwd_dq``) at the LM training shape (8 ×
  256 tokens, 9 heads over 3 kv heads, hd 64, causal) and paged decode
  (``flash_decode``) at the serving decode shape (8 slots at position 160,
  16-token pages, 12 table entries): per wrapper call (CUDA events around
  back-to-back calls) and on the device alone (CUDA-graph replay), with
  SDPA's backward on the same inputs beside the dq pass;
* Co-Boosting at the paper's image width (5 cnn5 clients, a cnn5 server,
  32x32x3, 10 classes, batch 128, 30 generator steps; the market of
  ``launch.ofl``'s options below): one epoch to warm up, then ``--epochs``
  epochs timed (s/epoch, host clock after a synchronise), then as many
  under ``torch.profiler``: the device's busy share and the kernels by
  device time;
* the distilling Table 1 baselines (DENSE, F-DAFL, F-ADI, FedDF; trees
  that have ``repro_torch.core.baselines``) on the same market, each like
  Co-Boosting: one epoch to warm up, ``--epochs`` timed, as many profiled;
* ``repro_torch.launch.train`` at full width (batch 8, seq 256, 30 steps,
  AdamW): tok/s after the first step, s/step, the loss;
* ``repro_torch.launch.serve`` at full width (16 requests, prompt 128, 64
  new tokens, 8 slots): tok/s, p50 and p95 latency;
* each of the two again under ``torch.profiler`` (12 training steps, the
  same request stream): device busy seconds, wall seconds and the kernels
  by device time (in the turn's log).

``--parts`` picks which of these a turn measures; ``--serve-runs``
repeats the unprofiled serving run within each turn. Each turn prints one
JSON line; the last lines are the card's name and power limit and a table
of every turn. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
TRAIN_ARGV = ["--arch", "smollm-135m", "--batch", "8", "--seq", "256", "--optimizer", "adamw", "--device", "cuda"]
OFL_ARGV = ["--method", "coboosting", "--clients", "5", "--classes", "10", "--image", "32", "--batch", "128",
            "--gen-iters", "30", "--local-epochs", "2", "--per-class", "500", "--server-arch", "cnn5",
            "--device", "cuda"]
SERVE_ARGV = ["--arch", "smollm-135m", "--engine", "continuous", "--kv-layout", "paged", "--requests", "16",
              "--prompt-len", "128", "--gen", "64", "--max-slots", "8", "--page-size", "16", "--device", "cuda"]


def one_turn(tree: Path, parts, serve_runs: int, epochs: int) -> dict:
    """Measure one tree in this process (its package first on the path)."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))  # chip_smoke.py's timing helpers and cases
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.build import build_cuda_libraries
    from repro_torch.kernels.ensemble_kl import kernel as kl_kernel
    from repro_torch.kernels.flash_attention.kernel import BWD_SOURCE, SM90_SOURCE, SOURCE
    from repro_torch.kernels.flash_decode.kernel import SOURCE as FD_SOURCE
    from repro_torch.kernels.ghm_ce import kernel as ce_kernel
    from repro_torch.launch import serve, train
    from repro_torch.utils.device import disable_tf32

    disable_tf32()
    t0 = time.perf_counter()
    # each tree's loss kernels that are CUDA C++ (older trees: fewer or none)
    loss_sources = [getattr(m, n) for m in (kl_kernel, ce_kernel) for n in ("FWD_SOURCE", "BWD_SOURCE") if hasattr(m, n)]
    build_cuda_libraries([SOURCE, BWD_SOURCE, SM90_SOURCE, FD_SOURCE, *loss_sources])
    res = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda")
    if "losses" in parts:
        res.update(time_losses(cs, dev))
    if "ofl" in parts:
        res["ofl"] = time_ofl(epochs)
    if "baselines" in parts:
        res["baselines"] = time_baselines(epochs)
    if "kernels" in parts:
        res.update(time_kernels(cs, dev))
    if "train" in parts:
        r = train.main(TRAIN_ARGV + ["--steps", "30"])
        res["train"] = {n: r[n] for n in ("tok_per_s", "s_per_step", "first10", "last10", "max_memory_bytes")}
        r = train.main(TRAIN_ARGV + ["--steps", "12", "--profile"])
        res["train_profile"] = {"device_busy_s": r["device_busy_s"], "steps": 11,
                                "device_ms_per_step": r["device_busy_s"] * 1e3 / 11}
    if "serve" in parts:
        runs = [serve.main(SERVE_ARGV) for _ in range(serve_runs)]
        res["serve"] = {n: [r[n] for r in runs] for n in ("tok_per_s", "p50_s", "p95_s", "wall_s")}
        r = serve.main(SERVE_ARGV + ["--profile"])
        res["serve_profile"] = {"device_busy_s": r["device_busy_s"], "wall_s": r["wall_s"],
                                "idle_share": 1 - r["device_busy_s"] / r["wall_s"]}
    return res


def time_losses(cs, dev) -> dict:
    """The loss forwards, and the backwards in the generator's mode, per
    call and on the device alone."""
    import inspect

    import torch

    from repro_torch.kernels.ensemble_kl.kernel import ensemble_kl_bwd, ensemble_kl_fwd
    from repro_torch.kernels.ensemble_kl.ref import ensemble_kl_fwd_ref
    from repro_torch.kernels.ghm_ce.kernel import ghm_ce_bwd, ghm_ce_fwd
    from repro_torch.kernels.ghm_ce.ref import ghm_ce_fwd_ref

    # older trees compute every cotangent and take no flags
    kl_kw = {"needs": (True, True, False)} if "needs" in inspect.signature(ensemble_kl_bwd).parameters else {}
    ce_kw = {"needs": (True, False)} if "needs" in inspect.signature(ghm_ce_bwd).parameters else {}
    res = {}
    for tag, shape, dtype, per_call in (("main", cs.MAIN, torch.float32, True), ("wide", cs.WIDE, torch.float32, True),
                                        ("wide_bf16", cs.WIDE, torch.bfloat16, False),
                                        ("c20", cs.CLIENTS20, torch.float32, False)):
        cl, st, w, labels, ct = cs._case(shape["k"], shape["b"], shape["v"], dtype, seed=0, device=dev)
        out, lse_t, lse_s = ensemble_kl_fwd_ref(cl, st, w, 4.0)
        _, lse, ly = ghm_ce_fwd_ref(cl, labels, w, True)
        calls = {"ensemble_kl_fwd": lambda: ensemble_kl_fwd(cl, st, w, 4.0),
                 "ghm_ce_fwd": lambda: ghm_ce_fwd(cl, labels, w, True)}
        if tag != "c20":
            calls["ensemble_kl_bwd"] = lambda: ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, 4.0, **kl_kw)
            calls["ghm_ce_bwd"] = lambda: ghm_ce_bwd(cl, labels, w, ct, lse, ly, True, True, **ce_kw)
        for name, fn in calls.items():
            res[f"{name}_{tag}"] = {"ms": cs._time_ms(fn) if per_call else None, "device_ms": cs._graph_ms(fn)}
    print(f"losses: {json.dumps(res)}", flush=True)
    return res


def _profiled(run, epochs: int) -> dict:
    """``run(epochs)`` under ``torch.profiler`` (device activity only): the
    wall time, the device's busy share, the loss kernels and the kernels by
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = run(epochs)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    # the loss kernels by name (older trees: also the bodies ``_fwd_body``, ``_bwd_body``, ``_gw_reduce_body``)
    loss = [e for e in events if any(n in e.key for n in ("ensemble_kl", "ghm_ce", "_fwd_body", "_bwd_body",
                                                            "_gw_reduce_body"))]
    return {"loss_kernels": {"device_ms": sum(e.self_device_time_total for e in loss) / 1e3,
                             "calls": sum(e.count for e in loss)},
            "profiled_wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "top_kernels": [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
                            for e in top]}


def time_baselines(epochs: int) -> dict:
    """The distilling Table 1 baselines on ``time_ofl``'s market, each from
    a fresh server (and generator): one epoch to warm up, then ``epochs``
    timed (s/epoch, host clock after a synchronise), then as many under
    ``torch.profiler``."""
    import dataclasses
    from functools import partial

    import torch

    from repro_torch.core.baselines import run_adi_baseline, run_feddf, run_generator_baseline
    from repro_torch.core.coboosting import default_image_setup
    from repro_torch.launch import ofl
    from repro_torch.models.cnn import cnn_apply, init_cnn
    from repro_torch.utils.prng import Draws

    args = ofl.parse_args(OFL_ARGV)
    dev = torch.device("cuda")
    mk = ofl.prepare_run(args, dev)
    server_apply = partial(cnn_apply, args.server_arch)
    init = torch.Generator(device=dev)
    res = {}
    for method in ("dense", "f_dafl", "f_adi", "feddf"):

        def run(n):
            c = dataclasses.replace(mk.cfg, epochs=n)
            init.manual_seed(args.seed + 77)
            server = init_cnn(init, args.server_arch, args.classes, mk.image_shape)
            init.manual_seed(args.seed + 5)
            gen_apply, gen = default_image_setup(init, c, args.classes, mk.image_shape)
            draws = Draws(args.seed, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if method == "feddf":
                run_feddf(mk.applies, mk.params, server_apply, server, mk.train_x, c, draws)
            elif method == "f_adi":
                run_adi_baseline(mk.applies, mk.params, server_apply, server, mk.image_shape, c, args.classes, draws)
            else:
                run_generator_baseline(method, mk.applies, mk.params, server_apply, server, gen_apply, gen, c,
                                       args.classes, draws)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run(1)
        res[method] = {"epochs": epochs, "s_per_epoch": run(epochs) / epochs, **_profiled(run, epochs)}
        print(f"{method}: {json.dumps(res[method])}", flush=True)
    return res


def time_ofl(epochs: int) -> dict:
    """Co-Boosting at the paper's image width: s/epoch, then the same number
    of epochs under ``torch.profiler`` (device activity only)."""
    import dataclasses
    from functools import partial

    import torch

    from repro_torch.config.train import OFLConfig
    from repro_torch.core.coboosting import default_image_setup, run_coboosting
    from repro_torch.data.synthetic import make_synth_images
    from repro_torch.fed.market import build_market
    from repro_torch.launch import ofl
    from repro_torch.models.cnn import cnn_apply, init_cnn
    from repro_torch.utils.prng import Draws

    args = ofl.parse_args(OFL_ARGV)
    dev = torch.device("cuda")
    shape = (args.image, args.image, 3)
    cfg = OFLConfig(num_clients=args.clients, local_epochs=args.local_epochs, gen_iters=args.gen_iters,
                    batch_size=args.batch, latent_dim=32, buffer_batches=4, seed=args.seed)
    x, y = make_synth_images(args.seed, args.classes, args.per_class, shape)
    applies, params, _, _ = build_market(args.seed, x, y, cfg, args.classes, None, device=dev)
    init = torch.Generator(device=dev)
    init.manual_seed(args.seed + 77)
    server = init_cnn(init, args.server_arch, args.classes, shape)
    init.manual_seed(args.seed + 5)
    gen_apply, gen = default_image_setup(init, cfg, args.classes, shape)

    def run(n):
        c = dataclasses.replace(cfg, epochs=n)
        t0 = time.perf_counter()
        run_coboosting(applies, params, partial(cnn_apply, args.server_arch), server, gen_apply, gen, c,
                       args.classes, Draws(args.seed, dev))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(1)  # builds the kernels
    res = {"epochs": epochs, "s_per_epoch": run(epochs) / epochs, **_profiled(run, epochs)}
    print(f"ofl: {json.dumps(res)}", flush=True)
    return res


def time_kernels(cs, dev) -> dict:
    """The dq pass and paged decode, per call and on the device alone."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_dq
    from repro_torch.kernels.flash_attention.ref import attention_delta, flash_attention_ref_lse
    from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd

    q, k, v = cs._attn_case(8, 256, 256, 9, 3, 64, torch.bfloat16, seed=20, device=dev)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(30)).to(torch.bfloat16).to(dev)
    out, lse = flash_attention_ref_lse(q, k, v, causal=True)
    args = (q, k, v, dout, lse, attention_delta(out, dout))
    dq = lambda: flash_attention_bwd_dq(*args, causal=True)
    both, fwd = cs._sdpa_bwd(q, k, v, dout)
    res = {}
    res["dq"] = {"ms": cs._time_ms(dq, iters=50), "device_ms": cs._graph_ms(dq),
                 "sdpa_bwd_ms": cs._time_ms(both, iters=50) - cs._time_ms(fwd, iters=50),
                 "sdpa_bwd_device_ms": cs._graph_ms(both) - cs._graph_ms(fwd)}

    mid = 128 + 64 // 2
    qd, kp, vp, table, pos, kw, _ = cs._decode_case(8, 9, 3, 64, 16, 12, 0, [mid] * 8, torch.bfloat16, seed=10,
                                                    device=dev)
    dec = lambda: flash_decode_fwd(qd, kp, vp, table, pos, **kw)
    res["decode"] = {"ms": cs._time_ms(dec), "device_ms": cs._graph_ms(dec)}
    print(f"kernels: {json.dumps(res)}", flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", help="unpacked checkout of the commit to compare with")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--parts", default="losses,kernels,ofl,train,serve", help="any of losses,kernels,ofl,baselines,"
                    "train,serve")
    ap.add_argument("--serve-runs", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=3, help="Co-Boosting epochs timed, and as many profiled")
    ap.add_argument("--out", default=str(HERE / "build" / "turns"), help="directory for each turn's log")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # internal: measure this tree in this process
    args = ap.parse_args()
    if args.one:
        print("TURN " + json.dumps(one_turn(Path(args.one).resolve(), args.parts.split(","), args.serve_runs,
                                            args.epochs)), flush=True)
        return

    import torch

    if not torch.cuda.is_available() or args.parent is None:
        sys.exit("needs a CUDA card and the parent's checkout")
    trees = {"parent": Path(args.parent).resolve(), "change": HERE}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    turns = []
    for i, name in enumerate(args.order.split(",")):
        log = out / f"{i}-{name}.log"
        with open(log, "w") as f:
            proc = subprocess.run([sys.executable, __file__, "--one", str(trees[name]), "--parts", args.parts,
                                   "--serve-runs", str(args.serve_runs), "--epochs", str(args.epochs)], stdout=f,
                                  stderr=subprocess.STDOUT, timeout=1200)
        lines = [ln for ln in log.read_text().splitlines() if ln.startswith("TURN ")]
        if proc.returncode != 0 or not lines:
            sys.exit(f"turn {i} ({name}) failed with code {proc.returncode}; see {log}")
        res = json.loads(lines[-1][5:])
        res["turn"], res["name"] = i, name
        print(json.dumps(res), flush=True)
        turns.append(res)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    for t in turns:
        cols = [f"{t['turn']} {t['name']:6s}"]
        for n in ("ensemble_kl_fwd", "ensemble_kl_bwd", "ghm_ce_fwd", "ghm_ce_bwd"):
            if f"{n}_main" in t:
                c20 = f", K=20 {t[n + '_c20']['device_ms']:.4f}" if f"{n}_c20" in t else ""
                cols.append(f"{n} {t[n + '_main']['ms']:.4f} ms (device {t[n + '_main']['device_ms']:.4f}; wide "
                            f"f32 {t[n + '_wide']['device_ms']:.4f}, bf16 {t[n + '_wide_bf16']['device_ms']:.4f}{c20})")
        if "ofl" in t:
            cols.append(f"ofl {t['ofl']['s_per_epoch']:.4f} s/epoch, idle {t['ofl']['idle_share']:.3f}, loss "
                        f"kernels {t['ofl']['loss_kernels']['device_ms']:.2f} device ms")
        for m, b in t.get("baselines", {}).items():
            cols.append(f"{m} {b['s_per_epoch']:.4f} s/epoch, idle {b['idle_share']:.3f}, loss kernels "
                        f"{b['loss_kernels']['device_ms']:.2f} device ms")
        if "dq" in t:
            cols.append(f"dq {t['dq']['ms']:.4f} ms (device {t['dq']['device_ms']:.4f}; SDPA bwd "
                        f"{t['dq']['sdpa_bwd_ms']:.4f}, device {t['dq']['sdpa_bwd_device_ms']:.4f})")
            cols.append(f"decode {t['decode']['ms']:.4f} ms (device {t['decode']['device_ms']:.4f})")
        if "train" in t:
            cols.append(f"train {t['train']['tok_per_s']:.1f} tok/s, "
                        f"{t['train_profile']['device_ms_per_step']:.2f} device ms/step")
        if "serve" in t:
            cols.append("serve " + ", ".join(f"{x:.1f}" for x in t["serve"]["tok_per_s"]) + " tok/s, p50 "
                        + ", ".join(f"{x:.3f}" for x in t["serve"]["p50_s"]) + f" s, idle "
                        f"{t['serve_profile']['idle_share']:.3f}")
        print(" | ".join(cols))

if __name__ == "__main__":
    main()
