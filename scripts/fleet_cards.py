#!/usr/bin/env python3
"""The sharded fleet and the client bank's client axis across cards, one
process a card under ``torchrun`` (NCCL; gloo with ``--device cpu``):

    torchrun --nnodes 1 --nproc-per-node 4 --master-addr localhost --master-port 29517 \\
        scripts/fleet_cards.py                    # four cards
    torchrun ... scripts/fleet_cards.py --device cpu   # a dry run on CPU ranks, at a small size

* Serving, smollm-135m at full width (reduced with ``--device cpu``),
  embedding x10, 8 requests x (128 + 16), in f32 and in bf16, through
  ``launch.serve``'s ``build_fleet`` and ``run_continuous``: the single
  meshless engine (every rank its own), then ``--replicas 2 --disagg``,
  ``--mesh multipod --replicas 1`` and ``--replicas 4`` over the world.
  Printed by rank 0: the replicas, the requests and positions whose tokens
  equal the single engine's, whether every rank returned the same tokens,
  tok/s, each replica's admissions, prefills and handoffs, the router's
  stats.
* Co-Boosting on phase 4's market of ``chip_smoke.py`` (K=4, whose clients
  split over ``data`` 2, and K=5, which stays whole), 2 epochs on cuDNN's
  deterministic algorithms, meshless, under the (data 2, model W/2) mesh,
  meshless again: s/epoch of the sharded and of the second meshless run,
  the largest gaps of ``w``, server and generator to the first meshless
  run (and the two meshless runs' own), #1–#4's launches and the
  ``local_map`` calls, and whether every rank holds the same bits. For
  K=4 also the split's gaps after one generator step and after one epoch,
  and two meshless witnesses of the same size: the client forward in two
  vmapped halves (``ensemble_scan_chunk=2``, the input gradient summed in
  the split's order), and one generator parameter moved by one ulp.
* One tick of the f32 ``--replicas 4`` fleet taken apart on rank 0: host
  seconds a tick in the decode chunks (the DTensor dispatch), in the
  shared clock, in the shared heads (waiting for the chunk, the
  all-reduce, the host copy) and in the finished rows; then the shared
  heads alone on idle replicas (the collective and the copy).

Nothing is gated: the printed lines are the record.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.config.model import reduced_variant  # noqa: E402
from repro_torch.config.registry import get_arch  # noqa: E402
from repro_torch.launch import ofl, serve  # noqa: E402
from repro_torch.launch.mesh import init_distributed  # noqa: E402
from repro_torch.models.transformer import cast_weights, init_lm  # noqa: E402
from repro_torch.utils.device import disable_tf32  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402

FLEETS = (["--replicas", "2", "--disagg"], ["--mesh", "multipod", "--replicas", "1"], ["--replicas", "4"])
LOSS_KERNELS = ("ensemble_kl_fwd", "ensemble_kl_bwd", "ghm_ce_fwd", "ghm_ce_bwd")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    dev_name = p.parse_args().device
    init_distributed(dev_name)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(dev_name)
    on_card = dev.type == "cuda"
    if not on_card:
        torch.set_num_threads(1)
    disable_tf32()
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    def agree(obj) -> bool:
        got = [None] * world
        dist.all_gather_object(got, obj)
        return all(g == got[0] for g in got)

    say(f"device {torch.cuda.get_device_name(0) if on_card else 'cpu'}, world {world}, torch {torch.__version__}")

    def served(flags, cfg, params):
        args = serve.build_parser().parse_args(
            ["--arch", "smollm-135m", "--requests", "8", "--prompt-len", "128", "--gen", "16", "--max-slots", "4",
             "--page-size", "16", "--device", dev_name, *flags])
        out = serve.run_continuous(args, cfg, params)
        sync()
        return {c.rid: c.tokens.tolist() for c in out["completions"]}, out

    def tick_split(cfg, params):
        """Host seconds a tick of the ``--replicas 4`` fleet, by where they
        go, and the shared heads alone on idle replicas."""
        from repro_torch.serve.engine import ServeEngine
        from repro_torch.serve.scheduler import FleetRouter, SharedHost

        spent, calls, inside, fleets, saved = collections.defaultdict(float), collections.Counter(), [False], [], {}

        def timed(cls, name):
            f = saved[cls, name] = getattr(cls, name)

            def g(self, *a, **k):
                if not inside[0]:
                    return f(self, *a, **k)
                t0 = time.perf_counter()
                out = f(self, *a, **k)
                spent[name] += time.perf_counter() - t0
                calls[name] += 1
                return out
            setattr(cls, name, g)

        def run(self, requests):
            inside[0] = True
            try:
                return saved[FleetRouter, "run"](self, requests)
            finally:
                inside[0] = False
                fleets.append(self.engines)

        for cls, name in ((ServeEngine, "decode_chunk"), (SharedHost, "now"), (SharedHost, "heads"),
                          (SharedHost, "hold_rows")):
            timed(cls, name)
        saved[FleetRouter, "run"] = FleetRouter.run
        FleetRouter.run = run
        try:
            _, out = served(["--replicas", "4"], cfg, params)
        finally:
            for (cls, name), f in saved.items():
                setattr(cls, name, f)
        ticks = calls["heads"]
        host = SharedHost(fleets[-1])
        live = list(range(len(host.workers)))
        sync()
        t0 = time.perf_counter()
        for _ in range(50):
            host.heads(live)
        idle = (time.perf_counter() - t0) / 50
        per_tick = {k: round(v / ticks * 1e3, 3) for k, v in spent.items()}
        say(f"float32 --replicas 4, one tick taken apart on rank 0: {ticks} ticks in {out['wall_s']:.3f} s "
            f"({out['wall_s'] / ticks * 1e3:.3f} ms a tick); host ms a tick {json.dumps(per_tick)} (decode_chunk "
            f"summed over the 4 replicas, 1 of them on this rank); shared heads on idle replicas "
            f"{idle * 1e3:.3f} ms")

    for dtype in ("float32", "bfloat16"):
        cfg = get_arch("smollm-135m").replace(dtype=dtype)
        if not on_card:
            cfg = reduced_variant(cfg).replace(dtype=dtype)
        params = init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
        params["embed"]["table"] *= 10.0
        params = cast_weights(params, cfg)
        single, _ = served([], cfg, params)
        for flags in FLEETS:
            toks, out = served(flags, cfg, params)
            same = sum(int(toks[r] == single[r]) for r in single)
            pos = sum(int(a == b) for r in single for a, b in zip(toks[r], single[r]))
            say(f"{dtype} {' '.join(flags)}: {len(out['replicas'])} replicas; requests equal to the single meshless "
                f"engine {same}/{len(single)}, positions {pos}/{sum(map(len, single.values()))}; every rank the "
                f"same {agree(toks)}; tok/s {out['tok_per_s']:.1f}; per replica (admitted, prefills, handoffs) "
                f"{[(r['admitted'], r['prefill_dispatches'], r['handoffs']) for r in out['replicas']]}; router "
                f"{json.dumps(out['router'])}")
        if dtype == "float32":
            tick_split(cfg, params)
        del params
        if on_card:
            torch.cuda.empty_cache()

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.coboosting import default_image_setup, run_coboosting
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.dispatch import LOCAL_MAP_CALLS, reset_local_map_calls
    from repro_torch.models.cnn import cnn_apply, init_cnn
    from repro_torch.sharding import mesh_context
    from repro_torch.utils.prng import Draws

    grid = DeviceMesh(dev.type, torch.arange(world).reshape(2, world // 2), mesh_dim_names=("data", "model"))
    # deterministic before the market too: every rank trains the same clients
    torch.backends.cudnn.deterministic = True
    size = (["--image", "32", "--batch", "128", "--gen-iters", "30", "--per-class", "500"] if on_card
            else ["--image", "8", "--batch", "16", "--gen-iters", "2", "--per-class", "20"])
    gap = lambda a, b: max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    bits = lambda st: [t.cpu().numpy().tobytes() for t in [st.weights, *tree_leaves(st.server_params),
                                                             *tree_leaves(st.gen_params)]]
    for clients in ("4", "5"):
        args = ofl.parse_args(["--clients", clients, "--classes", "10", *size, "--epochs", "2", "--local-epochs",
                               "2", "--server-arch", "cnn5", "--device", dev_name])
        run = ofl.prepare_run(args, dev)

        def coboost(mesh, nudge=False, **knobs):
            cfg = dataclasses.replace(run.cfg, **knobs)
            g = torch.Generator(device=dev).manual_seed(args.seed + 77)
            server = init_cnn(g, "cnn5", args.classes, run.image_shape)
            g.manual_seed(args.seed + 5)
            gen_apply, gen = default_image_setup(g, cfg, args.classes, run.image_shape)
            if nudge:  # one generator parameter one ulp up
                leaf = tree_leaves(gen)[0].view(-1)
                leaf[0] = torch.nextafter(leaf[0], torch.tensor(float("inf"), device=dev))
            reset_launch_counts()
            reset_local_map_calls()
            sync()
            t0 = time.perf_counter()
            with mesh_context(mesh):
                st = run_coboosting(run.applies, run.params, partial(cnn_apply, "cnn5"), server, gen_apply, gen,
                                    cfg, args.classes, Draws(args.seed, dev))
            sync()
            return st, (time.perf_counter() - t0) / cfg.epochs, dict(launch_counts()), dict(LOCAL_MAP_CALLS)

        gaps = lambda a, b: (f"w {float((a.weights - b.weights).abs().max()):.3e}, server "
                             f"{gap(a.server_params, b.server_params):.3e}, generator "
                             f"{gap(a.gen_params, b.gen_params):.3e}")

        plain, _, plain_counts, _ = coboost(None)
        sharded, sharded_s, counts, route = coboost(grid)
        again, plain_s, _, _ = coboost(None)
        say(f"Co-Boosting K={clients} on the {tuple(grid.mesh.shape)} mesh, 2 epochs, cuDNN deterministic: s/epoch "
            f"{sharded_s:.4f} (meshless {plain_s:.4f}); gaps to meshless w "
            f"{float((sharded.weights - plain.weights).abs().max()):.3e}, server "
            f"{gap(sharded.server_params, plain.server_params):.3e}, generator "
            f"{gap(sharded.gen_params, plain.gen_params):.3e} (meshless run to run: server "
            f"{gap(again.server_params, plain.server_params):.3e}); launches "
            f"{json.dumps({k: counts[k] for k in LOSS_KERNELS})} (meshless "
            f"{json.dumps({k: plain_counts[k] for k in LOSS_KERNELS})}); local_map "
            f"{json.dumps({k: route[k] for k in ('client_bank', 'ensemble_kl', 'ghm_ce')})}; every rank the same "
            f"bits {agree(bits(sharded))}")
        if clients != "4":
            continue
        for knobs in ({"epochs": 1, "gen_iters": 1}, {"epochs": 1}, {}):
            base = coboost(None, **knobs)[0] if knobs else plain
            split = coboost(grid, **knobs)[0] if knobs else sharded
            halves = coboost(None, ensemble_scan_chunk=2, **knobs)[0]
            ulp = coboost(None, nudge=True, **knobs)[0]
            say(f"Co-Boosting K=4 {json.dumps(knobs or {'epochs': 2})}, gaps to meshless: split over data 2 "
                f"{gaps(split, base)}; witness, the client forward in two halves {gaps(halves, base)}; witness, "
                f"one generator parameter one ulp up {gaps(ulp, base)}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
