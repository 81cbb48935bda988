"""One-shot federated learning pipeline entry point — the paper end to end, on
the GPU.

    python -m repro_torch.launch.ofl --method coboosting \\
        --clients 5 --alpha 0.1 --epochs 40

Builds the model market (synthetic images, Dirichlet/C_cls/lognormal
partition, SGD-m local training), then runs the chosen server-side method
(Co-Boosting or one of the paper's Table 1 baselines) and reports server
and ensemble test accuracy. Runs on ``cuda`` unless ``--device cpu`` is
given; TF32 is off, so the card computes in full f32 like the reference.
The client ensemble is the grouped ``ClientBank`` (one vmapped forward a
client architecture) unless ``--ensemble-impl looped`` asks for one
forward a client; ``--grouped-market`` trains each architecture group of
the market at once. ``--metrics-out``, ``--trace-out`` and
``--profile-dir`` export the run's telemetry (:mod:`repro_torch.obs`), as
the reference's launcher does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.config.train import ENSEMBLE_IMPLS, OFLConfig
from repro_torch.core.baselines import fedavg, run_adi_baseline, run_feddf, run_generator_baseline
from repro_torch.core.coboosting import default_image_setup, run_coboosting
from repro_torch.core.ensemble import uniform_weights
from repro_torch.data.synthetic import make_synth_images
from repro_torch.fed.market import build_market, build_market_grouped, market_eval_fn
from repro_torch.kernels.dispatch import KERNEL_BACKENDS
from repro_torch.models.cnn import CNN_ARCHS, cnn_apply, init_cnn
from repro_torch.utils.device import disable_tf32, get_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.prng import Draws

log = get_logger("ofl")

METHODS = ("coboosting", "dense", "f_dafl", "f_adi", "feddf", "fedavg", "fedens")


def run_method(
    method: str,
    cfg: OFLConfig,
    num_classes: int,
    image_shape: Tuple[int, int, int],
    applies: List[Callable],
    params: List[Any],
    sizes: Sequence[int],
    train_x: np.ndarray,
    test_x: np.ndarray,
    test_y: np.ndarray,
    server_arch: str,
    seed: int,
    eval_every: int = 50,
    device="cuda",
    archs: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Dispatch one OFL method on ``device``; returns {'server_acc':…,
    'ensemble_acc':…} (and the method's losses and last epoch), except
    ``fedens``, which trains no server and returns ``ensemble_acc`` only.
    FedAvg and FedENS evaluate without training; FedDF distills on
    ``train_x``. ``archs`` (one per client) names the clients in FedAvg's
    error on a mixed market."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    device = torch.device(device)
    server_apply = partial(cnn_apply, server_arch)
    init_gen = torch.Generator(device=device)
    init_gen.manual_seed(seed + 77)
    server_params = init_cnn(init_gen, server_arch, num_classes, image_shape)
    eval_fn = market_eval_fn(applies, params, server_apply, test_x, test_y, impl=cfg.ensemble_impl)
    w = uniform_weights(len(params), device)
    draws = Draws(seed, device)

    if method == "fedavg":
        return eval_fn(fedavg(params, sizes, archs), w)
    if method == "fedens":
        # no server is trained here: evaluating the fresh random init would
        # record a meaningless server_acc next to the real ensemble number
        return eval_fn(None, w)
    if method == "feddf":
        st = run_feddf(applies, params, server_apply, server_params, train_x, cfg, draws, eval_fn, eval_every)
        return st.history[-1]
    if method == "f_adi":
        st = run_adi_baseline(
            applies, params, server_apply, server_params, image_shape, cfg, num_classes, draws, eval_fn, eval_every,
        )
        return st.history[-1]
    init_gen.manual_seed(seed + 5)
    gen_apply, gen_params = default_image_setup(init_gen, cfg, num_classes, image_shape)
    if method in ("dense", "f_dafl"):
        st = run_generator_baseline(
            method, applies, params, server_apply, server_params, gen_apply, gen_params,
            cfg, num_classes, draws, eval_fn, eval_every,
        )
        return st.history[-1]
    # coboosting (+ ablations via component flags on cfg)
    st = run_coboosting(
        applies, params, server_apply, server_params, gen_apply, gen_params,
        cfg, num_classes, draws, eval_fn, eval_every,
    )
    return st.history[-1]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--method", default="coboosting", choices=METHODS)
    p.add_argument("--clients", type=int, default=5)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--partition", default="dirichlet", choices=("dirichlet", "c_cls", "iid"))
    p.add_argument("--c-cls", type=int, default=2)
    p.add_argument("--sigma", type=float, default=0.0, help="lognormal size skew")
    p.add_argument("--classes", type=int, default=6)
    p.add_argument("--image", type=int, default=16)
    p.add_argument("--per-class", type=int, default=150)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--gen-iters", type=int, default=10)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--local-epochs", type=int, default=15)
    p.add_argument("--client-archs", default="", help="comma list (heterogeneous market)")
    p.add_argument("--server-arch", default="cnn5", choices=CNN_ARCHS)
    p.add_argument("--no-ghs", action="store_true")
    p.add_argument("--no-dhs", action="store_true")
    p.add_argument("--no-ee", action="store_true")
    p.add_argument("--no-adv", action="store_true",
                   help="drop the adversarial generator term L_A (independent "
                        "of --no-ghs, so every Table 7 row is reachable)")
    p.add_argument("--backend", default="auto", choices=KERNEL_BACKENDS,
                   help="loss kernels: auto (hand kernels for CUDA tensors, "
                        "plain versions on the CPU) | cuda | ref")
    p.add_argument("--ensemble-impl", default="grouped", choices=ENSEMBLE_IMPLS,
                   help="client forward engine: grouped ClientBank (one vmap "
                        "per arch group) or the K-way looped baseline")
    p.add_argument("--ensemble-scan-chunk", type=int, default=0,
                   help=">0: loop over vmapped chunks of this many clients "
                        "inside each group (memory bound at large K)")
    p.add_argument("--grouped-market", action="store_true",
                   help="vmap local client training within arch groups "
                        "(build_market_grouped) instead of the per-client loop")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    # telemetry (repro_torch.obs) — off by default, zero-cost when off
    p.add_argument("--metrics-out", default=None, metavar="PATH.jsonl",
                   help="dump the ofl.* metrics registry (epoch/phase "
                        "counters + step-time histograms) as JSONL plus a "
                        ".prom Prometheus-text sibling at exit")
    p.add_argument("--trace-out", default=None, metavar="PATH.json",
                   help="record host-side phase spans and dump Chrome "
                        "trace-event JSON (Perfetto-loadable) at exit")
    p.add_argument("--profile-dir", default=None,
                   help="also run a torch.profiler trace into this directory "
                        "(the epoch's record_function phases show up in the "
                        "device timeline; python -m repro_torch.obs.phases "
                        "splits its device time by phase)")
    return p.parse_args(argv)


@dataclasses.dataclass
class Run:
    """A method's inputs: the configuration, the data and the client market."""

    cfg: OFLConfig
    image_shape: Tuple[int, int, int]
    train_x: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    applies: List[Callable]
    params: List[Any]
    sizes: List[int]
    archs: Optional[List[str]]


def prepare_run(args: argparse.Namespace, device) -> Run:
    """The configuration (latent 32, 4 ring slots), the synthetic data and
    the trained client market from the parsed flags (``--grouped-market``:
    trained by arch group, then handed on as the per-client list)."""
    shape = (args.image, args.image, 3)
    cfg = OFLConfig(
        num_clients=args.clients,
        partition=args.partition,
        alpha=args.alpha,
        c_cls=args.c_cls,
        lognormal_sigma=args.sigma,
        local_epochs=args.local_epochs,
        epochs=args.epochs,
        gen_iters=args.gen_iters,
        batch_size=args.batch,
        latent_dim=32,
        buffer_batches=4,
        use_ghs=not args.no_ghs,
        use_dhs=not args.no_dhs,
        use_ee=not args.no_ee,
        use_adv=not args.no_adv,
        backend=args.backend,
        ensemble_impl=args.ensemble_impl,
        ensemble_scan_chunk=args.ensemble_scan_chunk,
        seed=args.seed,
    )
    x, y = make_synth_images(args.seed, args.classes, args.per_class, shape)
    test_x, test_y = make_synth_images(args.seed + 1, args.classes, max(40, args.per_class // 4), shape)
    archs = args.client_archs.split(",") if args.client_archs else None
    if args.grouped_market:
        bank, bank_params, sizes, _ = build_market_grouped(args.seed, x, y, cfg, args.classes, archs, device=device)
        params = bank.unstack_params(bank_params)
        applies = [bank.client_apply(k) for k in range(bank.num_clients)]
    else:
        applies, params, sizes, _ = build_market(args.seed, x, y, cfg, args.classes, archs, device=device)
    return Run(cfg, shape, x, test_x, test_y, applies, params, sizes, archs)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = get_device(args.device)
    disable_tf32()
    obs.configure(
        metrics=bool(args.metrics_out),
        trace=bool(args.trace_out),
        profile_dir=args.profile_dir,
        device=device,
    )
    run = prepare_run(args, device)
    result = run_method(
        args.method, run.cfg, args.classes, run.image_shape, run.applies, run.params, run.sizes,
        run.train_x, run.test_x, run.test_y, args.server_arch, args.seed, eval_every=max(args.epochs // 3, 1),
        device=device, archs=run.archs,
    )
    result = {k: v for k, v in result.items() if isinstance(v, (int, float))}
    log.info("[%s] %s", args.method, result)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"method": args.method, **result}, f, indent=1)
    if args.profile_dir:
        log.info("profile -> %s", obs.stop_torch_profile(obs.tracer()))
    if args.metrics_out:
        obs.registry().dump(args.metrics_out)
        log.info("metrics snapshot -> %s (+ .prom)", args.metrics_out)
    if args.trace_out:
        obs.tracer().dump(args.trace_out)
        log.info("trace -> %s (%d events)", args.trace_out, len(obs.tracer()))
    return result


if __name__ == "__main__":
    main()
