"""Co-Boosting at LM scale: distill an ensemble of K LM clients into a
server LM (the port of the reference's ``examples/distill_llm.py``).

    # smollm-135m at full width on the GPU (bf16 activations, f32 params)
    python -m repro_torch.launch.distill_llm

    # the reduced variant in f32 on the CPU
    python -m repro_torch.launch.distill_llm --reduced --device cpu

K = 3 clients with random weights (seeds 0..K-1; stand-ins for the model
market's uploads) and a server (seed 42). Each of 8 epochs draws an
embedding-space batch (B = 4, S = 32, standing in for the generator),
makes it hard for the ensemble (DHS, Eq. 10, epsilon 0.05), reweights the
clients on it (EE, Eq. 12, mu 0.1/K) against random target tokens, and
takes one SGD-momentum step of the server on the Eq. 4 KL (T = 4, rate
0.05). DHS differentiates the clients' forwards and distillation the
server's, both through the flash-attention backward kernels on the card.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.config.train import TrainConfig
from repro_torch.core.distributed import dhs_embeds, ee_update_lm
from repro_torch.kernels.dispatch import KERNEL_BACKENDS
from repro_torch.models.transformer import init_lm
from repro_torch.runtime.steps import make_distill_step_lm
from repro_torch.utils.device import disable_tf32, get_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.prng import Draws

log = get_logger("distill_llm")

K, B, S, EPOCHS = 3, 4, 32, 8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--reduced", action="store_true", help="smoke-scale variant, in f32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="auto", choices=KERNEL_BACKENDS)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_variant(cfg).replace(dtype="float32", param_dtype="float32")
    cfg = cfg.replace(backend=args.backend)
    device = get_device(args.device)
    disable_tf32()

    clients = [init_lm(cfg, torch.Generator(device=device).manual_seed(i)) for i in range(K)]
    server = init_lm(cfg, torch.Generator(device=device).manual_seed(42))
    w = torch.full((K,), 1.0 / K, device=device)
    step = make_distill_step_lm(cfg, TrainConfig(optimizer="sgdm", learning_rate=0.05), temperature=4.0)
    opt_state = step.optimizer.init(server)
    draws = Draws(args.seed, device)

    kds, ws = [], []
    for epoch in range(EPOCHS):
        # embedding-space synthetic batch (generator stand-in: random draws)
        batch = {"embeds": torch.randn((B, S, cfg.d_model), generator=draws.gen, device=device) * 0.02}
        # DHS: make the batch hard for the ensemble (Eq. 10, embedding space)
        batch = dhs_embeds(clients, cfg, batch, w, draws, epsilon=0.05)
        # EE: reweight clients on the hard batch (Eq. 12)
        labels = torch.randint(0, cfg.vocab_size, (B,), generator=draws.gen, device=device)
        w = ee_update_lm(w, clients, cfg, batch, labels, mu=0.1 / K)
        # distill (Eq. 4)
        server, opt_state, metrics = step(server, opt_state, clients, w, batch, epoch)
        kds.append(float(metrics["kd"]))
        ws.append(w.cpu().tolist())
        log.info("epoch %d: kd=%.4f w=%s", epoch, kds[-1], [round(x, 3) for x in ws[-1]])
    log.info("done: the server now approximates the weighted client ensemble")
    return {"kd": kds, "w": ws}


if __name__ == "__main__":
    main()
