"""Quickstart: the whole one-shot-FL story (the port of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]

1. Make a synthetic non-IID federation (3 clients, Dirichlet split).
2. Train each client locally (this is all that ever leaves a client).
3. Run Co-Boosting on the server: generator + ensemble reweighting +
   distillation — no data, no extra transmissions.

The settings are the reference's. Its keys become seeded
``torch.Generator``s (the server's init from 7, the generator's from 5,
the epochs' draws from 0), so the numbers are the port's own.
"""
from __future__ import annotations

import argparse
from functools import partial
from typing import Optional, Sequence

from repro_torch.config.train import OFLConfig
from repro_torch.core import uniform_weights
from repro_torch.examples import coboost, federation, init_generator, init_server
from repro_torch.fed import market_eval_fn
from repro_torch.models.cnn import cnn_apply
from repro_torch.utils.device import disable_tf32, get_device
from repro_torch.utils.prng import Draws

ARCH = "cnn2"

CFG = OFLConfig(
    num_clients=3, alpha=0.1,            # highly non-IID
    local_epochs=12, local_batch_size=32,
    epochs=12, gen_iters=8, batch_size=32, latent_dim=32, buffer_batches=3,
)
EVAL_EVERY = 4


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = get_device(args.device)
    disable_tf32()

    applies, client_params, test_x, test_y = federation([ARCH] * CFG.num_clients, CFG, device)
    server_params = init_server(ARCH, 7, device)
    gen_apply, gen_params = init_generator(5, CFG, device)
    eval_fn = market_eval_fn(applies, client_params, partial(cnn_apply, ARCH), test_x, test_y)

    before = eval_fn(server_params, uniform_weights(CFG.num_clients, device))
    print("before:", before)
    state = coboost(ARCH, applies, client_params, server_params, gen_apply, gen_params, CFG, Draws(0, device),
                    eval_fn, EVAL_EVERY)
    weights = [float(w) for w in state.weights]
    print("after :", state.history[-1])
    print("learned ensemble weights:", [round(w, 3) for w in weights])
    return {"before": before, "after": state.history[-1], "weights": weights, "history": state.history}


if __name__ == "__main__":
    main()
