"""Model-market heterogeneity (paper Table 3; the port of
``examples/heterogeneous_clients.py``): every client a different
architecture — LeNet, CNN, ResNet-style, MLP — distilled into a ResNet-
family server. FedAvg is impossible here; Co-Boosting does not care, since
it only touches logits.

    python -m repro_torch.examples.heterogeneous_clients [--device cpu]

The settings are the reference's; the client ensemble is the default
grouped bank. The reference itself stops in its market build (its SGD-m
reads ``.dtype`` off the miniresnet's ``"stride"`` int); the port's trees
pass non-tensor leaves through, so this runs to the end.
"""
from __future__ import annotations

import argparse
from functools import partial
from typing import Optional, Sequence

from repro_torch.config.train import OFLConfig
from repro_torch.examples import coboost, federation, init_generator, init_server
from repro_torch.fed import market_eval_fn
from repro_torch.models.cnn import cnn_apply
from repro_torch.utils.device import disable_tf32, get_device
from repro_torch.utils.prng import Draws

CLIENT_ARCHS = ["cnn5", "cnn2", "miniresnet", "mlp"]
SERVER_ARCH = "miniresnet"

CFG = OFLConfig(
    num_clients=len(CLIENT_ARCHS), alpha=0.1,
    local_epochs=12, local_batch_size=32,
    epochs=10, gen_iters=8, batch_size=32, latent_dim=32, buffer_batches=3,
)
EVAL_EVERY = 5


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = get_device(args.device)
    disable_tf32()

    applies, client_params, test_x, test_y = federation(CLIENT_ARCHS, CFG, device)
    server_params = init_server(SERVER_ARCH, 7, device)
    gen_apply, gen_params = init_generator(5, CFG, device)
    eval_fn = market_eval_fn(applies, client_params, partial(cnn_apply, SERVER_ARCH), test_x, test_y)

    state = coboost(SERVER_ARCH, applies, client_params, server_params, gen_apply, gen_params, CFG,
                    Draws(0, device), eval_fn, EVAL_EVERY)
    weights = {a: float(w) for a, w in zip(CLIENT_ARCHS, state.weights)}
    print("final:", state.history[-1])
    print("per-arch weights:", {a: round(w, 3) for a, w in weights.items()})
    return {"final": state.history[-1], "weights": weights, "history": state.history}


if __name__ == "__main__":
    main()
