"""The port's pipeline end to end at miniature scale, on the CPU: the same
qualitative targets as the JAX package's ``tests/test_ofl_integration.py``
(the port's client inits come from ``torch.Generator``, so the numbers
differ, not the claims): Co-Boosting lifts the server above its random init
and above chance, and EE moves the ensembling weights off the uniform point
while keeping them on the simplex; FedAvg on non-IID shards falls below the
logit ensemble (Table 1's ordering)."""
from __future__ import annotations

from functools import partial

import pytest
import torch

from repro_torch.config.train import OFLConfig
from repro_torch.core.baselines import fedavg
from repro_torch.core.coboosting import default_image_setup, run_coboosting
from repro_torch.core.ensemble import uniform_weights
from repro_torch.data.synthetic import make_synth_images
from repro_torch.fed.client import evaluate_cnn
from repro_torch.fed.market import build_market, market_eval_fn
from repro_torch.models.cnn import cnn_apply, init_cnn
from repro_torch.utils.prng import Draws

pytestmark = pytest.mark.tier1

CLASSES = 5
SHAPE = (16, 16, 3)


@pytest.fixture(scope="module")
def market():
    x, y = make_synth_images(0, CLASSES, 100, SHAPE)
    tx, ty = make_synth_images(1, CLASSES, 30, SHAPE)
    cfg = OFLConfig(
        num_clients=3, alpha=0.3, local_epochs=15, local_batch_size=32,
        epochs=14, gen_iters=5, batch_size=32, latent_dim=16, buffer_batches=2,
        server_lr=0.05,
    )
    applies, params, sizes, _ = build_market(0, x, y, cfg, CLASSES, archs=["mlp"] * 3, device="cpu")
    return cfg, applies, params, sizes, (tx, ty)


def test_coboosting_end_to_end_on_cpu(market):
    cfg, applies, params, _, (tx, ty) = market
    for ap, p in zip(applies, params):
        assert evaluate_cnn(ap, p, tx, ty) > 1.5 / CLASSES  # each client learned its shard

    g = torch.Generator().manual_seed(99)
    server_apply = partial(cnn_apply, "mlp")
    server_params = init_cnn(g, "mlp", CLASSES, SHAPE)
    eval_fn = market_eval_fn(applies, params, server_apply, tx, ty)
    pre = eval_fn(server_params, uniform_weights(3))
    gen_apply, gen_params = default_image_setup(torch.Generator().manual_seed(5), cfg, CLASSES, SHAPE)
    st = run_coboosting(
        applies, params, server_apply, server_params, gen_apply, gen_params,
        cfg, CLASSES, Draws(0, "cpu"), eval_fn=eval_fn, eval_every=cfg.epochs,
    )
    final = st.history[-1]
    assert final["server_acc"] > pre["server_acc"] + 0.05, (pre, final)
    assert final["server_acc"] > 1.4 / CLASSES, final
    w = st.weights
    assert abs(float(w.sum()) - 1) < 1e-4
    assert not torch.allclose(w, torch.full_like(w, 1 / 3), atol=1e-3)


def test_fedavg_below_ensemble_on_noniid(market):
    cfg, applies, params, sizes, (tx, ty) = market
    avg = fedavg(params, sizes)
    acc_avg = evaluate_cnn(partial(cnn_apply, "mlp"), avg, tx, ty)
    ens = market_eval_fn(applies, params, partial(cnn_apply, "mlp"), tx, ty)(avg, uniform_weights(3))["ensemble_acc"]
    # the logit ensemble beats naive parameter averaging under non-IID
    assert ens > acc_avg, (ens, acc_avg)
