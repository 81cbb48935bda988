"""One and two Co-Boosting epochs of the port against the JAX package's
fused epoch (``repro.core.epoch.make_coboost_epoch`` under
``backend="ref"``).

Both sides start from the reference's initial parameters (carried across
with ``repro_torch.convert``), and the port replays the reference's own
draws (``z, y``, the EE step's DHS direction, one direction per
distillation slot) through its draw seam. The port runs through
``run_coboosting``, under ``"auto"`` (the fused ops; on the CPU their plain
versions) and ``"ref"``.

Tolerances, absolute, on the CPU in f32: ensembling weights 1e-6 — held
only where every EE gradient component clears 1e-4 (the sign step moves
``w_k`` by a whole μ, so a component in the rounding noise could flip);
server parameters 1e-6; generator parameters and buffer images 2e-5
(convolutions reduce in another order in XLA and in PyTorch, and Adam
normalizes the generator's gradients, so their rounding differences reach
the parameters at the scale of the learning rate times the relative gap;
measured gaps are about 4e-6 and 7e-6). Buffer labels are exact.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.train import OFLConfig as JaxOFLConfig
from repro.core.buffer import buffer_init as jax_buffer_init
from repro.core.coboosting import default_image_setup as jax_default_image_setup
from repro.core.ensemble import make_logits_all as jax_make_logits_all
from repro.core.ensemble import uniform_weights as jax_uniform_weights
from repro.core.epoch import _sample_zy, distill_schedule as jax_distill_schedule
from repro.core.epoch import make_coboost_epoch as jax_make_coboost_epoch
from repro.core.hard_samples import diversify as jax_diversify
from repro.core.weight_search import weight_loss as jax_weight_loss
from repro.kernels.dispatch import BackendPolicy
from repro.models.cnn import cnn_apply as jax_cnn_apply, init_cnn as jax_init_cnn
from repro_torch.config.train import OFLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.coboosting import run_coboosting
from repro_torch.models.cnn import cnn_apply
from repro_torch.models.generator import image_generator
from repro_torch.utils.prng import ReplayDraws
from repro_torch.utils.trees import flatten_dict

pytestmark = pytest.mark.tier1

CLASSES, SHAPE, K = 4, (8, 8, 3), 3
EPOCHS = 2
CFG = dict(num_clients=K, epochs=EPOCHS, gen_iters=2, batch_size=8, latent_dim=8, buffer_batches=2, seed=0)
TOL = {"buffer": 2e-5, "w": 1e-6, "server": 1e-6, "generator": 2e-5}
G_FLOOR = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, tree)


@pytest.fixture(scope="module")
def reference():
    """The JAX fused epoch run for EPOCHS epochs; returns the initial
    parameters, the draws of each epoch, the state after each epoch and the
    EE gradient of each epoch."""
    jcfg = JaxOFLConfig(**CFG, backend=BackendPolicy(default="ref"))
    clients = tuple(jax_init_cnn(jax.random.key(20 + k), "cnn5", CLASSES, SHAPE) for k in range(K))
    server = jax_init_cnn(jax.random.key(77), "cnn5", CLASSES, SHAPE)
    gen_apply, gen = jax_default_image_setup(jax.random.key(5), jcfg, CLASSES, SHAPE)
    logits_all = jax_make_logits_all([partial(jax_cnn_apply, "cnn5")] * K)
    step, gen_opt, srv_opt = jax_make_coboost_epoch(
        logits_all, partial(jax_cnn_apply, "cnn5"), gen_apply, jcfg, K, CLASSES
    )
    init = {"clients": [_np(c) for c in clients], "server": _np(server), "generator": _np(gen)}
    sp, gp, w = server, gen, jax_uniform_weights(K)
    sst, gst = srv_opt.init(sp), gen_opt.init(gp)
    buf = jax_buffer_init(jcfg.buffer_batches, (jcfg.batch_size, *SHAPE))
    key, steps = jax.random.key(0), jnp.zeros((), jnp.int32)
    draws, states, ee_grads = [], [], []
    for epoch in range(EPOCHS):
        order, n_valid = jax_distill_schedule(epoch, jcfg.buffer_batches)
        # the epoch's draws, by the reference's own key chain
        keys = jax.random.split(key, 4)
        z, y = _sample_zy(keys[1], jcfg.batch_size, jcfg.latent_dim, CLASSES)
        u_shape = (jcfg.batch_size, CLASSES)
        draws.append(("zy", (np.asarray(z), np.asarray(y))))
        draws.append(("direction", np.asarray(jax.random.uniform(keys[2], u_shape, jnp.float32, -1.0, 1.0))))
        k = keys[3]
        for _ in range(int(n_valid)):
            k, kb = jax.random.split(k)
            draws.append(("direction", np.asarray(jax.random.uniform(kb, u_shape, jnp.float32, -1.0, 1.0))))
        w_before = w
        sp, sst, gp, gst, w, buf, key, steps, _, _ = step(
            sp, sst, gp, gst, w, buf, key, steps, order, n_valid, clients
        )
        # the EE gradient this epoch took (fresh batch at slot epoch % capacity)
        x_new = buf.x[epoch % jcfg.buffer_batches]
        xe = jax_diversify(logits_all, clients, w_before, x_new, keys[2], jcfg.epsilon)
        la = logits_all(clients, xe)
        ee_grads.append(np.asarray(jax.grad(lambda w_: jax_weight_loss(w_, la, y, "ref"))(w_before)))
        states.append({
            "server": _np(sp), "generator": _np(gp), "w": np.asarray(w),
            "buf_x": np.asarray(buf.x), "buf_y": np.asarray(buf.y),
        })
    return init, draws, states, ee_grads


def _max_diff(got_tree, want_tree, arch):
    want = flatten_dict(params_from_jax(arch, want_tree))
    got = flatten_dict(got_tree)
    return max(
        float((got[k] - want[k]).abs().max()) for k in want if torch.is_tensor(want[k])
    )


@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_epochs_match_jax_fused_ref(reference, epochs, backend):
    init, draws, states, ee_grads = reference
    cfg = dataclasses.replace(OFLConfig(**CFG, backend=backend), epochs=epochs)
    n_draws = sum(1 + 1 + min(e + 1, cfg.buffer_batches) for e in range(epochs))
    replay = ReplayDraws(draws[:n_draws], "cpu")
    clients = [params_from_jax("cnn5", c) for c in init["clients"]]
    state = run_coboosting(
        [partial(cnn_apply, "cnn5")] * K, clients, partial(cnn_apply, "cnn5"),
        params_from_jax("cnn5", init["server"]),
        lambda p, z, y: image_generator(p, z, y, SHAPE),
        params_from_jax("image_generator", init["generator"]),
        cfg, CLASSES, replay,
    )
    assert not replay.items, "the port drew fewer values than the reference"
    want = states[epochs - 1]
    np.testing.assert_allclose(state.buffer.x.numpy(), want["buf_x"], rtol=0, atol=TOL["buffer"])
    np.testing.assert_array_equal(state.buffer.y.numpy(), want["buf_y"])
    assert (state.buffer.ptr, state.buffer.size) == (epochs % cfg.buffer_batches, min(epochs, cfg.buffer_batches))
    # the EE guard: every gradient component the sign step read clears the floor
    assert min(np.abs(g).min() for g in ee_grads[:epochs]) > G_FLOOR
    np.testing.assert_allclose(state.weights.numpy(), want["w"], rtol=0, atol=TOL["w"])
    assert _max_diff(state.server_params, want["server"], "cnn5") < TOL["server"]
    assert _max_diff(state.gen_params, want["generator"], "image_generator") < TOL["generator"]
