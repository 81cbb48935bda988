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
from repro.core.ensemble import ensemble_logits as jax_ensemble_logits
from repro.core.coboosting import default_image_setup as jax_default_image_setup
from repro.core.ensemble import make_logits_all as jax_make_logits_all
from repro.core.ensemble import uniform_weights as jax_uniform_weights
from repro.core.epoch import _sample_zy, distill_schedule as jax_distill_schedule
from repro.core.epoch import make_coboost_epoch as jax_make_coboost_epoch
from repro.core.epoch import make_kd_loss as jax_make_kd_loss
from repro.core.hard_samples import diversify as jax_diversify
from repro.core.hardness import generator_loss as jax_generator_loss
from repro.core.weight_search import update_weights as jax_update_weights
from repro.core.weight_search import weight_loss as jax_weight_loss
from repro.kernels.dispatch import BackendPolicy
from repro.models.cnn import cnn_apply as jax_cnn_apply, init_cnn as jax_init_cnn
from repro.models.generator import image_generator as jax_image_generator
from repro.optim import adam as jax_adam, constant_schedule as jax_constant_schedule, sgdm as jax_sgdm
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro_torch.config.train import OFLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.coboosting import run_coboosting
from repro_torch.core.ensemble import make_logits_all
from repro_torch.core.epoch import make_kd_loss
from repro_torch.core.hard_samples import diversify
from repro_torch.core.hardness import generator_loss
from repro_torch.core.weight_search import weight_grad
from repro_torch.models.cnn import cnn_apply
from repro_torch.models.generator import image_generator
from repro_torch.utils.prng import ReplayDraws
from repro_torch.utils.trees import flatten_dict, unflatten_dict, value_and_grad

pytestmark = pytest.mark.tier1

CLASSES, SHAPE, K = 4, (8, 8, 3), 3
EPOCHS = 2
CFG = dict(num_clients=K, epochs=EPOCHS, gen_iters=2, batch_size=8, latent_dim=8, buffer_batches=2, seed=0)
TOL = {"buffer": 2e-5, "w": 1e-6, "server": 1e-6, "generator": 2e-5}
G_FLOOR = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, tree)


def _run_reference(cfg_kw, classes, shape, k, epochs):
    """The JAX fused epoch run for ``epochs`` epochs; returns the initial
    parameters, the draws of each epoch, the state after each epoch and the
    EE gradient of each epoch."""
    jcfg = JaxOFLConfig(**cfg_kw, backend=BackendPolicy(default="ref"))
    clients = tuple(jax_init_cnn(jax.random.key(20 + i), "cnn5", classes, shape) for i in range(k))
    server = jax_init_cnn(jax.random.key(77), "cnn5", classes, shape)
    gen_apply, gen = jax_default_image_setup(jax.random.key(5), jcfg, classes, shape)
    logits_all = jax_make_logits_all([partial(jax_cnn_apply, "cnn5")] * k)
    step, gen_opt, srv_opt = jax_make_coboost_epoch(
        logits_all, partial(jax_cnn_apply, "cnn5"), gen_apply, jcfg, k, classes
    )
    init = {"clients": [_np(c) for c in clients], "server": _np(server), "generator": _np(gen)}
    sp, gp, w = server, gen, jax_uniform_weights(k)
    sst, gst = srv_opt.init(sp), gen_opt.init(gp)
    buf = jax_buffer_init(jcfg.buffer_batches, (jcfg.batch_size, *shape))
    key, steps = jax.random.key(0), jnp.zeros((), jnp.int32)
    draws, states, ee_grads = [], [], []
    for epoch in range(epochs):
        order, n_valid = jax_distill_schedule(epoch, jcfg.buffer_batches)
        # the epoch's draws, by the reference's own key chain
        keys = jax.random.split(key, 4)
        z, y = _sample_zy(keys[1], jcfg.batch_size, jcfg.latent_dim, classes)
        u_shape = (jcfg.batch_size, classes)
        draws.append(("zy", (np.asarray(z), np.asarray(y))))
        draws.append(("direction", np.asarray(jax.random.uniform(keys[2], u_shape, jnp.float32, -1.0, 1.0))))
        kk, kd_keys = keys[3], []
        for _ in range(int(n_valid)):
            kk, kb = jax.random.split(kk)
            kd_keys.append(kb)
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
            "keys": {"zy": keys[1], "ee": keys[2], "kd": kd_keys}, "order": np.asarray(order),
        })
    return init, draws, states, ee_grads


def _check_port(reference, cfg_kw, classes, shape, k, epochs, backend, tol):
    """Run the port through ``run_coboosting`` from the reference's initial
    parameters on its replayed draws, and hold the state after ``epochs``
    epochs to the reference's at ``tol``."""
    init, draws, states, ee_grads = reference
    cfg = dataclasses.replace(OFLConfig(**cfg_kw, backend=backend), epochs=epochs)
    n_draws = sum(1 + 1 + min(e + 1, cfg.buffer_batches) for e in range(epochs))
    replay = ReplayDraws(draws[:n_draws], "cpu")
    clients = [params_from_jax("cnn5", c) for c in init["clients"]]
    state = run_coboosting(
        [partial(cnn_apply, "cnn5")] * k, clients, partial(cnn_apply, "cnn5"),
        params_from_jax("cnn5", init["server"]),
        lambda p, z, y: image_generator(p, z, y, shape),
        params_from_jax("image_generator", init["generator"]),
        cfg, classes, replay,
    )
    assert not replay.items, "the port drew fewer values than the reference"
    want = states[epochs - 1]
    np.testing.assert_allclose(state.buffer.x.numpy(), want["buf_x"], rtol=0, atol=tol["buffer"])
    np.testing.assert_array_equal(state.buffer.y.numpy(), want["buf_y"])
    assert (state.buffer.ptr, state.buffer.size) == (epochs % cfg.buffer_batches, min(epochs, cfg.buffer_batches))
    # the EE guard: every gradient component the sign step read clears the floor
    assert min(np.abs(g).min() for g in ee_grads[:epochs]) > G_FLOOR
    np.testing.assert_allclose(state.weights.numpy(), want["w"], rtol=0, atol=tol["w"])
    assert _max_diff(state.server_params, want["server"], "cnn5") < tol["server"]
    assert _max_diff(state.gen_params, want["generator"], "image_generator") < tol["generator"]


@pytest.fixture(scope="module")
def reference():
    return _run_reference(CFG, CLASSES, SHAPE, K, EPOCHS)


def _max_diff(got_tree, want_tree, arch):
    want = flatten_dict(params_from_jax(arch, want_tree))
    got = flatten_dict(got_tree)
    return max(
        float((got[k] - want[k]).abs().max()) for k in want if torch.is_tensor(want[k])
    )


@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_epochs_match_jax_fused_ref(reference, epochs, backend):
    _check_port(reference, CFG, CLASSES, SHAPE, K, epochs, backend, TOL)


# ---------------------------------------------------------------------------
# one epoch at the paper's image width (the setting of ``chip_smoke.py``'s
# training path and of ``python -m repro_torch.launch.ofl`` there: 5 cnn5
# clients, a cnn5 server, 32x32x3, 10 classes, synthetic batch 128, 30
# generator steps; latent 32 and 4 ring slots as the CLI sets them). Random
# clients: the point is the algorithm's arithmetic, not the accuracy.

#
# At this width the epoch is chaotic in f32: the generator's 30 Adam steps
# amplify rounding differences until the fresh batch differs everywhere.
# The reference shows it against itself: replayed step by step (the same
# loss, optimizer, draws and keys, compiled step by step instead of as one
# fused program) it ends with generator parameters up to 0.3 of their size
# away from its fused epoch's. So the free-running epoch is held to the
# reference's own spread, and the arithmetic is held tightly by the
# teacher-forced test further down.

FULL_CLASSES, FULL_SHAPE, FULL_K = 10, (32, 32, 3), 5
FULL_CFG = dict(num_clients=FULL_K, epochs=1, gen_iters=30, batch_size=128, latent_dim=32, buffer_batches=4, seed=0)
SPREAD = 2.0  # the port may stray from the fused epoch by this multiple of the reference's own spread


@pytest.fixture(scope="module")
def reference_full():
    return _run_reference(FULL_CFG, FULL_CLASSES, FULL_SHAPE, FULL_K, 1)


def _mean_gap(got_tree, want_tree, arch):
    """Mean |got - want| over every element of the tensor leaves."""
    want = flatten_dict(params_from_jax(arch, want_tree))
    got = flatten_dict(got_tree)
    diffs = [(got[k] - want[k]).abs().flatten() for k in want if torch.is_tensor(want[k])]
    return float(torch.cat(diffs).mean())


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_full_width_epoch_matches_jax_fused_ref(reference_full, reference_full_steps, backend):
    """The port's free-running epoch strays from the reference's fused epoch
    no further than SPREAD times the reference's own replay does, or than
    the small epoch's tolerances where those are wider (mean absolute gaps
    of the fresh batch, the generator and the server); the ensembling
    weights, whose EE gradient components all clear the floor, match at
    1e-6."""
    init, draws, states, ee_grads = reference_full
    _, _, replay = reference_full_steps
    want = states[0]
    own = {
        "buffer": float(np.abs(replay["buf_x0"] - want["buf_x"][0]).mean()),
        "generator": _mean_gap(params_from_jax("image_generator", replay["generator"]), want["generator"],
                               "image_generator"),
        "server": _mean_gap(params_from_jax("cnn5", replay["server"]), want["server"], "cnn5"),
    }
    np.testing.assert_allclose(replay["w"], want["w"], rtol=0, atol=TOL["w"])
    cfg = OFLConfig(**FULL_CFG, backend=backend)
    replay_draws = ReplayDraws(draws[:3], "cpu")
    state = run_coboosting(
        [partial(cnn_apply, "cnn5")] * FULL_K, [params_from_jax("cnn5", c) for c in init["clients"]],
        partial(cnn_apply, "cnn5"), params_from_jax("cnn5", init["server"]),
        lambda p, z, y: image_generator(p, z, y, FULL_SHAPE),
        params_from_jax("image_generator", init["generator"]), cfg, FULL_CLASSES, replay_draws,
    )
    assert not replay_draws.items
    np.testing.assert_array_equal(state.buffer.y.numpy(), want["buf_y"])
    got = {
        "buffer": float(np.abs(state.buffer.x.numpy()[0] - want["buf_x"][0]).mean()),
        "generator": _mean_gap(state.gen_params, want["generator"], "image_generator"),
        "server": _mean_gap(state.server_params, want["server"], "cnn5"),
    }
    assert min(np.abs(ee_grads[0])) > G_FLOOR
    np.testing.assert_allclose(state.weights.numpy(), want["w"], rtol=0, atol=TOL["w"])
    print(f"full-width epoch ({backend}), mean gaps to the fused reference: port {got}, the reference's replay {own}")
    for q in own:
        assert got[q] <= max(SPREAD * own[q], TOL[q]), (q, got[q], own[q])


# Teacher-forced: every step of the epoch at the reference's own parameters
# and inputs, so no difference carries from one step to the next. At each
# of the reference's 30 generator iterates the images and the Eq. 8 loss
# (forward passes, held at 1e-4) and its gradient; then the DHS images and
# the EE gradient of Eq. 12 on the reference's fresh batch, and the
# server's Eq. 4 gradient on the reference's diversified ring slot.
#
# The network gradients are ill-conditioned in f32 at this width (batch-128
# BatchNorm and convolution reductions that cancel; the generator's tanh
# saturates as it trains): against a float64 gradient, the port's and the
# reference's own f32 gradients each lie 3e-4 to 2.7e-3 of a leaf's largest
# value away at the first iterate; at the 6th the reference's `fc`
# gradient lies 1.1e-2 away (the port's 8.8e-3), at the 16th the port's
# BatchNorm bias 3.9e-3 (the reference's 5e-4). So the function is held
# where it is well conditioned: the images and the loss at every iterate,
# and at the first iterate the gradients of the port and the reference to
# each other and the reference's to float64, within LEAF_RTOL of each
# leaf's scale. The precision is held at every iterate: the port's f32
# gradient lies no further from float64 than twice the reference's own, or
# LEAF_RTOL. The float64 gradient is the port's networks in float64 with
# Eq. 8 written out below, independent of both loss ops. The DHS images
# are held within LEAF_RTOL of the step ε, the EE gradient at 1e-4.
LEAF_RTOL = 1e-2


def _leaf_errors(got_tree, want_flat, arch=None):
    """``{leaf: max |got - want| / max |want|}``, ``got_tree`` a JAX tree
    when ``arch`` is given."""
    got = flatten_dict(params_from_jax(arch, got_tree) if arch else got_tree)
    return {
        k: float((got[k].double() - w.double()).abs().max()) / max(float(w.abs().max()), 1e-300)
        for k, w in want_flat.items() if torch.is_tensor(w)
    }


def _eq8_f64(la, w, s_logits, y, cfg):
    """Eq. 8 in float64, written out: the difficulty-weighted CE of the
    ensemble (difficulty held constant) minus β times the KL to the server."""
    ens = torch.einsum("k,kbc->bc", w, la)
    lse = torch.logsumexp(ens, -1)
    ly = ens.gather(1, y[:, None])[:, 0]
    loss = torch.mean((1.0 - torch.exp(ly - lse)).detach() * (lse - ly))
    t = cfg.gen_kl_temperature
    lt, ls = torch.log_softmax(ens / t, -1), torch.log_softmax(s_logits / t, -1)
    return loss - cfg.beta * torch.mean(torch.sum(torch.exp(lt) * (lt - ls), -1) * t * t)


@pytest.fixture(scope="module")
def port_f64_grads(reference_full, reference_full_steps):
    """The float64 gradient of Eq. 8 at each of the reference's iterates."""
    init, draws, _, _ = reference_full
    steps, _, _ = reference_full_steps
    jcfg = JaxOFLConfig(**FULL_CFG, backend=BackendPolicy(default="ref"))
    f64 = lambda tree: unflatten_dict({k: v.double() if torch.is_tensor(v) else v for k, v in flatten_dict(tree).items()})
    clients = [f64(params_from_jax("cnn5", c)) for c in init["clients"]]
    server = f64(params_from_jax("cnn5", init["server"]))
    logits_all = lambda ps, x: torch.stack([cnn_apply("cnn5", p, x) for p in ps])  # make_logits_all casts to f32
    z = torch.tensor(np.asarray(draws[0][1][0]), dtype=torch.float64)
    y = torch.tensor(np.asarray(draws[0][1][1])).long()
    w0 = torch.full((FULL_K,), 1.0 / FULL_K, dtype=torch.float64)

    def loss(gp):
        x = image_generator(gp, z, y, FULL_SHAPE)
        return _eq8_f64(logits_all(clients, x), w0, cnn_apply("cnn5", server, x), y, jcfg)

    return [flatten_dict(value_and_grad(loss, f64(params_from_jax("image_generator", st["params"])))[1])
            for st in steps]


@pytest.fixture(scope="module")
def reference_full_steps(reference_full):
    """The reference's epoch replayed step by step with its own functions,
    draws and keys: the generator phase (every iterate and its gradient),
    then the EE step and the distillation step on the replay's fresh batch.
    Returns ``(steps, last generator iterate, the replay's end state)``;
    each step holds the iterate, its gradient, its loss and its images."""
    init, draws, states, _ = reference_full
    jcfg = JaxOFLConfig(**FULL_CFG, backend=BackendPolicy(default="ref"))
    clients = tuple(init["clients"])
    logits_all = jax_make_logits_all([partial(jax_cnn_apply, "cnn5")] * FULL_K)
    z, y = (jnp.asarray(a) for a in draws[0][1])
    w0 = jax_uniform_weights(FULL_K)

    def loss(gp):
        x = jax_image_generator(gp, z, y, FULL_SHAPE)
        return jax_generator_loss(
            jax_ensemble_logits(logits_all(clients, x), w0), jax_cnn_apply("cnn5", init["server"], x), y,
            beta=jcfg.beta, use_ghs=jcfg.use_ghs, use_adv=jcfg.use_adv, kl_temperature=jcfg.gen_kl_temperature,
        )

    value_grad = jax.jit(jax.value_and_grad(loss))
    images = jax.jit(lambda gp: jax_image_generator(gp, z, y, FULL_SHAPE))
    opt = jax_adam(jax_constant_schedule(jcfg.gen_lr))
    gp = jax.tree_util.tree_map(lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v, init["generator"])
    st, steps = opt.init(gp), []
    for i in range(jcfg.gen_iters):
        val, g = value_grad(gp)
        steps.append({"params": _np(gp), "grads": _np(g), "loss": float(val), "images": np.asarray(images(gp))})
        upd, st = opt.update(g, st, gp, jnp.asarray(i, jnp.int32))
        gp = jax_apply_updates(gp, upd)
    keys = states[0]["keys"]
    x_new = jax_image_generator(gp, z, y, FULL_SHAPE)
    xe = jax_diversify(logits_all, clients, w0, x_new, keys["ee"], jcfg.epsilon)
    w1 = jax_update_weights(w0, logits_all(clients, xe), y, jcfg.mu / FULL_K, backend="ref")
    xk = jax_diversify(logits_all, clients, w1, x_new, keys["kd"][0], jcfg.epsilon)  # the one valid slot holds x_new
    kd = jax_make_kd_loss(logits_all, partial(jax_cnn_apply, "cnn5"), jcfg.kd_temperature, "ref")
    server = jax.tree_util.tree_map(lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v, init["server"])
    srv_opt = jax_sgdm(jax_constant_schedule(jcfg.server_lr), momentum=0.9)
    upd, _ = srv_opt.update(jax.grad(kd)(server, xk, clients, w1), srv_opt.init(server), server, jnp.int32(0))
    replay = {"buf_x0": np.asarray(x_new), "generator": _np(gp), "w": np.asarray(w1),
              "server": _np(jax_apply_updates(server, upd))}
    return steps, _np(gp), replay


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_full_width_epoch_gradients_match_jax_teacher_forced(reference_full, reference_full_steps, port_f64_grads,
                                                             backend):
    init, draws, states, ee_grads = reference_full
    steps, _, _ = reference_full_steps
    jcfg = JaxOFLConfig(**FULL_CFG, backend=BackendPolicy(default="ref"))
    clients = [params_from_jax("cnn5", c) for c in init["clients"]]
    server = params_from_jax("cnn5", init["server"])
    logits_all = make_logits_all([partial(cnn_apply, "cnn5")] * FULL_K)
    server_apply = partial(cnn_apply, "cnn5")
    z, y = (torch.tensor(np.asarray(a)) for a in draws[0][1])
    y = y.long()
    w0 = torch.full((FULL_K,), 1.0 / FULL_K)

    def gen_loss(gp):
        x = image_generator(gp, z, y, FULL_SHAPE)
        return generator_loss(
            logits_all(clients, x), w0, server_apply(server, x), y, beta=jcfg.beta, use_ghs=jcfg.use_ghs,
            use_adv=jcfg.use_adv, kl_temperature=jcfg.gen_kl_temperature, backend=backend,
        )

    worst = {"images": 0.0, "loss": 0.0, "grad_port_f64": 0.0, "grad_jax_f64": 0.0}
    for i, (step, g64) in enumerate(zip(steps, port_f64_grads)):
        gp = params_from_jax("image_generator", step["params"])
        with torch.no_grad():
            x = image_generator(gp, z, y, FULL_SHAPE)
        np.testing.assert_allclose(x.numpy(), step["images"], rtol=0, atol=1e-4)
        val, got = value_and_grad(gen_loss, gp)
        assert abs(float(val) - step["loss"]) <= 1e-4 * max(1.0, abs(step["loss"])), (i, float(val), step["loss"])
        port_err = _leaf_errors(got, g64)
        jax_err = _leaf_errors(step["grads"], g64, "image_generator")
        for k in port_err:
            assert port_err[k] <= max(2 * jax_err[k], LEAF_RTOL), (f"step {i}", k, port_err[k], jax_err[k])
        if i == 0:
            gap = _leaf_errors(got, flatten_dict(params_from_jax("image_generator", step["grads"])))
            assert max(gap.values()) <= LEAF_RTOL and max(jax_err.values()) <= LEAF_RTOL, (gap, jax_err)
        worst["images"] = max(worst["images"], float(np.abs(x.numpy() - step["images"]).max()))
        worst["loss"] = max(worst["loss"], abs(float(val) - step["loss"]))
        worst["grad_port_f64"] = max(worst["grad_port_f64"], max(port_err.values()))
        worst["grad_jax_f64"] = max(worst["grad_jax_f64"], max(jax_err.values()))

    # EE on the reference's fresh batch: the DHS images and the w gradient
    jclients = tuple(init["clients"])
    jlogits_all = jax_make_logits_all([partial(jax_cnn_apply, "cnn5")] * FULL_K)
    x_new = states[0]["buf_x"][0]
    keys = states[0]["keys"]
    xe_want = np.asarray(jax_diversify(jlogits_all, jclients, jax_uniform_weights(FULL_K), jnp.asarray(x_new),
                                       keys["ee"], jcfg.epsilon))
    xe = diversify(logits_all, clients, w0, torch.tensor(x_new), torch.tensor(draws[1][1]), jcfg.epsilon)
    np.testing.assert_allclose(xe.numpy(), xe_want, rtol=0, atol=LEAF_RTOL * jcfg.epsilon)
    with torch.no_grad():
        la = logits_all(clients, torch.tensor(xe_want))
    g_w = weight_grad(w0, la, y, backend).numpy()
    np.testing.assert_allclose(g_w, ee_grads[0], rtol=1e-4, atol=1e-4 * float(np.abs(ee_grads[0]).max()))

    # the server's distillation step on the reference's diversified slot
    w1 = states[0]["w"]
    slot = int(states[0]["order"][0])
    xk_want = np.asarray(jax_diversify(jlogits_all, jclients, jnp.asarray(w1), jnp.asarray(states[0]["buf_x"][slot]),
                                       keys["kd"][0], jcfg.epsilon))
    xk = diversify(logits_all, clients, torch.tensor(w1), torch.tensor(states[0]["buf_x"][slot]),
                   torch.tensor(draws[2][1]), jcfg.epsilon)
    np.testing.assert_allclose(xk.numpy(), xk_want, rtol=0, atol=LEAF_RTOL * jcfg.epsilon)
    kd_want = jax.grad(jax_make_kd_loss(jlogits_all, partial(jax_cnn_apply, "cnn5"), jcfg.kd_temperature, "ref"))(
        init["server"], jnp.asarray(xk_want), jclients, jnp.asarray(w1))
    kd_loss = make_kd_loss(logits_all, server_apply, jcfg.kd_temperature, backend)
    _, kd_got = value_and_grad(kd_loss, server, torch.tensor(xk_want), clients, torch.tensor(w1))
    gap = _leaf_errors(kd_got, flatten_dict(params_from_jax("cnn5", _np(kd_want))))
    assert max(gap.values()) <= LEAF_RTOL, gap
    print(f"full-width epoch ({backend}), teacher-forced over {len(steps)} generator steps: {worst}; server "
          f"gradient gap {max(gap.values())}; DHS images {float(np.abs(xe.numpy() - xe_want).max())} and "
          f"{float(np.abs(xk.numpy() - xk_want).max())}; EE gradient {g_w} against {ee_grads[0]}")
