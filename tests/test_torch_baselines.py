"""The port's Table 1 baselines (``repro_torch.core.baselines``) against the
JAX package's (``repro.core.baselines`` and the fused epochs of
``repro.core.epoch`` under ``backend="ref"``).

DENSE, F-DAFL and F-ADI: both sides start from the reference's initial
parameters (carried across with ``repro_torch.convert``) and the port
replays the reference's own draws through its draw seam: ``z, y`` for
DENSE and F-DAFL (``split(key, 3)``, ``zy`` from ``keys[1]``), the labels
and the unit noise for F-ADI (``split(key, 4)``, ``y`` from ``k1``, the
noise from ``k2``). FedDF draws nothing. The port runs through its
runners under ``"auto"`` (the fused ops; on the CPU their plain versions)
and ``"ref"``, and every replay must be used up.

Tolerances, absolute, on the CPU in f32 (as in ``test_torch_epoch.py``):
buffer images and generator parameters 2e-5 (convolutions reduce in
another order in XLA and in PyTorch, and Adam normalizes the gradients, so
rounding differences reach the parameters at the scale of the rate times
the relative gap); server parameters 1e-6; the uniform ensembling weights
1e-6; buffer labels exact. FedAvg's average, the generator objectives, the
image prior and the entropy, and their input gradients: 1e-6.
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
from repro.core.baselines import GEN_OBJECTIVES as JAX_GEN_OBJECTIVES
from repro.core.baselines import _tv_l2 as jax_tv_l2
from repro.core.baselines import fedavg as jax_fedavg
from repro.core.buffer import buffer_init as jax_buffer_init
from repro.core.coboosting import default_image_setup as jax_default_image_setup
from repro.core.ensemble import ensemble_logits as jax_ensemble_logits
from repro.core.ensemble import make_logits_all as jax_make_logits_all
from repro.core.ensemble import uniform_weights as jax_uniform_weights
from repro.core.epoch import _sample_zy, distill_schedule as jax_distill_schedule
from repro.core.epoch import make_adi_epoch as jax_make_adi_epoch
from repro.core.epoch import make_coboost_epoch as jax_make_coboost_epoch
from repro.core.epoch import make_feddf_epoch as jax_make_feddf_epoch
from repro.core.losses import ce_loss as jax_ce_loss
from repro.core.losses import entropy as jax_entropy
from repro.kernels.dispatch import BackendPolicy
from repro.models.cnn import cnn_apply as jax_cnn_apply, init_cnn as jax_init_cnn
from repro_torch.config.train import OFLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.baselines import (
    GEN_OBJECTIVES,
    _tv_l2,
    fedavg,
    run_adi_baseline,
    run_feddf,
    run_generator_baseline,
)
from repro_torch.core.losses import entropy
from repro_torch.models.cnn import cnn_apply, init_cnn
from repro_torch.models.generator import image_generator, init_image_generator
from repro_torch.utils.prng import Draws, ReplayDraws
from repro_torch.utils.trees import flatten_dict

pytestmark = pytest.mark.tier1

CLASSES, SHAPE, K = 4, (8, 8, 3), 3
EPOCHS = 2
CFG = dict(num_clients=K, epochs=EPOCHS, gen_iters=2, batch_size=8, latent_dim=8, buffer_batches=2, seed=0)
TOL = {"buffer": 2e-5, "w": 1e-6, "server": 1e-6, "generator": 2e-5}
FN_TOL = 1e-6
FEDDF_IMAGES = 28  # 3 whole batches of 8; the 4 left over are dropped, as in the reference
DISTILLING = ("dense", "f_dafl", "f_adi", "feddf")


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, tree)


def _max_diff(got_tree, want_tree, arch):
    want = flatten_dict(params_from_jax(arch, want_tree))
    got = flatten_dict(got_tree)
    return max(float((got[k] - want[k]).abs().max()) for k in want if torch.is_tensor(want[k]))


def _feddf_images():
    return np.random.RandomState(3).uniform(-1, 1, (FEDDF_IMAGES, *SHAPE)).astype(np.float32)


def _run_reference(method):
    """The JAX fused epochs of ``method`` under ``backend="ref"`` for EPOCHS
    epochs; returns the initial parameters, the draws of each epoch (by the
    reference's own key chain) and the state after each epoch."""
    jcfg = JaxOFLConfig(**CFG, backend=BackendPolicy(default="ref"))
    clients = tuple(jax_init_cnn(jax.random.key(20 + i), "cnn5", CLASSES, SHAPE) for i in range(K))
    server = jax_init_cnn(jax.random.key(77), "cnn5", CLASSES, SHAPE)
    server_apply = partial(jax_cnn_apply, "cnn5")
    logits_all = jax_make_logits_all([server_apply] * K)
    w = jax_uniform_weights(K)
    init = {"clients": [_np(c) for c in clients], "server": _np(server)}
    key, steps = jax.random.key(0), jnp.zeros((), jnp.int32)
    draws, states = [], []
    if method in GEN_OBJECTIVES:
        gen_apply, gen = jax_default_image_setup(jax.random.key(5), jcfg, CLASSES, SHAPE)
        init["generator"] = _np(gen)
        step, gen_opt, srv_opt = jax_make_coboost_epoch(
            logits_all, server_apply, gen_apply, jcfg, K, CLASSES,
            gen_objective=JAX_GEN_OBJECTIVES[method], use_ee=False, distill_dhs=False,
        )
        sp, sst, gp, gst = server, srv_opt.init(server), gen, gen_opt.init(gen)
        buf = jax_buffer_init(jcfg.buffer_batches, (jcfg.batch_size, *SHAPE))
        for epoch in range(EPOCHS):
            order, n_valid = jax_distill_schedule(epoch, jcfg.buffer_batches)
            z, y = _sample_zy(jax.random.split(key, 3)[1], jcfg.batch_size, jcfg.latent_dim, CLASSES)
            draws.append(("zy", (np.asarray(z), np.asarray(y))))
            sp, sst, gp, gst, w, buf, key, steps, _, _ = step(
                sp, sst, gp, gst, w, buf, key, steps, order, n_valid, clients
            )
            states.append({"server": _np(sp), "generator": _np(gp), "w": np.asarray(w),
                           "buf_x": np.asarray(buf.x), "buf_y": np.asarray(buf.y)})
    elif method == "f_adi":

        def inv_loss(x, y, cp):
            return jax_ce_loss(jax_ensemble_logits(logits_all(cp, x), w), y) + 2.5e-2 * jax_tv_l2(x)

        step, srv_opt = jax_make_adi_epoch(logits_all, server_apply, SHAPE, jcfg, CLASSES, inv_loss)
        sp, sst = server, srv_opt.init(server)
        buf = jax_buffer_init(jcfg.buffer_batches, (jcfg.batch_size, *SHAPE))
        for epoch in range(EPOCHS):
            order, n_valid = jax_distill_schedule(epoch, jcfg.buffer_batches)
            _, k1, k2, _ = jax.random.split(key, 4)
            y = jax.random.randint(k1, (jcfg.batch_size,), 0, CLASSES)
            draws.append(("inversion", (np.asarray(y), np.asarray(jax.random.normal(k2, (jcfg.batch_size, *SHAPE))))))
            sp, sst, buf, key, steps, _ = step(sp, sst, w, buf, key, steps, order, n_valid, clients)
            states.append({"server": _np(sp), "w": np.asarray(w), "buf_x": np.asarray(buf.x),
                           "buf_y": np.asarray(buf.y)})
    else:
        step, srv_opt = jax_make_feddf_epoch(logits_all, server_apply, jcfg)
        sp, sst = server, srv_opt.init(server)
        val_x = _feddf_images()
        nb = len(val_x) // jcfg.batch_size
        val_batches = jnp.asarray(val_x[: nb * jcfg.batch_size].reshape(nb, jcfg.batch_size, *SHAPE))
        for epoch in range(EPOCHS):
            order = jnp.asarray(np.random.RandomState(epoch).permutation(nb).astype(np.int32))
            sp, sst, key, steps, _ = step(sp, sst, key, steps, order, val_batches, w, clients)
            states.append({"server": _np(sp), "w": np.asarray(w)})
    return init, draws, states


@pytest.fixture(scope="module")
def references():
    cache = {}

    def get(method):
        if method not in cache:
            cache[method] = _run_reference(method)
        return cache[method]

    return get


def _run_port(method, init, draws, epochs, backend):
    """The port's runner for ``method`` from the reference's initial
    parameters on its replayed draws; returns the state and the replay."""
    cfg = dataclasses.replace(OFLConfig(**CFG, backend=backend), epochs=epochs)
    replay = ReplayDraws(draws[:epochs], "cpu")
    applies = [partial(cnn_apply, "cnn5")] * K
    clients = [params_from_jax("cnn5", c) for c in init["clients"]]
    server = params_from_jax("cnn5", init["server"])
    if method in GEN_OBJECTIVES:
        state = run_generator_baseline(
            method, applies, clients, partial(cnn_apply, "cnn5"), server,
            lambda p, z, y: image_generator(p, z, y, SHAPE), params_from_jax("image_generator", init["generator"]),
            cfg, CLASSES, replay,
        )
    elif method == "f_adi":
        state = run_adi_baseline(applies, clients, partial(cnn_apply, "cnn5"), server, SHAPE, cfg, CLASSES, replay)
    else:
        state = run_feddf(applies, clients, partial(cnn_apply, "cnn5"), server, _feddf_images(), cfg, replay)
    return state, replay


@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("method", DISTILLING)
def test_baseline_epochs_match_jax_fused_ref(references, method, backend, epochs):
    init, draws, states = references(method)
    state, replay = _run_port(method, init, draws, epochs, backend)
    assert not replay.items, "the port drew fewer values than the reference"
    want = states[epochs - 1]
    np.testing.assert_allclose(state.weights.numpy(), want["w"], rtol=0, atol=TOL["w"])
    np.testing.assert_allclose(state.weights.numpy(), np.full((K,), 1.0 / K), rtol=0, atol=TOL["w"])
    assert _max_diff(state.server_params, want["server"], "cnn5") < TOL["server"]
    if method != "feddf":
        np.testing.assert_allclose(state.buffer.x.numpy(), want["buf_x"], rtol=0, atol=TOL["buffer"])
        np.testing.assert_array_equal(state.buffer.y.numpy(), want["buf_y"])
        assert (state.buffer.ptr, state.buffer.size) == (epochs % CFG["buffer_batches"], min(epochs, CFG["buffer_batches"]))
    if method in GEN_OBJECTIVES:
        assert _max_diff(state.gen_params, want["generator"], "image_generator") < TOL["generator"]


@pytest.mark.parametrize("method", DISTILLING)
def test_baseline_history_keeps_the_references_keys(method):
    """Evaluation at every epoch: the history holds the reference's keys
    (DENSE and F-DAFL add their losses, F-ADI and FedDF the epoch only)."""
    g = torch.Generator().manual_seed(0)
    cfg = OFLConfig(**CFG)
    applies = [partial(cnn_apply, "cnn5")] * K
    clients = [init_cnn(g, "cnn5", CLASSES, SHAPE) for _ in range(K)]
    server = init_cnn(g, "cnn5", CLASSES, SHAPE)
    eval_fn = lambda sp, w: {"server_acc": 0.5, "ensemble_acc": 0.5}
    draws = Draws(0, "cpu")
    if method in GEN_OBJECTIVES:
        gen = init_image_generator(g, CFG["latent_dim"], CLASSES, SHAPE)
        state = run_generator_baseline(
            method, applies, clients, partial(cnn_apply, "cnn5"), server,
            lambda p, z, y: image_generator(p, z, y, SHAPE), gen, cfg, CLASSES, draws, eval_fn, eval_every=1,
        )
        extra = {"gen_loss", "distill_loss"}
    elif method == "f_adi":
        state = run_adi_baseline(applies, clients, partial(cnn_apply, "cnn5"), server, SHAPE, cfg, CLASSES, draws,
                                 eval_fn, eval_every=1)
        extra = set()
    else:
        state = run_feddf(applies, clients, partial(cnn_apply, "cnn5"), server, _feddf_images(), cfg, draws,
                          eval_fn, eval_every=1)
        extra = set()
    assert [h["epoch"] for h in state.history] == list(range(EPOCHS))
    for h in state.history:
        assert set(h) == {"server_acc", "ensemble_acc", "epoch"} | extra
        assert all(np.isfinite(h[k]) for k in extra)


# ---------------------------------------------------------------------------
# FedAvg


@pytest.mark.parametrize("arch", ["cnn5", "miniresnet"])
@pytest.mark.parametrize("sizes", [None, [5, 17, 2]])
def test_fedavg_matches_jax(arch, sizes):
    jparams = [jax_init_cnn(jax.random.key(30 + i), arch, CLASSES, SHAPE) for i in range(K)]
    want = _np(jax_fedavg(jparams, sizes))
    got = fedavg([params_from_jax(arch, _np(p)) for p in jparams], sizes)
    assert _max_diff(got, want, arch) < FN_TOL
    flat = flatten_dict(got)
    # non-tensor leaves (a residual block's stride) pass through as they are
    for k, v in flatten_dict(params_from_jax(arch, _np(jparams[0]))).items():
        if not torch.is_tensor(v):
            assert flat[k] == v and not torch.is_tensor(flat[k])
        else:
            assert flat[k].dtype == v.dtype


def test_fedavg_raises_on_a_mixed_arch_market():
    archs = ["cnn5", "mlp", "cnn5"]
    jparams = [jax_init_cnn(jax.random.key(40 + i), a, CLASSES, SHAPE) for i, a in enumerate(archs)]
    with pytest.raises(ValueError):  # the reference fails inside tree_stack
        jax_fedavg(jparams)
    params = [params_from_jax(a, _np(p)) for a, p in zip(archs, jparams)]
    with pytest.raises(ValueError, match=r"archs \['cnn5', 'mlp', 'cnn5'\]"):
        fedavg(params, archs=archs)
    with pytest.raises(ValueError, match="parameter trees differ"):
        fedavg(params)


# ---------------------------------------------------------------------------
# the generator objectives, the image prior and the entropy


def _objective_inputs(seed=0):
    rs = np.random.RandomState(seed)
    ens = (rs.randn(8, CLASSES) * 2).astype(np.float32)
    y = rs.randint(0, CLASSES, (8,)).astype(np.int32)
    x = rs.uniform(-1, 1, (8, *SHAPE)).astype(np.float32)
    return ens, y, x


def _port_value_and_grads(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in arrays]
    out = fn(*ts)
    wrt = [t for t in ts if t.requires_grad]
    grads = torch.autograd.grad(out, wrt, allow_unused=True)  # F-DAFL does not read the images
    return float(out.detach()), [np.zeros(t.shape, np.float32) if g is None else g.numpy() for t, g in zip(wrt, grads)]


@pytest.mark.parametrize("name", ["f_dafl", "dense", "tv_l2", "entropy"])
def test_objectives_and_their_input_gradients_match_jax(name):
    ens, y, x = _objective_inputs()
    if name in GEN_OBJECTIVES:
        port = lambda e, y_, x_: GEN_OBJECTIVES[name](e, y_.long(), x_)
        ref = lambda e, x_: JAX_GEN_OBJECTIVES[name](e, jnp.asarray(y), x_)
        got, got_g = _port_value_and_grads(port, ens, y, x)
        want, want_g = jax.value_and_grad(ref, argnums=(0, 1))(ens, x)
    elif name == "tv_l2":
        got, got_g = _port_value_and_grads(_tv_l2, x)
        want, want_g = jax.value_and_grad(lambda x_: jax_tv_l2(x_), argnums=(0,))(x)
    else:
        got, got_g = _port_value_and_grads(entropy, ens)
        want, want_g = jax.value_and_grad(lambda e: jax_entropy(e), argnums=(0,))(ens)
    np.testing.assert_allclose(got, float(want), rtol=0, atol=FN_TOL)
    assert len(got_g) == len(want_g)
    for g, wg in zip(got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(wg), rtol=0, atol=FN_TOL)


def test_replay_inversion_draws_fail_out_of_step():
    n = np.zeros((2, *SHAPE), np.float32)
    r = ReplayDraws([("inversion", (np.zeros((2,), np.int32), n))], "cpu")
    with pytest.raises(RuntimeError, match="out of step"):
        r.zy(2, 4, CLASSES)
    r = ReplayDraws([("inversion", (np.zeros((2,), np.int32), n))], "cpu")
    with pytest.raises(RuntimeError, match="shape"):
        r.inversion(2, (4, 4, 3), CLASSES)
    with pytest.raises(RuntimeError, match="exhausted"):
        r.inversion(2, SHAPE, CLASSES)
    y, noise = Draws(1, "cpu").inversion(5, SHAPE, CLASSES)
    assert y.shape == (5,) and y.dtype == torch.int64 and int(y.max()) < CLASSES
    assert noise.shape == (5, *SHAPE) and noise.dtype == torch.float32
