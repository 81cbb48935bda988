"""The port's equations, optimizers and replay ring (``repro_torch.core``,
``repro_torch.optim``) against the JAX package, on the same numpy inputs.

Tolerance 1e-5 on f32 values unless a test says otherwise. The EE sign step
(Eq. 12) moves each ``w_k`` by a whole μ in the direction of ``sign(g_k)``,
so a component with ``|g_k|`` near the rounding noise could flip; the test
holds ``g`` at a tolerance and ``w`` only where every ``|g_k|`` clears it.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buffer as jbuf
from repro.core.ensemble import ensemble_logits as jax_ensemble_logits
from repro.core.ensemble import make_logits_all as jax_make_logits_all
from repro.core.epoch import distill_schedule as jax_distill_schedule
from repro.core.hard_samples import diversify as jax_diversify
from repro.core.hardness import generator_loss as jax_generator_loss
from repro.core.weight_search import update_weights as jax_update_weights
from repro.core.weight_search import weight_loss as jax_weight_loss
from repro.models.cnn import cnn_apply as jax_cnn_apply, init_cnn as jax_init_cnn
from repro.optim import adam as jax_adam, constant_schedule as jax_constant, sgdm as jax_sgdm
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro.utils.trees import flatten_dict as jax_flatten_dict
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.buffer import buffer_append, buffer_get, buffer_init
from repro_torch.core.ensemble import ensemble_logits, make_logits_all
from repro_torch.core.epoch import distill_schedule
from repro_torch.core.hard_samples import diversify
from repro_torch.core.hardness import generator_loss
from repro_torch.core.weight_search import normalize_weights, update_weights, weight_grad
from repro_torch.models.cnn import cnn_apply
from repro_torch.optim.optimizers import adam, apply_updates, sgdm
from repro_torch.optim.schedules import constant_schedule
from repro_torch.utils.prng import Draws, ReplayDraws
from repro_torch.utils.trees import flatten_dict, unflatten_dict, value_and_grad

pytestmark = pytest.mark.tier1

TOL = 1e-5
SHAPE = (8, 8, 3)
CLASSES = 4


@pytest.fixture(scope="module")
def clients():
    """Three cnn5 clients with JAX inits, as (jax applies, jax params, port
    applies, port params)."""
    jparams = [jax_init_cnn(jax.random.key(10 + k), "cnn5", CLASSES, SHAPE) for k in range(3)]
    tparams = [params_from_jax("cnn5", jax.tree_util.tree_map(np.asarray, p)) for p in jparams]
    japply = [partial(jax_cnn_apply, "cnn5")] * 3
    tapply = [partial(cnn_apply, "cnn5")] * 3
    return jax_make_logits_all(japply), tuple(jparams), make_logits_all(tapply), tparams


def _x(seed, b=8):
    return np.random.default_rng(seed).uniform(-1, 1, (b, *SHAPE)).astype(np.float32)


def test_logits_all_and_ensemble_match_jax(clients):
    jla, jp, tla, tp = clients
    x = _x(0)
    w = np.asarray([0.5, 0.3, 0.2], np.float32)
    want_la = jla(jp, jnp.asarray(x))
    got_la = tla(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got_la.numpy(), np.asarray(want_la), rtol=TOL, atol=TOL)
    want = jax_ensemble_logits(want_la, jnp.asarray(w))
    got = ensemble_logits(got_la, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_diversify_with_replayed_direction(clients):
    """DHS (Eq. 10): the reference draws u from its key; the port takes the
    same u through the draw seam."""
    jla, jp, tla, tp = clients
    x = _x(1)
    w = np.asarray([0.2, 0.5, 0.3], np.float32)
    key = jax.random.key(7)
    u = np.asarray(jax.random.uniform(key, (8, CLASSES), jnp.float32, -1.0, 1.0))
    want = jax_diversify(jla, jp, jnp.asarray(w), jnp.asarray(x), key, 8.0 / 255.0)
    draws = ReplayDraws([("direction", u)], "cpu")
    got = diversify(tla, tp, torch.from_numpy(w), torch.from_numpy(x), draws.direction((8, CLASSES)), 8.0 / 255.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert not got.requires_grad


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_update_weights_matches_jax(clients, backend):
    jla, jp, tla, tp = clients
    x = _x(2, b=16)
    y = np.random.default_rng(2).integers(0, CLASSES, 16).astype(np.int32)
    w = np.asarray([0.3, 0.3, 0.4], np.float32)
    mu = 0.1 / 3
    la_np = np.array(jla(jp, jnp.asarray(x)))
    g_want = jax.grad(lambda w_: jax_weight_loss(w_, jnp.asarray(la_np), jnp.asarray(y), "ref"))(jnp.asarray(w))
    la, yt, wt = torch.from_numpy(la_np), torch.from_numpy(y).long(), torch.from_numpy(w)
    g = weight_grad(wt, la, yt, backend)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_want), rtol=1e-4, atol=1e-6)
    # the guard: every |g_k| clears the tolerance, so sign(g) is well defined
    assert np.abs(np.asarray(g_want)).min() > 1e-4
    want = jax_update_weights(jnp.asarray(w), jnp.asarray(la_np), jnp.asarray(y), mu, backend="ref")
    got = update_weights(wt, la, yt, mu, backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=1e-7)
    assert abs(float(got.sum()) - 1.0) < 1e-6


def test_normalize_weights_clips_to_simplex():
    got = normalize_weights(torch.tensor([-0.2, 0.5, 1.5]))
    np.testing.assert_allclose(got.numpy(), [0.0, 1 / 3, 2 / 3], rtol=1e-6)
    assert float(normalize_weights(torch.zeros(3)).sum()) == 0.0


@pytest.mark.parametrize("use_ghs,use_adv,temp", [(True, True, 1.0), (False, True, 2.0), (True, False, 1.0)])
@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_generator_loss_and_grads_match_jax(use_ghs, use_adv, temp, backend):
    """Eq. 8 and its gradients with respect to the client logits and the
    server logits (the generator's gradient reaches both)."""
    rng = np.random.default_rng(3)
    la = (rng.standard_normal((3, 8, CLASSES)) * 2).astype(np.float32)
    s = (rng.standard_normal((8, CLASSES)) * 2).astype(np.float32)
    y = rng.integers(0, CLASSES, 8).astype(np.int32)
    w = np.asarray([0.2, 0.5, 0.3], np.float32)
    kw = dict(beta=0.7, use_ghs=use_ghs, use_adv=use_adv, kl_temperature=temp)

    def jf(la_, s_):
        return jax_generator_loss(jax_ensemble_logits(la_, jnp.asarray(w)), s_, jnp.asarray(y), **kw)

    want, (g_la, g_s) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(la), jnp.asarray(s))
    lat, st = torch.from_numpy(la).requires_grad_(), torch.from_numpy(s).requires_grad_()
    got = generator_loss(lat, torch.from_numpy(w), st, torch.from_numpy(y).long(), backend=backend, **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lat.grad.numpy(), np.asarray(g_la), rtol=1e-4, atol=1e-6)
    g_st = torch.zeros_like(st) if st.grad is None else st.grad  # no L_A: no server gradient
    np.testing.assert_allclose(g_st.numpy(), np.asarray(g_s), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# replay ring and schedule


@pytest.mark.parametrize("capacity", [1, 2, 3])
def test_ring_matches_jax_buffer(capacity):
    b, obs = 2, (3,)
    jb = jbuf.buffer_init(capacity, (b, *obs))
    tb = buffer_init(capacity, (b, *obs))
    for t in range(3 * capacity + 1):
        x = np.full((b, *obs), float(t), np.float32)
        y = np.full((b,), t, np.int32)
        jb = jbuf.buffer_append(jb, jnp.asarray(x), jnp.asarray(y))
        tb = buffer_append(tb, torch.from_numpy(x), torch.from_numpy(y))
        assert (tb.ptr, tb.size) == (int(jb.ptr), int(jb.size))
        np.testing.assert_array_equal(tb.x.numpy(), np.asarray(jb.x))
        np.testing.assert_array_equal(tb.y.numpy(), np.asarray(jb.y))
    x0, _ = buffer_get(tb, 0)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jbuf.buffer_get(jb, 0)[0]))


@pytest.mark.parametrize("capacity", [1, 3, 4])
def test_distill_schedule_matches_jax(capacity):
    for epoch in range(2 * capacity + 3):
        order, n_valid = distill_schedule(epoch, capacity)
        j_order, j_valid = jax_distill_schedule(epoch, capacity)
        assert n_valid == int(j_valid)
        np.testing.assert_array_equal(order, np.asarray(j_order))


# ---------------------------------------------------------------------------
# optimizers


def _dense_problem():
    rng = np.random.default_rng(4)
    params = {
        "a": {"w": rng.standard_normal((4, 3)).astype(np.float32), "stride": 2},
        "b": rng.standard_normal((3,)).astype(np.float32),
    }
    xs = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(3)]
    return params, xs


def _jax_loss(p, x):
    return jnp.sum(jnp.tanh(x @ p["a"]["w"] + p["b"]) ** 2)


def _torch_loss(p, x):
    return torch.sum(torch.tanh(x @ p["a"]["w"] + p["b"]) ** 2)


@pytest.mark.parametrize("opt_name", ["sgdm", "adam"])
def test_optimizer_steps_match_jax(opt_name):
    """Three steps; the step index restarts (0, 1, 0) as the Co-Boosting
    generator's does each epoch, with the moments carried over."""
    params, xs = _dense_problem()
    if opt_name == "sgdm":
        jopt, topt = jax_sgdm(jax_constant(0.05), momentum=0.9), sgdm(constant_schedule(0.05), momentum=0.9)
    else:
        jopt, topt = jax_adam(jax_constant(0.01)), adam(constant_schedule(0.01))
    jp = {"a": {"w": jnp.asarray(params["a"]["w"])}, "b": jnp.asarray(params["b"])}
    tp = {"a": {"w": torch.from_numpy(params["a"]["w"]), "stride": 2}, "b": torch.from_numpy(params["b"])}
    jst, tst = jopt.init(jp), topt.init(tp)
    for step, x in zip((0, 1, 0), xs):
        g = jax.grad(_jax_loss)(jp, jnp.asarray(x))
        u, jst = jopt.update(g, jst, jp, jnp.asarray(step, jnp.int32))
        jp = jax_apply_updates(jp, u)
        _, tg = value_and_grad(_torch_loss, tp, torch.from_numpy(x))
        tu, tst = topt.update(tg, tst, tp, step)
        tp = apply_updates(tp, tu)
        assert tp["a"]["stride"] == 2
        for k, v in jax_flatten_dict(jp).items():
            np.testing.assert_allclose(flatten_dict(tp)[k].numpy(), np.asarray(v), rtol=TOL, atol=1e-6)


def test_flatten_unflatten_round_trip():
    tree = {"a": {"b": torch.ones(2), "stride": 2}, "c": torch.zeros(3)}
    flat = flatten_dict(tree)
    assert set(flat) == {"a/b", "a/stride", "c"}
    back = unflatten_dict(flat)
    assert back["a"]["stride"] == 2 and torch.equal(back["c"], tree["c"])


def test_value_and_grad_gives_zero_for_unused_leaves():
    p = {"used": torch.tensor([1.0, 2.0]), "unused": torch.tensor([3.0])}
    loss, g = value_and_grad(lambda q: torch.sum(q["used"] ** 2), p)
    assert float(loss) == 5.0
    torch.testing.assert_close(g["used"], torch.tensor([2.0, 4.0]))
    torch.testing.assert_close(g["unused"], torch.tensor([0.0]))


# ---------------------------------------------------------------------------
# draw seam


def test_draws_are_seeded_and_shaped():
    a, b = Draws(3, "cpu"), Draws(3, "cpu")
    z1, y1 = a.zy(4, 5, 3)
    z2, y2 = b.zy(4, 5, 3)
    assert torch.equal(z1, z2) and torch.equal(y1, y2)
    assert z1.shape == (4, 5) and y1.dtype == torch.int64 and int(y1.max()) < 3
    u = a.direction((4, 3))
    assert u.shape == (4, 3) and float(u.min()) >= -1.0 and float(u.max()) < 1.0


def test_replay_draws_fail_out_of_step():
    r = ReplayDraws([("direction", np.zeros((2, 3), np.float32))], "cpu")
    with pytest.raises(RuntimeError, match="out of step"):
        r.zy(2, 4, 3)
    r = ReplayDraws([("direction", np.zeros((2, 3), np.float32))], "cpu")
    with pytest.raises(RuntimeError, match="shape"):
        r.direction((2, 4))
    with pytest.raises(RuntimeError, match="exhausted"):
        r.direction((2, 3))


def test_params_to_jax_of_trained_tree_runs_in_jax(clients):
    """Weights carried back from the port run in the JAX model unchanged."""
    jla, jp, tla, tp = clients
    back = params_to_jax("cnn5", tp[0])
    x = _x(5)
    want = jax_cnn_apply("cnn5", jp[0], jnp.asarray(x))
    got = jax_cnn_apply("cnn5", jax.tree_util.tree_map(jnp.asarray, back), jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
