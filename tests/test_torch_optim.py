"""The port's optimizers, gradient clipping and learning-rate schedules
against the JAX package (``repro.optim``) on the CPU. Both sides start from
the same seeded numpy parameters and are fed the same seeded gradients
for several steps; tolerance ``|Δ| ≤ 1e-4·(1 + |ref|)`` in f32 (the
schedules, 1e-6 relative)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JaxTrainConfig
from repro.optim import clip_by_global_norm as jax_clip_by_global_norm
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import make_schedule as jax_make_schedule
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro_torch.config.train import TrainConfig
from repro_torch.optim.optimizers import apply_updates, clip_by_global_norm, make_optimizer
from repro_torch.optim.schedules import make_schedule
from repro_torch.utils.trees import flatten_dict

pytestmark = pytest.mark.tier1

STEPS = 6
SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) - tol * (1 + np.abs(want))
    assert err.max() <= 0, f"max excess {err.max():.3e}, max abs diff {np.abs(got - want).max():.3e}"


def _tree(rng, scale=1.0):
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return (rng.standard_normal(spec) * scale).astype(np.float32)

    return make(SHAPES)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_trees_close(got, want):
    g, w = flatten_dict(got), flatten_dict(want)
    assert set(g) == set(w)
    for p in w:
        _close(g[p].float().numpy(), np.asarray(jnp.asarray(w[p], jnp.float32)))


OPTIMIZERS = [
    dict(optimizer="sgd"),
    dict(optimizer="sgdm"),
    dict(optimizer="sgdm", weight_decay=0.05, state_dtype="bfloat16"),
    dict(optimizer="adam"),
    dict(optimizer="adam", weight_decay=0.1),
    dict(optimizer="adamw"),
    dict(optimizer="adamw", weight_decay=0.1),
]
SCHEDULES = [
    dict(schedule="constant"),
    dict(schedule="cosine", total_steps=5),
    dict(schedule="linear_warmup_cosine", warmup_steps=2, total_steps=6),
]


@pytest.mark.parametrize("opt_kw", OPTIMIZERS, ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
@pytest.mark.parametrize("sched_kw", SCHEDULES, ids=lambda d: d["schedule"])
def test_optimizer_matches_jax_on_given_gradients(opt_kw, sched_kw):
    kw = dict(learning_rate=0.05, **opt_kw, **sched_kw)
    jopt, opt = jax_make_optimizer(JaxTrainConfig(**kw)), make_optimizer(TrainConfig(**kw))
    rng = np.random.default_rng(0)
    jparams = _tree(rng)
    params = _to_torch(jparams)
    jstate, state = jopt.init(jparams), opt.init(params)
    for step in range(STEPS):
        grads = _tree(rng, scale=0.5)
        jup, jstate = jopt.update(grads, jstate, jparams, jnp.asarray(step))
        jparams = jax_apply_updates(jparams, jup)
        up, state = opt.update(_to_torch(grads), state, params, step)
        params = apply_updates(params, up)
        _assert_trees_close(params, jparams)
    if opt_kw.get("state_dtype"):
        assert flatten_dict(state["m"])["a"].dtype == torch.bfloat16
    if jstate:
        _assert_trees_close(state, jstate)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_jax(scale):
    grads = _tree(np.random.default_rng(1), scale=scale)
    for max_norm in (0.0, 1.0):
        got = clip_by_global_norm(_to_torch(grads), max_norm)
        _assert_trees_close(got, jax_clip_by_global_norm(grads, max_norm))
    assert flatten_dict(clip_by_global_norm(_to_torch(grads), 1.0))["a"].dtype == torch.float32


@pytest.mark.parametrize("sched_kw", SCHEDULES + [dict(schedule="linear_warmup_cosine", warmup_steps=0, total_steps=4)],
                         ids=lambda d: f"{d['schedule']}-{d.get('warmup_steps', '')}")
def test_schedules_match_jax(sched_kw):
    cfg = dict(learning_rate=3e-3, **sched_kw)
    jfn, fn = jax_make_schedule(JaxTrainConfig(**cfg)), make_schedule(TrainConfig(**cfg))
    for step in range(12):
        want = float(jfn(jnp.asarray(step)))
        np.testing.assert_allclose(fn(step), want, rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule(TrainConfig(schedule="step"))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(TrainConfig(optimizer="lion"))
