"""The port's LM-scale Co-Boosting (``repro_torch.core.distributed``) and
the embedding-space generator against the JAX package on the CPU: K = 3
reduced smollm-135m clients and a server in f32, JAX weights carried
across (``convert.lm_stacked_params_from_jax``), the JAX side on
``backend="ref"``. DHS gets the reference's own uniform draw through
``ReplayDraws``. Tolerance ``|Δ| ≤ 1e-4·(1 + |ref|)``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.core import distributed as jd
from repro.models import init_lm as jax_init_lm
from repro.models.generator import embedding_generator as jax_embedding_generator
from repro.models.generator import init_embedding_generator as jax_init_embedding_generator
from repro.runtime import make_distill_step_lm as jax_make_distill_step_lm
from repro.utils import tree_stack
from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.config.train import TrainConfig
from repro_torch.convert import (
    lm_params_from_jax,
    lm_params_to_jax,
    lm_stacked_params_from_jax,
    lm_stacked_params_to_jax,
    params_from_jax,
)
from repro_torch.core import distributed as td
from repro_torch.models.generator import embedding_generator, init_embedding_generator
from repro_torch.runtime.steps import make_distill_step_lm
from repro_torch.utils.prng import ReplayDraws
from repro_torch.utils.trees import flatten_dict, value_and_grad

pytestmark = pytest.mark.tier1

K, B, S = 3, 2, 16


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) - 1e-4 * (1 + np.abs(want))
    assert err.max() <= 0, f"max excess {err.max():.3e}, max abs diff {np.abs(got - want).max():.3e}"


def _assert_lm_trees_close(cfg, got, jtree):
    have = flatten_dict(lm_params_to_jax(cfg, got))
    want = flatten_dict(jax.tree_util.tree_map(np.asarray, jtree))
    assert set(have) == set(want)
    for path in want:
        _close(have[path], want[path])


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_variant(jax_get_arch("smollm-135m")).replace(
        dtype="float32", param_dtype="float32", attn_backend="ref", decode_backend="ref"
    )
    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    jclients = np_tree(tree_stack([jax_init_lm(jcfg, jax.random.key(i)) for i in range(K)]))
    jserver = np_tree(jax_init_lm(jcfg, jax.random.key(42)))
    embeds = (np.random.default_rng(0).standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    w = np.asarray([0.5, 0.3, 0.2], np.float32)
    return jcfg, cfg, jclients, jserver, embeds, w


def _port(cfg, jclients, jserver):
    return lm_stacked_params_from_jax(cfg, jclients), lm_params_from_jax(cfg, jserver)


def test_stacked_params_round_trip(setup):
    _, cfg, jclients, _, _, _ = setup
    clients = lm_stacked_params_from_jax(cfg, jclients)
    assert len(clients) == K
    back, want = flatten_dict(lm_stacked_params_to_jax(cfg, clients)), flatten_dict(jclients)
    assert set(back) == set(want)
    for path in want:
        assert np.array_equal(back[path], want[path]), path


def test_embedding_generator_matches_jax():
    jp = jax_init_embedding_generator(jax.random.key(0), 8, 5, S, 128, hidden=64)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((B, 8)).astype(np.float32)
    y = np.asarray([1, 4], np.int32)
    want = jax_embedding_generator(jp, z, y, S, hidden=64)
    params = params_from_jax("embedding_generator", jp)
    got = embedding_generator(params, torch.from_numpy(z), torch.from_numpy(y).long(), S, hidden=64)
    _close(got, want)
    fresh = init_embedding_generator(torch.Generator().manual_seed(0), 8, 5, S, 128, hidden=64)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {k: tuple(v.shape) for k, v in params.items()}


def test_ensemble_and_client_logits_match_jax(setup):
    jcfg, cfg, jclients, jserver, embeds, w = setup
    clients, _ = _port(cfg, jclients, jserver)
    batch = {"embeds": torch.from_numpy(embeds)}
    _close(td.ensemble_lm_logits(clients, cfg, batch, torch.from_numpy(w)),
           jd.ensemble_lm_logits(jclients, jcfg, {"embeds": embeds}, jnp.asarray(w)))
    _close(td.client_lm_logits(clients, cfg, batch), jd.client_lm_logits(jclients, jcfg, {"embeds": embeds}))


def test_dhs_embeds_matches_jax(setup):
    """The reference's uniform draw (its key) is handed to the port."""
    jcfg, cfg, jclients, jserver, embeds, w = setup
    clients, _ = _port(cfg, jclients, jserver)
    key = jax.random.key(7)
    want = jd.dhs_embeds(jclients, jcfg, {"embeds": embeds}, jnp.asarray(w), key, 0.05)["embeds"]
    u = np.asarray(jax.random.uniform(key, (B, cfg.vocab_size), jnp.float32, -1.0, 1.0))
    got = td.dhs_embeds(clients, cfg, {"embeds": torch.from_numpy(embeds)}, torch.from_numpy(w),
                        ReplayDraws([("direction", u)], "cpu"), 0.05)["embeds"]
    _close(got, want)
    moved = np.linalg.norm((np.asarray(want) - embeds).reshape(B, -1), axis=-1)
    np.testing.assert_allclose(moved, 0.05, rtol=1e-4)


def test_ee_update_lm_matches_jax(setup):
    jcfg, cfg, jclients, jserver, embeds, w = setup
    clients, _ = _port(cfg, jclients, jserver)
    labels = np.asarray([3, 300], np.int32)
    want = jd.ee_update_lm(jnp.asarray(w), jclients, jcfg, {"embeds": embeds}, jnp.asarray(labels), 0.1 / K)
    got = td.ee_update_lm(torch.from_numpy(w), clients, cfg, {"embeds": torch.from_numpy(embeds)},
                          torch.from_numpy(labels), 0.1 / K)
    _close(got, want)
    assert abs(float(got.sum()) - 1.0) < 1e-6 and not np.allclose(np.asarray(want), w)


@pytest.mark.parametrize("kl_chunk", [0, 8], ids=["whole", "chunked"])
def test_coboost_distill_loss_and_grads_match_jax(setup, kl_chunk):
    jcfg, cfg, jclients, jserver, embeds, w = setup
    clients, server = _port(cfg, jclients, jserver)
    jloss, jgrads = jax.value_and_grad(jd.coboost_distill_loss)(
        jserver, jclients, jnp.asarray(w), jcfg, {"embeds": embeds}, 4.0, kl_chunk
    )
    batch = {"embeds": torch.from_numpy(embeds)}
    loss, grads = value_and_grad(
        lambda p: td.coboost_distill_loss(p, clients, torch.from_numpy(w), cfg, batch, 4.0, kl_chunk), server
    )
    _close(loss, jloss)
    _assert_lm_trees_close(cfg, grads, jgrads)


def test_distill_step_matches_jax(setup):
    """One ``make_distill_step_lm`` step (SGD momentum, the example's
    optimizer) and one ``coboost_distill_step`` with in-step DHS."""
    jcfg, cfg, jclients, jserver, embeds, w = setup
    clients, server = _port(cfg, jclients, jserver)
    kw = dict(optimizer="sgdm", learning_rate=0.05)
    jstep = jax_make_distill_step_lm(jcfg, JaxTrainConfig(**kw), temperature=4.0)
    jnew, _, jm = jstep(jserver, jstep.optimizer.init(jserver), jclients, jnp.asarray(w), {"embeds": embeds}, jnp.asarray(0))
    step = make_distill_step_lm(cfg, TrainConfig(**kw), temperature=4.0)
    batch = {"embeds": torch.from_numpy(embeds)}
    new, _, m = step(server, step.optimizer.init(server), clients, torch.from_numpy(w), batch, 0)
    _close(m["kd"], jm["kd"])
    _assert_lm_trees_close(cfg, new, jnew)

    key = jax.random.key(11)
    jnew, _, jl = jd.coboost_distill_step(
        jserver, jstep.optimizer.init(jserver), jclients, jnp.asarray(w), jcfg, {"embeds": embeds},
        jstep.optimizer, jnp.asarray(0), epsilon=0.05, key=key,
    )
    u = np.asarray(jax.random.uniform(key, (B, cfg.vocab_size), jnp.float32, -1.0, 1.0))
    new, _, loss = td.coboost_distill_step(
        server, step.optimizer.init(server), clients, torch.from_numpy(w), cfg, {"embeds": torch.from_numpy(embeds)},
        step.optimizer, 0, epsilon=0.05, draws=ReplayDraws([("direction", u)], "cpu"),
    )
    _close(loss, jl)
    _assert_lm_trees_close(cfg, new, jnew)
