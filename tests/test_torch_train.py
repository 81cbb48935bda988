"""The port's LM training slice against the JAX package on the CPU:
reduced smollm-135m in f32 with JAX ``init_lm`` weights carried across
(``repro_torch.convert``), the JAX side on ``backend="ref"``. ``lm_loss``
and its gradients against ``jax.value_and_grad`` (tokens, a mask, and the
embeddings input path), ``lm_features``, one ``make_train_step`` step
against the reference's, gradient micro-batching, the launcher, and
checkpoints written by each package read by the other. Tolerance
``|Δ| ≤ 1e-4·(1 + |ref|)``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.models import init_lm as jax_init_lm
from repro.models import lm_loss as jax_lm_loss
from repro.models.transformer import lm_features as jax_lm_features
from repro.models.transformer import lm_forward as jax_lm_forward
from repro.runtime import make_train_step as jax_make_train_step
from repro_torch.checkpoint import list_checkpoints, load_checkpoint, save_checkpoint
from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.config.train import TrainConfig
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch import train
from repro_torch.models.transformer import lm_features, lm_forward, lm_loss
from repro_torch.runtime.steps import make_train_step
from repro_torch.utils.trees import flatten_dict, value_and_grad

pytestmark = pytest.mark.tier1

B, S = 3, 24


def _close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) - 1e-4 * (1 + np.abs(want))
    assert err.max() <= 0, f"max excess {err.max():.3e}, max abs diff {np.abs(got - want).max():.3e}"


def _perturb_norms(tree, rng):
    """Norm scales init at zero; give them values so ``1 + scale`` counts."""
    def f(path, x):
        name = jax.tree_util.keystr(path)
        return (rng.standard_normal(x.shape) * 0.3).astype(np.float32) if "scale" in name else x
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced_variant(jax_get_arch("smollm-135m")).replace(
        dtype="float32", param_dtype="float32", attn_backend="ref", decode_backend="ref"
    )
    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32")
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_lm(jcfg, jax.random.key(0)))
    jparams = _perturb_norms(jparams, np.random.default_rng(0))
    return jcfg, cfg, jparams


def _batch(cfg, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
    }
    if mask:
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


def _assert_lm_trees_close(cfg, got, jtree):
    want = flatten_dict(lm_params_to_jax(cfg, lm_params_from_jax(cfg, jtree)))  # numpy, JAX layout
    have = flatten_dict(lm_params_to_jax(cfg, got))
    assert set(have) == set(want)
    for path in want:
        _close(have[path], want[path])


@pytest.mark.parametrize("mask", [False, True], ids=["plain", "masked"])
def test_lm_loss_and_grads_match_jax(model, mask):
    jcfg, cfg, jparams = model
    batch = _batch(cfg, mask=mask)
    (jloss, jm), jgrads = jax.value_and_grad(lambda p: jax_lm_loss(p, jcfg, batch), has_aux=True)(jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = value_and_grad(lambda p: lm_loss(p, cfg, tbatch)[0], lm_params_from_jax(cfg, jparams))
    _close(loss, jloss)
    _close(lm_loss(lm_params_from_jax(cfg, jparams), cfg, tbatch)[1]["ce"], jm["ce"])
    _assert_lm_trees_close(cfg, grads, jax.tree_util.tree_map(np.asarray, jgrads))


def test_embeds_input_path_and_features_match_jax(model):
    """``batch["embeds"]`` bypasses the token embedding (and its gradient
    reaches the embeddings); ``lm_features`` is the post-norm trunk."""
    jcfg, cfg, jparams = model
    embeds = (np.random.default_rng(2).standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    params = lm_params_from_jax(cfg, jparams)
    jlogits, _ = jax_lm_forward(jparams, jcfg, {"embeds": embeds})
    jfeats, _ = jax_lm_features(jparams, jcfg, {"embeds": embeds})
    e = torch.from_numpy(embeds.copy()).requires_grad_()
    logits, _ = lm_forward(params, cfg, {"embeds": e})
    _close(logits, jlogits)
    _close(lm_features(params, cfg, {"embeds": e})[0], jfeats)
    ct = np.random.default_rng(3).standard_normal(jlogits.shape).astype(np.float32)
    jg = jax.grad(lambda x: jnp.vdot(jax_lm_forward(jparams, jcfg, {"embeds": x})[0], ct))(embeds)
    (g,) = torch.autograd.grad(torch.sum(logits * torch.from_numpy(ct)), e)
    _close(g, jg)


def test_train_step_matches_jax(model):
    """One step of each package's ``make_train_step`` (SGD with a clipping
    norm, so the update is the gradient's, unamplified)."""
    jcfg, cfg, jparams = model
    kw = dict(optimizer="sgd", learning_rate=0.1, grad_clip_norm=1.0)
    batch = _batch(cfg, seed=4)
    jstep = jax_make_train_step(jcfg, JaxTrainConfig(**kw))
    jnew, _, jmetrics = jstep(jparams, jstep.optimizer.init(jparams), batch, jnp.asarray(0))
    step = make_train_step(cfg, TrainConfig(**kw))
    params = lm_params_from_jax(cfg, jparams)
    new, _, metrics = step(params, step.optimizer.init(params), {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    _close(metrics["loss"], jmetrics["loss"])
    _assert_lm_trees_close(cfg, new, jax.tree_util.tree_map(np.asarray, jnew))


def test_microbatches_match_one_batch(model):
    """``microbatches=2`` averages the two halves' gradients: the same step
    as one batch of both (grad_dtype f32 is a no-op cast)."""
    _, cfg, jparams = model
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=5).items()}
    batch = {k: torch.cat([v, v.flip(0)[:1]]) for k, v in batch.items()}  # B = 4
    out = []
    for micro in (1, 2):
        tc = TrainConfig(optimizer="sgd", learning_rate=0.1, microbatches=micro, grad_dtype="float32")
        step = make_train_step(cfg, tc)
        params = lm_params_from_jax(cfg, jparams)
        new, _, metrics = step(params, step.optimizer.init(params), batch, 0)
        out.append((new, float(metrics["loss"])))
    assert abs(out[0][1] - out[1][1]) < 1e-5
    a, b = flatten_dict(lm_params_to_jax(cfg, out[0][0])), flatten_dict(lm_params_to_jax(cfg, out[1][0]))
    for path in a:
        np.testing.assert_allclose(b[path], a[path], rtol=0, atol=1e-6)


def test_train_launcher_on_cpu(tmp_path):
    """``launch.train --reduced --device cpu`` runs, its loss falls, and the
    checkpoint it writes loads into the reference's tree layout."""
    result = train.main([
        "--reduced", "--device", "cpu", "--steps", "30", "--batch", "4", "--seq", "32", "--log-every", "10",
        "--ckpt-dir", str(tmp_path),
    ])
    assert len(result["losses"]) == 30 and all(np.isfinite(result["losses"]))
    assert result["last10"] < result["first10"]
    assert list_checkpoints(str(tmp_path)) == [30]
    tree = jax_load_checkpoint(str(tmp_path))
    assert "groups" in tree and tree["embed"]["table"].shape == (512, 128)
    # a production mesh needs a 256-rank world: a world of one exits first
    with pytest.raises(SystemExit, match="256"):
        train.main(["--reduced", "--device", "cpu", "--mesh", "production"])


def test_checkpoints_cross_load(model, tmp_path):
    """A checkpoint each package writes loads, bitwise, in the other."""
    _, cfg, jparams = model
    jax_save_checkpoint(str(tmp_path / "jax"), 7, jparams, {"arch": cfg.name})
    params = lm_params_from_jax(cfg, load_checkpoint(str(tmp_path / "jax")))
    save_checkpoint(str(tmp_path / "port"), 3, lm_params_to_jax(cfg, params), {"arch": cfg.name})
    back = flatten_dict(jax_load_checkpoint(str(tmp_path / "port"), 3))
    want = flatten_dict(jparams)
    assert set(back) == set(want)
    for path in want:
        assert back[path].dtype == want[path].dtype and np.array_equal(back[path], want[path]), path
