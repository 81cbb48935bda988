"""The port's data pipeline and client market (``repro_torch.data``,
``repro_torch.fed``) against the JAX package: the numpy data and partitions
bitwise, local training from the same init within 1e-5, evaluation equal."""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.train import OFLConfig as JaxOFLConfig
from repro.config.train import TrainConfig as JaxTrainConfig
from repro.data import make_synth_images as jax_make_synth_images
from repro.data import partitions as jax_partitions
from repro.data.loader import batch_iterator as jax_batch_iterator
from repro.fed.client import evaluate_cnn as jax_evaluate_cnn
from repro.fed.client import local_train as jax_local_train
from repro.fed.market import market_eval_fn as jax_market_eval_fn
from repro.models.cnn import cnn_apply as jax_cnn_apply, init_cnn as jax_init_cnn
from repro_torch.config.train import OFLConfig, TrainConfig
from repro_torch.convert import params_from_jax
from repro_torch.data import partitions
from repro_torch.data.loader import batch_iterator
from repro_torch.data.synthetic import make_synth_images
from repro_torch.fed.client import evaluate_cnn, local_train
from repro_torch.fed.market import build_market, market_eval_fn
from repro_torch.models.cnn import cnn_apply
from repro_torch.utils.trees import flatten_dict

pytestmark = pytest.mark.tier1

SHAPE = (8, 8, 3)


@pytest.mark.parametrize("seed,classes,per_class,shape", [(0, 4, 10, (8, 8, 3)), (3, 10, 3, (32, 32, 3))])
def test_synth_images_bitwise(seed, classes, per_class, shape):
    x, y = make_synth_images(seed, classes, per_class, shape)
    jx, jy = jax_make_synth_images(seed, classes, per_class, shape)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize(
    "cfg_kw",
    [
        dict(partition="dirichlet", alpha=0.1, num_clients=5),
        dict(partition="dirichlet", alpha=1.0, num_clients=3, lognormal_sigma=0.5),
        dict(partition="c_cls", c_cls=2, num_clients=4),
        dict(partition="iid", num_clients=3),
    ],
)
def test_partitions_bitwise(cfg_kw):
    _, y = make_synth_images(0, 6, 20, SHAPE)
    got = partitions.partition_dataset(7, y, OFLConfig(**cfg_kw))
    want = jax_partitions.partition_dataset(7, y, JaxOFLConfig(**cfg_kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_iterator_bitwise():
    x, y = make_synth_images(1, 3, 7, SHAPE)
    got = list(batch_iterator(x, y, 5, seed=2, epochs=2))
    want = list(jax_batch_iterator(x, y, 5, seed=2, epochs=2))
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("arch", ["cnn5", "mlp"])
def test_local_train_matches_jax(arch):
    """A few SGD-momentum steps (two epochs over 40 samples, batch 16: six
    steps, the last of each epoch a partial batch) from the same init."""
    x, y = make_synth_images(0, 4, 10, SHAPE)
    p0 = jax_init_cnn(jax.random.key(3), arch, 4, SHAPE)
    jtc = JaxTrainConfig(optimizer="sgdm", learning_rate=0.05, momentum=0.9, batch_size=16, seed=1)
    want = jax_local_train(partial(jax_cnn_apply, arch), p0, x, y, jtc, epochs=2)
    tc = TrainConfig(optimizer="sgdm", learning_rate=0.05, momentum=0.9, batch_size=16, seed=1)
    got = local_train(partial(cnn_apply, arch), params_from_jax(arch, jax.tree_util.tree_map(np.asarray, p0)), x, y, tc, 2)
    want_t = flatten_dict(params_from_jax(arch, jax.tree_util.tree_map(np.asarray, want)))
    for k, v in flatten_dict(got).items():
        np.testing.assert_allclose(v.numpy(), want_t[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    assert evaluate_cnn(partial(cnn_apply, arch), got, x, y) == jax_evaluate_cnn(
        partial(jax_cnn_apply, arch), want, x, y
    )


def test_market_eval_matches_jax():
    x, y = make_synth_images(2, 4, 12, SHAPE)
    jp = [jax_init_cnn(jax.random.key(k), "cnn5", 4, SHAPE) for k in range(2)]
    server = jax_init_cnn(jax.random.key(9), "cnn5", 4, SHAPE)
    w = np.asarray([0.7, 0.3], np.float32)
    want = jax_market_eval_fn(
        [partial(jax_cnn_apply, "cnn5")] * 2, jp, partial(jax_cnn_apply, "cnn5"), x, y,
        batch_size=20, impl="looped",
    )(server, jnp.asarray(w))
    conv = lambda p: params_from_jax("cnn5", jax.tree_util.tree_map(np.asarray, p))
    got = market_eval_fn(
        [partial(cnn_apply, "cnn5")] * 2, [conv(p) for p in jp], partial(cnn_apply, "cnn5"), x, y, batch_size=20
    )(conv(server), torch.from_numpy(w))
    assert got == want


def test_market_eval_without_server_matches_jax_and_skips_it():
    """``server_params=None`` (FedENS) returns ``ensemble_acc`` only, as
    the reference does, and never calls the server."""
    x, y = make_synth_images(3, 4, 12, SHAPE)
    jp = [jax_init_cnn(jax.random.key(k), "cnn5", 4, SHAPE) for k in range(2)]
    w = np.asarray([0.4, 0.6], np.float32)
    want = jax_market_eval_fn(
        [partial(jax_cnn_apply, "cnn5")] * 2, jp, partial(jax_cnn_apply, "cnn5"), x, y,
        batch_size=20, impl="looped",
    )(None, jnp.asarray(w))

    def server_apply(params, xb):
        raise AssertionError("the server was called")

    conv = lambda p: params_from_jax("cnn5", jax.tree_util.tree_map(np.asarray, p))
    got = market_eval_fn(
        [partial(cnn_apply, "cnn5")] * 2, [conv(p) for p in jp], server_apply, x, y, batch_size=20
    )(None, torch.from_numpy(w))
    assert got == want and set(got) == {"ensemble_acc"}


def test_build_market_on_cpu():
    x, y = make_synth_images(0, 4, 20, SHAPE)
    cfg = OFLConfig(num_clients=2, local_epochs=1, local_batch_size=16)
    applies, params, sizes, parts = build_market(0, x, y, cfg, 4, archs=["cnn5", "mlp"], device="cpu")
    assert len(applies) == len(params) == 2 and sum(sizes) == len(y)
    assert [len(p) for p in parts] == sizes
    logits = applies[1](params[1], torch.from_numpy(x[:3]))
    assert logits.shape == (3, 4) and bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="client archs"):
        build_market(0, x, y, cfg, 4, archs=["cnn5"], device="cpu")
