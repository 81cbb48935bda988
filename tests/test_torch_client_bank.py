"""The port's grouped client ensemble (``repro_torch.core.client_bank``),
grouped local training (``repro_torch.fed.client.local_train_group``), the
grouped market and the launcher's ensemble flags, against the JAX package
(``repro.core.client_bank``, ``repro.fed``) and against the port's own
looped engine.

Tolerances, absolute, on the CPU in f32: client logits and input
gradients 1e-5, a few rounding steps at logits of size ~5 (a grouped
convolution sums in another order than K separate ones, in PyTorch as in
XLA; a chunk of fewer clients is a grouped convolution of another size,
which oneDNN blocks differently again: 2.9e-6 measured); locally trained
parameters 1e-5; one Co-Boosting epoch as in ``tests/test_torch_epoch.py``
(buffer images 2e-5, server parameters and ensembling weights 1e-6, labels
exact), except the generator parameters, 5e-5: Adam's first steps move a
parameter by about the rate (1e-3) times the sign of its gradient, so a
gradient component at rounding level, summed in another order, moves its
parameter by up to that rate (measured, this market: the port's loop 1.8e-5
and its bank 2.7e-5 from the reference's bank, 1.4e-5 from each other).
Grouping, the client order and the local-training schedule are exact.

The reference's bank cannot hold a miniresnet group (its parameter key
reads a shape off the ``"stride"`` int), so markets with miniresnet are
held against the reference's looped stack; the port's bank keeps that
leaf out of the stack.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.train import OFLConfig as JaxOFLConfig
from repro.config.train import TrainConfig as JaxTrainConfig
from repro.core.buffer import buffer_init as jax_buffer_init
from repro.core.client_bank import ClientBank as JaxClientBank
from repro.core.client_bank import make_ensemble as jax_make_ensemble
from repro.core.ensemble import uniform_weights as jax_uniform_weights
from repro.core.epoch import _sample_zy, distill_schedule as jax_distill_schedule
from repro.core.epoch import make_coboost_epoch as jax_make_coboost_epoch
from repro.fed.client import _group_schedule as jax_group_schedule
from repro.fed.client import local_train as jax_local_train
from repro.fed.client import local_train_group as jax_local_train_group
from repro.kernels.dispatch import BackendPolicy
from repro.models.cnn import cnn_apply as jax_cnn_apply
from repro.models.generator import image_generator as jax_image_generator
from repro.utils.trees import tree_stack as jax_tree_stack, tree_unstack as jax_tree_unstack
from repro_torch.config.train import OFLConfig, TrainConfig
from repro_torch.convert import bank_params_from_jax, params_from_jax, params_to_jax
from repro_torch.core import ENSEMBLE_IMPLS, ClientBank, make_ensemble
from repro_torch.core.coboosting import run_coboosting
from repro_torch.data.synthetic import make_synth_images
from repro_torch.fed import build_market, build_market_grouped, local_train, local_train_group
from repro_torch.fed.client import _group_schedule
from repro_torch.launch import ofl
from repro_torch.models.cnn import CNN_ARCHS, cnn_apply, init_cnn
from repro_torch.models.generator import image_generator, init_image_generator
from repro_torch.utils.prng import ReplayDraws
from repro_torch.utils.trees import flatten_dict, tree_leaves, tree_stack, tree_unstack

pytestmark = pytest.mark.tier1

CLASSES, SHAPE = 5, (8, 8, 3)
TOL = 1e-5
EPOCH_TOL = {"buffer": 2e-5, "w": 1e-6, "server": 1e-6, "generator": 5e-5}
MARKETS = {
    "homogeneous": ["cnn5"] * 4,
    "singletons": ["mlp", "cnn2", "lenet5"],
    "mixed_miniresnet": ["miniresnet", "mlp", "miniresnet", "cnn2", "mlp"],
    "random": [CNN_ARCHS[i] for i in np.random.RandomState(5).randint(0, len(CNN_ARCHS), 7)],
}
# markets the reference's bank can build (no miniresnet)
JAX_BANK_MARKETS = {
    "homogeneous": MARKETS["homogeneous"],
    "singletons": MARKETS["singletons"],
    "interleaved": ["cnn2", "mlp", "mlp", "lenet5", "cnn2", "mlp"],
}


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, tree)


def _jax_market(archs, seed=0):
    """Clients drawn by the port's init (cheaper than the reference's eager
    init), in the reference's layouts as numpy trees."""
    g = torch.Generator().manual_seed(seed)
    applies = [partial(jax_cnn_apply, a) for a in archs]
    return applies, [params_to_jax(a, init_cnn(g, a, CLASSES, SHAPE)) for a in archs]


def _port_market(archs, jparams):
    return [partial(cnn_apply, a) for a in archs], [params_from_jax(a, _np(p)) for a, p in zip(archs, jparams)]


def _images(seed=7, b=4):
    return np.random.RandomState(seed).randn(b, *SHAPE).astype(np.float32)


def _max_diff(a, b):
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if not torch.is_tensor(fa[k]):
            assert fa[k] == fb[k], k
    return max(float((fa[k] - fb[k]).abs().max()) for k in fa if torch.is_tensor(fa[k]))


# ---------------------------------------------------------------------------
# the stacked logits


@pytest.mark.parametrize("market", sorted(MARKETS))
def test_grouped_matches_looped_and_jax(market):
    archs = MARKETS[market]
    japplies, jparams = _jax_market(archs)
    applies, params = _port_market(archs, jparams)
    x = _images()
    want = np.asarray(jax_make_ensemble(japplies, jparams, impl="looped")[0](tuple(jparams), jnp.asarray(x)))
    grp_fn, grp_p = make_ensemble(applies, params)
    loop_fn, loop_p = make_ensemble(applies, params, impl="looped")
    got = grp_fn(grp_p, torch.from_numpy(x))
    assert got.shape == (len(archs), 4, CLASSES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), loop_fn(loop_p, torch.from_numpy(x)).numpy(), rtol=0, atol=TOL)
    # each row is its own client's logits: the stack comes back in client order
    for k, (f, p) in enumerate(zip(applies, params)):
        np.testing.assert_allclose(got[k].numpy(), f(p, torch.from_numpy(x)).numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("market", sorted(JAX_BANK_MARKETS))
def test_grouped_matches_jax_grouped_on_carried_bank_params(market):
    archs = JAX_BANK_MARKETS[market]
    japplies, jparams = _jax_market(archs)
    jbank, jbank_params = JaxClientBank.build(japplies, jparams)
    x = _images(3)
    want = np.asarray(jbank.logits_all(jbank_params, jnp.asarray(x)))
    bank, own = ClientBank.build(*_port_market(archs, jparams))
    starts = np.cumsum((0,) + jbank.counts[:-1])
    carried = bank_params_from_jax([archs[jbank.order[s]] for s in starts], _np(jbank_params))
    for a, b in zip(carried, own):
        assert _max_diff(a, b) == 0.0
    got = bank.logits_all(carried, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("market", sorted(JAX_BANK_MARKETS))
def test_grouping_and_order_equal_jax(market):
    archs = JAX_BANK_MARKETS[market]
    japplies, jparams = _jax_market(archs)
    jbank, _ = JaxClientBank.build(japplies, jparams)
    applies, params = _port_market(archs, jparams)
    bank, bank_params = ClientBank.build(applies, params)
    assert (bank.counts, bank.order, bank.num_groups) == (jbank.counts, jbank.order, jbank.num_groups)
    assert bank.num_clients == len(archs) and bank.is_client_ordered == jbank.is_client_ordered
    assert (bank.inverse is None) == bank.is_client_ordered
    # params round-trip in client order and regroup to the same stacked layout
    for p0, p1 in zip(params, bank.unstack_params(bank_params)):
        assert _max_diff(p0, p1) == 0.0
    for a, b in zip(bank_params, bank.stack_params(params)):
        assert _max_diff(a, b) == 0.0
    for k, a in enumerate(archs):
        assert bank.client_apply(k).args == (a,)


def test_grouped_calls_each_apply_once_per_group():
    """The O(#groups) claim, as the reference's trace-count pin: the
    grouped forward calls each group's apply once (vmap runs the body once
    for the whole group), the looped one once per client."""
    archs = ["mlp", "cnn2"] * 3
    calls = []

    def counting_apply(arch, p, x):
        calls.append(arch)
        return cnn_apply(arch, p, x)

    _, jparams = _jax_market(archs)
    _, params = _port_market(archs, jparams)
    applies = [partial(counting_apply, a) for a in archs]
    x = torch.from_numpy(_images())
    for impl, want in (("grouped", 2), ("looped", 6)):
        fn, p = make_ensemble(applies, params, impl=impl)
        calls.clear()
        fn(p, x)
        assert len(calls) == want, impl


def test_unhashable_applies_become_singletons():
    _, jparams = _jax_market(["mlp", "mlp"])
    _, params = _port_market(["mlp", "mlp"], jparams)
    applies = [lambda p, x: cnn_apply("mlp", p, x), lambda p, x: cnn_apply("mlp", p, x)]
    bank, bank_params = ClientBank.build(applies, params)
    assert bank.num_groups == 2
    x = torch.from_numpy(_images())
    want = torch.stack([f(p, x) for f, p in zip(applies, params)])
    torch.testing.assert_close(bank.logits_all(bank_params, x), want, rtol=0, atol=TOL)


def test_input_gradient_matches_looped_and_jax_and_spares_the_params():
    """The generator and DHS differentiate the stack with respect to x; the
    bank's stacked params are detached and receive nothing."""
    archs = MARKETS["mixed_miniresnet"]
    japplies, jparams = _jax_market(archs)
    applies, params = _port_market(archs, jparams)
    x = _images(11)
    jloop, jp = jax_make_ensemble(japplies, jparams, impl="looped")
    want = np.asarray(jax.jit(jax.grad(lambda xx: jnp.sum(jloop(jp, xx) ** 2)))(jnp.asarray(x)))
    grads = {}
    for impl in ENSEMBLE_IMPLS:
        fn, p = make_ensemble(applies, params, impl=impl)
        xt = torch.from_numpy(x).requires_grad_()
        (grads[impl],) = torch.autograd.grad(torch.sum(fn(p, xt) ** 2), xt)
        if impl == "grouped":
            leaves = tree_leaves(list(p))
            assert leaves and not any(t.requires_grad or t.grad is not None for t in leaves)
    np.testing.assert_allclose(grads["grouped"].numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(grads["grouped"].numpy(), grads["looped"].numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 8])
def test_scan_chunk_matches_one_vmap(chunk):
    """A group of 5 cnn5 clients next to a group of 2 mlps, evaluated in
    chunks of ``chunk`` clients (the last chunk short where 5 % chunk)."""
    archs = ["cnn5"] * 5 + ["mlp"] * 2
    _, jparams = _jax_market(archs)
    applies, params = _port_market(archs, jparams)
    x = torch.from_numpy(_images(13))
    base_fn, base_p = make_ensemble(applies, params)
    fn, p = make_ensemble(applies, params, scan_chunk=chunk)
    torch.testing.assert_close(fn(p, x), base_fn(base_p, x), rtol=0, atol=TOL)


def test_mixed_dtype_market_gives_an_f32_stack():
    """A bf16 client next to f32 ones: both engines give the same f32
    stack, each row its own client's output cast to f32."""
    archs = ["mlp", "mlp", "cnn2"]
    _, jparams = _jax_market(archs)
    applies, params = _port_market(archs, jparams)
    params[1] = {k: v.to(torch.bfloat16) for k, v in params[1].items()}
    applies[1] = lambda p, x: cnn_apply("mlp", p, x.to(torch.bfloat16))
    x = torch.from_numpy(_images(2))
    stacks = {}
    for impl in ENSEMBLE_IMPLS:
        fn, p = make_ensemble(applies, params, impl=impl)
        stacks[impl] = fn(p, x)
        assert stacks[impl].dtype == torch.float32
        torch.testing.assert_close(stacks[impl][1], applies[1](params[1], x).float(), rtol=0, atol=0)
    torch.testing.assert_close(stacks["grouped"], stacks["looped"], rtol=0, atol=TOL)


def test_unknown_impl_and_bad_chunk_raise():
    _, jparams = _jax_market(["mlp"])
    applies, params = _port_market(["mlp"], jparams)
    with pytest.raises(ValueError, match="unknown ensemble impl"):
        make_ensemble(applies, params, impl="vmapped")
    with pytest.raises(ValueError, match="unknown ensemble impl"):
        OFLConfig(ensemble_impl="vmapped")
    with pytest.raises(ValueError, match="ensemble_scan_chunk"):
        OFLConfig(ensemble_scan_chunk=-1)
    with pytest.raises(SystemExit):
        ofl.parse_args(["--ensemble-impl", "vmapped"])
    assert ENSEMBLE_IMPLS == ("grouped", "looped")
    assert OFLConfig().ensemble_impl == JaxOFLConfig().ensemble_impl == ofl.parse_args([]).ensemble_impl == "grouped"
    assert OFLConfig().ensemble_scan_chunk == JaxOFLConfig().ensemble_scan_chunk == 0


def test_tree_stack_keeps_equal_non_tensor_leaves_and_refuses_others():
    g = torch.Generator().manual_seed(0)
    a, b = (init_cnn(g, "miniresnet", CLASSES, SHAPE) for _ in range(2))
    stacked = tree_stack([a, b])
    assert stacked["b2"]["stride"] == 2 and stacked["stem"].shape == (2, *a["stem"].shape)
    back = tree_unstack(stacked, 2)
    assert _max_diff(back[0], a) == 0.0 and _max_diff(back[1], b) == 0.0
    b["b2"]["stride"] = 1
    with pytest.raises(ValueError, match="non-tensor leaves differ"):
        tree_stack([a, b])


# ---------------------------------------------------------------------------
# grouped local training and the grouped market


@pytest.mark.parametrize(
    "sizes,batch,seed,epochs",
    [([37, 64, 19], 16, 3, 2), ([5], 8, 0, 1), ([8, 8, 24, 3], 8, 11, 3)],
)
def test_group_schedule_equals_jax(sizes, batch, seed, epochs):
    got = _group_schedule(sizes, batch, seed, epochs)
    want = jax_group_schedule(sizes, batch, seed, epochs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _shards(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, *SHAPE).astype(np.float32), rng.randint(0, CLASSES, n)) for n in sizes]


@pytest.mark.parametrize("arch", ["mlp", "cnn5"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_local_train_group_matches_local_train(arch, clip):
    """Partial batches (37 and 19 at batch 16) and unequal step counts:
    each client of the group ends where its own ``local_train`` ends, and
    that where the reference's ``local_train`` ends (with its clip)."""
    sizes = [37, 64, 19]
    shards = _shards(sizes)
    kw = dict(optimizer="sgdm", learning_rate=0.01, momentum=0.9, batch_size=16, seed=3, grad_clip_norm=clip)
    tc = TrainConfig(**kw)
    _, jinits = _jax_market([arch] * 3, seed=1)
    inits = [params_from_jax(arch, _np(p)) for p in jinits]
    apply = partial(cnn_apply, arch)
    seq = [local_train(apply, p0, x, y, tc, 2) for p0, (x, y) in zip(inits, shards)]
    grp = tree_unstack(local_train_group(apply, tree_stack(inits), shards, tc, 2), 3)
    for a, b in zip(seq, grp):
        assert _max_diff(a, b) < TOL
    want = jax_local_train(partial(jax_cnn_apply, arch), jinits[2], *shards[2], JaxTrainConfig(**kw), epochs=2)
    assert _max_diff(seq[2], params_from_jax(arch, _np(want))) < TOL


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_local_train_group_first_step_with_a_stride_leaf(clip):
    """miniresnet's ``"stride"`` int is held out of the vmapped gradient and
    passed through. One step a client (shards of 16, 9 and 5 at batch 16,
    two of them partial): its ReLUs and GroupNorms turn the grouped
    forward's rounding (1e-6 at logits of size ~5) into a kink flipped now
    and then over many steps, which moved a parameter by 1.6e-4 after four
    steps in one draw, so the arithmetic is held at the step itself."""
    shards = _shards([16, 9, 5], seed=2)
    tc = TrainConfig(optimizer="sgdm", learning_rate=0.01, momentum=0.9, batch_size=16, seed=3, grad_clip_norm=clip)
    _, jinits = _jax_market(["miniresnet"] * 3, seed=1)
    inits = [params_from_jax("miniresnet", _np(p)) for p in jinits]
    apply = partial(cnn_apply, "miniresnet")
    grp = tree_unstack(local_train_group(apply, tree_stack(inits), shards, tc, 1), 3)
    for p0, (x, y), got in zip(inits, shards, grp):
        assert got["b2"]["stride"] == 2 and not torch.is_tensor(got["b2"]["stride"])
        assert _max_diff(local_train(apply, p0, x, y, tc, 1), got) < TOL


@pytest.mark.parametrize("arch", ["mlp", "cnn5"])
def test_local_train_group_matches_jax_group(arch):
    sizes = [21, 40, 9]
    shards = _shards(sizes, seed=4)
    kw = dict(optimizer="sgdm", learning_rate=0.02, momentum=0.9, batch_size=16, seed=5)
    _, jinits = _jax_market([arch] * 3, seed=2)
    want = jax_tree_unstack(
        jax_local_train_group(partial(jax_cnn_apply, arch), jax_tree_stack(jinits), shards, JaxTrainConfig(**kw), 2), 3
    )
    inits = tree_stack([params_from_jax(arch, _np(p)) for p in jinits])
    got = tree_unstack(local_train_group(partial(cnn_apply, arch), inits, shards, TrainConfig(**kw), 2), 3)
    for g, w in zip(got, want):
        assert _max_diff(g, params_from_jax(arch, _np(w))) < TOL


def test_build_market_grouped_matches_build_market():
    """The same partition and inits (one generator, client order) and each
    client's own batches: the grouped market ends where the looped one
    does."""
    x, y = make_synth_images(0, CLASSES, 12, SHAPE)
    cfg = OFLConfig(num_clients=4, local_epochs=2, local_batch_size=16)
    archs = ["cnn5", "mlp", "cnn5", "miniresnet"]
    applies, params, sizes, parts = build_market(0, x, y, cfg, CLASSES, archs=archs, device="cpu")
    bank, bank_params, gsizes, gparts = build_market_grouped(0, x, y, cfg, CLASSES, archs=archs, device="cpu")
    assert gsizes == sizes and all(np.array_equal(a, b) for a, b in zip(parts, gparts))
    assert bank.counts == (2, 1, 1) and bank.order == (0, 2, 1, 3)
    for k, p in enumerate(bank.unstack_params(bank_params)):
        assert bank.client_apply(k).args == (archs[k],) and applies[k].args == (archs[k],)
        assert _max_diff(p, params[k]) < TOL
    with pytest.raises(ValueError, match="client archs"):
        build_market_grouped(0, x, y, cfg, CLASSES, archs=["cnn5"], device="cpu")


# ---------------------------------------------------------------------------
# one fused Co-Boosting epoch on a heterogeneous market

EPOCH_ARCHS = ["cnn5", "mlp", "cnn5"]
EPOCH_CFG = dict(num_clients=3, epochs=1, gen_iters=2, batch_size=8, latent_dim=8, buffer_batches=2, seed=0)


@pytest.fixture(scope="module")
def jax_grouped_epoch():
    """The reference's fused epoch (``backend="ref"``) over its grouped bank;
    its initial parameters, its draws by its own key chain, and its state."""
    jcfg = JaxOFLConfig(**EPOCH_CFG, backend=BackendPolicy(default="ref"))
    japplies, jclients = _jax_market(EPOCH_ARCHS, seed=20)
    g = torch.Generator().manual_seed(77)
    server = params_to_jax("cnn5", init_cnn(g, "cnn5", CLASSES, SHAPE))
    gen = params_to_jax("image_generator", init_image_generator(g, jcfg.latent_dim, CLASSES, SHAPE))
    gen_apply = lambda p, z, y: jax_image_generator(p, z, y, SHAPE)
    logits_all, bank_params = jax_make_ensemble(japplies, jclients, impl="grouped")
    step, gen_opt, srv_opt = jax_make_coboost_epoch(
        logits_all, partial(jax_cnn_apply, "cnn5"), gen_apply, jcfg, 3, CLASSES
    )
    buf = jax_buffer_init(jcfg.buffer_batches, (jcfg.batch_size, *SHAPE))
    key, steps = jax.random.key(0), jnp.zeros((), jnp.int32)
    order, n_valid = jax_distill_schedule(0, jcfg.buffer_batches)
    keys = jax.random.split(key, 4)
    z, y = _sample_zy(keys[1], jcfg.batch_size, jcfg.latent_dim, CLASSES)
    u_shape = (jcfg.batch_size, CLASSES)
    draws = [("zy", (np.asarray(z), np.asarray(y))),
             ("direction", np.asarray(jax.random.uniform(keys[2], u_shape, jnp.float32, -1.0, 1.0)))]
    kk = keys[3]
    for _ in range(int(n_valid)):
        kk, kb = jax.random.split(kk)
        draws.append(("direction", np.asarray(jax.random.uniform(kb, u_shape, jnp.float32, -1.0, 1.0))))
    sp, _, gp, _, w, buf, *_ = step(
        server, srv_opt.init(server), gen, gen_opt.init(gen), jax_uniform_weights(3), buf, key, steps,
        order, n_valid, bank_params,
    )
    init = {"clients": [_np(c) for c in jclients], "server": _np(server), "generator": _np(gen)}
    state = {"server": _np(sp), "generator": _np(gp), "w": np.asarray(w), "buf_x": np.asarray(buf.x),
             "buf_y": np.asarray(buf.y)}
    return init, draws, state


def test_coboosting_epoch_grouped_matches_looped_and_jax_grouped(jax_grouped_epoch):
    init, draws, want = jax_grouped_epoch
    states = {}
    for impl in ENSEMBLE_IMPLS:
        cfg = OFLConfig(**EPOCH_CFG, ensemble_impl=impl)
        replay = ReplayDraws(draws, "cpu")
        applies, clients = _port_market(EPOCH_ARCHS, init["clients"])
        states[impl] = run_coboosting(
            applies, clients, partial(cnn_apply, "cnn5"), params_from_jax("cnn5", init["server"]),
            lambda p, z, y: image_generator(p, z, y, SHAPE), params_from_jax("image_generator", init["generator"]),
            cfg, CLASSES, replay,
        )
        assert not replay.items, "the port drew fewer values than the reference"
    for impl, st in states.items():
        np.testing.assert_allclose(st.buffer.x.numpy(), want["buf_x"], rtol=0, atol=EPOCH_TOL["buffer"], err_msg=impl)
        np.testing.assert_array_equal(st.buffer.y.numpy(), want["buf_y"])
        np.testing.assert_allclose(st.weights.numpy(), want["w"], rtol=0, atol=EPOCH_TOL["w"], err_msg=impl)
        assert _max_diff(st.server_params, params_from_jax("cnn5", want["server"])) < EPOCH_TOL["server"]
        assert _max_diff(st.gen_params, params_from_jax("image_generator", want["generator"])) < EPOCH_TOL["generator"]
    grouped, looped = states["grouped"], states["looped"]
    np.testing.assert_allclose(grouped.weights.numpy(), looped.weights.numpy(), rtol=0, atol=EPOCH_TOL["w"])
    assert _max_diff(grouped.server_params, looped.server_params) < EPOCH_TOL["server"]


# ---------------------------------------------------------------------------
# the launcher


@pytest.mark.parametrize(
    "flags,builds",
    [
        ([], 2),  # the default: the bank in the Co-Boosting driver and in evaluation
        (["--ensemble-impl", "looped"], 0),
        (["--ensemble-impl", "looped", "--grouped-market"], 1),  # the market's own bank
        (["--grouped-market", "--ensemble-scan-chunk", "1"], 3),
    ],
)
def test_launcher_ensemble_flags(monkeypatch, flags, builds):
    built = []
    build = ClientBank.build.__func__

    def counting_build(cls, *a, **kw):
        built.append(kw.get("scan_chunk", 0))
        return build(cls, *a, **kw)

    monkeypatch.setattr(ClientBank, "build", classmethod(counting_build))
    result = ofl.main([
        "--method", "coboosting", "--device", "cpu", "--clients", "3", "--client-archs", "cnn2,mlp,cnn2",
        "--classes", "3", "--image", "8", "--per-class", "12", "--epochs", "1", "--gen-iters", "2",
        "--batch", "8", "--local-epochs", "1", *flags,
    ])
    assert len(built) == builds
    if "--ensemble-scan-chunk" in flags:
        assert built == [1, 0, 1]  # the market, evaluation (whole groups) and the driver
    assert 0.0 <= result["server_acc"] <= 1.0 and 0.0 <= result["ensemble_acc"] <= 1.0
    assert np.isfinite(result["gen_loss"]) and np.isfinite(result["distill_loss"])
