"""The last public names of the port (``sample_difficulty``,
``data_amount_weights``, ``make_logits_all_stacked``, ``ensemble_accuracy``,
the ring's ``logical_to_slot`` and ``buffer_as_lists``, ``OFLState``'s
``buffer_x``/``buffer_y``/``dispatch_count``, ``run_coboosting(init_weights=)``,
``avg_pool_global``, ``make_cnn``, ``layer_norm``, ``make_lm_distill_batch``,
the tree helpers, ``ASSIGNED_ARCHS``) against the JAX package, and a check
that every public name of ``src/repro`` has its twin in ``src/repro_torch``.

Inputs are made from a seed with numpy and fed to both sides; weights cross
through ``repro_torch.convert``. Tolerances: the functions 1e-6 relative
(f32 on the CPU); the ring's slots and lists, the tree helpers (on dyadic
values, whose sums, squares and casts are exact in f32 and bf16), the
numpy batch and the arch list exactly. Two Co-Boosting epochs from
``data_amount_weights`` and one DENSE run against the reference's
``run_coboosting`` and ``run_generator_baseline`` (``backend="ref"``, the
looped ensemble on both sides) on replayed draws, at
``tests/test_torch_epoch.py``'s ``TOL``.

The name check reads both packages' files with ``ast`` and imports nothing.
For each module of ``src/repro`` it takes the public names the module
defines (``def``, ``class``, a top-level assignment) and, for an
``__init__.py``, its ``__all__``, and looks each up among the names the
port's twin module binds, imports included. ``DELIBERATE`` lists the
omissions, each with its reason; an entry no longer missing fails too.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.train import OFLConfig as JaxOFLConfig
from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED_ARCHS
from repro.core import buffer as jax_buffer
from repro.core.baselines import run_generator_baseline as jax_run_generator_baseline
from repro.core.coboosting import default_image_setup as jax_default_image_setup
from repro.core.coboosting import run_coboosting as jax_run_coboosting
from repro.core.ensemble import data_amount_weights as jax_data_amount_weights
from repro.core.ensemble import ensemble_accuracy as jax_ensemble_accuracy
from repro.core.ensemble import make_logits_all as jax_make_logits_all
from repro.core.ensemble import make_logits_all_stacked as jax_make_logits_all_stacked
from repro.core.epoch import _sample_zy
from repro.core.hardness import sample_difficulty as jax_sample_difficulty
from repro.data.synthetic import make_lm_distill_batch as jax_make_lm_distill_batch
from repro.kernels.dispatch import BackendPolicy
from repro.models.cnn import avg_pool_global as jax_avg_pool_global
from repro.models.cnn import cnn_apply as jax_cnn_apply
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.models.cnn import make_cnn as jax_make_cnn
from repro.models.layers import layer_norm as jax_layer_norm
from repro.utils import trees as jax_trees
from repro_torch.config.train import OFLConfig
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import buffer as port_buffer
from repro_torch.core import (
    data_amount_weights,
    ensemble_accuracy,
    make_logits_all_stacked,
    run_coboosting,
    run_generator_baseline,
    sample_difficulty,
)
from repro_torch.data import make_lm_distill_batch
from repro_torch.models import make_cnn
from repro_torch.models.cnn import CNN_ARCHS, avg_pool_global, cnn_apply, init_cnn
from repro_torch.models.generator import image_generator
from repro_torch.models.layers import layer_norm
from repro_torch.utils import trees
from repro_torch.utils.prng import ReplayDraws

from test_torch_epoch import TOL, _max_diff, _np

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
RTOL = 1e-6
CLASSES, SHAPE, K = 4, (8, 8, 3), 3
SIZES = [50, 30, 20]
RUN_CFG = dict(num_clients=K, epochs=2, gen_iters=2, batch_size=8, latent_dim=8, buffer_batches=2, seed=0,
               ensemble_impl="looped")

_LEGACY = "a piece of the legacy driver (driver='legacy'), deprecated and failing its own parity pin; not ported"
_PALLAS = "a Pallas TPU kernel entry; the port's kernel is hand-written CUDA C++ behind the same wrapper"
_DRAWS = "JAX-key plumbing; the port's draw seam (utils/prng.py Draws, ReplayDraws) replaces it"
_MESH = "a jax.sharding shim or spec helper; DTensor placements take its place (launch/specs.py _placed_batch)"
_BACKEND = "the deprecated per-op backend aliases; the port takes a BackendPolicy (or a string) only"
DELIBERATE = {
    "PRNGStream": _DRAWS,
    "split_like": _DRAWS,
    "start_jax_profile": "starts jax.profiler; the port's profile is torch.profiler (obs.start_torch_profile)",
    "stop_jax_profile": "stops jax.profiler; the port's profile is torch.profiler (obs.stop_torch_profile)",
    "flash_attn_jax": "the blocked jnp attention of the JAX package; the port's plain path is SDPA-free torch",
    "make_generator_phase": _LEGACY,
    "make_distill_step": _LEGACY,
    "make_ee_step": _LEGACY,
    "make_static_generator": "returns a jitted static program; the port's static_generate runs eagerly",
    "kernel_arm": _BACKEND,
    "policy_from_flags": _BACKEND,
    "resolve_backend": _BACKEND,
    "ensemble_kl_pallas": _PALLAS,
    "ensemble_kl_bwd_pallas": _PALLAS,
    "ghm_ce_pallas": _PALLAS,
    "ghm_ce_bwd_pallas": _PALLAS,
    "flash_attention_pallas": _PALLAS,
    "flash_attention_bwd_pallas": _PALLAS,
    "flash_decode_pallas": _PALLAS,
    "NEG": "the Pallas kernels' -1e30 mask value; the CUDA sources define their own",
    "DEFAULT_Q_BLOCK": "a Pallas block default; the CUDA kernels pick their tiles themselves",
    "DEFAULT_KV_BLOCK": "a Pallas block default; the CUDA kernels pick their tiles themselves",
    "kernels/tiling.py": "pads to the TPU (8, 128) tile; the CUDA kernels mask tails instead",
    "roofline/hlo_cost.py": "walks XLA HLO text; the port counts ops as dispatched (roofline/op_cost.py)",
    "V5E": "the TPU v5e's constants; H100 is the port's only HardwareSpec",
    "compat_mesh": _MESH,
    "compat_make_mesh": _MESH,
    "SDS": _MESH,
    "batch_shardings": _MESH,
    "replicated": _MESH,
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.as_tensor(np.asarray(a))



# ---------------------------------------------------------------------------
# the functions


def test_sample_difficulty_matches_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(37, 11) * 3).astype(np.float32)
    labels = rng.randint(0, 11, 37).astype(np.int32)
    got = sample_difficulty(_t(logits), _t(labels))
    assert got.dtype == torch.float32 and got.shape == (37,)
    assert _rel(got, jax_sample_difficulty(jnp.asarray(logits), jnp.asarray(labels))) < RTOL


@pytest.mark.parametrize("sizes", [[5, 3, 2], [120, 7, 33, 1]])
def test_data_amount_weights_match_jax(sizes):
    got = data_amount_weights(sizes)
    assert got.dtype == torch.float32
    assert _rel(got, jax_data_amount_weights(sizes)) < RTOL


def test_ensemble_accuracy_matches_jax():
    rng = np.random.RandomState(1)
    la = rng.randn(4, 64, 10).astype(np.float32)
    w = rng.dirichlet(np.ones(4)).astype(np.float32)
    labels = rng.randint(0, 10, 64).astype(np.int32)
    got = ensemble_accuracy(_t(la), _t(w), _t(labels))
    want = jax_ensemble_accuracy(jnp.asarray(la), jnp.asarray(w), jnp.asarray(labels))
    assert 0.0 < float(want) < 1.0
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("arch", ["cnn2", "miniresnet"])
def test_make_logits_all_stacked_matches_jax(arch):
    """Random clients carried to JAX: cnn2 against the reference's vmap over
    its stacked tree; miniresnet (whose ``"stride"`` ints the port's stack
    shares, the reference's stacks into arrays its convolutions refuse)
    against its loop."""
    clients = [init_cnn(torch.Generator().manual_seed(30 + i), arch, CLASSES, SHAPE) for i in range(K)]
    jclients = [params_to_jax(arch, c) for c in clients]
    x = np.random.RandomState(2).uniform(-1, 1, (5, *SHAPE)).astype(np.float32)
    apply = partial(jax_cnn_apply, arch)
    if arch == "cnn2":
        want = jax.jit(jax_make_logits_all_stacked(apply))(jax_trees.tree_stack(jclients), jnp.asarray(x))
    else:
        # the params closed over, so that the strides stay Python ints under jit
        want = jax.jit(lambda x_: jax_make_logits_all([apply] * K)(jclients, x_))(jnp.asarray(x))
    got = make_logits_all_stacked(partial(cnn_apply, arch))(trees.tree_stack(clients), _t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (K, 5, CLASSES)
    assert _rel(got, want) < RTOL


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 48) * 2 + 0.5).astype(np.float32)
    scale, bias = (rng.randn(2, 48) * 0.1).astype(np.float32)
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    assert _rel(layer_norm(_t(x), _t(scale), _t(bias)), want) < RTOL
    got = layer_norm(_t(x).bfloat16(), _t(scale), _t(bias))
    assert got.dtype == torch.bfloat16
    want = jax_layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_avg_pool_global_matches_jax():
    x = np.random.RandomState(4).randn(3, 6, 5, 7).astype(np.float32)
    got = avg_pool_global(_t(x))
    assert tuple(got.shape) == (3, 7)
    assert _rel(got, jax_avg_pool_global(jnp.asarray(x))) < RTOL


@pytest.mark.parametrize("arch", CNN_ARCHS)
def test_make_cnn_matches_jax(arch):
    """The reference's init, carried across, through the port's apply; the
    port's init equals ``init_cnn`` from the same generator."""
    jinit, japply = jax_make_cnn(arch, CLASSES, SHAPE)
    init, apply = make_cnn(arch, CLASSES, SHAPE)
    jparams = jinit(jax.random.key(9))
    x = np.random.RandomState(5).uniform(-1, 1, (4, *SHAPE)).astype(np.float32)
    got = apply(params_from_jax(arch, _np(jparams)), _t(x))
    assert _rel(got, jax.jit(lambda x_: japply(jparams, x_))(jnp.asarray(x))) < RTOL
    mine = trees.flatten_dict(init(torch.Generator().manual_seed(3)))
    ref = trees.flatten_dict(init_cnn(torch.Generator().manual_seed(3), arch, CLASSES, SHAPE))
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(mine[k], v) if torch.is_tensor(v) else mine[k] == v


def test_make_lm_distill_batch_is_the_references():
    got = make_lm_distill_batch(11, 3, 7, 16, 100)
    want = jax_make_lm_distill_batch(11, 3, 7, 16, 100)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_assigned_archs_are_the_references():
    assert ASSIGNED_ARCHS == JAX_ASSIGNED_ARCHS


# ---------------------------------------------------------------------------
# the ring


@pytest.mark.parametrize("capacity", [1, 2, 3, 4])
def test_ring_slots_and_lists_match_jax(capacity):
    jbuf = jax_buffer.buffer_init(capacity, (2,), jnp.float32)
    buf = port_buffer.buffer_init(capacity, (2,))
    for n in range(8):
        ptr, size = int(jbuf.ptr), int(jbuf.size)
        assert (buf.ptr, buf.size) == (ptr, size)
        for i in range(size):
            assert port_buffer.logical_to_slot(i, ptr, size, capacity) == jax_buffer.logical_to_slot(i, ptr, size, capacity)
        idx = np.arange(size)
        np.testing.assert_array_equal(
            port_buffer.logical_to_slot(torch.as_tensor(idx), ptr, size, capacity).numpy(),
            np.asarray(jax_buffer.logical_to_slot(jnp.asarray(idx), ptr, size, capacity)),
        )
        got_x, got_y = port_buffer.buffer_as_lists(buf)
        want_x, want_y = jax_buffer.buffer_as_lists(jbuf)
        assert len(got_x) == len(got_y) == len(want_x) == size
        for gx, gy, wx, wy in zip(got_x, got_y, want_x, want_y):
            np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
            np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
        if n == 7:
            break
        x, y = np.full((2,), n + 0.5, np.float32), np.full((2,), n, np.int32)
        jbuf = jax_buffer.buffer_append(jbuf, jnp.asarray(x), jnp.asarray(y))
        buf = port_buffer.buffer_append(buf, _t(x), _t(y).long())


# ---------------------------------------------------------------------------
# the tree helpers


def _dyadic(rng, shape):
    return (rng.randint(-8, 9, shape) / 4.0).astype(np.float32)


def _jax_tree(seed=6):
    rng = np.random.RandomState(seed)
    return {
        "z": {"w": _dyadic(rng, (3, 2, 4)), "b": _dyadic(rng, (3, 4))},
        "a": _dyadic(rng, (3, 5)),
        "layers": [{"x": _dyadic(rng, (3, 2))}, {"x": _dyadic(rng, (3, 2)), "n": np.arange(3, dtype=np.int32)}],
    }


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_tree(v) for v in tree]
    return torch.as_tensor(np.asarray(tree))


def _flat(tree):
    """path -> float32 numpy, over either package's tree."""
    return {p: np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x).astype(jnp.float32))
            for p, x in (trees.iter_leaves_with_path(tree) if _is_port(tree) else jax_trees.iter_leaves_with_path(tree))}


def _is_port(tree):
    return any(torch.is_tensor(x) for x in trees.tree_leaves(tree))


def _same(got, want):
    g, w = _flat(got), _flat(want)
    assert list(g) == list(w)
    for p in w:
        assert g[p].shape == w[p].shape, p
        np.testing.assert_array_equal(g[p], w[p], err_msg=p)


def test_tree_paths_and_leaves_are_the_references():
    jt = _jax_tree()
    pt = _port_tree(jt)
    assert trees.tree_paths(pt) == jax_trees.tree_paths(jt)
    assert [p for p, _ in trees.iter_leaves_with_path(pt)] == [p for p, _ in jax_trees.iter_leaves_with_path(jt)]
    # a residual block's "stride" ints are leaves of both, at the same paths
    jres = jax_init_cnn(jax.random.key(0), "miniresnet", CLASSES, SHAPE)
    pres = params_from_jax("miniresnet", _np(jres))
    assert trees.tree_paths(pres) == jax_trees.tree_paths(jres)
    assert "b2/stride" in trees.tree_paths(pres)


@pytest.mark.parametrize("helper", ["map_with_path", "index", "zeros_like", "cast", "add", "scale", "l2_norm"])
def test_tree_helpers_match_jax(helper):
    jt, jt2 = _jax_tree(6), _jax_tree(7)
    pt, pt2 = _port_tree(jt), _port_tree(jt2)
    if helper == "map_with_path":
        _same(trees.tree_map_with_path(lambda p, x: x * len(p), pt),
              jax_trees.tree_map_with_path(lambda p, x: x * len(p), jt))
    elif helper == "index":
        _same(trees.tree_index(pt, 1), jax_trees.tree_index(jt, 1))
    elif helper == "zeros_like":
        got, want = trees.tree_zeros_like(pt), jax_trees.tree_zeros_like(jt)
        _same(got, want)
        assert [x.dtype for x in trees.tree_leaves(got)] == [x.dtype for x in trees.tree_leaves(pt)]
    elif helper == "cast":
        got, want = trees.tree_cast(pt, torch.bfloat16), jax_trees.tree_cast(jt, jnp.bfloat16)
        _same(got, want)
        dtypes = {p: str(x.dtype) for p, x in trees.iter_leaves_with_path(got)}
        assert dtypes["layers/1/n"] == "torch.int32" and dtypes["a"] == "torch.bfloat16"
    elif helper == "add":
        _same(trees.tree_add(pt, pt2), jax_trees.tree_add(jt, jt2))
    elif helper == "scale":
        _same(trees.tree_scale(pt, 0.25), jax_trees.tree_scale(jt, 0.25))
    else:
        got, want = trees.tree_l2_norm(pt), jax_trees.tree_l2_norm(jt)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(want)


# ---------------------------------------------------------------------------
# OFLState's ring views and run_coboosting(init_weights=...)


def coboost_draws(key, cfg, epochs, classes=CLASSES):
    """The reference's fused Co-Boosting draws by its own key chain (as
    ``tests/test_torch_epoch.py`` derives them), for ``ReplayDraws``."""
    draws, u_shape = [], (cfg.batch_size, classes)
    for epoch in range(epochs):
        keys = jax.random.split(key, 4)
        key = keys[0]
        z, y = _sample_zy(keys[1], cfg.batch_size, cfg.latent_dim, classes)
        draws.append(("zy", (np.asarray(z), np.asarray(y))))
        draws.append(("direction", np.asarray(jax.random.uniform(keys[2], u_shape, jnp.float32, -1.0, 1.0))))
        kk = keys[3]
        for _ in range(min(epoch + 1, cfg.buffer_batches)):
            kk, kb = jax.random.split(kk)
            draws.append(("direction", np.asarray(jax.random.uniform(kb, u_shape, jnp.float32, -1.0, 1.0))))
    return draws


def _dense_draws(key, cfg, epochs):
    draws = []
    for _ in range(epochs):
        keys = jax.random.split(key, 3)
        key = keys[0]
        z, y = _sample_zy(keys[1], cfg.batch_size, cfg.latent_dim, CLASSES)
        draws.append(("zy", (np.asarray(z), np.asarray(y))))
    return draws


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's run_coboosting from data_amount_weights(SIZES) and
    its DENSE run, two epochs each, from the reference's initial parameters
    of ``tests/test_torch_epoch.py`` (keys 20 + i, 77 and 5), carried
    across."""
    jcfg = JaxOFLConfig(**RUN_CFG, backend=BackendPolicy(default="ref"))
    clients = [jax_init_cnn(jax.random.key(20 + i), "cnn5", CLASSES, SHAPE) for i in range(K)]
    server = jax_init_cnn(jax.random.key(77), "cnn5", CLASSES, SHAPE)
    gen_apply, gen = jax_default_image_setup(jax.random.key(5), jcfg, CLASSES, SHAPE)
    init = {
        "clients": [params_from_jax("cnn5", _np(c)) for c in clients],
        "server": params_from_jax("cnn5", _np(server)),
        "generator": params_from_jax("image_generator", _np(gen)),
    }
    apply = partial(jax_cnn_apply, "cnn5")
    w0 = jax_data_amount_weights(SIZES)
    runs = {
        "coboosting": (jax_run_coboosting([apply] * K, clients, apply, server, gen_apply, gen, jcfg, CLASSES,
                                          jax.random.key(0), init_weights=w0),
                       coboost_draws(jax.random.key(0), jcfg, jcfg.epochs)),
        "dense": (jax_run_generator_baseline("dense", [apply] * K, clients, apply, server, gen_apply, gen, jcfg,
                                             CLASSES, jax.random.key(0)),
                  _dense_draws(jax.random.key(0), jcfg, jcfg.epochs)),
    }
    return init, runs


def _port_run(method, init, draws):
    cfg = OFLConfig(**RUN_CFG, backend="auto")
    replay = ReplayDraws(draws, "cpu")
    apply = partial(cnn_apply, "cnn5")
    init = trees.tree_map(torch.clone, init)
    args = ([apply] * K, init["clients"], apply, init["server"], lambda p, z, y: image_generator(p, z, y, SHAPE),
            init["generator"], cfg, CLASSES, replay)
    if method == "coboosting":
        state = run_coboosting(*args, init_weights=data_amount_weights(SIZES))
    else:
        state = run_generator_baseline(method, *args)
    assert not replay.items, "the port drew fewer values than the reference"
    return state


@pytest.mark.parametrize("method", ["coboosting", "dense"])
def test_runs_match_jax_with_their_ring_views(reference_runs, method):
    init, runs = reference_runs
    want, draws = runs[method]
    state = _port_run(method, init, draws)
    np.testing.assert_allclose(state.weights.numpy(), np.asarray(want.weights), rtol=0, atol=TOL["w"])
    if method == "coboosting":  # EE moved the weights off the data-amount start
        assert np.abs(np.asarray(want.weights) - np.asarray(SIZES) / sum(SIZES)).max() > 1e-3
    assert _max_diff(state.server_params, _np(want.server_params), "cnn5") < TOL["server"]
    assert _max_diff(init["server"], _np(want.server_params), "cnn5") > 1e-4  # the run moved the server
    assert _max_diff(state.gen_params, _np(want.gen_params), "image_generator") < TOL["generator"]
    assert state.dispatch_count == want.dispatch_count == RUN_CFG["epochs"]
    assert len(state.buffer_x) == len(state.buffer_y) == len(want.buffer_x) == RUN_CFG["buffer_batches"]
    for gx, gy, wx, wy in zip(state.buffer_x, state.buffer_y, want.buffer_x, want.buffer_y):
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0, atol=TOL["buffer"])
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


# ---------------------------------------------------------------------------
# every public name of src/repro has its twin


def _top_level(tree):
    """The module's statements outside any def or class (into if/try/with)."""
    out, todo = [], list(tree.body)
    while todo:
        node = todo.pop(0)
        out.append(node)
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                todo.extend(getattr(node, field, []))
        elif isinstance(node, ast.ExceptHandler):
            todo.extend(node.body)
    return out


def _targets(node):
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _targets(e)


def _defined(tree):
    names = set()
    for node in _top_level(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                names.update(_targets(t))
        elif isinstance(node, ast.AnnAssign):
            names.update(_targets(node.target))
    return names


def _all(tree):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return set()


def _imported(tree):
    return {(a.asname or a.name).split(".")[0]
            for node in _top_level(tree) if isinstance(node, (ast.Import, ast.ImportFrom)) for a in node.names}


def _bound(tree):
    return _defined(tree) | _imported(tree)


def _public(path):
    """The public names ``path`` defines; a name it also imports (an import
    with a fallback, ``except ImportError: X = None``) is an import."""
    tree = ast.parse(path.read_text())
    names = {n for n in _defined(tree) - _imported(tree) if not n.startswith("_")}
    return names | _all(tree) if path.name == "__init__.py" else names


def _missing():
    """{module path: sorted public names its port twin lacks}, a module the
    port lacks whole under its own path."""
    out = {}
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        names = _public(path)
        twin = PORT / rel
        if not twin.exists():
            if names:
                out[rel] = [rel]
            continue
        lacking = sorted(names - _bound(ast.parse(twin.read_text())))
        if lacking:
            out[rel] = lacking
    return out


def test_every_reference_name_has_a_twin_or_a_reason():
    missing = _missing()
    undeclared = {rel: [n for n in names if n not in DELIBERATE] for rel, names in missing.items()}
    undeclared = {rel: names for rel, names in undeclared.items() if names}
    assert not undeclared, f"public names of src/repro the port lacks, without a reason in DELIBERATE: {undeclared}"
    used = {n for names in missing.values() for n in names}
    assert set(DELIBERATE) == used, f"DELIBERATE entries the port no longer lacks: {sorted(set(DELIBERATE) - used)}"
    assert all(reason.strip() for reason in DELIBERATE.values())


@pytest.mark.parametrize("package", ["core", "data", "models", "optim", "utils", "config", "fed", "serve", "obs"])
def test_package_all_is_the_references_less_the_deliberate(package):
    want = _all(ast.parse((REF / package / "__init__.py").read_text())) - set(DELIBERATE)
    got = _all(ast.parse((PORT / package / "__init__.py").read_text()))
    assert want <= got, f"repro_torch.{package}.__all__ lacks {sorted(want - got)}"


def test_imports_build_no_kernel_and_import_no_jax():
    """A fresh interpreter imports the packages and the examples: no kernel
    library is built or loaded, and neither JAX nor the JAX package is
    imported."""
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.models, repro_torch.data, repro_torch.optim, "
        "repro_torch.utils, repro_torch.configs\n"
        "import repro_torch.examples.quickstart, repro_torch.examples.heterogeneous_clients, "
        "repro_torch.examples.serve_decode\n"
        "from repro_torch.kernels import build\n"
        "assert not build._LIBS, build._LIBS\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
