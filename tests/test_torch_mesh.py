"""The port's meshes (``repro_torch.launch.mesh``) and sharded execution on
CPU ranks.

* Topology under ``torch.distributed``'s fake process group (one process
  stands for a world of 8, 256 or 512 ranks; it builds meshes, it cannot
  check numbers), the port of ``tests/test_fleet.py``'s: a ragged fleet
  and 0 replicas raise; replica submeshes are disjoint; disaggregated
  halves are disjoint; a single-device replica gives ``pm is dm is one``.
  A production mesh is (16, 16) at 256 ranks and (2, 16, 16) at 512, and
  raises at any other world size.
* Multi-rank parity: ONE spawn of 4 gloo ranks (file rendezvous, one
  thread each, its own 120 s deadline; a hang kills the ranks and fails),
  while this process computes the JAX package's answers:

  (a) ``ServeEngine(mesh=...)`` over ``replica_meshes(make_fleet_mesh(1))[0]``
      (model = 4) and over a (1, 2) submesh, both KV layouts, on the
      reference's ``_mk`` config (4/2 heads, hd 8) and reduced smollm-135m
      in f32: greedy tokens equal to the meshless port engine's and the
      meshless JAX engine's on every request;
  (b) the same engine with a drafter (``spec_k = 2``): the same tokens;
      ``static_generate`` on the same mesh: the meshless generator's;
  (c) one sharded ``lm_prefill`` of reduced mixtral (experts over
      ``model``), jamba and xlstm-125m on a (1, 2) mesh: logits within
      1e-5 of the largest |logit| of the meshless port's, and within
      ``1e-4·(1 + |ref|)`` of JAX's;
  (d) 3 AdamW train steps on a (data 2, model 2) mesh: losses within 1e-5
      relative of the meshless port's and within ``1e-4·(1 + |ref|)`` of
      JAX's train step; every parameter, gathered, within
      ``1e-4·(1 + |ref|)`` of the meshless port's (the sharded reductions
      reorder f32 sums, so nothing is bitwise);
  (e) splits that cut, on the (2, 2) mesh: reduced mixtral with 3 experts
      (each rank holds half of every expert's width, its output a partial
      sum) and the ``_mk`` config with 3 query heads over 1 KV head (the
      projections' outputs split over ``model``, which cuts a head, and
      are made whole first): the prefill's logits as in (c), the loss and
      every gradient, gathered, within ``1e-4·(1 + |ref|)`` of the
      meshless port's and JAX's;
  (f) the LM distillation loss (Eq. 4, two reduced smollm-135m clients)
      on the (2, 2) mesh, whole and in sequence chunks of 8: the KL runs
      on each rank's vocabulary slice (``vocab_kl``); the loss and every
      gradient as in (e).

  Every param leaf under a mesh is a DTensor whose local shard has the
  shape its spec gives; the kernels and strategy-less ops ran through the
  ``local_map`` route.
"""
from __future__ import annotations

import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.config import ModelConfig as JaxModelConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.models import init_lm_state as jax_init_lm_state
from repro.core.distributed import coboost_distill_loss as jax_distill_loss
from repro.models import lm_loss as jax_lm_loss
from repro.models import lm_prefill as jax_lm_prefill
from repro.runtime import make_train_step as jax_make_train_step
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ManualClock as JaxManualClock
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.convert import lm_params_to_jax
from repro_torch.launch.mesh import disagg_submeshes, make_fleet_mesh, make_production_mesh, replica_meshes
from torch_mesh_ranks import (
    COBOOST_CHUNKS, ENGINE, GEN, MK, NAMES, PREFILL_ARCHS, RAGGED, TRAIN, WORLD, inputs, port_cfg, ragged_cfg,
    rank_main,
)

pytestmark = pytest.mark.tier1

DEADLINE_S = 120


# ---------------------------------------------------------------------------
# topology under the fake process group


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(n: int, rank: int = 0):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _ranks(mesh) -> set:
    return set(mesh.mesh.flatten().tolist())


def test_fleet_mesh_rejects_ragged_split(fake_world):
    fake_world(8)
    with pytest.raises(ValueError, match="divide"):
        make_fleet_mesh(9, device_type="cpu")
    with pytest.raises(ValueError, match="divide"):
        make_fleet_mesh(3, device_type="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_fleet_mesh(0, device_type="cpu")


@pytest.mark.parametrize("rank", [0, 5])
def test_fleet_mesh_topology(fake_world, rank):
    """On every rank (one inside replica 0, one outside it) the replica
    submeshes and their disaggregated halves partition the world."""
    fake_world(8, rank)
    fleet = make_fleet_mesh(2, device_type="cpu")
    assert fleet.mesh_dim_names == ("replica", "data", "model")
    assert tuple(fleet.mesh.shape) == (2, 1, 4)
    subs = replica_meshes(fleet)
    assert len(subs) == 2
    seen: set = set()
    for sub in subs:
        assert sub.mesh_dim_names == ("data", "model") and tuple(sub.mesh.shape) == (1, 4)
        ids = _ranks(sub)
        assert not ids & seen  # replicas are disjoint
        seen |= ids
        pmesh, dmesh = disagg_submeshes(sub)
        assert not _ranks(pmesh) & _ranks(dmesh) and _ranks(pmesh) | _ranks(dmesh) == ids
        assert tuple(pmesh.mesh.shape) == tuple(dmesh.mesh.shape) == (1, 2)
    assert seen == set(range(8))
    assert (subs[0].get_coordinate() is not None) == (rank < 4)
    # a single-device replica colocates rather than failing
    one = replica_meshes(make_fleet_mesh(8, device_type="cpu"))[0]
    pm, dm = disagg_submeshes(one)
    assert pm is dm is one


@pytest.mark.parametrize("world, multi_pod, shape", [(256, False, (16, 16)), (512, True, (2, 16, 16))])
def test_production_mesh_shapes(fake_world, world, multi_pod, shape):
    fake_world(world, rank=world - 1)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert tuple(mesh.mesh.shape) == shape
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
    fake_world(world // 2)
    with pytest.raises(SystemExit, match=str(world)):
        make_production_mesh(multi_pod=multi_pod, device_type="cpu")


# ---------------------------------------------------------------------------
# multi-rank parity: the parent


def _jax_cfg(name, **kw):
    if name == "mk":
        return JaxModelConfig(scan_layers=False, remat=False, **{**MK, **kw})
    return jax_reduced_variant(jax_get_arch(name)).replace(
        dtype="float32", param_dtype="float32", attn_backend="ref", decode_backend="ref", **kw
    )


def _jax_tokens(jcfg, jparams, prompts):
    eng = JaxServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), JaxEngineConfig(**ENGINE))
    comps = JaxScheduler(eng, clock=JaxManualClock()).run(
        [JaxRequest(rid=i, tokens=p, max_new_tokens=GEN) for i, p in enumerate(prompts)]
    )
    return [np.asarray(c.tokens).tolist() for c in comps]


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Spawn the 4 ranks; compute the JAX answers meanwhile, on the same
    weights (the port's, carried to JAX); join within the deadline (a hang
    kills the ranks and fails)."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    ctx = mp.start_processes(rank_main, args=(tmp,), nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        inp = inputs()
        jax_params = {name: lm_params_to_jax(port_cfg(name), p) for name, p in inp["params"].items()}
        ref = {"tokens": {}, "prefill": {}}
        for name in NAMES:
            ref["tokens"][name] = _jax_tokens(_jax_cfg(name), jax_params[name], inp["prompts"][name])
        for arch in PREFILL_ARCHS:
            jcfg = _jax_cfg(arch)
            tokens = jnp.asarray(inp["prefill_tokens"])
            logits, _ = jax_lm_prefill(jax_params[arch], jcfg, {"tokens": tokens}, jax_init_lm_state(jcfg, *tokens.shape))
            ref["prefill"][arch] = np.asarray(logits)
        ref["ragged"] = {}
        batch = {k: jnp.asarray(v) for k, v in inp["ragged_batch"].items()}
        for case, (name, kw) in RAGGED.items():
            jcfg = _jax_cfg(name, **kw)
            jp = jax.tree_util.tree_map(jnp.asarray, lm_params_to_jax(ragged_cfg(case), inp["ragged_params"][case]))
            logits, _ = jax_lm_prefill(jp, jcfg, {"tokens": batch["tokens"]}, jax_init_lm_state(jcfg, *batch["tokens"].shape))
            loss, grads = jax.value_and_grad(lambda p: jax_lm_loss(p, jcfg, batch)[0])(jp)
            ref["ragged"][case] = {"prefill": np.asarray(logits), "loss": float(loss),
                                   "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]}
        jcfg, cb = _jax_cfg("smollm-135m"), inp["coboost"]
        to_jax = lambda p: jax.tree_util.tree_map(jnp.asarray, lm_params_to_jax(port_cfg("smollm-135m"), p))
        clients = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[to_jax(c) for c in cb["clients"]])
        ref["coboost"] = {}
        for kl_chunk in COBOOST_CHUNKS:
            loss, grads = jax.value_and_grad(jax_distill_loss)(
                to_jax(cb["server"]), clients, jnp.asarray(cb["w"]), jcfg, {"embeds": jnp.asarray(cb["embeds"])}, 4.0,
                kl_chunk)
            ref["coboost"][kl_chunk] = {"loss": float(loss),
                                        "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]}
        step = jax_make_train_step(jcfg, JaxTrainConfig(**TRAIN))
        jstep = jax.jit(step)
        jp = jax.tree_util.tree_map(jnp.asarray, jax_params["smollm-135m"])
        jo = step.optimizer.init(jp)
        ref["losses"] = []
        for i, b in enumerate(inp["batches"]):
            jp, jo, m = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(i))
            ref["losses"].append(float(m["loss"]))
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {WORLD} ranks did not finish within {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = []
    for r in range(WORLD):
        with open(f"{tmp}/out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs, ref


def _results(outs, part, key):
    """Every rank's result for ``key`` (the ranks that ran it)."""
    got = [out[part][key] for out in outs if key in out[part]]
    assert got, f"no rank ran {part} {key}"
    return got


@pytest.mark.parametrize("name", ["mk", "smollm-135m"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("mesh", ["1x4", "1x2"])
def test_sharded_engine_tokens(parity, name, layout, mesh):
    """(a) The sharded engine's greedy tokens equal the meshless port
    engine's and the JAX engine's on every request, on every rank; its
    params are DTensors with the specs' shards."""
    outs, ref = parity
    for plain, sharded, shards in zip(_results(outs, "engine", (name, layout, "none")),
                                      _results(outs, "engine", (name, layout, mesh)),
                                      _results(outs, "shards", (name, layout, mesh))):
        assert sharded == plain == ref["tokens"][name]
        assert shards


@pytest.mark.parametrize("name", ["mk", "smollm-135m"])
def test_sharded_engine_with_drafter(parity, name):
    """(b) Speculative decoding on the sharded engine (model = 4): the same
    tokens."""
    outs, ref = parity
    for tokens in _results(outs, "spec", name):
        assert tokens == ref["tokens"][name]


@pytest.mark.parametrize("name", ["mk", "smollm-135m"])
def test_sharded_static_generate(parity, name):
    """The static generator (``launch.serve --engine static``) over the
    model = 4 mesh: the meshless generator's tokens."""
    outs, _ = parity
    for plain, sharded in _results(outs, "static", name):
        assert sharded == plain


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_sharded_prefill(parity, arch):
    """(c) The sharded prefill's logits against the meshless port's (within
    1e-5 of its largest |logit|) and JAX's (``1e-4·(1 + |ref|)``)."""
    outs, ref = parity
    for (plain, sharded), shards in zip(_results(outs, "prefill", arch), _results(outs, "shards", arch)):
        assert np.max(np.abs(sharded - plain)) <= 1e-5 * np.max(np.abs(plain))
        assert np.all(np.abs(sharded - ref["prefill"][arch]) <= 1e-4 * (1 + np.abs(ref["prefill"][arch])))
        assert shards


def test_shard_lm_state_sequence_splits_the_dense_cache(parity):
    """``shard_lm_state`` places a dense cache (L, B, S, KH, hd) as the
    reference's decode-state constraint does: the sequence over
    ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    outs, _ = parity
    got = [p for out in outs for p in out["lm_state"].values()]
    assert got and all(p == (Replicate(), Shard(2)) for p in got), got


def test_sharded_train_step(parity):
    """(d) 3 AdamW steps on the (2, 2) mesh: losses against the meshless
    port's and JAX's, every gathered parameter against the meshless port's;
    params and moments are DTensors with the specs' shards."""
    outs, ref = parity
    for out in outs:
        t = out["train"]
        for (plain, sharded), want in zip(t["losses"], ref["losses"]):
            assert abs(sharded - plain) <= 1e-5 * abs(plain)
            assert abs(sharded - want) <= 1e-4 * (1 + abs(want))
        for plain, sharded in t["params"]:
            assert np.all(np.abs(sharded - plain) <= 1e-4 * (1 + np.abs(plain)))
        assert t["shards"]


@pytest.mark.parametrize("case", list(RAGGED))
def test_ragged_split_prefill(parity, case):
    """(e) A split that cuts an expert's width or a head: the prefill's
    logits against the meshless port's and JAX's, as in (c)."""
    outs, ref = parity
    for out in _results(outs, "ragged", case):
        plain, sharded = out["prefill"]
        want = ref["ragged"][case]["prefill"]
        assert np.max(np.abs(sharded - plain)) <= 1e-5 * np.max(np.abs(plain))
        assert np.all(np.abs(sharded - want) <= 1e-4 * (1 + np.abs(want)))
        assert out["shards"]


def _assert_loss_and_grads(cfg, got, want):
    """A sharded loss and its gathered gradients against the meshless
    port's (the loss within ``1e-5·(1 + |ref|)``: a KL of 0.04 is a
    difference of log-probabilities near log V, whose f32 rounding sets its
    error; each gradient within ``1e-4·(1 + |ref|)``) and JAX's (both
    within ``1e-4·(1 + |ref|)``)."""
    plain_loss, sharded_loss = got["loss"]
    assert abs(sharded_loss - plain_loss) <= 1e-5 * (1 + abs(plain_loss))
    assert abs(sharded_loss - want["loss"]) <= 1e-4 * (1 + abs(want["loss"]))
    plain, sharded = (jax.tree_util.tree_leaves(lm_params_to_jax(cfg, g)) for g in got["grads"])
    assert len(plain) == len(sharded) == len(want["grads"])
    for p, s, w in zip(plain, sharded, want["grads"]):
        assert np.all(np.abs(s - p) <= 1e-4 * (1 + np.abs(p)))
        assert np.all(np.abs(s - w) <= 1e-4 * (1 + np.abs(w)))


@pytest.mark.parametrize("case", list(RAGGED))
def test_ragged_split_gradients(parity, case):
    """(e) The same splits: the loss and every gradient of the sharded loss,
    gathered, against the meshless port's and JAX's."""
    outs, ref = parity
    for out in _results(outs, "ragged", case):
        _assert_loss_and_grads(ragged_cfg(case), out, ref["ragged"][case])


@pytest.mark.parametrize("kl_chunk", COBOOST_CHUNKS, ids=["whole", "chunked"])
def test_sharded_distill_loss(parity, kl_chunk):
    """(f) The LM distillation loss over the vocabulary split: the loss and
    every gradient against the meshless port's and JAX's."""
    outs, ref = parity
    for out in _results(outs, "coboost", kl_chunk):
        _assert_loss_and_grads(port_cfg("smollm-135m"), out, ref["coboost"][kl_chunk])


def test_local_map_route_taken(parity):
    """The kernels (flash attention, flash decode) and every op DTensor has
    no strategy for ran on local shards, on every rank."""
    outs, _ = parity
    routed = ("flash_attention", "flash_decode", "kv_scatter", "page_gather", "moe_dispatch", "recurrent_scan",
              "vocab_kl")
    for out in outs:
        assert all(out["local_map"][k] > 0 for k in routed), out["local_map"]
    assert len(outs) == WORLD
