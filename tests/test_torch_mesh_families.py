"""The sharded engine of every decoder family on CPU ranks: ONE spawn of 4
gloo ranks (file rendezvous, two intra-op threads each, its own deadline;
a hang kills the ranks and fails), while this process computes the JAX
package's answers on the same weights, two archs at a time.

Each registered decoder arch runs as its reduced variant in f32 (the
overrides of ``torch_mesh_families_ranks.ARCHS``: granite at 8 query heads
over 4 KV heads and an odd 515-token vocabulary, every MoE at capacity
factor E / k) on ``replica_meshes(make_fleet_mesh(1))[0]`` (model = 4, one
KV head a rank) and on a (1, 2) submesh:

* the continuous paged engine's greedy tokens (phi-3-vision: the static
  generator's, its image prefix fed at prefill) equal the meshless port
  engine's and the meshless JAX engine's on every request, on every rank
  of the mesh (all 4 for (1, 4); the two pairs share the (1, 2) runs, one
  arch each in turn);
* every parameter is a DTensor whose local shard has its spec's shape, and
  the kernels and strategy-less ops the family has ran on local shards
  (``LOCAL_MAP_CALLS``);
* granite with a drafter (``spec_k = 3``): the same tokens, its verify's
  4-position logits split by sequence over ``model`` (the vocabulary
  neither 2 nor 4 divides) and its one-position logits whole.
"""
from __future__ import annotations

import pickle
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ManualClock as JaxManualClock
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.static import static_generate as jax_static_generate
from repro_torch.convert import lm_params_to_jax
from torch_mesh_families_ranks import (
    ARCHS, ENGINE, GEN, MESHES, ODD_VOCAB, STATIC, WORLD, inputs, port_cfg, rank_main, routes,
)

pytestmark = pytest.mark.tier1

DEADLINE_S = 150


def _jax_cfg(name):
    return jax_reduced_variant(jax_get_arch(name)).replace(
        dtype="float32", param_dtype="float32", attn_backend="ref", decode_backend="ref", **ARCHS[name]
    )


def _jax_tokens(name, jparams, prompts):
    jcfg = _jax_cfg(name)
    if name in STATIC:
        batch = {k: jnp.asarray(v) for k, v in prompts.items()}
        return np.asarray(jax_static_generate(jparams, jcfg, batch, GEN, key=jax.random.key(0))).tolist()
    eng = JaxServeEngine(jcfg, jparams, JaxEngineConfig(**ENGINE))
    comps = JaxScheduler(eng, clock=JaxManualClock()).run(
        [JaxRequest(rid=i, tokens=p, max_new_tokens=GEN) for i, p in enumerate(prompts)]
    )
    return [np.asarray(c.tokens).tolist() for c in comps]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Spawn the 4 ranks; compute the JAX tokens meanwhile, on the same
    weights (the port's, carried to JAX); join within the deadline (a hang
    kills the ranks and fails)."""
    tmp = str(tmp_path_factory.mktemp("families"))
    ctx = mp.start_processes(rank_main, args=(tmp,), nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        inp = inputs()

        def want(name):
            jparams = jax.tree_util.tree_map(jnp.asarray, lm_params_to_jax(port_cfg(name), inp["params"][name]))
            return _jax_tokens(name, jparams, inp["prompts"][name])

        # two compiles at a time beside the 4 ranks
        with ThreadPoolExecutor(2) as pool:
            ref = dict(zip(ARCHS, pool.map(want, ARCHS)))
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


def _ran(outs, key):
    """The outputs of the ranks that ran ``key``: all 4 for the (1, 4)
    mesh, the two ranks of one (1, 2) pair."""
    got = [out for out in outs if key in out["tokens"]]
    assert len(got) == (WORLD if key[1] == "1x4" else 2), key
    return got


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(ARCHS))
def test_sharded_family_tokens(served, name, mesh):
    """The sharded engine's (phi: static generator's) greedy tokens equal
    the meshless port's and the JAX engine's on every request, on every
    rank of the mesh."""
    outs, ref = served
    for out in _ran(outs, (name, mesh)):
        assert out["tokens"][name, mesh] == out["tokens"][name, "none"] == ref[name]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(ARCHS))
def test_sharded_family_placement_and_route(served, name, mesh):
    """Every parameter is a DTensor with its spec's shards; the family's
    kernels and strategy-less ops ran on local shards, and no other."""
    outs, _ = served
    want = set(routes(name))
    for out in _ran(outs, (name, mesh)):
        assert out["shards"][name, mesh]
        calls = out["local_map"][name, mesh]
        assert {k for k, n in calls.items() if n} == want, calls


@pytest.mark.parametrize("mesh", MESHES)
def test_odd_vocab_sequence_split(served, mesh):
    """granite with a drafter on a mesh whose model axis does not divide
    its vocabulary: the same tokens as the JAX engine's; the verify's
    4-position logits come back split by sequence over ``model`` and a
    single position's whole (no rank holds an uneven vocabulary slice);
    the verify reads the pool through the page table on local shards."""
    from torch.distributed.tensor import Replicate, Shard

    outs, ref = served
    assert port_cfg(ODD_VOCAB).vocab_size % 2
    assert len(outs) == WORLD
    for out in outs:
        assert out["tokens"]["spec", mesh] == ref[ODD_VOCAB]
        assert out["logits"][mesh] == {(4, (Replicate(), Shard(1))), (1, (Replicate(), Replicate()))}
        calls = out["local_map"]["spec", mesh]
        assert {k for k, n in calls.items() if n} == set(routes(ODD_VOCAB, spec=True)), calls
