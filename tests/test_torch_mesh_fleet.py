"""The sharded serving fleet and the client bank's client axis on CPU
ranks: ONE spawn of 4 gloo ranks (file rendezvous, two intra-op threads
each, its own deadline; a hang kills the ranks and fails), while this
process computes the JAX package's answers on the same weights.

(a) The reference's acceptance pin
    (``tests/test_fleet.py::test_router_sharded_disagg_fleet_parity``) on 4
    ranks: two replicas on ``replica_meshes(make_fleet_mesh(2))``, replica
    0 a disaggregated pair on its halves (``ServeEngine(mesh=d,
    prefill_mesh=p)``, one rank each), replica 1 on its own two ranks,
    behind one ``FleetRouter`` that every rank runs, on
    ``ManualClock(tick=0.2)``; the reference's ``_mk`` config and reduced
    smollm-135m in f32. The tokens equal the meshless JAX engine's for
    every request; each request's replica, its stamps, every replica's
    stats and the router's stats equal the meshless JAX ``FleetRouter``'s
    over two engines; every rank returns the same; both replicas serve and
    the pair hands off. Each of the router's collectives moves the live
    replicas' heads or the finished slots' rows, each row once.
(b) The handoff between sharded halves: ``make_fleet_mesh(1)`` split into a
    (1, 2) prefill half and a (1, 2) decode half, heads split on both sides,
    on the pin's stream and on a hot-prefix stream with the prefix cache:
    the tokens and stats of the meshless JAX engine.
(c) The launcher on 4 ranks: ``--mesh multipod --replicas 1`` (2 replicas
    of 2 ranks) and ``--replicas 4`` (4 of 1) give the single meshless
    engine's tokens, with the reference's replica count.
(d) The grouped bank on a (data 2, model 2) mesh (4 cnn5 and 2 mlp clients,
    interleaved): the stack and the input gradient within ``TOL`` of the
    meshless bank; one fused Co-Boosting epoch on JAX's draws within
    ``EPOCH_TOL`` of the meshless port and of JAX's grouped epoch, bitwise
    equal on every rank; the bank's forward and #1–#4 ran through the
    ``local_map`` route; a group of 5 over data 2 stays whole. On the same
    mesh the trunk input keeps its sequence whole on the model ranks.
"""
from __future__ import annotations

import os
import pickle
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.config import ModelConfig as JaxModelConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.config.train import OFLConfig as JaxOFLConfig
from repro.core.buffer import buffer_init as jax_buffer_init
from repro.core.client_bank import make_ensemble as jax_make_ensemble
from repro.core.ensemble import uniform_weights as jax_uniform_weights
from repro.core.epoch import _sample_zy, distill_schedule as jax_distill_schedule
from repro.core.epoch import make_coboost_epoch as jax_make_coboost_epoch
from repro.kernels.dispatch import BackendPolicy
from repro.models.cnn import cnn_apply as jax_cnn_apply
from repro.models.generator import image_generator as jax_image_generator
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import FleetRouter as JaxFleetRouter
from repro.serve import ManualClock as JaxManualClock
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.convert import lm_params_to_jax, params_to_jax
from torch_mesh_fleet_ranks import (
    BANK_ARCHS, CLASSES, ECFG, EPOCH_CFG, LAUNCH, MK, NAMES, SHAPE, TICK, WORLD, bank_market, inputs, port_cfg,
    rank_main, streams,
)

pytestmark = pytest.mark.tier1

DEADLINE_S = 150
# the client bank's tolerances (tests/test_torch_client_bank.py)
TOL = 1e-5
EPOCH_TOL = {"buffer": 2e-5, "w": 1e-6, "server": 1e-6, "generator": 5e-5}


def _jax_cfg(name):
    if name == "mk":
        return JaxModelConfig(scan_layers=False, remat=False, **MK)
    return jax_reduced_variant(jax_get_arch(name)).replace(
        dtype="float32", param_dtype="float32", attn_backend="ref", decode_backend="ref"
    )


def _jax_reqs(reqs):
    return [JaxRequest(rid=r.rid, tokens=r.tokens, max_new_tokens=r.max_new_tokens, arrival=r.arrival) for r in reqs]


def _jax_serve(router, reqs):
    comps = router.run(_jax_reqs(reqs))
    return {
        "completions": {c.rid: (np.asarray(c.tokens).tolist(), c.replica, c.admitted, c.first_token, c.finished)
                        for c in comps},
        "router": {k: int(v) for k, v in dict(router.stats).items()},
        "stats": [{k: int(v) for k, v in dict(e.stats).items()} for e in router.engines],
    }


def _jax_answers(inp):
    """The meshless JAX engine on each stream, and the meshless JAX fleet
    of two engines on the pin's stream."""
    ref = {"single": {}, "fleet": {}, "hot": None}
    for name in NAMES:
        jcfg = _jax_cfg(name)
        jparams = jax.tree_util.tree_map(jnp.asarray, lm_params_to_jax(port_cfg(name), inp["params"][name]))
        plain = streams(port_cfg(name))["plain"]
        one = JaxServeEngine(jcfg, jparams, JaxEngineConfig(**ECFG))
        ref["single"][name] = _jax_serve(JaxScheduler(one, clock=JaxManualClock(tick=TICK)), plain)
        # the single engine, reset by the router, is the fleet's replica 0:
        # its compiled programs serve again
        fleet = JaxFleetRouter([one, JaxServeEngine(jcfg, jparams, JaxEngineConfig(**ECFG))],
                               clock=JaxManualClock(tick=TICK))
        ref["fleet"][name] = _jax_serve(fleet, plain)
        if name == "mk":
            hot = JaxScheduler(JaxServeEngine(jcfg, jparams, JaxEngineConfig(**ECFG, prefix_cache=True)),
                               clock=JaxManualClock(tick=TICK))
            ref["hot"] = _jax_serve(hot, streams(port_cfg(name))["hot"])
    return ref


def _jax_epoch():
    """The reference's fused epoch (``backend="ref"``) over its grouped
    bank on the market's weights: its draws, by its own key chain, and its
    state."""
    jcfg = JaxOFLConfig(**EPOCH_CFG, backend=BackendPolicy(default="ref"))
    clients, server, gen = bank_market()
    jclients = [params_to_jax(a, c) for a, c in zip(BANK_ARCHS, clients)]
    server, gen = params_to_jax("cnn5", server), params_to_jax("image_generator", gen)
    logits_all, bank_params = jax_make_ensemble([partial(jax_cnn_apply, a) for a in BANK_ARCHS], jclients)
    step, gen_opt, srv_opt = jax_make_coboost_epoch(
        logits_all, partial(jax_cnn_apply, "cnn5"), lambda p, z, y: jax_image_generator(p, z, y, SHAPE), jcfg,
        len(BANK_ARCHS), CLASSES,
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

    def run():
        sp, _, gp, _, w, jbuf, *_ = step(
            server, srv_opt.init(server), gen, gen_opt.init(gen), jax_uniform_weights(len(BANK_ARCHS)), buf, key,
            steps, order, n_valid, bank_params,
        )
        return {"w": np.asarray(w), "server": sp, "generator": gp, "buf_x": np.asarray(jbuf.x),
                "buf_y": np.asarray(jbuf.y)}

    return draws, run


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The 4 ranks, while this process computes JAX's draws (which the
    ranks replay, once they reach the epoch) and the JAX answers; join
    within the deadline (a hang kills the ranks and fails)."""
    tmp = str(tmp_path_factory.mktemp("fleet"))
    ctx = mp.start_processes(rank_main, args=(tmp,), nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        draws, jax_epoch = _jax_epoch()
        with open(f"{tmp}/draws.tmp", "wb") as f:
            pickle.dump(draws, f)
        os.replace(f"{tmp}/draws.tmp", f"{tmp}/draws.pkl")  # whole, or not there: the ranks wait for it
        ref = _jax_answers(inputs())
        ref["epoch"] = jax_epoch()
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


def _same_on_every_rank(outs, *path):
    got = []
    for out in outs:
        for key in path:
            out = out[key]
        got.append(out)
    for g in got[1:]:
        assert g == got[0]
    return got[0]


def _assert_served(got, want):
    """Tokens, replica and stamps of every request, and each replica's
    stats, key for key."""
    assert sorted(got["completions"]) == sorted(want["completions"])
    for rid, (tokens, replica, *stamps) in got["completions"].items():
        wtokens, wreplica, *wstamps = want["completions"][rid]
        assert tokens == wtokens, rid
        assert replica == wreplica, rid
        assert stamps == pytest.approx(wstamps), rid


@pytest.mark.parametrize("name", NAMES)
def test_sharded_disagg_fleet_pin(fleet, name):
    """(a) The reference's pin: the tokens of the meshless JAX engine; the
    routing, stamps, replica stats and router stats of the meshless JAX
    fleet; every rank the same; both replicas served and the pair handed
    off."""
    outs, ref = fleet
    got = _same_on_every_rank(outs, "pin", name)
    single = ref["single"][name]["completions"]
    for rid, (tokens, *_) in got["completions"].items():
        assert tokens == single[rid][0], rid
    _assert_served(got, ref["fleet"][name])
    assert got["stats"] == ref["fleet"][name]["stats"]
    assert got["router"] == ref["fleet"][name]["router"]
    assert {replica for _, replica, *_ in got["completions"].values()} == {0, 1}
    assert got["stats"][0]["handoffs"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_fleet_readback_volume(fleet, name):
    """(a) What the pin's router moved between ranks: each tick's heads
    (``active``, ``n_out``) in one all-reduce, one head a live replica;
    output rows only on a tick where a slot finished, in one more, each
    request's row exactly once; the volume never grows with the world."""
    outs, _ = fleet
    got = _same_on_every_rank(outs, "pin", name)
    head, row = 2 * ECFG["max_slots"], ECFG["max_new"]
    for call in got["moved"]:
        pieces = {piece for piece, _ in call}
        assert pieces in ({"head"}, {"rows"}), call
        sizes = [size for _, size in call]
        assert all(size == head for size in sizes) if pieces == {"head"} else all(size % row == 0 for size in sizes)
        assert len(call) <= 2  # at most one piece a replica
    rows = [size for call in got["moved"] for piece, size in call if piece == "rows"]
    assert sum(rows) == len(got["completions"]) * row


def test_embed_keeps_the_sequence_whole(fleet):
    """The trunk input under the (data 2, model 2) mesh: the batch split
    over data, the sequence whole on the model ranks (``Replicate`` on the
    model dim, where the reference constrains it to ``("batch", "seq",
    None)``), the values the meshless embedding's, on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    outs, _ = fleet
    got = _same_on_every_rank(outs, "embed")
    assert got["placements"] == (Shard(0), Replicate())
    assert got["equal"]


@pytest.mark.parametrize("stream", ["plain", "hot"])
def test_handoff_between_sharded_halves(fleet, stream):
    """(b) A (1, 2) prefill half handing off to a (1, 2) decode half: the
    meshless JAX engine's tokens, stamps and stats, on every rank; the hot
    stream splices."""
    outs, ref = fleet
    got = _same_on_every_rank(outs, "halves", stream)
    want = ref["single"]["mk"] if stream == "plain" else ref["hot"]
    _assert_served(got, want)
    assert got["stats"] == want["stats"][0]
    assert got["stats"]["handoffs"] > 0
    if stream == "hot":
        assert got["stats"]["spliced_admissions"] > 0


@pytest.mark.parametrize("extra, replicas", LAUNCH, ids=["multipod", "replicas4"])
def test_launcher_fleet_on_four_ranks(fleet, extra, replicas):
    """(c) ``launch.serve`` over the world: the single meshless engine's
    tokens, the reference's replica count, every replica serving, every
    rank the same."""
    outs, _ = fleet
    got = _same_on_every_rank(outs, "launch", extra)
    single = _same_on_every_rank(outs, "launch", "single")
    assert got["tokens"] == single["tokens"]
    assert got["replicas"] == replicas and single["replicas"] == 1
    assert got["served_by"] == list(range(replicas))


def test_bank_stack_and_input_gradient(fleet):
    """(d) The sharded bank's stack and input gradient against the meshless
    bank's, on every rank; a group of 5 over data 2 stays whole."""
    outs, _ = fleet
    for out in outs:
        bank = out["bank"]
        for plain, sharded in zip(bank["plain"], bank["sharded"]):
            np.testing.assert_allclose(sharded, plain, rtol=0, atol=TOL)
        assert bank["split"], bank["placements"]
        assert bank["whole"], bank["placements"]


def _max_diff(a, b):
    assert a.keys() == b.keys()
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in a)


def test_bank_epoch_matches_meshless_and_jax(fleet):
    """(d) One fused Co-Boosting epoch under the (2, 2) mesh against the
    meshless port's and JAX's grouped epoch, on JAX's draws."""
    from repro_torch.convert import params_from_jax
    from repro_torch.utils.trees import flatten_dict

    outs, ref = fleet
    want = ref["epoch"]
    flat = lambda t: {k: v.numpy() for k, v in flatten_dict(t).items() if hasattr(v, "numpy")}
    jserver = flat(params_from_jax("cnn5", jax.tree_util.tree_map(np.asarray, want["server"])))
    jgen = flat(params_from_jax("image_generator", jax.tree_util.tree_map(np.asarray, want["generator"])))
    for out in outs:
        plain, sharded = out["epoch"]["plain"], out["epoch"]["sharded"]
        assert plain["left"] == sharded["left"] == 0, "the port drew fewer values than the reference"
        for other in (plain, {"w": want["w"], "server": jserver, "generator": jgen, "buf_x": want["buf_x"],
                              "buf_y": want["buf_y"]}):
            np.testing.assert_allclose(sharded["buf_x"], other["buf_x"], rtol=0, atol=EPOCH_TOL["buffer"])
            np.testing.assert_array_equal(sharded["buf_y"], other["buf_y"])
            np.testing.assert_allclose(sharded["w"], other["w"], rtol=0, atol=EPOCH_TOL["w"])
            assert _max_diff(sharded["server"], other["server"]) < EPOCH_TOL["server"]
            assert _max_diff(sharded["generator"], other["generator"]) < EPOCH_TOL["generator"]


def test_bank_epoch_bitwise_on_every_rank(fleet):
    """(d) Every rank's ensembling weights, server and generator after the
    sharded epoch are the same bits: the gradients that cross from the bank
    to the plain server and generator come back whole and equal."""
    outs, _ = fleet
    first = outs[0]["epoch"]["sharded"]
    for out in outs[1:]:
        got = out["epoch"]["sharded"]
        np.testing.assert_array_equal(got["w"], first["w"])
        for part in ("server", "generator"):
            for k in first[part]:
                np.testing.assert_array_equal(got[part][k], first[part][k])


def test_bank_local_map_route_taken(fleet):
    """(d) The bank's group forwards and the loss kernels #1–#4 ran on local
    shards, on every rank."""
    outs, _ = fleet
    for out in outs:
        calls = out["local_map"]
        assert all(calls[k] > 0 for k in ("client_bank", "ensemble_kl", "ghm_ce")), calls
    assert len(outs) == WORLD


# ---------------------------------------------------------------------------
# one process, no ranks


def test_engine_placements_refuse_each_other():
    """``prefill_mesh`` and ``prefill_device`` place the prefill worker in
    two ways: together they raise, and so does a prefill mesh without the
    decode worker's, before any device work."""
    import torch

    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import EngineConfig, ServeEngine

    cfg = port_cfg("mk")
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    mesh = object()  # never reached: the arguments are refused first
    with pytest.raises(ValueError, match="give one"):
        ServeEngine(cfg, params, EngineConfig(**ECFG), mesh=mesh, prefill_mesh=mesh, prefill_device="cpu")
    with pytest.raises(ValueError, match="decode worker's mesh"):
        ServeEngine(cfg, params, EngineConfig(**ECFG), prefill_mesh=mesh)


def test_meshless_router_shares_nothing():
    """A fleet of meshless engines spans no rank: the router's host inputs
    are its own and it issues no collective (it needs no process group)."""
    import torch

    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import EngineConfig, FleetRouter, ManualClock, ServeEngine
    from repro_torch.serve.scheduler import SharedHost

    cfg = port_cfg("mk")
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    engines = [ServeEngine(cfg, params, EngineConfig(**ECFG), replica=i) for i in range(2)]
    assert engines[0].ranks == () and not SharedHost(engines).active
    comps = FleetRouter(engines, clock=ManualClock(tick=TICK)).run(streams(cfg)["plain"])
    assert len(comps) == 8 and {c.replica for c in comps} == {0, 1}
