"""The ranks of ``tests/test_torch_mesh_fleet.py``: each is a gloo process
that runs the port's sharded fleet, its cross-mesh handoff, the launcher's
fleet and the client bank's client axis on the inputs of :func:`inputs`
(made from fixed seeds, the same in every process), and writes what it
got; the test's own process compares. This module imports no JAX, so a
rank starts with the port's imports alone."""
from __future__ import annotations

import os
import pickle
import time
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
THREADS = 2  # intra-op threads a rank
# the reference's _mk and _ECFG (tests/test_fleet.py), dense fields
MK = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
          vocab_size=64, dtype="float32", param_dtype="float32")
ECFG = dict(max_slots=2, max_seq=48, max_new=8, decode_chunk=3, prefill_bucket=8, page_size=8)
NAMES = ("mk", "smollm-135m")
TICK = 0.2
STREAM = dict(n=8, seed=17)  # the reference's pin: _stream(cfg, 8, seed=17)
HOT = dict(n=6, prompt=16, gen=6, seed=5, budget_min=2, shared=0.5, dt=1.0)
# the launcher's runs: (flags, the reference's replica count)
LAUNCH = (("--mesh", "multipod", "--replicas", "1"), 2), (("--replicas", "4"), 4)
LAUNCH_FLAGS = ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--requests", "6", "--max-slots", "2",
                "--prompt-len", "12", "--gen", "4"]
# the client bank: a grouped market of 4 cnn5 and 2 mlp, interleaved (the
# bank restores client order), on a (data 2, model 2) mesh
CLASSES, SHAPE = 5, (8, 8, 3)
BANK_ARCHS = ("cnn5", "mlp", "cnn5", "cnn5", "mlp", "cnn5")
EPOCH_CFG = dict(num_clients=6, epochs=1, gen_iters=2, batch_size=8, latent_dim=8, buffer_batches=2, seed=0)


def port_cfg(name):
    from repro_torch.config.model import ModelConfig, reduced_variant
    from repro_torch.config.registry import get_arch

    if name == "mk":
        return ModelConfig(**MK)
    return reduced_variant(get_arch(name)).replace(dtype="float32", param_dtype="float32")


def streams(cfg) -> dict:
    """The reference pin's staggered stream, and a hot-prefix stream whose
    shared head fills a page (the prefix cache splices it)."""
    from repro_torch.serve import Request, hot_prefix_stream, staggered_stream

    h = HOT
    prompts, budgets = hot_prefix_stream(cfg.vocab_size, h["n"], h["prompt"], h["gen"], seed=h["seed"],
                                         budget_min=h["budget_min"], shared_fraction=h["shared"])
    hot = [Request(rid=i, tokens=p, max_new_tokens=b, arrival=h["dt"] * i)
           for i, (p, b) in enumerate(zip(prompts, budgets))]
    return {"plain": staggered_stream(cfg.vocab_size, STREAM["n"], seed=STREAM["seed"]), "hot": hot}


def bank_market(seed=20):
    """The market's clients (the port's init), the server and the
    generator, from fixed seeds."""
    from repro_torch.models.cnn import init_cnn
    from repro_torch.models.generator import init_image_generator

    g = torch.Generator().manual_seed(seed)
    clients = [init_cnn(g, a, CLASSES, SHAPE) for a in BANK_ARCHS]
    g = torch.Generator().manual_seed(77)
    server = init_cnn(g, "cnn5", CLASSES, SHAPE)
    gen = init_image_generator(g, EPOCH_CFG["latent_dim"], CLASSES, SHAPE)
    return clients, server, gen


def inputs() -> dict:
    """The LM weights (``init_lm`` from fixed seeds, embedding x10 so that
    greedy tokens are decided by wide top-2 margins; the test's process
    carries them to JAX), the bank's images and direction."""
    from repro_torch.models.transformer import init_lm

    inp = {"params": {}}
    for name in NAMES:
        p = init_lm(port_cfg(name), torch.Generator().manual_seed(1))
        p["embed"]["table"] = p["embed"]["table"] * 10.0
        inp["params"][name] = p
    rng = np.random.RandomState(7)
    inp["images"] = rng.randn(4, *SHAPE).astype(np.float32)
    inp["u"] = rng.randn(4, len(BANK_ARCHS), CLASSES).astype(np.float32)
    return inp


def _completions(comps):
    return {c.rid: (c.tokens.tolist(), c.replica, c.admitted, c.first_token, c.finished) for c in comps}


def _fleet_pin(cfg, params, reqs):
    """The reference's acceptance pin on 4 ranks: two replicas on
    ``replica_meshes(make_fleet_mesh(2))``, replica 0 a disaggregated pair
    on its halves (one rank each)."""
    from repro_torch.launch.mesh import disagg_submeshes, make_fleet_mesh, replica_meshes
    from repro_torch.serve import EngineConfig, FleetRouter, ManualClock, ServeEngine
    from repro_torch.serve.scheduler import SharedHost

    subs = replica_meshes(make_fleet_mesh(2, device_type="cpu"))
    pmesh, dmesh = disagg_submeshes(subs[0])
    engines = [ServeEngine(cfg, params, EngineConfig(**ECFG), mesh=dmesh, prefill_mesh=pmesh, replica=0),
               ServeEngine(cfg, params, EngineConfig(**ECFG), mesh=subs[1], replica=1)]
    router = FleetRouter(engines, clock=ManualClock(tick=TICK))
    # what each of the router's collectives moved: (piece, elements) a part
    moved, share = [], SharedHost._share

    def logged(self, parts):
        moved.append([(read.__name__, size) for _, size, read in parts])
        return share(self, parts)

    SharedHost._share = logged
    try:
        comps = router.run(reqs)
    finally:
        SharedHost._share = share
    return {"completions": _completions(comps), "router": dict(router.stats),
            "stats": [dict(e.stats) for e in engines], "moved": moved}


def _sharded_halves(cfg, params, reqs, **knobs):
    """One replica over all 4 ranks, split into a (1, 2) prefill half and
    a (1, 2) decode half: heads split on both sides of the handoff."""
    from repro_torch.launch.mesh import disagg_submeshes, make_fleet_mesh, replica_meshes
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, ServeEngine

    pmesh, dmesh = disagg_submeshes(replica_meshes(make_fleet_mesh(1, device_type="cpu"))[0])
    eng = ServeEngine(cfg, params, EngineConfig(**ECFG, **knobs), mesh=dmesh, prefill_mesh=pmesh)
    comps = ContinuousScheduler(eng, clock=ManualClock(tick=TICK)).run(reqs)
    return {"completions": _completions(comps), "stats": dict(eng.stats)}


def _launched(extra):
    from repro_torch.launch import serve

    out = serve.main([*LAUNCH_FLAGS, *extra])
    return {"tokens": {c.rid: c.tokens.tolist() for c in out["completions"]}, "replicas": len(out["replicas"]),
            "served_by": sorted({c.replica for c in out["completions"]})}


def _bank(inp, grid):
    """The bank on the (2, 2) mesh against the meshless bank: the stack,
    the input gradient, the placements; then one Co-Boosting epoch on
    replayed draws (the test's process carries JAX's draws over)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.client_bank import ClientBank
    from repro_torch.models.cnn import cnn_apply, init_cnn
    from repro_torch.sharding import mesh_context

    clients, _, _ = bank_market()
    bank, bank_params = ClientBank.build([partial(cnn_apply, a) for a in BANK_ARCHS], clients)
    fn = bank.logits_all
    x = torch.from_numpy(inp["images"])
    u = torch.from_numpy(inp["u"]).transpose(0, 1)  # (K, B, C)

    def stack_and_grad():
        xx = x.clone().requires_grad_()
        la = fn(bank_params, xx)
        la = la.full_tensor() if hasattr(la, "full_tensor") else la  # differentiable: the gradient reaches x
        (g,) = torch.autograd.grad(torch.sum(u * la), xx)
        return la.detach().numpy(), g.numpy()

    out = {"plain": stack_and_grad()}
    with mesh_context(grid):
        out["sharded"] = stack_and_grad()
        # the placements of each group's logits: 4 cnn5 and 2 mlp over data 2
        # split, 5 clients do not divide data 2 and stay whole
        five, five_params = ClientBank.build([partial(cnn_apply, "mlp")] * 5,
                                             [init_cnn(torch.Generator().manual_seed(i), "mlp", CLASSES, SHAPE)
                                              for i in range(5)])
        groups = [bank._group_logits(g, sp, x) for g, sp in enumerate(bank_params)]
        out["placements"] = {
            "groups": [tuple(t.placements) for t in groups],
            "five": tuple(five._group_logits(0, five_params[0], x).placements),
        }
    out["split"] = all(p == (Shard(0), Replicate()) for p in out["placements"]["groups"])
    out["whole"] = out["placements"]["five"] == (Replicate(), Replicate())
    return out


def _embed(inp, grid):
    """The trunk input of reduced smollm-135m under the (2, 2) mesh: its
    placements (the batch split over data, the sequence whole on the model
    ranks) and its values against the meshless embedding."""
    from repro_torch.models.transformer import _embed_inputs
    from repro_torch.sharding import mesh_context, shard_params

    cfg, params = port_cfg("smollm-135m"), inp["params"]["smollm-135m"]
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab_size, size=(2, 8)).astype(np.int64))
    plain = _embed_inputs(params, cfg, {"tokens": tokens})
    sharded = shard_params(params, grid)
    with mesh_context(grid):
        x = _embed_inputs(sharded, cfg, {"tokens": tokens})
    return {"placements": tuple(x.placements), "equal": torch.equal(x.full_tensor(), plain)}


def _epoch(draws, grid):
    """One fused Co-Boosting epoch of the grouped bank, meshless and under
    the (2, 2) mesh, on the reference's draws."""
    from repro_torch.config.train import OFLConfig
    from repro_torch.core.coboosting import run_coboosting
    from repro_torch.models.cnn import cnn_apply
    from repro_torch.models.generator import image_generator
    from repro_torch.sharding import mesh_context
    from repro_torch.utils.prng import ReplayDraws
    from repro_torch.utils.trees import flatten_dict

    def run(mesh):
        clients, server, gen = bank_market()
        replay = ReplayDraws(draws, "cpu")
        with mesh_context(mesh):
            st = run_coboosting(
                [partial(cnn_apply, a) for a in BANK_ARCHS], clients, partial(cnn_apply, "cnn5"), server,
                lambda p, z, y: image_generator(p, z, y, SHAPE), gen, OFLConfig(**EPOCH_CFG), CLASSES, replay,
            )
        flat = lambda t: {k: v.numpy() for k, v in flatten_dict(t).items() if torch.is_tensor(v)}
        return {"w": st.weights.numpy(), "server": flat(st.server_params), "generator": flat(st.gen_params),
                "buf_x": st.buffer.x.numpy(), "buf_y": st.buffer.y.numpy(), "left": len(replay.items)}

    return {"plain": run(None), "sharded": run(grid)}


def _draws(tmp: str, wait_s: float = 60.0):
    """The reference's draws, which the test's process writes while the
    ranks run (renamed into place whole)."""
    deadline = time.monotonic() + wait_s
    while not os.path.exists(f"{tmp}/draws.pkl"):
        if time.monotonic() > deadline:
            raise TimeoutError("the reference's draws never came")
        time.sleep(0.05)
    with open(f"{tmp}/draws.pkl", "rb") as f:
        return pickle.load(f)


def rank_main(rank: int, tmp: str) -> None:
    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank, world_size=WORLD)
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels.dispatch import LOCAL_MAP_CALLS, reset_local_map_calls

    inp = inputs()
    out = {"pin": {}, "halves": {}, "launch": {}}
    # (a) the reference's pin, on both configs
    for name in NAMES:
        cfg = port_cfg(name)
        out["pin"][name] = _fleet_pin(cfg, inp["params"][name], streams(cfg)["plain"])
    # (b) the handoff between sharded halves, a plain and a prefix-cache stream
    cfg = port_cfg("mk")
    s = streams(cfg)
    out["halves"]["plain"] = _sharded_halves(cfg, inp["params"]["mk"], s["plain"])
    out["halves"]["hot"] = _sharded_halves(cfg, inp["params"]["mk"], s["hot"], prefix_cache=True)
    # (c) the launcher: the fleet over the world, and the single meshless engine
    out["launch"]["single"] = _launched(())
    for extra, _ in LAUNCH:
        out["launch"][extra] = _launched(extra)
    # (d) the client bank's client axis on the (data 2, model 2) mesh
    grid = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2), mesh_dim_names=("data", "model"))
    reset_local_map_calls()
    out["embed"] = _embed(inp, grid)
    out["bank"] = _bank(inp, grid)
    out["epoch"] = _epoch(_draws(tmp), grid)
    out["local_map"] = dict(LOCAL_MAP_CALLS)
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
