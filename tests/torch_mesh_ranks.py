"""The ranks of ``tests/test_torch_mesh.py``'s multi-rank parity: each is a
gloo process that runs the port meshless and sharded on the inputs of
:func:`inputs` (made from fixed seeds, the same in every process) and
writes what it got; the test's own process compares. This module imports
no JAX, so a rank starts with the port's imports alone."""
from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_fleet_mesh, replica_meshes

WORLD = 4
# the reference's _mk (tests/test_fleet.py), dense fields
MK = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
          vocab_size=64, dtype="float32", param_dtype="float32")
NAMES = ("mk", "smollm-135m")
ENGINE = dict(max_slots=3, max_seq=32, max_new=6, decode_chunk=3, page_size=8)
GEN = 4
PREFILL_ARCHS = ("mixtral-8x7b", "jamba-v0.1-52b", "xlstm-125m")
# splits that cut over the (2, 2) mesh's model = 2: 3 experts (each rank
# takes half of every expert's width) and 3 query heads over 1 KV head (the
# data split puts a model split on the projections' outputs, which cuts a
# head; on a (1, 2) mesh they stay whole)
# the distillation loss's sequence chunks (0: whole)
COBOOST_CHUNKS = (0, 8)
RAGGED = {"experts": ("mixtral-8x7b", dict(num_experts=3)), "heads": ("mk", dict(num_heads=3, num_kv_heads=1))}
# AdamW's first steps move a weight by about lr·g/(|g| + eps): with the
# default eps (1e-8) a gradient at the f32 noise floor of a reordered sum
# moves its weight by up to a full ±lr either way, so the
# sharded and meshless weights could differ by 2·lr. eps = 1e-4 keeps the
# step Lipschitz in the gradient there; a wrong gradient still shows.
TRAIN = dict(optimizer="adamw", learning_rate=3e-3, schedule="linear_warmup_cosine", warmup_steps=1, total_steps=3,
             eps=1e-4)


def port_cfg(name):
    from repro_torch.config.model import ModelConfig, reduced_variant
    from repro_torch.config.registry import get_arch

    if name == "mk":
        return ModelConfig(**MK)
    return reduced_variant(get_arch(name)).replace(dtype="float32", param_dtype="float32")


def ragged_cfg(case):
    name, kw = RAGGED[case]
    return port_cfg(name).replace(**kw)


def shards_match_specs(params, mesh) -> bool:
    """Every leaf is a DTensor on ``mesh`` whose local shard has the shape
    its inferred spec gives."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import infer_param_specs
    from repro_torch.sharding.partition import map_with_path, mesh_axes_of
    from repro_torch.utils.trees import tree_leaves, tree_map, value_and_grad

    axes = mesh_axes_of(mesh)
    specs = []
    map_with_path(lambda _, s: specs.append(s), infer_param_specs(params, mesh_axes=axes),
                  is_leaf=lambda s: type(s).__name__ == "PartitionSpec")
    for leaf, spec in zip(tree_leaves(params), specs):
        if not isinstance(leaf, DTensor) or leaf.device_mesh != mesh:
            return False
        want = [n // int(np.prod([axes[a] for a in ((e,) if isinstance(e, str) else e)])) if e else n
                for n, e in zip(leaf.shape, tuple(spec) + (None,) * (leaf.dim() - len(spec)))]
        if list(leaf.to_local().shape) != want:
            return False
    return True


def _serve(cfg, params, prompts, mesh=None, drafter=None, **kw):
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine

    eng = ServeEngine(cfg, params, EngineConfig(**{**ENGINE, **kw}), mesh=mesh, drafter=drafter)
    comps = ContinuousScheduler(eng, clock=ManualClock()).run(
        [Request(rid=i, tokens=p, max_new_tokens=GEN) for i, p in enumerate(prompts)]
    )
    return [c.tokens.tolist() for c in comps], eng


def inputs() -> dict:
    """The port's weights (``init_lm`` from fixed seeds; the test's process
    carries them to JAX), the prompts, the prefill tokens and the train
    batches."""
    from repro_torch.models.transformer import init_lm

    rng = np.random.RandomState(5)
    init = lambda name, seed: init_lm(port_cfg(name), torch.Generator().manual_seed(seed))
    inp = {"params": {}, "drafter": {}, "prompts": {}}
    for name in NAMES:
        p = init(name, 1)
        # a wider embedding spreads the random model's logits, so greedy
        # tokens are decided by wide top-2 margins
        p["embed"]["table"] = p["embed"]["table"] * 10.0
        inp["params"][name] = p
        inp["drafter"][name] = init(name, 2)
        inp["prompts"][name] = [rng.randint(0, port_cfg(name).vocab_size, size=n).astype(np.int32) for n in (9, 20, 6)]
    for arch in PREFILL_ARCHS:
        inp["params"][arch] = init(arch, 3)
    inp["prefill_tokens"] = rng.randint(0, 512, size=(2, 16)).astype(np.int32)
    inp["batches"] = [
        {"tokens": t, "labels": np.roll(t, -1, axis=1)}
        for t in (rng.randint(0, 512, size=(4, 16)).astype(np.int32) for _ in range(3))
    ]
    inp["ragged_params"] = {}
    for case in RAGGED:
        inp["ragged_params"][case] = init_lm(ragged_cfg(case), torch.Generator().manual_seed(4))
    t = rng.randint(0, 64, size=(2, 16)).astype(np.int32)  # within every ragged config's vocabulary
    inp["ragged_batch"] = {"tokens": t, "labels": np.roll(t, -1, axis=1)}
    inp["coboost"] = {
        "server": init("smollm-135m", 8),
        "clients": [init("smollm-135m", 9), init("smollm-135m", 10)],
        "embeds": (rng.standard_normal((2, 16, port_cfg("smollm-135m").d_model)) * 0.5).astype(np.float32),
        "w": np.asarray([0.6, 0.4], np.float32),
    }
    return inp


def rank_main(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank, world_size=WORLD)
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.config.train import TrainConfig
    from repro_torch.kernels.dispatch import LOCAL_MAP_CALLS, reset_local_map_calls
    from repro_torch.models.transformer import init_lm_state, lm_loss, lm_prefill, shard_lm_state
    from repro_torch.runtime.steps import make_train_step, shard_batch
    from repro_torch.serve import static_generate
    from repro_torch.serve.engine import shard_state
    from repro_torch.sharding import mesh_context, shard_params
    from repro_torch.utils.trees import tree_leaves, tree_map, value_and_grad

    inp = inputs()
    model4 = replica_meshes(make_fleet_mesh(1, device_type="cpu"))[0]  # (1, 4)
    # (1, 2) submeshes: ranks {0, 1} and {2, 3}, each pair running its own
    # share of the (1, 2) cases
    pair_id = rank // 2
    pair = replica_meshes(make_fleet_mesh(2, device_type="cpu"))[pair_id]
    grid = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2), mesh_dim_names=("data", "model"))
    out = {"engine": {}, "spec": {}, "static": {}, "prefill": {}, "shards": {}, "lm_state": {}, "ragged": {}}
    reset_local_map_calls()
    # (a) and (b): the engine, meshless and sharded
    for i, name in enumerate(NAMES):
        cfg = port_cfg(name)
        params = inp["params"][name]
        prompts = inp["prompts"][name]
        for layout in ("paged", "dense"):
            out["engine"][name, layout, "none"] = _serve(cfg, params, prompts, kv_layout=layout)[0]
            for mname, mesh in (("1x4", model4), ("1x2", pair)):
                if mname == "1x2" and i % 2 != pair_id:
                    continue
                tokens, eng = _serve(cfg, params, prompts, mesh=mesh, kv_layout=layout)
                out["engine"][name, layout, mname] = tokens
                out["shards"][name, layout, mname] = shards_match_specs(eng.params, mesh)
        drafter = (cfg, inp["drafter"][name])
        out["spec"][name] = _serve(cfg, params, prompts, mesh=model4, drafter=drafter, spec_k=2)[0]
        # the static generator (launch.serve --engine static) on the same mesh
        batch = {"tokens": torch.from_numpy(np.stack([p[:6] for p in prompts]))}
        out["static"][name] = [static_generate(params, cfg, batch, GEN).tolist(),
                               static_generate(shard_params(params, model4), cfg, batch, GEN, mesh=model4).tolist()]
    # (c) one sharded prefill of the MoE, hybrid and xLSTM archs
    for arch in PREFILL_ARCHS[pair_id::2]:
        cfg = port_cfg(arch)
        params = inp["params"][arch]
        tokens = torch.from_numpy(inp["prefill_tokens"])
        with torch.no_grad():
            plain, _ = lm_prefill(params, cfg, {"tokens": tokens}, init_lm_state(cfg, *tokens.shape))
            sharded = shard_params(params, pair)
            state = shard_state(init_lm_state(cfg, *tokens.shape), pair)
            with mesh_context(pair):
                logits, _ = lm_prefill(sharded, cfg, {"tokens": tokens}, state)
        out["prefill"][arch] = (plain.numpy(), logits.full_tensor().numpy())
        if "k" in state:  # the dense cache's decode-state constraint: sequence over "model"
            with mesh_context(pair):
                placed = shard_lm_state(state)
            out["lm_state"][arch] = tuple(placed["k"].placements)
        out["shards"][arch] = shards_match_specs(sharded, pair)
    # (e) a prefill and the loss's gradients where the split cuts an expert's
    # width or a head, on the (2, 2) mesh
    batch = {k: torch.from_numpy(v) for k, v in inp["ragged_batch"].items()}
    tokens = batch["tokens"]
    for case in RAGGED:
        cfg, params = ragged_cfg(case), inp["ragged_params"][case]
        sharded = shard_params(params, grid)
        with torch.no_grad():
            plain, _ = lm_prefill(params, cfg, {"tokens": tokens}, init_lm_state(cfg, *tokens.shape))
            with mesh_context(grid):
                state = shard_state(init_lm_state(cfg, *tokens.shape), grid)
                logits, _ = lm_prefill(sharded, cfg, {"tokens": tokens}, state)
        loss0, g0 = value_and_grad(lambda p: lm_loss(p, cfg, batch)[0], params)
        with mesh_context(grid):
            loss1, g1 = value_and_grad(lambda p: lm_loss(p, cfg, shard_batch(batch, grid))[0], sharded)
        whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        out["ragged"][case] = {
            "prefill": (plain.numpy(), whole(logits).numpy()),
            "loss": (float(loss0), float(whole(loss1))),
            "grads": (g0, tree_map(whole, g1)),
            "shards": shards_match_specs(sharded, grid),
        }
    # (f) the LM distillation loss (Eq. 4) and its gradients on the (2, 2)
    # mesh, whole and chunked: the KL over the vocabulary split
    from repro_torch.core.distributed import coboost_distill_loss

    cb, cfg = inp["coboost"], port_cfg("smollm-135m")
    w, batch = torch.from_numpy(cb["w"]), {"embeds": torch.from_numpy(cb["embeds"])}
    sharded_clients = [shard_params(c, grid) for c in cb["clients"]]
    out["coboost"] = {}
    for kl_chunk in COBOOST_CHUNKS:
        loss0, g0 = value_and_grad(lambda p: coboost_distill_loss(p, cb["clients"], w, cfg, batch, 4.0, kl_chunk),
                                   cb["server"])
        with mesh_context(grid):
            loss1, g1 = value_and_grad(
                lambda p: coboost_distill_loss(p, sharded_clients, w, cfg, shard_batch(batch, grid), 4.0, kl_chunk),
                shard_params(cb["server"], grid))
        out["coboost"][kl_chunk] = {"loss": (float(loss0), float(whole(loss1))), "grads": (g0, tree_map(whole, g1))}
    # (d) 3 AdamW steps on the (2, 2) mesh
    cfg = port_cfg("smollm-135m")
    params = inp["params"]["smollm-135m"]
    step = make_train_step(cfg, TrainConfig(**TRAIN))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in inp["batches"]]
    p0, o0 = params, step.optimizer.init(params)
    p1 = shard_params(params, grid)
    o1 = step.optimizer.init(p1)
    losses = []
    for i, batch in enumerate(batches):
        p0, o0, m0 = step(p0, o0, batch, i)
        with mesh_context(grid):
            p1, o1, m1 = step(p1, o1, batch, i)
        losses.append((float(m0["loss"]), float(m1["loss"])))
    out["train"] = {
        "losses": losses,
        "params": [(a.numpy(), b.full_tensor().numpy()) for a, b in zip(tree_leaves(p0), tree_leaves(p1))],
        "shards": shards_match_specs(p1, grid) and shards_match_specs(o1["m"], grid),
    }
    out["local_map"] = dict(LOCAL_MAP_CALLS)
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


