"""The ranks of ``tests/test_torch_mesh_families.py``: each is a gloo
process that serves every decoder family's reduced config meshless, on the
(1, 4) mesh and on its (1, 2) pair, on the inputs of :func:`inputs` (made
from fixed seeds, the same in every process), and writes what it got; the
test's own process compares. This module imports no JAX, so a rank starts
with the port's imports alone."""
from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist

from torch_mesh_ranks import shards_match_specs

WORLD = 4
THREADS = 2  # intra-op threads a rank
#: The registered decoder archs, each with the overrides of its reduced
#: variant: granite at 8 query heads over 4 KV heads (a GQA group of 2 on
#: each rank of model 2, one KV head a rank at model 4) and an odd
#: vocabulary that neither 2 nor 4 divides (the logits of several positions
#: split by sequence, one position's whole); every MoE at capacity factor
#: E / k, where no slot drops; jamba's interleave group cut to 4 layers
#: (Mamba with an MLP, Mamba with a MoE, attention, Mamba with a MoE) and
#: xLSTM's to one mLSTM and one sLSTM block, every mechanism kept at half
#: the depth.
ARCHS = {
    "granite-3-2b": dict(num_heads=8, num_kv_heads=4, vocab_size=515),
    "qwen3-32b": {},
    "internlm2-20b": {},
    "mixtral-8x7b": dict(moe_capacity_factor=2.0),
    "qwen3-moe-235b-a22b": dict(moe_capacity_factor=2.0),
    "jamba-v0.1-52b": dict(num_layers=4, attn_every=4, moe_capacity_factor=2.0),
    "xlstm-125m": dict(num_layers=2, slstm_every=2),
    "phi-3-vision-4.2b": {},
}
#: the VLM is served by the static generator (the engine refuses it)
STATIC = ("phi-3-vision-4.2b",)
MESHES = ("1x4", "1x2")
ENGINE = dict(max_slots=3, max_seq=32, max_new=6, decode_chunk=3, page_size=8)
GEN = 4
PROMPT_LENS = (9, 20, 6)
STATIC_PROMPT = 6
#: granite also serves with a drafter: its verify is an ``lm_extend`` of
#: SPEC_K + 1 = 4 positions, whose logits take the sequence split (4 and 2
#: divide 4) and whose K/V reads gather pages
ODD_VOCAB = "granite-3-2b"
SPEC_K = 3


def port_cfg(name):
    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch

    cfg = reduced_variant(get_arch(name)).replace(dtype="float32", param_dtype="float32", **ARCHS[name])
    assert not cfg.num_experts or cfg.moe_capacity_factor == cfg.num_experts / cfg.experts_per_token
    return cfg


def routes(name, spec: bool = False) -> tuple:
    """The ``LOCAL_MAP_CALLS`` keys ``name``'s sharded serving takes (with
    a drafter where ``spec``)."""
    cfg = port_cfg(name)
    if name in STATIC:  # the static path decodes against the dense cache
        keys = ["flash_attention", "kv_scatter"]
    elif cfg.ssm_kind == "xlstm":  # carries only, no KV pages
        keys = ["kv_scatter"]
    elif spec:  # a verify (every decode step) reads the pool through the page table
        keys = ["flash_attention", "kv_scatter", "page_gather"]
    else:  # the paged engine
        keys = ["flash_attention", "flash_decode", "kv_scatter"]
    if cfg.num_experts:
        keys.append("moe_dispatch")
    if cfg.ssm_kind:
        keys.append("recurrent_scan")
    return tuple(keys)


def inputs() -> dict:
    """The port's weights (``init_lm``; the test's process carries them to
    JAX) with a wider embedding, which spreads the random model's logits so
    greedy tokens are decided by wide top-2 margins; the prompts; phi's
    image prefix."""
    from repro_torch.models.transformer import init_lm

    rng = np.random.RandomState(11)
    inp = {"params": {}, "prompts": {}, "drafter": init_lm(port_cfg(ODD_VOCAB), torch.Generator().manual_seed(40))}
    for i, name in enumerate(ARCHS):
        cfg = port_cfg(name)
        p = init_lm(cfg, torch.Generator().manual_seed(20 + i))
        p["embed"]["table"] = p["embed"]["table"] * 10.0
        inp["params"][name] = p
        if name in STATIC:
            inp["prompts"][name] = {
                "tokens": rng.randint(0, cfg.vocab_size, size=(2, STATIC_PROMPT)).astype(np.int32),
                "prefix": (rng.standard_normal((2, cfg.num_prefix_tokens, cfg.frontend_dim)) * 0.02).astype(
                    np.float32),
            }
        else:
            inp["prompts"][name] = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in PROMPT_LENS]
    return inp


def _serve(cfg, params, prompts, mesh=None, drafter=None):
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine

    eng = ServeEngine(cfg, params, EngineConfig(**ENGINE, spec_k=SPEC_K if drafter else 0), mesh=mesh,
                      drafter=drafter and (cfg, drafter))
    comps = ContinuousScheduler(eng, clock=ManualClock()).run(
        [Request(rid=i, tokens=p, max_new_tokens=GEN) for i, p in enumerate(prompts)]
    )
    return [c.tokens.tolist() for c in comps], eng


def _static(cfg, params, batch, mesh=None):
    from repro_torch.serve import static_generate
    from repro_torch.sharding import shard_params

    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mesh is not None:
        params = shard_params(params, mesh)
    return static_generate(params, cfg, batch, GEN, mesh=mesh).tolist(), params


def _logit_placements(run):
    """``run()``'s result and the (positions, placements) of every sharded
    logits tensor ``lm_logits`` returned during it."""
    from repro_torch.models import transformer

    seen, plain = set(), transformer.lm_logits

    def recorded(*args):
        out = plain(*args)
        if hasattr(out, "placements"):  # the drafter runs meshless
            seen.add((out.shape[1], tuple(out.placements)))
        return out

    transformer.lm_logits = recorded
    try:
        return run(), seen
    finally:
        transformer.lm_logits = plain


def rank_main(rank: int, tmp: str) -> None:
    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank, world_size=WORLD)
    from repro_torch.kernels.dispatch import LOCAL_MAP_CALLS, reset_local_map_calls
    from repro_torch.launch.mesh import make_fleet_mesh, replica_meshes

    inp = inputs()
    pair = rank // 2  # ranks {0, 1} and {2, 3}
    meshes = {"1x4": replica_meshes(make_fleet_mesh(1, device_type="cpu"))[0],
              "1x2": replica_meshes(make_fleet_mesh(2, device_type="cpu"))[pair]}
    out = {"tokens": {}, "shards": {}, "local_map": {}, "logits": {}}
    for i, name in enumerate(ARCHS):
        cfg, params, prompts = port_cfg(name), inp["params"][name], inp["prompts"][name]
        run = _static if name in STATIC else _serve
        out["tokens"][name, "none"] = run(cfg, params, prompts)[0]
        # every arch on the (1, 4) mesh; the two pairs share the (1, 2) runs
        for mname in MESHES if i % 2 == pair else MESHES[:1]:
            reset_local_map_calls()
            tokens, placed = run(cfg, params, prompts, meshes[mname])
            out["tokens"][name, mname] = tokens
            out["shards"][name, mname] = shards_match_specs(placed if name in STATIC else placed.params,
                                                             meshes[mname])
            out["local_map"][name, mname] = dict(LOCAL_MAP_CALLS)
    # granite with a drafter on both meshes: the tokens and the logits'
    # placements
    cfg, params, prompts = port_cfg(ODD_VOCAB), inp["params"][ODD_VOCAB], inp["prompts"][ODD_VOCAB]
    for mname in MESHES:
        reset_local_map_calls()
        (tokens, _), out["logits"][mname] = _logit_placements(
            lambda: _serve(cfg, params, prompts, meshes[mname], drafter=inp["drafter"]))
        out["tokens"]["spec", mname] = tokens
        out["local_map"]["spec", mname] = dict(LOCAL_MAP_CALLS)
    with open(f"{tmp}/out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
