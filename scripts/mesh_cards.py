#!/usr/bin/env python3
"""Every decoder family's sharded engine across four cards, one process a
card under ``torchrun`` (NCCL; gloo with ``--device cpu``):

    torchrun --nnodes 1 --nproc-per-node 4 --master-addr localhost --master-port 29518 \\
        scripts/mesh_cards.py                       # four cards
    torchrun ... scripts/mesh_cards.py --device cpu # a dry run on CPU ranks, at reduced size
    torchrun ... scripts/mesh_cards.py --arch granite-3-2b --arch xlstm-125m   # some archs only
    python3 scripts/mesh_cards.py --predict     # the predicted launches and weight bytes, no device
    torchrun --nproc-per-node 1 ... scripts/mesh_cards.py --witness-only   # one card's rounding witnesses

Each arch of :data:`ARCHS` runs at full width in f32, at the depth one card
holds (:data:`ARCHS`; qwen3-32b at the deepest whose f32 weights stay under
:data:`WEIGHT_CAP` bytes), its weights ``init_lm``'s from one seed, and
every MoE at capacity factor E / k (nothing drops). Every rank first serves :data:`SERVE`'s requests (all at t = 0)
with the meshless engine on its own card (the witness; phi-3-vision, a VLM,
through ``static_generate`` with an image prefix), then all ranks serve
them on ``replica_meshes(make_fleet_mesh(1))[0]``, the (data 1, model 4)
mesh. Gates, each of which, failed, is printed naming the arch and the
gate; the next arch runs, and the script exits non-zero at the end (the
record, written after each arch, holds the failed archs too):

* tokens: on every request the sharded tokens equal the witness's up to
  its first difference, which may only fall where the witness's
  teacher-forced top-2 margin is below :data:`NEAR_TIE` of its largest
  |logit| (the rest of that request follows from a different token and
  is not compared); every rank returns the same tokens;
* teacher-forced: the sharded prefill (``lm_prefill``) of the prompts
  followed by the witness's tokens: its logits within ``TF_TOL·(1 +
  |ref|)`` of the meshless prefill's. An arch with no attention layer
  (xLSTM) is held instead to the exact answer, the meshless prefill in f64
  (``xlstm_rounding.float64_model``): the sharded prefill's largest error
  against it at most the meshless f32 prefill's own plus ``TF_TOL``, each
  in units of ``1 + |exact|``. Its f32 floor lies above ``TF_TOL`` (on one
  device its f32 logits part from f64 by more than that, and from one
  another when each request runs alone; ``scripts/xlstm_rounding.py``), so
  two f32 runs that sum in different orders cannot be held closer;
* launches: #5 (flash attention) ``attention layers × prefills`` and #8
  (flash decode) ``attention layers × decode steps`` on every rank, the
  meshless and sharded runs alike, every sharded launch through
  ``local_map`` and on H/4 query heads over KH/4 KV heads (#5 and #8 only
  where the arch has them: xLSTM has neither, the static VLM no #8);
* MoE: 0 slots dropped.

Printed, not gated: each arch's depth, weight bytes a card, tok/s and TTFT
sharded and meshless, peak memory a card, the ``local_map`` calls; the
same teacher-forced gap over every position (``lm_forward``), and beside
it two rounding witnesses of the meshless run against itself: its forward
when one token's input embedding goes one ulp up, and its forward and
prefill of each request alone (other matmul shapes, so other sums) against
the batch's; then the same arch in bf16 on (1, 4) against its own one-card bf16 run (weights
made in bf16): the positions that agree, whether every rank returned the
same tokens, tok/s.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.config.model import reduced_variant  # noqa: E402
from repro_torch.config.registry import get_arch  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.dispatch import LOCAL_MAP_CALLS, reset_local_map_calls  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_fleet_mesh, replica_meshes  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.transformer import init_lm, layer_kinds, lm_forward  # noqa: E402
from repro_torch.serve import ContinuousScheduler, EngineConfig, Request, ServeEngine, static_generate  # noqa: E402
from repro_torch.serve.metrics import latency_summary  # noqa: E402
from repro_torch.sharding.partition import (  # noqa: E402
    infer_param_specs, map_with_path, mesh_axes_of, mesh_context, shard_params, whole,
)
from repro_torch.utils.device import disable_tf32  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402
from xlstm_rounding import float64_config, float64_model, rel_gap, to_float64  # noqa: E402

#: Each arch's depth on one card in f32: None is full depth, "cap" the
#: deepest whose f32 weights stay under WEIGHT_CAP; the others are the cut
#: depths of ``chip_smoke.py``'s f32 checks.
ARCHS = {
    "granite-3-2b": None,
    "qwen3-32b": "cap",
    "internlm2-20b": 4,
    "mixtral-8x7b": 4,
    "qwen3-moe-235b-a22b": 2,
    "jamba-v0.1-52b": 8,
    "xlstm-125m": None,
    "phi-3-vision-4.2b": None,
}
WEIGHT_CAP = 60e9
SERVE = dict(requests=6, prompt=128, gen=32, slots=4, page=16, chunk=16)
#: ``--device cpu``: the reduced variants, at a small stream; granite keeps
#: a GQA group over 4 ranks and a vocabulary 4 does not divide
SERVE_REDUCED = dict(requests=6, prompt=16, gen=8, slots=4, page=8, chunk=4)
REDUCED = {"granite-3-2b": dict(num_heads=8, num_kv_heads=4, vocab_size=515)}
NEAR_TIE = 1e-4
TF_TOL = 1e-4


class GateFailed(Exception):
    """Gates an arch failed, with the arch's record (``rec``)."""

    def __init__(self, msg: str, rec: dict):
        super().__init__(msg)
        self.rec = rec


def arch_cfg(name: str, dtype: str, reduced: bool):
    """The arch at full width and its card depth (or its reduced variant),
    in ``dtype``, MoE at capacity factor E / k."""
    full = get_arch(name)
    cfg = full.replace(dtype=dtype, param_dtype=dtype)
    depth = ARCHS[name]
    if reduced:
        cfg = reduced_variant(cfg).replace(dtype=dtype, param_dtype=dtype, **REDUCED.get(name, {}))
    elif depth == "cap":
        per_layer = (full.replace(num_layers=2).param_count() - full.replace(num_layers=1).param_count())
        outside = full.replace(num_layers=1).param_count() - per_layer
        cfg = cfg.replace(num_layers=int((WEIGHT_CAP / 4 - outside) // per_layer))
    elif depth is not None:
        cfg = cfg.replace(num_layers=depth)
    if cfg.num_experts:
        cfg = cfg.replace(moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    return cfg


def make_params(cfg, dev):
    """``init_lm`` from seed 1 on ``dev``: the same values on every card."""
    return init_lm(cfg, torch.Generator(device=dev).manual_seed(1))


def attention_layers(cfg) -> int:
    return sum(1 for mixer, _ in layer_kinds(cfg) if mixer == "attn")


def predicted_launches(cfg, serve_cfg) -> dict:
    """#5 once an attention layer a prefill, #8 once an attention layer a
    decode step. The requests all arrive at t = 0 with the same budget, so
    they are served in waves of ``slots``: a prefill and ``gen - 1`` decode
    steps a wave. The VLM's static batch is one prefill, decoded against
    the dense cache (no #8)."""
    s, attn = serve_cfg, attention_layers(cfg)
    if cfg.frontend == "vision":
        return {"flash_attention_fwd": attn, "flash_decode": 0}
    waves = -(-s["requests"] // s["slots"])
    return {"flash_attention_fwd": attn * waves, "flash_decode": attn * waves * (s["gen"] - 1)}


def predicted_bytes(cfg, model: int) -> tuple:
    """The weight bytes whole and on one rank of the (1, ``model``) mesh,
    from the specs of the params on ``meta`` (a split that does not divide
    gives rank 0 the larger share)."""
    from repro_torch.launch.specs import param_specs

    params, axes = param_specs(cfg), {"data": 1, "model": model}
    specs = infer_param_specs(params, axes)
    whole_b = card_b = 0
    flat = []
    map_with_path(lambda _, sp: flat.append(sp), specs, is_leaf=lambda sp: type(sp).__name__ == "PartitionSpec")
    for leaf, spec in zip(tree_leaves(params), flat):
        size = leaf.element_size()
        whole_b += leaf.numel() * size
        split = lambda e: int(np.prod([axes[a] for a in ((e,) if isinstance(e, str) else e)])) if e else 1
        dims = [-(-n // split(e)) for n, e in zip(leaf.shape, tuple(spec) + (None,) * leaf.dim())]
        card_b += int(np.prod(dims)) * size
    return whole_b, card_b


class Watch:
    """While open: the calls of #5 and #8 (through the wrappers the
    attention layer calls; each launches its kernel once on a card) with
    their local heads, and the slots every MoE dispatch drops (device sums,
    read at close)."""

    def __init__(self):
        self.heads, self.calls, self.dropped = set(), {"#5": 0, "#8": 0}, []
        self.saved = (attn_lib.flash_attention, attn_lib.flash_decode, moe_lib._positions_in_expert)

    def __enter__(self):
        fa, fd, positions = self.saved

        def flash_attention(q, k, v, **kw):
            self.heads.add(("#5", q.shape[-2], k.shape[-2]))
            self.calls["#5"] += 1
            return fa(q, k, v, **kw)

        def flash_decode(q, kp, vp, *a, **kw):
            self.heads.add(("#8", q.shape[-2], kp.shape[-2]))
            self.calls["#8"] += 1
            return fd(q, kp, vp, *a, **kw)

        def counted(idx, cfg):
            pos = positions(idx, cfg)
            cap = moe_lib._capacity(cfg, idx.shape[1])
            self.dropped.append((whole(pos) >= cap).sum())
            return pos

        attn_lib.flash_attention, attn_lib.flash_decode, moe_lib._positions_in_expert = (
            flash_attention, flash_decode, counted)
        return self

    def __exit__(self, *exc):
        attn_lib.flash_attention, attn_lib.flash_decode, moe_lib._positions_in_expert = self.saved
        self.dropped = int(sum(int(d) for d in self.dropped))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--arch", action="append", choices=list(ARCHS), help="run only these (repeatable)")
    p.add_argument("--skip-bf16", action="store_true", help="only the f32 gates")
    p.add_argument("--predict", action="store_true", help="print the predicted launches and weight bytes")
    p.add_argument("--witness-only", action="store_true",
                   help="only the meshless run's rounding witnesses (any world size; no gate)")
    p.add_argument("--out", help="write the record (JSON) here")
    args = p.parse_args()
    if args.predict:
        for name in args.arch or list(ARCHS):
            cfg = arch_cfg(name, "float32", False)
            whole_b, card_b = predicted_bytes(cfg, 4)
            print(f"{name}: {cfg.num_layers} layers ({attention_layers(cfg)} attention), {cfg.num_heads}/"
                  f"{cfg.num_kv_heads} heads -> {cfg.num_heads // 4}/{cfg.num_kv_heads // 4} a card at hd "
                  f"{cfg.head_dim}; f32 weight bytes {whole_b} whole, {card_b} a card; launches a rank "
                  f"{json.dumps(predicted_launches(cfg, SERVE))}", flush=True)
        return
    init_distributed(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    on_card = args.device == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    if not on_card:
        torch.set_num_threads(1)
    disable_tf32()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reduced = not on_card
    serve_cfg = SERVE_REDUCED if reduced else SERVE
    mesh = replica_meshes(make_fleet_mesh(1, device_type=dev.type))[0]
    model = mesh_axes_of(mesh)["model"]

    # the gates an arch failed: its run goes on to its end, so that every
    # rank takes part in every collective, and then stops (GateFailed)
    failed_gates = []

    def fail(arch: str, gate: str, msg: str) -> None:
        failed_gates.append(f"FAIL {arch}: gate {gate}: {msg}")

    def say(*a):
        if rank == 0:
            print(*a, flush=True)

    def gathered(obj):
        got = [None] * world
        dist.all_gather_object(got, obj)
        return got

    if on_card:  # every card's name and power limit, as nvidia-smi gives them
        import subprocess

        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    else:
        cards = ["cpu"]
    say(f"cards {cards}, world {world}, mesh {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}, torch "
        f"{torch.__version__}")

    def stream(cfg):
        from repro_torch.data.synthetic import make_token_stream

        s = serve_cfg
        tokens = make_token_stream(7, cfg.vocab_size, s["requests"], s["prompt"])["tokens"][:, : s["prompt"]]
        batch = {"tokens": torch.as_tensor(tokens.astype(np.int32), device=dev)}
        if cfg.frontend == "vision":
            g = torch.Generator(device=dev).manual_seed(3)
            batch["prefix"] = torch.randn((s["requests"], cfg.num_prefix_tokens, cfg.frontend_dim), generator=g,
                                          device=dev) * 0.02
        return tokens.astype(np.int32), batch

    def serve(cfg, params, prompts, batch, sharded):
        """Warm, then the timed run: tokens (R, G), tok/s, TTFT p50, the
        launches, the local_map calls, the #5/#8 local heads, the slots
        dropped and the peak bytes allocated."""
        s = serve_cfg
        on = mesh if sharded else None
        if cfg.frontend == "vision":
            run = lambda: static_generate(params, cfg, batch, s["gen"], mesh=on)
            run()
        else:
            ecfg = EngineConfig(max_slots=s["slots"], max_seq=s["prompt"] + s["gen"], max_new=s["gen"],
                                decode_chunk=s["chunk"], page_size=s["page"], prefill_bucket=s["prompt"])
            eng = ServeEngine(cfg, params, ecfg, mesh=on)
            eng.warmup(prompts[0], 2)
            reqs = [Request(rid=i, tokens=t, max_new_tokens=s["gen"]) for i, t in enumerate(prompts)]
            run = lambda: ContinuousScheduler(eng).run(reqs)
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        reset_local_map_calls()
        with Watch() as watch:
            t0 = time.perf_counter()
            out = run()
            sync()
            wall = time.perf_counter() - t0
        if cfg.frontend == "vision":
            tokens = out.cpu().numpy()
            summary = {"tok_per_s": tokens.size / wall, "ttft_p50_s": float("nan")}
        else:
            tokens = np.stack([c.tokens for c in sorted(out, key=lambda c: c.rid)])
            summary = latency_summary(out, wall)
        launched = {k: launch_counts()[k] for k in ("flash_attention_fwd", "flash_decode")}
        # a CPU rank computes the plain versions: its launches are the calls
        calls = {"flash_attention_fwd": watch.calls["#5"], "flash_decode": watch.calls["#8"]}
        if on_card and launched != calls:
            fail(cfg.name, "launches", f"launches {launched} are not the wrapper calls {calls}")
        return {"tokens": tokens, "tok_per_s": summary["tok_per_s"], "ttft_p50_s": summary["ttft_p50_s"],
                "launches": calls,
                "local_map": {k: v for k, v in LOCAL_MAP_CALLS.items() if v}, "heads": sorted(watch.heads),
                "dropped": watch.dropped, "peak": torch.cuda.max_memory_allocated() if on_card else 0}

    def teacher_forced(cfg, params, batch, tokens, sharded, forward):
        """The f32 logits, on this rank whole, of the prompts followed by
        the witness's tokens: the prefill's (``lm_prefill`` into a fresh
        dense state: the last position's) or, with ``forward``, every
        position's (``lm_forward``)."""
        from repro_torch.models.transformer import init_lm_state, lm_prefill
        from repro_torch.serve.engine import shard_state

        tf = {**batch, "tokens": torch.cat([batch["tokens"], torch.as_tensor(tokens[:, :-1], device=dev)], 1)}
        on = mesh if sharded else None
        with torch.no_grad(), mesh_context(on):
            if forward:
                logits = lm_forward(params, cfg, tf)[0]
            else:
                rows, length = tf["tokens"].shape
                length += tf["prefix"].shape[1] if "prefix" in tf else 0
                logits = lm_prefill(params, cfg, tf, shard_state(init_lm_state(cfg, rows, length, device=dev), on))[0]
        return whole(logits).float()

    def one_ulp_witness(cfg, params, batch, tokens, ref):
        """The meshless forward's own sensitivity: its logits with the
        embedding of the first prompt's first token one ulp up in every
        element, against ``ref``, in units of ``1 + |ref|``."""
        row = params["embed"]["table"][int(batch["tokens"][0, 0])]
        saved = row.clone()
        row.copy_(torch.nextafter(saved, torch.full_like(saved, float("inf"))))
        try:
            nudged = teacher_forced(cfg, params, batch, tokens, False, forward=True)
        finally:
            row.copy_(saved)
        return float(((nudged - ref).abs() / (1 + ref.abs())).max())

    def rows_witness(cfg, params, batch, tokens, ref, ref_prefill) -> tuple:
        """The meshless forward's and prefill's gaps when each request runs
        alone, against the batch's ``ref`` and ``ref_prefill``."""
        alone = lambda i, forward: teacher_forced(cfg, params, {k: v[i:i + 1] for k, v in batch.items()},
                                                  tokens[i:i + 1], False, forward=forward)
        rows = range(len(tokens))
        return (rel_gap(torch.cat([alone(i, True) for i in rows]), ref),
                rel_gap(torch.cat([alone(i, False) for i in rows]), ref_prefill))

    def exact_prefill(cfg, params, batch, tokens):
        """``teacher_forced``'s meshless prefill in f64, for an arch with no
        attention layer (no kernel has an f64 version)."""
        with float64_model():
            return teacher_forced(float64_config(cfg), to_float64(params), batch, tokens, False, forward=False)

    def weight_bytes(params):
        local = lambda t: t.to_local() if hasattr(t, "to_local") else t
        return sum(local(t).numel() * local(t).element_size() for t in tree_leaves(params))

    def check_launches(name, cfg, got, sharded):
        want = predicted_launches(cfg, serve_cfg)
        where = "sharded" if sharded else "meshless"
        if got["launches"] != want:
            fail(name, "launches", f"{where} launches {got['launches']}, predicted {want}")
        if not sharded:
            return
        if got["local_map"].get("flash_attention", 0) != want["flash_attention_fwd"] or \
                got["local_map"].get("flash_decode", 0) != want["flash_decode"]:
            fail(name, "launches", f"local_map calls {got['local_map']} are not the launches {want}")
        heads = {("#5", cfg.num_heads // model, cfg.num_kv_heads // model)} if want["flash_attention_fwd"] else set()
        if want["flash_decode"]:
            heads.add(("#8", cfg.num_heads // model, cfg.num_kv_heads // model))
        if set(map(tuple, got["heads"])) != heads:
            fail(name, "launches", f"local heads {got['heads']}, expected {sorted(heads)}")

    def compare(name, plain, sharded, margins, rel_margins):
        """Per request, positions equal up to the first difference, which
        must fall on a near-tie of the witness; returns the positions that
        agree and the smallest relative margin among the compared."""
        agree, smallest = 0, float("inf")
        for r, (a, b) in enumerate(zip(plain, sharded)):
            diff = np.flatnonzero(a != b)
            upto = int(diff[0]) if len(diff) else len(a)
            if len(diff) and rel_margins[r, upto] >= NEAR_TIE:
                fail(name, "tokens", f"request {r} differs at position {upto}, where the one-card margin is "
                     f"{margins[r, upto]:.3e} ({rel_margins[r, upto]:.3e} of its largest |logit|)")
            agree += upto
            if upto:
                smallest = min(smallest, float(rel_margins[r, :upto].min()))
        return agree, smallest

    def run(name) -> dict:
        """The arch's record; the gates it failed are left in ``failed_gates``."""
        failed_gates.clear()
        t_arch = time.perf_counter()
        cfg = arch_cfg(name, "float32", reduced)
        prompts, batch = stream(cfg)
        params = make_params(cfg, dev)
        bytes_whole = weight_bytes(params)
        say(f"{name} f32: {cfg.num_layers} of {get_arch(name).num_layers} layers, {cfg.num_heads}/"
            f"{cfg.num_kv_heads} heads at hd {cfg.head_dim}, vocab {cfg.vocab_size}, weight bytes {bytes_whole} "
            f"whole, {serve_cfg['requests']} requests x "
            f"({serve_cfg['prompt']} + {serve_cfg['gen']})")
        plain = serve(cfg, params, prompts, batch, sharded=False)
        check_launches(name, cfg, plain, sharded=False)
        ref = teacher_forced(cfg, params, batch, plain["tokens"], False, forward=True)
        ref_prefill = teacher_forced(cfg, params, batch, plain["tokens"], False, forward=False)
        witness = one_ulp_witness(cfg, params, batch, plain["tokens"], ref)
        rows_fwd, rows_prefill = rows_witness(cfg, params, batch, plain["tokens"], ref, ref_prefill)
        exact = None if attention_layers(cfg) else exact_prefill(cfg, params, batch, plain["tokens"])
        floor = None if exact is None else rel_gap(ref_prefill, exact)  # the meshless f32 prefill's own error
        if args.witness_only:
            rec = {"layers": cfg.num_layers, "one_ulp_witness": witness, "rows_witness_forward": rows_fwd,
                   "rows_witness_prefill": rows_prefill, "f32_prefill_vs_f64": floor,
                   "seconds": time.perf_counter() - t_arch}
            say(f"{name} f32 meshless witnesses: {json.dumps(rec)}")
            return rec
        # the witness's top-2 margins at the generated positions
        start = ref.shape[1] - serve_cfg["gen"]
        rows = ref[:, start:]
        top2 = rows.topk(2, dim=-1).values
        margins = (top2[..., 0] - top2[..., 1]).cpu().numpy()
        rel = margins / rows.abs().amax(-1).cpu().numpy()
        params = shard_params(params, mesh)
        gc.collect()  # the whole tree goes, with any meshless engine still holding it
        sync()
        bytes_card = weight_bytes(params)
        sharded = serve(cfg, params, prompts, batch, sharded=True)
        tf = teacher_forced(cfg, params, batch, plain["tokens"], True, forward=True)
        forward_err = rel_gap(tf, ref)
        tf_prefill = teacher_forced(cfg, params, batch, plain["tokens"], True, forward=False)
        tf_err = rel_gap(tf_prefill, ref_prefill)
        exact_err = None if exact is None else rel_gap(tf_prefill, exact)
        del params, tf, ref, rows
        if on_card:
            torch.cuda.empty_cache()
        check_launches(name, cfg, sharded, sharded=True)
        if exact is None and tf_err > TF_TOL:
            fail(name, "teacher-forced", f"the sharded prefill's logits differ from the meshless by {tf_err:.3e}·(1 + "
                 f"|ref|)")
        if exact is not None and exact_err > floor + TF_TOL:
            fail(name, "teacher-forced", f"the sharded prefill's logits differ from the f64 prefill by "
                 f"{exact_err:.3e}·(1 + |exact|), the meshless f32 prefill's by {floor:.3e}")
        for where in (plain, sharded):
            if where["dropped"]:
                fail(name, "moe", f"{where['dropped']} slots dropped at capacity factor {cfg.moe_capacity_factor}")
        agree, smallest = compare(name, plain["tokens"], sharded["tokens"], margins, rel)
        ranks = gathered(sharded["tokens"].tolist())
        if any(r != ranks[0] for r in ranks):
            fail(name, "tokens", "the ranks returned different tokens")
        rec = {"layers": cfg.num_layers, "weight_bytes_whole": bytes_whole, "weight_bytes_card": bytes_card,
               "positions_agree": agree, "positions": int(plain["tokens"].size),
               "smallest_rel_margin": smallest, "smallest_margin": float(margins.min()),
               "teacher_forced_err": tf_err, "sharded_prefill_vs_f64": exact_err, "f32_prefill_vs_f64": floor,
               "forward_err": forward_err, "one_ulp_witness": witness,
               "rows_witness_forward": rows_fwd, "rows_witness_prefill": rows_prefill, "launches": sharded["launches"], "local_heads": sharded["heads"],
               "local_map": sharded["local_map"], "dropped": sharded["dropped"],
               "tok_per_s": sharded["tok_per_s"], "tok_per_s_meshless": plain["tok_per_s"],
               "ttft_p50_s": sharded["ttft_p50_s"], "ttft_p50_s_meshless": plain["ttft_p50_s"],
               "peak_bytes": max(gathered(sharded["peak"])), "peak_bytes_meshless": plain["peak"]}
        say(f"{name} f32 on (1, {model}): {json.dumps(rec)}")
        if not args.skip_bf16:
            bf = arch_cfg(name, "bfloat16", reduced)
            params = make_params(bf, dev)
            plain = serve(bf, params, prompts, batch, sharded=False)
            params = shard_params(params, mesh)
            sharded = serve(bf, params, prompts, batch, sharded=True)
            del params
            if on_card:
                torch.cuda.empty_cache()
            agree = sum(int(np.flatnonzero(a != b)[0]) if (a != b).any() else len(a)
                        for a, b in zip(plain["tokens"], sharded["tokens"]))
            ranks = gathered(sharded["tokens"].tolist())
            rec["bf16"] = {"positions_agree": agree, "every_rank_same": all(r == ranks[0] for r in ranks),
                           "tok_per_s": sharded["tok_per_s"], "tok_per_s_meshless": plain["tok_per_s"],
                           "launches": sharded["launches"]}
            say(f"{name} bf16 on (1, {model}): {json.dumps(rec['bf16'])}")
        rec["seconds"] = time.perf_counter() - t_arch
        if failed_gates:
            rec["failed_gates"] = list(failed_gates)
            raise GateFailed("; ".join(failed_gates), rec)
        say(f"{name}: all gates met, {rec['seconds']:.1f} s")
        return rec

    record, failed = {}, {}
    for name in args.arch or list(ARCHS):
        try:
            record[name] = run(name)
        except Exception as e:  # a gate or a fault, alike on every rank: on to the next arch
            failed[name] = f"{type(e).__name__}: {e}"
            if isinstance(e, GateFailed):
                record[name] = e.rec
            if rank == 0:
                traceback.print_exc()
            say(f"{name} FAILED: {failed[name]}")
            if on_card:
                torch.cuda.empty_cache()
        if args.out and rank == 0:  # after each arch, so that a run cut short keeps what it measured
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps({"cards": cards, "torch": torch.__version__, "record": record,
                                                  "failed": failed}, indent=1))
    dist.destroy_process_group()
    if failed:
        raise SystemExit(f"mesh cards: {len(failed)} archs failed: {json.dumps(failed)}")
    say(f"mesh cards: every gate met for {len(record)} archs")


if __name__ == "__main__":
    main()
