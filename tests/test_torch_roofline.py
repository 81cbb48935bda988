"""The port's roofline and dry-run (``repro_torch.roofline``,
``repro_torch.launch.specs``, ``repro_torch.launch.dryrun``,
``repro_torch.config.shapes``) against the JAX package's.

* The input shapes, ``list_archs``, ``arch_supports_shape`` (skips and
  reasons) and ``model_flops`` equal the reference's for every arch ×
  shape; ``input_specs`` give the reference's shapes and dtypes for every
  family; ``tree_size`` and ``tree_bytes`` the reference's on the same
  params.
* ``roofline_report``'s terms equal the reference's on the same counts
  (the reference fed HLO text and a stub compiled object, the port the
  counts its HLO walker gives, under a ``HardwareSpec`` holding the
  reference's numbers); under the default ``H100`` each term is its count
  over the H100's constant. ``report.markdown_table`` equals the
  reference's.
* One step at a tiny smollm-135m (2 layers, d_model 64, 4/2 heads, d_ff
  128, vocab 256, B=2, S=32, ``backend="ref"``): the port's FLOPs, counted
  on ``meta``, equal the reference's ``HloCost`` on a 1×1 mesh for prefill
  and decode; the train step differs by exactly the products the
  reference's two-pass flash backward recomputes (below). On ``meta`` the
  counter's aten FLOPs equal ``FlopCounterMode``'s over the same step run
  on real CPU tensors.
* Every registered arch, reduced, counts ``ok`` meshless for each step
  kind it supports (nothing reads back to the host), with the attention
  kernels counted once an attention layer a pass.
* The moved kernel formulas (``kernels.kernel_cost``) give the kernel
  table's bounds; every kernel wrapper given ``meta`` tensors returns the
  outputs' shapes and records its call, and neither launches nor touches
  ``ctypes``.
* One subprocess (a 4-rank fake world; the CLI builds its own worlds):
  the counter counts an all-gather, all-reduce, reduce-scatter, all-to-all
  and broadcast of known local sizes as their output bytes; the
  sequence-split cache writes put rank 0's rows where a plain write does;
  the CLI writes ``ok`` records on ``--mesh-shape 2x2`` and ``2x2x2`` for
  train and ``--coboost 2``, collective bytes > 0 there and 0 meshless.

``repro.launch.dryrun`` is never imported: it sets ``XLA_FLAGS`` to 512
devices at import, which would leak into later JAX tests on this worker.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.config import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.config import arch_supports_shape as jax_arch_supports_shape
from repro.config import get_arch as jax_get_arch
from repro.config import list_archs as jax_list_archs
from repro.config import reduced_variant as jax_reduced_variant
from repro.config.shapes import ShapeConfig as JaxShapeConfig
from repro.kernels.dispatch import BackendPolicy as JaxBackendPolicy
from repro.launch import specs as jax_specs
from repro.launch.mesh import compat_make_mesh
from repro.roofline import V5E
from repro.roofline import model_flops as jax_model_flops
from repro.roofline import report as jax_report
from repro.roofline import roofline_report as jax_roofline_report
from repro.roofline.hlo_cost import HloCost
from repro.utils.trees import tree_bytes as jax_tree_bytes
from repro.utils.trees import tree_size as jax_tree_size
from repro_torch.config import INPUT_SHAPES, ShapeConfig, arch_supports_shape, get_arch, list_archs, reduced_variant
from repro_torch.config.mesh import HBM_BW, HBM_BYTES, ICI_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32
from repro_torch.kernels.build import LAUNCHES
from repro_torch.launch.specs import build_coboost_program, build_program, input_specs, param_specs
from repro_torch.models.transformer import layer_kinds
from repro_torch.roofline import H100, HardwareSpec, model_flops, report, roofline_report
from repro_torch.kernels.kernel_cost import attention_fwd_work, bound_ms, decode_work, loss_work, peak_flops
from repro_torch.roofline.op_cost import COLLECTIVES, OpCounter, count_step
from repro_torch.utils.trees import tree_bytes, tree_size

REPO = Path(__file__).resolve().parents[1]
ARCHS = jax_list_archs()
# one arch a family: dense, moe, ssm, hybrid, audio, vlm
FAMILY_ARCHS = ("smollm-135m", "qwen3-moe-235b-a22b", "xlstm-125m", "jamba-v0.1-52b", "hubert-xlarge",
                "phi-3-vision-4.2b")
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
TINY_B, TINY_S = 2, 32
SMALL_S = 20  # every arch's steps (a reduced VLM puts its 16 patches first)
KINDS = ("train", "prefill", "decode")


# ---------------------------------------------------------------------------
# the CLI and the collectives: one subprocess, started with the module and
# read by the last tests, so that it runs beside the rest of the file

_SUBPROCESS = textwrap.dedent('''
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import dryrun
    from repro_torch.models.attention import write_positions, write_rows
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.sharding.partition import mesh_context

    out = {"records": []}
    if sys.argv[2] == "2x2x2":  # the slow one (DTensor on a 3-D mesh), in a process of its own
        for extra in ([], ["--coboost", "2"]):
            path = sys.argv[1] + f"/dryrun-{len(extra)}.json"
            dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k", "--mesh-shape", "2x2x2", "--out", path,
                         *[a for kv in ("num_layers=2", "d_model=64", "num_heads=4", "num_kv_heads=2", "d_ff=128",
                                        "vocab_size=256") for a in ("--override", kv)], *extra])
            out["records"] += json.load(open(path))
        print(json.dumps(out))
        sys.exit(0)
    torch.manual_seed(0)
    dryrun.fake_world(4)
    group = dist.group.WORLD
    x = torch.empty(8, 16, device="meta")
    with OpCounter() as c:
        for fn in (lambda: funcol.all_gather_tensor(x, 0, group), lambda: funcol.all_reduce(x, "sum", group),
                   lambda: funcol.reduce_scatter_tensor(x, "sum", 0, group),
                   lambda: funcol.all_to_all_single(x, None, None, group), lambda: funcol.broadcast(x, 0, group)):
            funcol.wait_tensor(fn())
    out["collectives"] = c.totals()["collectives"]

    # the sequence-split cache writes on rank 0's shard of a (2, 2) mesh
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    full = torch.randn(4, 8, 2, 4)
    vals, pos = torch.randn(4, 2, 4), torch.tensor([1, 6, 3, 0], dtype=torch.int32)
    want = full.clone()
    want[torch.arange(4), pos.long()] = vals
    buf = DTensor.from_local(full[:2, :4].clone(), mesh, [Shard(0), Shard(1)], run_check=False)
    with mesh_context(mesh):
        write_positions(buf, pos, vals)
    out["write_positions"] = bool(torch.equal(buf.to_local(), want[:2, :4]))
    tail = torch.randn(4, 8, 2, 4)
    buf = DTensor.from_local(full[:2, :4].clone(), mesh, [Shard(0), Shard(1)], run_check=False)
    with mesh_context(mesh):
        write_rows(buf, (slice(None), slice(None)), tail)
    out["write_rows"] = bool(torch.equal(buf.to_local(), tail[:2, :4]))

    tiny = [a for kv in ("num_layers=2", "d_model=64", "num_heads=4", "num_kv_heads=2", "d_ff=128",
                         "vocab_size=256") for a in ("--override", kv)]
    out["records"] = []
    for mesh_shape in sys.argv[2].split(","):
        for extra in ([], ["--coboost", "2"]):
            path = sys.argv[1] + f"/dryrun-{mesh_shape}.json"
            try:
                dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k", "--mesh-shape", mesh_shape,
                             "--out", path, *tiny, *extra])
            except SystemExit as e:
                out["records"].append({"status": "error", "exit": str(e), "mesh": mesh_shape})
                continue
            out["records"] += json.load(open(path))
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """Two processes, started together: the collectives, the writes and the
    CLI on ``2x2`` and ``host``; the CLI on ``2x2x2``."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _SUBPROCESS, str(tmp_path_factory.mktemp("dryrun")), meshes],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for meshes in ("2x2,host", "2x2x2")]
    yield procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(autouse=True)
def _start_cli(cli_run):
    """Start the subprocess with the file's first test."""


def _cli_result(procs):
    for proc in procs:
        if not hasattr(proc, "result"):
            stdout, stderr = proc.communicate(timeout=240)
            assert proc.returncode == 0, stderr[-4000:]
            proc.result = json.loads(stdout.strip().splitlines()[-1])
    first, second = (proc.result for proc in procs)
    return dict(first, records=first["records"] + second["records"])


# ---------------------------------------------------------------------------
# shapes, skips, model FLOPs, input specs, tree sizes


def test_input_shapes_and_archs_equal_the_reference():
    assert list_archs() == jax_list_archs()
    assert list(INPUT_SHAPES) == list(JAX_INPUT_SHAPES)
    for name, s in INPUT_SHAPES.items():
        j = JAX_INPUT_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind, s.tokens) == (j.name, j.seq_len, j.global_batch, j.kind,
                                                                           j.tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_skips_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for name, shape in INPUT_SHAPES.items():
        assert arch_supports_shape(cfg, shape) == jax_arch_supports_shape(jcfg, JAX_INPUT_SHAPES[name])
        assert model_flops(cfg, shape) == jax_model_flops(jcfg, JAX_INPUT_SHAPES[name])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_input_specs_equal_the_reference(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for name, shape in INPUT_SHAPES.items():
        got, want = input_specs(cfg, shape), jax_specs.input_specs(jcfg, JAX_INPUT_SHAPES[name])
        assert list(got) == list(want), name
        for k, t in got.items():
            assert t.is_meta
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), (name, k)


@pytest.mark.parametrize("arch", ("smollm-135m", "jamba-v0.1-52b"))
def test_tree_size_and_bytes_equal_the_reference(arch):
    """The params of the reduced config, on ``meta`` (the port's layer list)
    and as the reference's ``eval_shape`` (its stacked groups)."""
    cfg = reduced_variant(get_arch(arch)).replace(dtype="float32", param_dtype="float32")
    jcfg = jax_reduced_variant(jax_get_arch(arch)).replace(dtype="float32", param_dtype="float32")
    params, jparams = param_specs(cfg), jax_specs.param_specs(jcfg)
    assert tree_size(params) == jax_tree_size(jparams)
    assert tree_bytes(params) == jax_tree_bytes(jparams)


# ---------------------------------------------------------------------------
# the roofline record


HLO_SAMPLE = """
HloModule test
ENTRY %main.1 (p0: f32[128,256]) -> f32[128,256] {
  %p0 = f32[128,256]{1,0} parameter(0)
  %ag = f32[128,4096]{1,0} all-gather(%p0), dimensions={1}
  %ar.1 = bf16[64,64]{1,0} all-reduce(%x), to_apply=%add
  %rs = f32[8,256]{1,0} reduce-scatter(%y), dimensions={0}
  %a2a = f32[16,16]{1,0} all-to-all(%z), dimensions={0}
  %cp = bf16[4,4]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
  %dot = f32[128,256]{1,0} dot(%p0, %p0), lhs_contracting_dims={1}
}
"""
HLO_DOTS = """
HloModule dots
ENTRY %main.2 (p0: f32[2048,2048], p1: f32[2048,2048]) -> f32[2048,2048] {
  %p0 = f32[2048,2048]{1,0} parameter(0)
  %p1 = f32[2048,2048]{1,0} parameter(1)
  %d0 = f32[2048,2048]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}
  %d1 = f32[2048,2048]{1,0} dot(%d0, %p1), lhs_contracting_dims={1}
}
"""


@pytest.mark.parametrize("hlo,chips,mem", [(HLO_SAMPLE, 256, (3 << 30, 20 << 30)), (HLO_DOTS, 1, (1 << 20, 2 << 20))],
                         ids=("collectives", "dots"))
def test_roofline_terms_equal_the_reference(hlo, chips, mem):
    """The same counts through both records: the reference's from HLO text
    and a stub compiled object, the port's from the counts its walker
    gives, under the reference's hardware numbers."""
    args, temp = mem
    compiled = SimpleNamespace(
        cost_analysis=lambda: {"flops": 1.0},
        memory_analysis=lambda: SimpleNamespace(argument_size_in_bytes=args, output_size_in_bytes=0,
                                                temp_size_in_bytes=temp, generated_code_size_in_bytes=0),
    )
    jcfg, cfg = jax_get_arch("smollm-135m"), get_arch("smollm-135m")
    want = jax_roofline_report(compiled, chips, jcfg, JAX_INPUT_SHAPES["train_4k"], hlo_text=hlo)
    walk = HloCost(hlo).totals()
    counts = {"flops": {"bfloat16": walk["flops"]}, "bytes": walk["bytes"],
              "collectives": {k: walk[k] for k in COLLECTIVES}, "argument_bytes": args, "temp_bytes": temp}
    hw = HardwareSpec(name=V5E.name, peak_flops=V5E.peak_flops, peak_flops_f32=V5E.peak_flops, hbm_bw=V5E.hbm_bw,
                      link_bw=V5E.link_bw, hbm_bytes=V5E.hbm_bytes)
    got = roofline_report(counts, chips, cfg, INPUT_SHAPES["train_4k"], hw=hw)
    assert got["flops_per_device"] == want["hlo_flops_per_device"]
    assert got["flops_global"] == want["hlo_flops_global"]
    assert got["bytes_per_device"] == want["hlo_bytes_per_device"]
    for key in ("chips", "collective_bytes_per_device", "collectives", "compute_s", "memory_s", "collective_s",
                "dominant", "bound_s", "peak_bytes_per_device", "fits_hbm", "model_flops", "useful_flops_ratio",
                "mfu_bound"):
        assert got[key] == want[key], key


def test_h100_terms_are_counts_over_its_constants():
    counts = {"flops": {"float32": 3e12, "bfloat16": 5e13}, "bytes": 7e11,
              "collectives": {"all-gather": 2e9, "reduce-scatter": 1e9}, "argument_bytes": 5 * 10**10,
              "temp_bytes": 4 * 10**10, "kernels": {"flash_attention_fwd": {"calls": 1, "flops": 1, "bytes": 1}}}
    got = roofline_report(counts, 4)
    assert H100.peak_flops == PEAK_FLOPS_BF16 and H100.peak_flops_f32 == PEAK_FLOPS_F32
    assert got["compute_s"] == 3e12 / PEAK_FLOPS_F32 + 5e13 / PEAK_FLOPS_BF16
    assert got["memory_s"] == 7e11 / HBM_BW
    assert got["collective_s"] == 3e9 / ICI_BW
    assert got["collectives"]["all-reduce"] == 0 and got["collective_bytes_per_device"] == 3e9
    assert got["dominant"] == "memory" and got["bound_s"] == got["memory_s"]
    assert got["peak_bytes_per_device"] == 9 * 10**10 and got["fits_hbm"] == (9 * 10**10 <= HBM_BYTES)
    assert got["kernels"] == counts["kernels"] and "model_flops" not in got


def test_report_table_equals_the_reference():
    ok = {"arch": "smollm-135m", "shape": "train_4k", "mesh": "16x16", "status": "ok", "compute_s": 0.0021,
          "memory_s": 0.31, "collective_s": 0.0000123, "dominant": "memory", "useful_flops_ratio": 0.79,
          "peak_bytes_per_device": 4.3e9, "fits_hbm": True,
          "collectives": {"all-gather": 3e9, "all-reduce": 2e5, "reduce-scatter": 1.5e6, "all-to-all": 0,
                          "collective-permute": 12.0}}
    skip = {"arch": "smollm-135m", "shape": "long_500k", "mesh": "16x16", "status": "skip",
            "reason": "long_500k needs sub-quadratic attention (no SWA/SSM path)"}
    error = {"arch": "xlstm-125m", "shape": "train_4k", "mesh": "16x16", "status": "error", "error": "boom"}
    records = [skip, ok, error]
    assert report.markdown_table(records) == jax_report.markdown_table(records)
    assert report.collective_breakdown(records) == jax_report.collective_breakdown(records)


# ---------------------------------------------------------------------------
# one step's FLOPs at the tiny config


def _tiny(kind):
    cfg = get_arch("smollm-135m").replace(backend="ref", **TINY)
    jcfg = jax_get_arch("smollm-135m").replace(backend=JaxBackendPolicy(default="ref"), **TINY)
    return cfg, jcfg, ShapeConfig(kind, TINY_S, TINY_B, kind), JaxShapeConfig(kind, TINY_S, TINY_B, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_step_flops_equal_hlocost(kind):
    """Per device on one device: prefill and decode equal the reference's
    ``HloCost`` exactly. The train step is the reference's less, per
    layer, three (B, H, S, S, hd) products: the reference's
    ``backend="ref"`` attention (``flash_attn_jax``) has a two-pass flash
    backward that rebuilds S = QK^T in both passes and dP = dO·V^T in the
    dk/dv pass, where the port's ``backend="ref"`` is plain autograd,
    which saves P (the port's kernels #6, #7 recompute as the reference
    does, and count so)."""
    cfg, jcfg, shape, jshape = _tiny(kind)
    with jax.set_mesh(compat_make_mesh((1, 1), ("data", "model"))):
        fn, args, in_sh, out_sh = jax_specs.build_program(jcfg, jshape)
        hlo = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile().as_text()
    want = HloCost(hlo).totals()["flops"]
    got = sum(count_step(*build_program(cfg, shape))["flops"].values())
    if kind != "train":
        assert got == want
        return
    h, hd = cfg.num_heads, cfg.head_dim_
    recomputed = cfg.num_layers * 3 * 2 * TINY_B * h * TINY_S * TINY_S * hd
    assert recomputed == 6_291_456
    assert want - got == recomputed


def _real(t):
    """A real CPU tensor in place of a ``meta`` stand-in (ids 0)."""
    if not torch.is_tensor(t):
        return t
    if t.is_floating_point():
        return torch.randn(t.shape, generator=torch.Generator().manual_seed(t.numel()), dtype=torch.float32).to(t.dtype)
    return torch.zeros(t.shape, dtype=t.dtype)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("kind", KINDS)
def test_meta_count_equals_flopcountermode(kind):
    cfg, _, shape, _ = _tiny(kind)
    fn, args = build_program(cfg, shape)
    counted = count_step(fn, args)
    real = _tree(_real, args)
    with FlopCounterMode(display=False) as flop_counter:
        fn(*real)
    assert sum(counted["aten_flops"].values()) == flop_counter.get_total_flops() > 0
    assert counted["flops"] == counted["aten_flops"] and counted["kernels"] == {}


# ---------------------------------------------------------------------------
# every arch, reduced, meshless


def _with_sm90(calls, cfg):
    """The calls under the launch counters: a bf16 call also under its
    tensor-core kernel's name."""
    if cfg.dtype != "bfloat16":
        return calls
    return {**calls, **{f"{n}_sm90": c for n, c in calls.items()}}


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_counts_meshless(arch):
    """Each step kind the arch supports, through the kernels' ``meta``
    branches: finite terms, and #5–#7 counted once an attention layer a
    pass (the reduced configs run without remat)."""
    cfg = reduced_variant(get_arch(arch))
    attn_layers = sum(m == "attn" for m, _ in layer_kinds(cfg))
    for kind in KINDS:
        shape = ShapeConfig(kind, SMALL_S, TINY_B, kind)
        if arch_supports_shape(cfg, shape):
            assert cfg.is_encoder_only and kind == "decode"
            continue
        rec = roofline_report(count_step(*build_program(cfg, shape)), 1, cfg, shape)
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        assert math.isfinite(rec["bound_s"]) and rec["bound_s"] > 0 and rec["fits_hbm"]
        assert rec["collective_bytes_per_device"] == 0
        calls = {n: k["calls"] for n, k in rec["kernels"].items()}
        want = {}
        if kind != "decode" and attn_layers:  # decode attends through the dense cache, plainly
            want["flash_attention_fwd"] = attn_layers
        if kind == "train" and attn_layers:
            want.update(flash_attention_bwd_dq=attn_layers, flash_attention_bwd_dkv=attn_layers)
        assert calls == _with_sm90(want, cfg), kind


def test_coboost_program_counts_meshless():
    cfg = reduced_variant(get_arch("smollm-135m"))
    shape = ShapeConfig("train", SMALL_S, TINY_B, "train")
    counts = count_step(*build_coboost_program(cfg, shape, num_clients=2))
    layers = cfg.num_layers
    # the server's forward and backward, each client's forward (no gradient)
    assert {n: k["calls"] for n, k in counts["kernels"].items()} == _with_sm90(
        {"flash_attention_fwd": 3 * layers, "flash_attention_bwd_dq": layers, "flash_attention_bwd_dkv": layers}, cfg)
    assert counts["temp_bytes"] > 0 and counts["argument_bytes"] > 0


def _every_step(step, carry, n):
    """``utils.scan._steps`` without its ``meta`` shortcut: every step run."""
    ys = []
    for i in range(n):
        carry, y = step(carry, i)
        ys.append(y)
    return carry, ys


@pytest.mark.parametrize("t,chunk", [(12, 12), (12, 4), (64, 16)])
def test_loop_counted_by_its_trip_count(t, chunk, monkeypatch):
    """A recurrence on ``meta`` runs two steps (or chunks) and counts the
    second for the rest: its FLOPs, forward and backward (through the
    chunk checkpoints), equal those of every step run."""
    from repro_torch.utils import scan

    def count():
        w = torch.empty(8, 8, device="meta", requires_grad=True)
        xs = torch.empty(t, 4, 8, device="meta", requires_grad=True)
        h0 = torch.empty(4, 8, device="meta", requires_grad=True)

        def cell(carry, x):
            h = torch.tanh(carry[0] @ w + x)
            return (h,), h

        with OpCounter() as counter:
            (h,), ys = scan.chunked_scan(cell, (h0,), xs, chunk=chunk)
            forward = counter.snapshot()["flops"]
            torch.autograd.grad(ys.sum() + h.sum(), (w, xs, h0))
        return forward, counter.totals()["flops"]

    fast = count()
    monkeypatch.setattr(scan, "_steps", _every_step)
    assert fast == count()


def test_xlstm_prefill_counted_by_its_trip_count(monkeypatch):
    from repro_torch.utils import scan

    cfg = reduced_variant(get_arch("xlstm-125m"))
    shape = ShapeConfig("prefill", TINY_S, TINY_B, "prefill")
    fast = count_step(*build_program(cfg, shape))
    monkeypatch.setattr(scan, "_steps", _every_step)
    full = count_step(*build_program(cfg, shape))
    assert (fast["flops"], fast["bytes"]) == (full["flops"], full["bytes"])


@pytest.mark.parametrize("s", (13, 16, 21))
def test_prefill_fills_the_ring_by_position(s):
    """A prompt at least as long as a sliding-window ring: ``attn_prefill``
    writes the last ``cl`` positions with position t at slot t % cl (the
    rule ``attn_decode`` reads by), as one write of the rolled tail."""
    from repro_torch.models.attention import _project_qkv, attn_prefill, init_attention, init_cache

    cfg = reduced_variant(get_arch("mixtral-8x7b")).replace(sliding_window=8, dtype="float32")
    params = init_attention(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, s, cfg.d_model, generator=torch.Generator().manual_seed(1))
    cache = init_cache(cfg, 2, 32, torch.float32)
    attn_prefill(params, x, cfg, cache)
    _, k, v = _project_qkv(params, x, cfg, torch.arange(s))
    cl = cache["k"].shape[1]
    for got, new in ((cache["k"], k), (cache["v"], v)):
        want = torch.zeros_like(got)
        want[:, torch.arange(s - cl, s) % cl] = new[:, -cl:]
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the kernels' formulas and their meta branches


@pytest.mark.parametrize("case", ("ensemble_kl_fwd", "flash_attention_fwd", "flash_decode"))
def test_kernel_cost_gives_the_tables_bounds(case):
    """``PERF.md``'s kernel table: #1 at K=5, B=128, V=10, f32; #5 at the
    training shape 8 × 256, 9 heads over 3, hd 64, causal, bf16; #8 at 8
    slots at position 160 (161 keys each), 12 table entries, bf16."""
    if case == "ensemble_kl_fwd":
        ms, by = bound_ms(*loss_work("ensemble_kl_fwd", 5, 128, 10, 4))
        assert (round(ms, 7), by) == (0.0000096, "bytes")
    elif case == "flash_attention_fwd":
        ms, by = bound_ms(*attention_fwd_work(8, 256, 256, 9, 3, 64, 2, True), peak_flops(torch.bfloat16))
        assert (round(ms, 4), by) == (0.0019, "bytes")
    else:
        ms, by = bound_ms(*decode_work(8, 9, 3, 64, 8 * 161, 8 * 12, 2), peak_flops(torch.bfloat16))
        assert (round(ms, 5), by) == (0.00030, "bytes")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _wrapper_cases():
    from repro_torch.kernels.ensemble_kl.kernel import ensemble_kl_bwd, ensemble_kl_fwd
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
    )
    from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd
    from repro_torch.kernels.ghm_ce.kernel import ghm_ce_bwd, ghm_ce_fwd

    k, b, v = 5, 6, 11
    cl, st, w, row = _meta(k, b, v), _meta(b, v), _meta(k), _meta(b)
    labels = _meta(b, dtype=torch.int32)
    bf = torch.bfloat16
    q, kk = _meta(2, 16, 4, 32, dtype=bf), _meta(2, 16, 2, 32, dtype=bf)
    lse = _meta(2, 16, 4)
    pages, table = _meta(9, 8, 2, 32, dtype=bf), _meta(2, 3, dtype=torch.int32)
    return {
        "ensemble_kl_fwd": (lambda: ensemble_kl_fwd(cl, st, w, 4.0), [(b,)] * 3, ("ensemble_kl_fwd",)),
        "ensemble_kl_bwd": (lambda: ensemble_kl_bwd(cl, st, w, row, row, row, row, 4.0, needs=(True, False, True)),
                            [(k, b, v), None, (k,)], ("ensemble_kl_bwd",)),
        "ghm_ce_fwd": (lambda: ghm_ce_fwd(cl, labels, w), [(b,)] * 3, ("ghm_ce_fwd",)),
        "ghm_ce_bwd": (lambda: ghm_ce_bwd(cl, labels, w, row, row, row), [(k, b, v), (k,)], ("ghm_ce_bwd",)),
        "flash_attention_fwd": (lambda: flash_attention_fwd(q, kk, kk), [(2, 16, 4, 32), (2, 16, 4)],
                                ("flash_attention_fwd", "flash_attention_fwd_sm90")),
        "flash_attention_fwd_f32": (lambda: flash_attention_fwd(q.float(), kk.float(), kk.float()),
                                    [(2, 16, 4, 32), (2, 16, 4)], ("flash_attention_fwd",)),
        "flash_attention_bwd_dq": (lambda: flash_attention_bwd_dq(q, kk, kk, q, lse, lse), [(2, 16, 4, 32)],
                                   ("flash_attention_bwd_dq", "flash_attention_bwd_dq_sm90")),
        "flash_attention_bwd_dkv": (lambda: flash_attention_bwd_dkv(q, kk, kk, q, lse, lse),
                                    [(2, 16, 2, 32)] * 2, ("flash_attention_bwd_dkv", "flash_attention_bwd_dkv_sm90")),
        "flash_decode": (lambda: flash_decode_fwd(_meta(2, 4, 32, dtype=bf), pages, pages, table, _meta(2, dtype=torch.int32)),
                         [(2, 4, 32)], ("flash_decode",)),
    }


@pytest.mark.parametrize("name", list(_wrapper_cases()))
def test_kernel_wrapper_on_meta_records_and_never_launches(name, monkeypatch):
    import ctypes

    import repro_torch.kernels.build as build

    def refuse(*a, **k):
        raise AssertionError("a meta call reached the launch path")

    monkeypatch.setattr(ctypes, "CDLL", refuse)
    monkeypatch.setattr(build, "cuda_library", refuse)
    call, shapes, names = _wrapper_cases()[name]
    before = dict(LAUNCHES)
    with OpCounter() as counter:
        out = call()
    out = out if isinstance(out, tuple) else (out,)
    assert [None if t is None else tuple(t.shape) for t in out] == [tuple(s) if s else None for s in shapes]
    assert all(t is None or t.is_meta for t in out)
    assert dict(LAUNCHES) == before
    kernels = counter.totals()["kernels"]
    assert set(kernels) == set(names)
    assert all(k["calls"] == 1 and k["flops"] > 0 and k["bytes"] > 0 for k in kernels.values())


# ---------------------------------------------------------------------------
# the subprocess: collectives, the sequence-split writes, the CLI


def test_collectives_counted_as_output_bytes(cli_run):
    got = _cli_result(cli_run)["collectives"]
    x = 8 * 16 * 4  # the local input's bytes, on a world of 4
    assert got == {"all-gather": 4 * x, "all-reduce": x, "reduce-scatter": x // 4, "all-to-all": x,
                   "collective-permute": x}


def test_sequence_split_cache_writes(cli_run):
    out = _cli_result(cli_run)
    assert out["write_positions"] and out["write_rows"]


@pytest.mark.parametrize("mesh", ("2x2", "2x2x2", "host"))
@pytest.mark.parametrize("coboost", (0, 2))
def test_cli_records(cli_run, mesh, coboost):
    recs = [r for r in _cli_result(cli_run)["records"]
            if r["mesh"] == mesh and r.get("coboost_clients", 0) == coboost or r["status"] == "error"]
    assert len(recs) == 1 and recs[0]["status"] == "ok", recs
    rec = recs[0]
    chips = {"2x2": 4, "2x2x2": 8, "host": 1}[mesh]
    assert rec["chips"] == chips and rec["shape"] == "train_4k" and rec["overrides"]["num_layers"] == 2
    assert (rec["collective_bytes_per_device"] > 0) == (mesh != "host")
    assert rec["flops_per_device"] > 0 and rec["bound_s"] > 0
    # remat: the server twice a layer; each client once (no gradient)
    assert rec["kernels"]["flash_attention_fwd"]["calls"] == (8 if coboost else 4)
