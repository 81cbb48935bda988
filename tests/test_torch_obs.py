"""The port's telemetry (``repro_torch.obs``) against the JAX package's
(``repro.obs``), on the CPU.

* names: every table equal to the reference's, key for key;
* registry: the same calls (labels in mixed order, a histogram past its
  ring) give the same ``snapshot()`` and ``to_prometheus()`` text, and
  byte-equal ``dump()`` files; ``StatsView`` keeps dict semantics and
  raises what the reference raises;
* tracer: nested spans record ``args.parent`` as the reference does; each
  package's validator accepts the other's dump and rejects the same
  malformed files; the profiler bridge raises where the reference returned
  False (no CUDA tracing on a CUDA run, a second start, a stop without
  start);
* Co-Boosting: the port's ``run_coboosting`` and JAX's fused
  ``backend="ref"`` run record the same ``ofl.*`` counters, histogram
  counts and spans;
* serving: the tiny paged engine of ``tests/test_obs.py``, JAX weights
  carried across, gives the reference's engine and router counters, pool
  gauges and request-histogram counts; host syncs equal decode chunks with
  telemetry off and on;
* the launchers' ``--metrics-out`` / ``--trace-out`` / ``--profile-dir``
  write files both validators accept, the per-phase split of a trace by
  launch correlation, and ``set_level`` / ``REPRO_LOG_LEVEL``.

No tolerance anywhere: counters, names and exported bytes are equal.
"""
from __future__ import annotations

import json
import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jax_obs
import repro.obs.names as jax_names
from repro.config import ModelConfig as JaxModelConfig
from repro.config.train import OFLConfig as JaxOFLConfig
from repro.core.coboosting import default_image_setup as jax_default_image_setup
from repro.core.coboosting import run_coboosting as jax_run_coboosting
from repro.kernels.dispatch import BackendPolicy
from repro.models import init_lm as jax_init_lm
from repro.models.cnn import cnn_apply as jax_cnn_apply
from repro.models.cnn import init_cnn as jax_init_cnn
from repro.obs.registry import MetricsRegistry as JaxMetricsRegistry
from repro.obs.tracer import SpanTracer as JaxSpanTracer
from repro.obs.validate import REQUIRED_OFL_KEYS as JAX_REQUIRED_OFL_KEYS
from repro.obs.validate import validate_metrics as jax_validate_metrics
from repro.obs.validate import validate_trace as jax_validate_trace
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ManualClock as JaxManualClock
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.utils.logging import _level_from_env as jax_level_from_env
from repro_torch import obs
from repro_torch.config.model import ModelConfig
from repro_torch.config.train import OFLConfig
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.core.coboosting import default_image_setup, run_coboosting
from repro_torch.launch import ofl as ofl_launch
from repro_torch.launch import serve as serve_launch
from repro_torch.models.cnn import cnn_apply
from repro_torch.models.generator import image_generator
from repro_torch.obs import KV_GAUGES, SERVE_ENGINE_METRICS, MetricsRegistry, SpanTracer, names, serve_namespace
from repro_torch.obs.phases import OFL_OUTER, OFL_PHASES, device_split
from repro_torch.obs.tracer import _NULL_SPAN, PROFILE_TRACE, start_torch_profile, stop_torch_profile
from repro_torch.obs.validate import REQUIRED_OFL_KEYS, validate_metrics, validate_trace
from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine
from repro_torch.utils.logging import _level_from_env, set_level
from repro_torch.utils.prng import Draws

pytestmark = pytest.mark.tier1


@pytest.fixture
def global_obs_off():
    """Tests that flip either package's process-global telemetry restore the
    default afterwards."""
    yield
    for pkg in (obs, jax_obs):
        pkg.configure(metrics=False, trace=False)
        pkg.tracer().clear()
        pkg.registry().reset()


def _timeless(snapshot):
    """A snapshot without the wall-time statistics of its histograms (the
    sample count stays)."""
    return [{k: v for k, v in r.items() if k not in ("sum", "min", "max", "p50", "p95")} for r in snapshot]


def _spans(tracer):
    return [(e["name"], e.get("args", {})) for e in tracer.events()]


# ---------------------------------------------------------------------------
# names


@pytest.mark.parametrize("table", [
    "SERVE_ENGINE_METRICS", "ROUTER_METRICS", "KV_GAUGES", "REQUEST_HISTOGRAMS", "OFL_METRICS",
    "OFL_HISTOGRAMS", "REQUIRED_SERVE_KEYS",
])
def test_names_match_reference(table):
    got, want = getattr(names, table), getattr(jax_names, table)
    assert type(got) is type(want)
    assert list(got.items() if isinstance(got, dict) else got) == list(want.items() if isinstance(want, dict) else want)


def test_namespace_and_required_ofl_keys_match_reference():
    assert serve_namespace() == jax_names.serve_namespace()
    assert REQUIRED_OFL_KEYS == JAX_REQUIRED_OFL_KEYS


# ---------------------------------------------------------------------------
# registry


def _mixed(reg):
    reg.inc("a.b", 2)
    reg.inc("a.b", 3, replica=1, arch="cnn2")
    reg.inc("a.b", 1, arch="cnn2", replica=1)  # the same series: canonical label order
    reg.inc("serve.admit.requests", 3, replica=0)
    reg.set_counter("c.mirror", 7, replica=0)
    reg.set_counter("c.mirror", 4.5, replica=0)
    reg.set_gauge("g.x", 7.5, replica=0)
    reg.set_gauge("g.x", 1.25, b=2, a=1)
    reg.observe("serve.request.ttft_s", 0.5)
    for i in range(50):  # past the ring of 8
        reg.observe("h.t", float(i) * 0.37, z="last", a="first")


def _ring_only(reg):
    for i in range(20):
        reg.observe("h.ring", float(i % 7), replica=i % 2)


def _empty(reg):
    pass


@pytest.mark.parametrize("calls", [_mixed, _ring_only, _empty], ids=["mixed", "ring", "empty"])
@pytest.mark.parametrize("enabled", [True, False])
def test_registry_exports_equal_reference_bytes(tmp_path, calls, enabled):
    got, want = MetricsRegistry(enabled=enabled, hist_capacity=8), JaxMetricsRegistry(enabled=enabled, hist_capacity=8)
    calls(got)
    calls(want)
    assert got.snapshot() == want.snapshot()
    assert got.to_prometheus() == want.to_prometheus()
    for reg, name in ((got, "port"), (want, "ref")):
        (tmp_path / name).mkdir()
        reg.dump(str(tmp_path / name / "m.jsonl"))
    for f in ("m.jsonl", "m.prom"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes()
    assert got.names() == want.names() and got.total("a.b") == want.total("a.b")


def test_stats_view_keeps_dict_semantics_as_reference():
    schema = {"hits": "c.hits", "misses": "c.misses"}
    views = [MetricsRegistry().view(schema, replica=3), JaxMetricsRegistry().view(schema, replica=3)]
    for st in views:
        st["hits"] += 1
        st["hits"] += 1
        st["misses"] = 5
    got, want = views
    assert dict(got) == dict(want) == {"hits": 2, "misses": 5}
    assert isinstance(got["hits"], int) and got.labels == want.labels
    assert got.registry.snapshot() == want.registry.snapshot()
    for st in views:
        for k in list(st):
            st[k] = 0
    assert dict(got) == dict(want) == {"hits": 0, "misses": 0}


def _bump(st):
    st["typo"] += 1


def _assign(st):
    st["typo"] = 1


def _delete(st):
    del st["hits"]


@pytest.mark.parametrize("op", [_bump, _assign, _delete], ids=["bump", "assign", "delete"])
def test_stats_view_raises_what_reference_raises(op):
    raised = []
    for reg in (MetricsRegistry(), JaxMetricsRegistry()):
        with pytest.raises(Exception) as info:
            op(reg.view({"hits": "c.hits"}))
        raised.append(type(info.value))
    assert raised[0] is raised[1] and raised[0] in (KeyError, TypeError)


# ---------------------------------------------------------------------------
# tracer and validator


def _nested(tr):
    tr.enabled = True
    with tr.span("outer", kind="parent", epoch=0):
        with tr.span("inner"):
            with tr.span("leaf", x=1.5):
                pass
        tr.instant("marker", rid=3)
        with tr.span("inner2", obj=object):
            pass


def test_nested_spans_record_parents_as_reference(tmp_path):
    got, want = SpanTracer(), JaxSpanTracer()
    _nested(got)
    _nested(want)
    assert _spans(got) == _spans(want)
    assert dict(_spans(got))["leaf"]["parent"] == "inner"
    assert "parent" not in dict(_spans(got))["outer"]
    # each validator accepts the other's dump
    got.dump(str(tmp_path / "port.json"))
    want.dump(str(tmp_path / "ref.json"))
    for path in ("port.json", "ref.json"):
        assert len(validate_trace(str(tmp_path / path))) == len(jax_validate_trace(str(tmp_path / path))) == 5
    assert json.loads((tmp_path / "port.json").read_text()).keys() == json.loads((tmp_path / "ref.json").read_text()).keys()


def test_disabled_tracer_is_the_shared_noop():
    tr = SpanTracer()
    assert tr.span("a") is tr.span("b", x=1) is _NULL_SPAN
    with tr.span("a"):
        tr.instant("m")
    assert len(tr) == 0


MALFORMED = {
    "no_ts": [{"name": "a", "ph": "X", "dur": 1.0, "tid": 1}],
    "no_dur": [{"name": "a", "ph": "X", "ts": 1.0, "tid": 1}],
    "non_monotonic": [
        {"name": "a", "ph": "X", "ts": 10.0, "dur": 1.0, "tid": 1},
        {"name": "b", "ph": "X", "ts": 5.0, "dur": 1.0, "tid": 1},
    ],
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_both_validators_reject_the_same_malformed_traces(tmp_path, case):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": MALFORMED[case]}))
    messages = []
    for check in (validate_trace, jax_validate_trace):
        with pytest.raises(ValueError) as info:
            check(str(bad))
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_validators_agree_on_metrics(tmp_path):
    reg = MetricsRegistry()
    reg.inc("serve.admit.requests")
    p = tmp_path / "m.jsonl"
    reg.dump(str(p))
    for check in (validate_metrics, jax_validate_metrics):
        with pytest.raises(ValueError, match="missing required keys"):
            check(str(p))
    reg.inc("ofl.epoch.count")
    reg.observe("ofl.epoch.step_s", 0.1)
    reg.dump(str(p))
    assert len(validate_metrics(str(p), REQUIRED_OFL_KEYS)) == len(jax_validate_metrics(str(p), JAX_REQUIRED_OFL_KEYS)) == 3


def test_profile_bridge_never_falls_back(tmp_path, monkeypatch):
    """Where the reference's start_jax_profile returns False, the port's
    bridge raises: a CUDA run whose profiler cannot trace CUDA, a second
    start, a stop without a start."""
    from torch.profiler import ProfilerActivity

    tr = SpanTracer()
    monkeypatch.setattr(torch.profiler, "supported_activities", lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CPU-only"):
        start_torch_profile(tr, str(tmp_path / "p"), device="cuda")
    assert tr.profile is None
    with pytest.raises(RuntimeError, match="no torch profile"):
        stop_torch_profile(tr)
    start_torch_profile(tr, str(tmp_path / "p"), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already running"):
            start_torch_profile(tr, str(tmp_path / "p"), device="cpu")
        with tr.span("bridged"):  # recording off: the span still enters its range
            torch.ones(3).sum()
    finally:
        path = stop_torch_profile(tr)
    assert len(tr) == 0
    evs = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e["name"] == "bridged" for e in evs)


def test_phase_split_attributes_by_launch_not_device_time(tmp_path):
    """Kernels land on the phase whose range launched them even when
    they run after it closed, and when another thread of the process (the
    autograd engine's) launched them inside the range's window; a kernel
    without a launch record is counted as unattributed."""
    host = dict(ph="X", pid=1, tid=1)
    evs = [
        dict(host, cat="user_annotation", name="ofl.epoch", ts=0, dur=100),
        dict(host, cat="user_annotation", name="ofl.gen.boost", ts=0, dur=40),
        dict(host, cat="user_annotation", name="ofl.ee.weight_search", ts=40, dur=10),
        dict(host, cat="user_annotation", name="ofl.kd", ts=50, dur=50),
        dict(host, cat="cuda_runtime", name="cudaLaunchKernel", ts=10, dur=2, args={"correlation": 1}),
        # autograd's device thread launches the backward inside the range's window
        dict(host, tid=2, cat="cuda_runtime", name="cudaLaunchKernel", ts=20, dur=2, args={"correlation": 5}),
        dict(host, cat="cuda_driver", name="cuLaunchKernel", ts=45, dur=2, args={"correlation": 2}),
        dict(host, cat="cuda_runtime", name="cudaMemcpyAsync", ts=60, dur=2, args={"correlation": 3}),
        dict(host, cat="cuda_runtime", name="cudaLaunchKernel", ts=150, dur=2, args={"correlation": 4}),
        # the device runs late: every kernel starts after its range closed
        dict(ph="X", pid=0, tid=7, cat="kernel", name="k1", ts=90, dur=30, args={"correlation": 1}),
        dict(ph="X", pid=0, tid=7, cat="kernel", name="k2", ts=120, dur=5, args={"correlation": 2}),
        dict(ph="X", pid=0, tid=7, cat="gpu_memcpy", name="m3", ts=125, dur=15, args={"correlation": 3}),
        dict(ph="X", pid=0, tid=7, cat="kernel", name="k4", ts=160, dur=7, args={"correlation": 4}),
        dict(ph="X", pid=0, tid=7, cat="kernel", name="k5", ts=170, dur=3, args={"correlation": 99}),
        dict(ph="X", pid=0, tid=7, cat="kernel", name="k6", ts=121, dur=4, args={"correlation": 5}),
        # the same range names in another process do not count
        dict(host, pid=2, cat="user_annotation", name="ofl.kd", ts=140, dur=30),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    split = device_split(str(path))
    assert {n: r["device_ms"] * 1e3 for n, r in split["ranges"].items()} == {
        "ofl.gen.boost": 34.0, "ofl.ee.weight_search": 5.0, "ofl.kd": 15.0,
    }
    assert split["ranges"]["ofl.gen.boost"]["top"] == [["k1", 0.03, 1], ["k6", 0.004, 1]]
    assert {k: v for k, v in split["outer"].items() if k != "top"} == {"device_ms": 0.054, "launches": 4, "count": 1}
    assert split["unattributed"] == {"device_ms": 0.003, "launches": 1}
    assert split["device_ms"] == pytest.approx(0.064)


# ---------------------------------------------------------------------------
# Co-Boosting against the reference's fused driver

CLASSES = 5
SHAPE = (16, 16, 3)
K = 3
OFL_CFG = dict(num_clients=K, epochs=3, gen_iters=2, batch_size=16, latent_dim=16, buffer_batches=2)


def _run_jax_coboosting(use_ee):
    cfg = JaxOFLConfig(**OFL_CFG, use_ee=use_ee, backend=BackendPolicy(default="ref"))
    clients = [jax_init_cnn(jax.random.key(20 + i), "mlp", CLASSES, SHAPE) for i in range(K)]
    server = jax_init_cnn(jax.random.key(77), "mlp", CLASSES, SHAPE)
    gen_apply, gen = jax_default_image_setup(jax.random.key(5), cfg, CLASSES, SHAPE)
    jax_run_coboosting(
        [partial(jax_cnn_apply, "mlp")] * K, clients, partial(jax_cnn_apply, "mlp"), server, gen_apply, gen,
        cfg, CLASSES, jax.random.key(0),
    )
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return [np_tree(c) for c in clients], np_tree(server), np_tree(gen)


@pytest.mark.parametrize("use_ee", [True, False])
def test_coboosting_records_the_references_telemetry(global_obs_off, use_ee):
    jax_obs.configure(metrics=True, trace=True)
    jax_obs.registry().reset()
    clients, server, gen = _run_jax_coboosting(use_ee)

    obs.configure(metrics=True, trace=True)
    cfg = OFLConfig(**OFL_CFG, use_ee=use_ee, backend="ref")
    _, gen_params = default_image_setup(torch.Generator().manual_seed(5), cfg, CLASSES, SHAPE)
    gen_params = params_from_jax("image_generator", gen)
    run_coboosting(
        [partial(cnn_apply, "mlp")] * K, [params_from_jax("mlp", c) for c in clients], partial(cnn_apply, "mlp"),
        params_from_jax("mlp", server), lambda p, z, y: image_generator(p, z, y, SHAPE), gen_params,
        cfg, CLASSES, Draws(0, "cpu"),
    )
    got, want = obs.registry().snapshot(), jax_obs.registry().snapshot()
    assert _timeless(got) == _timeless(want)
    counters = {r["name"]: r["value"] for r in got if r["type"] == "counter"}
    assert counters["ofl.epoch.count"] == counters["ofl.epoch.dispatches"] == 3
    assert counters["ofl.gen.steps"] == 6 and counters["ofl.kd.steps"] == 1 + 2 + 2
    assert ("ofl.ee.steps" in counters) == use_ee
    assert _spans(obs.tracer()) == _spans(jax_obs.tracer())
    assert [a for _, a in _spans(obs.tracer())] == [{"epoch": e, "driver": "fused"} for e in range(3)]


# ---------------------------------------------------------------------------
# serving against the reference's engine

TINY = dict(
    name="t", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
    vocab_size=64, dtype="float32", param_dtype="float32",
)
TINY_ENGINE = dict(max_slots=2, max_seq=32, max_new=8, decode_chunk=4, kv_layout="paged", page_size=8)


def _tiny_prompts(vocab):
    return [np.arange(6, dtype=np.int32) % vocab, (np.arange(7, dtype=np.int32) * 3) % vocab]


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = JaxModelConfig(**TINY, scan_layers=False, remat=False)
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_lm(jcfg, jax.random.key(0)))
    cfg = ModelConfig(**TINY)
    return jcfg, jparams, cfg, lm_params_from_jax(cfg, jparams)


def _run_tiny(make_engine, make_sched, make_request, clock, prompts, gen=6):
    eng = make_engine()
    sched = make_sched(eng, clock=clock(tick=0.01))
    comps = sched.run([make_request(rid=i, tokens=p, max_new_tokens=gen, arrival=0.0) for i, p in enumerate(prompts)])
    eng.publish_gauges()
    return eng, sched, comps


def _run_port_tiny(tiny_lm, registry=None):
    _, _, cfg, params = tiny_lm
    return _run_tiny(
        lambda: ServeEngine(cfg, params, EngineConfig(**TINY_ENGINE), registry=registry),
        ContinuousScheduler, Request, ManualClock, _tiny_prompts(cfg.vocab_size),
    )


def test_tiny_engine_counters_equal_reference(tiny_lm):
    jcfg, jparams, _, _ = tiny_lm
    jreg, reg = JaxMetricsRegistry(), MetricsRegistry()
    jeng, jsched, jcomps = _run_tiny(
        lambda: JaxServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), JaxEngineConfig(**TINY_ENGINE),
                               registry=jreg),
        JaxScheduler, JaxRequest, JaxManualClock, _tiny_prompts(jcfg.vocab_size),
    )
    eng, sched, comps = _run_port_tiny(tiny_lm, registry=reg)
    assert len(comps) == len(jcomps) == 2
    assert dict(eng.stats) == dict(jeng.stats) and set(eng.stats) == set(SERVE_ENGINE_METRICS)
    assert dict(sched.stats) == dict(jsched.stats)
    assert _timeless(reg.snapshot()) == _timeless(jreg.snapshot())
    touched = set(reg.names("serve."))
    assert touched <= serve_namespace()
    assert {KV_GAUGES[k] for k in ("free_pages", "pages_in_use", "capacity_pages")} <= touched
    for name in names.REQUEST_HISTOGRAMS:
        (rec,) = [r for r in reg.snapshot() if r["name"] == name]
        assert rec["count"] == 2 and rec["labels"] == {"replica": "0"}
    assert reg.value("serve.decode.chunks", replica=0) == eng.stats["decode_chunks"]


def test_tiny_engine_host_syncs_equal_chunks_with_telemetry_off_and_on(tiny_lm, global_obs_off):
    eng_off, _, _ = _run_port_tiny(tiny_lm)
    assert len(obs.tracer()) == 0
    assert eng_off.stats["host_syncs"] == eng_off.stats["decode_chunks"] > 0
    obs.configure(metrics=True, trace=True, device="cpu")
    eng_on, _, _ = _run_port_tiny(tiny_lm, registry=obs.registry())
    assert dict(eng_on.stats) == dict(eng_off.stats)
    span_names = {e["name"] for e in obs.tracer().events()}
    assert {"serve.prefill", "serve.adopt", "serve.decode_chunk", "serve.sync", "serve.admit", "serve.route"} <= span_names
    assert "serve.handoff" not in span_names  # colocated: no cross-device transport, as in the reference


# ---------------------------------------------------------------------------
# the launchers' flags


def _flags(tmp_path, stem):
    return ["--metrics-out", str(tmp_path / f"{stem}.jsonl"), "--trace-out", str(tmp_path / f"{stem}.json"),
            "--profile-dir", str(tmp_path / f"{stem}_prof")]


def test_ofl_launcher_writes_valid_telemetry_with_phase_ranges(tmp_path, global_obs_off):
    epochs = 2
    result = ofl_launch.main([
        "--method", "coboosting", "--device", "cpu", "--clients", "2", "--classes", "4", "--image", "8",
        "--per-class", "20", "--epochs", str(epochs), "--gen-iters", "2", "--batch", "16", "--local-epochs", "1",
        *_flags(tmp_path, "ofl"),
    ])
    assert "server_acc" in result
    for check, required in ((validate_metrics, REQUIRED_OFL_KEYS), (jax_validate_metrics, JAX_REQUIRED_OFL_KEYS)):
        check(str(tmp_path / "ofl.jsonl"), required)
    validate_trace(str(tmp_path / "ofl.json"))
    jax_validate_trace(str(tmp_path / "ofl.json"))
    assert (tmp_path / "ofl.prom").exists()
    profile = tmp_path / "ofl_prof" / PROFILE_TRACE
    ranges = [e["name"] for e in json.loads(profile.read_text())["traceEvents"] if e.get("cat") == "user_annotation"]
    for name in (*OFL_PHASES, OFL_OUTER):
        assert ranges.count(name) == epochs, name
    split = device_split(str(profile))
    assert split["outer"]["count"] == epochs and split["device_ms"] == 0.0  # the CPU has no device events
    assert obs.tracer().profile is None


def test_serve_launcher_writes_valid_telemetry(tmp_path, global_obs_off):
    result = serve_launch.main([
        "--arch", "smollm-135m", "--reduced", "--device", "cpu", "--requests", "4", "--max-slots", "2",
        "--prompt-len", "12", "--gen", "6", *_flags(tmp_path, "serve"),
    ])
    assert result["stats"]["host_syncs"] == result["stats"]["decode_chunks"]
    for check in (validate_metrics, jax_validate_metrics):
        recs = check(str(tmp_path / "serve.jsonl"))
    for check in (validate_trace, jax_validate_trace):
        check(str(tmp_path / "serve.json"))
    hists = {r["name"]: r["count"] for r in recs if r["type"] == "histogram"}
    assert hists == {name: 4 for name in names.REQUEST_HISTOGRAMS}
    assert {r["name"] for r in recs} <= serve_namespace()
    evs = json.loads((tmp_path / "serve_prof" / PROFILE_TRACE).read_text())["traceEvents"]
    assert "serve.decode_chunk" in {e["name"] for e in evs if e.get("cat") == "user_annotation"}


def test_serve_launcher_refuses_two_profilers():
    with pytest.raises(SystemExit, match="pick one"):
        serve_launch.main(["--reduced", "--device", "cpu", "--profile", "--profile-dir", "unused"])


# ---------------------------------------------------------------------------
# logging knob


@pytest.mark.parametrize("raw", ["debug", "WARNING", "15", "bogus", None])
def test_log_level_from_env_matches_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("REPRO_LOG_LEVEL", raising=False)
    else:
        monkeypatch.setenv("REPRO_LOG_LEVEL", raw)
    assert _level_from_env() == jax_level_from_env()


def test_set_level():
    root = logging.getLogger("repro_torch")
    before = root.level
    try:
        set_level("error")
        assert root.level == logging.ERROR
        set_level(logging.DEBUG)
        assert root.level == logging.DEBUG
        with pytest.raises(ValueError):
            set_level("nope")
    finally:
        root.setLevel(before)
