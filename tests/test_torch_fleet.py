"""The serving fleet in the port (``repro_torch.serve`` and
``repro_torch.launch.serve``) on the CPU, held against the JAX package.

The reference's model of ``tests/test_fleet.py`` (2 layers, d_model 32, 4
heads over 2 kv heads, hd 8, vocabulary 64, f32) with JAX ``init_lm``
weights carried across by ``convert.lm_params_from_jax``. Ported from
``tests/test_fleet.py`` (its non-mesh tests):

* the disaggregation checks (paged only), on ``ServeEngine``'s
  ``prefill_device``, the port's disaggregation seam; the reference's
  pure-SSM case has no port family, so the port refuses the family itself;
* the router needs engines;
* a handoff's staging accounting and an atomic adopt on a full pool, step
  by step beside the JAX workers, with equal pool counts;
* the fleet against one engine for ``n2``, ``n3`` and the dense layout
  (the reference's ``disagg`` cases colocate their pairs on one device, as
  every replica here does). Beyond the reference's self-parity, each case also
  runs the JAX ``FleetRouter`` on the same stream and ``ManualClock``: the
  port's tokens, each completion's ``replica``, each replica's ``stats``
  and the router's stats equal the JAX fleet's, key for key, and every
  compared token has a teacher-forced top-2 margin above 1e-3;
* the randomized router invariants, requeue-on-defer, fail-fast when no
  replica can ever admit, and queue wait against service.

Also: ``prefill_device`` naming the parameters' own device (one copy of
them, the colocated engine's tokens; the card test puts the prefill on
another device); ``static_generate`` against JAX ``static_generate``; the
launcher with ``--replicas 2`` (a shared registry with two replica labels
that passes the validator) and ``--engine static``, and its fail-fast
messages.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JaxModelConfig
from repro.models import init_lm as jax_init_lm
from repro.serve import DecodeWorker as JaxDecodeWorker
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import FleetRouter as JaxFleetRouter
from repro.serve import ManualClock as JaxManualClock
from repro.serve import PrefillWorker as JaxPrefillWorker
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import static_generate as jax_static_generate
from repro_torch.config.model import ModelConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels.dispatch import BackendPolicy
from repro_torch.models.transformer import lm_forward
from repro_torch.serve import (
    ContinuousScheduler,
    DecodeWorker,
    EngineConfig,
    FleetRouter,
    ManualClock,
    PrefillWorker,
    Request,
    ServeEngine,
    staggered_stream,
    static_generate,
)

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
# the reference's _mk (tests/test_fleet.py), dense fields
MK = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
          vocab_size=64, dtype="float32", param_dtype="float32")
# the reference's _ECFG
ECFG = dict(max_slots=2, max_seq=48, max_new=8, decode_chunk=3, prefill_bucket=8, page_size=8)
NEAR_TIE = 1e-3


@pytest.fixture(scope="module")
def model():
    """``(jax cfg, jax params, port cfg, port params)``: one set of weights."""
    jcfg = JaxModelConfig(scan_layers=False, remat=False, **MK)
    cfg = ModelConfig(**MK)
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_lm(jcfg, jax.random.key(0)))
    return jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), cfg, lm_params_from_jax(cfg, jparams)


def _margin_check(cfg, params, reqs, tokens):
    """Teacher-force each request's prompt and tokens through the port's
    full forward: the tokens are the argmaxes, with top-2 margins above
    1e-3 (no near-tie decides a compared token)."""
    smallest = float("inf")
    with torch.inference_mode():
        for r in reqs:
            got = tokens[r.rid]
            seq = torch.from_numpy(np.concatenate([r.tokens, got[:-1]]).astype(np.int32))[None]
            rows = lm_forward(params, cfg, {"tokens": seq})[0][0, len(r.tokens) - 1 :]
            np.testing.assert_array_equal(rows.argmax(-1).numpy(), got)
            top2 = rows.topk(2, dim=-1).values
            smallest = min(smallest, float((top2[:, 0] - top2[:, 1]).min()))
    assert smallest > NEAR_TIE, f"near-tie: smallest top-2 margin {smallest:.2e}"


def _jax_reqs(reqs):
    return [JaxRequest(rid=r.rid, tokens=r.tokens, max_new_tokens=r.max_new_tokens, arrival=r.arrival) for r in reqs]


def _fleet(cfg, params, n, **over):
    return [ServeEngine(cfg, params, EngineConfig(**{**ECFG, **over})) for _ in range(n)]


def _jax_fleet(jcfg, jparams, n, **over):
    return [JaxServeEngine(jcfg, jparams, JaxEngineConfig(**{**ECFG, **over})) for _ in range(n)]


def _jax_stats(eng):
    return {k: int(v) for k, v in dict(eng.stats).items()}


# ---------------------------------------------------------------------------
# config validation


def test_disagg_requires_paged_layout(model):
    """A prefill worker placed apart hands off sealed pages, so the dense
    layout refuses it, as the reference's ``disagg`` check does."""
    cfg, params = model[2:]
    dense = {**ECFG, "kv_layout": "dense"}
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(cfg, params, EngineConfig(**dense), prefill_device="cpu")
    with pytest.raises(ValueError, match="paged"):
        JaxEngineConfig(disagg=True, **dense)
    ServeEngine(cfg, params, EngineConfig(**ECFG), prefill_device="cpu")


def test_disagg_pure_ssm_has_no_port_family(model):
    """A disaggregated pure-SSM engine is refused, as the reference refuses
    it: its state degrades to the dense layout, which has no page units to
    hand off. Colocated, the same engine runs the dense layout."""
    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm

    cfg = reduced_variant(get_arch("xlstm-125m")).replace(dtype="float32")
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no attention layers"):
        ServeEngine(cfg, params, EngineConfig(**ECFG), prefill_device="cpu")
    assert ServeEngine(cfg, params, EngineConfig(**ECFG)).layout == "dense"


def test_router_needs_engines():
    with pytest.raises(ValueError, match="at least one"):
        FleetRouter([])


# ---------------------------------------------------------------------------
# the handoff itself, beside the JAX workers


def test_handoff_staging_accounting(model):
    """A sealed burst reserves staging pages on the source pool and donates
    them back exactly when the decode worker adopts; the counts equal the
    JAX workers' at every step."""
    jcfg, jparams, cfg, params = model
    prompts = [np.arange(5, dtype=np.int32), np.arange(7, dtype=np.int32)]
    counts = []
    for pw_cls, dw_cls, ecfg_cls, c, p in ((PrefillWorker, DecodeWorker, EngineConfig, cfg, params),
                                            (JaxPrefillWorker, JaxDecodeWorker, JaxEngineConfig, jcfg, jparams)):
        ecfg = ecfg_cls(**ECFG)
        pw = pw_cls(c, p, ecfg)
        dw = dw_cls(c, p, ecfg, stats=pw.stats)
        h = pw.prefill_group([(q, 4) for q in prompts])
        steps = [(h.n, h.n_alloc, pw.staging.pages_in_use, dw.pool.pages_in_use)]
        slots = dw.adopt(h)
        steps.append((sorted(slots), pw.staging.pages_in_use, dw.pool.pages_in_use,
                      sorted(len(dw.pool.owned(s)) for s in slots)))
        dw.decode_chunk()
        active, n_out = dw.sync()
        steps.append(([bool(a) for a in active], [int(x) for x in n_out]))
        counts.append((steps, {k: int(v) for k, v in dict(pw.stats).items()}))
    assert counts[0][0][0] == (2, 1, 2, 0)  # one 8-token page each, staged, nothing landed
    assert counts[0][0][1][1:] == (0, 2, [1, 1])  # donated on adoption
    assert all(n >= 1 for n in counts[0][0][2][1])
    assert counts[0] == counts[1]


def test_adopt_atomic_on_full_pool(model):
    """A burst whose sealed pages outsize the adopting pool raises before a
    slot or page moves; the handoff stays staged and lands once the first
    request drains. Each step's counts equal the JAX workers'."""
    jcfg, jparams, cfg, params = model
    kw = dict(max_slots=2, max_seq=32, max_new=4, decode_chunk=4, prefill_bucket=16, page_size=8, pool_pages=4)
    big = np.arange(20, dtype=np.int32)  # buckets to 32 tokens = 4 pages
    logs = []
    for pw_cls, dw_cls, ecfg_cls, c, p in ((PrefillWorker, DecodeWorker, EngineConfig, cfg, params),
                                            (JaxPrefillWorker, JaxDecodeWorker, JaxEngineConfig, jcfg, jparams)):
        ecfg = ecfg_cls(**kw)
        pw = pw_cls(c, p, ecfg)
        dw = dw_cls(c, p, ecfg, stats=pw.stats)
        dw.adopt(pw.prefill_group([(big, 4)]))  # fills the pool
        pw2 = pw_cls(c, p, ecfg)
        h2 = pw2.prefill_group([(big, 4)])
        with pytest.raises(RuntimeError, match="cannot adopt"):
            dw.adopt(h2)
        log = [(len(dw.free_slots), pw2.staging.pages_in_use, dw.pool.free_pages)]
        for _ in range(4):
            dw.decode_chunk()
            active, n_out = dw.sync()
            if not active.any():
                break
        (slot,) = [s for s in range(ecfg.max_slots) if s not in dw.free_slots]
        log.append((slot, [int(x) for x in n_out], [int(t) for t in np.asarray(dw.fetch(slot, int(n_out[slot])))]))
        dw.adopt(h2)
        log.append((pw2.staging.pages_in_use, dw.pool.pages_in_use, dw.pool.free_pages))
        logs.append(log)
    assert logs[0][0] == (1, 4, 0)  # no slot consumed, the handoff still staged
    assert logs[0][2][0] == 0
    assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# the fleet against one engine and against the JAX fleet


FLEETS = {
    # name: (replicas, engine knobs, stream size, stream seed)
    "n2": (2, {}, 9, 3),
    "n3": (3, {}, 9, 3),
    "dense": (2, dict(kv_layout="dense"), 7, 9),
}


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_matches_single_engine_and_jax(model, name):
    """The routed fleet gives one colocated engine's greedy tokens on the
    reference's staggered stream, and the JAX fleet's tokens, replica ids,
    per-replica stats and router stats, key for key."""
    jcfg, jparams, cfg, params = model
    n, knobs, size, seed = FLEETS[name]
    reqs = staggered_stream(cfg.vocab_size, size, seed=seed)
    single = ServeEngine(cfg, params, EngineConfig(**ECFG, **knobs))
    ref = {c.rid: c.tokens for c in ContinuousScheduler(single, clock=ManualClock(tick=0.2)).run(reqs)}
    _margin_check(cfg, params, reqs, ref)
    router = FleetRouter(_fleet(cfg, params, n, **knobs), clock=ManualClock(tick=0.2))
    comps = router.run(reqs)
    assert sorted(c.rid for c in comps) == sorted(ref)
    for c in comps:
        np.testing.assert_array_equal(c.tokens, ref[c.rid])
    assert len({c.replica for c in comps}) > 1  # the fleet spread the load
    jrouter = JaxFleetRouter(_jax_fleet(jcfg, jparams, n, **knobs), clock=JaxManualClock(tick=0.2))
    jcomps = jrouter.run(_jax_reqs(reqs))
    assert [(c.rid, c.replica) for c in comps] == [(c.rid, c.replica) for c in jcomps]
    for c, jc in zip(comps, jcomps):
        np.testing.assert_array_equal(c.tokens, np.asarray(jc.tokens))
        assert (c.admitted, c.first_token, c.finished) == pytest.approx((jc.admitted, jc.first_token, jc.finished))
    assert [dict(e.stats) for e in router.engines] == [_jax_stats(e) for e in jrouter.engines]
    assert dict(router.stats) == {k: int(v) for k, v in dict(jrouter.stats).items()}


# ---------------------------------------------------------------------------
# randomized router invariants


class _Audit:
    """Delegating per-replica wrapper asserting slot and page hygiene on
    every transition, and that transitions on this replica never move
    another replica's pool (the reference's audit)."""

    def __init__(self, inner, peers_fn):
        self._e = inner
        self._peers = peers_fn
        self.in_use = set()

    def __getattr__(self, name):
        return getattr(self._e, name)

    @staticmethod
    def _pool_snapshot(eng):
        pool = eng.pool
        return pool.free_pages, {s: tuple(pool.owned(s)) for s in range(eng.ecfg.max_slots)}

    def _check(self):
        pool = self._e.pool
        owned = [p for s in range(self._e.ecfg.max_slots) for p in pool.owned(s)]
        assert len(owned) == len(set(owned)), "page double-booked"
        assert pool.free_pages + len(owned) == pool.n_pages, "free-list leak"
        assert all(not pool.owned(s) for s in self._e.free_slots)

    def admit_many(self, requests):
        peers_before = [self._pool_snapshot(p) for p in self._peers(self)]
        slots = self._e.admit_many(requests)
        assert len(set(slots)) == len(slots)
        for slot in slots:
            assert slot not in self.in_use, f"slot {slot} double-booked"
            self.in_use.add(slot)
        self._check()
        assert peers_before == [self._pool_snapshot(p) for p in self._peers(self)], (
            "admission on one replica moved another replica's pool"
        )
        return slots

    def decode_chunk(self):
        self._e.decode_chunk()
        self._check()

    def fetch(self, slot, n_out):
        assert slot in self.in_use
        self.in_use.discard(slot)
        peers_before = [self._pool_snapshot(p) for p in self._peers(self)]
        toks = self._e.fetch(slot, n_out)
        self._check()
        assert peers_before == [self._pool_snapshot(p) for p in self._peers(self)], (
            "eviction on one replica touched another replica's pages"
        )
        return toks


def test_router_randomized_invariants(model):
    cfg, params = model[2:]
    engines = _fleet(cfg, params, 3, max_slots=2)
    audits = [None] * len(engines)
    peers = lambda a: [x._e for x in audits if x is not a]
    for i, eng in enumerate(engines):
        audits[i] = _Audit(eng, peers)
    reqs = staggered_stream(cfg.vocab_size, 17, seed=11)
    comps = FleetRouter(audits, clock=ManualClock(tick=0.3)).run(reqs)
    assert sorted(c.rid for c in comps) == sorted(r.rid for r in reqs)  # none lost or duplicated
    by_rid = {c.rid: c for c in comps}
    for r in reqs:
        c = by_rid[r.rid]
        assert len(c.tokens) == r.max_new_tokens
        assert c.admitted >= r.arrival and c.finished >= c.admitted
        assert 0 <= c.replica < len(engines)
    for a, eng in zip(audits, engines):
        assert not a.in_use
        assert sorted(eng.free_slots) == list(range(eng.ecfg.max_slots))
        assert eng.pool.pages_in_use == 0 and eng.pool.free_pages == eng.pool.n_pages
        assert not bool(eng._state.active.any())
    assert sum(e.stats["evicted"] for e in engines) == len(reqs)
    assert sum(e.stats["admitted"] for e in engines) == len(reqs)


def test_router_requeues_blocked_head_to_idle_replica(model):
    """rid 2 lands on replica 0 by the load tie-break, but replica 0 is
    pinned by a long-budget resident while replica 1 drains quickly: the
    blocked head moves (requeue-on-defer) and finishes first there."""
    cfg, params = model[2:]
    kw = dict(max_slots=1, max_seq=48, max_new=16, decode_chunk=2, prefill_bucket=8, kv_layout="dense")
    engines = [ServeEngine(cfg, params, EngineConfig(**kw)) for _ in range(2)]
    prompt = np.arange(6, dtype=np.int32)
    reqs = [Request(rid=0, tokens=prompt, max_new_tokens=16), Request(rid=1, tokens=prompt, max_new_tokens=2),
            Request(rid=2, tokens=prompt, max_new_tokens=2)]
    router = FleetRouter(engines, clock=ManualClock(tick=0.1))
    comps = {c.rid: c for c in router.run(reqs)}
    assert comps[0].replica == 0 and comps[1].replica == 1
    assert router.stats["requeued"] == 1
    assert comps[2].replica == 1
    assert comps[2].finished < comps[0].finished


def test_router_fail_fast_when_no_replica_can_ever_admit(model):
    cfg, params = model[2:]
    engines = _fleet(cfg, params, 2, max_seq=32, max_new=4, decode_chunk=4, prefill_bucket=8, pool_pages=2)
    big = Request(rid=0, tokens=np.arange(26, dtype=np.int32), max_new_tokens=4)
    with pytest.raises(RuntimeError, match="never be admitted"):
        FleetRouter(engines, clock=ManualClock()).run([big])


def test_queue_wait_separates_arrival_from_admission(model):
    """The pool fits one lifetime bill at a time: rid 1 waits out rid 0's
    service, and queue wait + service == latency for both."""
    cfg, params = model[2:]
    eng = ServeEngine(cfg, params, EngineConfig(max_slots=2, max_seq=32, max_new=16, decode_chunk=4,
                                                prefill_bucket=8, page_size=8, pool_pages=4))
    reqs = [Request(rid=i, tokens=np.arange(8, dtype=np.int32), max_new_tokens=16) for i in range(2)]
    comps = {c.rid: c for c in ContinuousScheduler(eng, clock=ManualClock(tick=0.1)).run(reqs)}
    for c in comps.values():
        assert c.queue_wait >= 0 and c.service > 0
        np.testing.assert_allclose(c.queue_wait + c.service, c.latency)
    assert comps[1].queue_wait > comps[0].queue_wait
    assert comps[1].queue_wait > comps[0].service / 2


# ---------------------------------------------------------------------------
# the pair's placement, the static path


def test_disagg_pair_with_prefill_device(model):
    """``prefill_device`` names where the prefill worker runs. Naming the
    parameters' own device keeps one copy of them and the colocated
    engine's tokens and stats; only another device makes a pair (the card
    test moves the prefill to the CPU and decodes on the card)."""
    cfg, params = model[2:]
    reqs = staggered_stream(cfg.vocab_size, 9, seed=3)
    out = {}
    for name, kw in (("colocated", {}), ("pair", dict(prefill_device="cpu"))):
        eng = ServeEngine(cfg, params, EngineConfig(**ECFG), **kw)
        assert eng.prefill.params is params and eng.prefill.device == eng.decode.device
        comps = ContinuousScheduler(eng, clock=ManualClock(tick=0.2)).run(reqs)
        out[name] = ({c.rid: c.tokens.tolist() for c in comps}, dict(eng.stats))
    assert out["pair"] == out["colocated"]
    assert out["pair"][1]["handoffs"] == out["pair"][1]["prefill_dispatches"] > 0


def test_static_generate_matches_jax(model):
    """Greedy tokens equal JAX ``static_generate``'s on the same prompts."""
    jcfg, jparams, cfg, params = model
    prompts = np.random.RandomState(5).randint(0, cfg.vocab_size, size=(3, 11)).astype(np.int32)
    gen = 7
    want = np.asarray(jax_static_generate(jparams, jcfg, {"tokens": jnp.asarray(prompts)}, gen))
    got = static_generate(params, cfg, {"tokens": torch.from_numpy(prompts)}, gen)
    assert got.dtype == torch.int32 and got.shape == (3, gen)
    np.testing.assert_array_equal(got.numpy(), want)
    reqs = [Request(rid=i, tokens=p, max_new_tokens=gen) for i, p in enumerate(prompts)]
    _margin_check(cfg, params, reqs, {i: want[i] for i in range(3)})


# ---------------------------------------------------------------------------
# the launcher


def _launch_serve(argv):
    from repro_torch.launch import serve

    return serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu", *argv])


def test_serve_fleet_args_fail_fast():
    from repro_torch.config.registry import get_arch
    from repro_torch.launch.serve import build_parser, validate_args

    parser = build_parser()
    dec = get_arch("smollm-135m")
    for argv, match in (
        (["--replicas", "0"], "--replicas must be >= 1"),
        (["--replicas", "2", "--engine", "static"], "Use --engine continuous"),
    ):
        with pytest.raises(SystemExit, match=match):
            validate_args(parser.parse_args(argv), dec)
    validate_args(parser.parse_args(["--replicas", "3"]), dec)
    validate_args(parser.parse_args(["--replicas", "2", "--kv-layout", "dense"]), dec)


def test_serve_cli_fleet_cpu(tmp_path):
    """``--replicas 2`` on the CPU: the reference's log lines, a
    shared registry with both replicas' labels that the validator passes,
    and the tokens of one engine on the same stream."""
    from repro_torch.obs.validate import validate_metrics, validate_trace

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    flags = ["--requests", "6", "--max-slots", "2", "--prompt-len", "24", "--gen", "6"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "smollm-135m", "--reduced", "--device", "cpu",
         *flags, "--replicas", "2", "--metrics-out", str(tmp_path / "m.jsonl"),
         "--trace-out", str(tmp_path / "t.json")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    for line in ("fleet[2]: 6 reqs", "replica 0:", "replica 1:", "replica 1 kv pool:", "router: 6 routed",
                 "sample continuation"):
        assert line in proc.stderr, line
    records = validate_metrics(str(tmp_path / "m.jsonl"))
    assert {r["labels"].get("replica") for r in records if r["name"] == "serve.prefill.dispatches"} == {"0", "1"}
    validate_trace(str(tmp_path / "t.json"))
    single = _launch_serve(flags)
    fleet = _launch_serve([*flags, "--replicas", "2"])
    assert [c.tokens.tolist() for c in fleet["completions"]] == [c.tokens.tolist() for c in single["completions"]]
    assert len(fleet["replicas"]) == 2 and all(r["admitted"] > 0 for r in fleet["replicas"])
    assert fleet["stats"] == {k: sum(r[k] for r in fleet["replicas"]) for k in fleet["stats"]}
    assert fleet["router"]["routed"] == 6 and single["router"]["routed"] == 6


def test_serve_cli_static_cpu():
    """``--engine static``: its sample is ``static_generate``'s tokens on
    the launcher's prompts."""
    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.models.transformer import cast_weights, init_lm

    result = _launch_serve(["--engine", "static", "--batch", "3", "--prompt-len", "24", "--gen", "6"])
    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32",
                                                          backend=BackendPolicy())
    params = cast_weights(init_lm(cfg, torch.Generator().manual_seed(0)), cfg)
    tokens = torch.as_tensor(make_token_stream(0, cfg.vocab_size, 3, 24)["tokens"][:, :24])
    want = static_generate(params, cfg, {"tokens": tokens}, 6)
    assert result["sample"] == want[0].tolist() and result["tokens"] == 18.0
