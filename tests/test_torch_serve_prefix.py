"""Shared-prefix serving in the port (``repro_torch.serve``) on the CPU,
held against the JAX package on the same numpy inputs.

Reduced smollm-135m in f32 (2 layers, d_model 128, 4 heads over 2 kv heads,
hd 32, vocabulary 512) with JAX weights carried across and the tied
embedding scaled by 10, as in ``tests/test_torch_serve.py``: the random
model's logits spread, and every stream's greedy tokens are checked to have
a top-2 margin above 1e-3, so no near-tie decides a token. The JAX engines
run the plain reference kernels (``attn_backend="ref"``,
``decode_backend="ref"``).

* ``attn_extend``/``lm_extend``: every position's logits and the page
  buffers within 1e-5, from mid-page starts, with a pad tail past the table
  extent redirected to the scratch page.
* ``PrefixCache``: one seeded sequence of insert, match, probe and make_room
  on both packages' pools gives equal pages, refcounts and free lists.
* The reference's prefix and speculative streams (splice, a fully-covered
  prompt through copy-on-write, eviction on a tight pool, spec with a
  matched and a mismatched drafter, spec with the prefix cache) through
  both engines: equal tokens, ``stats`` equal key for key, and the tokens
  of the port's plain engine.
* Router prefix affinity with two port engines; the hot-prefix, ragged and
  arrival streams against the reference's; the fail-fast messages; one
  host read per speculative chunk; the launcher's flags on the CPU.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.models import init_lm as jax_init_lm
from repro.models import init_lm_state as jax_init_lm_state
from repro.models import lm_extend as jax_lm_extend
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import KVPool as JaxKVPool
from repro.serve import ManualClock as JaxManualClock
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import hot_prefix_stream as jax_hot_prefix_stream
from repro.serve import ragged_stream as jax_ragged_stream
from repro.serve import staggered_stream as jax_staggered_stream
from repro.serve.prefix_cache import PrefixCache as JaxPrefixCache
from repro.serve.traffic import with_arrivals as jax_with_arrivals
from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.transformer import init_lm, init_lm_state, lm_extend, lm_forward
from repro_torch.serve import (
    ContinuousScheduler,
    EngineConfig,
    FleetRouter,
    KVPool,
    ManualClock,
    PrefixCache,
    Request,
    ServeEngine,
    hot_prefix_stream,
    ragged_stream,
    staggered_stream,
    with_arrivals,
)
from test_torch_serve import _NoDeviceReads

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
# the reference's stream settings (tests/test_serve.py _PCFG)
PCFG = dict(max_slots=2, max_seq=48, max_new=8, decode_chunk=3, prefill_bucket=8, page_size=8)
# the mismatched drafter: one narrow layer over the target's vocabulary
DRAFTER = dict(num_layers=1, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128)


def _jax_cfg(**kw):
    return jax_reduced_variant(jax_get_arch("smollm-135m")).replace(
        dtype="float32", param_dtype="float32", attn_backend="ref", decode_backend="ref", **kw
    )


def _cfg(**kw):
    return reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32", **kw)


def _weights(jcfg, seed, scale):
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_lm(jcfg, jax.random.key(seed)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * np.float32(scale)
    return jparams


@pytest.fixture(scope="module")
def model():
    """The target (embedding x10) and the mismatched drafter, each as
    ``(jax cfg, jax params, port cfg, port params)``."""
    jcfg, cfg = _jax_cfg(), _cfg()
    jparams = _weights(jcfg, 7, 10.0)
    jdcfg, dcfg = _jax_cfg(**DRAFTER), _cfg(**DRAFTER)
    jdparams = _weights(jdcfg, 9, 1.0)
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    return {
        "target": (jcfg, to_jax(jparams), cfg, lm_params_from_jax(cfg, jparams)),
        "drafter": (jdcfg, to_jax(jdparams), dcfg, lm_params_from_jax(dcfg, jdparams)),
    }


# ---------------------------------------------------------------------------
# attn_extend / lm_extend


def test_lm_extend_matches_jax(model):
    """Two rows continuing a paged cache from positions 5 and 13 (mid-page),
    12 tokens each: row 1 runs past the table extent (24 positions), and
    its pad tail goes to the scratch page. All-position logits and every
    page but the scratch page within 1e-5."""
    jcfg, jparams, cfg, params = model["target"]
    ps, n_pages = 8, 6
    rng = np.random.RandomState(0)
    jstate = jax_init_lm_state(jcfg, 2, 24, kv_pages=n_pages + 1, kv_page_size=ps)
    pages = {n: rng.randn(*jstate["p0"][n].shape).astype(np.float32) for n in ("k_pages", "v_pages")}
    table = np.array([[4, 0, 2], [1, 5, n_pages]], np.int32)  # row 1's third entry: scratch
    tokens = rng.randint(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    pos = np.array([5, 13], np.int32)
    jlogits, jst = jax_lm_extend(
        jparams, jcfg, jnp.asarray(tokens), {"p0": {n: jnp.asarray(a) for n, a in pages.items()}},
        jnp.asarray(pos), jnp.asarray(table),
    )
    state = init_lm_state(cfg, 2, 24, kv_pages=n_pages + 1, kv_page_size=ps)
    for n, a in pages.items():
        state[n].copy_(torch.from_numpy(a))
    with torch.inference_mode():
        logits, state = lm_extend(
            params, cfg, torch.from_numpy(tokens), state, torch.from_numpy(pos), torch.from_numpy(table)
        )
    assert logits.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    for n in ("k_pages", "v_pages"):
        got, want = state[n].numpy()[:, :n_pages], np.asarray(jst["p0"][n])[:, :n_pages]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        # the writes landed: row 0's positions 5..16 and row 1's 13..15
        assert not np.allclose(got[:, 4, 5:], pages[n][:, 4, 5:])
        assert not np.allclose(got[:, 5, 5:8], pages[n][:, 5, 5:8])
        np.testing.assert_array_equal(got[:, 3], pages[n][:, 3])  # untouched page


def test_extend_refuses_a_ring(model):
    _, _, cfg, params = model["target"]
    state = init_lm_state(cfg, 1, 16, kv_pages=3, kv_page_size=8)
    with pytest.raises(ValueError, match="non-ring"):
        lm_extend(params, cfg.replace(sliding_window=8), torch.zeros((1, 2), dtype=torch.int32), state,
                  torch.zeros(1, dtype=torch.int32), torch.zeros((1, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# PrefixCache on both pools


def test_prefix_cache_matches_jax():
    """One seeded sequence of slot allocations, inserts, matches (attached
    to a slot), probes, evictions and drains on the reference's cache and
    the port's: the same pages, counts, refcounts and free lists."""
    kw = dict(max_slots=4, max_seq=64, prefill_bucket=8, page_size=4, pool_pages=24)
    jpool = JaxKVPool(jax_reduced_variant(jax_get_arch("smollm-135m")), JaxEngineConfig(**kw))
    pool = KVPool(reduced_variant(get_arch("smollm-135m")), EngineConfig(**kw))
    caches = (JaxPrefixCache(jpool), PrefixCache(pool))
    rng = np.random.RandomState(1)
    heads = [rng.randint(0, 6, size=12) for _ in range(3)]  # few distinct heads, so runs share
    for step in range(300):
        op = rng.randint(6)
        slot = int(rng.randint(4))
        tokens = np.concatenate([heads[rng.randint(3)][: rng.randint(0, 13)], rng.randint(0, 6, size=rng.randint(0, 9))])
        n = int(rng.randint(1, 5))
        results = []
        for cache in caches:
            p = cache.pool
            try:
                if op == 0:
                    p.free_slot(slot)
                    r = p.alloc(slot, -(-len(tokens) // 4))
                    r = (r, cache.insert(tokens, p.owned(slot)))
                elif op == 1:
                    pages = cache.match(tokens)
                    p.free_slot(slot)
                    p.attach(slot, pages)
                    r = pages
                elif op == 2:
                    r = cache.probe(tokens)
                elif op == 3:
                    r = cache.make_room(n)
                elif op == 4:
                    r = p.free_slot(slot)
                else:
                    r = (cache.reclaimable(), cache.cached_pages)
            except RuntimeError as ex:
                r = ("error", str(ex).split(":")[0])
            results.append((r, p.free_pages, [p.refcount(i) for i in range(p.n_pages)], p.owned(slot),
                            cache.cached_pages, cache.reclaimable()))
        assert results[0] == results[1], f"step {step} op {op}"
    assert caches[1].cached_pages > 0
    for cache in caches:
        cache.pool.reset()
        cache.clear()
        assert cache.cached_pages == 0 and cache.probe(heads[0]) == 0


# ---------------------------------------------------------------------------
# the reference's streams through both engines


def _margin_check(cfg, params, reqs, tokens):
    """Teacher-force every request's prompt and tokens through the port's
    full forward: the greedy tokens are the argmax, with a top-2 margin
    above 1e-3 (no near-tie can decide a token)."""
    margins = []
    with torch.inference_mode():
        for r in reqs:
            got = tokens[r.rid]
            seq = torch.from_numpy(np.concatenate([r.tokens, got[:-1]]).astype(np.int32))[None]
            rows = lm_forward(params, cfg, {"tokens": seq})[0][0, len(r.tokens) - 1 :]
            np.testing.assert_array_equal(rows.argmax(-1).numpy(), got)
            top2 = rows.topk(2, dim=-1).values
            margins.append(float((top2[:, 0] - top2[:, 1]).min()))
    assert min(margins) > 1e-3, f"near-tie: smallest top-2 margin {min(margins):.2e}"


def _serve_jax(model, reqs, ecfg, drafter=None, tick=0.2):
    jcfg, jparams = model["target"][:2]
    jd = None
    if drafter is not None:
        jd = (jcfg, jparams) if drafter == "matched" else model["drafter"][:2]
    eng = JaxServeEngine(jcfg, jparams, JaxEngineConfig(**ecfg), drafter=jd)
    comps = JaxScheduler(eng, clock=JaxManualClock(tick=tick)).run(
        [JaxRequest(rid=r.rid, tokens=r.tokens, max_new_tokens=r.max_new_tokens, arrival=r.arrival) for r in reqs]
    )
    return {c.rid: np.asarray(c.tokens) for c in comps}, eng


def _serve(model, reqs, ecfg, drafter=None, tick=0.2):
    cfg, params = model["target"][2:]
    d = None
    if drafter is not None:
        d = (cfg, params) if drafter == "matched" else model["drafter"][2:]
    eng = ServeEngine(cfg, params, EngineConfig(**ecfg), drafter=d)
    comps = ContinuousScheduler(eng, clock=ManualClock(tick=tick)).run(reqs)
    return {c.rid: c.tokens for c in comps}, eng


def _splice_stream(cfg):
    rng = np.random.RandomState(11)
    p0 = rng.randint(0, cfg.vocab_size, size=20).astype(np.int32)  # 2 full pages + 4
    p_ext = np.concatenate([p0, rng.randint(0, cfg.vocab_size, size=8).astype(np.int32)])
    p_cold = rng.randint(0, cfg.vocab_size, size=13).astype(np.int32)
    return [Request(rid=i, tokens=p, max_new_tokens=4 + (i % 3), arrival=2.0 * i)
            for i, p in enumerate([p0, p0, p_ext, p_cold, p0])]


def _covered_stream(cfg):
    p = np.random.RandomState(12).randint(0, cfg.vocab_size, size=16).astype(np.int32)  # exactly 2 pages
    return [Request(rid=i, tokens=p, max_new_tokens=5, arrival=2.0 * i) for i in range(3)]


def _hot_stream(cfg, n, gen, seed, budget_min, shared, dt):
    prompts, budgets = hot_prefix_stream(cfg.vocab_size, n, 16, gen, seed=seed, budget_min=budget_min,
                                         shared_fraction=shared)
    return [Request(rid=i, tokens=p, max_new_tokens=b, arrival=dt * i) for i, (p, b) in enumerate(zip(prompts, budgets))]


STREAMS = {
    # name: (requests, engine knobs, drafter)
    "splice": (_splice_stream, dict(prefix_cache=True), None),
    "covered_cow": (_covered_stream, dict(prefix_cache=True), None),
    "tight_pool": (lambda c: _hot_stream(c, 10, 8, 2, 3, 0.6, 0.7), dict(prefix_cache=True, pool_pages=8), None),
    "spec_matched": (lambda c: staggered_stream(c.vocab_size, 7, seed=4, prompt_range=(4, 14), budget_range=(2, 9)),
                     dict(spec_k=3), "matched"),
    "spec_mismatched": (lambda c: staggered_stream(c.vocab_size, 7, seed=4, prompt_range=(4, 14),
                                                   budget_range=(2, 9)), dict(spec_k=3), "mismatched"),
    "spec_prefix": (lambda c: _hot_stream(c, 8, 6, 5, 2, 0.5, 1.0), dict(prefix_cache=True, spec_k=3), "matched"),
}


@pytest.fixture(scope="module")
def plain_tokens(model):
    """The port's plain engine (no cache, no drafter) on every stream, its
    tokens checked against teacher-forced argmaxes with wide margins."""
    cfg, params = model["target"][2:]
    out = {}
    for name, (make, knobs, _) in STREAMS.items():
        reqs = make(cfg)
        base = {k: v for k, v in knobs.items() if k == "pool_pages"}
        out[name], _ = _serve(model, reqs, {**PCFG, **base})
        _margin_check(cfg, params, reqs, out[name])
    return out


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_jax_engine(model, plain_tokens, name):
    """The port's accelerated engine against the reference's on the same
    stream: equal tokens, ``stats`` equal key for key, and the tokens of
    the port's plain engine (the parity contract of both features)."""
    make, knobs, drafter = STREAMS[name]
    reqs = make(model["target"][2])
    ecfg = {**PCFG, **knobs}
    want, jeng = _serve_jax(model, reqs, ecfg, drafter)
    got, eng = _serve(model, reqs, ecfg, drafter)
    assert got.keys() == want.keys() == plain_tokens[name].keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        np.testing.assert_array_equal(got[rid], plain_tokens[name][rid])
    assert dict(eng.stats) == {k: int(v) for k, v in dict(jeng.stats).items()}
    st = eng.stats
    if knobs.get("prefix_cache"):
        assert st["spliced_admissions"] > 0
        assert eng.prefix.cached_pages == jeng.prefix.cached_pages
        assert eng.pool.pages_in_use == jeng.pool.pages_in_use == eng.prefix.cached_pages
        assert sorted(eng.free_slots) == [0, 1]
    if name == "covered_cow":
        assert st["spliced_admissions"] == 2 and st["cow_copies"] >= 2
    if knobs.get("spec_k"):
        assert st["spec_steps"] > 0 and st["draft_proposed"] > 0
        if drafter == "matched":
            assert st["draft_accepted"] / st["draft_proposed"] > 0.5


def test_spliced_admission_prefills_less(model):
    """The splice stream with and without the cache: the spliced engine
    prefills fewer tokens and allocates fewer pages for the same output."""
    reqs = _splice_stream(model["target"][2])
    cold, ce = _serve(model, reqs, PCFG)
    hot, he = _serve(model, reqs, {**PCFG, "prefix_cache": True})
    for rid in cold:
        np.testing.assert_array_equal(cold[rid], hot[rid])
    assert he.stats["spliced_admissions"] >= 3 and he.stats["spliced_pages"] >= 6
    assert he.stats["prefill_tokens"] < ce.stats["prefill_tokens"]
    assert he.stats["pages_allocated"] < ce.stats["pages_allocated"]


@pytest.mark.parametrize("name", ["covered_cow", "tight_pool", "spec_prefix"])
def test_extend_writes_only_private_or_scratch_pages(model, monkeypatch, name):
    """Every K/V write of every extend (spliced tails, verify rounds, also
    rounds after every row has finished) lands on a page only its slot
    holds (refcount 1) or on the scratch page, and two writes share a
    (page, offset) only on the scratch page: the order of colliding index
    writes is undefined on the card."""
    from repro_torch.models import attention as attn_lib

    make, knobs, drafter = STREAMS[name]
    cfg, params = model["target"][2:]
    eng = ServeEngine(cfg, params, EngineConfig(**{**PCFG, **knobs}),
                      drafter=(cfg, params) if drafter else None)
    extend, seen = attn_lib.attn_extend, []

    def checked(p, x, c, cache, pos, table):
        ps, width = cache["k_pages"].shape[1], table.shape[1]
        idx = pos.long()[:, None] + torch.arange(x.shape[1])[None, :]
        pid = torch.gather(table.long(), 1, torch.clamp(idx // ps, max=width - 1))
        pid = torch.where(idx < width * ps, pid, cache["k_pages"].shape[0] - 1)
        scratch = eng.pool.scratch_page
        pairs = list(zip(pid.flatten().tolist(), (idx % ps).flatten().tolist()))
        for page, off in pairs:
            assert page == scratch or eng.pool.refcount(page) == 1, f"write into page {page}"
            assert page == scratch or pairs.count((page, off)) == 1, f"colliding writes at {page}:{off}"
        seen.append(len(pairs))
        return extend(p, x, c, cache, pos, table)

    monkeypatch.setattr(attn_lib, "attn_extend", checked)
    ContinuousScheduler(eng, clock=ManualClock(tick=0.2)).run(make(cfg))
    assert seen and eng.stats["spliced_admissions"] > 0


def test_spec_chunk_reads_nothing_back(model):
    """A speculative chunk reads no value back from the device, a round
    after every row has finished adds to no counter, and host syncs equal
    chunks."""
    cfg, params = model["target"][2:]
    eng = ServeEngine(cfg, params, EngineConfig(**{**PCFG, "spec_k": 3}), drafter=(cfg, params))
    prompt = np.arange(8, dtype=np.int32)
    eng.admit_many([(prompt, 8), (prompt[:5], 3)])
    chunks = 0
    while True:
        with _NoDeviceReads():
            eng.decode_chunk()
        chunks += 1
        active, _ = eng.sync()
        if not active.any():
            break
    assert eng.stats["host_syncs"] == eng.stats["decode_chunks"] == chunks
    before = {k: eng.stats[k] for k in ("spec_steps", "draft_proposed", "draft_accepted")}
    out = eng._state.out.clone()
    eng.decode._spec.chunk(2)  # two rounds with every row finished
    eng.sync()
    assert {k: eng.stats[k] for k in before} == before
    assert torch.equal(eng._state.out, out)


# ---------------------------------------------------------------------------
# router affinity, streams, fail-fast, launcher


def test_router_prefix_affinity_routes_hot_requests(model):
    """With per-replica prefix caches the router sends a request where its
    prefix is resident: the first hot serve lands by load, every re-serve on
    the replica holding its pages, which splices instead of prefilling."""
    cfg, params = model["target"][2:]
    rng = np.random.RandomState(21)
    hot = rng.randint(0, cfg.vocab_size, size=16).astype(np.int32)
    cold = [rng.randint(0, cfg.vocab_size, size=16).astype(np.int32) for _ in range(2)]
    reqs = [Request(rid=i, tokens=p, max_new_tokens=3, arrival=1.5 * i)
            for i, p in enumerate([hot, cold[0], hot, cold[1], hot, hot])]
    ecfg = EngineConfig(max_slots=2, max_seq=32, max_new=4, decode_chunk=3, prefill_bucket=8, page_size=8,
                        prefix_cache=True)
    engines = [ServeEngine(cfg, params, ecfg, replica=i) for i in range(2)]
    router = FleetRouter(engines, clock=ManualClock(tick=0.2))
    comps = {c.rid: c for c in router.run(reqs)}
    assert len(comps) == len(reqs)
    warm = comps[0].replica
    assert all(comps[r].replica == warm for r in (2, 4, 5)), "hot prompt bounced"
    assert router.stats["affinity_hits"] >= 3
    assert engines[warm].stats["spliced_admissions"] >= 3
    assert engines[1 - warm].stats["spliced_admissions"] == 0


def test_streams_match_reference():
    for kw in (dict(seed=0), dict(seed=3, shared_fraction=0.3, prefix_len=5, budget_min=2)):
        for mine, ref in ((hot_prefix_stream, jax_hot_prefix_stream), (ragged_stream, jax_ragged_stream)):
            if mine is ragged_stream:
                kw = {k: v for k, v in kw.items() if k in ("seed", "budget_min")}
            got, want = mine(512, 9, 12, 10, **kw), ref(512, 9, 12, 10, **kw)
            assert got[1] == want[1]
            for a, b in zip(got[0], want[0]):
                np.testing.assert_array_equal(a, b)
    prompts, budgets = hot_prefix_stream(512, 6, 12, 10)
    for a, b in zip(with_arrivals(prompts, budgets, 0.25), jax_with_arrivals(prompts, budgets, 0.25)):
        assert (a.rid, a.max_new_tokens, a.arrival) == (b.rid, b.max_new_tokens, b.arrival)
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for a, b in zip(staggered_stream(512, 5), jax_staggered_stream(512, 5)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    with pytest.raises(ValueError, match="shared_fraction"):
        hot_prefix_stream(512, 4, 8, 4, shared_fraction=1.5)


def test_prefix_spec_config_fail_fast(model):
    """The reference's gates: config-level where the config suffices,
    engine-level where the arch or drafter is needed; a disaggregated pair
    (``prefill_device``) is paged only."""
    EngineConfig(prefix_cache=True)
    EngineConfig(spec_k=2)
    with pytest.raises(ValueError, match="paged"):
        EngineConfig(kv_layout="dense", prefix_cache=True)
    with pytest.raises(ValueError, match="temperature"):
        EngineConfig(spec_k=2, temperature=0.7)
    with pytest.raises(ValueError, match=">= 0"):
        EngineConfig(spec_k=-1)
    cfg, params = model["target"][2:]
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(cfg, params, EngineConfig(**{**PCFG, "kv_layout": "dense"}), prefill_device="cpu")
    spec_cfg = EngineConfig(spec_k=2, **PCFG)
    with pytest.raises(ValueError, match="no drafter"):
        ServeEngine(cfg, params, spec_cfg)
    with pytest.raises(ValueError, match="spec_k == 0"):
        ServeEngine(cfg, params, EngineConfig(**PCFG), drafter=(cfg, params))
    with pytest.raises(ValueError, match="paged layout"):
        ServeEngine(cfg, params, EngineConfig(spec_k=2, **{**PCFG, "kv_layout": "dense"}), drafter=(cfg, params))
    with pytest.raises(ValueError, match="ring"):
        ServeEngine(cfg, params, spec_cfg, drafter=(cfg.replace(sliding_window=8), params))
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(cfg, params, spec_cfg, drafter=(cfg.replace(vocab_size=256), params))
    # a recurrent drafter cannot roll back past a rejected draft
    xcfg = reduced_variant(get_arch("xlstm-125m")).replace(dtype="float32")
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(cfg, params, spec_cfg, drafter=(xcfg, init_lm(xcfg, torch.Generator().manual_seed(0))))
    # the target itself: a ring cache cannot be spliced or rolled back
    swa = cfg.replace(sliding_window=16)
    for knobs in (dict(prefix_cache=True), dict(spec_k=2)):
        with pytest.raises(ValueError, match="non-ring"):
            ServeEngine(swa, params, EngineConfig(**{**PCFG, **knobs}), drafter=(cfg, params) if "spec_k" in knobs else None)


def test_serve_args_fail_fast():
    from repro_torch.launch.serve import build_parser, validate_args

    parser = build_parser()
    dec = get_arch("smollm-135m")
    for argv, match in (
        (["--prefix-cache", "--kv-layout", "dense"], "prefix-cache"),
        (["--hot-fraction", "1.5"], "hot-fraction"),
        (["--spec-decode", "--spec-k", "0"], "spec-k"),
        (["--spec-decode", "--temperature", "0.7"], "temperature"),
        (["--spec-decode", "--kv-layout", "dense"], "paged"),
        (["--spec-decode", "--drafter", "xlstm-125m"], "recurrent carry"),
        (["--spec-decode", "--drafter", "hubert-xlarge"], "does not match"),  # a 504-way codebook, not a vocabulary
        (["--spec-decode", "--drafter", "nope"], "unknown arch"),
    ):
        with pytest.raises(SystemExit, match=match):
            validate_args(parser.parse_args(argv), dec)
    validate_args(parser.parse_args(["--prefix-cache", "--spec-decode"]), dec)
    validate_args(parser.parse_args(["--prefix-cache", "--hot-fraction", "0.5"]), dec)


def test_serve_cli_prefix_spec_cpu_runs():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "smollm-135m", "--reduced", "--device", "cpu",
         "--engine", "continuous", "--kv-layout", "paged", "--requests", "6", "--max-slots", "2",
         "--prompt-len", "40", "--gen", "6", "--pool-pages", "12", "--prefix-cache", "--spec-decode", "--hot-fraction", "0.5"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    for line in ("fleet[1]:", "tok/s", "prefix cache:", "spec decode:", "sample continuation"):
        assert line in proc.stderr, line
    # the 20-token shared head fills one 16-token page, and the pool has room
    # to keep it cached: later hot requests splice it
    spliced = re.search(r"prefix cache: (\d+)/6 admissions spliced", proc.stderr)
    assert spliced and int(spliced.group(1)) > 0, proc.stderr[-2000:]
