"""The port's serving path (``repro_torch.serve``) on the CPU.

* ``KVPool``: one random sequence of operations gives the same page ids,
  refcounts and errors as the JAX package's pool.
* ``ServeEngine``, continuous and paged, reduced smollm-135m in f32 with
  JAX weights carried across: 6 requests with ragged 9–24-token prompts,
  8 new tokens each, 3 slots, page size 8, under ``ManualClock``; its
  greedy tokens equal the JAX engine's. The JAX run's smallest top-2 logit
  margin is checked to exceed 1e-3, so a near-tie cannot decide a token.
* Within the port: paged, dense and static give the same tokens; idle
  slots cannot clobber live pages; decode reads nothing back from the
  device inside a chunk (one host sync per chunk).
* The launcher runs to its tok/s line on the CPU.
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

from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.models import init_lm as jax_init_lm
from repro.models import lm_forward as jax_lm_forward
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import KVPool as JaxKVPool
from repro.serve import ManualClock as JaxManualClock
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.serve import (
    ContinuousScheduler,
    EngineConfig,
    KVPool,
    ManualClock,
    Request,
    ServeEngine,
    staggered_stream,
    static_generate,
)

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
GEN = 8
ENGINE = dict(max_slots=3, max_seq=32, max_new=GEN, decode_chunk=4, page_size=8)


def _prompts():
    rng = np.random.RandomState(11)
    lens = [9, 24, 13, 17, 10, 21]
    return [rng.randint(0, 512, size=n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def served():
    """Reduced smollm-135m in f32, JAX weights; the JAX engine's tokens. The
    (tied) embedding is scaled by 10, which spreads the random model's
    logits (std about 2 instead of 0.2), so greedy tokens are decided by
    wide top-2 margins."""
    jcfg = jax_reduced_variant(jax_get_arch("smollm-135m")).replace(
        dtype="float32", param_dtype="float32", attn_backend="ref", decode_backend="ref"
    )
    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32")
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_lm(jcfg, jax.random.key(7)))
    jparams["embed"]["table"] = jparams["embed"]["table"] * np.float32(10.0)
    prompts = _prompts()
    eng = JaxServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), JaxEngineConfig(**ENGINE))
    comps = JaxScheduler(eng, clock=JaxManualClock()).run(
        [JaxRequest(rid=i, tokens=p, max_new_tokens=GEN) for i, p in enumerate(prompts)]
    )
    jax_tokens = [np.asarray(c.tokens) for c in comps]
    # the logits behind every generated token, teacher-forced in one causal forward
    seqs = np.zeros((len(prompts), 32), np.int32)
    for i, (p, t) in enumerate(zip(prompts, jax_tokens)):
        seqs[i, : len(p) + GEN - 1] = np.concatenate([p, t[:-1]])
    logits = np.asarray(jax_lm_forward(jparams, jcfg, {"tokens": jnp.asarray(seqs)})[0])
    margins = []
    for i, p in enumerate(prompts):
        rows = logits[i, len(p) - 1 : len(p) - 1 + GEN]
        top2 = np.sort(rows, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        np.testing.assert_array_equal(rows.argmax(-1), jax_tokens[i])
    return cfg, lm_params_from_jax(cfg, jparams), prompts, jax_tokens, float(np.min(margins))


def _run(cfg, params, prompts, **kw):
    eng = ServeEngine(cfg, params, EngineConfig(**{**ENGINE, **kw}))
    comps = ContinuousScheduler(eng, clock=ManualClock()).run(
        [Request(rid=i, tokens=p, max_new_tokens=GEN) for i, p in enumerate(prompts)]
    )
    assert [c.rid for c in comps] == list(range(len(prompts)))
    return eng, [c.tokens for c in comps]


def test_engine_tokens_match_jax(served):
    cfg, params, prompts, jax_tokens, margin = served
    assert margin > 1e-3, f"JAX run has a near-tie (top-2 margin {margin:.2e})"
    eng, tokens = _run(cfg, params, prompts, kv_layout="paged")
    for got, want in zip(tokens, jax_tokens):
        np.testing.assert_array_equal(got, want)
    assert eng.pool.pages_in_use == 0 and eng.pool.free_pages == eng.pool.n_pages


def test_layouts_and_static_agree(served):
    cfg, params, prompts, jax_tokens, _ = served
    _, dense = _run(cfg, params, prompts, kv_layout="dense")
    for got, want in zip(dense, jax_tokens):
        np.testing.assert_array_equal(got, want)
    for p, want in zip(prompts, jax_tokens):
        got = static_generate(params, cfg, {"tokens": torch.from_numpy(p[None])}, GEN, max_seq=32)
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_paged_matches_dense_with_appends_and_deferral(served):
    """Staggered ragged stream on a tight pool: decode-time page appends and
    deferred admissions run, and paged equals dense token for token."""
    cfg, params, _, _, _ = served
    reqs = staggered_stream(cfg.vocab_size, 7, seed=4, prompt_range=(4, 14), budget_range=(2, 9))
    outs = {}
    for layout, pool_pages in (("dense", 0), ("paged", 8)):
        eng = ServeEngine(cfg, params, EngineConfig(
            max_slots=2, max_seq=48, max_new=8, decode_chunk=3, prefill_bucket=8,
            kv_layout=layout, page_size=8, pool_pages=pool_pages,
        ))
        comps = ContinuousScheduler(eng, clock=ManualClock(tick=0.2)).run(reqs)
        outs[layout] = {c.rid: c.tokens for c in comps}
        if layout == "paged":
            assert eng.stats["page_appends"] > 0
            assert eng.pool.pages_in_use == 0
    assert outs["dense"].keys() == outs["paged"].keys() == set(range(7))
    for rid in outs["dense"]:
        np.testing.assert_array_equal(outs["dense"][rid], outs["paged"][rid])


def test_paged_idle_slots_cannot_clobber(served):
    """An evicted slot keeps rewriting its frozen position as it rides along
    in the batched decode; its table row must point at the scratch page
    before its old pages are handed out again. A short request drains early (its
    slot stays idle) while the survivors' page appends take exactly the
    returned pages; every live position of the survivors' paged caches must
    then equal the dense engine's rows."""
    cfg, params, _, _, _ = served
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, size=4).astype(np.int32) for _ in range(3)]
    budgets = [2, 14, 14]

    def drive(layout):
        eng = ServeEngine(cfg, params, EngineConfig(
            max_slots=3, max_seq=32, max_new=16, decode_chunk=2, prefill_bucket=4,
            kv_layout=layout, page_size=4, pool_pages=12,
        ))
        slots = eng.admit_many(list(zip(prompts, budgets)))
        freed = None
        for _ in range(20):
            eng.decode_chunk()
            active, n_out = eng.sync()
            if not active[slots[0]] and freed is None:
                if eng.pool is not None:
                    freed = set(eng.pool.owned(slots[0]))
                eng.fetch(slots[0], int(n_out[slots[0]]))  # early drain, no refill
            if not active.any():
                break
        assert not active.any()
        return eng, slots, freed

    eng_d, slots_d, _ = drive("dense")
    eng_p, slots_p, freed = drive("paged")
    assert slots_d == slots_p
    survivors = {p for s in slots_p[1:] for p in eng_p.pool.owned(s)}
    assert freed and freed <= survivors  # the hazard really occurred
    table = eng_p._state.page_table.numpy()
    for idx in (1, 2):
        slot = slots_p[idx]
        for dn, pn in (("k", "k_pages"), ("v", "v_pages")):
            dense_rows = eng_d._state.kv[dn][:, slot].numpy()
            pages = eng_p._state.kv[pn].numpy()
            for j in range(4 + budgets[idx]):
                np.testing.assert_allclose(
                    pages[:, table[slot, j // 4], j % 4], dense_rows[:, j], rtol=1e-5, atol=1e-5,
                    err_msg=f"{pn} slot {slot} position {j} clobbered",
                )
    assert eng_p.stats["table_resets"] >= 1


class _NoDeviceReads:
    """Makes every way of reading a tensor's value on the host raise."""

    NAMES = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__", "__index__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(*a, **k):
            raise AssertionError("decode chunk read a tensor's value on the host")

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse)

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_decode_host_syncs_one_per_chunk(served, layout):
    """Host syncs equal decode chunks, ceil((gen-1)/chunk) of them, and a
    chunk never reads a value back from the device."""
    cfg, params, _, _, _ = served
    prompt = np.arange(8, dtype=np.int32)
    counts = {}
    for gen in (4, 16):
        eng = ServeEngine(cfg, params, EngineConfig(max_slots=2, max_seq=48, max_new=16, decode_chunk=8, kv_layout=layout))
        eng.admit_many([(prompt, gen), (prompt[:5], gen)])
        n_chunks = 0
        while True:
            with _NoDeviceReads():
                eng.decode_chunk()
            n_chunks += 1
            active, _ = eng.sync()
            if not active.any():
                break
        assert eng.stats["host_syncs"] == eng.stats["decode_chunks"] == n_chunks == -(-(gen - 1) // 8)
        counts[gen] = n_chunks
    assert counts == {4: 1, 16: 2}


def test_kv_pool_matches_jax():
    """The same random operations on both pools: the same page ids,
    refcounts, free counts, table rows and errors."""
    jcfg = jax_reduced_variant(jax_get_arch("smollm-135m"))
    cfg = reduced_variant(get_arch("smollm-135m"))
    kw = dict(max_slots=4, max_seq=64, prefill_bucket=16, page_size=8, pool_pages=20)
    pools = (JaxKVPool(jcfg, JaxEngineConfig(**kw)), KVPool(cfg, EngineConfig(**kw)))
    rng = np.random.RandomState(0)
    staged = []
    for step in range(400):
        op = rng.randint(8)
        slot = int(rng.randint(6))
        n = int(rng.randint(1, 6))
        results = []
        for pool in pools:
            try:
                if op == 0:
                    r = pool.alloc(slot, n)
                elif op == 1:
                    r = pool.free_slot(slot)
                elif op == 2:
                    src = pool.owned((slot + 1) % 6)
                    r = pool.attach(slot, src[:1]) if src else None
                elif op == 3:
                    r = pool.cow(slot, n % 3)
                elif op == 4:
                    r = pool.stage(n)
                elif op == 5:
                    r = pool.donate(staged[-1]) if staged else None
                elif op == 6:
                    r = pool.adopt(slot, n)
                else:
                    r = pool.table_row(slot).tolist()
            except RuntimeError as ex:
                r = ("error", str(ex).split(":")[0])
            results.append((r, pool.free_pages, pool.pages_in_use, [pool.refcount(p) for p in range(pool.n_pages)],
                            pool.staged_ids, pool.owned(slot)))
        assert results[0] == results[1], f"step {step} op {op}"
        if op == 4 and results[0][0][0] != "error":
            staged.append(results[0][0][0])  # the staging id
        if step == 250:
            for pool in pools:
                pool.reset()
    assert pools[0].scratch_page == pools[1].scratch_page == 20


def test_engine_config_fails_fast():
    for kw in (dict(disagg=True), dict(prefix_cache=True), dict(spec_k=2)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            EngineConfig(**kw)
    with pytest.raises(ValueError, match="power of two"):
        EngineConfig(page_size=12, max_seq=48)
    with pytest.raises(ValueError, match="multiple of"):
        EngineConfig(page_size=16, max_seq=40)


def test_serve_cli_cpu_runs():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    for extra in ([], ["--kv-layout", "dense"], ["--engine", "static", "--batch", "2"]):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "smollm-135m", "--reduced", "--device", "cpu",
             "--requests", "4", "--max-slots", "2", "--prompt-len", "12", "--gen", "6", *extra],
            capture_output=True, text=True, env=env, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "tok/s" in proc.stderr and "sample continuation" in proc.stderr
        if not extra:
            assert "fleet[1]:" in proc.stderr and "kv pool:" in proc.stderr
