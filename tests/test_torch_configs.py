"""The configs granite-3-2b, internlm2-20b (dense), qwen3-32b (dense,
qk-norm), mixtral-8x7b (MoE, sliding window) and qwen3-moe-235b-a22b (MoE,
qk-norm) in the port, against the JAX package on the CPU.

* Every field of the port's ``ModelConfig`` equals the JAX config's (the
  backend through ``backend_for`` per op: the port's field is always a
  policy, the reference's is unset until a caller sets one), ``remat``
  among them, and the JAX fields the port's config lacks sit at their
  family-off defaults (``scan_layers`` is left out on purpose: it bounds
  the size of a compiled XLA program, and the eager port has none).
* Each arch's reduced variant (2 layers, d_model 128, 4 heads, hd 32, at
  most 4 experts, top 2), and the reduced variant regrouped to the arch's
  own GQA group (4 query heads a kv head for granite and mixtral, 6 for
  internlm2, 8 for qwen3-32b, 16 for qwen3-moe, at hd 16), in f32 with JAX
  ``init_lm`` weights carried across: ``lm_forward`` logits, prefill logits
  at per-row last indices and four decode steps on the dense and the
  paged layouts, each within 1e-5 of JAX's (absolute, logits of size
  about 1)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JaxModelConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.models import init_lm as jax_init_lm
from repro.models import init_lm_state as jax_init_lm_state
from repro.models import lm_decode as jax_lm_decode
from repro.models import lm_forward as jax_lm_forward
from repro.models import lm_prefill as jax_lm_prefill
from repro_torch.config.model import ModelConfig, reduced_variant
from repro_torch.config.registry import NOT_PORTED, get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.transformer import init_lm_state, lm_decode, lm_forward, lm_prefill

pytestmark = pytest.mark.tier1

ARCHS = ("granite-3-2b", "internlm2-20b", "qwen3-32b", "mixtral-8x7b", "qwen3-moe-235b-a22b")
# JAX fields the port's config leaves out on purpose: scan_layers bounds the
# size of a compiled XLA program, and the eager port has no such program
NOT_YET = ("scan_layers",)
# (head_dim, GQA group) of each arch
HEADS = {"granite-3-2b": (64, 4), "internlm2-20b": (128, 6), "qwen3-32b": (128, 8), "mixtral-8x7b": (128, 4),
         "qwen3-moe-235b-a22b": (128, 16)}
B, PROMPT, MAX_SEQ, PS, STEPS = 2, 12, 24, 8, 4
LENS = np.array([12, 7], np.int32)
TOL = 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_jax(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    assert arch not in NOT_PORTED
    mine = {f.name for f in dataclasses.fields(ModelConfig)} - {"backend"}
    for name in mine:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for op in ("attn", "decode"):
        assert cfg.backend_for(op) == jcfg.backend_for(op) == "auto", op
    defaults = JaxModelConfig(name="d", family="dense")
    for f in dataclasses.fields(JaxModelConfig):
        if f.name not in mine and f.name not in NOT_YET:
            assert getattr(jcfg, f.name) == getattr(defaults, f.name), f.name
    assert (cfg.head_dim_, cfg.num_heads // cfg.num_kv_heads) == HEADS[arch]
    assert cfg.remat and cfg.expert_d_ff == jcfg.expert_d_ff
    red, jred = reduced_variant(cfg), jax_reduced_variant(jcfg)
    for name in mine:
        assert getattr(red, name) == getattr(jred, name), name


def _variants(arch):
    """The reduced variant and the reduced variant with the arch's GQA
    group, each as (jax cfg, port cfg), f32."""
    jred = jax_reduced_variant(jax_get_arch(arch)).replace(dtype="float32", param_dtype="float32")
    red = reduced_variant(get_arch(arch)).replace(dtype="float32", param_dtype="float32")
    g = get_arch(arch).num_heads // get_arch(arch).num_kv_heads
    group = dict(num_heads=2 * g, num_kv_heads=2, head_dim=16)
    return {"reduced": (jred, red), "grouped": (jred.replace(**group), red.replace(**group))}


@pytest.fixture(scope="module", params=[(a, v) for a in ARCHS for v in ("reduced", "grouped")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, variant = request.param
    jcfg, cfg = _variants(arch)[variant]
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_lm(jcfg, jax.random.key(3)))
    # norm scales (qk-norm's too) start at zero: give them values so that they count
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32)
        if any(n in jax.tree_util.keystr(p) for n in ("scale", "q_norm", "k_norm")) else x,
        jparams,
    )
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, jparams), lm_params_from_jax(cfg, jparams)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(want).max() > 0.1  # logits of size about 1, not vanishing
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_lm_forward_matches_jax(model):
    jcfg, cfg, jparams, params = model
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    want, _ = jax_lm_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        got, _ = lm_forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)


def test_prefill_and_decode_match_jax(model):
    """Prefill at per-row last indices, then four decode steps fed fixed
    tokens on the dense layout and, from the same prefill's KV laid out in
    pages, on the paged one."""
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    jstate = jax_init_lm_state(jcfg, B, MAX_SEQ)
    want, jstate = jax_lm_prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, jstate,
                                  last_index=jnp.asarray(LENS - 1))
    with torch.inference_mode():
        state = init_lm_state(cfg, B, MAX_SEQ)
        got, state = lm_prefill(params, cfg, {"tokens": torch.from_numpy(tokens)}, state,
                                last_index=torch.from_numpy(LENS - 1))
        _close(got, want)
        width = MAX_SEQ // PS
        n_pages = B * width + 1
        table = np.random.default_rng(5).permutation(n_pages - 1)[: B * width].reshape(B, width).astype(np.int32)
        pages = {}
        for n in ("k", "v"):
            dense = state[n].numpy()  # (L, B, MAX_SEQ, KH, hd)
            paged = np.zeros((dense.shape[0], n_pages, PS) + dense.shape[3:], np.float32)
            for r in range(B):
                for j in range(MAX_SEQ):
                    paged[:, table[r, j // PS], j % PS] = dense[:, r, j]
            pages[f"{n}_pages"] = paged
        jpaged = {"p0": {n: jnp.asarray(a) for n, a in pages.items()}}
        paged = {n: torch.from_numpy(a.copy()) for n, a in pages.items()}
        pos = LENS.copy()
        for t in range(STEPS):
            tok = feed[t]
            want_d, jstate = jax_lm_decode(jparams, jcfg, jnp.asarray(tok), jstate, jnp.asarray(pos))
            want_p, jpaged = jax_lm_decode(jparams, jcfg, jnp.asarray(tok), jpaged, jnp.asarray(pos),
                                           page_table=jnp.asarray(table))
            got_d, state = lm_decode(params, cfg, torch.from_numpy(tok), state, torch.from_numpy(pos))
            got_p, paged = lm_decode(params, cfg, torch.from_numpy(tok), paged, torch.from_numpy(pos),
                                     page_table=torch.from_numpy(table))
            _close(got_d, want_d)
            _close(got_p, want_p)
            pos = pos + 1
