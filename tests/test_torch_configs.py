"""The configs granite-3-2b, internlm2-20b (dense), qwen3-32b (dense,
qk-norm), mixtral-8x7b (MoE, sliding window), qwen3-moe-235b-a22b (MoE,
qk-norm), xlstm-125m (SSM: mLSTM and sLSTM blocks), jamba-v0.1-52b
(hybrid: Mamba, one attention layer in 8, MoE every other layer),
hubert-xlarge (audio encoder, hd 80) and phi-3-vision-4.2b (VLM, hd 96) in
the port, against the JAX package on the CPU. Every arch the reference
registers is ported (``NOT_PORTED`` is empty).

* Every field of the port's ``ModelConfig`` equals the JAX config's (the
  backend through ``backend_for`` per op: the port's field is always a
  policy, the reference's is unset until a caller sets one), ``remat``
  among them, and the JAX fields the port's config lacks sit at their
  family-off defaults (``scan_layers`` is left out on purpose: it bounds
  the size of a compiled XLA program, and the eager port has none).
* Each arch's reduced variant (2 layers, d_model 128, 4 heads, hd 32, at
  most 4 experts, top 2), and the reduced variant regrouped to the arch's
  own GQA group (4 query heads a kv head for granite and mixtral, 6 for
  internlm2, 8 for qwen3-32b, 16 for qwen3-moe, 4 for jamba, at hd 16;
  xlstm-125m has no attention, so no regrouped variant), in f32 with JAX
  ``init_lm`` weights carried across: ``lm_forward`` logits, prefill logits
  at per-row last indices and four decode steps on the dense and the
  paged layouts (the recurrent carries per slot beside the pages; dense
  only for xlstm-125m), each within 1e-5 of JAX's (absolute, logits of
  size about 1). The two recurrent archs are held to 1e-5 of the larger
  of 1 and the largest |logit|: jamba's untied head gives logits up to
  about 4, and its 8 layers (Mamba, MoE) add f32 rounding that the
  2-layer attention configs do not have. The encoder and the VLM take
  frames or a prefix, not tokens alone: their forward, loss, gradients and
  serving are in ``tests/test_torch_modality.py``."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JaxModelConfig
from repro.config import get_arch as jax_get_arch
from repro.config import list_archs as jax_list_archs
from repro.config import reduced_variant as jax_reduced_variant
from repro.models import group_pattern as jax_group_pattern
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

ARCHS = ("granite-3-2b", "internlm2-20b", "qwen3-32b", "mixtral-8x7b", "qwen3-moe-235b-a22b", "xlstm-125m",
         "jamba-v0.1-52b", "hubert-xlarge", "phi-3-vision-4.2b")
NO_ATTENTION = ("xlstm-125m",)  # no GQA group to vary, no KV to page
# frames or a prefix in, not tokens alone (tests/test_torch_modality.py)
MODALITY = ("hubert-xlarge", "phi-3-vision-4.2b")
# JAX fields the port's config leaves out on purpose: scan_layers bounds the
# size of a compiled XLA program, and the eager port has no such program
NOT_YET = ("scan_layers",)
# (head_dim, GQA group) of each arch
HEADS = {"granite-3-2b": (64, 4), "internlm2-20b": (128, 6), "qwen3-32b": (128, 8), "mixtral-8x7b": (128, 4),
         "qwen3-moe-235b-a22b": (128, 16), "xlstm-125m": (192, 1), "jamba-v0.1-52b": (128, 4),
         "hubert-xlarge": (80, 1), "phi-3-vision-4.2b": (96, 1)}
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


def test_every_jax_arch_is_ported():
    assert NOT_PORTED == ()
    for arch in jax_list_archs():
        assert get_arch(arch).name == jax_get_arch(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


def _variants(arch):
    """The reduced variant and the reduced variant with the arch's GQA
    group, each as (jax cfg, port cfg), f32."""
    jred = jax_reduced_variant(jax_get_arch(arch)).replace(dtype="float32", param_dtype="float32")
    red = reduced_variant(get_arch(arch)).replace(dtype="float32", param_dtype="float32")
    g = get_arch(arch).num_heads // get_arch(arch).num_kv_heads
    group = dict(num_heads=2 * g, num_kv_heads=2, head_dim=16)
    return {"reduced": (jred, red), "grouped": (jred.replace(**group), red.replace(**group))}


@pytest.fixture(scope="module", params=[(a, v) for a in ARCHS for v in ("reduced", "grouped")
                                        if a not in MODALITY and (a not in NO_ATTENTION or v == "reduced")],
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


RECURRENT = ("xlstm-125m", "jamba-v0.1-52b")


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(want).max() > 0.1  # logits of size about 1, not vanishing
    scale = max(1.0, np.abs(want).max()) if name.startswith(RECURRENT) else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def test_lm_forward_matches_jax(model):
    jcfg, cfg, jparams, params = model
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    want, _ = jax_lm_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        got, _ = lm_forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    _close(got, want, cfg.name)


def test_prefill_and_decode_match_jax(model):
    """Prefill at per-row last indices, then four decode steps fed fixed
    tokens on the dense layout and, from the same prefill's KV laid out in
    pages, on the paged one."""
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    jstate = jax_init_lm_state(jcfg, B, MAX_SEQ)
    # compiled once a layout: the reference's programs, as its engine runs them
    jdecode = jax.jit(lambda p, t, st, pos, table=None: jax_lm_decode(p, jcfg, t, st, pos, page_table=table))
    want, jstate = jax_lm_prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, jstate,
                                  last_index=jnp.asarray(LENS - 1))
    with torch.inference_mode():
        state = init_lm_state(cfg, B, MAX_SEQ)
        got, state = lm_prefill(params, cfg, {"tokens": torch.from_numpy(tokens)}, state,
                                last_index=torch.from_numpy(LENS - 1))
        _close(got, want, cfg.name)
        width = MAX_SEQ // PS
        n_pages = B * width + 1
        table = np.random.default_rng(5).permutation(n_pages - 1)[: B * width].reshape(B, width).astype(np.int32)

        def pages_of(dense):  # (L, B, MAX_SEQ, KH, hd) -> (L, n_pages, PS, KH, hd)
            paged = np.zeros((dense.shape[0], n_pages, PS) + dense.shape[3:], np.float32)
            for r in range(B):
                for j in range(MAX_SEQ):
                    paged[:, table[r, j // PS], j % PS] = dense[:, r, j]
            return paged

        # the same prefill's state laid out in pages: the attention KV in
        # pages, each recurrent carry per slot as it is
        attn = [f"p{i}" for i, (m, _) in enumerate(jax_group_pattern(jcfg)) if m == "attn"]
        assert len(attn) <= 1  # one attention layer a group: the port's stack is JAX's group axis
        jpaged = {p: ({f"{n}_pages": jnp.asarray(pages_of(np.asarray(jstate[p][n]))) for n in ("k", "v")}
                      if p in attn else jstate[p]) for p in jstate}
        paged = {n: t.clone() for n, t in state.items() if n not in ("k", "v")}
        if attn:
            paged.update({f"{n}_pages": torch.from_numpy(pages_of(state[n].numpy())) for n in ("k", "v")})
        pos = LENS.copy()
        for t in range(STEPS):
            tok = feed[t]
            want_d, jstate = jdecode(jparams, jnp.asarray(tok), jstate, jnp.asarray(pos))
            got_d, state = lm_decode(params, cfg, torch.from_numpy(tok), state, torch.from_numpy(pos))
            _close(got_d, want_d, cfg.name)
            if attn:
                want_p, jpaged = jdecode(jparams, jnp.asarray(tok), jpaged, jnp.asarray(pos), jnp.asarray(table))
                got_p, paged = lm_decode(params, cfg, torch.from_numpy(tok), paged, torch.from_numpy(pos),
                                         page_table=torch.from_numpy(table))
                _close(got_p, want_p, cfg.name)
            pos = pos + 1
