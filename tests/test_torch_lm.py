"""The port's LM (``repro_torch.models``) against the JAX package on the
CPU: reduced smollm-135m in f32, JAX ``init_lm`` weights carried across
with ``repro_torch.convert``, the JAX side on ``backend="ref"``. Prefill
logits at a per-row last index, six decode steps on the dense and the paged
layouts (and a sliding-window ring), and the full-sequence forward, within
``|Δ| <= 1e-4·(1 + |ref|)``. Also the parameter round trip, bitwise."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.data.synthetic import make_token_stream as jax_make_token_stream
from repro.models import init_lm as jax_init_lm
from repro.models import init_lm_state as jax_init_lm_state
from repro.models import lm_decode as jax_lm_decode
from repro.models import lm_forward as jax_lm_forward
from repro.models import lm_prefill as jax_lm_prefill
from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.data.synthetic import make_token_stream
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.transformer import cast_weights, init_lm, init_lm_state, lm_decode, lm_forward, lm_prefill
from repro_torch.utils.trees import flatten_dict

pytestmark = pytest.mark.tier1

B, PROMPT, MAX_SEQ, PS, STEPS = 2, 20, 32, 8, 6
LENS = np.array([20, 12], np.int32)  # row 1 is padded past its prompt


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want) - 1e-4 * (1 + np.abs(want))
    assert err.max() <= 0, f"max excess {err.max():.3e}, max abs diff {np.abs(got - want).max():.3e}"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_norms(tree, rng):
    """Norm scales init at zero; give them values so ``1 + scale`` counts."""
    def f(path, x):
        name = jax.tree_util.keystr(path)
        return (rng.standard_normal(x.shape) * 0.3).astype(np.float32) if "scale" in name else x
    return jax.tree_util.tree_map_with_path(f, tree)


def _configs(window=0):
    jcfg = jax_reduced_variant(jax_get_arch("smollm-135m")).replace(
        dtype="float32", param_dtype="float32", attn_backend="ref", decode_backend="ref", sliding_window=window
    )
    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32", sliding_window=window)
    return jcfg, cfg


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs()
    jparams = _perturb_norms(_np_tree(jax_init_lm(jcfg, jax.random.key(0))), np.random.default_rng(0))
    return jcfg, cfg, jparams, lm_params_from_jax(cfg, jparams)


def test_config_and_tokens_match_jax():
    jcfg, cfg = _configs()
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "norm_eps", "tie_embeddings", "rope_theta", "name"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    full, jfull = get_arch("smollm-135m"), jax_get_arch("smollm-135m")
    assert (full.dtype, full.param_dtype, full.num_layers, full.d_model) == (jfull.dtype, jfull.param_dtype, 30, 576)
    for k, v in jax_make_token_stream(3, 512, 4, 17).items():
        np.testing.assert_array_equal(make_token_stream(3, 512, 4, 17)[k], v)
    assert get_arch("hubert-xlarge").family == "audio"  # every arch of the reference is ported
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("option,error,match", [
    (dict(act="relu"), ValueError, "act"),
    (dict(family="ssm"), ValueError, "ssm_kind"),
    (dict(family="audio", frontend="audio"), ValueError, "num_prefix_tokens"),
    (dict(family="hybrid"), ValueError, "attn_every"),
    (dict(family="diffusion"), NotImplementedError, "not ported yet"),
], ids=["gelu", "ssm", "audio", "hybrid", "unknown-family"])
def test_unported_dense_options_refuse(option, error, match):
    """An activation or a family that no config of the reference has is
    refused, never ignored; so is an SSM or hybrid family without its
    recurrent fields, and a frontend without its prefix tokens (the
    reference's assertion)."""
    _, cfg = _configs()
    with pytest.raises(error, match=match):
        init_lm(cfg.replace(**option), torch.Generator().manual_seed(0))


def test_lm_params_round_trip(model):
    jcfg, cfg, jparams, params = model
    back = lm_params_to_jax(cfg, params)
    want, got = flatten_dict(jparams), flatten_dict(back)
    assert set(got) == set(want)
    for path in want:
        assert got[path].dtype == want[path].dtype and np.array_equal(got[path], want[path]), path
    assert len(params["layers"]) == cfg.num_layers
    bad = dict(jparams, extra={"w": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="top-level leaves"):
        lm_params_from_jax(cfg, bad)


def test_layers_match_jax():
    from repro.models.layers import apply_rope as jax_apply_rope
    from repro.models.layers import rms_norm as jax_rms_norm

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(scale)), jax_rms_norm(x, scale))
    _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0), jax_apply_rope(x, pos, 10000.0))


def test_lm_forward_matches_jax(model):
    jcfg, cfg, jparams, params = model
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    want, _ = jax_lm_forward(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    got, _ = lm_forward(params, cfg, {"tokens": torch.from_numpy(tokens)})
    _close(got, want)


def _to_pages(dense, table, n_pages):
    """Dense per-slot caches (G, B, cl, KH, hd) laid out into pages
    (G, n_pages, PS, KH, hd) through ``table``."""
    g, b, cl, kh, hd = dense.shape
    pages = np.zeros((g, n_pages, PS, kh, hd), np.float32)
    for r in range(b):
        for j in range(cl):
            pages[:, table[r, j // PS], j % PS] = dense[:, r, j]
    return pages


@pytest.mark.parametrize("window", [0, 16], ids=["full", "ring"])
def test_prefill_and_decode_match_jax(model, window):
    """Prefill at per-row last indices, then six decode steps at per-row
    positions, fed fixed tokens, on both layouts. With window 16 the
    20-token prompt overruns the ring (cache_len 16), so prefill places
    the tail on ring slots and decode wraps."""
    jcfg, cfg, jparams, params = model
    jcfg, cfg = jcfg.replace(sliding_window=window), cfg.replace(sliding_window=window)
    rng = np.random.default_rng(3 + window)
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)

    jstate = jax_init_lm_state(jcfg, B, MAX_SEQ)
    want, jstate = jax_lm_prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, jstate, last_index=jnp.asarray(LENS - 1))
    state = init_lm_state(cfg, B, MAX_SEQ)
    got, state = lm_prefill(params, cfg, {"tokens": torch.from_numpy(tokens)}, state, last_index=torch.from_numpy(LENS - 1))
    _close(got, want)
    dense = {n: np.asarray(jstate["p0"][n]) for n in ("k", "v")}
    np.testing.assert_allclose(state["k"].numpy(), dense["k"], rtol=1e-5, atol=1e-5)

    cl = dense["k"].shape[2]
    width = -(-cl // PS)
    n_pages = B * width + 1
    table = np.random.default_rng(5).permutation(n_pages - 1)[: B * width].reshape(B, width).astype(np.int32)
    jpaged = {"p0": {f"{n}_pages": jnp.asarray(_to_pages(dense[n], table, n_pages)) for n in ("k", "v")}}
    paged = {f"{n}_pages": torch.from_numpy(_to_pages(dense[n], table, n_pages)) for n in ("k", "v")}
    jdense = jstate

    pos = LENS.copy()
    for t in range(STEPS):
        tok = feed[t]
        want_d, jdense = jax_lm_decode(jparams, jcfg, jnp.asarray(tok), jdense, jnp.asarray(pos))
        want_p, jpaged = jax_lm_decode(jparams, jcfg, jnp.asarray(tok), jpaged, jnp.asarray(pos), page_table=jnp.asarray(table))
        got_d, state = lm_decode(params, cfg, torch.from_numpy(tok), state, torch.from_numpy(pos))
        got_p, paged = lm_decode(params, cfg, torch.from_numpy(tok), paged, torch.from_numpy(pos), page_table=torch.from_numpy(table))
        _close(got_d, want_d)
        _close(got_p, want_p)
        pos = pos + 1


def test_cast_weights_keeps_bf16_logits(model):
    """Weights cast to the activation dtype ahead of time give the same bf16
    logits as casting them at every use."""
    _, cfg, _, params = model
    cfg = cfg.replace(dtype="bfloat16")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32))
    want, st_want = lm_prefill(params, cfg, {"tokens": tokens}, init_lm_state(cfg, B, MAX_SEQ))
    cast = cast_weights(params, cfg)
    got, st_got = lm_prefill(cast, cfg, {"tokens": tokens}, init_lm_state(cfg, B, MAX_SEQ))
    assert cast["layers"][0]["mlp"]["wi"].dtype == torch.bfloat16 and cast["final_norm"]["scale"].dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(st_got["k"], st_want["k"])
    step = torch.from_numpy(LENS)
    tok = tokens[:, :1]
    assert torch.equal(lm_decode(cast, cfg, tok, st_got, step)[0], lm_decode(params, cfg, tok, st_want, step)[0])
