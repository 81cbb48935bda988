"""The port's MoE (``repro_torch.models.moe``) and ``remat`` against the
JAX package on the CPU (qk-norm is held to JAX through the qwen3 configs in
``tests/test_torch_configs.py``).

* ``moe_apply_einsum``, ``moe_apply_scatter`` and the dense oracle
  ``moe_ref`` against JAX's, in f32 with the same weights and inputs, at
  (E, k) in {(4,1), (4,2), (8,2), (16,4)}, each with one dispatch group a
  sequence and with groups of 8 tokens, and at a tight capacity (factor
  0.5, where slots drop): outputs within 1e-5 absolute (values of size
  about 1), the router loss within 1e-6 relative. The same with the
  gradients of x and every parameter, against ``jax.grad``, within 1e-5
  absolute. One bf16 case of each dispatch within 2^-7 of JAX's largest
  |y|. A group that does not divide the batch's tokens raises, and so does
  an unknown ``moe_impl``.
* ``lm_loss`` (CE + router_aux_coef · aux) and its gradients on a reduced
  mixtral-8x7b and a reduced qwen3-moe-235b-a22b, with the port's
  ``remat`` on and off, against JAX with ``remat=True, scan_layers=True``:
  the loss within 1e-6 relative, each gradient within 1e-5 of its leaf's
  largest; ``remat`` changes no bit of the port's loss or gradients.
* ``coboost_distill_loss`` with a reduced MoE server against JAX's, both
  branches (whole logits and ``kl_chunk``), the router loss included:
  within 1e-6 relative, 1e-5 for the chunked branch (its client features
  are rounded to bf16, on both sides).
* The continuous engine (paged, 3 slots) on a reduced qwen3-moe and on a
  reduced mixtral at its own capacity factor 1.25, against the JAX engine
  on one small ragged stream: tokens equal, ``stats`` equal key for key.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JaxModelConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.core.distributed import coboost_distill_loss as jax_distill_loss
from repro.models import init_lm as jax_init_lm
from repro.models import lm_loss as jax_lm_loss
from repro.models import moe as jax_moe
from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ManualClock as JaxManualClock
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.config.model import ModelConfig, reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.core.distributed import coboost_distill_loss
from repro_torch.models import moe
from repro_torch.models.transformer import lm_loss
from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine
from repro_torch.utils.trees import flatten_dict, value_and_grad

pytestmark = pytest.mark.tier1

B, S, D, F = 2, 16, 32, 48
TOL, AUX_RTOL = 1e-5, 1e-6
IMPLS = ("einsum", "scatter", "ref")
# the tight cases: factor 0.5 at 4 experts, one group a sequence and one group
# for the whole batch (groups of 8 cannot overflow the least capacity, 8)
CASES = [(e, k, g, 1.25) for e, k in ((4, 1), (4, 2), (8, 2), (16, 4)) for g in (0, 8)] + [(4, 2, 0, 0.5), (4, 2, 32, 0.5)]


def _cfgs(e, k, group, factor, dtype="float32"):
    kw = dict(name="moe-test", family="moe", d_model=D, d_ff=F, num_experts=e, experts_per_token=k,
              moe_group_size=group, moe_capacity_factor=factor, dtype=dtype, param_dtype="float32")
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _inputs(e, seed=0):
    """Weights and x from a numpy seed; the router at unit scale (logits of
    std about 6), so that the top-k choices are decided by wide gaps."""
    rng = np.random.default_rng(seed)
    p = {
        "router": rng.standard_normal((D, e)).astype(np.float32),
        "wi": (rng.standard_normal((e, D, F)) / np.sqrt(D)).astype(np.float32),
        "wg": (rng.standard_normal((e, D, F)) / np.sqrt(D)).astype(np.float32),
        "wo": (rng.standard_normal((e, F, D)) / np.sqrt(F)).astype(np.float32),
    }
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return p, x


_JAX_FNS = {n: jax.jit(f, static_argnums=2) for n, f in
            (("einsum", jax_moe.moe_apply_einsum), ("scatter", jax_moe.moe_apply_scatter), ("ref", jax_moe.moe_ref))}


def _jax_fn(impl):
    return _JAX_FNS[impl]


def _port_fn(impl):
    return {"einsum": moe.moe_apply_einsum, "scatter": moe.moe_apply_scatter, "ref": moe.moe_ref}[impl]


def _drops(jcfg, e, x, p):
    """How many token-slots overflow their expert's capacity."""
    xg, _ = jax_moe._group(jnp.asarray(x), jcfg, x.shape[1])
    _, idx, _ = jax_moe._router({"router": jnp.asarray(p["router"])}, xg, jcfg)
    pos = jax_moe._positions_in_expert(idx, jcfg)
    return int(jnp.sum(pos >= jax_moe._capacity(jcfg, xg.shape[1])))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("e,k,group,factor", CASES, ids=lambda v: str(v))
def test_moe_matches_jax(impl, e, k, group, factor):
    jcfg, cfg = _cfgs(e, k, group, factor)
    p, x = _inputs(e)
    if factor < 1:
        assert _drops(jcfg, e, x, p) > 0  # the tight case really drops
    want, want_aux = _jax_fn(impl)({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jcfg)
    got, got_aux = _port_fn(impl)({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x), cfg)
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=AUX_RTOL, atol=0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("e,k,group,factor", [(4, 2, 0, 1.25), (16, 4, 8, 1.25), (4, 2, 32, 0.5)], ids=lambda v: str(v))
def test_moe_grads_match_jax(impl, e, k, group, factor):
    """d/d(x, router, wi, wg, wo) of sum(y · u) + 3 · aux."""
    jcfg, cfg = _cfgs(e, k, group, factor)
    p, x = _inputs(e, seed=1)
    u = np.random.default_rng(2).standard_normal((B, S, D)).astype(np.float32)

    def jloss(args):
        params, xx = args
        y, aux = _jax_fn(impl)(params, xx, jcfg)
        return jnp.sum(y * jnp.asarray(u)) + 3.0 * aux

    jg = jax.grad(jloss)(({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x)))
    want = {**{n: np.asarray(a) for n, a in jg[0].items()}, "x": np.asarray(jg[1])}

    def tloss(args):
        y, aux = _port_fn(impl)(args["p"], args["x"], cfg)
        return torch.sum(y * torch.from_numpy(u)) + 3.0 * aux

    _, tg = value_and_grad(tloss, {"p": {n: torch.from_numpy(a) for n, a in p.items()}, "x": torch.from_numpy(x)})
    got = {**{n: g.numpy() for n, g in tg["p"].items()}, "x": tg["x"].numpy()}
    for name, w in want.items():
        assert np.abs(w).max() > 1e-3, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("impl", ("einsum", "scatter"))
def test_moe_bf16_matches_jax(impl):
    jcfg, cfg = _cfgs(8, 2, 8, 1.25, dtype="bfloat16")
    p, x = _inputs(8, seed=3)
    jp = {n: jnp.asarray(a) if n == "router" else jnp.asarray(a, jnp.bfloat16) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) if n == "router" else torch.from_numpy(a).bfloat16() for n, a in p.items()}
    want, want_aux = _jax_fn(impl)(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    got, got_aux = _port_fn(impl)(tp, torch.from_numpy(x).bfloat16(), cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2.0**-7 * np.abs(want).max())
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=AUX_RTOL, atol=0)


def test_moe_scatter_same_bits_on_a_second_call():
    jcfg, cfg = _cfgs(4, 2, 32, 0.5)
    p, x = _inputs(4, seed=4)
    assert _drops(jcfg, 4, x, p) > 0
    tp, tx = {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x)
    a, b = moe.moe_apply_scatter(tp, tx, cfg)[0], moe.moe_apply_scatter(tp, tx, cfg)[0]
    assert torch.equal(a, b)


def test_moe_group_must_divide_the_tokens():
    _, cfg = _cfgs(4, 2, 12, 1.25)  # 2 x 16 = 32 tokens, groups of 12
    p, x = _inputs(4)
    for fn in (moe.moe_apply_einsum, moe.moe_apply_scatter):
        with pytest.raises(ValueError, match="12 tokens does not divide the 2x16 = 32"):
            fn({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x), cfg)


def test_unknown_moe_impl_raises():
    with pytest.raises(ValueError, match="moe_impl"):
        ModelConfig(name="m", family="moe", num_experts=4, experts_per_token=2, moe_impl="dropless").validate()
    _, cfg = _cfgs(4, 2, 0, 1.25)
    p, x = _inputs(4)
    with pytest.raises(ValueError, match="moe_impl"):
        moe.moe_apply({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
                      cfg.replace(moe_impl="dropless"))
    with pytest.raises(ValueError, match="num_experts"):
        ModelConfig(name="m", family="moe").validate()


# ---------------------------------------------------------------------------
# the LM: lm_loss with the router loss, remat, the distillation loss


def _lm(arch, seed=3):
    """The reduced arch in f32 (JAX with remat and scan on), JAX weights
    carried across, norm scales and qk-norm given values."""
    jcfg = jax_reduced_variant(jax_get_arch(arch)).replace(
        dtype="float32", param_dtype="float32", remat=True, scan_layers=True)
    cfg = reduced_variant(get_arch(arch)).replace(dtype="float32", param_dtype="float32")
    rng = np.random.default_rng(seed)
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32)
        if any(n in jax.tree_util.keystr(p) for n in ("scale", "q_norm", "k_norm")) else np.asarray(x),
        jax_init_lm(jcfg, jax.random.key(seed)),
    )
    return jcfg, cfg, jparams, lm_params_from_jax(cfg, jparams)


def _tokens(cfg, b=2, s=16, seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("arch", ("mixtral-8x7b", "qwen3-moe-235b-a22b"))
def test_lm_loss_with_aux_and_remat_matches_jax(arch):
    jcfg, cfg, jparams, params = _lm(arch)
    batch = _tokens(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, jm), jg = jax.jit(jax.value_and_grad(lambda p: jax_lm_loss(p, jcfg, jbatch), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    assert float(jm["moe_aux"]) > 0.5  # two layers' router losses, each about 1
    want_g = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {}
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        metrics = {}

        def fn(p):
            loss, m = lm_loss(p, c, tbatch)
            metrics.update({k: v.detach() for k, v in m.items()})
            return loss

        loss, grads = value_and_grad(fn, params)
        got_g = flatten_dict(lm_params_to_jax(c, grads))
        runs[remat] = (loss, got_g)
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-6, atol=0)
        np.testing.assert_allclose(float(metrics["moe_aux"]), float(jm["moe_aux"]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]), rtol=1e-6, atol=0)
        assert set(got_g) == set(want_g)
        for path, w in want_g.items():
            np.testing.assert_allclose(got_g[path], w, rtol=0, atol=TOL * max(np.abs(w).max(), 1e-30), err_msg=path)
    assert torch.equal(runs[True][0], runs[False][0])
    for path, g in runs[True][1].items():
        np.testing.assert_array_equal(g, runs[False][1][path], err_msg=path)


@pytest.mark.parametrize("kl_chunk", (0, 8))
def test_distill_loss_with_moe_server_matches_jax(kl_chunk):
    jcfg, cfg, jserver, server = _lm("qwen3-moe-235b-a22b")
    clients = [_lm("qwen3-moe-235b-a22b", seed=10 + i) for i in range(2)]
    jstacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[c[2] for c in clients])
    w = np.array([0.3, 0.7], np.float32)
    tokens = _tokens(cfg)["tokens"]
    want = jax_distill_loss(jax.tree_util.tree_map(jnp.asarray, jserver), jstacked, jnp.asarray(w), jcfg,
                            {"tokens": jnp.asarray(tokens)}, 4.0, kl_chunk)
    args = ([c[3] for c in clients], torch.from_numpy(w))
    with torch.no_grad():
        got = coboost_distill_loss(server, *args, cfg, {"tokens": torch.from_numpy(tokens)}, 4.0, kl_chunk)
        no_aux = coboost_distill_loss(server, *args, cfg.replace(router_aux_coef=0.0),
                                      {"tokens": torch.from_numpy(tokens)}, 4.0, kl_chunk)
    # the chunked branch keeps the client features in bf16, where a rounding
    # step can fall either side of a 1e-7 gap in f32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6 if kl_chunk == 0 else 1e-5, atol=0)
    assert float(got - no_aux) > 100 * 1e-6 * float(got)  # the router loss counts


# ---------------------------------------------------------------------------
# the continuous engine against the JAX engine

GEN = 6
ENGINE = dict(max_slots=3, max_seq=32, max_new=GEN, decode_chunk=3, page_size=8, prefill_bucket=8)


@pytest.mark.parametrize("arch", ("qwen3-moe-235b-a22b", "mixtral-8x7b"))
def test_moe_engine_matches_jax_engine(arch, monkeypatch):
    """Reduced arch in f32, its own capacity factor (1.25), head x10 for
    wide margins; 5 ragged prompts of 5-20 tokens. Some prefill dispatches
    drop slots (pad tokens of the bucket take capacity too), as the
    reference's do."""
    dropped = []
    positions = moe._positions_in_expert

    def counted(idx, c):
        pos = positions(idx, c)
        dropped.append(int((pos >= moe._capacity(c, idx.shape[1])).sum()))
        return pos

    monkeypatch.setattr(moe, "_positions_in_expert", counted)
    jcfg, cfg, jparams, _ = _lm(arch, seed=7)
    jcfg = jcfg.replace(attn_backend="ref", decode_backend="ref", remat=False, scan_layers=False)
    jparams["lm_head"]["kernel"] = jparams["lm_head"]["kernel"] * np.float32(10.0)
    params = lm_params_from_jax(cfg, jparams)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 20, 11, 14, 8)]
    jeng = JaxServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), JaxEngineConfig(**ENGINE))
    jcomps = JaxScheduler(jeng, clock=JaxManualClock()).run(
        [JaxRequest(rid=i, tokens=p, max_new_tokens=GEN) for i, p in enumerate(prompts)])
    eng = ServeEngine(cfg, params, EngineConfig(**ENGINE))
    comps = ContinuousScheduler(eng, clock=ManualClock()).run(
        [Request(rid=i, tokens=p, max_new_tokens=GEN) for i, p in enumerate(prompts)])
    assert [c.rid for c in comps] == [c.rid for c in jcomps]
    for got, want in zip(comps, jcomps):
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert dict(eng.stats) == {k: int(v) for k, v in dict(jeng.stats).items()}
    assert sum(dropped) > 0


def test_lm_params_round_trip_moe_and_qk_norm():
    """qwen3-moe's tree (moe/{router,wi,wg,wo}, attn/{q_norm,k_norm}) crosses
    both ways bitwise; a tree without the router is refused."""
    _, cfg, jparams, params = _lm("qwen3-moe-235b-a22b")
    layer = params["layers"][0]
    assert set(layer["moe"]) == {"router", "wi", "wg", "wo"} and {"q_norm", "k_norm"} <= set(layer["attn"])
    assert layer["moe"]["wi"].shape == (cfg.num_experts, cfg.d_model, cfg.expert_d_ff)
    back, want = flatten_dict(lm_params_to_jax(cfg, params)), flatten_dict(jparams)
    assert set(back) == set(want)
    for path, a in want.items():
        assert back[path].dtype == a.dtype and np.array_equal(back[path], a), path
    bad = jax.tree_util.tree_map(lambda x: x, jparams)
    del bad["groups"]["p0"]["moe"]["router"]
    with pytest.raises(ValueError, match="layer 0"):
        lm_params_from_jax(cfg, bad)


def test_cast_weights_keeps_norms_and_router():
    """Serving weights in bf16: the projections and experts cast, the norm
    scales (qk-norm's too) and the f32 router kept."""
    from repro_torch.models.transformer import cast_weights

    _, cfg, _, params = _lm("qwen3-moe-235b-a22b")
    layer = cast_weights(params, cfg.replace(dtype="bfloat16"))["layers"][1]
    assert {n: w.dtype for n, w in layer["moe"].items()} == {
        "router": torch.float32, "wi": torch.bfloat16, "wg": torch.bfloat16, "wo": torch.bfloat16}
    assert layer["attn"]["q_norm"].dtype == layer["attn"]["k_norm"].dtype == torch.float32
    assert layer["attn"]["wq"].dtype == torch.bfloat16 and layer["norm2"]["scale"].dtype == torch.float32
