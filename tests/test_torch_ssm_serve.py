"""The port's serving of the recurrent families against the JAX package on
the CPU (the model-level parity is in ``tests/test_torch_ssm.py``, whose
helpers this file shares), on the reduced xlstm-125m and jamba-v0.1-52b in
f32:

* The continuous engine against the JAX engine on a ragged stream of 5
  prompts on 3 slots (a slot reused after eviction): xlstm-125m on the
  dense layout it falls back to, jamba-v0.1-52b on the paged one. Tokens
  equal and ``stats`` equal key for key, prefill dispatches included (a
  recurrent arch prefills at its exact prompt length); the engine against
  ``static_generate``. A jamba engine with ``prefill_device`` set gives the
  colocated engine's tokens and stats, and adoption rewrites every
  recurrent row of a reused slot.
* The refusals: the prefix cache and speculative decoding on both archs
  (engine and launcher, with the engine's reason), a recurrent drafter,
  a disaggregated pure-SSM engine; the launchers' CPU runs; a
  ``convert.py`` round trip for both archs, bitwise; ``cast_weights``
  keeping the f32 leaves the model uses without a cast.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import ContinuousScheduler as JaxScheduler
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ManualClock as JaxManualClock
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.config.registry import get_arch
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.models.transformer import cast_weights, group_period, layer_kinds
from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine, static_generate
from repro_torch.utils.trees import flatten_dict

from test_torch_ssm import ARCHS, _lm, few_threads  # noqa: F401  (few_threads: a module fixture)

pytestmark = pytest.mark.tier1


# ---------------------------------------------------------------------------
# the engine

GEN = 6
ENGINE = dict(max_slots=3, max_seq=32, max_new=GEN, decode_chunk=3, page_size=8, prefill_bucket=8)
LENS = (5, 20, 11, 20, 5)


def _stream(cfg):
    rng = np.random.RandomState(3)
    return [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The reduced arch with the head x10 (wide top-2 margins), and the JAX
    engine's completions and stats on the ragged stream."""
    arch = request.param
    jcfg, cfg, jparams, params = _lm(arch, seed=7, head=10.0)
    jcfg = jcfg.replace(attn_backend="ref", decode_backend="ref", remat=False, scan_layers=False)
    prompts = _stream(cfg)
    jeng = JaxServeEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), JaxEngineConfig(**ENGINE))
    jcomps = JaxScheduler(jeng, clock=JaxManualClock()).run(
        [JaxRequest(rid=i, tokens=p, max_new_tokens=GEN) for i, p in enumerate(prompts)])
    want = ({c.rid: np.asarray(c.tokens).tolist() for c in jcomps}, {k: int(v) for k, v in dict(jeng.stats).items()})
    return arch, cfg, params, prompts, want, jeng.layout


def _run(cfg, params, prompts, **kw):
    eng = ServeEngine(cfg, params, EngineConfig(**ENGINE), **kw)
    comps = ContinuousScheduler(eng, clock=ManualClock()).run(
        [Request(rid=i, tokens=p, max_new_tokens=GEN) for i, p in enumerate(prompts)])
    return eng, ({c.rid: c.tokens.tolist() for c in comps}, dict(eng.stats))


def test_engine_matches_jax_engine(served):
    """xlstm on the dense layout it falls back to (paged requested), jamba
    on the paged one; one prefill dispatch for each distinct prompt length
    of a burst (no bucketing)."""
    arch, cfg, params, prompts, want, jlayout = served
    eng, got = _run(cfg, params, prompts)
    assert eng.layout == jlayout == ("dense" if arch == "xlstm-125m" else "paged")
    assert got == want
    assert got[1]["prefill_tokens"] == sum(LENS) and got[1]["evicted"] == len(LENS)
    assert (eng.pool is None) == (arch == "xlstm-125m")


def test_engine_matches_static_generator(served):
    """The engine's tokens equal the static generator's for the prompts of
    one length (the static path prefills them together, then decodes
    against the dense state)."""
    _, cfg, params, prompts, want, _ = served
    rids = [i for i, n in enumerate(LENS) if n == 20]
    out = static_generate(params, cfg, {"tokens": torch.from_numpy(np.stack([prompts[i] for i in rids]))}, GEN)
    assert out.tolist() == [want[0][i] for i in rids]


def test_jamba_pair_with_prefill_device_matches_one_engine():
    """``prefill_device`` naming the parameters' device: the recurrent rows
    travel in the handoff beside the sealed pages, tokens and stats equal
    the colocated engine's."""
    _, cfg, _, params = _lm("jamba-v0.1-52b", seed=7, head=10.0)
    prompts = _stream(cfg)
    _, one = _run(cfg, params, prompts)
    pair, got = _run(cfg, params, prompts, prefill_device="cpu")
    assert pair.layout == "paged" and got == one and got[1]["handoffs"] == got[1]["prefill_dispatches"] > 0


def test_adopt_overwrites_every_recurrent_row():
    """A reused slot's carries are rewritten at adoption, on both layouts:
    a burst adopted onto evicted slots, whose carries kept stepping in the
    decode chunks, holds the same rows as the same burst adopted by a
    fresh engine."""
    for arch in ARCHS:
        _, cfg, _, params = _lm(arch, seed=7)
        first, second = _stream(cfg)[:2]
        eng = ServeEngine(cfg, params, EngineConfig(**ENGINE))
        slots = eng.admit_many([(first, GEN)] * 2)
        active = [True]
        while any(active):
            eng.decode_chunk()
            active, n_out = eng.sync()
        for slot in slots:
            eng.fetch(slot, int(n_out[slot]))
        reused = eng.admit_many([(second, GEN)] * 2)
        fresh = ServeEngine(cfg, params, EngineConfig(**ENGINE))
        into = fresh.admit_many([(second, GEN)] * 2)
        assert sorted(reused) == sorted(slots)
        names = [n for n in eng._state.kv if "." in n]
        assert names and all(torch.equal(eng._state.kv[n][:, reused], fresh._state.kv[n][:, into]) for n in names)


# ---------------------------------------------------------------------------
# refusals, the launchers, conversion


def test_recurrent_archs_refuse_prefix_cache_and_spec_decode():
    from repro_torch.launch.serve import build_parser, validate_args

    parser = build_parser()
    for arch in ARCHS:
        _, cfg, _, params = _lm(arch)
        drafter = (cfg, params)
        for knobs, match in ((dict(prefix_cache=True), "prefix_cache"), (dict(spec_k=2), "spec_decode")):
            with pytest.raises(ValueError, match=match):
                ServeEngine(cfg, params, EngineConfig(**{**ENGINE, **knobs}),
                            drafter=drafter if "spec_k" in knobs else None)
        for argv, match in ((["--prefix-cache"], "prefix_cache"), (["--spec-decode"], "spec_decode")):
            with pytest.raises(SystemExit, match=match):
                validate_args(parser.parse_args(["--arch", arch, "--reduced"] + argv), cfg)
        validate_args(parser.parse_args(["--arch", arch, "--reduced"]), cfg)
    dec = get_arch("smollm-135m")
    with pytest.raises(SystemExit, match="recurrent carry"):
        validate_args(parser.parse_args(["--spec-decode", "--drafter", "xlstm-125m"]), dec)
    _, xcfg, _, xparams = _lm("xlstm-125m")
    with pytest.raises(ValueError, match="no attention layers"):
        ServeEngine(xcfg, xparams, EngineConfig(**ENGINE), prefill_device="cpu")


def test_serve_and_train_launchers_on_recurrent_archs():
    from repro_torch.launch import serve, train

    for arch in ARCHS:
        result = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3", "--max-slots", "2",
                             "--prompt-len", "12", "--gen", "4"])
        assert len(result["completions"]) == 3 and all(len(c.tokens) == 4 for c in result["completions"])
    result = train.main(["--arch", "xlstm-125m", "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "32", "--log-every", "1"])
    assert len(result["losses"]) == 3 and all(np.isfinite(result["losses"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip(arch):
    """Both trees cross both ways bitwise; layer i has the leaves of its
    kind (an xLSTM block no mlp and no norm2); a tree missing a leaf is
    refused at its layer."""
    _, cfg, jparams, params = _lm(arch)
    kinds = layer_kinds(cfg)
    for layer, (mixer, ffn) in zip(params["layers"], kinds):
        assert ("norm2" in layer) == (ffn is not None) and (ffn is None or ffn in layer)
    back, want = flatten_dict(lm_params_to_jax(cfg, params)), flatten_dict(jparams)
    assert set(back) == set(want)
    for path, a in want.items():
        assert back[path].dtype == a.dtype and np.array_equal(back[path], a), path
    last = group_period(cfg) - 1
    bad = jax.tree_util.tree_map(lambda x: x, jparams)
    mixer_key = next(k for k in bad["groups"][f"p{last}"] if k not in ("norm1", "norm2", "mlp", "moe"))
    del bad["groups"][f"p{last}"][mixer_key][next(iter(bad["groups"][f"p{last}"][mixer_key]))]
    with pytest.raises(ValueError, match=f"layer {last}"):
        lm_params_from_jax(cfg, bad)


def test_cast_weights_keeps_the_f32_leaves():
    """Serving weights in bf16: the projections and the conv cast; the
    xLSTM gates and recurrence, Mamba's dt bias, A and D, the norms and
    the router kept."""
    for arch, kept in (("xlstm-125m", {"gates", "r"}), ("jamba-v0.1-52b", {"dt_bias", "A_log", "D", "router"})):
        _, cfg, _, params = _lm(arch)
        cast = cast_weights(params, cfg.replace(dtype="bfloat16"))
        seen = set()
        for layer in cast["layers"]:
            for path, w in flatten_dict(layer).items():
                leaf = path.split("/")[-1]
                want = torch.float32 if leaf in kept or leaf == "scale" else torch.bfloat16
                assert w.dtype == want, path
                seen.add(leaf)
        assert kept <= seen
