"""The audio-encoder and VLM families in the port against the JAX package
on the CPU: hubert-xlarge (encoder-only: frame features in, a 504-way
codebook head out, non-causal attention, the tanh-GELU MLP) and
phi-3-vision-4.2b (a decoder fed a projected prefix of patch embeddings
before its tokens).

Configs: each arch's reduced variant (2 layers, d_model 128, 4 heads at hd
32; phi with 16 prefix tokens of 1024 dims) and a variant at the arch's own
head dim (hubert at hd 80 with 2 heads; phi at hd 96 with 2 heads, d_model
192, 8 prefix tokens), in f32, JAX ``init_lm`` weights carried across with
``repro_torch.convert`` (norm scales given values), inputs made from a seed
with numpy. The JAX side runs ``backend="auto"``, its plain path on the CPU.

* ``lm_forward`` logits and ``lm_loss`` within 1e-5 absolute of JAX's; the
  gradient of every parameter within 1e-5 of its leaf's largest, through
  the attention op's kernel wrappers (their plain versions on the CPU) and
  through plain autograd.
* phi: prefill with the prefix, then four dense decode steps at positions
  from prompt + P, logits within 1e-5; ``static_generate``'s greedy tokens
  equal the JAX ``static_generate``'s.
* ``gelu_mlp`` is the tanh form within 1e-6 of the reference's; the erf
  form misses that bar.
* The engine's and the launchers' refusals (encoder-only; a VLM on the
  continuous engine; ``launch.train`` on the audio family) raise as the
  reference's do; a VLM's static launcher and ``launch.train`` run.
* Conversion is the identity both ways; ``param_count`` equals the
  reference's for every arch.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.config import get_arch as jax_get_arch
from repro.config import list_archs as jax_list_archs
from repro.config import reduced_variant as jax_reduced_variant
from repro.launch.serve import build_parser as jax_build_parser
from repro.launch.serve import validate_args as jax_validate_args
from repro.models import init_lm as jax_init_lm
from repro.models import init_lm_state as jax_init_lm_state
from repro.models import lm_decode as jax_lm_decode
from repro.models import lm_forward as jax_lm_forward
from repro.models import lm_loss as jax_lm_loss
from repro.models import lm_prefill as jax_lm_prefill
from repro.models.layers import gelu_mlp as jax_gelu_mlp
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.static import static_generate as jax_static_generate
from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.launch import serve, train
from repro_torch.models.layers import apply_mlp, gelu_mlp, init_mlp
from repro_torch.models.transformer import init_lm, init_lm_state, lm_decode, lm_forward, lm_loss, lm_prefill
from repro_torch.serve import EngineConfig, ServeEngine, static_generate
from repro_torch.utils.trees import flatten_dict, value_and_grad

pytestmark = pytest.mark.tier1


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs (the suite runs several
    workers on one host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


HUBERT, PHI = "hubert-xlarge", "phi-3-vision-4.2b"
# each arch's reduced variant, and one at the arch's own head dim
OWN_HEAD_DIM = {HUBERT: dict(num_heads=2, num_kv_heads=2, head_dim=80),
                PHI: dict(num_heads=2, num_kv_heads=2, head_dim=96, d_model=192, num_prefix_tokens=8)}
VARIANTS = [(a, v) for a in (HUBERT, PHI) for v in ("reduced", "own-hd")]
B, S, STEPS = 2, 12, 4
TOL = 1e-5


def _configs(arch, variant):
    f32 = dict(dtype="float32", param_dtype="float32")
    jcfg = jax_reduced_variant(jax_get_arch(arch)).replace(**f32)
    cfg = reduced_variant(get_arch(arch)).replace(**f32)
    if variant == "own-hd":
        jcfg, cfg = jcfg.replace(**OWN_HEAD_DIM[arch]), cfg.replace(**OWN_HEAD_DIM[arch])
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _model(arch, variant):
    """(jax cfg, port cfg, JAX params as numpy, port params), once a variant."""
    jcfg, cfg = _configs(arch, variant)
    jparams = jax.tree_util.tree_map(np.asarray, jax_init_lm(jcfg, jax.random.key(3)))
    rng = np.random.default_rng(0)  # norm scales start at zero: give them values so that they count
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32) if "scale" in jax.tree_util.keystr(p) else x,
        jparams,
    )
    return jcfg, cfg, jparams, lm_params_from_jax(cfg, jparams)


@pytest.fixture(scope="module", params=VARIANTS, ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    return _model(*request.param)


@pytest.fixture(scope="module")
def jax_loss_and_grads(model):
    """The reference's loss and gradients on ``_batch(cfg, seed=2)``, once
    a model (compiled: the eager reference is slow)."""
    jcfg, cfg, jparams, _ = model
    jb, _ = _both(_batch(cfg, seed=2))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_lm_loss(p, jcfg, jb)[0]))(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    return float(loss), _leaves(lm_params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, grads)))


def _leaves(params):
    """Every tensor of a port param tree by path, the layers' too."""
    out = {f"layers/{i}/{p}": t for i, layer in enumerate(params["layers"]) for p, t in flatten_dict(layer).items()}
    out.update(flatten_dict({k: v for k, v in params.items() if k != "layers"}))
    return out


def _batch(cfg, seed=1, prefix_scale=1.0):
    """numpy inputs: frames and labels for the encoder; tokens, a prefix
    and text labels for the VLM."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.is_encoder_only:
        return {"frames": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32), "labels": labels}
    prefix = rng.standard_normal((B, cfg.num_prefix_tokens, cfg.frontend_dim)) * prefix_scale
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "prefix": prefix.astype(np.float32), "labels": labels}


def _both(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}, {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(want).max() > 0.1  # values of size about 1, not vanishing
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_lm_forward_matches_jax(model):
    jcfg, cfg, jparams, params = model
    jb, tb = _both(_batch(cfg))
    want, _ = jax.jit(lambda p, b: jax_lm_forward(p, jcfg, b))(jparams, jb)
    with torch.inference_mode():
        got, _ = lm_forward(params, cfg, tb)
    # the VLM's logits cover the prefix positions too
    assert got.shape == (B, S + (0 if cfg.is_encoder_only else cfg.num_prefix_tokens), cfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_lm_loss_and_grads_match_jax(model, jax_loss_and_grads, backend):
    """The loss (the VLM's on its text positions) and every gradient, through
    the attention op's wrappers ("auto": the kernels' plain versions on the
    CPU, the custom backward) and through plain autograd ("ref")."""
    _, cfg, _, params = model
    want, want_g = jax_loss_and_grads
    _, tb = _both(_batch(cfg, seed=2))
    got, grads = value_and_grad(lambda p: lm_loss(p, cfg.replace(backend=backend), tb)[0], params)
    assert abs(float(got) - want) <= TOL
    got_g = _leaves(grads)
    assert set(got_g) == set(want_g)
    for path, w in want_g.items():
        w, g = w.numpy().astype(np.float64), got_g[path].numpy().astype(np.float64)
        assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-30), path


@pytest.fixture(scope="module", params=["reduced", "own-hd"])
def vlm(request):
    jcfg, cfg, jparams, params = _model(PHI, request.param)
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, jparams), params


def test_vlm_prefill_and_decode_match_jax(vlm):
    """Prefill with the prefix (the last position's logits), then four dense
    decode steps fed fixed tokens at positions prompt + P + t."""
    jcfg, cfg, jparams, params = vlm
    batch = _batch(cfg, seed=3, prefix_scale=0.02)
    del batch["labels"]
    jb, tb = _both(batch)
    feed = np.random.default_rng(4).integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    base = S + cfg.num_prefix_tokens
    jstate = jax_init_lm_state(jcfg, B, base + STEPS)
    want, jstate = jax.jit(lambda p, b, st: jax_lm_prefill(p, jcfg, b, st))(jparams, jb, jstate)
    jdecode = jax.jit(lambda p, t, st, pos: jax_lm_decode(p, jcfg, t, st, pos))
    with torch.inference_mode():
        state = init_lm_state(cfg, B, base + STEPS)
        got, state = lm_prefill(params, cfg, tb, state)
        _close(got, want)
        for t in range(STEPS):
            want, jstate = jdecode(jparams, jnp.asarray(feed[t]), jstate, base + t)
            got, state = lm_decode(params, cfg, torch.from_numpy(feed[t]), state, base + t)
            _close(got, want)


def test_vlm_static_generate_matches_jax(vlm):
    """Greedy tokens of the static path, the prefix fed at prefill, equal the
    reference's."""
    jcfg, cfg, jparams, params = vlm
    batch = _batch(cfg, seed=5, prefix_scale=0.02)
    del batch["labels"]
    jb, tb = _both(batch)
    want = np.asarray(jax_static_generate(jparams, jcfg, jb, 6, key=jax.random.key(0)))
    got = static_generate(params, cfg, tb, 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_gelu_mlp_is_the_tanh_form():
    """The reference's ``jax.nn.gelu`` is the tanh approximation: the port's
    ``gelu_mlp`` agrees within 1e-6, and the erf form would not. GELU's
    params are two matrices, and ``apply_mlp`` takes them by the missing
    ``wg``."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 8, 64)).astype(np.float32) * 2
    wi = rng.standard_normal((64, 96)).astype(np.float32) / 8
    wo = rng.standard_normal((96, 64)).astype(np.float32) / 10
    want = np.asarray(jax_gelu_mlp(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo)))
    tx, ti, to = (torch.from_numpy(a) for a in (x, wi, wo))
    got = gelu_mlp(tx, ti, to).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    erf = (F.gelu(tx @ ti) @ to).numpy()
    assert np.abs(erf - want).max() > 1e-5
    cfg = get_arch(HUBERT).replace(d_model=64, d_ff=96)
    p = init_mlp(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == {"wi": (64, 96), "wo": (96, 64)}
    np.testing.assert_array_equal(apply_mlp({"wi": ti, "wo": to}, tx, cfg).numpy(), got)


def test_engines_refuse_encoder_and_vlm():
    """The continuous engine refuses an encoder (nothing to decode) and a VLM
    (no per-request prefix through admission), as the reference's does,
    before touching the params."""
    for arch, match in ((HUBERT, "encoder-only"), (PHI, "vision prefix")):
        with pytest.raises(ValueError, match=match):
            JaxServeEngine(jax_reduced_variant(jax_get_arch(arch)), None, JaxEngineConfig())
        with pytest.raises(ValueError, match=match):
            ServeEngine(reduced_variant(get_arch(arch)), None, EngineConfig())


def test_launchers_refuse_as_the_reference_does():
    """``launch.serve`` refuses an encoder on either engine and a VLM on the
    continuous one, and takes a VLM on the static one, as the reference's
    ``validate_args`` does; ``launch.train`` refuses the audio family."""
    cases = [(HUBERT, "static", "encoder-only"), (HUBERT, "continuous", "encoder-only"),
             (PHI, "continuous", "is a vlm"), (PHI, "static", None)]
    for arch, engine, match in cases:
        argv = ["--arch", arch, "--engine", engine]
        for parser, check, get in ((jax_build_parser(), jax_validate_args, jax_get_arch),
                                   (serve.build_parser(), serve.validate_args, get_arch)):
            args = parser.parse_args(argv)
            if match is None:
                check(args, get(arch))
            else:
                with pytest.raises(SystemExit, match=match):
                    check(args, get(arch))
    with pytest.raises(SystemExit, match="hubert trains via lm_loss on frames"):
        train.main(["--arch", HUBERT, "--reduced", "--device", "cpu"])


def test_vlm_launchers_run_on_cpu():
    """The static launcher serves a reduced phi with its seeded prefix, and
    ``launch.train`` trains it: its first loss is ``lm_loss`` of the same
    weights on the step's text with ``RandomState(0)``'s prefix."""
    out = serve.main(["--arch", PHI, "--reduced", "--device", "cpu", "--engine", "static", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4"])
    assert len(out["sample"]) == 4
    result = train.main(["--arch", PHI, "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
                         "--log-every", "1"])
    assert len(result["losses"]) == 2 and np.isfinite(result["losses"]).all()
    cfg = reduced_variant(get_arch(PHI)).replace(dtype="float32", param_dtype="float32")
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    from repro_torch.data.synthetic import make_token_stream

    batch = {k: torch.as_tensor(v) for k, v in make_token_stream(0, cfg.vocab_size, 2, 8).items()}
    prefix = np.random.RandomState(0).randn(2, cfg.num_prefix_tokens, cfg.frontend_dim).astype(np.float32) * 0.02
    with torch.no_grad():
        first, _ = lm_loss(params, cfg, dict(batch, prefix=torch.from_numpy(prefix)))
    assert result["losses"][0] == pytest.approx(float(first), abs=1e-6)


def test_conversion_is_the_identity(model):
    """JAX → port → JAX and port → JAX → port give the same bits, with the
    encoder's ``frames_proj`` and ``pred_head`` and the VLM's
    ``prefix_proj``; a tree without its head is refused."""
    _, cfg, jparams, params = model
    back = flatten_dict(lm_params_to_jax(cfg, params))
    want = flatten_dict(jparams)
    assert set(back) == set(want)
    for path, a in want.items():
        assert back[path].dtype == a.dtype and np.array_equal(back[path], a), path
    again = _leaves(lm_params_from_jax(cfg, lm_params_to_jax(cfg, params)))
    for path, t in _leaves(params).items():
        assert torch.equal(again[path], t), path
    top = {"frames_proj", "pred_head"} if cfg.is_encoder_only else {"embed", "lm_head", "prefix_proj"}
    assert top <= set(params)
    head = "pred_head" if cfg.is_encoder_only else "prefix_proj"
    with pytest.raises(ValueError, match="top-level leaves"):
        lm_params_from_jax(cfg, {k: v for k, v in jparams.items() if k != head})


def test_param_count_matches_jax():
    for arch in jax_list_archs():
        for active in (False, True):
            assert get_arch(arch).param_count(active) == jax_get_arch(arch).param_count(active), (arch, active)
