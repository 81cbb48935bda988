"""The port's recurrent families against the JAX package on the CPU:
``utils/scan.py`` ``chunked_scan``, ``models/xlstm.py`` (mLSTM, sLSTM),
``models/mamba.py``, the hybrid layer pattern and the engine's recurrent
carries, on the reduced xlstm-125m (3 mLSTM blocks and an sLSTM block,
d_model 128, 4 heads) and the reduced jamba-v0.1-52b (8 layers: Mamba,
attention at layer 4, MoE every other layer), all in f32.

Inputs are made from a seed with numpy and fed to both sides; weights
cross through ``repro_torch.convert``. At the reduced scan chunk of 16, a
sequence of T = 12 is one chunk, T = 32 runs the chunked (checkpointed)
branch, and T = 40 falls back to the plain loop (and pads Mamba's scan).

* ``chunked_scan`` on a toy cell at T in {12, 32, 40}: outputs, final
  carry and the gradients of the inputs, the initial carry and a weight
  within 1e-5 (relative to each's largest); with the checkpoint on and
  off, the same bits.
* The mLSTM, sLSTM and Mamba forwards at the reduced widths, from zeros,
  at the three T: outputs and final carries within 1e-5 absolute (values
  of size about 1), the gradients of every parameter and of x within 1e-5
  of each's largest.
* Prefill of S in {32, 40} tokens, then 4 decode steps fed fixed tokens,
  for both archs: logits within 1e-5 (prefill) and 2e-5 (decode, see
  ``DECODE_TOL``) of the larger of 1 and the largest |logit| (jamba's
  logits reach about 4).
* ``lm_loss`` and its gradients for both archs with the port's ``remat``
  on and off, against JAX with ``remat=True, scan_layers=True``, at T = 32:
  the loss within 1e-6 relative, each gradient within 1e-5 of its leaf's
  largest; ``remat`` changes no bit.

The engine, the refusals, the launchers and conversion are in
``tests/test_torch_ssm_serve.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import reduced_variant as jax_reduced_variant
from repro.models import init_lm as jax_init_lm
from repro.models import init_lm_state as jax_init_lm_state
from repro.models import lm_decode as jax_lm_decode
from repro.models import lm_loss as jax_lm_loss
from repro.models import lm_prefill as jax_lm_prefill
from repro.models import mamba as jax_mamba
from repro.models import xlstm as jax_xlstm
from repro.utils.scan import chunked_scan as jax_chunked_scan
from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.models import mamba, xlstm
from repro_torch.models.transformer import init_lm_state, lm_decode, lm_loss, lm_prefill
from repro_torch.utils.scan import chunked_scan
from repro_torch.utils.trees import flatten_dict, value_and_grad

pytestmark = pytest.mark.tier1


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers on one host, and a loop of small ops in each of them slows to
    a crawl when every worker spins all the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)

ARCHS = ("xlstm-125m", "jamba-v0.1-52b")
TS = (12, 32, 40)
TOL = 1e-5
# decode after a long prefill: the mLSTM read-out divides by max(|n·q|,
# exp(-m)), and a one-ulp change of every weight moves the reference's own
# xlstm-125m logits by up to 9.8e-6 at the third decode step after a
# 32-token prefill; the port is held to twice TOL there
DECODE_TOL = 2e-5


def _close(got, want, rel=False, name="", tol=TOL):
    """Within ``tol``: absolute on values of size about 1 (scaled by the
    largest |want| where that exceeds 1), or (``rel``) relative to the
    largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = np.abs(want).max()
    if rel:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(top, 1e-30), err_msg=name)
    else:
        assert top > 0.1, name  # of size about 1, not vanishing
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, top), err_msg=name)


def _cfgs(arch, **kw):
    jcfg = jax_reduced_variant(jax_get_arch(arch)).replace(dtype="float32", param_dtype="float32", **kw)
    cfg = reduced_variant(get_arch(arch)).replace(dtype="float32", param_dtype="float32")
    return jcfg, cfg


# ---------------------------------------------------------------------------
# chunked_scan


def _toy_cell(lib):
    """carry (h (B, D), s (B,)); x_t (B, D); w (D, D): a tanh RNN and a
    running sum, the same on both sides."""
    def cell(w, carry, x):
        h, s = carry
        h = lib.tanh(h @ w + x)
        return (h, s + h.sum(-1)), 2.0 * h
    return cell


@pytest.mark.parametrize("t", TS)
def test_chunked_scan_matches_jax(t):
    rng = np.random.default_rng(t)
    b, d, chunk = 2, 8, 16
    w = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    xs = rng.standard_normal((t, b, d)).astype(np.float32)
    r = rng.standard_normal((t, b, d)).astype(np.float32)
    jcell = _toy_cell(jnp)

    def jloss(w, h0, xs):
        (h, s), ys = jax_chunked_scan(lambda c, x: jcell(w, c, x), (h0, jnp.zeros((b,))), xs, chunk=chunk)
        return jnp.sum(ys * r) + jnp.sum(h) + jnp.sum(s), (h, s, ys)

    (_, (wh, ws, wys)), wg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(w, h0, xs)
    tcell = _toy_cell(torch)
    runs = []
    for use_checkpoint in (True, False):
        args = [torch.tensor(a, requires_grad=True) for a in (w, h0, xs)]
        (h, s), ys = chunked_scan(lambda c, x: tcell(args[0], c, x), (args[1], torch.zeros(b)), args[2], chunk,
                                  use_checkpoint=use_checkpoint)
        (torch.sum(ys * torch.from_numpy(r)) + h.sum() + s.sum()).backward()
        runs.append([h, s, ys] + [a.grad for a in args])
    for got, want, name in zip(runs[0], [wh, ws, wys, *wg], ("h", "s", "ys", "dw", "dh0", "dxs")):
        _close(got.detach(), want, rel=True, name=name)
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


# ---------------------------------------------------------------------------
# the mixers


MIXERS = {
    "mlstm": ("xlstm-125m", jax_xlstm.init_mlstm, jax_xlstm.mlstm_forward, xlstm.mlstm_forward),
    "slstm": ("xlstm-125m", jax_xlstm.init_slstm, jax_xlstm.slstm_forward, xlstm.slstm_forward),
    "mamba": ("jamba-v0.1-52b", jax_mamba.init_mamba, jax_mamba.mamba_forward, mamba.mamba_forward),
}


@pytest.mark.parametrize("mixer,t", [(m, t) for m in MIXERS for t in TS])
def test_mixer_forward_and_grads_match_jax(mixer, t):
    """From zeros, as a prefill starts: the output and the final carry, and
    the gradients of a loss that reads both."""
    arch, jinit, jfwd, fwd = MIXERS[mixer]
    jcfg, cfg = _cfgs(arch)
    jp = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(1), jcfg, jnp.float32))
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    _, jstate = jfwd(jp, jnp.asarray(x), jcfg, return_state=True)
    r_out = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    r_state = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in jstate.items()}

    def jloss(p, x):
        out, st = jfwd(p, x, jcfg, return_state=True)
        return jnp.sum(out * r_out) + sum(jnp.sum(st[k] * r_state[k]) for k in st), (out, st)

    (_, (want, wstate)), (wgp, wgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in jp.items()}
    xt = torch.tensor(x, requires_grad=True)
    out, st = fwd(p, xt, cfg, return_state=True)
    assert set(st) == set(wstate) and all(st[k].dtype == torch.float32 or k == "conv" for k in st)
    (torch.sum(out * torch.from_numpy(r_out)) + sum(torch.sum(st[k] * torch.from_numpy(r_state[k])) for k in st)).backward()
    _close(out.detach(), want, name="out")
    for k in st:
        _close(st[k].detach(), wstate[k], rel=True, name=k)
    _close(xt.grad, wgx, rel=True, name="dx")
    for k in jp:
        _close(p[k].grad, wgp[k], rel=True, name=f"d{k}")


# ---------------------------------------------------------------------------
# the LM: prefill and decode, lm_loss


def _lm(arch, seed=3, head=1.0, **kw):
    """The reduced arch in f32, JAX weights carried across, norm scales
    given values (they start at zero); ``head`` scales the output head."""
    jcfg, cfg = _cfgs(arch, **kw)
    rng = np.random.default_rng(seed)
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32)
        if "scale" in jax.tree_util.keystr(p) else np.asarray(x),
        jax_init_lm(jcfg, jax.random.key(seed)),
    )
    if head != 1.0:
        where = ("embed", "table") if cfg.tie_embeddings else ("lm_head", "kernel")
        jparams[where[0]][where[1]] = jparams[where[0]][where[1]] * np.float32(head)
    return jcfg, cfg, jparams, lm_params_from_jax(cfg, jparams)


@pytest.mark.parametrize("arch,s", [(a, s) for a in ARCHS for s in (32, 40)])
def test_prefill_then_decode_matches_jax(arch, s):
    jcfg, cfg, jparams, params = _lm(arch)
    rng = np.random.default_rng(s)
    b, steps, max_seq = 2, 4, 48
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (steps, b, 1)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jprefill = jax.jit(lambda p, t, st: jax_lm_prefill(p, jcfg, {"tokens": t}, st))
    jdecode = jax.jit(lambda p, t, st, pos: jax_lm_decode(p, jcfg, t, st, pos))
    want, jstate = jprefill(jp, jnp.asarray(tokens), jax_init_lm_state(jcfg, b, max_seq))
    with torch.inference_mode():
        state = init_lm_state(cfg, b, max_seq)
        got, state = lm_prefill(params, cfg, {"tokens": torch.from_numpy(tokens)}, state)
        _close(got, want, name="prefill")
        for i in range(steps):
            want, jstate = jdecode(jp, jnp.asarray(feed[i]), jstate, jnp.int32(s + i))
            got, state = lm_decode(params, cfg, torch.from_numpy(feed[i]), state, s + i)
            _close(got, want, name=f"decode {i}", tol=DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_with_remat_matches_jax(arch):
    """At T = 32 (two scan chunks, checkpointed inside each checkpointed
    layer under remat)."""
    jcfg, cfg, jparams, params = _lm(arch, remat=True, scan_layers=True)
    rng = np.random.default_rng(5)
    batch = {n: rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32) for n in ("tokens", "labels")}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, jm), jg = jax.jit(jax.value_and_grad(lambda p: jax_lm_loss(p, jcfg, jbatch), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    want_g = flatten_dict(jax.tree_util.tree_map(np.asarray, jg))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {}
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        loss, grads = value_and_grad(lambda p: lm_loss(p, c, tbatch)[0], params)
        got_g = flatten_dict(lm_params_to_jax(c, grads))
        runs[remat] = (loss, got_g)
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-6, atol=0)
        assert set(got_g) == set(want_g)
        for path, w in want_g.items():
            _close(got_g[path], w, rel=True, name=path)
    assert torch.equal(runs[True][0], runs[False][0])
    for path, g in runs[True][1].items():
        np.testing.assert_array_equal(g, runs[False][1][path], err_msg=path)
