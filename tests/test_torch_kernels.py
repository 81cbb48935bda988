"""The port's loss ops (``repro_torch.kernels``) against the JAX package.

The same numpy inputs go through the JAX op (``backend="ref"``, plain
autodiff of the jnp oracle; ``pallas-interpret`` for the kernels' forward
residuals) and through the port, on the CPU, where each kernel wrapper
computes its plain version. Two port arms are held: ``"auto"`` (the
``torch.autograd.Function`` whose backward is the kernels' closed-form
cotangents) and ``"ref"`` (plain autograd of the port's oracle).

Tolerances: 1e-4 (rtol and atol) for everything computed and stored in f32,
with atol raised to the conditioning floor of ``tests/grad_harness.py``
(``_cond_atols``) at extreme logit scales; outputs stored in bf16 are held
to one bf16 rounding step (rtol 2^-7), since two f32 values 1e-7 apart can
round to neighbouring bf16 values.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grad_harness import EPS32, TOL, _cond_atols
from repro.kernels import ensemble_kl as jax_ensemble_kl
from repro.kernels import ghm_ce as jax_ghm_ce
from repro.kernels.ensemble_kl.kernel import ensemble_kl_pallas
from repro.kernels.ghm_ce.kernel import ghm_ce_pallas
from repro_torch.kernels import ensemble_kl, ghm_ce, launch_counts, resolve
from repro_torch.kernels.ensemble_kl.kernel import ensemble_kl_fwd
from repro_torch.kernels.ghm_ce.kernel import ghm_ce_fwd

pytestmark = pytest.mark.tier1

BF16_STEP = 2.0**-7

# (k, b, v, dtype, logit scale, w mode): B=5 and V off a multiple of 128,
# the main path's (5, 128, 10), several Pallas vocab tiles (V=700), bf16,
# logits of ±1e4, and degenerate weights
CASES = [
    (3, 5, 33, "f32", 2.0, "softmax"),
    (5, 128, 10, "f32", 2.0, "softmax"),
    (2, 13, 700, "f32", 2.0, "softmax"),
    (3, 8, 96, "bf16", 2.0, "softmax"),
    (3, 5, 33, "f32", 1e4, "softmax"),
    (3, 5, 33, "f32", 2.0, "onehot"),
    (3, 5, 33, "f32", 2.0, "zero"),
]
CASE_IDS = [f"k{k}-b{b}-v{v}-{dt}-s{s:g}-{wm}" for k, b, v, dt, s, wm in CASES]


def make_case(seed, k, b, v, dtype, scale, w_mode):
    """numpy inputs; bf16 cases hold bf16-representable values (stored as f32
    numpy), so JAX and the port see the same numbers."""
    rng = np.random.default_rng(seed)
    cl = (rng.standard_normal((k, b, v)) * scale).astype(np.float32)
    st = (rng.standard_normal((b, v)) * scale).astype(np.float32)
    if dtype == "bf16":
        cl = torch.from_numpy(cl).to(torch.bfloat16).float().numpy()
        st = torch.from_numpy(st).to(torch.bfloat16).float().numpy()
    if w_mode == "softmax":
        e = np.exp(rng.standard_normal(k))
        w = (e / e.sum()).astype(np.float32)
    elif w_mode == "onehot":
        w = np.eye(k, dtype=np.float32)[rng.integers(k)]
    else:
        w = np.zeros(k, np.float32)
    return {
        "cl": cl, "st": st, "w": w, "dtype": dtype,
        "labels": rng.integers(0, v, b).astype(np.int32),
        "ct": rng.standard_normal(b).astype(np.float32),
    }


def _jnp(a, dtype="f32"):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _torch(a, dtype="f32", grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
    return t.requires_grad_(grad)


def _close(got, want, atol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol = BF16_STEP if atol == "bf16" else TOL
    atol = BF16_STEP * max(1.0, float(np.abs(want).max())) if atol == "bf16" else atol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _fwd_atol(case, temperature):
    """The conditioning floor applied to a forward value: KL·T² cancels terms
    of size ~S/T, scaled by T²."""
    s = max(float(np.abs(case["cl"]).max()), float(np.abs(case["st"]).max()), 1.0)
    return max(TOL, 4 * EPS32 * s * max(temperature, 1.0))


# ---------------------------------------------------------------------------
# forward values and residuals


@pytest.mark.parametrize("case_args", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("temperature", [1.0, 4.0])
def test_ensemble_kl_forward_matches_jax(case_args, temperature):
    c = make_case(0, *case_args)
    dt = c["dtype"]
    want_out, want_lt, want_ls = ensemble_kl_pallas(
        _jnp(c["cl"], dt), _jnp(c["st"], dt), _jnp(c["w"]), temperature, interpret=True, return_stats=True
    )
    want_ref = jax_ensemble_kl(_jnp(c["cl"], dt), _jnp(c["st"], dt), _jnp(c["w"]), temperature, backend="ref")
    out, lse_t, lse_s = ensemble_kl_fwd(_torch(c["cl"], dt), _torch(c["st"], dt), _torch(c["w"]), temperature)
    atol = _fwd_atol(c, temperature)
    _close(out, want_out, atol)
    _close(out, want_ref, atol)
    _close(lse_t, want_lt, atol)
    _close(lse_s, want_ls, atol)
    for backend in ("auto", "ref"):
        got = ensemble_kl(_torch(c["cl"], dt), _torch(c["st"], dt), _torch(c["w"]), temperature, backend=backend)
        _close(got, want_ref, atol)


@pytest.mark.parametrize("case_args", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("weighted", [True, False])
def test_ghm_ce_forward_matches_jax(case_args, weighted):
    c = make_case(1, *case_args)
    dt = c["dtype"]
    want_out, want_lse, want_ly = ghm_ce_pallas(
        _jnp(c["cl"], dt), jnp.asarray(c["labels"]), _jnp(c["w"]), weighted=weighted,
        interpret=True, return_stats=True,
    )
    want_ref = jax_ghm_ce(_jnp(c["cl"], dt), jnp.asarray(c["labels"]), _jnp(c["w"]), weighted, backend="ref")
    labels = torch.from_numpy(c["labels"]).long()
    out, lse, ly = ghm_ce_fwd(_torch(c["cl"], dt), labels, _torch(c["w"]), weighted)
    atol = _fwd_atol(c, 1.0)
    _close(out, want_out, atol)
    _close(out, want_ref, atol)
    _close(lse, want_lse, atol)
    _close(ly, want_ly, atol)
    for backend in ("auto", "ref"):
        got = ghm_ce(_torch(c["cl"], dt), labels, _torch(c["w"]), weighted, backend=backend)
        _close(got, want_ref, atol)


# ---------------------------------------------------------------------------
# every cotangent set


@pytest.mark.parametrize("case_args", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("temperature", [1.0, 4.0])
@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_ensemble_kl_cotangents_match_jax(case_args, temperature, backend):
    c = make_case(2, *case_args)
    dt = c["dtype"]
    ct = jnp.asarray(c["ct"])

    def f(cl, st, w):
        return jnp.vdot(jax_ensemble_kl(cl, st, w, temperature, backend="ref"), ct)

    want = jax.grad(f, argnums=(0, 1, 2))(_jnp(c["cl"], dt), _jnp(c["st"], dt), _jnp(c["w"]))
    cl, st, w = _torch(c["cl"], dt, True), _torch(c["st"], dt, True), _torch(c["w"], grad=True)
    out = ensemble_kl(cl, st, w, temperature, backend=backend)
    torch.sum(out * torch.from_numpy(c["ct"])).backward()
    atol_logits, atol_w = _cond_atols(c, TOL)
    logit_tol = "bf16" if dt == "bf16" else atol_logits
    _close(cl.grad, want[0], logit_tol)
    _close(st.grad, want[1], logit_tol)
    _close(w.grad, want[2], atol_w)
    assert cl.grad.dtype == cl.dtype and st.grad.dtype == st.dtype


@pytest.mark.parametrize("case_args", CASES, ids=CASE_IDS)
@pytest.mark.parametrize(
    "weighted,stop", [(False, False), (True, True), (True, False)], ids=["ce", "ghs-stopgrad", "ghs-full"]
)
@pytest.mark.parametrize("backend", ["auto", "ref"])
def test_ghm_ce_cotangents_match_jax(case_args, weighted, stop, backend):
    c = make_case(3, *case_args)
    dt = c["dtype"]
    ct, lbl = jnp.asarray(c["ct"]), jnp.asarray(c["labels"])

    def f(cl, w):
        return jnp.vdot(jax_ghm_ce(cl, lbl, w, weighted, backend="ref", stop_difficulty_grad=stop), ct)

    want = jax.grad(f, argnums=(0, 1))(_jnp(c["cl"], dt), _jnp(c["w"]))
    cl, w = _torch(c["cl"], dt, True), _torch(c["w"], grad=True)
    labels = torch.from_numpy(c["labels"]).long()
    out = ghm_ce(cl, labels, w, weighted, backend=backend, stop_difficulty_grad=stop)
    torch.sum(out * torch.from_numpy(c["ct"])).backward()
    atol_logits, atol_w = _cond_atols(c, TOL)
    _close(cl.grad, want[0], "bf16" if dt == "bf16" else atol_logits)
    _close(w.grad, want[1], atol_w)


def test_ghm_ce_accepts_int32_labels():
    c = make_case(4, 3, 5, 33, "f32", 2.0, "softmax")
    cl = _torch(c["cl"])
    a = ghm_ce(cl, torch.from_numpy(c["labels"]), _torch(c["w"]))
    b = ghm_ce(cl, torch.from_numpy(c["labels"]).long(), _torch(c["w"]))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dispatch


def test_dispatch_values():
    cpu = torch.device("cpu")
    assert resolve("loss", "auto", cpu) == "fused"
    assert resolve("loss", "ref", cpu) == "ref"
    assert resolve("loss", "cuda", torch.device("cuda")) == "fused"
    with pytest.raises(ValueError, match="unknown kernel backend"):
        resolve("loss", "pallas", cpu)
    for op in ("attn", "decode"):  # the attention ops of the serving slice
        assert resolve(op, "auto", cpu) == "fused"
        assert resolve(op, "ref", cpu) == "ref"
    with pytest.raises(ValueError, match="unknown backend op"):
        resolve("moe", "auto", cpu)


def test_cuda_backend_raises_on_cpu_tensors():
    c = make_case(5, 3, 5, 33, "f32", 2.0, "softmax")
    cl, st, w = _torch(c["cl"]), _torch(c["st"]), _torch(c["w"])
    with pytest.raises(ValueError, match="requires CUDA tensors"):
        ensemble_kl(cl, st, w, backend="cuda")
    with pytest.raises(ValueError, match="requires CUDA tensors"):
        ghm_ce(cl, torch.from_numpy(c["labels"]).long(), w, backend="cuda")


def test_plain_versions_on_cpu_launch_nothing():
    """A CPU tensor takes the plain version: no launch is counted."""
    c = make_case(6, 3, 5, 33, "f32", 2.0, "softmax")
    before = launch_counts()
    cl = _torch(c["cl"], grad=True)
    loss = ensemble_kl(cl, _torch(c["st"]), _torch(c["w"])).sum() + ghm_ce(
        cl, torch.from_numpy(c["labels"]).long(), _torch(c["w"])
    ).sum()
    loss.backward()
    assert launch_counts() == before


@pytest.mark.parametrize("b,v", [(1, 1), (5, 10), (128, 10), (37, 32003), (3, 1024), (7, 1025)])
def test_row_blocks_are_powers_of_two_covering_small_v(b, v):
    from repro_torch.kernels.build import row_blocks

    block_b, block_v = row_blocks(b, v)
    assert block_v >= 16 and block_v & (block_v - 1) == 0 and block_v <= 1024
    assert block_b >= 1 and block_b & (block_b - 1) == 0 and block_b * block_v <= 4096
    if v <= 1024:
        assert block_v >= v  # one masked chunk covers the row


def test_wrapper_checks_reject_cpu_tensors():
    from repro_torch.kernels.build import check_cuda

    with pytest.raises(ValueError, match="one CUDA device"):
        check_cuda("ensemble_kl_fwd", torch.zeros(2))
