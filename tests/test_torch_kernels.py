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


# ---------------------------------------------------------------------------
# only the cotangents autograd asks for: for each subset of the inputs that
# require grad, the Function's backward returns None exactly for the others,
# and the rest match the JAX cotangents at the tolerances above

NEEDS_CASES = [CASES[1], CASES[2], CASES[3]]  # the main path's shape, several vocab tiles, bf16
NEEDS_IDS = [CASE_IDS[1], CASE_IDS[2], CASE_IDS[3]]
KL_SUBSETS = [(a, b, c) for a in (False, True) for b in (False, True) for c in (False, True) if a or b or c]


def _needs_id(subset):
    return "needs-" + "".join(str(int(x)) for x in subset)


@pytest.mark.parametrize("case_args", NEEDS_CASES, ids=NEEDS_IDS)
@pytest.mark.parametrize("subset", KL_SUBSETS, ids=_needs_id)
def test_ensemble_kl_backward_returns_only_needed_cotangents(case_args, subset):
    c = make_case(7, *case_args)
    dt, temperature = c["dtype"], 4.0
    ct = jnp.asarray(c["ct"])

    def f(cl, st, w):
        return jnp.vdot(jax_ensemble_kl(cl, st, w, temperature, backend="ref"), ct)

    want = jax.grad(f, argnums=(0, 1, 2))(_jnp(c["cl"], dt), _jnp(c["st"], dt), _jnp(c["w"]))
    args = (_torch(c["cl"], dt, subset[0]), _torch(c["st"], dt, subset[1]), _torch(c["w"], grad=subset[2]))
    out = ensemble_kl(*args, temperature, backend="auto")
    got = out.grad_fn.apply(torch.from_numpy(c["ct"]))  # the Function's backward, as autograd calls it
    assert got[3] is None  # the temperature
    atol_logits, atol_w = _cond_atols(c, TOL)
    tols = ("bf16" if dt == "bf16" else atol_logits,) * 2 + (atol_w,)
    for i in range(3):
        if not subset[i]:
            assert got[i] is None, i
            continue
        assert got[i].dtype == args[i].dtype
        _close(got[i], want[i], tols[i])
    torch.sum(out * torch.from_numpy(c["ct"])).backward()
    for i in range(3):
        assert (args[i].grad is None) == (not subset[i])


@pytest.mark.parametrize("case_args", NEEDS_CASES, ids=NEEDS_IDS)
@pytest.mark.parametrize(
    "weighted,stop", [(False, False), (True, True), (True, False)], ids=["ce", "ghs-stopgrad", "ghs-full"]
)
@pytest.mark.parametrize("subset", [(True, False), (False, True), (True, True)], ids=_needs_id)
def test_ghm_ce_backward_returns_only_needed_cotangents(case_args, weighted, stop, subset):
    c = make_case(8, *case_args)
    dt = c["dtype"]
    ct, lbl = jnp.asarray(c["ct"]), jnp.asarray(c["labels"])

    def f(cl, w):
        return jnp.vdot(jax_ghm_ce(cl, lbl, w, weighted, backend="ref", stop_difficulty_grad=stop), ct)

    want = jax.grad(f, argnums=(0, 1))(_jnp(c["cl"], dt), _jnp(c["w"]))
    cl, w = _torch(c["cl"], dt, subset[0]), _torch(c["w"], grad=subset[1])
    out = ghm_ce(cl, torch.from_numpy(c["labels"]).long(), w, weighted, backend="auto", stop_difficulty_grad=stop)
    got = out.grad_fn.apply(torch.from_numpy(c["ct"]))
    assert got[1] is None and got[3] is None and got[4] is None  # labels and the two flags
    atol_logits, atol_w = _cond_atols(c, TOL)
    for i, x, wi, tol in ((0, cl, 0, "bf16" if dt == "bf16" else atol_logits), (2, w, 1, atol_w)):
        if not subset[wi]:
            assert got[i] is None, i
            continue
        assert got[i].dtype == x.dtype
        _close(got[i], want[wi], tol)


@pytest.mark.parametrize(
    "n,itemsize,aligned",
    [(1280, 4, True), (1280, 2, True), (37 * 32003, 4, True), (37 * 32003, 2, True), (256 * 100, 4, True),
     (1280, 4, False), (5 * 33, 4, True), (1, 2, True), (4096 * 1024, 2, True)],
)
def test_loss_bwd_geometry(n, itemsize, aligned):
    """The loss backward kernels' grid: 16-byte accesses only where the
    plane allows them, one block at the main path's K=5, B=128, V=10, every
    thread at least two steps of the grid-stride loop until the grid fills
    the card's resident blocks, and one partials column per block when
    there is more than one."""
    from repro_torch.kernels.build import (
        LOSS_BWD_BLOCKS_PER_SM,
        LOSS_BWD_THREADS,
        SMS,
        loss_bwd_geometry,
    )

    blocks, vec, rows = loss_bwd_geometry(n, itemsize, aligned)
    cap = SMS * LOSS_BWD_BLOCKS_PER_SM
    assert vec in (1, 16 // itemsize)
    assert (vec > 1) == (aligned and n % (16 // itemsize) == 0)
    assert 1 <= blocks <= cap
    per_step = LOSS_BWD_THREADS * max(vec, 8 // itemsize)  # elements a block takes per step
    assert blocks == cap or blocks * per_step * 2 >= n
    assert blocks == 1 or (blocks - 1) * per_step * 2 < n  # no block without two steps' work
    assert rows == (blocks if blocks > 1 else 0)
    if n == 1280 and aligned:  # the main path's plane, fresh (aligned) tensors
        assert blocks == 1
    if n == 37 * 32003:
        assert blocks == cap and vec == 1


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


def _fwd_coverage(b, v, geo):
    """How often the loss forward kernels' walk visits each element of the
    (B, V) plane: the blocks' loop over (row group, split) items, each
    lane's steps of ``U`` accesses a group width apart (two single elements,
    or one 16-byte access), as the ``.cu`` sources walk."""
    from repro_torch.kernels.build import LOSS_FWD_THREADS

    lanes, rows, splits, span, blocks, vec = geo
    u_steps = 2 if vec == 1 else 1
    items = -(-b // rows) * splits
    seen = np.zeros(items, np.int64)
    for bx in range(blocks):
        seen[bx::blocks] += 1
    assert (seen == 1).all()  # every item taken by exactly one block
    count = np.zeros(b * v, np.int64)
    j = np.arange(lanes)[:, None]
    for item in range(items):
        c0 = item % splits * span
        c1 = min(v, c0 + span)
        steps = np.arange(0, max(c1 - c0, 0), lanes * vec * u_steps)[None, :]
        c = c0 + j * vec + steps  # (lanes, steps): each lane's loop
        for g in range(LOSS_FWD_THREADS // lanes):
            row = item // splits * rows + g
            if row >= b:
                continue
            for u in range(u_steps):
                cc = c + u * lanes * vec
                cc = cc[(c < c1) & (cc < c1)]
                np.add.at(count, (row * v + cc[:, None] + np.arange(vec)[None, :]).ravel(), 1)
    return count


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,v", [(1, 1), (5, 10), (128, 10), (256, 100), (37, 32003), (1, 151936), (3, 1024), (7, 1025)]
)
def test_loss_fwd_geometry(b, v, itemsize):
    """The loss forward kernels' launch: every row and column visited once
    across lanes and splits, at most the card's resident blocks, rows of a
    group of lanes filling whole warps (one block holds 16 rows of 16 lanes
    at the main path's B=128, V=10), 16-byte accesses only where the plane
    allows them, and a row split across blocks only where B rows alone
    cannot put two blocks on every SM."""
    from repro_torch.kernels.build import (
        LOSS_FWD_BLOCKS_PER_SM,
        LOSS_FWD_SPLIT_MIN,
        LOSS_FWD_THREADS,
        SMS,
        loss_fwd_geometry,
    )

    for aligned in (True, False):
        geo = loss_fwd_geometry(b, v, itemsize, aligned)
        lanes, rows, splits, span, blocks, vec = geo
        assert vec in (1, 16 // itemsize)
        assert (vec > 1) == (aligned and v % (16 // itemsize) == 0)
        assert (_fwd_coverage(b, v, geo) == 1).all()
        assert 1 <= blocks <= SMS * LOSS_FWD_BLOCKS_PER_SM
        assert rows * lanes == LOSS_FWD_THREADS and lanes & (lanes - 1) == 0
        assert lanes <= 32 or lanes == LOSS_FWD_THREADS
        if lanes < LOSS_FWD_THREADS:  # the lane groups fill their warps
            assert 32 % lanes == 0 and lanes * vec < 2 * v
        assert span % vec == 0 and (splits - 1) * span < v <= splits * span  # no empty split
        if splits > 1:
            assert b < 2 * SMS and lanes == LOSS_FWD_THREADS and span >= LOSS_FWD_SPLIT_MIN - vec
            assert b * splits <= SMS * LOSS_FWD_BLOCKS_PER_SM
        if (b, v) == (128, 10):
            assert (lanes, rows, splits) == (16, 16, 1)
        if v > 1024 and b < 2 * SMS and v >= 2 * LOSS_FWD_SPLIT_MIN:  # wide rows cover the card
            assert splits > 1 and blocks >= SMS


def test_wrapper_checks_reject_cpu_tensors():
    from repro_torch.kernels.build import check_cuda

    with pytest.raises(ValueError, match="one CUDA device"):
        check_cuda("ensemble_kl_fwd", torch.zeros(2))
