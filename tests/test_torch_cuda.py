"""The port's kernels on the GPU (the loss kernels: Triton forwards and CUDA
C++ backwards that compute only the wanted cotangents; the CUDA C++
attention kernels, forward and both backward passes: the tensor-core
kernels for bf16, the CUDA-core kernels for f32; split-KV paged decode),
against their plain PyTorch versions on the same inputs, a second call
bitwise equal, and one full-width training step. These tests need a CUDA device (marker
``cuda``) and skip without one; on the card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

Tolerance, elementwise: ``|got − want| ≤ tol·(|want| + max(1, max|want|))``
with tol = 1e-4 for f32 outputs and 2^-7 (one bf16 rounding step) for
outputs stored in bf16. The file imports no JAX: the machine with the card
has none.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ensemble_kl, ghm_ce, launch_counts, reset_launch_counts
from repro_torch.kernels.ensemble_kl.kernel import ensemble_kl_bwd, ensemble_kl_fwd
from repro_torch.kernels.ensemble_kl.ref import ensemble_kl_bwd_ref, ensemble_kl_fwd_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_delta,
    flash_attention_bwd_dkv_ref,
    flash_attention_bwd_dq_ref,
    flash_attention_ref_lse,
)
from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.ghm_ce.kernel import ghm_ce_bwd, ghm_ce_fwd
from repro_torch.kernels.ghm_ce.ref import ghm_ce_bwd_ref, ghm_ce_fwd_ref

pytestmark = pytest.mark.cuda

# (K, B, V): the main path's, a masked tail, a wide vocabulary, 20 clients
# on 100 classes (the paper's client sweep), and one client
SHAPES = [(5, 128, 10), (3, 5, 33), (5, 37, 32003), (20, 256, 100), (1, 128, 10)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton and CUDA C++ kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(k, b, v, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    cl = (torch.randn((k, b, v), generator=g) * 2).to(dtype)
    st = (torch.randn((b, v), generator=g) * 2).to(dtype)
    w = torch.softmax(torch.randn((k,), generator=g), 0)
    labels = torch.randint(0, v, (b,), generator=g)
    ct = torch.randn((b,), generator=g)
    return [t.to(device) for t in (cl, st, w, labels, ct)]


def _close(got, want):
    tol = 2.0**-7 if got.dtype == torch.bfloat16 else 1e-4
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    bound = tol * (want.abs() + max(1.0, float(want.abs().max())))
    assert bool(((got - want).abs() <= bound).all()), float((got - want).abs().max())


@pytest.mark.parametrize("k,b,v", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("temperature", [1.0, 4.0])
def test_ensemble_kl_kernels_match_plain(device, k, b, v, dtype, temperature):
    cl, st, w, _, ct = _inputs(k, b, v, dtype, device)
    want = ensemble_kl_fwd_ref(cl, st, w, temperature)
    for got, ref in zip(ensemble_kl_fwd(cl, st, w, temperature), want):
        _close(got, ref)
    out, lse_t, lse_s = want
    got = ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, temperature)
    ref = ensemble_kl_bwd_ref(cl, st, w, ct, out, lse_t, lse_s, temperature)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype
        _close(a, r)


@pytest.mark.parametrize("k,b,v", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("weighted,stop", [(False, False), (True, True), (True, False)])
def test_ghm_ce_kernels_match_plain(device, k, b, v, dtype, weighted, stop):
    cl, _, w, labels, ct = _inputs(k, b, v, dtype, device, seed=1)
    want = ghm_ce_fwd_ref(cl, labels, w, weighted)
    for got, ref in zip(ghm_ce_fwd(cl, labels, w, weighted), want):
        _close(got, ref)
    _, lse, ly = want
    got = ghm_ce_bwd(cl, labels, w, ct, lse, ly, weighted, stop)
    ref = ghm_ce_bwd_ref(cl, labels, w, ct, lse, ly, weighted, stop)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype
        _close(a, r)


def test_ops_launch_kernels_and_match_ref_autograd(device):
    """Through the autograd.Functions: every kernel launches once per pass,
    the gradients match autograd of the plain oracle, and ``g_w`` is the
    same bit for bit on a second run (fixed-order reduction). Then for each
    subset of the inputs that require grad (the generator's steps: logits
    only; the distillation sweep: the student's; the EE step: ``w``'s), the
    backward launches once and only those inputs get gradients, matching
    the plain oracle."""
    cl0, st0, w0, labels, ct = _inputs(5, 128, 10, torch.float32, device, seed=2)

    def grads(backend, want=(True, True, True)):
        cl, st, w = (t.clone().requires_grad_(x) for t, x in zip((cl0, st0, w0), want))
        loss = torch.sum(ensemble_kl(cl, st, w, 4.0, backend=backend) * ct)
        if want[0] or want[2]:
            loss = loss + torch.sum(ghm_ce(cl, labels, w, True, backend=backend, stop_difficulty_grad=True) * ct)
        loss.backward()
        return cl.grad, st.grad, w.grad

    reset_launch_counts()
    got = grads("cuda")
    assert launch_counts() == {
        "ensemble_kl_fwd": 1, "ensemble_kl_bwd": 1, "ghm_ce_fwd": 1, "ghm_ce_bwd": 1,
        "flash_attention_fwd": 0, "flash_attention_fwd_sm90": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dq_sm90": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dkv_sm90": 0,
        "flash_decode": 0,
    }
    for a, r in zip(got, grads("ref")):
        _close(a, r)
    assert torch.equal(grads("cuda")[2], got[2])
    for want in [(a, b, c) for a in (False, True) for b in (False, True) for c in (False, True) if a or b or c]:
        reset_launch_counts()
        got = grads("cuda", want)
        counts = launch_counts()
        assert counts["ensemble_kl_bwd"] == 1 and counts["ghm_ce_bwd"] == int(want[0] or want[2])
        for a, r, x in zip(got, grads("ref", want), want):
            assert (a is None) == (not x) and (r is None) == (not x)
            if x:
                _close(a, r)


# ---------------------------------------------------------------------------
# the loss backward kernels (CUDA C++): every cotangent subset, determinism,
# the g_w ticket, CUDA graphs

NEEDS_KL = [(a, b, c) for a in (False, True) for b in (False, True) for c in (False, True) if a or b or c]
NEEDS_CE = [(True, False), (False, True), (True, True)]
CE_MODES = [(False, False), (True, True), (True, False)]


def _kl_case(k, b, v, dtype, device, temperature=4.0, seed=0):
    cl, st, w, _, ct = _inputs(k, b, v, dtype, device, seed=seed)
    out, lse_t, lse_s = ensemble_kl_fwd_ref(cl, st, w, temperature)
    return (cl, st, w, ct, out, lse_t, lse_s, temperature)


def _ce_case(k, b, v, dtype, device, weighted=False, seed=1):
    cl, _, w, labels, ct = _inputs(k, b, v, dtype, device, seed=seed)
    _, lse, ly = ghm_ce_fwd_ref(cl, labels, w, weighted)
    return cl, labels, w, ct, lse, ly


@pytest.mark.parametrize("k,b,v", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("needs", NEEDS_KL, ids=lambda n: "".join(str(int(x)) for x in n))
def test_ensemble_kl_bwd_every_cotangent_subset(device, k, b, v, dtype, needs):
    args = _kl_case(k, b, v, dtype, device)
    reset_launch_counts()
    got = ensemble_kl_bwd(*args, needs=needs)
    torch.cuda.synchronize()
    assert launch_counts()["ensemble_kl_bwd"] == 1
    for a, r, x in zip(got, ensemble_kl_bwd_ref(*args), needs):
        assert (a is None) == (not x)
        if x:
            assert a.dtype == r.dtype
            _close(a, r)


@pytest.mark.parametrize("k,b,v", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("weighted,stop", CE_MODES)
@pytest.mark.parametrize("needs", NEEDS_CE, ids=lambda n: "".join(str(int(x)) for x in n))
def test_ghm_ce_bwd_every_cotangent_subset(device, k, b, v, dtype, weighted, stop, needs):
    cl, labels, w, ct, lse, ly = _ce_case(k, b, v, dtype, device, weighted)
    reset_launch_counts()
    got = ghm_ce_bwd(cl, labels, w, ct, lse, ly, weighted, stop, needs=needs)
    torch.cuda.synchronize()
    assert launch_counts()["ghm_ce_bwd"] == 1
    for a, r, x in zip(got, ghm_ce_bwd_ref(cl, labels, w, ct, lse, ly, weighted, stop), needs):
        assert (a is None) == (not x)
        if x:
            assert a.dtype == r.dtype
            _close(a, r)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ghm_ce_bwd_int32_labels(device, dtype):
    cl, labels, w, ct, lse, ly = _ce_case(5, 37, 1001, dtype, device, True)
    want = ghm_ce_bwd_ref(cl, labels, w, ct, lse, ly, True, True)
    for a, r in zip(ghm_ce_bwd(cl, labels.int(), w, ct, lse, ly, True, True), want):
        _close(a, r)


def test_loss_bwd_unaligned_planes_take_single_elements(device):
    """Logits that start off a 16-byte boundary (a view one element in) go
    through the single-element path and agree with the plain versions."""
    from repro_torch.kernels.build import loss_bwd_geometry

    base = torch.randn(5 * 128 * 12 + 1, device=device)
    cl = base[1:].view(5, 128, 12)
    st = torch.randn(128 * 12 + 1, device=device)[1:].view(128, 12)
    assert loss_bwd_geometry(128 * 12, 4, cl.data_ptr() % 16 == 0)[1] == 1
    w = torch.softmax(torch.randn(5, device=device), 0)
    ct = torch.randn(128, device=device)
    out, lse_t, lse_s = ensemble_kl_fwd_ref(cl, st, w, 2.0)
    for a, r in zip(ensemble_kl_bwd(cl, st, w, ct, out, lse_t, lse_s, 2.0),
                    ensemble_kl_bwd_ref(cl, st, w, ct, out, lse_t, lse_s, 2.0)):
        _close(a, r)
    labels = torch.randint(0, 12, (128,), device=device)
    _, lse, ly = ghm_ce_fwd_ref(cl, labels, w, False)
    for a, r in zip(ghm_ce_bwd(cl, labels, w, ct, lse, ly, False), ghm_ce_bwd_ref(cl, labels, w, ct, lse, ly, False)):
        _close(a, r)


# (K, B, V) whose grids have many blocks: the wide vocabulary, and 20
# clients on a vocabulary wide enough to fill the card
MANY_BLOCKS = [(5, 37, 32003), (20, 64, 8192)]


@pytest.mark.parametrize("k,b,v", MANY_BLOCKS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_bwd_second_call_same_bits(device, k, b, v, dtype):
    """No float atomics: at a many-block grid, a second call gives the same
    bits, g_w included."""
    from repro_torch.kernels.build import loss_bwd_geometry

    assert loss_bwd_geometry(b * v, 4, True)[0] > 100
    args = _kl_case(k, b, v, dtype, device)
    first = ensemble_kl_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(first, ensemble_kl_bwd(*args)))
    ce = _ce_case(k, b, v, dtype, device, True)
    first = ghm_ce_bwd(*ce, True, False)
    assert all(torch.equal(x, y) for x, y in zip(first, ghm_ce_bwd(*ce, True, False)))


def test_loss_bwd_ticket_left_at_zero(device):
    """A many-block call, then a one-block call, then the many-block call
    again: all right, so each launch left the g_w ticket at 0."""
    wide = _ce_case(5, 37, 32003, torch.float32, device)
    main = _ce_case(5, 128, 10, torch.float32, device)
    kl = _kl_case(5, 37, 32003, torch.float32, device)
    for args in (wide, main, wide, main, wide):
        got = ghm_ce_bwd(*args, False, False, needs=(False, True))[1]
        _close(got, ghm_ce_bwd_ref(*args, False, False)[1])
        got = ensemble_kl_bwd(*kl, needs=(False, False, True))[2]
        _close(got, ensemble_kl_bwd_ref(*kl)[2])


@pytest.mark.parametrize("k,b,v", [(5, 128, 10), (5, 37, 32003)])
def test_loss_bwd_cuda_graph_replay_equals_eager(device, k, b, v):
    """A captured call, replayed, gives the eager call's bits: the g_w
    scratch exists before the capture and the ticket is back at 0 after
    every launch."""
    kl = _kl_case(k, b, v, torch.float32, device)
    ce = _ce_case(k, b, v, torch.float32, device, True)
    eager = (*ensemble_kl_bwd(*kl), *ghm_ce_bwd(*ce, True, True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            ensemble_kl_bwd(*kl)
            ghm_ce_bwd(*ce, True, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = (*ensemble_kl_bwd(*kl), *ghm_ce_bwd(*ce, True, True))
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(captured, eager))


def test_wrappers_reject_bad_inputs(device):
    cl, st, w, labels, _ = _inputs(3, 5, 33, torch.float32, device)
    with pytest.raises(ValueError, match="contiguous"):
        ensemble_kl_fwd(cl.transpose(1, 2).contiguous().transpose(1, 2), st, w)
    with pytest.raises(ValueError, match="float32"):
        ghm_ce_fwd(cl, labels, w.double())
    with pytest.raises(ValueError, match="one CUDA device"):
        ghm_ce_fwd(cl, labels.cpu(), w)


# ---------------------------------------------------------------------------
# attention kernels (CUDA C++)

# (B, Sq, Sk, H, KH, hd): the smollm-135m prefill shape, a masked tail,
# Sq > Sk (fully-masked rows under a window), and hd = 128
ATTN_SHAPES = [(2, 128, 128, 9, 3, 64), (2, 37, 37, 4, 2, 32), (1, 70, 33, 4, 1, 128)]


def _attn_inputs(b, sq, sk, h, kh, hd, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).to(device) for shape in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd))]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "causal,window,softcap", [(True, 0, 0.0), (True, 8, 0.0), (True, 0, 30.0), (False, 0, 0.0), (False, 16, 30.0)]
)
def test_flash_attention_kernel_matches_plain(device, shape, dtype, causal, window, softcap):
    q, k, v = _attn_inputs(*shape, dtype, device)
    kw = dict(causal=causal, window=window, softcap=softcap)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_fwd_sm90"] == int(dtype == torch.bfloat16)  # bf16 → the tensor cores
    want_o, want_lse = flash_attention_ref_lse(q, k, v, **kw)
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, want_o)
    masked = want_lse == 1e30  # fully-masked rows: exactly 1e30 in both
    assert torch.equal(lse == 1e30, masked)
    _close(lse[~masked], want_lse[~masked])


# (B, Sq, Sk, H, KH, hd) of the backward: the smollm-135m training shape,
# a masked tail with hd 32, Sq > Sk (fully-masked rows under a window) with
# hd 128, and Sq < Sk with G = 8
BWD_SHAPES = [(2, 256, 256, 9, 3, 64), (2, 37, 37, 4, 2, 32), (1, 70, 33, 4, 1, 128), (2, 20, 45, 8, 1, 64)]
BWD_MASKS = [(True, 0, 0.0), (True, 16, 30.0), (False, 0, 0.0), (False, 16, 30.0), (True, 8, 0.0)]


def _bwd_inputs(shape, dtype, device, kw, seed=0):
    """q, k, v, dout and the forward's residuals (plain forward in f32, so
    both arms see the same lse and delta)."""
    q, k, v = _attn_inputs(*shape, dtype, device, seed=seed)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed + 1)).to(dtype).to(device)
    out, lse = flash_attention_ref_lse(q, k, v, **kw)
    return q, k, v, dout, lse, attention_delta(out, dout)


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,softcap", BWD_MASKS)
def test_flash_attention_bwd_kernels_match_plain(device, shape, dtype, causal, window, softcap):
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, dout, lse, delta = _bwd_inputs(shape, dtype, device, kw)
    reset_launch_counts()
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention_bwd_dq"] == 1 and counts["flash_attention_bwd_dkv"] == 1
    # bf16 → the tensor-core passes, both of them
    assert counts["flash_attention_bwd_dq_sm90"] == counts["flash_attention_bwd_dkv_sm90"] == int(dtype == torch.bfloat16)
    assert dq.dtype == dtype and dk.dtype == dtype and dv.dtype == dtype
    _close(dq, flash_attention_bwd_dq_ref(q, k, v, dout, lse, delta, **kw))
    for got, want in zip((dk, dv), flash_attention_bwd_dkv_ref(q, k, v, dout, lse, delta, **kw)):
        _close(got, want)


def test_flash_attention_sm90_long_sequence(device):
    """bf16 at 1024 tokens (9 heads over 3 kv heads, hd 64, causal): the
    forward's and the dq pass's K/V ring and the dk/dv pass's Q/dout ring
    wrap many times."""
    kw = dict(causal=True, window=0, softcap=0.0)
    shape = (1, 1024, 1024, 9, 3, 64)
    q, k, v = _attn_inputs(*shape, torch.bfloat16, device, seed=7)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, **kw)
    want_o, want_lse = flash_attention_ref_lse(q, k, v, **kw)
    _close(out, want_o)
    _close(lse, want_lse)
    args = _bwd_inputs(shape, torch.bfloat16, device, kw, seed=7)
    _close(flash_attention_bwd_dq(*args, **kw), flash_attention_bwd_dq_ref(*args, **kw))
    for got, want in zip(flash_attention_bwd_dkv(*args, **kw), flash_attention_bwd_dkv_ref(*args, **kw)):
        _close(got, want)
    counts = launch_counts()
    assert counts["flash_attention_fwd_sm90"] == 1 and counts["flash_attention_bwd_dkv_sm90"] == 1
    assert counts["flash_attention_bwd_dq_sm90"] == 1


@pytest.mark.parametrize("causal,window,softcap", BWD_MASKS)
def test_cuda_core_variant_on_bf16_matches_plain(device, causal, window, softcap):
    """The CUDA-core kernels still take bf16 when a caller names them
    (``chip_smoke.py`` times them beside the tensor-core kernels)."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, dout, lse, delta = _bwd_inputs(BWD_SHAPES[1], torch.bfloat16, device, kw, seed=8)
    reset_launch_counts()
    out, got_lse = flash_attention_fwd(q, k, v, variant="cuda_core", **kw)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, variant="cuda_core", **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, variant="cuda_core", **kw)
    counts = launch_counts()
    assert counts["flash_attention_fwd"] == 1 and counts["flash_attention_fwd_sm90"] == 0
    assert counts["flash_attention_bwd_dq"] == 1 and counts["flash_attention_bwd_dq_sm90"] == 0
    assert counts["flash_attention_bwd_dkv"] == 1 and counts["flash_attention_bwd_dkv_sm90"] == 0
    want_o, want_lse = flash_attention_ref_lse(q, k, v, **kw)
    _close(out, want_o)
    masked = want_lse == 1e30
    _close(got_lse[~masked], want_lse[~masked])
    _close(dq, flash_attention_bwd_dq_ref(q, k, v, dout, lse, delta, **kw))
    for got, want in zip((dk, dv), flash_attention_bwd_dkv_ref(q, k, v, dout, lse, delta, **kw)):
        _close(got, want)


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,softcap", BWD_MASKS)
def test_flash_attention_bwd_kernels_are_deterministic(device, shape, dtype, causal, window, softcap):
    """No atomics: a second call gives the same bits."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    args = _bwd_inputs(shape, dtype, device, kw, seed=4)
    first = (flash_attention_bwd_dq(*args, **kw), *flash_attention_bwd_dkv(*args, **kw))
    second = (flash_attention_bwd_dq(*args, **kw), *flash_attention_bwd_dkv(*args, **kw))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_op_backward_launches_kernels(device):
    """Through the autograd.Function: the forward and both backward kernels
    launch once each, and the gradients match autograd of the plain op."""
    q0, k0, v0 = _attn_inputs(2, 37, 37, 4, 2, 32, torch.float32, device, seed=5)
    ct = torch.randn(q0.shape, generator=torch.Generator().manual_seed(6)).to(device)

    def grads(backend):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        out = flash_attention(q, k, v, causal=True, window=16, softcap=30.0, backend=backend)
        return torch.autograd.grad(torch.sum(out * ct), (q, k, v))

    reset_launch_counts()
    got = grads("cuda")
    counts = launch_counts()
    assert (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"], counts["flash_attention_bwd_dkv"]) == (1, 1, 1)
    for a, r in zip(got, grads("ref")):
        _close(a, r)


def test_full_width_training_step_on_card(device):
    """One bf16 AdamW step of smollm-135m at full width (30 layers, batch 2,
    seq 128) through the attention kernels: 30 launches of each, a finite
    loss near log(V), finite parameters that moved."""
    import math

    from repro_torch.config.registry import get_arch
    from repro_torch.config.train import TrainConfig
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.models.transformer import init_lm
    from repro_torch.runtime.steps import make_train_step

    cfg = get_arch("smollm-135m")
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0))
    step = make_train_step(cfg, TrainConfig(optimizer="adamw", learning_rate=1e-3))
    opt_state = step.optimizer.init(params)
    data = make_token_stream(0, cfg.vocab_size, 2, 128)
    batch = {n: torch.as_tensor(a, device=device) for n, a in data.items()}
    before = params["layers"][0]["attn"]["wq"].clone()
    reset_launch_counts()
    params, opt_state, metrics = step(params, opt_state, batch, 0)
    torch.cuda.synchronize()
    counts = launch_counts()
    kernels = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    assert all(counts[n] == cfg.num_layers for n in kernels)
    # bf16 activations: the forward and both backward passes ran on the tensor cores
    assert counts["flash_attention_fwd_sm90"] == counts["flash_attention_bwd_dkv_sm90"] == cfg.num_layers
    assert counts["flash_attention_bwd_dq_sm90"] == cfg.num_layers
    loss = float(metrics["loss"])
    assert math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 1.0
    wq = params["layers"][0]["attn"]["wq"]
    assert torch.isfinite(wq).all() and not torch.equal(wq, before)


def _decode_inputs(b, h, kh, hd, ps, w, window, dtype, device, seed=0, pos=None, max_pos=None):
    """Each row owns the pages covering its positions; the rest of its table
    points at a scratch page holding NaN. ``pos`` fixes the positions;
    otherwise they are drawn below ``max_pos`` (default W·ps), row 0 at 0."""
    g = torch.Generator().manual_seed(seed)
    n_pages = b * w + 1
    kp = torch.randn((n_pages, ps, kh, hd), generator=g)
    vp = torch.randn((n_pages, ps, kh, hd), generator=g)
    kp[-1] = float("nan")
    vp[-1] = float("nan")
    cl = min(window, w * ps) if window else w * ps
    if pos is None:
        pos = torch.randint(0, max_pos or w * ps, (b,), generator=g, dtype=torch.int32)
        pos[0] = 0
    else:
        pos = torch.tensor(pos, dtype=torch.int32)
    table = torch.full((b, w), n_pages - 1, dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=g).to(torch.int32)
    for r in range(b):
        live = -(-min(int(pos[r]) + 1, cl) // ps)
        table[r, :live] = perm[r * w : r * w + live]
    q = torch.randn((b, h, hd), generator=g)
    to = lambda t: t.to(dtype).to(device) if t.is_floating_point() else t.to(device)
    return to(q), to(kp), to(vp), to(table), to(pos), dict(window=window, cache_len=cl)


# (B, H, KH, hd, page size, table width): the smollm-135m serving shape, a
# small one with hd 32, and hd 128 with 64-token pages
DECODE_SHAPES = [(8, 9, 3, 64, 16, 12), (3, 4, 2, 32, 8, 5), (2, 8, 8, 128, 64, 3)]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 30.0), (24, 0.0)])
def test_flash_decode_kernel_matches_plain(device, shape, dtype, window, softcap):
    q, kp, vp, table, pos, kw = _decode_inputs(*shape, window, dtype, device)
    reset_launch_counts()
    out = flash_decode_fwd(q, kp, vp, table, pos, softcap=softcap, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["flash_decode"] == 1
    assert out.dtype == dtype
    _close(out, flash_decode_ref(q, kp, vp, table, pos, softcap=softcap, **kw))
    assert torch.equal(flash_decode_fwd(q, kp, vp, table, pos, softcap=softcap, **kw), out)  # no atomics


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 30.0), (40, 0.0)])
@pytest.mark.parametrize("case", ["ragged", "wide table"])
def test_flash_decode_splits_match_plain(device, dtype, window, softcap, case):
    """The split kernel and its combine: ragged positions from 0 up to the
    last slot of the table (rows with one live page beside full ones, so
    some splits are empty), and a table far wider than the live pages
    (max_seq much larger than the positions reached). A second call gives
    the same bits."""
    b, h, kh, hd, ps = 8, 9, 3, 64, 16
    if case == "ragged":
        w = 12
        pos = [i * (w * ps - 1) // (b - 1) for i in range(b)]
        q, kp, vp, table, pos, kw = _decode_inputs(b, h, kh, hd, ps, w, window, dtype, device, seed=3, pos=pos)
    else:
        q, kp, vp, table, pos, kw = _decode_inputs(b, h, kh, hd, ps, 256, window, dtype, device, seed=4, max_pos=100)
    out = flash_decode_fwd(q, kp, vp, table, pos, softcap=softcap, **kw)
    _close(out, flash_decode_ref(q, kp, vp, table, pos, softcap=softcap, **kw))
    assert torch.equal(flash_decode_fwd(q, kp, vp, table, pos, softcap=softcap, **kw), out)


def test_engine_on_card_launches_kernels_and_layouts_agree(device):
    """A reduced f32 model served on the card: both attention kernels
    launch, and the paged engine's greedy tokens equal the static
    dense-SDPA path's."""
    import numpy as np

    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine, static_generate

    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32")
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0))
    params["embed"]["table"] *= 10.0  # wide logit margins for greedy parity
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 24, 13, 17)]
    reset_launch_counts()
    eng = ServeEngine(cfg, params, EngineConfig(max_slots=2, max_seq=32, max_new=8, decode_chunk=4, page_size=8))
    comps = ContinuousScheduler(eng, clock=ManualClock()).run(
        [Request(rid=i, tokens=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    )
    counts = launch_counts()
    assert counts["flash_attention_fwd"] > 0 and counts["flash_decode"] > 0
    for c, p in zip(comps, prompts):
        want = static_generate(params, cfg, {"tokens": torch.as_tensor(p[None], device=device)}, 8, max_seq=32)
        np.testing.assert_array_equal(c.tokens, want[0].cpu().numpy())


def test_attention_wrappers_reject_bad_inputs(device):
    q, k, v = _attn_inputs(1, 8, 8, 4, 2, 48, torch.float32, device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, k, v)
    q, k, v = _attn_inputs(1, 8, 8, 4, 2, 32, torch.float32, device)
    with pytest.raises(ValueError, match="share"):
        flash_attention_fwd(q, k.bfloat16(), v)
    out, lse = flash_attention_fwd(q, k, v)
    delta = attention_delta(out, q)
    with pytest.raises(ValueError, match="dout must match q"):
        flash_attention_bwd_dq(q, k, v, q.bfloat16(), lse, delta)
    with pytest.raises(ValueError, match="float32"):
        flash_attention_bwd_dkv(q, k, v, q, lse.bfloat16(), delta)
    qd, kp, vp, table, pos, kw = _decode_inputs(2, 4, 2, 32, 8, 3, 0, torch.float32, device)
    with pytest.raises(ValueError, match="int32"):
        flash_decode_fwd(qd, kp, vp, table.long(), pos, **kw)
