"""The port's kernels on the GPU (the loss kernels: CUDA C++ forwards, and
backwards that compute only the wanted cotangents; the CUDA C++
attention kernels, forward and both backward passes: the tensor-core
kernels for bf16, the CUDA-core kernels for f32; split-KV paged decode),
against their plain PyTorch versions on the same inputs, a second call
bitwise equal, one full-width training step, one small epoch of each
distilling Table 1 baseline, the grouped client bank against the looped
ensemble, a paged decode run that telemetry adds no device sync to, the
prefix cache with speculative decoding on hot-prefix traffic, and the MoE
dispatches, qk-norm prefill, ``remat``, the recurrent archs' engine
(jamba through #5/#8 against the plain attention) and the modality archs
(hubert at hd 80, phi with its prefix at hd 96), and on a world of one the
loss kernels on a sharded client stack and the cross-mesh serving pair.
These tests need a CUDA device (marker
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
        pytest.skip("needs a CUDA device: the CUDA C++ kernels run only on the card")
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


# (K, B, V) beyond SHAPES for the forwards: one row of an LM vocabulary
# (split across the card), V=1, one block owning each of many rows, more
# rows than resident blocks in both the block and the lane-group layouts
FWD_SHAPES = [(5, 1, 151936), (2, 1, 1), (3, 7, 1), (4, 300, 2048), (2, 600, 1500), (2, 20000, 10)]


def _fwd_match(cl, st, w, labels):
    for temperature in (1.0, 4.0):
        for got, ref in zip(ensemble_kl_fwd(cl, st, w, temperature), ensemble_kl_fwd_ref(cl, st, w, temperature)):
            _close(got, ref)
    for weighted in (True, False):
        for lab in (labels, labels.int()):
            for got, ref in zip(ghm_ce_fwd(cl, lab, w, weighted), ghm_ce_fwd_ref(cl, labels, w, weighted)):
                _close(got, ref)


@pytest.mark.parametrize("k,b,v", FWD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_fwd_more_shapes_match_plain(device, k, b, v, dtype):
    """Both forwards, in every mode and with int32 and int64 labels, one
    launch each."""
    cl, st, w, labels, _ = _inputs(k, b, v, dtype, device, seed=3)
    reset_launch_counts()
    _fwd_match(cl, st, w, labels)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["ensemble_kl_fwd"] == 2 and counts["ghm_ce_fwd"] == 4


@pytest.mark.parametrize("k,b,v", [(5, 128, 16), (5, 37, 32000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_fwd_unaligned_planes_match_plain(device, k, b, v, dtype):
    """Logits that start one element off a 16-byte boundary, at a V whose
    rows would otherwise take 16-byte accesses: the single-element path, in
    the lane-group layout and in split rows."""
    from repro_torch.kernels.build import loss_fwd_geometry

    g = torch.Generator().manual_seed(4)
    cl = (torch.randn(k * b * v + 1, generator=g) * 2).to(dtype).to(device)[1:].view(k, b, v)
    st = (torch.randn(b * v + 1, generator=g) * 2).to(dtype).to(device)[1:].view(b, v)
    assert loss_fwd_geometry(b, v, cl.element_size(), True).vec > 1
    assert loss_fwd_geometry(b, v, cl.element_size(), cl.data_ptr() % 16 == 0).vec == 1
    w = torch.softmax(torch.randn(k, generator=g), 0).to(device)
    labels = torch.randint(0, v, (b,), generator=g).to(device)
    _fwd_match(cl, st, w, labels)


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
    bits, g_w included, and so does a second call of each forward, whose
    rows are split across blocks there."""
    from repro_torch.kernels.build import loss_bwd_geometry, loss_fwd_geometry

    assert loss_bwd_geometry(b * v, 4, True)[0] > 100
    assert loss_fwd_geometry(b, v, 4, True).splits > 1
    args = _kl_case(k, b, v, dtype, device)
    cl, st, w, labels = args[0], args[1], args[2], _inputs(k, b, v, dtype, device)[3]
    for fn in (lambda: ensemble_kl_fwd(cl, st, w, 4.0), lambda: ghm_ce_fwd(cl, labels, w, True)):
        first = fn()
        assert all(torch.equal(x, y) for x, y in zip(first, fn()))
    first = ensemble_kl_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(first, ensemble_kl_bwd(*args)))
    ce = _ce_case(k, b, v, dtype, device, True)
    first = ghm_ce_bwd(*ce, True, False)
    assert all(torch.equal(x, y) for x, y in zip(first, ghm_ce_bwd(*ce, True, False)))


def test_loss_bwd_ticket_left_at_zero(device):
    """A many-block call, then a one-block call, then the many-block call
    again, the forwards' split rows between them: all right, so each
    launch left the shared ticket at 0, and it reads 0 at the end."""
    from repro_torch.kernels.build import loss_scratch

    wide = _ce_case(5, 37, 32003, torch.float32, device)
    main = _ce_case(5, 128, 10, torch.float32, device)
    kl = _kl_case(5, 37, 32003, torch.float32, device)
    labels = wide[1]
    for args in (wide, main, wide, main, wide):
        got = ghm_ce_bwd(*args, False, False, needs=(False, True))[1]
        _close(got, ghm_ce_bwd_ref(*args, False, False)[1])
        got = ensemble_kl_bwd(*kl, needs=(False, False, True))[2]
        _close(got, ensemble_kl_bwd_ref(*kl)[2])
        for a, r in zip(ensemble_kl_fwd(*kl[:3], 4.0), ensemble_kl_fwd_ref(*kl[:3], 4.0)):
            _close(a, r)
        for a, r in zip(ghm_ce_fwd(kl[0], labels, kl[2], True), ghm_ce_fwd_ref(kl[0], labels, kl[2], True)):
            _close(a, r)
    torch.cuda.synchronize()
    assert int(loss_scratch(device, 0)[1].item()) == 0


@pytest.mark.parametrize("k,b,v", [(5, 128, 10), (5, 37, 32003), (5, 1, 151936)])
def test_loss_bwd_cuda_graph_replay_equals_eager(device, k, b, v):
    """A captured call of each loss kernel, replayed, gives the eager
    call's bits: the scratch exists before the capture and the ticket is
    back at 0 after every launch (the forwards split their rows at the
    last two shapes)."""
    kl = _kl_case(k, b, v, torch.float32, device)
    ce = _ce_case(k, b, v, torch.float32, device, True)

    def calls():
        return (*ensemble_kl_fwd(*kl[:3], 4.0), *ensemble_kl_bwd(*kl), *ghm_ce_fwd(*ce[:3], True),
                *ghm_ce_bwd(*ce, True, True))

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
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
# (B, Sq, Sk, H, KH, hd): the smollm-135m prefill shape, a tail at hd 32,
# Sq > Sk at hd 128; hd 80 (hubert-xlarge) with a tail that is not a
# multiple of 64 and a GQA group of 1, hd 96 (phi-3-vision-4.2b) with
# Sq > Sk and a group of 4
ATTN_SHAPES = [(2, 128, 128, 9, 3, 64), (2, 37, 37, 4, 2, 32), (1, 70, 33, 4, 1, 128), (1, 100, 100, 16, 16, 80),
               (2, 70, 45, 8, 2, 96)]


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
BWD_SHAPES = [(2, 256, 256, 9, 3, 64), (2, 37, 37, 4, 2, 32), (1, 70, 33, 4, 1, 128), (2, 20, 45, 8, 1, 64),
              (1, 100, 100, 16, 16, 80), (2, 70, 45, 8, 2, 96)]
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
    seq 128) through the attention kernels, under ``remat`` (the config's
    default): the forward launches twice a layer (the forward and its
    recompute in the backward pass), each backward pass once; a finite
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
    assert cfg.remat
    assert counts["flash_attention_fwd"] == 2 * cfg.num_layers
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == cfg.num_layers
    # bf16 activations: the forward and both backward passes ran on the tensor cores
    assert counts["flash_attention_fwd_sm90"] == 2 * cfg.num_layers
    assert counts["flash_attention_bwd_dkv_sm90"] == counts["flash_attention_bwd_dq_sm90"] == cfg.num_layers
    loss = float(metrics["loss"])
    assert math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 1.0
    wq = params["layers"][0]["attn"]["wq"]
    assert torch.isfinite(wq).all() and not torch.equal(wq, before)


@pytest.mark.parametrize("method", ["dense", "f_dafl", "f_adi", "feddf"])
def test_baseline_epoch_kernels_match_plain_and_launch_once_a_step(device, method):
    """One epoch of a distilling baseline at a small size (3 cnn5 clients,
    16×16×3, 4 classes, batch 16, 2 ring slots; FedDF on 3 real batches)
    through the kernels (backend "cuda") stays within 1e-5 of plain
    autograd (backend "ref") on the server parameters, from the same
    parameters and draws; ``ensemble_kl`` launches its forward and its
    backward once per distillation step, ``ghm_ce`` never. cuDNN is held to
    its deterministic algorithms, so that only the loss kernels differ."""
    import dataclasses
    from functools import partial

    from repro_torch.config.train import OFLConfig
    from repro_torch.core.baselines import run_adi_baseline, run_feddf, run_generator_baseline
    from repro_torch.models.cnn import cnn_apply, init_cnn
    from repro_torch.models.generator import image_generator, init_image_generator
    from repro_torch.utils.prng import Draws
    from repro_torch.utils.trees import flatten_dict

    classes, shape, k, batch = 4, (16, 16, 3), 3, 16
    g = torch.Generator(device=device).manual_seed(0)
    clients = [init_cnn(g, "cnn5", classes, shape) for _ in range(k)]
    server = init_cnn(g, "cnn5", classes, shape)
    gen0 = init_image_generator(g, 8, classes, shape)
    val_x = torch.rand((3 * batch, *shape), generator=g, device=device) * 2 - 1
    apply = partial(cnn_apply, "cnn5")
    cfg = OFLConfig(num_clients=k, epochs=1, gen_iters=3, batch_size=batch, latent_dim=8, buffer_batches=2)
    steps = 3 if method == "feddf" else 1
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        servers = {}
        for backend in ("cuda", "ref"):
            c = dataclasses.replace(cfg, backend=backend)
            draws = Draws(1, device)
            reset_launch_counts()
            if method == "f_adi":
                st = run_adi_baseline([apply] * k, clients, apply, server, shape, c, classes, draws)
            elif method == "feddf":
                st = run_feddf([apply] * k, clients, apply, server, val_x, c, draws)
            else:
                st = run_generator_baseline(
                    method, [apply] * k, clients, apply, server, lambda p, z, y: image_generator(p, z, y, shape),
                    gen0, c, classes, draws,
                )
            torch.cuda.synchronize()
            counts = launch_counts()
            want = steps if backend == "cuda" else 0
            assert (counts["ensemble_kl_fwd"], counts["ensemble_kl_bwd"]) == (want, want), counts
            assert counts["ghm_ce_fwd"] == counts["ghm_ce_bwd"] == 0, counts
            servers[backend] = flatten_dict(st.server_params)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for p, want in servers["ref"].items():
        if torch.is_tensor(want):
            got = servers["cuda"][p]
            assert torch.isfinite(got).all(), p
            assert float((got - want).abs().max()) <= 1e-5, (p, float((got - want).abs().max()))
        else:
            assert servers["cuda"][p] == want


def test_client_bank_on_card_matches_looped_and_launches_as_looped(device):
    """The grouped client bank on the card: on Table 3's five families (two
    clients each, 16×16×3, batch 32) its f32 stack stays within 1e-4 of
    the looped one and, in float64, its input gradient within 1e-10 of the
    looped one, relative to the largest value (in f32 ReLU and max-pool
    make the input gradient jump where rounding moves a kink, with either
    engine); one small
    Co-Boosting epoch (cnn5, mlp, cnn5; batch 16, 3 generator steps)
    launches each loss kernel as often with either engine, to finite
    losses, with the ensembling weights on the simplex."""
    from functools import partial

    from repro_torch.config.train import OFLConfig
    from repro_torch.core.client_bank import make_ensemble
    from repro_torch.core.coboosting import run_coboosting
    from repro_torch.models.cnn import cnn_apply, init_cnn
    from repro_torch.models.generator import image_generator, init_image_generator
    from repro_torch.utils.prng import Draws
    from repro_torch.utils.trees import tree_map

    classes, shape = 4, (16, 16, 3)
    g = torch.Generator(device=device).manual_seed(0)
    archs = ["cnn5", "cnn2", "miniresnet", "mlp", "lenet5"] * 2
    applies = [partial(cnn_apply, a) for a in archs]
    params = [init_cnn(g, a, classes, shape) for a in archs]
    x = torch.rand((32, *shape), generator=g, device=device) * 2 - 1
    u = torch.rand((len(archs), 32, classes), generator=g, device=device) * 2 - 1
    params64 = [tree_map(torch.Tensor.double, p) for p in params]
    out = {}
    for impl in ("looped", "grouped"):
        for prec, ps, xs in (("f32", params, x), ("f64", params64, x.double())):
            fn, p = make_ensemble(applies, ps, impl=impl)
            xi = xs.clone().requires_grad_()
            la = fn(p, xi)
            (gx,) = torch.autograd.grad(torch.sum(la * u), xi)
            assert torch.isfinite(la).all() and torch.isfinite(gx).all()
            out[impl, prec] = (la.detach(), gx)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    assert rel(out["grouped", "f32"][0], out["looped", "f32"][0]) <= 1e-4
    assert rel(out["grouped", "f64"][1], out["looped", "f64"][1]) <= 1e-10

    archs = ["cnn5", "mlp", "cnn5"]
    clients = [init_cnn(g, a, classes, shape) for a in archs]
    server = init_cnn(g, "cnn5", classes, shape)
    gen0 = init_image_generator(g, 8, classes, shape)
    launches = {}
    for impl in ("looped", "grouped"):
        cfg = OFLConfig(num_clients=3, epochs=1, gen_iters=3, batch_size=16, latent_dim=8, buffer_batches=2,
                        ensemble_impl=impl)
        reset_launch_counts()
        st = run_coboosting(
            [partial(cnn_apply, a) for a in archs], clients, partial(cnn_apply, "cnn5"), server,
            lambda p, z, y: image_generator(p, z, y, shape), gen0, cfg, classes, Draws(1, device),
        )
        torch.cuda.synchronize()
        launches[impl] = {n: launch_counts()[n] for n in ("ensemble_kl_fwd", "ensemble_kl_bwd", "ghm_ce_fwd", "ghm_ce_bwd")}
        assert torch.isfinite(st.buffer.x).all() and abs(float(st.weights.sum()) - 1.0) < 1e-5
    assert launches["grouped"] == launches["looped"] and min(launches["looped"].values()) > 0, launches


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
# small one with hd 32, hd 128 with 64-token pages, hd 80 with one query
# head a kv head, and hd 96 with 4 (their key rows are 10 and 12 pieces of
# 16 bytes in bf16, 20 and 24 in f32: not a power of two)
DECODE_SHAPES = [(8, 9, 3, 64, 16, 12), (3, 4, 2, 32, 8, 5), (2, 8, 8, 128, 64, 3), (4, 16, 16, 80, 16, 6),
                 (3, 8, 2, 96, 8, 5)]


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


def test_prefix_spec_engine_on_card_matches_static(device):
    """A reduced f32 model on hot-prefix traffic through the prefix cache
    and speculative decoding (the target drafting itself): its greedy
    tokens equal the static dense-SDPA path's, admissions splice, the
    prefill kernel launches once a layer for every prefill of the target
    and of the drafter, and paged decode never launches (verify runs
    through ``lm_extend``)."""
    import numpy as np

    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import (
        ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine, hot_prefix_stream, static_generate,
    )

    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32")
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0))
    params["embed"]["table"] *= 10.0  # wide logit margins for greedy parity
    prompts, _ = hot_prefix_stream(cfg.vocab_size, 6, 24, 8, seed=1, budget_min=1, shared_fraction=0.5)
    eng = ServeEngine(
        cfg, params,
        EngineConfig(max_slots=2, max_seq=32, max_new=8, decode_chunk=4, page_size=8, prefix_cache=True, spec_k=3),
        drafter=(cfg, params),
    )
    sched = ContinuousScheduler(eng, clock=ManualClock(tick=0.2))
    reqs = [Request(rid=i, tokens=p, max_new_tokens=8, arrival=2.0 * i) for i, p in enumerate(prompts)]
    reset_launch_counts()
    comps = sched.run(reqs)
    counts = launch_counts()
    st = eng.stats
    assert st["spliced_admissions"] > 0 and st["spec_steps"] > 0
    assert counts["flash_attention_fwd"] == cfg.num_layers * (st["prefill_dispatches"] + eng.spec.prefill_dispatches) > 0
    assert counts["flash_decode"] == 0
    for c, p in zip(comps, prompts):
        want = static_generate(params, cfg, {"tokens": torch.as_tensor(p[None], device=device)}, 8, max_seq=32)
        np.testing.assert_array_equal(c.tokens, want[0].cpu().numpy())


def test_telemetry_adds_no_sync_to_paged_decode(device):
    """Under ``torch.cuda.set_sync_debug_mode("warn")``, a paged decode run
    with telemetry on (the shared registry and the span tracer) raises
    exactly as many sync warnings as the same run with it off: the spans
    and counters read no device value."""
    import warnings

    import numpy as np

    from repro_torch import obs
    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine

    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32")
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 24, 13, 17)]
    ecfg = EngineConfig(max_slots=2, max_seq=32, max_new=8, decode_chunk=4, page_size=8)

    def run(registry=None, debug=True):
        eng = ServeEngine(cfg, params, ecfg, registry=registry)
        reqs = [Request(rid=i, tokens=p, max_new_tokens=8) for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn" if debug else "default")
            try:
                ContinuousScheduler(eng, clock=ManualClock()).run(reqs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return eng, sum("synchroniz" in str(w.message) for w in caught)

    run(debug=False)  # builds the kernels
    try:
        eng_off, syncs_off = run()
        obs.configure(metrics=True, trace=True, device=device)
        eng_on, syncs_on = run(registry=obs.registry())
        stats_on = dict(eng_on.stats)  # read before the shared registry is reset
        assert len(obs.tracer()) > 0
    finally:
        obs.configure(metrics=False, trace=False)
        obs.tracer().clear()
        obs.registry().reset()
    assert syncs_off >= eng_off.stats["host_syncs"] > 0
    assert syncs_on == syncs_off
    assert stats_on == dict(eng_off.stats)


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


# ---------------------------------------------------------------------------
# the rest of serving: new attention shapes, the disaggregated pair, the fleet

# (B, S, H, KH, hd) of the two dense configs the port serves besides
# smollm-135m: granite-3-2b (a GQA group of 4) and internlm2-20b (6, hd 128)
ARCH_HEADS = {"granite-3-2b": (32, 8, 64), "internlm2-20b": (48, 8, 128)}


@pytest.mark.parametrize("arch", list(ARCH_HEADS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_kernels_at_new_arch_shapes(device, arch, dtype):
    """#5 (causal prefill, 8 prompts x 128 tokens) and #8 (8 slots, 16-token
    pages, ragged positions) at the attention shapes of granite-3-2b and
    internlm2-20b, against their plain versions; a second call gives the
    same bits."""
    h, kh, hd = ARCH_HEADS[arch]
    q, k, v = _attn_inputs(8, 128, 128, h, kh, hd, dtype, device, seed=7)
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_fwd_sm90"] == int(dtype == torch.bfloat16)
    want_o, want_lse = flash_attention_ref_lse(q, k, v, causal=True)
    _close(out, want_o)
    _close(lse, want_lse)
    assert torch.equal(flash_attention_fwd(q, k, v, causal=True)[0], out)
    w = 12
    pos = [i * (w * 16 - 1) // 7 for i in range(8)]
    qd, kp, vp, table, posd, kw = _decode_inputs(8, h, kh, hd, 16, w, 0, dtype, device, seed=8, pos=pos)
    got = flash_decode_fwd(qd, kp, vp, table, posd, **kw)
    _close(got, flash_decode_ref(qd, kp, vp, table, posd, **kw))
    assert torch.equal(flash_decode_fwd(qd, kp, vp, table, posd, **kw), got)


def _served_model(device):
    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm

    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32")
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0))
    params["embed"]["table"] *= 10.0  # wide logit margins for greedy parity
    return cfg, params


def test_disagg_pair_prefill_on_cpu_decode_on_card(device):
    """The one real cross-device handoff one card can show: the prefill
    worker on the CPU (its own copy of the parameters, the plain forward),
    the decode worker on the card; every admission's sealed pages cross
    under ``serve.handoff``. Greedy tokens equal the colocated engine's, and
    prefill never launches #5 while decode launches #8."""
    import numpy as np

    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine

    cfg, params = _served_model(device)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, tokens=rng.randint(0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=8,
                    arrival=0.5 * i) for i, n in enumerate((9, 24, 13, 17, 20))]
    ecfg = EngineConfig(max_slots=2, max_seq=32, max_new=8, decode_chunk=4, page_size=8)
    out = {}
    for name, kw in (("colocated", {}), ("pair", dict(prefill_device="cpu"))):
        eng = ServeEngine(cfg, params, ecfg, **kw)
        reset_launch_counts()
        comps = ContinuousScheduler(eng, clock=ManualClock(tick=0.2)).run(reqs)
        out[name] = ({c.rid: c.tokens.tolist() for c in comps}, dict(eng.stats), launch_counts())
    pair = ServeEngine(cfg, params, ecfg, prefill_device="cpu")
    assert pair.prefill.device.type == "cpu" and pair.decode.device.type == "cuda"
    assert out["pair"][0] == out["colocated"][0]
    assert out["pair"][1] == out["colocated"][1] and out["pair"][1]["handoffs"] > 0
    assert out["pair"][2]["flash_attention_fwd"] == 0 and out["pair"][2]["flash_decode"] > 0
    assert out["colocated"][2]["flash_attention_fwd"] == cfg.num_layers * out["colocated"][1]["prefill_dispatches"]


def test_fleet_on_card_matches_single_engine_and_its_launches(device):
    """Two colocated replicas, one slot each, on pairs of requests
    arriving together: the fleet spreads them, and its
    f32 tokens equal one engine's; each request prefills and decodes alone
    in both, so #5 and #8 launch as often in the fleet as in the single
    engine, once a layer for every prefill dispatch and decode step."""
    import numpy as np

    from repro_torch.serve import ContinuousScheduler, EngineConfig, FleetRouter, ManualClock, Request, ServeEngine
    from repro_torch.serve.engine import DecodeWorker

    cfg, params = _served_model(device)
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, tokens=rng.randint(0, cfg.vocab_size, size=8 + 3 * i).astype(np.int32),
                    max_new_tokens=4 + i % 3, arrival=10.0 * (i // 2)) for i in range(6)]
    kw = dict(max_slots=1, max_seq=32, max_new=8, decode_chunk=4, page_size=8)
    steps = []
    chunk = DecodeWorker._chunk

    def counted(self, n):
        steps.append(n)
        return chunk(self, n)

    DecodeWorker._chunk = counted
    try:
        runs = {}
        for name in ("single", "fleet"):
            engines = [ServeEngine(cfg, params, EngineConfig(**kw), replica=i)
                       for i in range(1 if name == "single" else 2)]
            sched = ContinuousScheduler(engines[0], clock=ManualClock(tick=0.2)) if name == "single" else \
                FleetRouter(engines, clock=ManualClock(tick=0.2))
            steps.clear()
            reset_launch_counts()
            comps = sched.run(reqs)
            counts = launch_counts()
            dispatches = sum(e.stats["prefill_dispatches"] for e in engines)
            runs[name] = ({c.rid: c.tokens.tolist() for c in comps}, {c.replica for c in comps},
                          counts["flash_attention_fwd"], counts["flash_decode"], dispatches, sum(steps))
    finally:
        DecodeWorker._chunk = chunk
    single, fleet = runs["single"], runs["fleet"]
    assert fleet[0] == single[0] and fleet[1] == {0, 1}
    assert fleet[2:4] == single[2:4]
    assert fleet[2] == cfg.num_layers * fleet[4] > 0 and fleet[3] == cfg.num_layers * fleet[5] > 0


# ---------------------------------------------------------------------------
# MoE and qk-norm decoders, remat


def _moe_case(device, dtype, factor, seed=0):
    """A mixtral-shaped MoE layer at a narrower width (8 experts, top 2,
    d 512, f 1024) on a prefill-shaped input of 8 x 128 tokens, one group."""
    from repro_torch.config.model import ModelConfig
    from repro_torch.models.moe import init_moe

    cfg = ModelConfig(name="moe-card", family="moe", d_model=512, d_ff=1024, num_experts=8, experts_per_token=2,
                      moe_capacity_factor=factor, dtype="float32")
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_moe(g, cfg, dtype)
    params["router"] *= 4.0  # spread the router's choices
    x = torch.randn((8, 128, 512), generator=g, device=device).to(dtype)
    return cfg, params, x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("factor", [0.5, 1.25, 4.0], ids=["tight", "mixtral", "ample"])
def test_moe_dispatches_agree_on_card(device, dtype, factor):
    """einsum and scatter dispatch drop the same slots and agree; at the
    ample factor (E / k: nothing drops) both equal the dense oracle; a
    second scatter call gives the same bits (each kept capacity row is
    written by one token-slot)."""
    from repro_torch.models.moe import _capacity, moe_apply_einsum, moe_apply_scatter, moe_ref

    cfg, params, x = _moe_case(device, dtype, factor)
    with torch.no_grad():
        y_e, aux_e = moe_apply_einsum(params, x, cfg)
        y_s, aux_s = moe_apply_scatter(params, x, cfg)
        assert y_e.dtype == y_s.dtype == dtype
        _close(y_s, y_e)
        assert torch.equal(aux_e, aux_s)
        assert torch.equal(moe_apply_scatter(params, x, cfg)[0], y_s)
        if factor == 4.0:
            assert _capacity(cfg, 8 * 128) >= 8 * 128
            y_r, aux_r = moe_ref(params, x, cfg)
            _close(y_e, y_r)
            _close(y_s, y_r)
            assert torch.equal(aux_r, aux_e)


@pytest.mark.parametrize("dtype", DTYPES)
def test_qk_norm_prefill_through_kernel_matches_plain(device, dtype):
    """qk-norm attention prefill at qwen3-moe-235b-a22b's heads (64 over 4,
    hd 128; d_model 4096), 2 prompts x 128 tokens: #5 against the plain
    attention, the output and the cached (normed, rotated) K."""
    from repro_torch.config.registry import get_arch
    from repro_torch.models.attention import attn_prefill, init_attention, init_cache

    cfg = get_arch("qwen3-moe-235b-a22b").replace(dtype="float32")
    assert cfg.qk_norm and (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_) == (64, 4, 128)
    g = torch.Generator(device=device).manual_seed(3)
    params = {n: w.to(dtype) for n, w in init_attention(g, cfg, torch.float32).items()}
    params["q_norm"] = params["q_norm"] + torch.randn((128,), generator=g, device=device).to(dtype) * 0.3
    params["k_norm"] = params["k_norm"] + torch.randn((128,), generator=g, device=device).to(dtype) * 0.3
    x = torch.randn((2, 128, cfg.d_model), generator=g, device=device).to(dtype)
    outs = {}
    for backend in ("cuda", "ref"):
        c = cfg.replace(backend=backend)
        cache = init_cache(c, 2, 128, dtype, device)
        reset_launch_counts()
        with torch.no_grad():
            out, cache = attn_prefill(params, x, c, cache)
        torch.cuda.synchronize()
        outs[backend] = (out, cache["k"], launch_counts()["flash_attention_fwd"])
    assert outs["cuda"][2] == 1 and outs["ref"][2] == 0
    _close(outs["cuda"][0], outs["ref"][0])
    assert torch.equal(outs["cuda"][1], outs["ref"][1])  # the same normed K on both paths


def test_remat_step_equals_plain_step_on_card(device):
    """One f32 ``lm_loss`` step of a reduced mixtral-8x7b (2 layers, 4
    experts, window 64), batch 2 x 128, with ``remat`` against without:
    the same loss bits, every gradient within 1e-6 of its leaf's largest;
    #5 launches twice a layer under remat (forward and recompute), once
    without; #6 and #7 once a layer either way."""
    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.utils.trees import flatten_dict, value_and_grad

    cfg = reduced_variant(get_arch("mixtral-8x7b")).replace(dtype="float32", param_dtype="float32")
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0))
    batch = {n: torch.as_tensor(a, device=device) for n, a in make_token_stream(0, cfg.vocab_size, 2, 128).items()}
    runs = {}
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        reset_launch_counts()
        loss, grads = value_and_grad(lambda p: lm_loss(p, c, batch)[0], params)
        torch.cuda.synchronize()
        counts = launch_counts()
        layers = cfg.num_layers
        assert counts["flash_attention_fwd"] == (2 if remat else 1) * layers
        assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == layers
        runs[remat] = (loss, grads)
    assert torch.equal(runs[True][0], runs[False][0])
    got, want = runs[True][1], runs[False][1]
    pairs = [(f"layers/{i}/{p}", g, flatten_dict(want["layers"][i])[p])
             for i, layer in enumerate(got["layers"]) for p, g in flatten_dict(layer).items()]
    pairs += [(p, g, flatten_dict({k: v for k, v in want.items() if k != "layers"})[p])
              for p, g in flatten_dict({k: v for k, v in got.items() if k != "layers"}).items()]
    for path, g, w in pairs:
        assert torch.isfinite(g).all(), path
        assert float((g - w).abs().max()) <= 1e-6 * max(float(w.abs().max()), 1e-30), path


def test_recurrent_engine_on_card_matches_ref_backend(device):
    """A reduced f32 jamba-v0.1-52b (Mamba, attention at layer 4 of 8, MoE)
    served on the card, paged, on ragged prompts (a recurrent arch prefills
    at each prompt's exact length, so #5 runs unpadded): the same greedy
    tokens through #5/#8 (backend "cuda") as through the plain attention
    (backend "ref"); #5 once for each prefill dispatch (one attention
    layer), #8 every decode step, and never with "ref". A reduced
    xlstm-125m launches neither."""
    import numpy as np

    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine

    ecfg = EngineConfig(max_slots=3, max_seq=48, max_new=8, decode_chunk=4, page_size=8)
    for arch in ("jamba-v0.1-52b", "xlstm-125m"):
        cfg = reduced_variant(get_arch(arch)).replace(dtype="float32", param_dtype="float32")
        params = init_lm(cfg, torch.Generator(device=device).manual_seed(0))
        head = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]["kernel"]
        head *= 10.0  # wide logit margins for greedy parity
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 37, 13, 37, 21)]
        out = {}
        for backend in ("cuda", "ref"):
            eng = ServeEngine(cfg.replace(backend=backend), params, ecfg)
            reset_launch_counts()
            comps = ContinuousScheduler(eng, clock=ManualClock()).run(
                [Request(rid=i, tokens=p, max_new_tokens=8) for i, p in enumerate(prompts)])
            torch.cuda.synchronize()
            counts = launch_counts()
            out[backend] = ({c.rid: c.tokens.tolist() for c in comps}, dict(eng.stats),
                            counts["flash_attention_fwd"], counts["flash_decode"])
        assert out["cuda"][:2] == out["ref"][:2]
        assert out["ref"][2:] == (0, 0)
        if arch == "xlstm-125m":
            assert eng.layout == "dense" and out["cuda"][2:] == (0, 0)
        else:
            assert out["cuda"][2] == out["cuda"][1]["prefill_dispatches"] >= len(set(map(len, prompts)))
            assert out["cuda"][3] > 0


def test_modality_paths_on_card(device):
    """Reduced hubert-xlarge at its head dim 80 (2 heads, non-causal): one
    f32 ``lm_loss`` step through #5-#7 (backend "cuda") against plain
    autograd (backend "ref"), the loss within 1e-5 relative and every
    gradient within 1e-4 of its leaf's largest; #5 once a layer (no remat),
    #6 and #7 once. Reduced phi-3-vision-4.2b at its head dim 96 with its
    seeded prefix: ``static_generate``'s greedy tokens through #5 equal the
    plain route's; #5 once a layer, #8 never (the static path decodes
    densely)."""
    import numpy as np

    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.serve import static_generate
    from repro_torch.utils.trees import tree_leaves, value_and_grad

    f32 = dict(dtype="float32", param_dtype="float32")
    cfg = reduced_variant(get_arch("hubert-xlarge")).replace(num_heads=2, num_kv_heads=2, head_dim=80, **f32)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {"frames": torch.as_tensor(rng.randn(2, 100, cfg.frontend_dim).astype(np.float32), device=device),
             "labels": torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(2, 100)), device=device)}
    out = {}
    for backend in ("cuda", "ref"):
        reset_launch_counts()
        out[backend] = value_and_grad(lambda p: lm_loss(p, cfg.replace(backend=backend), batch)[0], params)
        torch.cuda.synchronize()
        counts = launch_counts()
        n = cfg.num_layers if backend == "cuda" else 0
        assert (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"], counts["flash_attention_bwd_dkv"]) == (n, n, n)
    (loss_k, grads_k), (loss_r, grads_r) = out["cuda"], out["ref"]
    assert abs(float(loss_k) - float(loss_r)) <= 1e-5 * abs(float(loss_r))
    for g, w in zip(tree_leaves(grads_k), tree_leaves(grads_r)):
        assert torch.isfinite(g).all()
        assert float((g - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)

    cfg = reduced_variant(get_arch("phi-3-vision-4.2b")).replace(num_heads=2, num_kv_heads=2, head_dim=96, d_model=192,
                                                                 **f32)
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0))
    params["lm_head"]["kernel"] *= 10.0  # wide logit margins for greedy parity
    prefix = np.random.RandomState(0).randn(2, cfg.num_prefix_tokens, cfg.frontend_dim).astype(np.float32) * 0.02
    batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(2, 24)), device=device),
             "prefix": torch.as_tensor(prefix, device=device)}
    reset_launch_counts()
    got = static_generate(params, cfg.replace(backend="cuda"), batch, 8)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["flash_attention_fwd"], counts["flash_decode"]) == (cfg.num_layers, 0)
    assert torch.equal(got, static_generate(params, cfg.replace(backend="ref"), batch, 8))


@pytest.fixture
def world_of_one(device, tmp_path):
    """A process group of one rank on this card (NCCL), for the mesh
    routes; destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    assert init_distributed(device, init_method=f"file://{tmp_path}/rendezvous") == 1
    yield device
    dist.destroy_process_group()


def test_loss_kernels_on_a_sharded_client_stack(world_of_one):
    """#1–#4 take a client stack that is a DTensor (the grouped bank's
    logits under a mesh) through the row split on local shards: on a 1x1
    mesh each kernel launches once a call, through ``on_local_shards``, and
    the outputs and every cotangent are the plain call's bits."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels.dispatch import LOCAL_MAP_CALLS, reset_local_map_calls
    from repro_torch.sharding.partition import replicated

    device = world_of_one
    mesh = DeviceMesh("cuda", torch.tensor([[0]]), mesh_dim_names=("data", "model"))
    cl, st, w, labels, _ = _inputs(6, 8, 10, torch.float32, device)

    def run(stack_of):
        c, s, ww = (t.clone().requires_grad_() for t in (cl, st, w))
        out = ensemble_kl(stack_of(c), s, ww).sum() + ghm_ce(stack_of(c), labels, ww).sum()
        return (out, *torch.autograd.grad(out, (c, s, ww)))

    want = run(lambda c: c)
    reset_launch_counts()
    reset_local_map_calls()
    got = run(lambda c: replicated(c, mesh))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert all(counts[n] == 1 for n in ("ensemble_kl_fwd", "ensemble_kl_bwd", "ghm_ce_fwd", "ghm_ce_bwd")), counts
    assert LOCAL_MAP_CALLS["ensemble_kl"] == LOCAL_MAP_CALLS["ghm_ce"] == 1, LOCAL_MAP_CALLS
    for g, wnt in zip(got, want):
        assert not hasattr(g, "placements") and torch.equal(g, wnt)


def test_cross_mesh_pair_matches_colocated_engine(world_of_one):
    """``ServeEngine(mesh=d, prefill_mesh=p)`` on two distinct 1x1 meshes:
    every admission hands off across the meshes, and the reduced
    smollm-135m's greedy tokens (f32) are the colocated meshless engine's."""
    import numpy as np
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.config.model import reduced_variant
    from repro_torch.config.registry import get_arch
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import ContinuousScheduler, EngineConfig, ManualClock, Request, ServeEngine

    device = world_of_one
    cfg = reduced_variant(get_arch("smollm-135m")).replace(dtype="float32", param_dtype="float32")
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(1))
    params["embed"]["table"] *= 10.0
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, tokens=rng.randint(0, cfg.vocab_size, 12 + 5 * i).astype(np.int32), max_new_tokens=6)
            for i in range(4)]
    ecfg = EngineConfig(max_slots=2, max_seq=48, max_new=6, page_size=8)

    def run(**kw):
        eng = ServeEngine(cfg, params, ecfg, **kw)
        comps = ContinuousScheduler(eng, clock=ManualClock(tick=0.2)).run(reqs)
        return {c.rid: c.tokens.tolist() for c in comps}, dict(eng.stats)

    want, want_stats = run()
    meshes = [DeviceMesh("cuda", torch.tensor([[0]]), mesh_dim_names=("data", "model")) for _ in range(2)]
    got, stats = run(mesh=meshes[1], prefill_mesh=meshes[0])
    assert got == want
    assert stats == want_stats and stats["handoffs"] > 0
