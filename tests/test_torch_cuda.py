"""The port's Triton kernels on the GPU, against their plain PyTorch
versions on the same inputs. These tests need a CUDA device (marker
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
from repro_torch.kernels.ghm_ce.kernel import ghm_ce_bwd, ghm_ce_fwd
from repro_torch.kernels.ghm_ce.ref import ghm_ce_bwd_ref, ghm_ce_fwd_ref

pytestmark = pytest.mark.cuda

SHAPES = [(5, 128, 10), (3, 5, 33), (5, 37, 32003)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton kernels run only on the card")
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
    same bit for bit on a second run (fixed-order reduction)."""
    cl0, st0, w0, labels, ct = _inputs(5, 128, 10, torch.float32, device, seed=2)

    def grads(backend):
        cl, st, w = (t.clone().requires_grad_() for t in (cl0, st0, w0))
        loss = torch.sum(ensemble_kl(cl, st, w, 4.0, backend=backend) * ct)
        loss = loss + torch.sum(ghm_ce(cl, labels, w, True, backend=backend, stop_difficulty_grad=True) * ct)
        loss.backward()
        return cl.grad, st.grad, w.grad

    reset_launch_counts()
    got = grads("cuda")
    assert launch_counts() == {"ensemble_kl_fwd": 1, "ensemble_kl_bwd": 1, "ghm_ce_fwd": 1, "ghm_ce_bwd": 1}
    for a, r in zip(got, grads("ref")):
        _close(a, r)
    assert torch.equal(grads("cuda")[2], got[2])


def test_wrappers_reject_bad_inputs(device):
    cl, st, w, labels, _ = _inputs(3, 5, 33, torch.float32, device)
    with pytest.raises(ValueError, match="contiguous"):
        ensemble_kl_fwd(cl.transpose(1, 2).contiguous().transpose(1, 2), st, w)
    with pytest.raises(ValueError, match="float32"):
        ghm_ce_fwd(cl, labels, w.double())
    with pytest.raises(ValueError, match="one CUDA device"):
        ghm_ce_fwd(cl, labels.cpu(), w)
