"""The port's flash-attention backward on the CPU against the JAX package:
the plain backward ``flash_attention_bwd_ref`` (the CPU branch of kernels
#6 dq and #7 dk/dv) against the Pallas ``flash_attention_bwd_pallas`` in
interpret mode, fed the same forward residuals, and the op's autograd
backward against ``jax.grad`` of ``flash_attention_ref``. The cases are
those of ``tests/test_kernel_grads.py`` (GQA, MQA, sliding window,
softcap, cross lengths, tails 13/9/20), plus the port's CUDA head dims and
a case with fully-masked rows. Inputs are seeded numpy arrays; tolerance
``|Δ| ≤ 1e-4·(1 + |ref|)`` in f32."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bwd_pallas, flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_attention_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd_ref, flash_attention_ref_lse
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd

pytestmark = pytest.mark.tier1

TOL = 1e-4

# (b, sq, sk, h, kh, hd, causal, window, softcap): the cases of
# tests/test_kernel_grads.py, then the smollm-135m head layout at hd 64 and
# a windowed non-causal case at hd 128
CASES = [
    (2, 16, 16, 4, 2, 32, True, 0, 0.0),
    (1, 13, 13, 3, 3, 16, True, 5, 30.0),
    (2, 9, 24, 4, 1, 8, False, 0, 0.0),
    (1, 20, 20, 2, 2, 64, True, 0, 50.0),
    (1, 33, 33, 9, 3, 64, True, 0, 0.0),
    (1, 21, 30, 2, 1, 128, False, 7, 20.0),
]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) - TOL * (1 + np.abs(want))
    assert err.max() <= 0, f"max excess {err.max():.3e}, max abs diff {np.abs(got - want).max():.3e}"


def _inputs(b, sq, sk, h, kh, hd, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, sq, h, hd), f(b, sk, kh, hd), f(b, sk, kh, hd), f(b, sq, h, hd)


@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal,window,softcap", CASES)
def test_bwd_ref_matches_pallas_bwd(b, sq, sk, h, kh, hd, causal, window, softcap):
    """Both backwards fed the JAX forward kernel's out and lse."""
    q, k, v, dout = _inputs(b, sq, sk, h, kh, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = flash_attention_pallas(q, k, v, interpret=True, return_lse=True, **kw)
    want = flash_attention_bwd_pallas(q, k, v, out, lse, dout, interpret=True, block_q=8, block_kv=8, **kw)
    t = lambda a: torch.from_numpy(np.array(a))
    got = flash_attention_bwd_ref(t(q), t(k), t(v), t(out), t(lse), t(dout), **kw)
    via_wrapper = flash_attention_bwd(t(q), t(k), t(v), t(out), t(lse), t(dout), **kw)  # the CPU branch
    for g, w, g2 in zip(got, want, via_wrapper):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)
        assert torch.equal(g, g2)


@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal,window,softcap", CASES)
def test_op_backward_matches_jax_grad(b, sq, sk, h, kh, hd, causal, window, softcap):
    """The op's autograd backward (forward kernel's residuals, recompute
    from lse) against ``jax.grad`` of the plain reference."""
    q, k, v, dout = _inputs(b, sq, sk, h, kh, hd, seed=1)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax.grad(lambda q, k, v: jnp.vdot(jax_flash_attention_ref(q, k, v, **kw), dout), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, backend="auto", **kw)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(dout)), (tq, tk, tv))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_fully_masked_rows():
    """With a window and Sq > Sk + window, rows past the keys see none of
    them. The port's forward gives those rows out = 0 and lse = 1e30, so
    the recompute's p is exactly 0 there and their dq is 0. Fed those same
    residuals, the Pallas backward agrees on every output; fed its own
    (lse = -1e30 on those rows), it agrees on dq of every other row."""
    b, sq, sk, h, kh, hd = 2, 37, 16, 4, 2, 32
    kw = dict(causal=True, window=8, softcap=0.0)
    q, k, v, dout = _inputs(b, sq, sk, h, kh, hd, seed=3)
    masked = np.arange(sq) - 8 >= sk - 1  # no key k < 16 with k > q - 8
    assert masked.any() and not masked.all()

    t = lambda a: torch.from_numpy(np.array(a))
    out, lse = flash_attention_ref_lse(t(q), t(k), t(v), **kw)
    assert (lse.numpy()[:, masked] == 1e30).all()
    got = flash_attention_bwd_ref(t(q), t(k), t(v), out, lse, t(dout), **kw)
    want = flash_attention_bwd_pallas(q, k, v, out.numpy(), lse.numpy(), dout, interpret=True, block_q=8, block_kv=8, **kw)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    assert (got[0].numpy()[:, masked] == 0).all()

    jout, jlse = flash_attention_pallas(q, k, v, interpret=True, return_lse=True, **kw)
    jdq = np.asarray(flash_attention_bwd_pallas(q, k, v, jout, jlse, dout, interpret=True, block_q=8, block_kv=8, **kw)[0])
    _close(got[0].numpy()[:, ~masked], jdq[:, ~masked])

    # the op's backward on those rows: zero dq, and dk/dv as the plain version
    tq, tk, tv = (t(a).requires_grad_() for a in (q, k, v))
    grads = torch.autograd.grad(torch.sum(flash_attention(tq, tk, tv, backend="auto", **kw) * t(dout)), (tq, tk, tv))
    for g, w in zip(grads, got):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
