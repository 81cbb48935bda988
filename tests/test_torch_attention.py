"""The port's attention ops on the CPU against the JAX package: the plain
flash-attention forward (out and lse) against the Pallas kernel in
interpret mode and ``flash_attention_ref``, the plain paged flash-decode
against its Pallas kernel in interpret mode, and the ops' dispatch and
backward contracts (the backward's parity with JAX is in
``tests/test_torch_attention_grad.py``). The same seeded numpy inputs go into both; tolerance
1e-5 absolute in f32."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_attention_ref
from repro.kernels.flash_decode.kernel import flash_decode_pallas
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref_lse
from repro_torch.kernels.flash_attention.kernel import _pick, attention_variant, flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd

pytestmark = pytest.mark.tier1

TOL = 1e-5


def _qkv(b, sq, sk, h, kh, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, sq, h, hd)).astype(np.float32),
        rng.standard_normal((b, sk, kh, hd)).astype(np.float32),
        rng.standard_normal((b, sk, kh, hd)).astype(np.float32),
    )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_attention_plain_matches_jax(causal, window, softcap):
    q, k, v = _qkv(2, 37, 37, 4, 2, 32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want_o, want_lse = flash_attention_pallas(q, k, v, interpret=True, return_lse=True, **kw)
    want_ref = jax_flash_attention_ref(q, k, v, **kw)
    got_o, got_lse = flash_attention_ref_lse(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_ref), rtol=0, atol=TOL)
    # the wrapper's CPU branch is the plain version
    w_o, w_lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), **kw)
    assert torch.equal(w_o, got_o) and torch.equal(w_lse, got_lse)


def test_flash_attention_fully_masked_rows():
    """With a window and Sq > Sk + window, rows past the keys see none of
    them. The port gives those rows out = 0 and lse = 1e30 (the contract
    the JAX kernel's comment states; the JAX kernel itself returns -1e30
    and a mean of V there); every other row matches JAX."""
    q, k, v = _qkv(2, 37, 16, 4, 2, 32, seed=3)
    kw = dict(causal=True, window=8, softcap=0.0)
    want_o, want_lse = map(np.asarray, flash_attention_pallas(q, k, v, interpret=True, return_lse=True, **kw))
    got_o, got_lse = (t.numpy() for t in flash_attention_ref_lse(*map(torch.from_numpy, (q, k, v)), **kw))
    q_pos = np.arange(37)
    masked = q_pos - 8 >= 16 - 1  # no key k < 16 with k > q - 8
    assert masked.any() and not masked.all()
    np.testing.assert_allclose(got_o[:, ~masked], want_o[:, ~masked], rtol=0, atol=TOL)
    np.testing.assert_allclose(got_lse[:, ~masked], want_lse[:, ~masked], rtol=0, atol=TOL)
    assert (got_o[:, masked] == 0).all()
    assert (got_lse[:, masked] == 1e30).all()


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "sm90"), (torch.float32, "cuda_core")])
def test_attention_variant_by_dtype(dtype, want, hd):
    """The wrappers' choice of kernel: bf16 → the tensor-core kernels of
    ``flash_attention_sm90.cu``, f32 → the CUDA-core kernels."""
    assert attention_variant(dtype, hd) == want
    assert _pick("flash_attention_fwd", torch.zeros((1, 2, 1, hd), dtype=dtype), None) == want


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 48), (torch.float32, 16), (torch.bfloat16, 256), (torch.float16, 64)])
def test_attention_variant_rejects_what_no_kernel_takes(dtype, hd):
    with pytest.raises(ValueError):
        attention_variant(dtype, hd)


def test_attention_variant_override():
    """A caller may name the CUDA-core kernel for bf16 inputs (timing the
    two side by side), never the tensor-core kernel for f32, nor an
    unknown name."""
    bf16, f32 = torch.zeros((1, 2, 1, 64), dtype=torch.bfloat16), torch.zeros((1, 2, 1, 64))
    assert _pick("flash_attention_fwd", bf16, "cuda_core") == "cuda_core"
    assert _pick("flash_attention_fwd", bf16, "sm90") == "sm90"
    for q, variant in ((f32, "sm90"), (bf16, "wgmma")):
        with pytest.raises(ValueError, match="variant"):
            _pick("flash_attention_fwd", q, variant)


def _decode_case(window, softcap, seed):
    """B=3, H=4, KH=2, hd=32, page size 8, table width 5 (extent 40). Each
    row owns the pages covering its positions; the rest of its table points
    at a scratch page holding NaN, which must never reach the output."""
    rng = np.random.default_rng(seed)
    b, h, kh, hd, ps, w = 3, 4, 2, 32, 8, 5
    n_pages = b * w + 1
    scratch = n_pages - 1
    k_pages = rng.standard_normal((n_pages, ps, kh, hd)).astype(np.float32)
    v_pages = rng.standard_normal((n_pages, ps, kh, hd)).astype(np.float32)
    k_pages[scratch] = np.nan
    v_pages[scratch] = np.nan
    cl = min(window, w * ps) if window else w * ps
    pos = np.array([0, 17, 39], np.int32) if not window else np.array([0, 13, 37], np.int32)
    perm = rng.permutation(n_pages - 1)
    table = np.full((b, w), scratch, np.int32)
    for r in range(b):
        live = min(-(-min(pos[r] + 1 if pos[r] < cl else cl, cl) // ps), w)
        table[r, :live] = perm[r * w : r * w + live]
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    return q, k_pages, v_pages, table, pos, dict(window=window, softcap=softcap, cache_len=cl)


@pytest.mark.parametrize(
    "window,softcap", [(0, 0.0), (0, 30.0), (16, 0.0), (16, 30.0)], ids=["full", "softcap", "ring", "ring-softcap"]
)
def test_flash_decode_plain_matches_jax(window, softcap):
    """Dead pages, scratch-page entries, pos = 0 and (window 16) a ring
    that has wrapped (pos 37 ≥ cache_len 16) and one that has not."""
    q, kp, vp, table, pos, kw = _decode_case(window, softcap, seed=window + int(softcap))
    want = np.asarray(flash_decode_pallas(q, kp, vp, table, pos, interpret=True, **kw))
    assert np.isfinite(want).all()
    got = flash_decode_ref(*map(torch.from_numpy, (q, kp, vp, table, pos)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    via_wrapper = flash_decode_fwd(*map(torch.from_numpy, (q, kp, vp, table, pos)), **kw)
    assert torch.equal(via_wrapper, got)


def test_attention_ops_dispatch_and_backward():
    """``auto`` on CPU tensors runs the plain forward through the op, and its
    backward (the plain version of kernels #6/#7, recomputing from the saved
    lse) gives the gradients of ``ref``, which is plain autograd; the
    decode op is inference-only under every backend; ``cuda`` refuses CPU
    tensors."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 9, 9, 4, 2, 32))
    ct = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 9, 4, 32)).astype(np.float32))
    out = flash_attention(q, k, v, backend="auto")
    torch.testing.assert_close(out, flash_attention_ref_lse(q, k, v)[0], rtol=0, atol=0)
    got = torch.autograd.grad(torch.sum(out * ct), (q, k, v))
    want = torch.autograd.grad(torch.sum(flash_attention(q, k, v, backend="ref") * ct), (q, k, v))
    for a, r in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, r, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="requires CUDA tensors"):
        flash_attention(q, k, v, backend="cuda")

    qd, kp, vp, table, pos, kw = _decode_case(0, 0.0, seed=1)
    qd = torch.from_numpy(qd).requires_grad_()
    for backend in ("auto", "ref"):
        o = flash_decode(qd, torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(table),
                         torch.from_numpy(pos), backend=backend, **kw)
        with pytest.raises(NotImplementedError, match="inference-only"):
            o.sum().backward()
