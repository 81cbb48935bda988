"""The port's attention ops on the CPU against the JAX package: the plain
flash-attention forward (out and lse) against the Pallas kernel in
interpret mode and ``flash_attention_ref``, the plain paged flash-decode
against its Pallas kernel in interpret mode, the split-KV decode kernel's
plan (which table entries each split takes) and its split-and-combine
arithmetic in plain torch against that Pallas kernel, the kernels' choice
by dtype, and the ops' dispatch and backward contracts (the backward's parity with JAX is in
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
from repro_torch.kernels.flash_attention.kernel import _LAUNCHER_SPECS, _pick, attention_variant, flash_attention_fwd
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref, page_mask
from repro_torch.kernels.flash_decode.kernel import (
    SMS,
    decode_splits,
    flash_decode_fwd,
    live_entries,
    split_range,
)

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


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "sm90"), (torch.float32, "cuda_core")])
def test_dq_pass_variant(dtype, want):
    """The dq pass picks like the other passes: bf16 → the tensor-core
    kernel (``flash_attention_bwd_dq_sm90``, same pointer arguments as the
    CUDA-core launcher, no dtype code), f32 → the CUDA-core kernel; a
    caller may name the CUDA-core kernel for bf16, never the tensor-core
    one for f32, nor an unknown name."""
    q = torch.zeros((1, 2, 1, 64), dtype=dtype)
    assert _pick("flash_attention_bwd_dq", q, None) == want
    assert _pick("flash_attention_bwd_dq", q, "cuda_core") == "cuda_core"
    with pytest.raises(ValueError, match="variant"):
        _pick("flash_attention_bwd_dq", q, "wgmma")
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="variant"):
            _pick("flash_attention_bwd_dq", q, "sm90")
    source, ptrs, takes_dtype = _LAUNCHER_SPECS["flash_attention_bwd_dq_sm90"]
    assert source.name == "flash_attention_sm90.cu" and not takes_dtype
    assert ptrs == _LAUNCHER_SPECS["flash_attention_bwd_dq"][1]


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


# ---------------------------------------------------------------------------
# split-KV decode: the plan the kernel follows, and its arithmetic in plain
# torch held against the Pallas kernel


@pytest.mark.parametrize("b,kh,w", [(8, 3, 12), (1, 1, 256), (64, 8, 12), (3, 2, 5), (132, 1, 4), (200, 3, 1)])
def test_decode_splits_cover_the_card(b, kh, w):
    """S depends on B, KH and W alone: at least one split, at most one per
    table entry, and B·KH·S blocks reach the SMs unless W runs out first."""
    s = decode_splits(b, kh, w)
    assert 1 <= s <= w
    assert b * kh * s >= SMS or s == w
    assert decode_splits(8, 3, 12) == 6  # the serving shape: 144 blocks


@pytest.mark.parametrize(
    "pos,ps,w,cache_len",
    [
        ([0, 1, 15, 16, 17, 100, 160, 191], 16, 12, 192),  # ragged, from 0 to the last slot
        ([5, 30, 37, 39, 40, 41, 200], 8, 5, 16),  # a 16-slot ring before and after it wraps
        ([0, 3, 9, 100], 16, 256, 4096),  # a table far wider than the live pages
    ],
    ids=["ragged", "ring", "wide"],
)
def test_decode_split_plan(pos, ps, w, cache_len):
    """Every live table entry falls in exactly one split, in order, and no
    entry past the live ones does; the live entries are exactly those on
    which some index is valid (the JAX ``page_live`` predicate), for
    windowed rings and plain caches alike."""
    for window in (0, cache_len) if cache_len < w * ps else (0,):
        for p in pos:
            n = live_entries(p, ps, w, cache_len)
            entries = np.arange(w)
            base = entries * ps
            page_live = (base <= p) & (base < cache_len)
            if window:
                page_live |= (p >= cache_len) & (base < cache_len)
            assert n == int(page_live.sum()) and page_live[:n].all()
            valid = page_mask(torch.arange(w * ps), torch.tensor(p), cache_len, window).numpy().reshape(w, ps)
            assert not valid[n:].any()  # nothing valid past the live entries
            for b, kh in ((8, 3), (1, 1), (64, 8)):
                splits = decode_splits(b, kh, w)
                taken = [e for s in range(splits) for e in range(*split_range(n, splits, s))]
                assert taken == list(range(n))
                sizes = [hi - lo for lo, hi in (split_range(n, splits, s) for s in range(splits))]
                assert max(sizes) - min(sizes) <= 1


def _split_decode(q, k_pages, v_pages, page_table, pos, *, window=0, softcap=0.0, cache_len=0):
    """The split kernel and its combine, step by step in plain torch (f32):
    each split's online-softmax partials (m, l, acc) over its share of the
    live entries, masked scores at -inf and empty splits at m = -1e30,
    l = 0, then the combine in split order."""
    b, h, hd = q.shape
    ps, kh = k_pages.shape[1], k_pages.shape[2]
    w = page_table.shape[1]
    cl = cache_len or w * ps
    g = h // kh
    splits = decode_splits(b, kh, w)
    out = torch.zeros((b, h, hd))
    for r in range(b):
        p = int(pos[r])
        n = live_entries(p, ps, w, cl)
        for k in range(kh):
            qg = q[r, k * g : (k + 1) * g].float() * (1.0 / hd**0.5)  # (G, hd)
            parts = []
            for s in range(splits):
                m, l, acc = torch.full((g,), -1e30), torch.zeros(g), torch.zeros((g, hd))
                lo, hi = split_range(n, splits, s)
                if hi > lo:
                    pages = page_table[r, lo:hi].long()
                    kk = k_pages[pages, :, k].reshape(-1, hd).float()
                    vv = v_pages[pages, :, k].reshape(-1, hd).float()
                    j = torch.arange(lo * ps, hi * ps)
                    ok = page_mask(j, torch.tensor(p), cl, window)
                    kk = torch.where(ok[:, None], kk, 0.0)
                    vv = torch.where(ok[:, None], vv, 0.0)
                    sc = qg @ kk.T
                    if softcap > 0:
                        sc = torch.tanh(sc / softcap) * softcap
                    sc = sc.masked_fill(~ok[None], float("-inf"))
                    m = torch.maximum(m, sc.amax(-1))
                    e = torch.exp(sc - m[:, None])
                    l, acc = e.sum(-1), e @ vv
                parts.append((m, l, acc))
            mm = torch.stack([x[0] for x in parts])  # (S, G)
            big = mm.amax(0)
            wgt = torch.exp(mm - big)
            ll = (torch.stack([x[1] for x in parts]) * wgt).sum(0)
            aa = (torch.stack([x[2] for x in parts]) * wgt[:, :, None]).sum(0)
            out[r, k * g : (k + 1) * g] = torch.where(ll[:, None] > 0, aa / ll[:, None], 0.0)
    return out


def _wide_decode_case(seed):
    """The serving shape's heads (9 over 3 kv heads) at hd 32, 8-token
    pages and a 40-entry table of which rows use 1 to 6 entries: most of
    the 11 splits of a row are empty, and the row at position 0 has one
    live entry."""
    rng = np.random.default_rng(seed)
    b, h, kh, hd, ps, w = 4, 9, 3, 32, 8, 40
    n_pages = b * w + 1
    k_pages = rng.standard_normal((n_pages, ps, kh, hd)).astype(np.float32)
    v_pages = rng.standard_normal((n_pages, ps, kh, hd)).astype(np.float32)
    k_pages[-1] = v_pages[-1] = np.nan
    pos = np.array([0, 7, 8, 45], np.int32)
    table = np.full((b, w), n_pages - 1, np.int32)
    perm = rng.permutation(n_pages - 1)
    for r in range(b):
        live = -(-(int(pos[r]) + 1) // ps)
        table[r, :live] = perm[r * w : r * w + live]
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    return q, k_pages, v_pages, table, pos, dict(window=0, cache_len=w * ps)


@pytest.mark.parametrize(
    "case,window,softcap",
    [("ragged", 0, 0.0), ("ragged", 0, 30.0), ("ragged", 16, 0.0), ("ragged", 16, 30.0), ("wide", 0, 0.0)],
    ids=["full", "softcap", "ring", "ring-softcap", "empty-splits"],
)
def test_split_decode_arithmetic_matches_jax(case, window, softcap):
    """The split-and-combine arithmetic of the kernel, following its plan,
    gives JAX's paged decode (Pallas kernel in interpret mode) within 1e-5:
    no window, softcap, the ring window (wrapped and not), and rows whose
    splits are mostly empty. Scratch-page entries hold NaN and must never
    reach the output."""
    if case == "wide":
        q, kp, vp, table, pos, kw = _wide_decode_case(seed=5)
        assert decode_splits(q.shape[0], kp.shape[2], table.shape[1]) == 11  # more splits than live entries
    else:
        q, kp, vp, table, pos, kw = _decode_case(window, softcap, seed=window + int(softcap))
    kw["softcap"] = softcap
    want = np.asarray(flash_decode_pallas(q, kp, vp, table, pos, interpret=True, **kw))
    got = _split_decode(*map(torch.from_numpy, (q, kp, vp, table, pos)), **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)

