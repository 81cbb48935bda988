"""Grouped-query attention with RoPE, optional qk-norm, sliding window and
a KV cache for decode (the port's copy of ``repro.models.attention``,
serving path).

Entry points:

* :func:`attn_train`   — full-sequence attention (no cache);
* :func:`attn_prefill` — the same, and fills the cache;
* :func:`attn_decode`  — one token against the cache: the dense per-slot
  layout attends through :func:`_sdpa_small` (plain PyTorch), the paged
  layout through the flash-decode op;
* :func:`attn_extend`  — a multi-token continuation against a paged cache
  (prefix-cache tail prefill and speculative verify), through the table's
  gathered view and :func:`_sdpa_small`, as the reference computes it.

Full-sequence attention goes through the flash-attention op
(:mod:`repro_torch.kernels.flash_attention`), paged decode through the
flash-decode op; ``cfg.backend_for("attn")`` and
``cfg.backend_for("decode")`` route them.

Unlike the reference, whose arrays are immutable, the caches are updated
**in place**: ``attn_prefill`` and ``attn_decode`` write the new K/V into
the tensors they are given (views of the model state) and return them;
``attn_extend`` writes the page buffers in place too.
A serving state is written every decode step, and a copy per step would
double its memory traffic.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.dispatch import on_local_shards
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.layers import apply_rope, dense_init, rms_norm
from repro_torch.sharding.partition import (
    constrain, is_dtensor, logical_placements, mesh_axes_of, replicated,
)

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, dtype):
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    params = {
        "wq": dense_init(gen, d, (h, hd), dtype),
        "wk": dense_init(gen, d, (k, hd), dtype),
        "wv": dense_init(gen, d, (k, hd), dtype),
        "wo": dense_init(gen, h * hd, (d,), dtype).reshape(h, hd, d),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
        params["k_norm"] = torch.zeros((hd,), dtype=dtype, device=gen.device)
    return params


def _proj(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    d, h, hd = w.shape
    y = x @ w.to(x.dtype).reshape(d, h * hd)
    return y.reshape(*y.shape[:-1], h, hd)


def _out_proj(o, wo):
    """``einsum("bshk,hkd->bsd")``."""
    h, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], h * hd) @ wo.to(o.dtype).reshape(h * hd, d)


def _project_qkv(params, x, cfg, positions):
    """q, k, v: (B, S, H|KH, hd). qk-norm comes before RoPE, so every path
    (train, prefill, decode, extend) caches the normed K."""
    q, k, v = _proj(x, params["wq"]), _proj(x, params["wk"]), _proj(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q, k = apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)
    return (constrain(q, "batch", None, "heads", None), constrain(k, "batch", None, "heads", None),
            constrain(v, "batch", None, "heads", None))


def _gqa_placements(q, k, mesh, k_batch: bool = True):
    """Placements of q (B, ..., H, hd) and of k/v (B, ..., KH, hd), or of a
    page pool (P, ps, KH, hd) with ``k_batch=False``, for a kernel on local
    shards: the batch dim as constrained, the heads dim over the model axis
    only where BOTH H and KH divide it, so each rank keeps whole GQA groups
    (its H/m query heads are exactly those of its KH/m kv heads); otherwise
    the heads stay whole on every rank."""
    m = mesh_axes_of(mesh).get("model", 1)
    heads = "heads" if q.shape[-2] % m == 0 and k.shape[-2] % m == 0 else None
    lead = lambda t, batch: (("batch",) if batch else (None,)) + (None,) * (t.dim() - 3)
    return (logical_placements(q.shape, lead(q, True) + (heads, None), mesh),
            logical_placements(k.shape, lead(k, k_batch) + (heads, None), mesh))


def _attn_mix(q, k, v, cfg):
    fn = lambda q, k, v: flash_attention(
        q, k, v, causal=cfg.causal, window=cfg.sliding_window,
        softcap=cfg.attn_logit_softcap, backend=cfg.backend_for("attn"),
    )
    if not is_dtensor(q):
        return fn(q, k, v)
    qp, kp = _gqa_placements(q, k, q.device_mesh)
    return on_local_shards("flash_attention", fn, (q, k, v), (qp, kp, kp), [*qp])


def _index_parts(index):
    """A leading-dim index (slices and index tensors) as ``(index tuple,
    its tensors, rebuild)``: ``rebuild(tensors)`` puts (local) tensors back
    in their places, for a function run on local shards."""
    index = index if isinstance(index, tuple) else (index,)

    def rebuild(tensors):
        it = iter(tensors)
        return tuple(next(it) if torch.is_tensor(i) else i for i in index)

    return index, [i for i in index if torch.is_tensor(i)], rebuild


def write_rows(buf: torch.Tensor, index, values: torch.Tensor) -> None:
    """``buf[index] = values`` in place (cast to ``buf``'s dtype). On a
    DTensor ``buf`` every rank writes its own shard: the indexed leading
    dims (slots, pages, positions) are never sharded, so ``values`` takes
    ``buf``'s placements on the trailing dims they share (the heads or
    channel dims) and the index tensors, data every rank holds, stay
    whole."""
    if not is_dtensor(buf):
        buf[index] = values.to(buf.dtype)
        return
    from torch.distributed.tensor import Shard

    index, tensors, rebuild = _index_parts(index)
    values = replicated(values, buf.device_mesh)
    lead = buf.dim() - values.dim()
    vp = []
    for p in buf.placements:
        if isinstance(p, Shard):
            if p.dim < len(index):
                raise ValueError(f"cannot write rows of a buffer sharded on an indexed dim ({buf.placements})")
            p = Shard(p.dim - lead)
        vp.append(p)

    def local(b, v, *ts):
        b[rebuild(ts)] = v.to(b.dtype)
        return b

    on_local_shards("kv_scatter", local, (buf, values, *tensors),
                    (buf.placements, vp, *([None] * len(tensors))), [*buf.placements])


def take_rows(buf: torch.Tensor, index) -> torch.Tensor:
    """``buf[index]`` for leading-dim ``index`` (slices and index tensors):
    on a DTensor, each rank gathers from its own shard, the output sharded
    like ``buf`` on the trailing dims."""
    if not is_dtensor(buf):
        return buf[index]
    from torch.distributed.tensor import Shard

    index, tensors, rebuild = _index_parts(index)
    out_dim = buf.dim() - len(tensors) + max((t.dim() for t in tensors), default=0)
    out_pl = [Shard(p.dim + out_dim - buf.dim()) if isinstance(p, Shard) else p for p in buf.placements]
    return on_local_shards("page_gather", lambda b, *ts: b[rebuild(ts)], (buf, *tensors),
                           (buf.placements, *([None] * len(tensors))), out_pl)


def _sdpa_small(q, k, v, bias, cfg):
    """Unblocked attention for decode (Sq == 1) and extend. q: (B, Sq, H, hd);
    k, v: (B, Sk, KH, hd); ``bias`` is per batch row, ``(B, Sq, Sk)`` or
    right-aligned broadcastable to it, like the engine's ``(B, 1, Sk)``."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    if is_dtensor(q):  # whole GQA groups per rank before the heads split
        q = q.redistribute(q.device_mesh, _gqa_placements(q, k, q.device_mesh)[0])
    q = q.reshape(b, sq, kh, h // kh, hd)
    scale = 1.0 / torch.tensor(float(hd)).sqrt().to(q.dtype)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q * scale, k).float()
    if cfg.attn_logit_softcap > 0:
        c = cfg.attn_logit_softcap
        scores = torch.tanh(scores / c) * c
    scores = scores + bias[:, None, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v).reshape(b, sq, h, hd)


def attn_train(params, x, cfg, positions=None):
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    return constrain(_out_proj(_attn_mix(q, k, v, cfg), params["wo"]), "batch", None, None)


# ---------------------------------------------------------------------------
# KV cache


def cache_len(cfg, max_seq: int) -> int:
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_seq)
    return max_seq


def init_cache(cfg, batch: int, max_seq: int, dtype, device="cpu") -> Dict[str, torch.Tensor]:
    shape = (batch, cache_len(cfg, max_seq), cfg.num_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg, n_pages: int, page_size: int, dtype, device="cpu") -> Dict[str, torch.Tensor]:
    """Paged decode cache: a pool of fixed-size pages shared by all slots
    (:class:`repro_torch.serve.kv_pool.KVPool` hands out the page ids; the
    per-slot page table lives in the engine's decode state)."""
    shape = (n_pages, page_size, cfg.num_kv_heads, cfg.head_dim_)
    return {
        "k_pages": torch.zeros(shape, dtype=dtype, device=device),
        "v_pages": torch.zeros(shape, dtype=dtype, device=device),
    }


def attn_prefill(params, x, cfg, cache):
    """Full-sequence attention that also fills ``cache`` (in place). The
    cache keeps its allocated length ``cl``; when the prompt is longer than
    ``cl`` (a sliding-window ring), the kept tail lands on its ring slots
    (slot = position % cl) so :func:`attn_decode`'s position math holds."""
    s = x.shape[1]
    q, k, v = _project_qkv(params, x, cfg, torch.arange(s, device=x.device))
    out = _out_proj(_attn_mix(q, k, v, cfg), params["wo"])
    ck, cv = cache["k"], cache["v"]
    cl = ck.shape[1]
    if s < cl:
        write_rows(ck, (slice(None), slice(0, s)), k)
        write_rows(cv, (slice(None), slice(0, s)), v)
    else:
        tail_pos = torch.arange(s - cl, s, device=x.device)
        slots = tail_pos % cl if cfg.sliding_window > 0 else torch.arange(cl, device=x.device)
        write_rows(ck, (slice(None), slots), k[:, -cl:])
        write_rows(cv, (slice(None), slots), v[:, -cl:])
    return constrain(out, "batch", None, None), cache


def _positions(pos, b: int, device) -> torch.Tensor:
    """``pos`` (an int, a 0-d tensor or a (B,) tensor) as a (B,) int32 vector."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.reshape(-1).expand(b) if pos.dim() else pos.expand(b)


def attn_decode(params, x, cfg, cache, pos, page_table=None):
    """One-token decode. x: (B, 1, d); ``pos``: the index of this token, a
    scalar or a (B,) vector of per-row positions.

    The dense per-slot cache (``{"k", "v"}``, a ring buffer for SWA) attends
    through :func:`_sdpa_small`; a paged cache (``{"k_pages", "v_pages"}``
    plus ``page_table``) through the flash-decode op. Both layouts use the
    same ring/mask math, so they are token-for-token interchangeable."""
    b = x.shape[0]
    posv = _positions(pos, b, x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, posv[:, None])
    if "k_pages" in cache:
        return _attn_decode_paged(params, q, k_new, v_new, cfg, cache, posv, page_table)
    ck, cv = cache["k"], cache["v"]
    cl = ck.shape[1]
    slot = posv % cl if cfg.sliding_window > 0 else torch.clamp(posv, max=cl - 1)
    rows = torch.arange(b, device=x.device)
    write_rows(ck, (rows, slot), k_new[:, 0])
    write_rows(cv, (rows, slot), v_new[:, 0])
    # the attended copy of the cache is sequence-sharded, as in the reference
    ck, cv = constrain(ck, "batch", "seq", None, None), constrain(cv, "batch", "seq", None, None)
    ring_idx = torch.arange(cl, dtype=torch.int32, device=x.device)[None, :]
    p = posv[:, None]
    if cfg.sliding_window > 0:
        wrap = (p // cl) * cl
        k_pos = torch.where(ring_idx <= slot[:, None], wrap + ring_idx, wrap - cl + ring_idx)
        valid = (k_pos >= 0) & (k_pos <= p) & (k_pos > p - cfg.sliding_window)
    else:
        valid = ring_idx <= p
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(valid, zero, NEG_INF)[:, None, :]  # (B, 1, cl)
    out = _sdpa_small(q, ck, cv, bias, cfg)
    return constrain(_out_proj(out, params["wo"]), "batch", None, None), cache


def attn_extend(params, x, cfg, cache, pos, page_table):
    """Multi-token continuation against an existing paged cache. x: (B, S,
    d); ``pos``: (B,) per-row start positions — row ``b``'s tokens occupy
    logical positions ``pos[b] .. pos[b]+S-1``. The primitive behind
    prefix-cache admission (prefill only the tail after a page-table splice)
    and speculative verify (score k draft tokens in one forward).

    K/V are written into the pages first (in place) and attended after:
    each query sees every position at or before its own through the
    table's gathered view, so pad-tail positions and rejected drafts hold
    values no surviving query attended, overwritten by the next write there.
    Writes past the table extent go to the buffer's last page, the engine's
    scratch page (``DecodeWorker`` sizes the buffer one page past the pool,
    and unallocated table entries point there too). Several rows may write
    one scratch offset together; that page is never read unmasked, so the
    order of those writes is moot. A sliding-window ring is refused: a
    wrapped write could land in a page another request shares."""
    if cfg.sliding_window > 0:
        raise ValueError(
            "attn_extend requires a full (non-ring) cache: sliding-window "
            "layers wrap writes into shared/live pages"
        )
    b, s, _ = x.shape
    posv = _positions(pos, b, x.device)
    idx = posv[:, None] + torch.arange(s, dtype=torch.int32, device=x.device)[None, :]  # (B, S)
    q, k_new, v_new = _project_qkv(params, x, cfg, idx)
    kp, vp = cache["k_pages"], cache["v_pages"]
    ps, width = kp.shape[1], page_table.shape[1]
    extent = width * ps
    pid = torch.gather(page_table, 1, torch.clamp(idx // ps, max=width - 1).long())
    pid = torch.where(idx < extent, pid, kp.shape[0] - 1).long()
    off = (idx % ps).long()
    write_rows(kp, (pid, off), k_new)
    write_rows(vp, (pid, off), v_new)
    # the logical cache through the table, attended densely (as the
    # reference does: extend runs at admission and verify cadence)
    table = page_table.long()
    k_full = take_rows(kp, table).reshape(b, extent, *kp.shape[2:])
    v_full = take_rows(vp, table).reshape(b, extent, *vp.shape[2:])
    valid = torch.arange(extent, dtype=torch.int32, device=x.device)[None, None, :] <= idx[:, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(valid, zero, NEG_INF)  # (B, S, extent)
    out = _sdpa_small(q, k_full, v_full, bias, cfg)
    return constrain(_out_proj(out, params["wo"]), "batch", None, None), cache


def _attn_decode_paged(params, q, k_new, v_new, cfg, cache, posv, page_table):
    """Paged decode: write the new K/V onto the write position's page, then
    attend through the flash-decode op. The logical cache length comes back
    from the table extent W·ps: for full attention it is ``max_seq``
    (``EngineConfig`` keeps ``max_seq`` a multiple of the page size), and an
    SWA ring of ``min(window, max_seq)`` slots has cl <= W·ps < cl + ps, so
    ``min(window, W·ps)`` recovers cl in every case."""
    if page_table is None:
        raise ValueError("paged KV cache requires a page_table (see repro_torch.serve.kv_pool)")
    kp, vp = cache["k_pages"], cache["v_pages"]
    b = posv.shape[0]
    ps = kp.shape[1]
    extent = page_table.shape[1] * ps
    if cfg.sliding_window > 0:
        cl = min(cfg.sliding_window, extent)
        slot = posv % cl
    else:
        cl = extent
        slot = torch.clamp(posv, max=cl - 1)
    rows = torch.arange(b, device=posv.device)
    pid = page_table[rows, slot // ps]
    off = slot % ps
    # rows re-aimed at the scratch page may write one offset together: that
    # page is never read unmasked, so the order of those writes is moot
    write_rows(kp, (pid, off), k_new[:, 0])
    write_rows(vp, (pid, off), v_new[:, 0])
    fn = lambda q, kp, vp, table, p: flash_decode(
        q, kp, vp, table, p,
        window=cfg.sliding_window, softcap=cfg.attn_logit_softcap,
        cache_len=cl, backend=cfg.backend_for("decode"),
    )
    q = q[:, 0]
    if is_dtensor(q):
        qp, pp = _gqa_placements(q, kp, q.device_mesh, k_batch=False)
        out = on_local_shards("flash_decode", fn, (q, kp, vp, page_table, posv), (qp, pp, pp, None, None), [*qp])
    else:
        out = fn(q, kp, vp, page_table, posv)
    return constrain(_out_proj(out, params["wo"])[:, None], "batch", None, None), cache
