"""Mixture-of-Experts FFN with top-k routing and two capacity dispatches
(the port's copy of ``repro.models.moe``).

``moe_impl = "einsum"``: the GShard capacity dispatch. Tokens are grouped,
and a (group, token, expert, capacity) one-hot routes them through two
dispatch/combine einsums around the expert products.

``moe_impl = "scatter"``: the same capacity buffer filled with
``index_add`` and read back with a gather, so the only large products are
the expert FFNs.

Both drop the token-slots that overflow an expert's capacity, identically
(the same gates are zeroed), so they agree with each other and, when the
capacity is ample, with the dense oracle :func:`moe_ref`. Every product is
a plain ``torch.einsum``: the reference computes them outside any Pallas
kernel too.

Weights keep the reference's layouts: ``router`` (d, E) in f32 always,
``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import on_local_shards
from repro_torch.models.layers import dense_init
from repro_torch.sharding.partition import constrain, is_dtensor


def init_moe(gen: torch.Generator, cfg, dtype):
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    return {
        "router": dense_init(gen, d, (e,), torch.float32),
        "wi": dense_init(gen, d, (e, f), dtype).permute(1, 0, 2).contiguous(),  # (E, d, f)
        "wg": dense_init(gen, d, (e, f), dtype).permute(1, 0, 2).contiguous(),
        "wo": dense_init(gen, f, (e, d), dtype).permute(1, 0, 2).contiguous(),  # (E, f, d)
    }


def _router(params, x, cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(gates, expert_idx, aux_loss)`` for x (..., d): the top-k of the
    f32 router softmax, renormalised, and the Switch load-balance loss
    ``E · Σ_e mean_prob_e · mean_dispatch_e``."""
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)

    def route(probs):
        gates, idx = torch.topk(probs, k, dim=-1, sorted=True)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        # the expert histogram (bincount's, whose output size is data and
        # which a dry-run's meta tensors cannot give)
        flat = idx.reshape(-1)
        return gates, idx, torch.zeros(e, dtype=torch.int64, device=idx.device).scatter_add_(0, flat, torch.ones_like(flat))

    if is_dtensor(probs):
        # top-k and the expert histogram on each rank's tokens: the counts
        # are partial sums over the mesh dims the tokens are sharded on
        from torch.distributed.tensor import Partial, Replicate, Shard

        pl = [*probs.placements]
        counts_pl = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
        gates, idx, counts = on_local_shards("moe_dispatch", route, (probs,), (pl,), (pl, pl, counts_pl))
    else:
        gates, idx, counts = route(probs)
    me = probs.reshape(-1, e).mean(0)  # mean router prob per expert
    n_tokens = probs.numel() // e
    fe = counts.float() / n_tokens  # tokens dispatched per expert
    return gates, idx, e * torch.sum(me * fe)


def _capacity(cfg, tokens_per_group: int) -> int:
    """The reference's float expression, as written: ceil of
    ``tokens · k / E · capacity_factor``, then up to a multiple of 8, at
    least 8."""
    c = tokens_per_group * cfg.experts_per_token / cfg.num_experts
    c = int(-(-c * cfg.moe_capacity_factor // 1))  # ceil
    return max(8, -(-c // 8) * 8)


def _positions_in_expert(idx, cfg) -> torch.Tensor:
    """idx (G, S, k) → each token-slot's position in its expert's capacity
    buffer: a cumsum over the S·k slots, tokens first, then their k
    choices."""
    def positions(idx):
        g, s, k = idx.shape
        flat = idx.reshape(g, s * k)
        counts = F.one_hot(flat, cfg.num_experts).cumsum(1)  # (G, S·k, E)
        return (torch.gather(counts, 2, flat[..., None])[..., 0] - 1).reshape(g, s, k)

    if is_dtensor(idx):  # per group: local to the rank that holds the group
        return on_local_shards("moe_dispatch", positions, (idx,), (idx.placements,), [*idx.placements])
    return positions(idx)


def _group(x, cfg, seq_len: int):
    """(B, S, d) → (G, Sg, d) with ``Sg = min(moe_group_size or seq_len,
    B·S)``. Raises where Sg does not divide B·S (the reference's reshape
    fails there too); nothing is regrouped silently."""
    # routing needs a group's tokens on one rank: batch over data, the
    # sequence whole
    x = constrain(x, "batch", None, None)
    b, s, d = x.shape
    sg = min(cfg.moe_group_size or seq_len, b * s)
    if (b * s) % sg:
        raise ValueError(
            f"{cfg.name}: MoE dispatch group of {sg} tokens does not divide the {b}x{s} = {b * s} tokens of the batch"
        )
    return x.reshape((b * s) // sg, sg, d), (b, s)


def _one_hot(i, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (i[..., None] == torch.arange(n, device=i.device)).to(dtype)


def _expert_ffn(xe, wi, wg, wo):
    dt = xe.dtype
    h = torch.einsum("gecd,edf->gecf", xe, wi.to(dt))
    hg = torch.einsum("gecd,edf->gecf", xe, wg.to(dt))
    return torch.einsum("gecf,efd->gecd", h * F.silu(hg), wo.to(dt))


def _experts(params, xe):
    """The expert SwiGLU on the capacity buffer xe (G, E, C, d).

    On a DTensor ``xe`` the products run on each rank's local shards: where
    ``xe`` splits the experts over a mesh dim the weights split their
    experts there too; on the ``model`` axis, where the experts do not
    split, each rank takes a slice of every expert's width (the weights'
    ``f``; its output is a partial sum over the axis); a split of the
    groups keeps the weights whole there. The weights' FSDP split is
    gathered for the product (their gradients come back reduce-scattered).
    DTensor's own einsum cannot run these products where the data axes
    meet two dims at once."""
    weights = (params["wi"], params["wg"], params["wo"])
    if not is_dtensor(xe):
        return _expert_ffn(xe, *weights)
    from torch.distributed.tensor import Partial, Replicate, Shard

    xp, wp, op, outp = [], [], [], []
    for name, p in zip(xe.device_mesh.mesh_dim_names, xe.placements):
        if isinstance(p, Shard) and p.dim == 1:  # the experts split
            xp.append(p), wp.append(Shard(0)), op.append(Shard(0)), outp.append(p)
        elif isinstance(p, Shard) and p.dim == 0:  # the groups split
            xp.append(p), wp.append(Replicate()), op.append(Replicate()), outp.append(p)
        elif name == "model":  # tensor parallel over each expert's width
            xp.append(Replicate()), wp.append(Shard(2)), op.append(Shard(1)), outp.append(Partial())
        else:
            xp.append(Replicate()), wp.append(Replicate()), op.append(Replicate()), outp.append(Replicate())
    return on_local_shards("moe_dispatch", _expert_ffn, (xe, *weights), (xp, wp, wp, op), outp)


def _dispatch(xg, gates, idx, pos, cfg, cap):
    """The capacity buffer xe (G, E, C, d) and the combine weights (G, Sg,
    E, C) of each group, through one-hot einsums; drops past ``cap``."""
    dt = xg.dtype
    keep = (pos < cap).to(dt)
    gates = gates.to(dt) * keep
    e_oh = _one_hot(idx, cfg.num_experts, dt)  # (G, Sg, k, E)
    c_oh = _one_hot(pos, cap, dt) * keep[..., None]  # (G, Sg, k, C)
    dispatch = torch.einsum("gske,gskc->gsec", e_oh, c_oh)
    combine = torch.einsum("gske,gskc->gsec", e_oh * gates[..., None], c_oh)
    return torch.einsum("gsec,gsd->gecd", dispatch, xg), combine


def _combine(ye, combine):
    return torch.einsum("gecd,gsec->gsd", ye, combine)


def moe_apply_einsum(params, x, cfg):
    """GShard-style capacity dispatch through one-hot einsums. x: (B, S, d).
    Returns (y, aux). Under a mesh the dispatch and the combine run on each
    rank's groups (the einsums flatten dims DTensor may not flatten in
    place), the experts between them on the experts' split."""
    xg, (b, s) = _group(x, cfg, x.shape[1])
    gates, idx, aux = _router(params, xg, cfg)  # (G, Sg, k)
    cap = _capacity(cfg, xg.shape[1])
    pos = _positions_in_expert(idx, cfg)
    if is_dtensor(xg):
        from torch.distributed.tensor import Replicate, Shard

        pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in xg.placements]  # the groups' split
        xe, combine = on_local_shards("moe_dispatch", lambda *a: _dispatch(*a, cfg, cap), (xg, gates, idx, pos),
                                      (pl,) * 4, (pl, pl))
        ye = constrain(_experts(params, constrain(xe, None, "experts", None, None)), None, "experts", None, None)
        y = on_local_shards("moe_dispatch", _combine, (ye, combine), (pl, pl), pl)
    else:
        xe, combine = _dispatch(xg, gates, idx, pos, cfg, cap)
        y = _combine(_experts(params, xe), combine)
    return constrain(y.reshape(b, s, -1), "batch", None, None), aux


def moe_apply_scatter(params, x, cfg):
    """The same routing and drops as :func:`moe_apply_einsum`, with the
    capacity buffer filled by ``index_add`` and read back by a gather.
    x: (B, S, d). Returns (y, aux).

    Each group's buffer has ``E·cap + 1`` rows: every dropped slot goes to
    the last row, which is cut off, so ``index_add`` never sees an index
    out of range. Each kept row is written by exactly one token-slot, so
    the buffer has the same bits on every call, atomics or not."""
    xg, (b, s) = _group(x, cfg, x.shape[1])
    g, sg, d = xg.shape
    e, k, dt = cfg.num_experts, cfg.experts_per_token, xg.dtype
    gates, idx, aux = _router(params, xg, cfg)
    cap = _capacity(cfg, sg)
    pos = _positions_in_expert(idx, cfg)
    keep = pos < cap
    slot = torch.where(keep, idx * cap + pos, e * cap).reshape(g, sg * k)

    def fill(xg, slot):
        g = xg.shape[0]
        rows = e * cap + 1
        flat = (slot + rows * torch.arange(g, device=xg.device)[:, None]).reshape(-1)
        xk = xg[:, :, None, :].expand(g, sg, k, d).reshape(g * sg * k, d)
        buf = torch.zeros((g * rows, d), dtype=dt, device=xg.device).index_add(0, flat, xk)
        return buf.reshape(g, rows, d)[:, : e * cap].reshape(g, e, cap, d)

    def read(ye, slot, keep, gates):
        g = ye.shape[0]
        ye = F.pad(ye.reshape(g, e * cap, d), (0, 0, 0, 1))  # a zero row for the dropped slots
        yk = torch.gather(ye, 1, slot[..., None].expand(g, sg * k, d))
        yk = torch.where(keep.reshape(g, sg * k, 1), yk, torch.zeros((), dtype=dt, device=ye.device))
        return torch.sum(yk.reshape(g, sg, k, d) * gates.to(dt)[..., None], dim=2)

    if is_dtensor(xg):
        # the index_add fill and the gather read-back on each rank's groups;
        # the expert FFN between them runs experts-sharded
        pl = [*xg.placements]
        xe = on_local_shards("moe_dispatch", fill, (xg, slot), (pl, pl), pl)
        ye = constrain(_experts(params, constrain(xe, None, "experts", None, None)), None, "experts", None, None)
        y = on_local_shards("moe_dispatch", read, (ye, slot, keep, gates), (pl, pl, pl, pl), pl)
    else:
        y = read(_experts(params, fill(xg, slot)), slot, keep, gates)
    return constrain(y.reshape(b, s, d), "batch", None, None), aux


MOE_APPLY = {"einsum": moe_apply_einsum, "scatter": moe_apply_scatter}


def moe_apply(params, x, cfg):
    if cfg.moe_impl not in MOE_APPLY:
        raise ValueError(f"{cfg.name}: moe_impl {cfg.moe_impl!r} is not one of {tuple(MOE_APPLY)}")
    return MOE_APPLY[cfg.moe_impl](params, x, cfg)


def moe_ref(params, x, cfg):
    """Dense oracle: every token through every expert, combined by the
    top-k gates (no capacity, nothing dropped). O(E) overcompute, for tests
    only. x: (B, S, d)."""
    dt = x.dtype
    gates, idx, aux = _router(params, x, cfg)
    h = torch.einsum("bsd,edf->besf", x, params["wi"].to(dt))
    hg = torch.einsum("bsd,edf->besf", x, params["wg"].to(dt))
    ye = torch.einsum("besf,efd->besd", h * F.silu(hg), params["wo"].to(dt))  # (B, E, S, d)
    comb = torch.sum(_one_hot(idx, cfg.num_experts, dt) * gates.to(dt)[..., None], dim=2)  # (B, S, E)
    return torch.einsum("besd,bse->bsd", ye, comb), aux
