"""LM-scale Co-Boosting (the port of ``repro.core.distributed``): the
paper's technique with LM clients.

The clients are instances of the server's LM architecture. The reference
stacks their params on a leading K axis and scans over it; the port keeps
a list of K param dicts and loops, so the activations of one client are
live at a time. Token models have no pixel space, so:

* the generator synthesizes embedding-space sequences ``batch["embeds"]``
  (B, S, d) (``models.generator.embedding_generator``);
* DHS (Eq. 10) perturbs those embeddings;
* the EE labels are target-token ids scored at the final position.

The uniform ``u`` of DHS comes from a draw seam (``utils.prng.Draws`` on a
``torch.Generator``, or ``ReplayDraws`` in the tests, which hands in the
reference's own draw).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.ensemble import ensemble_logits
from repro_torch.core.losses import kl_loss, kl_per_sample
from repro_torch.core.weight_search import normalize_weights
from repro_torch.models.transformer import head_matrix, lm_features, lm_forward
from repro_torch.optim.optimizers import apply_updates
from repro_torch.utils.trees import value_and_grad

Clients = List[Dict[str, Any]]


def ensemble_lm_logits(client_params: Clients, cfg, batch: Dict, w: torch.Tensor) -> torch.Tensor:
    """Weighted ensemble logits A_w (Eq. 2) over the K LM clients, (B, S, V)
    f32."""
    acc = None
    for w_k, p_k in zip(w.float(), client_params):
        term = w_k * lm_forward(p_k, cfg, batch)[0].float()
        acc = term if acc is None else acc + term
    return acc


def client_lm_logits(client_params: Clients, cfg, batch: Dict) -> torch.Tensor:
    """Per-client final-position logits (K, B, V) f32: the EE weight search
    operand. Only the last position is kept, to bound memory."""
    return torch.stack([lm_forward(p_k, cfg, batch)[0][:, -1].float() for p_k in client_params])


def dhs_embeds(client_params: Clients, cfg, batch: Dict, w: torch.Tensor, draws, epsilon: float) -> Dict:
    """Eq. 10 in embedding space: move ``batch["embeds"]`` by ``epsilon``
    along the per-sample normalised gradient of uᵀA_w at the final
    position, u ~ Unif[-1, 1) of shape (B, V) from ``draws.direction``."""
    embeds = batch["embeds"]
    with torch.enable_grad():
        e = embeds.detach().requires_grad_()
        ens = ensemble_lm_logits(client_params, cfg, dict(batch, embeds=e), w)[:, -1]  # (B, V)
        u = draws.direction(tuple(ens.shape)).to(ens.device)
        (g,) = torch.autograd.grad(torch.sum(u * ens), e)
    flat = g.reshape(g.shape[0], -1).float()
    norm = torch.clamp(torch.linalg.vector_norm(flat, dim=-1), min=1e-12)[:, None]
    direction = (flat / norm).reshape(g.shape)
    new = (embeds.float() + epsilon * direction).to(embeds.dtype)
    return dict(batch, embeds=new)


def ee_update_lm(w: torch.Tensor, client_params: Clients, cfg, batch: Dict, labels: torch.Tensor, mu: float) -> torch.Tensor:
    """Eq. 12 on LM clients: a sign step on w against the final-position CE
    of the weighted ensemble."""
    with torch.no_grad():
        la = client_lm_logits(client_params, cfg, batch)  # (K, B, V)
    with torch.enable_grad():
        w_ = w.detach().requires_grad_()
        logits = ensemble_logits(la, w_).float()
        ll = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
        loss = torch.mean(torch.logsumexp(logits, dim=-1) - ll)
        (g,) = torch.autograd.grad(loss, w_)
    return normalize_weights(w - mu * torch.sign(g))


def coboost_distill_loss(
    server_params: Any,
    client_params: Clients,
    w: torch.Tensor,
    cfg,
    batch: Dict,
    temperature: float = 4.0,
    kl_chunk: int = 0,
) -> torch.Tensor:
    """Eq. 4 at LM scale: temperature-KL between the weighted client
    ensemble (the teacher, held constant) and the server, over every
    position, plus ``router_aux_coef`` times the server's router loss (0
    for a dense server).

    ``kl_chunk > 0`` is the memory lever: the LM heads are factored out of
    the forwards (``lm_features``), and the (B, S, V) teacher and student
    logits are made one sequence chunk at a time, so the live vocab-sized
    tensors are O(chunk·V) while the stored client features are O(K·S·d)
    (kept in bf16, as in the reference)."""
    if kl_chunk <= 0:
        with torch.no_grad():
            teacher = ensemble_lm_logits(client_params, cfg, batch, w)
        student, aux = lm_forward(server_params, cfg, batch)
        return kl_loss(teacher, student, temperature) + cfg.router_aux_coef * aux

    with torch.no_grad():
        cfeats = torch.stack([lm_features(p, cfg, batch)[0].to(torch.bfloat16) for p in client_params])  # (K,B,S,d)
        cheads = torch.stack([head_matrix(p, cfg).to(torch.bfloat16) for p in client_params])  # (K,d,V)
    sfeat, aux = lm_features(server_params, cfg, batch)
    shead = head_matrix(server_params, cfg)
    b, s, _ = sfeat.shape
    chunk = min(kl_chunk, s)
    if s % chunk:
        raise ValueError(f"kl_chunk {kl_chunk} does not divide the sequence length {s}")
    wf = w.float()
    total = torch.zeros((), dtype=torch.float32, device=sfeat.device)
    for c0 in range(0, s, chunk):
        cl = cfeats[:, :, c0 : c0 + chunk].float()
        t = torch.einsum("k,kbcd,kdv->bcv", wf, cl, cheads.float())
        st = sfeat[:, c0 : c0 + chunk] @ shead.to(sfeat.dtype)
        total = total + torch.sum(kl_per_sample(t, st, temperature))
    return total / (b * s) + cfg.router_aux_coef * aux


def coboost_distill_step(
    server_params: Any,
    opt_state: Any,
    client_params: Clients,
    w: torch.Tensor,
    cfg,
    batch: Dict,
    opt,
    step: int,
    temperature: float = 4.0,
    epsilon: float = 0.0,
    draws: Optional[Any] = None,
):
    """One server distillation step, with in-step DHS when ``epsilon > 0``
    and a draw seam is given. Returns ``(server_params, opt_state, loss)``."""
    if epsilon > 0.0 and draws is not None and "embeds" in batch:
        batch = dhs_embeds(client_params, cfg, batch, w, draws, epsilon)
    loss, grads = value_and_grad(
        lambda p: coboost_distill_loss(p, client_params, w, cfg, batch, temperature), server_params
    )
    updates, opt_state = opt.update(grads, opt_state, server_params, step)
    return apply_updates(server_params, updates), opt_state, loss
