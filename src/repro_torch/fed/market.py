"""Model-market simulation: partition a dataset, locally train each client,
and hand the server nothing but the pre-trained models (+ sizes).

Client inits are drawn from a ``torch.Generator`` seeded with ``seed``, in
client order, by both builders (the JAX package draws them from threefry,
so its markets differ; tests carry JAX inits across with
:mod:`repro_torch.convert`). :func:`build_market` trains the clients one
after another; :func:`build_market_grouped` trains each architecture group
at once (:func:`repro_torch.fed.client.local_train_group`).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.train import OFLConfig, TrainConfig
from repro_torch.core.client_bank import ClientBank, make_ensemble
from repro_torch.core.ensemble import ensemble_logits
from repro_torch.data.partitions import partition_dataset
from repro_torch.fed.client import evaluate_cnn, local_train, local_train_group
from repro_torch.models.cnn import cnn_apply, init_cnn
from repro_torch.utils.logging import get_logger

log = get_logger("market")


def build_market(
    seed: int,
    x: np.ndarray,
    y: np.ndarray,
    cfg: OFLConfig,
    num_classes: int,
    archs: Optional[Sequence[str]] = None,
    local_epochs: Optional[int] = None,
    device="cuda",
) -> Tuple[List[Callable], List[Any], List[int], List[np.ndarray]]:
    """Returns (client_apply_fns, client_params, shard_sizes, shard_indices).

    ``archs``: one CNN arch id per client (heterogeneous market) or None for
    all-``cnn5``."""
    n = cfg.num_clients
    archs = list(archs) if archs else ["cnn5"] * n
    if len(archs) != n:
        raise ValueError(f"{len(archs)} client archs for {n} clients")
    parts = partition_dataset(seed, y, cfg)
    in_shape = x.shape[1:]
    tc = TrainConfig(
        optimizer="sgdm",
        learning_rate=cfg.local_lr,
        momentum=cfg.local_momentum,
        batch_size=cfg.local_batch_size,
        seed=seed,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    applies, params_list, sizes = [], [], []
    epochs = cfg.local_epochs if local_epochs is None else local_epochs
    for k in range(n):
        p0 = init_cnn(gen, archs[k], num_classes, in_shape)
        xb, yb = x[parts[k]], y[parts[k]]
        pk = local_train(partial(cnn_apply, archs[k]), p0, xb, yb, tc, epochs)
        applies.append(partial(cnn_apply, archs[k]))
        params_list.append(pk)
        sizes.append(len(parts[k]))
        acc = evaluate_cnn(applies[-1], pk, xb[: min(512, len(xb))], yb[: min(512, len(yb))])
        log.info("client %d (%s): shard=%d train-acc=%.3f", k, archs[k], len(parts[k]), acc)
    return applies, params_list, sizes, parts


def build_market_grouped(
    seed: int,
    x: np.ndarray,
    y: np.ndarray,
    cfg: OFLConfig,
    num_classes: int,
    archs: Optional[Sequence[str]] = None,
    local_epochs: Optional[int] = None,
    device="cuda",
) -> Tuple[ClientBank, Tuple[Any, ...], List[int], List[np.ndarray]]:
    """The grouped twin of :func:`build_market`: the same partition, the
    same inits (drawn in client order from one generator, as there) and
    each client's own ``batch_iterator`` steps, but the clients of one arch
    train as ONE vmapped loop (:func:`repro_torch.fed.client.local_train_group`).
    Returns ``(bank, bank_params, shard_sizes, shard_indices)``: the bank's
    params feed ``bank.logits_all`` directly, or go back to the per-client
    list with ``bank.unstack_params``."""
    n = cfg.num_clients
    archs = list(archs) if archs else ["cnn5"] * n
    if len(archs) != n:
        raise ValueError(f"{len(archs)} client archs for {n} clients")
    parts = partition_dataset(seed, y, cfg)
    in_shape = x.shape[1:]
    tc = TrainConfig(
        optimizer="sgdm",
        learning_rate=cfg.local_lr,
        momentum=cfg.local_momentum,
        batch_size=cfg.local_batch_size,
        seed=seed,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    epochs = cfg.local_epochs if local_epochs is None else local_epochs
    applies = [partial(cnn_apply, a) for a in archs]
    inits = [init_cnn(gen, a, num_classes, in_shape) for a in archs]
    bank, bank_params0 = ClientBank.build(applies, inits, scan_chunk=cfg.ensemble_scan_chunk)
    bank_params, at = [], 0
    for g, count in enumerate(bank.counts):
        members = bank.order[at : at + count]
        at += count
        shards = [(x[parts[k]], y[parts[k]]) for k in members]
        bank_params.append(local_train_group(bank.applies[g], bank_params0[g], shards, tc, epochs))
        log.info("group %d (%s): %d clients, shards=%s", g, archs[members[0]], count, [len(s[0]) for s in shards])
    return bank, tuple(bank_params), [len(p) for p in parts], parts


def market_eval_fn(
    client_applies: List[Callable],
    client_params: List[Any],
    server_apply: Callable,
    test_x: np.ndarray,
    test_y: np.ndarray,
    batch_size: int = 512,
    impl: str = "grouped",
) -> Callable:
    """Builds eval_fn(server_params, w) -> {server_acc, ensemble_acc}.
    ``server_params=None`` skips the server forward and returns only
    ``ensemble_acc`` (FedENS trains no server). ``impl`` picks the client
    ensemble engine (:func:`repro_torch.core.client_bank.make_ensemble`)."""
    logits_all_fn, client_params = make_ensemble(client_applies, client_params, impl=impl)

    @torch.no_grad()
    def eval_fn(server_params, w) -> Dict[str, float]:
        ens_ok = srv_ok = 0
        for i in range(0, len(test_x), batch_size):
            xb = torch.as_tensor(test_x[i : i + batch_size], device=w.device)
            yb = test_y[i : i + batch_size]
            ep = torch.argmax(ensemble_logits(logits_all_fn(client_params, xb), w), dim=-1)
            ens_ok += int((ep.cpu().numpy() == yb).sum())
            if server_params is not None:
                sp = torch.argmax(server_apply(server_params, xb), dim=-1)
                srv_ok += int((sp.cpu().numpy() == yb).sum())
        out = {"ensemble_acc": ens_ok / len(test_x)}
        if server_params is not None:
            out["server_acc"] = srv_ok / len(test_x)
        return out

    return eval_fn
