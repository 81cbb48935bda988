"""Federated partition schemes used by the paper's experiments (the port's
copy of ``repro.data.partitions``; pure numpy).

* ``dirichlet_partition`` — p_k ~ Dir(α) per class (Table 1; smaller α ⇒
  more skew).
* ``c_cls_partition``     — each client holds only C of the classes
  (Table 5).
* ``lognormal_resize``    — unbalance client sizes by lognormal draws
  (Table 4 / Fig. 2).
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    seed: int, labels: np.ndarray, n_clients: int, alpha: float, min_size: int = 2
) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        idx_per_client: List[List[int]] = [[] for _ in range(n_clients)]
        for cls in range(n_classes):
            idx = np.where(labels == cls)[0]
            rng.shuffle(idx)
            p = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
            for k, part in enumerate(np.split(idx, cuts)):
                idx_per_client[k].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            break
    return [np.asarray(sorted(ix), np.int64) for ix in idx_per_client]


def c_cls_partition(
    seed: int, labels: np.ndarray, n_clients: int, c: int
) -> List[np.ndarray]:
    """Each client holds at most C distinct classes (hard invariant).
    Classes are dealt round-robin so coverage is maximal when
    n_clients·C ≥ n_classes (the paper's setting); with fewer total slots,
    uncovered classes' samples are dropped rather than violating the
    limit."""
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    c = min(c, n_classes)
    client_classes: List[List[int]] = [[] for _ in range(n_clients)]
    order = [int(v) for v in rng.permutation(n_classes)]
    ptr = 0
    for _ in range(n_clients * c):
        placed = False
        for _ in range(n_classes):
            cls = order[ptr % n_classes]
            ptr += 1
            ks = [
                k
                for k in range(n_clients)
                if len(client_classes[k]) < c and cls not in client_classes[k]
            ]
            if ks:
                k = min(ks, key=lambda k_: len(client_classes[k_]))
                client_classes[k].append(cls)
                placed = True
                break
        if not placed:
            break
    owners = {
        cls: [k for k in range(n_clients) if cls in client_classes[k]]
        for cls in range(n_classes)
    }
    idx_per_client: List[List[int]] = [[] for _ in range(n_clients)]
    for cls in range(n_classes):
        own = owners[cls]
        if not own:
            continue  # uncovered class (only when n·C < classes)
        idx = np.where(labels == cls)[0]
        rng.shuffle(idx)
        for k, part in zip(own, np.array_split(idx, len(own))):
            idx_per_client[k].extend(part.tolist())
    return [np.asarray(sorted(ix), np.int64) for ix in idx_per_client]


def iid_partition(seed: int, labels: np.ndarray, n_clients: int) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(labels))
    return [np.asarray(sorted(p), np.int64) for p in np.array_split(idx, n_clients)]


def lognormal_resize(
    seed: int, parts: List[np.ndarray], sigma: float
) -> List[np.ndarray]:
    """Subsample each client's shard so sizes follow a lognormal profile."""
    if sigma <= 0:
        return parts
    rng = np.random.RandomState(seed)
    draws = rng.lognormal(mean=0.0, sigma=sigma, size=len(parts))
    draws = draws / draws.max()
    out = []
    for part, frac in zip(parts, draws):
        n = max(2, int(len(part) * frac))
        out.append(part[rng.permutation(len(part))[:n]])
    return out


def partition_dataset(
    seed: int,
    labels: np.ndarray,
    cfg,
) -> List[np.ndarray]:
    """Dispatch on OFLConfig.partition."""
    if cfg.partition == "dirichlet":
        parts = dirichlet_partition(seed, labels, cfg.num_clients, cfg.alpha)
    elif cfg.partition == "c_cls":
        parts = c_cls_partition(seed, labels, cfg.num_clients, cfg.c_cls)
    elif cfg.partition == "iid":
        parts = iid_partition(seed, labels, cfg.num_clients)
    else:
        raise ValueError(f"unknown partition {cfg.partition!r}")
    return lognormal_resize(seed + 1, parts, cfg.lognormal_sigma)
