"""Minimal numpy batch iteration (host-side; the port's copy of
``repro.data.loader``)."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def shuffle_arrays(seed: int, *arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(arrays[0]))
    return tuple(a[order] for a in arrays)


def batch_iterator(
    x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0, epochs: int = 1, drop_last: bool = False
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    n = len(x)
    for e in range(epochs):
        xs, ys = shuffle_arrays(seed + e, x, y)
        stop = n - (n % batch_size) if drop_last else n
        for i in range(0, stop, batch_size):
            yield xs[i : i + batch_size], ys[i : i + batch_size]
