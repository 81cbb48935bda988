"""Seeded synthetic request streams for serving runs and tests (the
port's copy of ``repro.serve.traffic``, pure numpy: the same seed gives the
same stream as the reference).

Three stream shapes: fixed-length prompts with ragged budgets, fully-ragged
staggered arrivals, and hot-prefix traffic where a fraction of prompts share
a long common head (the prefix cache's workload). Keeping them here keeps
their draw ORDER stable: two engines compared on one stream must consume
the identical stream, and the order RandomState values are drawn in IS the
stream definition.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.scheduler import Request


def ragged_stream(
    vocab_size: int,
    n: int,
    prompt_len: int,
    max_gen: int,
    *,
    seed: int = 0,
    budget_min: int = 8,
) -> Tuple[List[np.ndarray], List[int]]:
    """Fixed-length prompts + ragged budgets, the serve-pair workload.
    Draw order (all prompts, then the budget vector) is part of the
    contract, as in the reference."""
    rng = np.random.RandomState(seed)
    prompts = [
        rng.randint(0, vocab_size, size=prompt_len).astype(np.int32) for _ in range(n)
    ]
    budgets = [int(g) for g in rng.randint(budget_min, max_gen + 1, size=n)]
    return prompts, budgets


def hot_prefix_stream(
    vocab_size: int,
    n: int,
    prompt_len: int,
    max_gen: int,
    *,
    seed: int = 0,
    budget_min: int = 8,
    shared_fraction: float = 0.5,
    prefix_len: Optional[int] = None,
) -> Tuple[List[np.ndarray], List[int]]:
    """Like :func:`ragged_stream` but a ``shared_fraction`` of the prompts
    open with one common ``prefix_len``-token head (default: half the
    prompt) — the system-prompt-heavy traffic a radix prefix cache exists
    for. Shared requests are interleaved with cold ones (even indices hot)
    so admission sees the mix, not two phases."""
    if not 0.0 <= shared_fraction <= 1.0:
        raise ValueError(f"shared_fraction must be in [0, 1], got {shared_fraction}")
    pl = prompt_len // 2 if prefix_len is None else prefix_len
    if pl > prompt_len:
        raise ValueError(f"prefix_len {pl} exceeds prompt_len {prompt_len}")
    rng = np.random.RandomState(seed)
    head = rng.randint(0, vocab_size, size=pl).astype(np.int32)
    n_hot = int(round(n * shared_fraction))
    hot = {i for i in range(0, n, max(1, n // max(n_hot, 1)))} if n_hot else set()
    hot = set(sorted(hot)[:n_hot])
    prompts = []
    for i in range(n):
        body = rng.randint(0, vocab_size, size=prompt_len).astype(np.int32)
        if i in hot:
            body[:pl] = head
        prompts.append(body)
    budgets = [int(g) for g in rng.randint(budget_min, max_gen + 1, size=n)]
    return prompts, budgets


def with_arrivals(
    prompts: Sequence[np.ndarray], budgets: Sequence[int], dt: float
) -> List[Request]:
    """Stamp a prompt/budget stream into :class:`Request`s arriving every
    ``dt`` seconds — the re-stamping step every calibrated A/B repeats with
    a different gap."""
    return [
        Request(rid=i, tokens=p, max_new_tokens=int(b), arrival=i * dt)
        for i, (p, b) in enumerate(zip(prompts, budgets))
    ]


def staggered_stream(
    vocab_size: int,
    n: int,
    *,
    seed: int = 3,
    prompt_range: Tuple[int, int] = (3, 14),
    budget_range: Tuple[int, int] = (2, 9),
    arrival_span: float = 3.0,
) -> List[Request]:
    """Fully-ragged staggered arrivals (the scheduler property-test
    workload): per request, draw length -> tokens -> budget -> arrival, in
    that order — the interleaved draw sequence the tests have always used."""
    rng = np.random.RandomState(seed)
    return [
        Request(
            rid=i,
            tokens=rng.randint(
                0, vocab_size, size=int(rng.randint(*prompt_range))
            ).astype(np.int32),
            max_new_tokens=int(rng.randint(*budget_range)),
            arrival=float(rng.uniform(0.0, arrival_span)),
        )
        for i in range(n)
    ]
