"""Seeded synthetic request streams for serving runs and tests (the
port's copy of ``repro.serve.traffic``, pure numpy: the same seed gives the
same stream as the reference).

The scheduler tests draw fully-ragged staggered arrivals. Keeping the
stream here keeps its draw ORDER stable: a property test's two engines must
consume the identical stream, and the order RandomState values are drawn in
IS the stream definition. The reference's other streams (fixed-length
prompts, hot-prefix traffic) come with the prefix cache.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.serve.scheduler import Request


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
