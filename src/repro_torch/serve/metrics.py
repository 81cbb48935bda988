"""Latency and throughput summaries of a serving run (the port's copy of
``repro.serve.metrics``): tok/s, and np.percentile (linear interpolation)
of end-to-end latency, queue wait (``admitted - arrival``) and TTFT."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float:
    """``np.percentile`` (q in [0, 100]) with an empty-safe 0.0."""
    xs = np.asarray(list(xs), np.float64)
    if xs.size == 0:
        return 0.0
    return float(np.percentile(xs, q))


def latency_summary(completions, wall_s: float) -> Dict[str, float]:
    """tok/s over ``wall_s`` plus p50/p95 of end-to-end latency, of its
    queue-wait share and of TTFT."""
    lats = [c.latency for c in completions]
    waits = [c.queue_wait for c in completions]
    ttfts = [c.ttft for c in completions if getattr(c, "first_token", None) is not None]
    toks = sum(len(c.tokens) for c in completions)
    return {
        "tok_per_s": toks / max(wall_s, 1e-9),
        "tokens": float(toks),
        "p50_s": percentile(lats, 50),
        "p95_s": percentile(lats, 95),
        "queue_wait_p50_s": percentile(waits, 50),
        "queue_wait_p95_s": percentile(waits, 95),
        "ttft_p50_s": percentile(ttfts, 50),
        "ttft_p95_s": percentile(ttfts, 95),
    }
