"""Continuous-batching serving of the distilled server LM (the port's copy
of ``repro.serve``).

* :mod:`repro_torch.serve.engine`    — :class:`PrefillWorker`,
  :class:`DecodeWorker` and their colocated composition
  :class:`ServeEngine`: bucketed prefill admission, slot-based decode
  chunks with on-device sampling and one host sync per chunk.
* :mod:`repro_torch.serve.kv_pool`   — the paged KV pool: host-side page
  allocator with refcounts, staging and the scratch page.
* :mod:`repro_torch.serve.scheduler` — :class:`FleetRouter` and its N=1
  case ``ContinuousScheduler``; request clocks.
* :mod:`repro_torch.serve.static`    — the static-batch baseline on the
  dense cache, the cross-layout parity oracle.
* :mod:`repro_torch.serve.traffic` / :mod:`repro_torch.serve.metrics` —
  a seeded request stream and latency percentiles.
"""
from repro_torch.serve.engine import (
    DecodeState,
    DecodeWorker,
    EngineConfig,
    KVHandoff,
    PrefillWorker,
    ServeEngine,
    sample_tokens,
)
from repro_torch.serve.kv_pool import KVPool
from repro_torch.serve.metrics import latency_summary, percentile
from repro_torch.serve.scheduler import (
    Completion,
    ContinuousScheduler,
    FleetRouter,
    ManualClock,
    MonotonicClock,
    Request,
)
from repro_torch.serve.static import static_generate
from repro_torch.serve.traffic import staggered_stream

__all__ = [
    "DecodeState",
    "DecodeWorker",
    "EngineConfig",
    "KVHandoff",
    "KVPool",
    "PrefillWorker",
    "ServeEngine",
    "sample_tokens",
    "Completion",
    "ContinuousScheduler",
    "FleetRouter",
    "ManualClock",
    "MonotonicClock",
    "Request",
    "latency_summary",
    "percentile",
    "staggered_stream",
    "static_generate",
]
