"""Every component's metric names, declared once (the port's copy of
``repro.obs.names``, key for key).

Components declare their **local key → namespaced metric name** schema
here and mutate it through a :class:`repro_torch.obs.registry.StatsView`;
``tests/test_torch_obs.py`` holds these tables equal to the reference's and
checks that what a serving run touches is exactly what they declare.

Namespaces:

* ``serve.admit.*``    — request admission
* ``serve.prefill.*``  — bucketed prefill dispatches/tokens
* ``serve.handoff.*``  — sealed prefill→decode handoffs
* ``serve.decode.*``   — decode chunks and the once-per-chunk host syncs
* ``serve.slots.*``    — slot lifecycle
* ``serve.kv.*``       — page pool traffic (allocs, appends, CoW, resets)
* ``serve.prefix.*``   — prefix cache hits/splices
* ``serve.spec.*``     — speculative draft/verify
* ``serve.router.*``   — fleet routing decisions
* ``serve.request.*``  — per-request latency breakdown (TTFT, queue wait)
* ``ofl.*``            — the Co-Boosting epoch (generator boost, EE weight
  search, KD distillation)
"""
from __future__ import annotations

# -- serving engine (ServeEngine / PrefillWorker / DecodeWorker) -------------
# Local keys are the historical stats-dict keys; metric names are the stable
# export namespace. Adding an engine counter means adding it HERE (the
# engine's StatsView rejects unknown keys).
SERVE_ENGINE_METRICS = {
    "admitted": "serve.admit.requests",
    "prefill_dispatches": "serve.prefill.dispatches",
    "prefill_tokens": "serve.prefill.tokens",
    "handoffs": "serve.handoff.count",
    "decode_chunks": "serve.decode.chunks",
    "host_syncs": "serve.decode.host_syncs",
    "evicted": "serve.slots.evicted",
    "page_appends": "serve.kv.page_appends",
    "pages_allocated": "serve.kv.pages_allocated",
    "table_resets": "serve.kv.table_resets",
    # radix prefix cache (serve/prefix_cache.py)
    "prefix_hits": "serve.prefix.hits",
    "spliced_admissions": "serve.prefix.spliced_admissions",
    "spliced_pages": "serve.prefix.spliced_pages",
    "cow_copies": "serve.kv.cow_copies",
    # speculative decoding (serve/spec_decode.py)
    "spec_steps": "serve.spec.steps",
    "draft_proposed": "serve.spec.draft_proposed",
    "draft_accepted": "serve.spec.draft_accepted",
}

# -- fleet router (serve/scheduler.py) ---------------------------------------
ROUTER_METRICS = {
    "routed": "serve.router.routed",
    "requeued": "serve.router.requeued",
    "affinity_hits": "serve.router.affinity_hits",
}

# -- KV pool / prefix cache occupancy gauges (published at snapshot time) ----
KV_GAUGES = {
    "free_pages": "serve.kv.free_pages",
    "pages_in_use": "serve.kv.pages_in_use",
    "capacity_pages": "serve.kv.capacity_pages",
    "reclaimable_pages": "serve.prefix.reclaimable_pages",
}

# -- per-request latency histograms (serve/metrics.py definitions) -----------
REQUEST_HISTOGRAMS = (
    "serve.request.latency_s",
    "serve.request.queue_wait_s",
    "serve.request.ttft_s",
)

# -- training pipeline (core/coboosting.py + core/epoch.py drivers) ----------
OFL_METRICS = {
    "epochs": "ofl.epoch.count",
    "epoch_dispatches": "ofl.epoch.dispatches",
    "gen_steps": "ofl.gen.steps",
    "ee_steps": "ofl.ee.steps",
    "kd_steps": "ofl.kd.steps",
}

# phase wall-time histograms (seconds); the epoch driver times the whole
# epoch call; the per-phase device split comes from the record_function
# ranges of core/epoch.py in a --profile-dir trace (repro_torch.obs.phases)
OFL_HISTOGRAMS = (
    "ofl.epoch.step_s",
    "ofl.gen.step_s",
    "ofl.ee.step_s",
    "ofl.kd.step_s",
)

#: Metric names a paged continuous-serving smoke run MUST increment — the
#: drift guard's floor (and repro_torch.obs.validate's required-key set).
REQUIRED_SERVE_KEYS = (
    "serve.admit.requests",
    "serve.prefill.dispatches",
    "serve.prefill.tokens",
    "serve.decode.chunks",
    "serve.decode.host_syncs",
    "serve.slots.evicted",
    "serve.kv.pages_allocated",
)


def serve_namespace() -> frozenset:
    """Every declared serve.* metric name (counters + gauges + request
    histograms) — the universe a serving run is allowed to touch."""
    return frozenset(
        list(SERVE_ENGINE_METRICS.values())
        + list(ROUTER_METRICS.values())
        + list(KV_GAUGES.values())
        + list(REQUEST_HISTOGRAMS)
    )
