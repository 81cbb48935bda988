"""Telemetry for the port's Co-Boosting and serving paths (the port's copy
of ``repro.obs``).

Three layers, one import:

* **metrics registry** (:mod:`repro_torch.obs.registry`) — counters,
  gauges and histograms under stable dotted names with a labels dimension
  (replica id). Components hold a :class:`StatsView` over a registry; the
  names live once in :mod:`repro_torch.obs.names`.
* **span tracer** (:mod:`repro_torch.obs.tracer`) — ``with
  obs.span("name"):`` host-side nested spans into a ring buffer, exported
  as Chrome trace-event JSON; while a ``torch.profiler`` profile runs
  (``--profile-dir``), every span also enters a ``record_function`` range.
* **per-phase device split** (:mod:`repro_torch.obs.phases`) — the device
  time of the kernels launched inside each ``record_function`` range of a
  ``--profile-dir`` trace.

Module-level state: one process-global registry and one process-global
tracer, both disabled until :func:`configure` (driven by the launchers'
``--metrics-out`` / ``--trace-out`` / ``--profile-dir``) switches them on.
Disabled, a call site costs an attribute check. Serving components create
private always-on registries for their own stats unless a launcher hands
them the shared one.
"""
from repro_torch.obs.names import (
    KV_GAUGES,
    OFL_HISTOGRAMS,
    OFL_METRICS,
    REQUEST_HISTOGRAMS,
    REQUIRED_SERVE_KEYS,
    ROUTER_METRICS,
    SERVE_ENGINE_METRICS,
    serve_namespace,
)
from repro_torch.obs.registry import MetricsRegistry, StatsView
from repro_torch.obs.tracer import SpanTracer, start_torch_profile, stop_torch_profile

_registry = MetricsRegistry(enabled=False)
_tracer = SpanTracer()


def registry() -> MetricsRegistry:
    """The process-global registry (disabled until :func:`configure`)."""
    return _registry


def tracer() -> SpanTracer:
    """The process-global span tracer (disabled until :func:`configure`)."""
    return _tracer


def span(name: str, **args):
    """Open a span on the global tracer (no-op context when disabled)."""
    return _tracer.span(name, **args)


def instant(name: str, **args) -> None:
    """Zero-duration marker on the global tracer."""
    _tracer.instant(name, **args)


def observe(name: str, value: float, **labels) -> None:
    """Histogram observation on the global registry (no-op when disabled)."""
    _registry.observe(name, value, **labels)


def inc(name: str, value: float = 1, **labels) -> None:
    """Counter bump on the global registry (no-op when disabled)."""
    _registry.inc(name, value, **labels)


def configure(metrics: bool = False, trace: bool = False, profile_dir: str = None,
              trace_capacity: int = 65536, device="cuda") -> None:
    """Switch the process-global telemetry on/off (launcher flag plumbing).

    ``metrics`` enables the global registry and empties it, ``trace`` the
    span tracer (its ring is cleared so a run's export starts at t=0): a
    launcher's ``main`` run twice in one process exports each run alone.
    ``profile_dir`` starts a ``torch.profiler`` profile on ``device``
    (CUDA activity too on a CUDA device), bridging every span to a
    ``record_function`` range; it raises if the profile cannot start."""
    global _tracer
    _registry.enabled = metrics
    if metrics:
        _registry.reset()
    if trace and _tracer._events.maxlen != trace_capacity:
        _tracer = SpanTracer(capacity=trace_capacity)
    _tracer.enabled = trace
    if trace:
        _tracer.clear()
    if profile_dir:
        start_torch_profile(_tracer, profile_dir, device)


__all__ = [
    "MetricsRegistry",
    "StatsView",
    "SpanTracer",
    "KV_GAUGES",
    "OFL_HISTOGRAMS",
    "OFL_METRICS",
    "REQUEST_HISTOGRAMS",
    "REQUIRED_SERVE_KEYS",
    "ROUTER_METRICS",
    "SERVE_ENGINE_METRICS",
    "serve_namespace",
    "registry",
    "tracer",
    "span",
    "instant",
    "observe",
    "inc",
    "configure",
    "start_torch_profile",
    "stop_torch_profile",
]
