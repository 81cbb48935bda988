"""Host-side span tracer (the port's copy of ``repro.obs.tracer``): nested
``with obs.span("serve.decode_chunk"): ...`` regions recorded into a
bounded ring buffer and exported as Chrome trace-event JSON (loadable in
Perfetto or ``chrome://tracing``), in the reference's format.

A span brackets one HOST action (a dispatch, a routing decision, an
adoption) and never forces a device sync: its args are host values, so
the engine's one-host-sync-per-chunk contract holds whether tracing is on
or off. When the tracer is disabled (the default) and no profile runs,
:meth:`SpanTracer.span` returns a shared no-op context manager: the cost of
an instrumented call site is one attribute check.

Events use the Chrome "complete" phase (``ph: "X"``): start timestamp and
duration in microseconds plus the recording thread id, so nesting is
containment. The enclosing span's name is also recorded in
``args.parent`` (from a per-thread stack).

**The profiler bridge.** Where the reference bridges to ``jax.profiler``
(``start_jax_profile`` / ``stop_jax_profile``), the port bridges to
``torch.profiler``: :func:`start_torch_profile` and
:func:`stop_torch_profile` replace them. While a profile runs, every span
also enters :func:`torch.profiler.record_function` of its name, so host
spans and the kernels they launch line up in one trace. Unlike the
reference, a profile that cannot start raises, and a profile of a CUDA run
always records CUDA activity: it never drops to a CPU-only trace.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Deque, List, Optional

#: File name of the profiler's Chrome trace inside ``--profile-dir``.
PROFILE_TRACE = "torch_trace.json"


class _NullSpan:
    """Shared no-op context manager — the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0
        self._ann = None

    def __enter__(self):
        tr = self._tracer
        if tr.profile is not None:
            import torch

            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        stack = tr._stack()
        if stack:
            self.args.setdefault("parent", stack[-1])
        stack.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        if tr.enabled:
            tr._record(self.name, self._t0, t1, self.args)
        if self._ann is not None:
            self._ann.__exit__(*exc)
        return False


class SpanTracer:
    """Ring-buffered host span recorder with Chrome trace-event export."""

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self.profile = None  # the running torch.profiler.profile, if any
        self.profile_dir: Optional[str] = None
        self._events: Deque[dict] = deque(maxlen=capacity)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._origin_ns = time.perf_counter_ns()

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **args):
        """Open a span; a disabled tracer with no profile running hands back
        a shared no-op. With a profile running, the span enters its
        ``record_function`` range even when recording is off."""
        if not self.enabled and self.profile is None:
            return _NULL_SPAN
        return _Span(self, name, args)

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, name: str, t0_ns: int, t1_ns: int, args: dict) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0_ns - self._origin_ns) / 1e3,  # microseconds
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": 0,
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event (arrivals, routing decisions)."""
        if not self.enabled:
            return
        t = time.perf_counter_ns()
        self._record(name, t, t, args)

    # -- lifecycle -----------------------------------------------------------

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
        self._origin_ns = time.perf_counter_ns()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- export --------------------------------------------------------------

    def events(self) -> List[dict]:
        """Events sorted by start time (ties: longest span first, so a parent
        precedes the children it contains). The ring records at span exit,
        so children land before their parents; the export re-sorts, which
        also makes per-thread ``ts`` monotonic for the validator."""
        with self._lock:
            evs = list(self._events)
        return sorted(evs, key=lambda e: (e["ts"], -e.get("dur", 0.0)))

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object Perfetto loads directly."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"recorder": "repro_torch.obs.tracer"},
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# -- torch profiler bridge ---------------------------------------------------


def start_torch_profile(tracer: SpanTracer, profile_dir: str, device="cuda") -> None:
    """Start ``torch.profiler.profile`` over CPU activity and, when
    ``device`` is a CUDA device, CUDA activity; every span of ``tracer``
    enters a ``record_function`` range of its name until
    :func:`stop_torch_profile`. Raises when a profile already runs, when
    this torch cannot trace CUDA on a CUDA run, or when the profiler fails
    to start: no fallback hides the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile, supported_activities

    if tracer.profile is not None:
        raise RuntimeError("a torch profile is already running on this tracer")
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "--profile-dir on a CUDA run, but this torch's profiler cannot trace CUDA "
                "activity (no CUPTI): refusing a CPU-only profile"
            )
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    tracer.profile, tracer.profile_dir = prof, profile_dir


def stop_torch_profile(tracer: SpanTracer) -> str:
    """Stop the profile :func:`start_torch_profile` started and write its
    Chrome trace into the profile directory; returns the trace's path."""
    prof, profile_dir = tracer.profile, tracer.profile_dir
    if prof is None:
        raise RuntimeError("no torch profile is running on this tracer")
    tracer.profile, tracer.profile_dir = None, None
    prof.stop()
    path = os.path.join(profile_dir, PROFILE_TRACE)
    prof.export_chrome_trace(path)
    return path
