"""Metrics registry: counters, gauges and histograms under stable dotted
names (``serve.prefill.dispatches``, ``ofl.epoch.step_s``) with an optional
labels dimension (``replica=0``), the port's copy of ``repro.obs.registry``.
``snapshot()``, ``to_prometheus()`` and ``dump()`` give the reference's
bytes for the same calls (``tests/test_torch_obs.py``).

Components declare their metric names once (:mod:`repro_torch.obs.names`)
and mutate them through a :class:`StatsView`, a dict-shaped adapter:
``stats["admitted"] += 1`` lands in a namespaced, labelled series.

Cost model: a counter bump is a lock and a dict update. A registry built
with ``enabled=False`` (the process-global default until a launcher is
given ``--metrics-out``) turns ``inc``/``observe``/``set_gauge`` into an
attribute check and a return. No method reads a device value: callers
pass host numbers.

Export shapes:

* :meth:`MetricsRegistry.snapshot` — one plain-dict record per labelled
  series (histograms carry count/sum/min/max/p50/p95), JSONL-ready;
* :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  (dots mangled to underscores, labels inline);
* :meth:`MetricsRegistry.dump` — both files in one call, the pair
  ``python -m repro_torch.obs.validate`` checks.
"""
from __future__ import annotations

import json
import os
import threading
from collections.abc import MutableMapping
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Mapping[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _prom_labels(labels: LabelKey) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class MetricsRegistry:
    """Counters, gauges and histograms keyed by (dotted name, label set).

    Thread-safe for the cheap mutators; snapshots are taken under the same
    lock.
    """

    def __init__(self, enabled: bool = True, hist_capacity: int = 4096):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._hist_capacity = hist_capacity
        self._counters: Dict[str, Dict[LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[LabelKey, float]] = {}
        self._hists: Dict[str, Dict[LabelKey, List[float]]] = {}

    # -- mutators ------------------------------------------------------------

    def inc(self, name: str, value: float = 1, **labels) -> None:
        """Add ``value`` to a counter series (created at 0 on first touch)."""
        if not self.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0) + value

    def set_counter(self, name: str, value: float, **labels) -> None:
        """Overwrite a counter series — the cumulative-mirror idiom
        (a view's plain assignment, and the resets that zero a view)."""
        if not self.enabled:
            return
        with self._lock:
            self._counters.setdefault(name, {})[_label_key(labels)] = value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges.setdefault(name, {})[_label_key(labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one histogram observation (ring-bounded at
        ``hist_capacity`` samples per labelled series)."""
        if not self.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            samples = self._hists.setdefault(name, {}).setdefault(key, [])
            samples.append(float(value))
            if len(samples) > self._hist_capacity:
                del samples[: len(samples) - self._hist_capacity]

    def reset(self) -> None:
        """Zero every series (names and labels are forgotten, not kept at 0:
        a snapshot after reset reports only what actually happened since)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- readers -------------------------------------------------------------

    def value(self, name: str, **labels) -> float:
        """One counter/gauge series' current value (0 if never touched)."""
        key = _label_key(labels)
        with self._lock:
            if name in self._counters:
                return self._counters[name].get(key, 0)
            return self._gauges.get(name, {}).get(key, 0)

    def total(self, name: str) -> float:
        """A counter summed across every label set — the fleet aggregate."""
        with self._lock:
            return sum(self._counters.get(name, {}).values())

    def names(self, prefix: str = "") -> List[str]:
        """Every metric name touched so far (optionally prefix-filtered)."""
        with self._lock:
            all_names = set(self._counters) | set(self._gauges) | set(self._hists)
        return sorted(n for n in all_names if n.startswith(prefix))

    def snapshot(self) -> List[dict]:
        """JSONL-ready records, one per labelled series, sorted by name so
        diffs between runs are stable."""
        out: List[dict] = []
        with self._lock:
            for name in sorted(self._counters):
                for key, val in sorted(self._counters[name].items()):
                    out.append(
                        {"name": name, "type": "counter", "labels": dict(key), "value": val}
                    )
            for name in sorted(self._gauges):
                for key, val in sorted(self._gauges[name].items()):
                    out.append(
                        {"name": name, "type": "gauge", "labels": dict(key), "value": val}
                    )
            for name in sorted(self._hists):
                for key, samples in sorted(self._hists[name].items()):
                    xs = np.asarray(samples, np.float64)
                    out.append(
                        {
                            "name": name,
                            "type": "histogram",
                            "labels": dict(key),
                            "count": int(xs.size),
                            "sum": float(xs.sum()),
                            "min": float(xs.min()) if xs.size else 0.0,
                            "max": float(xs.max()) if xs.size else 0.0,
                            "p50": float(np.percentile(xs, 50)) if xs.size else 0.0,
                            "p95": float(np.percentile(xs, 95)) if xs.size else 0.0,
                        }
                    )
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format. Histograms export as summary
        quantiles plus ``_count``/``_sum`` (enough for a scrape/pushgateway
        bridge without carrying raw samples)."""
        lines: List[str] = []
        for rec in self.snapshot():
            pname = _prom_name(rec["name"])
            labels = _label_key(rec["labels"])
            if rec["type"] in ("counter", "gauge"):
                lines.append(f"# TYPE {pname} {rec['type']}")
                lines.append(f"{pname}{_prom_labels(labels)} {rec['value']}")
                continue
            lines.append(f"# TYPE {pname} summary")
            for q, field in (("0.5", "p50"), ("0.95", "p95")):
                qlabels = labels + (("quantile", q),)
                lines.append(f"{pname}{_prom_labels(qlabels)} {rec[field]}")
            lines.append(f"{pname}_count{_prom_labels(labels)} {rec['count']}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} {rec['sum']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, jsonl_path: str, prom_path: Optional[str] = None) -> None:
        """Write the JSONL snapshot (and, by default, a ``.prom`` sibling in
        Prometheus text format)."""
        with open(jsonl_path, "w") as f:
            for rec in self.snapshot():
                f.write(json.dumps(rec) + "\n")
        if prom_path is None:
            prom_path = os.path.splitext(jsonl_path)[0] + ".prom"
        with open(prom_path, "w") as f:
            f.write(self.to_prometheus())

    # -- component adapters --------------------------------------------------

    def view(self, schema: Mapping[str, str], **labels) -> "StatsView":
        """A dict-shaped adapter over this registry: ``schema`` maps each
        component-local key to its namespaced metric name; ``labels`` ride on
        every series the view touches (replica id, arch group, ...)."""
        return StatsView(self, schema, labels)


class StatsView(MutableMapping):
    """A component's ``stats`` mapping, backed by the registry.

    Every key in ``schema`` reads 0 from construction, so ``for k in
    list(stats)`` resets and ``stats["x"] += 1`` bumps work as on a dict,
    but each mutation lands in a namespaced, labelled registry series.
    Unknown keys raise ``KeyError``: key drift between a component and its
    declared namespace is a bug, not a new metric.
    """

    __slots__ = ("_reg", "_schema", "_labels")

    def __init__(self, registry: MetricsRegistry, schema: Mapping[str, str],
                 labels: Mapping[str, object]):
        self._reg = registry
        self._schema = dict(schema)
        self._labels = dict(labels)

    @property
    def registry(self) -> MetricsRegistry:
        return self._reg

    @property
    def labels(self) -> Dict[str, object]:
        return dict(self._labels)

    def metric_name(self, key: str) -> str:
        return self._schema[key]

    def __getitem__(self, key: str) -> float:
        val = self._reg.value(self._schema[key], **self._labels)
        return int(val) if float(val).is_integer() else val

    def __setitem__(self, key: str, value: float) -> None:
        self._reg.set_counter(self._schema[key], value, **self._labels)

    def __delitem__(self, key: str) -> None:  # pragma: no cover - unused
        raise TypeError("StatsView keys are fixed by the component's schema")

    def __iter__(self) -> Iterator[str]:
        return iter(self._schema)

    def __len__(self) -> int:
        return len(self._schema)

    def __contains__(self, key: object) -> bool:
        return key in self._schema

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"StatsView({dict(self)!r}, labels={self._labels!r})"
