"""Telemetry artifact validator (the port's copy of ``repro.obs.validate``:
the same checks and exit codes).

    PYTHONPATH=src python -m repro_torch.obs.validate \
        --metrics serve_metrics.jsonl --trace serve_trace.json

Fails (exit 1) when:

* the trace file is not parseable Chrome trace-event JSON, has no
  ``traceEvents``, or any event lacks ``name``/``ts`` (or, for complete
  events, ``dur``);
* per thread, complete-event start timestamps are not monotonically
  non-decreasing (a scrambled ring buffer / clock bug);
* the metrics JSONL snapshot is unreadable or is missing any of the
  required serve-namespace keys
  (:data:`repro_torch.obs.names.REQUIRED_SERVE_KEYS`) — the drift guard
  that keeps a component rename from silently emptying the dashboards.

``--train`` switches the required-key set to the ofl namespace.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from repro_torch.obs.names import REQUIRED_SERVE_KEYS

REQUIRED_OFL_KEYS = ("ofl.epoch.count", "ofl.epoch.step_s")


def validate_trace(path: str) -> list:
    """Returns the parsed events; raises ValueError on malformed traces."""
    with open(path) as f:
        doc = json.load(f)  # json.loads round-trip IS the parseability check
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents is not a list")
    last_ts = defaultdict(lambda: float("-inf"))
    for ev in events:
        if "name" not in ev or "ts" not in ev:
            raise ValueError(f"{path}: event missing name/ts: {ev!r}")
        if ev.get("ph", "X") == "X" and "dur" not in ev:
            raise ValueError(f"{path}: complete event missing dur: {ev!r}")
        tid = ev.get("tid", 0)
        if ev["ts"] < last_ts[tid]:
            raise ValueError(
                f"{path}: non-monotonic ts on tid {tid}: {ev['ts']} after {last_ts[tid]}"
            )
        last_ts[tid] = ev["ts"]
    return events


def validate_metrics(path: str, required=REQUIRED_SERVE_KEYS) -> list:
    """Returns the parsed records; raises ValueError on missing keys."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as ex:
                raise ValueError(f"{path}:{i + 1}: unparseable JSONL line: {ex}")
    names = {r.get("name") for r in records}
    missing = [k for k in required if k not in names]
    if missing:
        raise ValueError(
            f"{path}: metrics snapshot is missing required keys {missing} "
            f"(has {len(names)} names) — component/namespace drift?"
        )
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--metrics", default=None, help="metrics JSONL snapshot")
    p.add_argument("--trace", default=None, help="Chrome trace-event JSON")
    p.add_argument("--train", action="store_true",
                   help="require the ofl.* namespace instead of serve.*")
    args = p.parse_args(argv)
    if not args.metrics and not args.trace:
        p.error("nothing to validate: pass --metrics and/or --trace")
    try:
        if args.trace:
            events = validate_trace(args.trace)
            print(f"ok: {args.trace} ({len(events)} events)")
        if args.metrics:
            required = REQUIRED_OFL_KEYS if args.train else REQUIRED_SERVE_KEYS
            records = validate_metrics(args.metrics, required)
            print(f"ok: {args.metrics} ({len(records)} series)")
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as ex:
        print(f"telemetry validation FAILED: {ex}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
