"""The per-phase device split of a ``--profile-dir`` trace.

    PYTHONPATH=src python -m repro_torch.obs.phases PROFILE_DIR/torch_trace.json

Each kernel, copy or memset on the device is attributed to the host range
from which it was launched, by the profiler's launch correlation (the
``correlation`` id a device event shares with its ``cudaLaunchKernel`` /
``cuLaunchKernel`` / ``cudaMemcpyAsync`` record), not to the range its
device timestamp falls in: an eager epoch's kernels run after the host
range that launched them has closed. A launch counts for a range when its
host timestamp lies inside one of the range's ``record_function`` events
of the same process, on any thread: autograd launches a backward's kernels
from its own device thread while the thread that opened the range waits in
``backward()``, so the range's own thread would miss them.

The default ranges are the three Algorithm 1 phases of
:func:`repro_torch.core.epoch.make_coboost_epoch` (``ofl.gen.boost``,
``ofl.ee.weight_search``, ``ofl.kd``), inside the ``ofl.epoch`` span of
:func:`repro_torch.core.coboosting.run_coboosting`.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from typing import Dict, Sequence

OFL_PHASES = ("ofl.gen.boost", "ofl.ee.weight_search", "ofl.kd")
OFL_OUTER = "ofl.epoch"

# Chrome-trace categories of torch.profiler (Kineto): device work, and the
# host API records that launched it
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_RANGE_CAT = "user_annotation"


def device_split(trace_path: str, ranges: Sequence[str] = OFL_PHASES, outer: str = OFL_OUTER, top: int = 5) -> Dict:
    """Device time launched inside each of ``ranges`` and inside ``outer``.

    Returns ``{"ranges": {name: {"device_ms", "launches", "count", "top"}},
    "outer": {...}, "device_ms": all device time in the trace,
    "unattributed": {"device_ms", "launches"}}``: ``count`` is the number of
    host ranges of that name, ``launches`` the device events attributed to
    them, ``top`` their ``top`` largest device-event names as ``[name,
    device_ms, events]``, ``unattributed`` the device events whose launch
    record the trace lacks."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = tuple(ranges) + (outer,)
    intervals = {n: defaultdict(list) for n in names}  # name -> pid -> [(t0, t1)]
    launches = {}  # correlation -> (pid, ts)
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == HOST_RANGE_CAT and ev.get("name") in intervals:
            intervals[ev["name"]][ev["pid"]].append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
        elif cat in LAUNCH_CATS and "correlation" in ev.get("args", {}):
            launches[ev["args"]["correlation"]] = (ev["pid"], float(ev["ts"]))
        elif cat in DEVICE_CATS:
            device.append(ev)
    for by_process in intervals.values():
        for ivs in by_process.values():
            ivs.sort()

    def inside(name, pid, ts) -> bool:
        ivs = intervals[name].get(pid, ())
        i = bisect.bisect_right(ivs, (ts, float("inf"))) - 1
        return i >= 0 and ivs[i][0] <= ts <= ivs[i][1]

    totals = {n: [0.0, 0] for n in names}
    by_kernel = {n: defaultdict(lambda: [0.0, 0]) for n in names}
    lost = [0.0, 0]
    all_us = 0.0
    for ev in device:
        dur = float(ev.get("dur", 0.0))
        all_us += dur
        src = launches.get(ev.get("args", {}).get("correlation"))
        if src is None:
            lost[0] += dur
            lost[1] += 1
            continue
        for n in names:
            if inside(n, *src):
                totals[n][0] += dur
                totals[n][1] += 1
                by_kernel[n][ev["name"]][0] += dur
                by_kernel[n][ev["name"]][1] += 1

    def entry(n):
        count = sum(len(v) for v in intervals[n].values())
        largest = sorted(by_kernel[n].items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ms": totals[n][0] / 1e3, "launches": totals[n][1], "count": count,
                "top": [[k, us / 1e3, c] for k, (us, c) in largest]}

    return {
        "ranges": {n: entry(n) for n in ranges},
        "outer": entry(outer),
        "device_ms": all_us / 1e3,
        "unattributed": {"device_ms": lost[0] / 1e3, "launches": lost[1]},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("trace", help="the Chrome trace a --profile-dir run wrote (torch_trace.json)")
    args = p.parse_args(argv)
    split = device_split(args.trace)
    outer = split["outer"]
    per = max(outer["count"], 1)
    print(f"{OFL_OUTER}: {outer['count']} ranges, {outer['device_ms']:.3f} device ms launched inside "
          f"({outer['device_ms'] / per:.3f} an epoch) of {split['device_ms']:.3f} in the trace")
    for name, r in split["ranges"].items():
        share = r["device_ms"] / outer["device_ms"] if outer["device_ms"] else 0.0
        print(f"  {name}: {r['device_ms'] / per:.3f} device ms an epoch, {r['launches']} launches, "
              f"share {share:.4f}")
        for kernel, ms, n in r["top"]:
            print(f"      {ms / per:9.3f} ms an epoch, {n} events  {kernel[:100]}")
    lost = split["unattributed"]
    print(f"unattributed (no launch record): {lost['launches']} device events, {lost['device_ms']:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
