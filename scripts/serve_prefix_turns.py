#!/usr/bin/env python3
"""Hot-prefix serving with and without the prefix cache, in turns on one
card.

    python3 scripts/serve_prefix_turns.py [--turns plain,prefix,prefix,plain] [--repeat 2]

``repro_torch.launch.serve`` at smollm-135m's full width on
``hot_prefix_stream`` (16 requests, prompt 128 with a shared 64-token head
on every other prompt, 64 new tokens, 8 slots, 16-token pages, bf16):
``plain`` serves it without the cache, ``prefix`` with ``--prefix-cache``.
One warm-up run builds the kernels, then the turns run in the order given
(``--repeat`` times), one line each with tok/s, p50 latency and TTFT; then
each arm once under ``--profile`` (the device's busy share and the kernels
by device time, logged). Host-bound serving spreads between runs, so only
medians over the turns of one call compare. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SERVE_ARGV = ["--arch", "smollm-135m", "--engine", "continuous", "--kv-layout", "paged", "--requests", "16",
              "--prompt-len", "128", "--gen", "64", "--max-slots", "8", "--page-size", "16", "--device", "cuda",
              "--hot-fraction", "0.5"]
ARMS = {"plain": [], "prefix": ["--prefix-cache"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--turns", default="plain,prefix,prefix,plain")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    from repro_torch.launch import serve

    serve.main(SERVE_ARGV)  # builds the kernels
    runs = {name: [] for name in ARMS}
    for name in args.turns.split(",") * args.repeat:
        r = serve.main(SERVE_ARGV + ARMS[name])
        row = {k: r[k] for k in ("tok_per_s", "p50_s", "p95_s", "ttft_p50_s", "wall_s")}
        row["prefill_tokens"] = r["stats"]["prefill_tokens"]
        runs[name].append(row)
        print(f"turn {name}: {json.dumps(row)}", flush=True)
    for name, rows in runs.items():
        tok = sorted(r["tok_per_s"] for r in rows)
        print(f"{name}: tok/s {json.dumps(tok)}, median {tok[len(tok) // 2 - 1: len(tok) // 2 + 1]}", flush=True)
    for name, flags in ARMS.items():
        r = serve.main(SERVE_ARGV + flags + ["--profile"])
        print(f"{name} profiled: device busy {r['device_busy_s']:.3f} s of {r['wall_s']:.3f} s wall, idle share "
              f"{1 - r['device_busy_s'] / r['wall_s']:.3f}", flush=True)


if __name__ == "__main__":
    main()
