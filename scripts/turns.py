#!/usr/bin/env python3
"""Two trees of the port on one card, in turns: the kernels that a change
redesigned, LM training and serving.

    python3 scripts/turns.py PARENT_DIR [--order parent,change,change,parent] [--parts kernels,train,serve]
                             [--serve-runs N] [--out DIR]

``PARENT_DIR`` is an unpacked checkout of the commit to compare with
(``git archive <commit> | tar -x -C PARENT_DIR``); "change" is the checkout
this script lies in. Each turn runs in a fresh process on one tree, which
builds that tree's kernels into its own ``build/`` and then measures, in
bf16 at the main paths' shapes:

* the dq pass (``flash_attention_bwd_dq``) at the LM training shape (8 ×
  256 tokens, 9 heads over 3 kv heads, hd 64, causal) and paged decode
  (``flash_decode``) at the serving decode shape (8 slots at position 160,
  16-token pages, 12 table entries): per wrapper call (CUDA events around
  back-to-back calls) and on the device alone (CUDA-graph replay), with
  SDPA's backward on the same inputs beside the dq pass;
* ``repro_torch.launch.train`` at full width (batch 8, seq 256, 30 steps,
  AdamW): tok/s after the first step, s/step, the loss;
* ``repro_torch.launch.serve`` at full width (16 requests, prompt 128, 64
  new tokens, 8 slots): tok/s, p50 and p95 latency;
* each of the two again under ``torch.profiler`` (12 training steps, the
  same request stream): device busy seconds, wall seconds and the kernels
  by device time (in the turn's log).

``--parts`` picks which of the three a turn measures; ``--serve-runs``
repeats the unprofiled serving run within each turn. Each turn prints one
JSON line; the last lines are the card's name and power limit and a table
of every turn. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
TRAIN_ARGV = ["--arch", "smollm-135m", "--batch", "8", "--seq", "256", "--optimizer", "adamw", "--device", "cuda"]
SERVE_ARGV = ["--arch", "smollm-135m", "--engine", "continuous", "--kv-layout", "paged", "--requests", "16",
              "--prompt-len", "128", "--gen", "64", "--max-slots", "8", "--page-size", "16", "--device", "cuda"]


def one_turn(tree: Path, parts, serve_runs: int) -> dict:
    """Measure one tree in this process (its package first on the path)."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))  # chip_smoke.py's timing helpers and cases
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.build import build_cuda_libraries
    from repro_torch.kernels.flash_attention.kernel import BWD_SOURCE, SM90_SOURCE, SOURCE
    from repro_torch.kernels.flash_decode.kernel import SOURCE as FD_SOURCE
    from repro_torch.launch import serve, train
    from repro_torch.utils.device import disable_tf32

    disable_tf32()
    t0 = time.perf_counter()
    build_cuda_libraries([SOURCE, BWD_SOURCE, SM90_SOURCE, FD_SOURCE])
    res = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    dev = torch.device("cuda")
    if "kernels" in parts:
        res.update(time_kernels(cs, dev))
    if "train" in parts:
        r = train.main(TRAIN_ARGV + ["--steps", "30"])
        res["train"] = {n: r[n] for n in ("tok_per_s", "s_per_step", "first10", "last10", "max_memory_bytes")}
        r = train.main(TRAIN_ARGV + ["--steps", "12", "--profile"])
        res["train_profile"] = {"device_busy_s": r["device_busy_s"], "steps": 11,
                                "device_ms_per_step": r["device_busy_s"] * 1e3 / 11}
    if "serve" in parts:
        runs = [serve.main(SERVE_ARGV) for _ in range(serve_runs)]
        res["serve"] = {n: [r[n] for r in runs] for n in ("tok_per_s", "p50_s", "p95_s", "wall_s")}
        r = serve.main(SERVE_ARGV + ["--profile"])
        res["serve_profile"] = {"device_busy_s": r["device_busy_s"], "wall_s": r["wall_s"],
                                "idle_share": 1 - r["device_busy_s"] / r["wall_s"]}
    return res


def time_kernels(cs, dev) -> dict:
    """The dq pass and paged decode, per call and on the device alone."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_dq
    from repro_torch.kernels.flash_attention.ref import attention_delta, flash_attention_ref_lse
    from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd

    q, k, v = cs._attn_case(8, 256, 256, 9, 3, 64, torch.bfloat16, seed=20, device=dev)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(30)).to(torch.bfloat16).to(dev)
    out, lse = flash_attention_ref_lse(q, k, v, causal=True)
    args = (q, k, v, dout, lse, attention_delta(out, dout))
    dq = lambda: flash_attention_bwd_dq(*args, causal=True)
    both, fwd = cs._sdpa_bwd(q, k, v, dout)
    res = {}
    res["dq"] = {"ms": cs._time_ms(dq, iters=50), "device_ms": cs._graph_ms(dq),
                 "sdpa_bwd_ms": cs._time_ms(both, iters=50) - cs._time_ms(fwd, iters=50),
                 "sdpa_bwd_device_ms": cs._graph_ms(both) - cs._graph_ms(fwd)}

    mid = 128 + 64 // 2
    qd, kp, vp, table, pos, kw, _ = cs._decode_case(8, 9, 3, 64, 16, 12, 0, [mid] * 8, torch.bfloat16, seed=10,
                                                    device=dev)
    dec = lambda: flash_decode_fwd(qd, kp, vp, table, pos, **kw)
    res["decode"] = {"ms": cs._time_ms(dec), "device_ms": cs._graph_ms(dec)}
    print(f"kernels: {json.dumps(res)}", flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", help="unpacked checkout of the commit to compare with")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--parts", default="kernels,train,serve")
    ap.add_argument("--serve-runs", type=int, default=1)
    ap.add_argument("--out", default=str(HERE / "build" / "turns"), help="directory for each turn's log")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # internal: measure this tree in this process
    args = ap.parse_args()
    if args.one:
        print("TURN " + json.dumps(one_turn(Path(args.one).resolve(), args.parts.split(","), args.serve_runs)),
              flush=True)
        return

    import torch

    if not torch.cuda.is_available() or args.parent is None:
        sys.exit("needs a CUDA card and the parent's checkout")
    trees = {"parent": Path(args.parent).resolve(), "change": HERE}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    turns = []
    for i, name in enumerate(args.order.split(",")):
        log = out / f"{i}-{name}.log"
        with open(log, "w") as f:
            proc = subprocess.run([sys.executable, __file__, "--one", str(trees[name]), "--parts", args.parts,
                                   "--serve-runs", str(args.serve_runs)], stdout=f, stderr=subprocess.STDOUT,
                                  timeout=1200)
        lines = [ln for ln in log.read_text().splitlines() if ln.startswith("TURN ")]
        if proc.returncode != 0 or not lines:
            sys.exit(f"turn {i} ({name}) failed with code {proc.returncode}; see {log}")
        res = json.loads(lines[-1][5:])
        res["turn"], res["name"] = i, name
        print(json.dumps(res), flush=True)
        turns.append(res)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    for t in turns:
        cols = [f"{t['turn']} {t['name']:6s}"]
        if "dq" in t:
            cols.append(f"dq {t['dq']['ms']:.4f} ms (device {t['dq']['device_ms']:.4f}; SDPA bwd "
                        f"{t['dq']['sdpa_bwd_ms']:.4f}, device {t['dq']['sdpa_bwd_device_ms']:.4f})")
            cols.append(f"decode {t['decode']['ms']:.4f} ms (device {t['decode']['device_ms']:.4f})")
        if "train" in t:
            cols.append(f"train {t['train']['tok_per_s']:.1f} tok/s, "
                        f"{t['train_profile']['device_ms_per_step']:.2f} device ms/step")
        if "serve" in t:
            cols.append("serve " + ", ".join(f"{x:.1f}" for x in t["serve"]["tok_per_s"]) + " tok/s, p50 "
                        + ", ".join(f"{x:.3f}" for x in t["serve"]["p50_s"]) + f" s, idle "
                        f"{t['serve_profile']['idle_share']:.3f}")
        print(" | ".join(cols))

if __name__ == "__main__":
    main()
