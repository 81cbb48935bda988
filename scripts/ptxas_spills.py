#!/usr/bin/env python3
"""Registers and spills of every attention kernel instantiation, as
``ptxas -v`` reports them for ``sm_90a``.

    python3 scripts/ptxas_spills.py [--json OUT]

Compiles ``flash_attention.cu``, ``flash_attention_bwd.cu``,
``flash_attention_sm90.cu`` and ``flash_decode.cu`` with the flags the port
builds them with (``repro_torch.kernels.build.CUDA_FLAGS``) plus
``-Xptxas -v``, into a temporary directory (the kernel cache is left
alone), and prints one line a kernel: its name, dtype, head dim, registers
a thread, stack frame and spill stores and loads in bytes. Needs ``nvcc``
(the machine with the card has it; this script builds nothing else).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.build import CUDA_FLAGS, nvcc_path  # noqa: E402

KERNELS = ROOT / "src" / "repro_torch" / "kernels"
SOURCES = [KERNELS / "flash_attention" / n for n in ("flash_attention.cu", "flash_attention_bwd.cu",
                                                      "flash_attention_sm90.cu")]
SOURCES.append(KERNELS / "flash_decode" / "flash_decode.cu")

ENTRY = re.compile(r"Compiling entry function '(\S+)'")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers")
# the template arguments of a mangled instantiation, after its name
ARGS = re.compile(r"I(f|13__nv_bfloat16)?(?:Li(\d+)E)?E")


def demangle(mangled: str):
    """``(kernel, dtype, hd)`` of a kernel in an anonymous namespace: the
    last length-prefixed name that ends in ``_kernel`` and its template
    arguments (no ``T``: the bf16-only tensor-core kernels)."""
    # every digit run and each of its tails: the hashes of the namespace run
    # straight into the name's length
    for m in reversed(list(re.finditer(r"(?=(\d+))", mangled))):
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if name.endswith("_kernel") and (a := ARGS.match(mangled, end + len(name))):
            dtype = {"f": "float32", "13__nv_bfloat16": "bfloat16", None: "bfloat16"}[a.group(1)]
            return name, dtype, int(a.group(2)) if a.group(2) else None
    return mangled, None, None


def report(source: Path) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [nvcc_path(), *CUDA_FLAGS, "-Xptxas", "-v", "-o", str(Path(tmp) / "lib.so"), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr[-4000:]}")
    rows, cur = [], None
    for line in proc.stderr.splitlines():
        if m := ENTRY.search(line):
            kernel, dtype, hd = demangle(m.group(1))
            cur = {"source": source.name, "kernel": kernel, "dtype": dtype, "hd": hd}
            rows.append(cur)
        elif cur is not None and (m := FRAME.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif cur is not None and (m := USED.search(line)):
            cur["registers"] = int(m.group(1))
    return rows


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json", default=None, help="also write the rows as JSON here")
    args = p.parse_args()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        rows = [r for rs in pool.map(report, SOURCES) for r in rs]
    rows.sort(key=lambda r: (r["source"], r["kernel"], r["dtype"], r["hd"] or 0))
    for r in rows:
        print(f"{r['source']} {r['kernel']} {r['dtype']} hd {r['hd']}: {r.get('registers')} registers, "
              f"stack {r.get('stack')} B, spill stores {r.get('spill_stores')} B, loads {r.get('spill_loads')} B")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
