#!/usr/bin/env python3
"""How far xlstm-125m's f32 logits lie from exact arithmetic, on one device:

    python3 scripts/xlstm_rounding.py                  # on the card
    python3 scripts/xlstm_rounding.py --device cpu     # on the CPU (about a minute)

The same weights (``init_lm``, seed 1) and tokens (6 requests × 160) run
through ``lm_forward`` four ways: f32 with the 6 requests batched, f32 one
request at a time, and the same two in f64 (:func:`float64_model`). Printed
as one JSON object, each gap as ``max |a - b| / (1 + |b|)``: the logits at
every position and at the last (the prefill's), and each layer's mixer
output (relative to its largest |value|) over each of the scan's chunks.
The f64 batch against the f64 requests alone shows whether a request's
logits depend on the others in its batch (a fault would show at any
precision); the f32 runs against f64 show the model's own f32 floor.

:func:`float64_model` also serves ``scripts/mesh_cards.py`` its exact
reference for an arch with no attention layer.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

from repro_torch.config.registry import get_arch  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models import xlstm as xl  # noqa: E402
from repro_torch.utils.device import disable_tf32  # noqa: E402

ARCH, REQUESTS, LENGTH = "xlstm-125m", 6, 160


def to_float64(tree):
    """Every floating leaf of ``tree`` as f64."""
    return pytree.tree_map(lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point() else t, tree)


def float64_config(cfg):
    return cfg.replace(dtype="float64", param_dtype="float64", logit_dtype="float64")


@contextlib.contextmanager
def float64_model():
    """While open, the port's model runs in f64 when given f64 params
    (:func:`to_float64`) and :func:`float64_config`: its f32 upcasts
    (``Tensor.float``) keep f64, and the recurrent carries start in f64.
    An exact reference only: no hand kernel has an f64 version, so on a
    card the model must have no attention layer."""
    saved = torch.Tensor.float, xl.init_mlstm_state, xl.init_slstm_state
    tr.DTYPES["float64"] = torch.float64
    torch.Tensor.float = lambda self: self.to(torch.float64)
    xl.init_mlstm_state = lambda *a, **k: to_float64(saved[1](*a, **k))
    xl.init_slstm_state = lambda *a, **k: to_float64(saved[2](*a, **k))
    try:
        yield
    finally:
        torch.Tensor.float, xl.init_mlstm_state, xl.init_slstm_state = saved
        del tr.DTYPES["float64"]


def rel_gap(got, want) -> float:
    return float(((got - want).abs() / (1 + want.abs())).max())


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu")
    disable_tf32()
    cfg = get_arch(ARCH).replace(dtype="float32", param_dtype="float32")
    from repro_torch.data.synthetic import make_token_stream

    tokens = make_token_stream(7, cfg.vocab_size, REQUESTS, LENGTH)["tokens"][:, :LENGTH]
    tokens = torch.as_tensor(tokens.astype(np.int64), device=dev)
    params = tr.init_lm(cfg, torch.Generator(device=dev).manual_seed(1))

    taps = []  # (kind, mixer output) of each layer, in order
    mixers = xl.mlstm_forward, xl.slstm_forward

    def tapped(fn, kind):
        def run(*a, **k):
            out = fn(*a, **k)
            taps.append((kind, (out[0] if isinstance(out, tuple) else out).detach().double()))
            return out
        return run

    def forward(p, c, rows):
        taps.clear()
        with torch.no_grad():
            logits = tr.lm_forward(p, c, {"tokens": tokens[rows]})[0].double()
        return logits, [t for _, t in taps]

    def batch_and_alone(p, c):
        """(logits, layer outputs) of the batch and of each request alone, stacked."""
        batch = forward(p, c, slice(None))
        alone = [forward(p, c, slice(i, i + 1)) for i in range(REQUESTS)]
        return batch, (torch.cat([a[0] for a in alone]),
                       [torch.cat([a[1][j] for a in alone]) for j in range(len(batch[1]))])

    xl.mlstm_forward, xl.slstm_forward = tapped(mixers[0], "mlstm"), tapped(mixers[1], "slstm")
    try:
        t0 = time.perf_counter()
        (b32, l32), (a32, la32) = batch_and_alone(params, cfg)
        t1 = time.perf_counter()
        with float64_model():
            (b64, l64), (a64, la64) = batch_and_alone(to_float64(params), float64_config(cfg))
        t2 = time.perf_counter()
    finally:
        xl.mlstm_forward, xl.slstm_forward = mixers
    kinds = [k for k, _ in tr.layer_kinds(cfg)]
    chunks = [(s, min(s + cfg.ssm_chunk, LENGTH)) for s in range(0, LENGTH, cfg.ssm_chunk)]

    def layer_gap(a, b, lo, hi):
        return float((a[:, lo:hi] - b[:, lo:hi]).abs().max() / b.abs().max())

    layers = [{"layer": j, "kind": kinds[j], **{
        f"{name} [{lo}, {hi})": layer_gap(a, b, lo, hi)
        for name, (a, b) in (("f32 batch vs f64", (l32[j], l64[j])), ("f32 alone vs f64", (la32[j], l64[j])),
                             ("f32 batch vs alone", (l32[j], la32[j])), ("f64 batch vs alone", (l64[j], la64[j])))
        for lo, hi in chunks}} for j in range(len(l32))]
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    out = {
        "device": name, "torch": torch.__version__, "arch": cfg.name, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "requests": REQUESTS, "length": LENGTH, "seconds_f32_f64": [t1 - t0, t2 - t1],
        "logits_every_position": {"f32 batch vs alone": rel_gap(a32, b32), "f64 batch vs alone": rel_gap(a64, b64),
                                  "f32 batch vs f64": rel_gap(b32, b64), "f32 alone vs f64": rel_gap(a32, b64)},
        "logits_last_position": {"f32 batch vs alone": rel_gap(a32[:, -1], b32[:, -1]),
                                 "f32 batch vs f64": rel_gap(b32[:, -1], b64[:, -1]),
                                 "f32 alone vs f64": rel_gap(a32[:, -1], b64[:, -1])},
        "layer_outputs": layers,
    }
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
