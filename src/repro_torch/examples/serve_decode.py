"""Serving example on a reduced assigned arch (the port of
``examples/serve_decode.py``): the static batch and the
continuous-batching engine generate the same greedy continuations — the
engine just never waits for a batch to fill and syncs once a decode chunk.

    python -m repro_torch.examples.serve_decode --arch jamba-v0.1-52b [--device cpu]

The flags and their defaults are the reference's, in f32. The weights come
from a ``torch.Generator`` seeded with 0 where the reference uses key 0.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig, get_arch, reduced_variant
from repro_torch.data import make_token_stream
from repro_torch.models import init_lm
from repro_torch.serve import ContinuousScheduler, EngineConfig, Request, ServeEngine, static_generate
from repro_torch.utils.device import disable_tf32, get_device

PAGE = 16
LAYOUTS = ("dense", "paged")


def model_config(arch: str) -> ModelConfig:
    """The reduced variant of ``arch`` in f32; an arch the engine cannot
    serve is refused."""
    cfg = reduced_variant(get_arch(arch)).replace(dtype="float32", param_dtype="float32")
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name}: encoder-only, no decode (src/repro_torch/launch/serve.py refuses it too)")
    if cfg.frontend == "vision":
        raise SystemExit(
            f"{cfg.name}: the continuous engine has no vision-prefix admission yet; "
            "see repro_torch.launch.serve --engine static for the vlm path"
        )
    return cfg


def init_params(cfg: ModelConfig, seed: int, device) -> Dict[str, Any]:
    return init_lm(cfg, torch.Generator(device=device).manual_seed(seed))


def prompts(cfg: ModelConfig, batch: int, prompt: int) -> np.ndarray:
    """(batch, prompt) int32 token prompts, the reference's stream."""
    data = make_token_stream(0, cfg.vocab_size, batch, prompt)
    return data["tokens"][:, :prompt].astype(np.int32)


def generate(cfg: ModelConfig, params: Dict[str, Any], tokens: np.ndarray, gen: int, device) -> dict:
    """The static arm, then the engine in both KV layouts, on the same
    prompts. Returns each arm's tokens (``static``, ``dense``, ``paged``:
    (B, gen) int arrays), its seconds, each layout's parity with the static
    arm and each engine's ``stats``."""
    batch = len(tokens)
    out: dict = {"seconds": {}, "parity": {}, "stats": {}}
    # static arm: prefill + full greedy decode, the dense cache
    t0 = time.perf_counter()
    out["static"] = static_generate(params, cfg, {"tokens": torch.as_tensor(tokens, device=device)}, gen).cpu().numpy()
    out["seconds"]["static"] = time.perf_counter() - t0
    print(f"arch={cfg.name} family={cfg.family}")
    print(f"static : {batch}x{gen} tokens in {out['seconds']['static']:.2f}s")

    # continuous arm: the same prompts through the slot engine, in BOTH KV
    # layouts — the paged pool (pages + page table + flash-decode) must give
    # the greedy tokens the dense per-slot rectangle does
    max_seq = -(-(tokens.shape[1] + gen) // PAGE) * PAGE
    for layout in LAYOUTS:
        engine = ServeEngine(
            cfg, params,
            EngineConfig(max_slots=batch, max_seq=max_seq, max_new=gen, decode_chunk=8,
                         kv_layout=layout, page_size=PAGE),
        )
        t0 = time.perf_counter()
        completions = ContinuousScheduler(engine).run(
            [Request(rid=i, tokens=tokens[i], max_new_tokens=gen) for i in range(batch)]
        )
        out["seconds"][layout] = time.perf_counter() - t0
        out[layout] = np.stack([c.tokens for c in sorted(completions, key=lambda c: c.rid)])
        out["stats"][layout] = dict(engine.stats)
        pool = (f", pool {engine.pool.n_pages}x{engine.pool.page_size} tokens"
                if engine.pool is not None else "")
        print(f"engine : {layout:5s} {batch}x{gen} tokens in {out['seconds'][layout]:.2f}s "
              f"({engine.stats['decode_chunks']} chunks, {engine.stats['host_syncs']} host syncs{pool})")
        out["parity"][layout] = bool(np.array_equal(out[layout], out["static"]))
        print(f"token parity static=={layout}-engine: {out['parity'][layout]}")
    print("continuation[0]:", out["paged"][0].tolist())
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="jamba-v0.1-52b")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--prompt", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    device = get_device(args.device)
    disable_tf32()

    cfg = model_config(args.arch)
    params = init_params(cfg, 0, device)
    return generate(cfg, params, prompts(cfg, args.batch, args.prompt), args.gen, device)


if __name__ == "__main__":
    main()
