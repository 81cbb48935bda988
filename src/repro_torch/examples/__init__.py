"""The JAX package's examples (``examples/*.py``), run on the port:

    python -m repro_torch.examples.quickstart              # 3 cnn2 clients, Co-Boosting
    python -m repro_torch.examples.heterogeneous_clients   # Table 3's mixed market
    python -m repro_torch.examples.serve_decode            # static vs engine, both KV layouts

Each runs at the reference example's settings on the GPU (``--device
cpu`` for the CPU) and has a ``main(argv=None) -> dict`` returning what it
prints. ``examples/distill_llm.py``'s counterpart is
:mod:`repro_torch.launch.distill_llm`.

The two Co-Boosting examples share the functions below, each a function
of its inputs, so a test can feed them the reference's market, inits and
draws; an example passes its own archs, seeds and settings.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.train import OFLConfig
from repro_torch.core import OFLState, default_image_setup, run_coboosting
from repro_torch.data import make_synth_images
from repro_torch.fed import build_market
from repro_torch.models.cnn import cnn_apply, init_cnn

CLASSES, SHAPE = 6, (16, 16, 3)  # both Co-Boosting examples' data


def federation(
    archs: Sequence[str], cfg: OFLConfig, device
) -> Tuple[List[Callable], List[Any], np.ndarray, np.ndarray]:
    """The client side: the data, its Dirichlet split, and one locally
    trained client per arch. Returns (client applies, client params, test
    images, test labels)."""
    x, y = make_synth_images(0, CLASSES, 120, SHAPE)
    test_x, test_y = make_synth_images(1, CLASSES, 40, SHAPE)
    applies, client_params, _, _ = build_market(0, x, y, cfg, CLASSES, archs=list(archs), device=device)
    return applies, client_params, test_x, test_y


def init_server(arch: str, seed: int, device) -> Any:
    return init_cnn(torch.Generator(device=device).manual_seed(seed), arch, CLASSES, SHAPE)


def init_generator(seed: int, cfg: OFLConfig, device) -> Tuple[Callable, Any]:
    return default_image_setup(torch.Generator(device=device).manual_seed(seed), cfg, CLASSES, SHAPE)


def coboost(
    server_arch: str,
    applies: List[Callable],
    client_params: List[Any],
    server_params: Any,
    gen_apply: Callable,
    gen_params: Any,
    cfg: OFLConfig,
    draws,
    eval_fn: Optional[Callable] = None,
    eval_every: int = 1,
) -> OFLState:
    """The server side: Co-Boosting over the market into a ``server_arch``
    server."""
    return run_coboosting(
        applies, client_params, partial(cnn_apply, server_arch), server_params, gen_apply, gen_params,
        cfg, CLASSES, draws, eval_fn=eval_fn, eval_every=eval_every,
    )
