"""Input, parameter and state stand-ins, and the step programs, for every
(architecture × input shape) combination (the port of
``repro.launch.specs``).

The reference builds ``jax.ShapeDtypeStruct`` stand-ins and lowers a jitted
step. The port runs eagerly, so its stand-ins are ``meta`` tensors: the
real initialisers run under ``_OnMeta``, which puts every tensor they
make on ``meta``, so no full-width model is ever allocated, and the step
is the function the launchers call. :func:`build_program` and
:func:`build_coboost_program` return ``(fn, args)``; ``fn(*args)`` runs
one step on ``meta``, for :mod:`repro_torch.roofline.op_cost` to count.

Under a mesh in context (:func:`repro_torch.sharding.mesh_context`) the
params and the optimizer state are DTensors placed by
:func:`repro_torch.sharding.partition.shard_params` (the state takes its
params' placements), the prefill and decode cache by
:func:`repro_torch.sharding.decode_state_specs` and their batch by
:func:`repro_torch.runtime.steps.shard_batch`; the train step places its
batch itself, as it does on cards.
"""
from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.config.model import ModelConfig
from repro_torch.config.shapes import ShapeConfig
from repro_torch.config.train import TrainConfig
from repro_torch.models.transformer import init_lm, init_lm_state
from repro_torch.runtime.steps import (
    make_decode_step, make_distill_step_lm, make_prefill_step, make_train_step, shard_batch,
)
from repro_torch.sharding.partition import current_mesh, decode_state_specs, place, shard_params

# dry-run trainer: the paper's own optimizer (SGD momentum, App. B.1) — one
# f32 slot; this is also what keeps the 235B MoE inside one card's memory.
DRYRUN_TC = TrainConfig(optimizer="sgdm", learning_rate=0.01, momentum=0.9)


class _OnMeta(TorchFunctionMode):
    """Every tensor factory called in the ``with`` body makes a ``meta``
    tensor, whatever device it names: the initialisers put their leaves on
    their generator's device, and there is no ``meta`` generator (a CPU
    generator drives ``meta`` draws)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.utils._device import _device_constructors

        kwargs = dict(kwargs or {})
        if func in _device_constructors():
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model-input stand-ins for one input shape. Training/prefill get the
    full sequence; decode gets ONE token (the KV cache carries seq_len)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32)}
    if cfg.family == "audio":
        return {"frames": _meta((b, s, cfg.frontend_dim), torch.float32), "labels": _meta((b, s), torch.int32)}
    if cfg.family == "vlm":
        p = cfg.num_prefix_tokens
        return {
            "tokens": _meta((b, s - p), torch.int32),
            "prefix": _meta((b, p, cfg.frontend_dim), torch.float32),
            "labels": _meta((b, s - p), torch.int32),
        }
    batch = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
    if shape.kind == "prefill":
        del batch["labels"]
    return batch


def param_specs(cfg: ModelConfig):
    """The params on ``meta``: the real initialiser, nothing allocated."""
    with _OnMeta():
        return init_lm(cfg, torch.Generator())


def state_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The dense decode state of ``shape.global_batch`` rows of
    ``shape.seq_len`` positions on ``meta`` (the reference's
    ``init_lm_state``: decode attends through the dense cache)."""
    return init_lm_state(cfg, shape.global_batch, shape.seq_len, device="meta")


def _placed_params(cfg: ModelConfig):
    params = param_specs(cfg)
    mesh = current_mesh()
    return params if mesh is None else shard_params(params, mesh)


def _placed_batch(batch: dict) -> dict:
    mesh = current_mesh()
    return batch if mesh is None else shard_batch(batch, mesh)


def build_program(cfg: ModelConfig, shape: ShapeConfig, tc: TrainConfig = DRYRUN_TC):
    """``(fn, args)`` of the step this input shape exercises (train /
    prefill / decode), every argument on ``meta`` and, under a mesh,
    placed over it."""
    params = _placed_params(cfg)
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        step = make_train_step(cfg, tc)
        return step, (params, step.optimizer.init(params), batch, 0)

    state = state_specs(cfg, shape)
    mesh = current_mesh()
    if mesh is not None:
        state = place(state, decode_state_specs(state), mesh)
    batch = _placed_batch(batch)
    if shape.kind == "prefill":
        return make_prefill_step(cfg), (params, batch, state)
    pos = _meta((), torch.int32)  # the decode position: data, as in the reference's int32 scalar
    return make_decode_step(cfg), (params, batch["tokens"], state, pos)


def build_coboost_program(cfg: ModelConfig, shape: ShapeConfig, num_clients: int = 4,
                          tc: TrainConfig = DRYRUN_TC, kl_chunk: int = 0):
    """The paper-technique program at LM scale: one server-distillation step
    (Eq. 4) against K client LMs of the server's architecture on synthetic
    embedding batches. The port's distill step takes the K clients as a
    list of param dicts, where the reference stacks them on a leading
    axis."""
    params = _placed_params(cfg)
    clients = [_placed_params(cfg) for _ in range(num_clients)]
    b, s = shape.global_batch, shape.seq_len
    batch = _placed_batch({
        "embeds": _meta((b, s, cfg.d_model), torch.float32),
        "labels": _meta((b, s), torch.int32),  # unused by KL but keeps shapes uniform
    })
    step = make_distill_step_lm(cfg, tc, kl_chunk=kl_chunk)
    w = _meta((num_clients,), torch.float32)
    return step, (params, step.optimizer.init(params), clients, w, batch, 0)
