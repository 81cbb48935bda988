"""Spec-driven sharding for the port (the counterpart of ``repro.sharding``):
logical rules resolved against a ``DeviceMesh``, DTensor placements and the
``constrain`` points of the models."""
from repro_torch.sharding.partition import (
    LOGICAL_RULES,
    PartitionSpec,
    activation_pspec,
    batch_pspec,
    constrain,
    decode_state_specs,
    infer_param_specs,
    logical_to_pspec,
    mesh_context,
    place,
    resolve_rule,
    shard_engine_state,
    shard_params,
    to_placements,
)

__all__ = [
    "LOGICAL_RULES",
    "constrain",
    "infer_param_specs",
    "logical_to_pspec",
    "resolve_rule",
    "batch_pspec",
    "activation_pspec",
    "decode_state_specs",
    "shard_engine_state",
    "PartitionSpec",
    "to_placements",
    "place",
    "mesh_context",
    "shard_params",
]
