"""Run configuration dataclasses, the input shapes and the architecture
registry (the port's copy of ``repro.config``)."""
from repro_torch.config.mesh import MeshConfig
from repro_torch.config.model import ModelConfig, reduced_variant
from repro_torch.config.registry import arch_supports_shape, get_arch, list_archs, register_arch
from repro_torch.config.shapes import INPUT_SHAPES, ShapeConfig
from repro_torch.config.train import OFLConfig, TrainConfig

__all__ = [
    "ModelConfig",
    "reduced_variant",
    "ShapeConfig",
    "INPUT_SHAPES",
    "MeshConfig",
    "TrainConfig",
    "OFLConfig",
    "register_arch",
    "get_arch",
    "list_archs",
    "arch_supports_shape",
]
