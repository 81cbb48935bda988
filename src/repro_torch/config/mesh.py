"""Mesh configuration: logical axes and hardware constants (the port's copy
of ``repro.config.mesh``).

:class:`MeshConfig` and the two production layouts keep the reference's
names and shapes. The hardware constants keep the reference's names but
hold the NVIDIA H100 SXM's figures (the card the port runs on): they feed
the roofline bounds of ``chip_smoke.py`` and nothing else.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes batch/FSDP shard over (pod folds into data parallel)."""
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"

    def axis_size(self, name: str) -> int:
        return self.shape[self.axes.index(name)]


SINGLE_POD = MeshConfig((16, 16), ("data", "model"))
MULTI_POD = MeshConfig((2, 16, 16), ("pod", "data", "model"))

# NVIDIA H100 SXM (80 GB) figures, per card.
PEAK_FLOPS_BF16 = 989e12  # bf16 tensor cores, dense
PEAK_FLOPS_F32 = 67e12  # f32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s, HBM3
ICI_BW = 450e9  # bytes/s each way, NVLink 4 (18 links)
HBM_BYTES = 80 * 10**9
VMEM_BYTES = 227 * 1024  # shared memory one SM offers a block
