"""The three-term roofline of one step on the H100 (the port of
``repro.roofline``): per-device counts from
:mod:`repro_torch.roofline.op_cost`, the hand kernels' work from
:mod:`repro_torch.kernels.kernel_cost`, the terms and the record from
:mod:`repro_torch.roofline.analysis`."""
from repro_torch.roofline.analysis import H100, HardwareSpec, collective_bytes, model_flops, roofline_report

__all__ = ["H100", "HardwareSpec", "collective_bytes", "roofline_report", "model_flops"]
