"""Three-term roofline of one step on the H100 (the port of
``repro.roofline.analysis``), from the per-device counts of
:mod:`repro_torch.roofline.op_cost`:

    compute    = Σ over dtypes of FLOPs / that dtype's peak
    memory     = HBM bytes / HBM bandwidth
    collective = collective bytes / link bandwidth

Every count is per device, so each term divides a per-device quantity by a
per-card rate. The compute term departs from the reference's single bf16
peak: the H100 runs f32 products outside the tensor cores, at 67 TFLOP/s
against bf16's 989 (the port keeps TF32 off), so f32 FLOPs are divided by
the f32 peak. The collective term uses one NVLink 4 link rate for every
byte, as the reference uses one ICI link's: where a mesh axis spans more
cards than one NVLink domain holds, that term is a floor.

These are projections: counts divided by the card's constants, not
measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

from repro_torch.config.mesh import HBM_BW, HBM_BYTES, ICI_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32
from repro_torch.roofline.op_cost import COLLECTIVES


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-card constants: the NVIDIA H100 SXM's by default
    (:mod:`repro_torch.config.mesh`)."""

    name: str = "h100_sxm"
    peak_flops: float = PEAK_FLOPS_BF16  # bf16 FLOP/s, tensor cores, dense
    peak_flops_f32: float = PEAK_FLOPS_F32  # f32 FLOP/s, CUDA cores
    hbm_bw: float = HBM_BW  # bytes/s
    link_bw: float = ICI_BW  # bytes/s, one NVLink 4 link rate
    hbm_bytes: float = HBM_BYTES

    def peak_for(self, dtype: str) -> float:
        """The peak of a dtype's FLOPs (a dtype name, e.g. ``"float32"``)."""
        return self.peak_flops_f32 if dtype in ("float32", "float64") else self.peak_flops


H100 = HardwareSpec()


def collective_bytes(counts: Mapping[str, Any]) -> Dict[str, int]:
    """Per-kind collective bytes of a count (:meth:`OpCounter.totals
    <repro_torch.roofline.op_cost.OpCounter.totals>`, or its
    ``collectives``), with their ``total``: the reference's keys."""
    coll = counts.get("collectives", counts)
    out = {k: int(coll.get(k, 0)) for k in COLLECTIVES}
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (fwd-only), the
    "useful" compute yardstick. D = tokens processed this step."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active * tokens


def roofline_report(counts: Mapping[str, Any], num_chips: int, cfg=None, shape=None,
                    hw: HardwareSpec = H100) -> Dict[str, Any]:
    """The three roofline terms, the memory fit and the useful-FLOPs ratio
    of one step from its per-device ``counts``
    (:meth:`OpCounter.totals <repro_torch.roofline.op_cost.OpCounter.totals>`).
    The reference's record, with its HLO counts named ``flops_per_device``
    and ``bytes_per_device``, FLOPs also by dtype, and ``kernels``: the
    hand kernels' calls, FLOPs and bytes by launch counter."""
    by_dtype = {k: float(v) for k, v in sorted(counts["flops"].items())}
    flops_dev = sum(by_dtype.values())
    bytes_dev = float(counts["bytes"])
    coll = collective_bytes(counts)

    compute_s = sum(n / hw.peak_for(d) for d, n in by_dtype.items())
    memory_s = bytes_dev / hw.hbm_bw
    collective_s = coll["total"] / hw.link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    peak_bytes = int(counts["argument_bytes"]) + int(counts["temp_bytes"])

    report: Dict[str, Any] = {
        "chips": num_chips,
        "flops_per_device": flops_dev,
        "flops_global": flops_dev * num_chips,
        "flops_by_dtype": by_dtype,
        "aten_flops_per_device": float(sum(counts.get("aten_flops", {}).values())),
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll["total"],
        "collectives": {k: v for k, v in coll.items() if k != "total"},
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": terms[dominant],
        "argument_bytes_per_device": int(counts["argument_bytes"]),
        "temp_bytes_per_device": int(counts["temp_bytes"]),
        "peak_bytes_per_device": peak_bytes,
        "fits_hbm": peak_bytes <= hw.hbm_bytes,
        "kernels": counts.get("kernels", {}),
    }
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        report["model_flops"] = mf
        global_flops = flops_dev * num_chips
        report["useful_flops_ratio"] = mf / global_flops if global_flops else 0.0
        # step-time bound and MFU if perfectly overlapped
        report["mfu_bound"] = (
            mf / (num_chips * hw.peak_flops) / terms[dominant] if terms[dominant] else 0.0
        )
    return report
