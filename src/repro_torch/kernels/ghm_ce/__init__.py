from repro_torch.kernels.ghm_ce.ops import ghm_ce
from repro_torch.kernels.ghm_ce.ref import ghm_ce_ref

__all__ = ["ghm_ce", "ghm_ce_ref"]
