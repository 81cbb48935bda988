from repro_torch.kernels.ensemble_kl.ops import ensemble_kl
from repro_torch.kernels.ensemble_kl.ref import ensemble_kl_ref

__all__ = ["ensemble_kl", "ensemble_kl_ref"]
