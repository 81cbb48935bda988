"""Cross entropy for client training (Eq. 1)."""
from __future__ import annotations

import torch


def ce_per_sample(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross entropy. logits: (B, C); labels: (B,) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return lse - ll


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(ce_per_sample(logits, labels))
