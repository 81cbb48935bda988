"""Cross entropy for client training (Eq. 1), the temperature KL of
distillation (Eq. 4) and the predictive entropy of the F-DAFL baseline, the
port of ``repro.core.losses``."""
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


def kl_per_sample(teacher_logits: torch.Tensor, student_logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """KL(softmax(t/T) || softmax(s/T)) · T² per sample. Shapes (B, C) or
    (..., C), reduced over the last axis only; computed in f32."""
    t = torch.log_softmax(teacher_logits.float() / temperature, dim=-1)
    s = torch.log_softmax(student_logits.float() / temperature, dim=-1)
    return torch.sum(torch.exp(t) * (t - s), dim=-1) * (temperature**2)


def kl_loss(teacher_logits: torch.Tensor, student_logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    return torch.mean(kl_per_sample(teacher_logits, student_logits, temperature))


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Mean predictive entropy (the F-DAFL baseline's information loss)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(torch.exp(lp) * lp, dim=-1))
