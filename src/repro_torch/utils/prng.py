"""The random-draw seam of the OFL epochs.

JAX's threefry stream cannot be reproduced with a ``torch.Generator``, so
every draw an epoch makes goes through one object, in this order per epoch:

1. ``zy``: the generator's latent ``z ~ N(0, 1)`` and labels ``y`` (the
   reference's ``core/epoch.py`` ``_sample_zy``); or, in an F-ADI epoch,
   ``inversion``: the labels ``y`` and the unit noise ``n ~ N(0, 1)`` the
   pixel batch starts from (the epoch scales it by 0.5);
2. ``direction``: the EE step's DHS direction ``u ~ Unif[-1, 1)`` (drawn
   only when EE and DHS are both on);
3. ``direction``: one ``u`` per valid distillation slot (only with DHS).

Co-Boosting draws all three; DENSE and F-DAFL draw only ``zy`` (no EE, no
DHS), F-ADI only ``inversion``, and FedDF nothing (its only randomness is
the host's batch permutation).

:class:`Draws` samples from a seeded ``torch.Generator`` on the run's
device. :class:`ReplayDraws` hands back recorded arrays in the same order,
which lets a test replay the reference's own draws through the port.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Sequence, Tuple

import numpy as np
import torch


class Draws:
    """Draws from a seeded ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device) -> None:
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def zy(self, batch: int, latent: int, num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.randn((batch, latent), generator=self.gen, device=self.device)
        y = torch.randint(0, num_classes, (batch,), generator=self.gen, device=self.device)
        return z, y

    def inversion(self, batch: int, image_shape: Sequence[int], num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
        y = torch.randint(0, num_classes, (batch,), generator=self.gen, device=self.device)
        n = torch.randn((batch, *image_shape), generator=self.gen, device=self.device)
        return y, n

    def direction(self, shape: Sequence[int]) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.gen, device=self.device)
        return u * 2.0 - 1.0


class ReplayDraws:
    """Recorded draws, handed back in the seam's order.

    ``items`` is an iterable of ``("zy", (z, y))``, ``("inversion", (y, n))``
    and ``("direction", u)`` entries (numpy arrays or tensors). A request of
    the wrong kind or shape raises, so a replay that drifts out of step with
    the epoch fails loudly.
    """

    def __init__(self, items: Iterable, device) -> None:
        self.device = torch.device(device)
        self.items = deque(items)

    def _next(self, kind: str):
        if not self.items:
            raise RuntimeError(f"replay exhausted: the epoch asked for one more {kind!r} draw")
        got, value = self.items.popleft()
        if got != kind:
            raise RuntimeError(f"replay out of step: the epoch asked for {kind!r}, next recorded draw is {got!r}")
        return value

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def zy(self, batch: int, latent: int, num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
        z, y = self._next("zy")
        z, y = self._tensor(z, torch.float32), self._tensor(y, torch.int64)
        if tuple(z.shape) != (batch, latent) or tuple(y.shape) != (batch,):
            raise RuntimeError(f"replayed zy shapes {tuple(z.shape)}, {tuple(y.shape)} do not match ({batch}, {latent})")
        return z, y

    def inversion(self, batch: int, image_shape: Sequence[int], num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
        y, n = self._next("inversion")
        y, n = self._tensor(y, torch.int64), self._tensor(n, torch.float32)
        if tuple(y.shape) != (batch,) or tuple(n.shape) != (batch, *image_shape):
            raise RuntimeError(
                f"replayed inversion shapes {tuple(y.shape)}, {tuple(n.shape)} do not match ({batch}, {tuple(image_shape)})"
            )
        return y, n

    def direction(self, shape: Sequence[int]) -> torch.Tensor:
        u = self._tensor(self._next("direction"), torch.float32)
        if tuple(u.shape) != tuple(shape):
            raise RuntimeError(f"replayed direction shape {tuple(u.shape)} != {tuple(shape)}")
        return u
