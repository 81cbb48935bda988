"""Deterministic synthetic data (the port's copies of
``repro.data.synthetic``).

*SynthDigits*: a class-separable image distribution where each class is a
distinct oriented grating + color blob, perturbed per sample by shifts and
noise. Small CNNs reach >90% centralized accuracy on it, and Dirichlet
partitions make it properly non-IID. Pure numpy, bitwise equal to the
reference for the same seed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def make_synth_images(
    seed: int,
    num_classes: int,
    n_per_class: int,
    shape: Tuple[int, int, int] = (32, 32, 3),
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images in [-1,1] NHWC float32, labels int32), shuffled."""
    rng = np.random.RandomState(seed)
    h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    xs, ys = [], []
    for cls in range(num_classes):
        angle = np.pi * cls / num_classes
        freq = 4.0 + 3.0 * (cls % 4)
        phase_dir = np.cos(angle) * xx + np.sin(angle) * yy
        grating = np.sin(2 * np.pi * freq * phase_dir)  # (h, w)
        # class-dependent color mixing
        color = np.array(
            [np.cos(2 * np.pi * cls / num_classes + k * 2.1) for k in range(c)],
            np.float32,
        )
        # class-dependent blob position
        cy, cx = (0.25 + 0.5 * ((cls * 7) % num_classes) / num_classes), (
            0.25 + 0.5 * ((cls * 3) % num_classes) / num_classes
        )
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 0.02))
        base = grating[..., None] * color[None, None] * 0.6 + blob[..., None] * 0.8
        for _ in range(n_per_class):
            img = base.copy()
            # per-sample jitter: roll + noise + contrast
            img = np.roll(img, rng.randint(-3, 4), axis=0)
            img = np.roll(img, rng.randint(-3, 4), axis=1)
            img = img * (0.8 + 0.4 * rng.rand()) + rng.randn(h, w, c).astype(np.float32) * 0.15
            xs.append(np.clip(img, -1.0, 1.0))
            ys.append(cls)
    x = np.stack(xs).astype(np.float32)
    y = np.asarray(ys, np.int32)
    order = rng.permutation(len(y))
    return x[order], y[order]


def make_token_stream(
    seed: int, vocab: int, batch: int, seq_len: int, num_states: int = 8
) -> Dict[str, np.ndarray]:
    """Hidden-Markov token batches: state transitions are deterministic-ish,
    each state emits from a distinct vocab slice. Pure numpy, bitwise equal
    to the reference for the same seed."""
    rng = np.random.RandomState(seed)
    trans = rng.dirichlet(np.ones(num_states) * 0.3, size=num_states)
    slice_w = max(vocab // num_states, 1)
    tokens = np.zeros((batch, seq_len + 1), np.int64)
    for b in range(batch):
        s = rng.randint(num_states)
        for t in range(seq_len + 1):
            tokens[b, t] = (s * slice_w + rng.zipf(1.5) - 1) % vocab
            s = rng.choice(num_states, p=trans[s])
    return {
        "tokens": tokens[:, :-1].astype(np.int32),
        "labels": tokens[:, 1:].astype(np.int32),
    }


def make_lm_distill_batch(
    seed: int, batch: int, seq_len: int, d_model: int, vocab: int
) -> Dict[str, np.ndarray]:
    """Embedding-space synthetic batch for the LM-scale distillation path:
    embeds (B, S, d) + target-token labels (B,) for the EE weight search.
    Pure numpy, bitwise equal to the reference for the same seed."""
    rng = np.random.RandomState(seed)
    return {
        "embeds": rng.randn(batch, seq_len, d_model).astype(np.float32) * 0.02,
        "targets": rng.randint(0, vocab, size=(batch,)).astype(np.int32),
    }
