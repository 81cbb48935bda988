"""Functional model zoo (the port of ``repro.models``).

LM families (dense/moe/ssm/hybrid/audio/vlm) live in
:mod:`repro_torch.models.transformer`; the paper's own CNN client zoo in
:mod:`repro_torch.models.cnn`; data-free generators in
:mod:`repro_torch.models.generator`. Importing this package builds no
kernel: the kernel libraries build on their first launch.
"""
from repro_torch.models.transformer import (
    cross_entropy,
    group_pattern,
    group_period,
    init_lm,
    init_lm_state,
    layer_kinds,
    lm_decode,
    lm_extend,
    lm_forward,
    lm_logits,
    lm_loss,
    lm_prefill,
    num_groups,
)
from repro_torch.models.cnn import CNN_ARCHS, cnn_apply, init_cnn, make_cnn
from repro_torch.models.generator import (
    embedding_generator,
    image_generator,
    init_embedding_generator,
    init_image_generator,
)

__all__ = [
    "init_lm",
    "lm_forward",
    "lm_loss",
    "lm_logits",
    "lm_prefill",
    "lm_decode",
    "lm_extend",
    "init_lm_state",
    "layer_kinds",
    "group_period",
    "group_pattern",
    "num_groups",
    "cross_entropy",
    "CNN_ARCHS",
    "init_cnn",
    "cnn_apply",
    "make_cnn",
    "init_image_generator",
    "image_generator",
    "init_embedding_generator",
    "embedding_generator",
]
