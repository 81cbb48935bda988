"""Deterministic synthetic data, federated partitions and batch iteration
(numpy, copied from the JAX package so the port imports none of it)."""
from repro_torch.data.synthetic import make_lm_distill_batch, make_synth_images, make_token_stream
from repro_torch.data.partitions import (
    c_cls_partition,
    dirichlet_partition,
    iid_partition,
    lognormal_resize,
    partition_dataset,
)
from repro_torch.data.loader import batch_iterator, shuffle_arrays

__all__ = [
    "make_synth_images",
    "make_token_stream",
    "make_lm_distill_batch",
    "dirichlet_partition",
    "c_cls_partition",
    "iid_partition",
    "lognormal_resize",
    "partition_dataset",
    "batch_iterator",
    "shuffle_arrays",
]
