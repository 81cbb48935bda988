"""Small shared utilities: parameter-tree helpers, draws, devices, logging.

The reference's ``PRNGStream`` and ``split_like`` (JAX-key plumbing) have
no counterpart: the draw seam :mod:`repro_torch.utils.prng` replaces them.
"""
from repro_torch.utils.trees import (
    flatten_dict,
    tree_add,
    tree_bytes,
    tree_cast,
    tree_index,
    tree_l2_norm,
    tree_map_with_path,
    tree_paths,
    tree_scale,
    tree_size,
    tree_stack,
    tree_unstack,
    tree_zeros_like,
    unflatten_dict,
)
from repro_torch.utils.logging import get_logger, set_level

__all__ = [
    "tree_map_with_path",
    "tree_paths",
    "tree_size",
    "tree_bytes",
    "tree_stack",
    "tree_unstack",
    "tree_index",
    "tree_zeros_like",
    "tree_cast",
    "tree_add",
    "tree_scale",
    "tree_l2_norm",
    "flatten_dict",
    "unflatten_dict",
    "get_logger",
    "set_level",
]
