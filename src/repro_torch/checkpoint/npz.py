"""Flat-npz checkpoints with an index manifest (the port of
``repro.checkpoint.npz``), in the same format: a nested dict is flattened
to "a/b/c" keys, stored as one ``step_%08d.npz`` per step beside a
``manifest.json`` recording the steps and their metadata.

The port's LM params are saved in the JAX tree's keys and layout
(``save_checkpoint(d, step, convert.lm_params_to_jax(cfg, params))``) and
read back with ``convert.lm_params_from_jax(cfg, load_checkpoint(d))``, so
each package reads a checkpoint the other wrote.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.utils.trees import flatten_dict, unflatten_dict


def _manifest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "manifest.json")


def _read_manifest(ckpt_dir: str) -> Dict:
    path = _manifest_path(ckpt_dir)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"steps": [], "meta": {}}


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, meta: Optional[Dict] = None) -> str:
    """Write ``tree`` (a nested dict of numpy arrays or tensors, which are
    copied to the host) as step ``step``; returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    host = {
        k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in flatten_dict(tree).items()
    }
    fname = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    np.savez(fname, **host)
    manifest = _read_manifest(ckpt_dir)
    if step not in manifest["steps"]:
        manifest["steps"].append(step)
        manifest["steps"].sort()
    manifest["meta"][str(step)] = dict(meta or {}, keys=len(host))
    with open(_manifest_path(ckpt_dir), "w") as f:
        json.dump(manifest, f, indent=1)
    return fname


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> Any:
    """The nested dict of numpy arrays saved at ``step`` (the latest when
    ``None``)."""
    manifest = _read_manifest(ckpt_dir)
    if not manifest["steps"]:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step = manifest["steps"][-1] if step is None else step
    fname = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(fname) as data:
        flat = {k: data[k] for k in data.files}
    return unflatten_dict(flat)


def list_checkpoints(ckpt_dir: str) -> List[int]:
    return list(_read_manifest(ckpt_dir)["steps"])
