"""Carry parameters between the JAX package and the port.

The CNN and generator weights of the Co-Boosting path (below; a grouped
client bank's stacked groups in one call, :func:`bank_params_from_jax`),
and the server LM's weights (:func:`lm_params_from_jax`, at the end), one
model or K client models stacked on a leading axis
(:func:`lm_stacked_params_from_jax`).

A JAX parameter tree travels as numpy arrays, either nested or flattened
to ``a/b/c`` paths (:func:`repro_torch.utils.trees.flatten_dict`). The
layouts differ only in the weights:

* conv weights: JAX HWIO → port OIHW;
* dense weights: JAX ``(din, dout)`` → port ``(dout, din)``, the
  ``nn.Linear`` layout;
* the generator's ``label_embed`` table ``(num_classes, latent)`` keeps its
  layout (it is indexed, not multiplied);
* 1-D leaves (norm scales and biases) are unchanged;
* non-array leaves (``"stride"`` of a residual block) stay plain Python
  values.

The first dense layer of ``lenet5``, ``cnn5`` and ``cnn2`` reads features
flattened from NHWC; the port flattens in NHWC order too
(:mod:`repro_torch.models.cnn`), so its rows need no permutation.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.cnn import CNN_ARCHS
from repro_torch.utils.trees import flatten_dict, tree_stack, unflatten_dict

GENERATOR = "image_generator"
EMBEDDING_GENERATOR = "embedding_generator"
ARCHS = CNN_ARCHS + (GENERATOR, EMBEDDING_GENERATOR)

_KEEP_LAYOUT = {GENERATOR: ("label_embed",), EMBEDDING_GENERATOR: ("label_embed",)}


def _check_arch(arch: str) -> None:
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")


def _to_port(path: str, a: np.ndarray, keep: bool) -> np.ndarray:
    if keep or a.ndim <= 1:
        return a
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if a.ndim == 2:
        return a.T  # (din, dout) -> (dout, din)
    raise ValueError(f"{path}: no port layout for a {a.ndim}-D weight")


def _to_jax(path: str, a: np.ndarray, keep: bool) -> np.ndarray:
    if keep or a.ndim <= 1:
        return a
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if a.ndim == 2:
        return a.T
    raise ValueError(f"{path}: no JAX layout for a {a.ndim}-D weight")


def params_from_jax(arch: str, tree: Dict[str, Any], device="cpu", dtype=torch.float32) -> Dict[str, Any]:
    """JAX params of ``arch`` (a CNN arch or a generator) as numpy
    arrays → the port's nested dict of tensors on ``device``."""
    _check_arch(arch)
    keep = _KEEP_LAYOUT.get(arch, ())
    out = {}
    for path, leaf in flatten_dict(tree).items():
        if isinstance(leaf, (int, float, bool, str)):
            out[path] = leaf
            continue
        a = np.asarray(leaf)
        if a.ndim == 0:
            out[path] = a.item()
            continue
        out[path] = torch.tensor(_to_port(path, a, path in keep), dtype=dtype, device=device)
    return unflatten_dict(out)


def bank_params_from_jax(archs, bank_params, device="cpu", dtype=torch.float32) -> tuple:
    """A JAX ``ClientBank``'s params (one stacked tree per group, the clients
    on the leading axis, numpy arrays) → the port's bank params, the client
    axis kept: :func:`params_from_jax` of each client's slice, restacked.
    ``archs`` names each group's arch. A non-array leaf stays one value."""
    if len(archs) != len(bank_params):
        raise ValueError(f"{len(archs)} archs for {len(bank_params)} groups")
    out = []
    for arch, tree in zip(archs, bank_params):
        flat = flatten_dict(tree)
        arrays = {p: np.asarray(v) for p, v in flat.items() if not isinstance(v, (int, float, bool, str))}
        n = {a.shape[0] for a in arrays.values()}
        if len(n) != 1:
            raise ValueError(f"{arch}: stacked leaves disagree on the client axis: {sorted(n)}")
        rows = [params_from_jax(arch, unflatten_dict({**flat, **{p: a[i] for p, a in arrays.items()}}), device, dtype)
                for i in range(n.pop())]
        out.append(tree_stack(rows))
    return tuple(out)


def params_to_jax(arch: str, params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: nested dict of numpy arrays
    in the JAX layouts."""
    _check_arch(arch)
    keep = _KEEP_LAYOUT.get(arch, ())
    out = {}
    for path, leaf in flatten_dict(params).items():
        if not torch.is_tensor(leaf):
            out[path] = leaf
            continue
        a = leaf.detach().cpu().numpy()
        out[path] = np.ascontiguousarray(_to_jax(path, a, path in keep))
    return unflatten_dict(out)


# ---------------------------------------------------------------------------
# the distilled server LM (repro.models.transformer / repro_torch.models.transformer)
#
# The JAX tree stacks layers by group: every leaf under ``groups/p{j}/...``
# has a leading axis of length num_layers / period, and layer g·period + j
# is index g of ``groups/p{j}``. The port keeps one dict per layer in
# ``layers``. Weights keep the einsum layouts on both sides (``wq``/``wk``/
# ``wv`` (d, H, hd), ``wo`` (H, hd, d), qk-norm ``q_norm``/``k_norm`` (hd,),
# MLP ``wi``/``wg`` (d, f) and ``wo`` (f, d), MoE ``router`` (d, E),
# ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d), the embedding (V, d),
# xLSTM's ``xlstm`` subtree and Mamba's ``mamba`` one as the reference
# lays them out), so the conversion is bitwise. An xLSTM block has no
# ``mlp`` and no ``norm2``; a GELU MLP has no ``wg``. Outside the layers,
# an encoder has ``frames_proj/projector/kernel`` (frontend_dim, d) and
# ``pred_head/kernel`` (d, V) in place of ``embed`` and ``lm_head``, and a
# VLM adds ``prefix_proj/projector/kernel`` (frontend_dim, d).


def lm_params_from_jax(cfg, tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX ``init_lm`` params (numpy arrays) → the port's LM params."""
    from repro_torch.models.transformer import group_period

    period = group_period(cfg)
    flat = {p: np.asarray(a) for p, a in flatten_dict(tree).items()}
    out: Dict[str, Any] = {}
    for path, a in flat.items():
        parts = path.split("/")
        if parts[0] == "groups":
            j = int(parts[1][1:])
            if a.shape[0] * period != cfg.num_layers:
                raise ValueError(f"{path}: {a.shape[0]} groups of {period} for {cfg.num_layers} layers")
            for g in range(a.shape[0]):
                out[f"layers/{g * period + j}/" + "/".join(parts[2:])] = torch.tensor(a[g], device=device)
        else:
            out[path] = torch.tensor(a, device=device)
    nested = unflatten_dict(out)
    nested["layers"] = [nested["layers"][str(i)] for i in range(cfg.num_layers)]
    _check_lm_tree(cfg, nested)
    return nested


def lm_params_to_jax(cfg, params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`lm_params_from_jax`: nested numpy arrays with
    the layers stacked by group."""
    from repro_torch.models.transformer import group_period

    _check_lm_tree(cfg, params)
    period = group_period(cfg)
    out: Dict[str, Any] = {}
    for path, leaf in flatten_dict({k: v for k, v in params.items() if k != "layers"}).items():
        out[path] = leaf.detach().cpu().numpy()
    per_layer = [flatten_dict(layer) for layer in params["layers"]]
    for j in range(period):
        for path in per_layer[j]:
            stack = [per_layer[g * period + j][path].detach().cpu().numpy() for g in range(cfg.num_layers // period)]
            out[f"groups/p{j}/{path}"] = np.stack(stack)
    return unflatten_dict(out)


def _check_lm_tree(cfg, params: Dict[str, Any]) -> None:
    """Every leaf the port's LM reads is there, and nothing else: layer
    ``i`` has the leaves of its kind (the template's layer ``i % period``)."""
    from repro_torch.models.transformer import group_period, init_lm

    # one group of layers at toy widths, with the config's families, qk-norm
    # and tied head: the leaves' names are what is compared. d_model keeps
    # the xLSTM heads dividing d_model and the inner width.
    period = group_period(cfg)
    tiny = dict(num_layers=period, d_model=2 * max(cfg.xlstm_heads, 1), num_heads=1, num_kv_heads=1, head_dim=2,
                d_ff=2, vocab_size=2, frontend_dim=min(cfg.frontend_dim, 2))
    if cfg.num_experts:
        tiny.update(num_experts=2, experts_per_token=1, moe_d_ff=2)
    want = init_lm(cfg.replace(**tiny), torch.Generator().manual_seed(0))
    layer_keys = [set(flatten_dict(layer)) for layer in want["layers"]]
    top_keys = set(flatten_dict({k: v for k, v in want.items() if k != "layers"}))
    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"expected {cfg.num_layers} layers, got {len(params['layers'])}")
    for i, layer in enumerate(params["layers"]):
        if set(flatten_dict(layer)) != layer_keys[i % period]:
            raise ValueError(f"layer {i}: leaves {sorted(flatten_dict(layer))} != {sorted(layer_keys[i % period])}")
    got_top = set(flatten_dict({k: v for k, v in params.items() if k != "layers"}))
    if got_top != top_keys:
        raise ValueError(f"top-level leaves {sorted(got_top)} != {sorted(top_keys)}")


def lm_stacked_params_from_jax(cfg, tree: Dict[str, Any], device="cpu") -> List[Dict[str, Any]]:
    """JAX LM params stacked on a leading client axis K (the
    ``core.distributed`` layout) → a list of K port param dicts."""
    flat = {p: np.asarray(a) for p, a in flatten_dict(tree).items()}
    k = {a.shape[0] for a in flat.values()}
    if len(k) != 1:
        raise ValueError(f"stacked leaves disagree on the client axis: {sorted(k)}")
    return [lm_params_from_jax(cfg, unflatten_dict({p: a[i] for p, a in flat.items()}), device) for i in range(k.pop())]


def lm_stacked_params_to_jax(cfg, clients: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The inverse of :func:`lm_stacked_params_from_jax`."""
    flats = [flatten_dict(lm_params_to_jax(cfg, p)) for p in clients]
    return unflatten_dict({path: np.stack([f[path] for f in flats]) for path in flats[0]})
