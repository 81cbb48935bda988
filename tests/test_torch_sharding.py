"""The port's sharding specs (``repro_torch.sharding``) against the JAX
package's (``repro.sharding``), and the launchers' ``--mesh`` flag.

* Spec parity, every registered arch at full width, no allocation: the JAX
  ``infer_param_specs`` on ``jax.eval_shape(init_lm)``, the port's on meta
  tensors of the same leaves in its layout (``layers/i/...`` one layer at a
  time where the reference stacks ``groups/pJ/...``); the port's spec for
  ``layers/i/p`` is the reference's for ``groups/pJ/p`` without the leading
  group entry. The same for ``decode_state_specs`` and
  ``shard_engine_state``, dim by meaning (the KH dim against the KH dim):
  the port's ``(L_mixer, ...)`` state leaves against the reference's
  ``(G, ...)`` ones, the engine's slot bookkeeping and a sealed handoff
  included. Six mesh-axes dicts, from none to the multipod mesh and the
  indivisible ``model = 3``.
* The port's twins of ``tests/test_optim_sharding.py``'s rule checks, and
  DTensor placements of a spec (``to_placements``: a tuple entry shards
  one tensor dim over both mesh dims, major first; size-1 mesh dims hold
  the whole dim).
* The public names of ``repro.sharding`` and ``repro.launch.mesh``, and
  ``MeshConfig``, against the reference's; the H100's constants.
* The launchers on a world of one: ``--mesh production`` exits before
  allocating, naming the 256 ranks it needs; ``launch.serve --mesh
  multipod --engine static`` gives the reference's message, and so does
  ``--disagg`` with the dense layout; ``--mesh multipod``, ``--disagg``
  and ``--mesh production --replicas 2`` serve their fleet, colocated
  meshless, with every request returned; ``--mesh host`` runs as before.

The multi-rank parity (gloo) and the mesh topology are in
``tests/test_torch_mesh.py``.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.config import get_arch as jax_get_arch
from repro.config import list_archs
from repro.models import init_lm as jax_init_lm
from repro.models.transformer import group_pattern as jax_group_pattern
from repro.models.transformer import init_lm_state as jax_init_lm_state
from repro.sharding import decode_state_specs as jax_decode_state_specs
from repro.sharding import infer_param_specs as jax_infer_param_specs
from repro.sharding import resolve_rule as jax_resolve_rule
from repro.sharding import shard_engine_state as jax_shard_engine_state
from repro.utils import tree_map_with_path as jax_tree_map_with_path
from repro_torch.config.model import reduced_variant
from repro_torch.config.registry import get_arch
from repro_torch.launch import serve, train
from repro_torch.models.transformer import group_period, init_lm, init_lm_state, layer_kinds
from repro_torch.sharding import (
    LOGICAL_RULES,
    PartitionSpec,
    activation_pspec,
    batch_pspec,
    constrain,
    decode_state_specs,
    infer_param_specs,
    logical_to_pspec,
    resolve_rule,
    shard_engine_state,
    to_placements,
)
from repro_torch.sharding.partition import map_with_path
from repro_torch.utils.trees import flatten_dict

pytestmark = pytest.mark.tier1

P = PartitionSpec
MESH_AXES = [
    {},
    {"data": 1, "model": 1},
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
    {"data": 1, "model": 2},
    {"data": 1, "model": 3},
]
SLOTS, MAX_SEQ, PAGE, MAX_NEW = 16, 512, 16, 64


def _meta(shape) -> torch.Tensor:
    return torch.empty(tuple(shape), device="meta")


def _flat_specs(tree, is_spec) -> dict:
    out = {}
    map_with_path(lambda path, s: out.__setitem__(path, s), tree, is_leaf=is_spec)
    return out


def _jax_flat_specs(tree) -> dict:
    out = {}
    jax_tree_map_with_path(lambda path, s: out.__setitem__(path, tuple(s)), tree)
    return out


def _port_layer_shapes(jshapes: dict, period: int) -> dict:
    """The port's leaves (path -> shape) for the reference's flattened
    ``eval_shape`` tree: ``groups/pJ/<rest>`` (G, ...) becomes
    ``layers/{g·period + J}/<rest>`` for every group g."""
    out = {}
    for path, shape in jshapes.items():
        parts = path.split("/")
        if parts[0] == "groups":
            j = int(parts[1][1:])
            for g in range(shape[0]):
                out[f"layers/{g * period + j}/" + "/".join(parts[2:])] = tuple(shape[1:])
        else:
            out[path] = tuple(shape)
    return out


def _nest(flat: dict) -> dict:
    nested: dict = {}
    for path, shape in flat.items():
        cur = nested
        parts = path.split("/")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _meta(shape)
    nested["layers"] = [nested["layers"][str(i)] for i in range(len(nested["layers"]))]
    return nested


@pytest.fixture(scope="module")
def shapes():
    """Per arch: the reference's full-width param and state shapes (no
    allocation) and its layer pattern."""
    out = {}
    for arch in list_archs():
        jcfg = jax_get_arch(arch)
        params = jax.eval_shape(lambda c=jcfg: jax_init_lm(c, jax.random.key(0)))
        state = jax.eval_shape(lambda c=jcfg: jax_init_lm_state(c, SLOTS, MAX_SEQ))
        paged = jax.eval_shape(
            lambda c=jcfg: jax_init_lm_state(c, SLOTS, MAX_SEQ, kv_pages=SLOTS * MAX_SEQ // PAGE + 1, kv_page_size=PAGE)
        )
        out[arch] = (params, state, paged, [m for m, _ in jax_group_pattern(jcfg)])
    return out


def test_port_layout_matches_reduced_init():
    """The layout map the parity tests use is the port's own: on every
    reduced arch, ``init_lm``'s leaves are the mapped reference leaves."""
    for arch in list_archs():
        cfg = reduced_variant(get_arch(arch)).replace(dtype="float32", param_dtype="float32")
        from repro.config import reduced_variant as jax_reduced_variant

        jcfg = jax_reduced_variant(jax_get_arch(arch))
        jshapes = {p: tuple(s.shape) for p, s in flatten_dict(
            jax.eval_shape(lambda c=jcfg: jax_init_lm(c, jax.random.key(0)))).items()}
        port = init_lm(cfg, torch.Generator().manual_seed(0))
        got = {p: tuple(t.shape) for p, t in flatten_dict(
            {**{k: v for k, v in port.items() if k != "layers"},
             "layers": {str(i): layer for i, layer in enumerate(port["layers"])}}).items()}
        assert got == _port_layer_shapes(jshapes, group_period(cfg)), arch


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, shapes):
    """``infer_param_specs`` on every leaf at full width, at every mesh:
    ``layers/i/p`` gets the reference's ``groups/pJ/p`` spec, G dropped."""
    jparams, _, _, _ = shapes[arch]
    cfg = get_arch(arch)
    jflat = {p: tuple(s.shape) for p, s in flatten_dict(jparams).items()}
    port = _nest(_port_layer_shapes(jflat, group_period(cfg)))
    for axes in MESH_AXES:
        want = _jax_flat_specs(jax_infer_param_specs(jparams, mesh_axes=axes))
        got = _flat_specs(infer_param_specs(port, mesh_axes=axes), lambda s: isinstance(s, PartitionSpec))
        assert len(got) == sum(s[0] if p.startswith("groups/") else 1 for p, s in jflat.items())
        for path, spec in got.items():
            assert isinstance(spec, PartitionSpec)
            parts = path.split("/")
            if parts[0] == "layers":
                i = int(parts[1])
                ref = want[f"groups/p{i % group_period(cfg)}/" + "/".join(parts[2:])]
                assert tuple(spec) == (ref[1:] if axes else ref), (arch, axes, path)
            else:
                assert tuple(spec) == want[path], (arch, axes, path)


def _state_pairs(cfg, jstate, port_state, pattern):
    """(port path, reference path) of every state leaf, matched by meaning:
    the reference's ``pJ/<leaf>`` of an attention or recurrent mixer is the
    port's ``<leaf>`` (attention) or ``<mixer>.<leaf>``."""
    pairs = []
    for jpath in flatten_dict(jstate):
        j, leaf = jpath.split("/")
        mixer = pattern[int(j[1:])]
        name = leaf if mixer == "attn" else f"{mixer}.{leaf}"
        assert name in port_state, (cfg.name, jpath)
        pairs.append((name, jpath))
    return pairs


@pytest.mark.parametrize("arch", list_archs())
def test_state_specs_match_reference(arch, shapes):
    """``decode_state_specs`` and ``shard_engine_state`` at full width, the
    dense, paged and sealed-handoff layouts and the engine's bookkeeping,
    dim for dim against the reference (the leading layer / group dim
    dropped)."""
    _, jstate, jpaged, pattern = shapes[arch]
    cfg = get_arch(arch)
    layer_kinds(cfg)
    with torch.device("meta"):
        dense = init_lm_state(cfg, SLOTS, MAX_SEQ, device="meta")
        paged = init_lm_state(cfg, SLOTS, MAX_SEQ, kv_pages=SLOTS * MAX_SEQ // PAGE + 1, kv_page_size=PAGE, device="meta")
    book = {"last_tok": (SLOTS, 1), "pos": (SLOTS,), "active": (SLOTS,), "out": (SLOTS, MAX_NEW),
            "n_out": (SLOTS,), "budget": (SLOTS,), "page_table": (SLOTS, MAX_SEQ // PAGE)}
    jbook = {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in book.items()}
    sealed = {name: _meta((leaf.shape[0], 4, 2, PAGE, *leaf.shape[3:]))
              for name, leaf in paged.items() if name.endswith("_pages")}
    jsealed = {j: {k: jax.ShapeDtypeStruct((v.shape[0], 4, 2, PAGE, *v.shape[3:]), np.float32)
                   for k, v in leaves.items() if k.endswith("_pages")} for j, leaves in jpaged.items()}
    is_spec = lambda s: isinstance(s, PartitionSpec)
    for axes in MESH_AXES:
        cut = lambda s: s[1:] if axes else s
        got = decode_state_specs(dense, mesh_axes=axes)
        want = _jax_flat_specs(jax_decode_state_specs(jstate, mesh_axes=axes))
        for name, jpath in _state_pairs(cfg, jstate, dense, pattern):
            assert cut(tuple(got[name])) == cut(want[jpath]), (arch, axes, "decode", jpath)
        for port_tree, jtree, what in ((dense, jstate, "engine dense"), (paged, jpaged, "engine paged")):
            got = _flat_specs(shard_engine_state({"kv": port_tree, **{k: _meta(s) for k, s in book.items()}},
                                                 mesh_axes=axes), is_spec)
            want = _jax_flat_specs(jax_shard_engine_state({"kv": jtree, **jbook}, mesh_axes=axes))
            for name, jpath in _state_pairs(cfg, jtree, port_tree, pattern):
                assert cut(tuple(got[f"kv/{name}"])) == cut(want[f"kv/{jpath}"]), (arch, axes, what, jpath)
            for k in book:
                assert tuple(got[k]) == want[k], (arch, axes, k)
        got = _flat_specs(shard_engine_state(sealed, mesh_axes=axes), is_spec)
        want = _jax_flat_specs(jax_shard_engine_state(jsealed, mesh_axes=axes))
        for jpath, spec in want.items():
            assert cut(tuple(got[jpath.split("/")[1]])) == cut(spec), (arch, axes, "sealed", jpath)


# ---------------------------------------------------------------------------
# the rules (the port's twins of tests/test_optim_sharding.py)


def test_resolve_rule_divisibility_fallback():
    axes = {"data": 16, "model": 16}
    # 9 heads don't divide 16 -> replicated; 64 do -> model
    assert resolve_rule(("fsdp", "heads", None), (576, 9, 64), axes)[1] is None
    assert resolve_rule(("fsdp", "heads", None), (4096, 64, 128), axes)[1] == "model"
    # experts 8 < 16 -> fall to None
    assert resolve_rule(("experts", "fsdp", None), (8, 4096, 14336), axes)[0] is None
    assert resolve_rule(("experts", "fsdp", None), (128, 4096, 1536), axes)[0] == "model"
    # batch folds pod+data when both divide
    axes3 = {"pod": 2, "data": 16, "model": 16}
    assert resolve_rule(("batch", None), (256, 128), axes3)[0] == ("pod", "data")
    for logical, shape, ax in ((("fsdp", "heads", None), (576, 9, 64), axes), (("batch", None), (256, 128), axes3),
                               (("batch", None), (6, 128), axes3), (("vocab", "fsdp"), (49155, 2048), axes)):
        assert tuple(resolve_rule(logical, shape, ax)) == tuple(jax_resolve_rule(logical, shape, ax))


def test_resolve_rule_never_reuses_axis():
    spec = resolve_rule(("tp", "tp"), (8, 8), {"data": 4, "model": 4})
    assert len([s for s in spec if s is not None]) <= 1  # second dim cannot reuse "model"


def test_infer_param_specs_no_mesh_is_replicated():
    params = {"block": {"attn": {"wq": torch.zeros((8, 4, 2))}}}
    assert infer_param_specs(params)["block"]["attn"]["wq"] == P()
    assert batch_pspec(8) == P() and logical_to_pspec(("batch",), (8,)) == P(None)
    assert activation_pspec((8, 4), ("batch", None)) == P(None, None)
    x = torch.ones(3)
    assert constrain(x, "batch") is x  # the identity without a mesh
    assert [r for r, _ in LOGICAL_RULES][0] == r"embed/table$"


def test_partition_spec_and_placements():
    """A spec compares entry by entry; its placements shard a dim named by
    one axis on that mesh dim, a tuple entry on both mesh dims (pod
    outermost, as ``NamedSharding`` orders it), and a size-1 mesh dim holds
    the dim whole."""
    from torch.distributed.tensor import Replicate, Shard

    assert P("data", None) == P("data", None) != P(None, "data")
    assert P(("pod", "data"), None, "model") == (("pod", "data"), None, "model")

    class Mesh:  # the two attributes to_placements reads
        def __init__(self, names, shape):
            self.mesh_dim_names, self.shape = names, shape

    m3 = Mesh(("pod", "data", "model"), (2, 16, 16))
    assert to_placements(P(("pod", "data"), None, "model"), m3) == (Shard(0), Shard(0), Shard(2))
    assert to_placements(P(None, "model"), m3) == (Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="axis order"):
        to_placements(P(("data", "pod")), m3)
    assert to_placements(P("data", "model"), Mesh(("data", "model"), (1, 1))) == (Replicate(), Replicate())
    assert to_placements(P("data", "model"), Mesh(("data", "model"), (1, 2))) == (Replicate(), Shard(1))


def test_public_names_and_mesh_config():
    """Every name ``repro.sharding`` exports, and every public function of
    ``repro.launch.mesh`` but its two JAX-only shims, has its port (plus
    ``init_distributed``); ``MeshConfig`` and its two layouts match the
    reference's; the hardware constants are the H100 SXM's, not a TPU's."""
    import inspect

    import repro.config.mesh as jax_mesh_config
    import repro.launch.mesh as jax_launch_mesh
    import repro.sharding as jax_sharding
    import repro_torch.config.mesh as mesh_config
    import repro_torch.launch.mesh as launch_mesh
    import repro_torch.sharding as sharding

    assert set(jax_sharding.__all__) <= set(sharding.__all__)
    assert all(callable(getattr(sharding, n)) or n == "LOGICAL_RULES" for n in sharding.__all__)
    public = {n for n, f in inspect.getmembers(jax_launch_mesh, inspect.isfunction)
              if f.__module__ == jax_launch_mesh.__name__ and not n.startswith("_")}
    want = (public - {"compat_make_mesh", "compat_mesh"}) | {"init_distributed"}
    assert want <= {n for n in dir(launch_mesh) if callable(getattr(launch_mesh, n))}, want
    for name in ("SINGLE_POD", "MULTI_POD"):
        got, ref = getattr(mesh_config, name), getattr(jax_mesh_config, name)
        assert (got.shape, got.axes, got.num_devices, got.data_axes, got.model_axis) == (
            ref.shape, ref.axes, ref.num_devices, ref.data_axes, ref.model_axis)
        assert [got.axis_size(a) for a in got.axes] == [ref.axis_size(a) for a in ref.axes]
    assert (mesh_config.PEAK_FLOPS_BF16, mesh_config.PEAK_FLOPS_F32, mesh_config.HBM_BW) == (989e12, 67e12, 3.35e12)
    assert mesh_config.HBM_BYTES == 80 * 10**9 and mesh_config.VMEM_BYTES == 227 * 1024
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW", "HBM_BYTES", "VMEM_BYTES"):
        assert getattr(mesh_config, name) != getattr(jax_mesh_config, name), name


# ---------------------------------------------------------------------------
# the launchers' --mesh on a world of one


def test_launchers_production_mesh_exits_before_allocating(monkeypatch):
    """A production or multipod mesh needs a 256- or 512-rank world: on a
    world of one both launchers exit with the size, before any weight is
    made (``init_lm`` is never reached)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(train, "init_lm", lambda *a, **k: pytest.fail("allocated"))
    monkeypatch.setattr(serve, "init_lm", lambda *a, **k: pytest.fail("allocated"))
    with pytest.raises(SystemExit, match="256"):
        train.main(["--reduced", "--device", "cpu", "--mesh", "production"])
    with pytest.raises(SystemExit, match="512"):
        train.main(["--reduced", "--device", "cpu", "--mesh", "multipod"])
    with pytest.raises(SystemExit, match="256"):
        serve.main(["--reduced", "--device", "cpu", "--mesh", "production"])
    with pytest.raises(SystemExit, match="256"):
        serve.main(["--reduced", "--device", "cpu", "--mesh", "production", "--engine", "static"])


FLEET_ARGS = ["--reduced", "--device", "cpu", "--requests", "4", "--max-slots", "2", "--prompt-len", "8", "--gen", "3"]


def test_serve_mesh_refusals():
    """The reference's ``validate_args`` rules: a multipod static run and
    ``--disagg`` with the dense layout are refused, each with its message."""
    with pytest.raises(SystemExit, match="not supported for static serving"):
        serve.main(["--reduced", "--device", "cpu", "--mesh", "multipod", "--engine", "static"])
    with pytest.raises(SystemExit, match="--disagg requires --kv-layout paged"):
        serve.main([*FLEET_ARGS, "--disagg", "--kv-layout", "dense"])


@pytest.mark.parametrize("extra, replicas", [
    (["--mesh", "multipod"], 2),  # one replica group a pod
    (["--disagg"], 1),
    (["--mesh", "production", "--replicas", "2"], 2),
])
def test_serve_fleet_runs_in_a_world_of_one(monkeypatch, extra, replicas):
    """The fleet serves in a world of one as the reference's does on one
    device: the replicas and the pair colocate meshless, no mesh is made
    (the production world of 256 is not asked for), every request
    returns, and the tokens are the single engine's."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = serve.main([*FLEET_ARGS, *extra])
    single = serve.main(FLEET_ARGS)
    assert len(out["replicas"]) == replicas
    assert len(out["completions"]) == 4 and all(len(c.tokens) == 3 for c in out["completions"])
    assert [c.tokens.tolist() for c in out["completions"]] == [c.tokens.tolist() for c in single["completions"]]


def test_mesh_host_runs_as_before():
    """``--mesh host`` is the meshless path: the same tokens as the
    default invocation, on both launchers."""
    args = ["--reduced", "--device", "cpu", "--requests", "2", "--max-slots", "2", "--prompt-len", "8", "--gen", "3"]
    tokens = lambda out: [c.tokens.tolist() for c in out["completions"]]
    assert tokens(serve.main(args + ["--mesh", "host"])) == tokens(serve.main(args))
    targs = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"]
    assert train.main(targs + ["--mesh", "host"])["losses"] == train.main(targs)["losses"]
