"""Per-device cost of one step, counted op by op as PyTorch dispatches it
(the port's counterpart of ``repro.roofline.hlo_cost``).

The reference walks the compiled, partitioned HLO of a step. The port has
no HLO: it runs eagerly. :class:`OpCounter` is a ``TorchDispatchMode``
that sees every aten op of a step as it is dispatched, usually on
``meta`` tensors, so nothing is computed and nothing is allocated:

* **FLOPs**, by dtype, from ``torch.utils.flop_counter``'s registered
  formulas (the products and convolutions), with the same decomposition
  rule as ``FlopCounterMode``, so the aten count equals that mode's on the
  same ops. A hand kernel called on ``meta`` tensors reports its call
  (:func:`repro_torch.kernels.build.record_meta_call`, from the wrapper's
  ``meta`` branch; the counter listens while it counts) with the FLOPs and
  bytes of :mod:`repro_torch.kernels.kernel_cost` at its shapes, under
  its ``LAUNCHES`` names (a bf16 attention call under the op name and its
  ``_sm90`` name, as the launch counters count it; the totals count the
  call once).
* **HBM bytes**: the operands plus the outputs of every op that
  materialises a result. Views, ``detach``, the allocations of ``empty``
  and the collectives' wait are free, as ``_FREE_OPS`` are in the
  reference. A write-only destination (``copy_``, ``fill_``, ``zero_``) is
  not read; an indexed write (``index_put_``, ``scatter_``) moves its
  values and indices, not the whole buffer, and an indexed read
  (``gather``, ``index``, ``embedding``) its output and indices, as the
  reference counts ``dynamic-update-slice`` and ``gather``. This is an
  eager, per-op proxy: every op reads and writes device memory, so it is
  no smaller than the reference's per-fusion count, where a fusion's
  internals stay on chip.
* **Collective bytes**, by the reference's five kinds: each c10d
  collective's output bytes (``all_gather_into_tensor`` under all-gather,
  ``reduce_scatter_tensor`` under reduce-scatter, ``all_to_all_single``
  under all-to-all, ``all_reduce`` under all-reduce; a broadcast, a scatter
  and point-to-point sends, where one rank sends, under
  collective-permute).
* **Peak bytes**: the storages made during the step and alive at once, at
  their most, plus the arguments' bytes (the counterparts of XLA's
  ``temp_size_in_bytes`` and ``argument_size_in_bytes``).

**Loops of like steps.** The recurrent scans (``utils/scan.py``) on
``meta`` tensors run their first two steps and count the second for all
the rest (:func:`repro_torch.utils.scan.counted_times`, through the
counter's :attr:`~OpCounter.scale`, :meth:`~OpCounter.snapshot` and
:meth:`~OpCounter.add_since`), forward and backward, as the reference
scales a while body by its trip count: a step of an mLSTM has the same
shapes, and on ``meta`` no values, whatever its index. Their peak then
holds two steps' intermediates where the loop would keep every step's.

**Per device.** Under a ``DeviceMesh`` the step's DTensors are dispatched
twice: once as DTensors, which the counter lets DTensor handle, and then
as each rank's local shards, which it counts. The shape propagation
DTensor runs on global ``FakeTensor`` stand-ins is not counted. So every
count is of the shards this process holds; a dry-run is rank 0, which
holds the largest shard where a dim does not divide the mesh.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels.build import META_LISTENERS
from repro_torch.utils.trees import tree_leaves as param_leaves

#: The reference's collective kinds (``repro.roofline.hlo_cost._COLLECTIVES``).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_aten = torch.ops.aten
#: Ops that move no bytes: allocations without a write and metadata.
_FREE_OPS = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten.detach.default, _aten.alias.default,
    _aten._unsafe_view.default, _aten.lift_fresh.default,
}
#: Ops whose first argument is written without being read.
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor, _aten.zero_.default}
#: Indexed writes: they move their values (read and written) and indices.
_INDEXED_WRITES = {_aten.index_put_.default, _aten.index_put.default, _aten._index_put_impl_.default,
                   _aten.scatter_.src, _aten.scatter.src}
#: Indexed reads: they move their output (read and written) and indices.
_INDEXED_READS = {_aten.gather.default, _aten.index.Tensor, _aten.index_select.default, _aten.embedding.default}
#: The collectives' ``wait`` and autograd wrapper return their input.
_FREE_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def collective_kind(name: str) -> str:
    """The reference's kind of a c10d op, by its name."""
    name = name.lower()
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all"
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "gather" in name:
        return "all-gather"
    if "reduce" in name:
        return "all-reduce"
    return "collective-permute"  # broadcast, scatter, send / recv: one rank sends


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (what this rank holds); a tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class OpCounter(TorchDispatchMode):
    """Counts one step: ``with OpCounter(args) as c: fn(*args)``, then
    :meth:`totals`. ``args`` are the step's arguments (params, optimizer
    state, batch, cache): their bytes are the peak's base, and their
    storages are not counted again as made during the step."""

    def __init__(self, args: Any = ()):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        self._fake, self._dtensor = FakeTensor, DTensor
        leaves = [_local(t) for t in param_leaves(args) if isinstance(t, torch.Tensor)]
        self.arg_bytes = sum(_nbytes(t) for t in leaves)
        self.flops: Dict[str, int] = defaultdict(int)
        self.aten_flops: Dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.collectives: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.scale = 1  # how many times the ops in progress count (counted_times)
        self.live = self.peak_live = 0
        self._known = {id(t.untyped_storage()) for t in leaves}
        self._keep = [t.untyped_storage() for t in leaves]  # the ids stay theirs during the count

    def __enter__(self):
        META_LISTENERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        META_LISTENERS.remove(self)
        return super().__exit__(*exc)

    # -- bookkeeping --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return {"flops": dict(self.flops), "aten_flops": dict(self.aten_flops), "bytes": self.bytes,
                "collectives": dict(self.collectives), "kernels": {k: dict(v) for k, v in self.kernels.items()}}

    def add_since(self, snap: Dict[str, Any], times: int) -> None:
        """Every count taken since ``snap`` taken ``times`` more times."""
        for name in ("flops", "aten_flops", "collectives"):
            now = getattr(self, name)
            for k in list(now):
                now[k] += times * (now[k] - snap[name].get(k, 0))
        self.bytes += times * (self.bytes - snap["bytes"])
        for name, k in self.kernels.items():
            before = snap["kernels"].get(name, {})
            for key in k:
                k[key] += times * (k[key] - before.get(key, 0))

    def _free(self, key: int, nbytes: int) -> None:
        self._known.discard(key)
        self.live -= nbytes

    def _track(self, outs: List[torch.Tensor]) -> None:
        for t in outs:
            if t.layout != torch.strided:
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._known:
                continue
            self._known.add(key)
            n = st.nbytes()
            self.live += n
            self.peak_live = max(self.peak_live, self.live)
            weakref.finalize(st, self._free, key, n)

    def kernel(self, names, nbytes: int, flops: int, dtype: torch.dtype) -> None:
        n, flops, nbytes = self.scale, int(flops) * self.scale, int(nbytes) * self.scale
        for name in names:
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
            k["calls"] += n
            k["flops"] += flops
            k["bytes"] += nbytes
        self.flops[str(dtype).removeprefix("torch.")] += flops
        self.bytes += nbytes

    def _bytes_of(self, func, args, kwargs, ins, outs) -> int:
        if func in _FREE_OPS or func.is_view:
            return 0
        if func in _INDEXED_WRITES:
            # index_put(self, indices, values), scatter(self, dim, index, src)
            values, indices = (args[3], args[2]) if func.__name__.startswith("scatter") else (args[2], args[1])
            return 2 * _nbytes(values) + sum(_nbytes(t) for t in _tensors(indices))
        if func in _INDEXED_READS:
            return 2 * sum(_nbytes(t) for t in outs) + sum(_nbytes(t) for t in ins[1:])
        n = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if func in _WRITE_ONLY:
            n -= _nbytes(args[0])
        return n

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, self._dtensor) for t in ins):
            return NotImplemented  # DTensor runs it on the local shards, which come back here
        if any(isinstance(t, self._fake) for t in ins):
            return func(*args, **kwargs)  # DTensor's shape propagation on global stand-ins
        packet = func._overloadpacket
        from torch.utils.flop_counter import flop_registry

        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:  # as FlopCounterMode: count what a composite op decomposes into
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, self._fake) for t in outs):
            return out
        self._track(outs)
        if func.namespace in ("_c10d_functional", "c10d", "_c10d_functional_autograd"):
            if func.__name__.split(".")[0] not in _FREE_COLLECTIVES:
                self.collectives[collective_kind(func.__name__)] += sum(_nbytes(t) for t in outs) * self.scale
                self.bytes += (sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)) * self.scale
            return out
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out)) * self.scale
            dtype = next((t.dtype for t in ins if t.is_floating_point()), ins[0].dtype if ins else torch.float32)
            key = str(dtype).removeprefix("torch.")
            self.flops[key] += n
            self.aten_flops[key] += n
        self.bytes += self._bytes_of(func, args, kwargs, ins, outs) * self.scale
        return out

    # -- result -------------------------------------------------------------

    def totals(self) -> Dict[str, Any]:
        """The counts of the step: ``flops`` by dtype name (aten ops and
        kernels), ``aten_flops`` by dtype, ``bytes``, ``collectives`` by
        kind, ``argument_bytes``, ``temp_bytes`` (the peak of what the step
        made) and ``kernels`` (calls, FLOPs and bytes by launch counter)."""
        return {
            "flops": dict(self.flops),
            "aten_flops": dict(self.aten_flops),
            "bytes": self.bytes,
            "collectives": dict(self.collectives),
            "argument_bytes": self.arg_bytes,
            "temp_bytes": self.peak_live,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
        }


def count_step(fn, args) -> Dict[str, Any]:
    """``fn(*args)`` once under an :class:`OpCounter`; its totals."""
    with OpCounter(args) as counter:
        fn(*args)
    return counter.totals()
