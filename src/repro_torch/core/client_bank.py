"""ClientBank: the grouped client ensemble (the port of
``repro.core.client_bank``).

``make_logits_all`` runs K heterogeneous clients as K forwards, so the host
issues each client's kernels in turn and launches grow with K. The bank
groups the clients by (apply fn, parameter structure): each group's
parameters stack into one tree with the clients on a leading axis, and the
whole group runs as ONE ``torch.func.vmap`` forward, whose convolutions and
products PyTorch batches over the clients (a convolution with batched
input and weight becomes one grouped convolution). Launches are O(#groups) =
O(#architectures), not O(K). The groups' rows are concatenated and one
``index_select`` restores client order, so the output is the same
``(K, B, C)`` stack every consumer (generator loss, DHS, EE, distillation,
and the loss kernels behind them) already takes: the bank is a drop-in
``logits_all_fn`` with its grouped params as the ``client_params``.

``scan_chunk`` is the memory lever: a group larger than it runs as a loop
over vmapped chunks of that many clients, bounding live activations to
(chunk, B, ...) instead of (group, B, ...). The last chunk may be short
(the reference pads it only because ``lax.scan`` needs static shapes).

Outputs are cast to the ensemble dtype (f32) at this boundary, so a bf16
client next to f32 ones gives an f32 stack. The stacked parameters are
detached: gradients flow to the input (generator, DHS) through the vmapped
forwards, never to the clients.

Numerics: a grouped convolution sums in another order than K separate
ones, so grouped and looped agree at a tolerance, not bitwise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.train import ENSEMBLE_IMPLS
from repro_torch.core.ensemble import ENSEMBLE_DTYPE, make_logits_all
from repro_torch.utils.trees import flatten_dict, tree_leaves, tree_map, tree_stack, tree_unstack, vmap_dims


def _apply_key(fn: Callable) -> Any:
    """A hashable grouping key for an apply fn. ``functools.partial`` is
    destructured (two ``partial(cnn_apply, "mlp")`` objects must group
    together, though a partial hashes by identity); anything unhashable
    falls back to object identity: at worst a singleton group, never a
    wrong group."""
    if isinstance(fn, functools.partial):
        kw = tuple(sorted(fn.keywords.items())) if fn.keywords else ()
        key = ("partial", _apply_key(fn.func), fn.args, kw)
    else:
        key = ("fn", fn)
    try:
        hash(key)
        return key
    except TypeError:
        return ("id", id(fn))


def _params_key(params: Any) -> Any:
    """The flattened paths with each tensor leaf's shape and dtype and each
    non-tensor leaf's value (a block's ``"stride"``)."""
    return tuple(
        (path, ("tensor", tuple(leaf.shape), str(leaf.dtype)) if torch.is_tensor(leaf) else ("value", leaf))
        for path, leaf in flatten_dict(params).items()
    )


@dataclasses.dataclass(frozen=True)
class ClientBank:
    """Host-side description of a grouped client ensemble.

    The bank holds no parameters: its grouped params travel separately as a
    ``tuple`` of stacked trees (one per group, clients on the leading axis),
    exactly where the per-client params list went. ``inverse`` is the
    index, on the params' device, that restores client order (``None``
    when the stacked rows are already in client order). Build with
    :meth:`ClientBank.build`, evaluate with :meth:`logits_all`.
    """

    applies: Tuple[Callable, ...]  # one apply fn per group
    counts: Tuple[int, ...]  # clients per group
    order: Tuple[int, ...]  # original client index of each stacked row
    scan_chunk: int = 0
    inverse: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def num_clients(self) -> int:
        return len(self.order)

    @property
    def num_groups(self) -> int:
        return len(self.applies)

    @property
    def is_client_ordered(self) -> bool:
        return self.order == tuple(range(self.num_clients))

    @classmethod
    def build(
        cls, apply_fns: Sequence[Callable], params_list: Sequence[Any], scan_chunk: int = 0
    ) -> Tuple["ClientBank", Tuple[Any, ...]]:
        """Group clients by (apply fn, parameter paths, shapes, dtypes and
        non-tensor values) and stack each group, detached. Returns
        ``(bank, bank_params)``; groups keep first-seen order and clients
        their order within a group, so a homogeneous market is one group
        with ``order == range(K)``."""
        if len(apply_fns) != len(params_list):
            raise ValueError(f"{len(apply_fns)} apply fns for {len(params_list)} clients")
        groups: Dict[Any, int] = {}
        applies: List[Callable] = []
        members: List[List[int]] = []
        for k, (fn, p) in enumerate(zip(apply_fns, params_list)):
            key = (_apply_key(fn), _params_key(p))
            g = groups.get(key)
            if g is None:
                g = groups[key] = len(applies)
                applies.append(fn)
                members.append([])
            members[g].append(k)
        order = tuple(k for m in members for k in m)
        device = tree_leaves(params_list[0])[0].device
        inverse = None
        if order != tuple(range(len(order))):
            inverse = torch.as_tensor(np.argsort(np.asarray(order)), device=device)
        bank = cls(tuple(applies), tuple(len(m) for m in members), order, int(scan_chunk), inverse)
        bank_params = tuple(
            tree_map(torch.Tensor.detach, tree_stack([params_list[k] for k in m])) for m in members
        )
        return bank, bank_params

    # -- forward ------------------------------------------------------------

    def _group_logits(self, g: int, stacked: Any, x: torch.Tensor) -> torch.Tensor:
        """One group's (n_g, B, C) client logits: one vmapped forward, or a
        loop over vmapped chunks when the group outgrows ``scan_chunk``.
        ``x`` goes to every client as a stride-0 view, so the first layer is
        a grouped convolution like the rest and the input gradient comes
        back per client and is summed over the clients, as in the loop (a
        shared ``x`` would sum the clients inside the first convolution's
        data gradient, in another order)."""
        n, c = self.counts[g], self.scan_chunk
        fwd = torch.func.vmap(self.applies[g], in_dims=(vmap_dims(stacked), 0))
        if c <= 0 or n <= c:
            out = fwd(stacked, x.expand(n, *x.shape))
        else:
            out = torch.cat([
                fwd(tree_map(lambda l, i=i: l[i : i + c], stacked), x.expand(min(c, n - i), *x.shape))
                for i in range(0, n, c)
            ])
        return out.to(ENSEMBLE_DTYPE)

    def logits_all(self, bank_params: Tuple[Any, ...], x: torch.Tensor) -> torch.Tensor:
        """f(bank_params, x) -> (K, B, C) stacked client logits in client
        order: the drop-in for the fn :func:`make_logits_all` builds."""
        outs = [self._group_logits(g, sp, x) for g, sp in enumerate(bank_params)]
        stacked = outs[0] if len(outs) == 1 else torch.cat(outs)
        if self.is_client_ordered:
            return stacked
        return stacked.index_select(0, self.inverse)

    # -- interop ------------------------------------------------------------

    def unstack_params(self, bank_params: Tuple[Any, ...]) -> List[Any]:
        """Back to the per-client params list, in client order."""
        rows = []
        for n, sp in zip(self.counts, bank_params):
            rows.extend(tree_unstack(sp, n))
        out: List[Any] = [None] * self.num_clients
        for row, k in zip(rows, self.order):
            out[k] = row
        return out

    def stack_params(self, params_list: Sequence[Any]) -> Tuple[Any, ...]:
        """Regroup a client-ordered params list into this bank's layout."""
        if len(params_list) != self.num_clients:
            raise ValueError(f"{len(params_list)} params for a bank of {self.num_clients} clients")
        out, at = [], 0
        for n in self.counts:
            out.append(tree_stack([params_list[k] for k in self.order[at : at + n]]))
            at += n
        return tuple(out)

    def client_apply(self, k: int) -> Callable:
        """The apply fn of client ``k``."""
        at = 0
        for g, n in enumerate(self.counts):
            if k in self.order[at : at + n]:
                return self.applies[g]
            at += n
        raise IndexError(k)


def make_ensemble(
    apply_fns: Sequence[Callable], params_list: Sequence[Any], impl: str = "grouped", scan_chunk: int = 0
) -> Tuple[Callable, Any]:
    """The one ensemble constructor every method driver uses. Returns
    ``(logits_all_fn, ensemble_params)`` with
    ``logits_all_fn(ensemble_params, x) -> (K, B, C)`` in client order:

    * ``impl="grouped"``: a :class:`ClientBank` (params stacked per arch
      group, one vmapped forward a group; the default, as in the reference);
    * ``impl="looped"``: one forward per client over the tuple of
      per-client params (the parity baseline).
    """
    if impl == "looped":
        return make_logits_all(list(apply_fns)), tuple(params_list)
    if impl != "grouped":
        raise ValueError(f"unknown ensemble impl {impl!r}; expected one of {ENSEMBLE_IMPLS}")
    bank, bank_params = ClientBank.build(apply_fns, params_list, scan_chunk=scan_chunk)
    return bank.logits_all, bank_params
