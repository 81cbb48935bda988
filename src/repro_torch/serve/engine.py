"""Serving engine for the distilled server LM (the port's copy of
``repro.serve.engine``): a prefill/decode worker pair composed into
:class:`ServeEngine`, colocated or disaggregated behind an explicit KV
handoff.

* :class:`PrefillWorker` — admission: prefills a bucketed burst of prompts
  in one batch (padded to a ``prefill_bucket`` multiple; the pad tail is
  never attended because decode overwrites position ``p`` before reading
  it), samples each row's first token from its true last prompt position,
  and seals the result into a :class:`KVHandoff`: the attention KV re-viewed
  as page units ``(L, N, n_alloc, page, KH, hd)`` (paged layout) or the
  dense rows, and every recurrent carry's rows. A recurrent arch (SSM,
  hybrid) prefills to its exact prompt length, since a carry absorbs pad
  tokens; an arch without attention runs the dense layout. A staging
  :class:`~repro_torch.serve.kv_pool.KVPool` accounts the in-flight
  handoff pages.
* :class:`DecodeWorker` — owns the device-resident per-slot
  :class:`DecodeState` (each request lives in one of ``max_slots`` slots
  with its own position), ``adopt``s handoffs (pool ids from its pool, the
  sealed pages copied into its buffers: data movement, no model forward)
  and runs decode chunks with on-device sampling. The host reads back only
  the ``(active, n_out)`` vectors once per chunk (``sync``) and a finished
  request's tokens once at eviction (``fetch``).

Because adoption is data movement, a request prefilled by one worker can
land on another worker's pool than the one it decodes from: that is the
disaggregation seam. ``ServeEngine(..., mesh=d, prefill_mesh=p)`` places
the prefill worker on mesh ``p`` and the decode worker on mesh ``d`` (the
reference's, paged only, since the dense per-slot rectangle has no page
units to hand off); the halves are disjoint rank sets, so ``adopt`` sends
each sealed burst whole from ``p`` to ``d`` in one broadcast and places it
by the decode worker's own specs. ``ServeEngine(..., prefill_device=...)``
is the meshless pair: the prefill worker on another device of the same
process. Either transport runs under the ``serve.handoff`` span. Unset,
the pair colocates. It runs the same programs either way, so the
colocated engine is the disaggregated pair's parity oracle by
construction.

Multi-controller: every rank builds every worker (mesh groups are made
collectively, and a fleet's router needs every replica's bookkeeping),
but a worker runs its device work only on the ranks of its own mesh
(:func:`device_program`); elsewhere it keeps the host state (slots,
pages, budgets), which advances from the readbacks the router shares
(:meth:`DecodeWorker.head` into :meth:`DecodeWorker.advance`, the finished
slots' rows into :meth:`DecodeWorker.hold`).

The reference runs a chunk as one ``lax.while_loop`` dispatch. Here a
chunk is a Python loop of device ops that never reads the device: finished
rows stay frozen on the device, and the host bounds the loop by the largest
remaining budget it knows from the last sync (the step at which the
reference's loop condition would stop, when no EOS token is set), so there
is still one host sync per chunk. A speculative chunk emits a
data-dependent number of tokens a round, so the host cannot know when the
reference's loop stops: it runs every round the budget bound allows, and a
round after every row has finished changes nothing the reference would not
(see :mod:`repro_torch.serve.spec_decode`).

Two opt-in accelerations live on the decode worker, because they need the
pool and the slot state: the **radix prefix cache** (``ecfg.prefix_cache``;
a hot admission splices resident pages into its page table and prefills
only the tail through ``lm_extend``, :meth:`DecodeWorker.admit_spliced`)
and **speculative decoding** (``ecfg.spec_k`` and a ``drafter``; the chunk
drafts and verifies through :class:`repro_torch.serve.spec_decode.SpecDecoder`).

Two KV layouts (``EngineConfig.kv_layout``): **paged** (default) — a shared
page pool; admission allocates the pages the bucketed prefill fills, decode
appends a page when a slot's position crosses a page boundary (planned once
per chunk on the host), eviction returns the slot's pages, and decode
attention goes through the flash-decode op. **dense** — the per-slot
``(slots, cache_len, ...)`` rectangle attending through the small SDPA
path; the parity baseline.

Inactive slots ride along in the batched decode: their position is frozen,
so they rewrite one cache location with the same values. The dense layout
absorbs those writes in the slot's own row; the paged layout re-aims every
idle or evicted slot's page-table row at the pool's never-allocated scratch
page before the next chunk, because its old pages may already belong to
another slot.

Telemetry (:mod:`repro_torch.obs`): ``stats`` is a
:class:`~repro_torch.obs.StatsView` over a metrics registry (the
``serve.*`` names of :data:`repro_torch.obs.SERVE_ENGINE_METRICS`,
labelled with the replica id); it counts dispatches and host syncs (one per
decode chunk). A bare engine gets a private registry; a launcher passes the
shared one. Host-side spans (``serve.prefill``, ``serve.handoff``,
``serve.adopt``, ``serve.splice``, ``serve.decode_chunk``,
``serve.spec.verify``, ``serve.sync``) bracket the hot path's actions and
never force a device sync.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models.attention import take_rows, write_rows
from repro_torch.models.transformer import group_pattern, init_lm_state, lm_decode, lm_extend, lm_prefill
from repro_torch.obs import KV_GAUGES, SERVE_ENGINE_METRICS, MetricsRegistry, StatsView
from repro_torch.launch.mesh import group_over, mesh_ranks, on_this_rank
from repro_torch.serve.kv_pool import KVPool
from repro_torch.sharding.partition import (
    mesh_axes_of, mesh_context, place, shard_engine_state, shard_params, shard_whole, whole,
)
from repro_torch.utils.trees import tree_map

KV_LAYOUTS = ("paged", "dense")


def shard_state(state, mesh):
    """Place a model/engine state's leaves on ``mesh`` by
    :func:`~repro_torch.sharding.shard_engine_state` (KV heads and
    recurrent channels over the model axis); identity without a mesh."""
    if mesh is None:
        return state
    return place(state, shard_engine_state(state, mesh_axes=mesh_axes_of(mesh)), mesh)


def device_program(fn):
    """A worker method's device work runs without autograd: under
    ``inference_mode`` for a meshless worker, under ``no_grad`` for one on
    a mesh (DTensor cannot take views of a state made outside inference
    mode inside it). ``self.mesh`` (or ``self.worker.mesh``) decides. On a
    rank outside the worker's mesh the method does nothing and returns
    None: that rank keeps only the worker's host bookkeeping."""

    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        owner = self if hasattr(self, "mesh") else self.worker
        if not owner.local:
            return None
        with torch.inference_mode() if owner.mesh is None else torch.no_grad():
            return fn(self, *args, **kwargs)

    return run


def sample_tokens(logits: torch.Tensor, gen: Optional[torch.Generator], temperature: float) -> torch.Tensor:
    """On-device sampling. logits: (B, V) -> (B,) int32. ``temperature <= 0``
    is greedy (argmax, first index on ties); otherwise temperature-scaled
    categorical from ``gen``. Sharded logits are made whole first, so every
    rank samples the same tokens."""
    logits = whole(logits)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Continuous-batching knobs (the model itself comes from ModelConfig).
    Construction fails fast on inconsistent paged-KV knobs, before any
    device allocation."""

    max_slots: int = 4  # concurrent sequences resident on device
    max_seq: int = 256  # per-slot cache length (prompt + generation)
    max_new: int = 64  # output-buffer width (per-request budget <= this)
    decode_chunk: int = 16  # decode steps per chunk (and per host sync)
    prefill_bucket: int = 32  # prompts pad up to a multiple of this
    temperature: float = 0.0  # 0 => greedy
    eos_token: int = -1  # <0 => disabled (synthetic streams have no EOS)
    seed: int = 0
    kv_layout: str = "paged"  # paged (KVPool + flash-decode) | dense (SDPA)
    page_size: int = 16  # tokens per KV page (power of two)
    pool_pages: int = 0  # pool capacity; 0 => max_slots × full per-slot width
    prefix_cache: bool = False  # radix prefix cache over refcounted pages
    spec_k: int = 0  # speculative decoding: drafts per verify step (0 = off)

    def __post_init__(self):
        for field in ("max_slots", "max_seq", "max_new", "decode_chunk", "prefill_bucket"):
            if getattr(self, field) < 1:
                raise ValueError(f"EngineConfig.{field} must be >= 1, got {getattr(self, field)}")
        if self.kv_layout not in KV_LAYOUTS:
            raise ValueError(f"EngineConfig.kv_layout must be one of {KV_LAYOUTS}, got {self.kv_layout!r}")
        if self.spec_k < 0:
            raise ValueError(f"EngineConfig.spec_k must be >= 0, got {self.spec_k}")
        if self.spec_k and self.temperature > 0.0:
            raise ValueError(
                "speculative decoding (spec_k > 0) requires temperature=0: the "
                "accept-longest-greedy-run verify is a GREEDY parity contract; "
                "sampled drafts would need rejection sampling the engine does "
                "not implement. Drop --spec-decode or set --temperature 0."
            )
        if self.kv_layout != "paged":
            if self.prefix_cache:
                raise ValueError(
                    'prefix_cache=True requires kv_layout="paged": prefix sharing '
                    "IS page-table splicing — the dense per-slot rectangle has no "
                    "page units to share. Drop --prefix-cache or use --kv-layout "
                    "paged."
                )
            return
        if self.page_size < 1 or (self.page_size & (self.page_size - 1)):
            raise ValueError(
                f"EngineConfig.page_size must be a power of two, got {self.page_size} "
                "(page offsets are bit-sliced from positions)"
            )
        if self.max_seq % self.page_size:
            raise ValueError(
                f"EngineConfig.max_seq={self.max_seq} must be a multiple of "
                f"page_size={self.page_size} so the page-table extent recovers the "
                "logical cache length exactly (round max_seq up)"
            )
        if self.pool_pages and self.pool_pages < self.max_slots:
            raise ValueError(
                f"pool_pages={self.pool_pages} < max_slots={self.max_slots}: "
                "every live slot needs at least one page"
            )


@dataclasses.dataclass
class DecodeState:
    """The device-resident per-slot state decode chunks update in place."""

    kv: Dict[str, torch.Tensor]  # model state, leaves (L, max_slots, ...) or page pools
    last_tok: torch.Tensor  # (S, 1) int32 — last sampled token per slot
    pos: torch.Tensor  # (S,) int32 — position the next decode step writes
    active: torch.Tensor  # (S,) bool
    out: torch.Tensor  # (S, max_new) int32 — generated tokens per slot
    n_out: torch.Tensor  # (S,) int32 — tokens generated so far
    budget: torch.Tensor  # (S,) int32 — per-request generation budget
    page_table: torch.Tensor  # (S, W) int32 — per-slot page ids ((S, 1) dummy when dense)


class KVHandoff(NamedTuple):
    """One sealed prefill burst in flight between a prefill worker and a
    decode worker. Page ids are pool-local and never travel: the adopting
    pool assigns its own."""

    # paged: k_pages/v_pages (L_attn, N, n_alloc, page, KH, hd); dense: k/v
    # (L_attn, N, cl, KH, hd); either: every recurrent carry's rows (L_mixer, N, ...)
    sealed: Dict[str, torch.Tensor]
    first_tok: torch.Tensor  # (N,) int32 — first sampled token per row
    true_lens: np.ndarray  # (N,) host — true prompt lengths
    budgets: np.ndarray  # (N,) host — generation budgets
    n_alloc: int  # sealed pages per row (0 for the dense layout)
    staging_id: int  # staging-pool reservation on the source (-1 when none)
    source: Any  # the PrefillWorker that sealed this burst
    tokens: Any = None  # (N, bucket) host prompt tokens: the adopting side
    # feeds them to the speculative drafter's own prefill; never needed by
    # the target model

    @property
    def n(self) -> int:
        return len(self.true_lens)


def bucket_len(cfg, ecfg: EngineConfig, prompt_len: int) -> int:
    """The padded prefill length of a prompt."""
    if cfg.family in ("ssm", "hybrid"):
        # a recurrent carry (Mamba or xLSTM state) absorbs pad tokens: the
        # prefill must stop exactly at the prompt's end. Attention caches
        # are position-addressed: the pad tail is overwritten before it is
        # ever attended, so bucketing is safe for them.
        return prompt_len
    b = ecfg.prefill_bucket
    lb = min(-(-prompt_len // b) * b, ecfg.max_seq)
    if cfg.sliding_window > 0:
        # the SWA cache is a ring of min(window, max_seq) slots holding the
        # LAST cache-len prefill positions; padding past the ring length
        # would evict real prompt tokens in favour of pad garbage.
        cl = min(cfg.sliding_window, ecfg.max_seq)
        lb = prompt_len if prompt_len > cl else min(lb, cl)
    return lb


def engine_layout(cfg, ecfg: EngineConfig) -> str:
    """The layout the engine runs: ``ecfg.kv_layout``, except that an arch
    without attention layers has no KV to page and runs the dense layout
    (its recurrent carries are per slot either way)."""
    has_attn = any(mixer == "attn" for mixer, _ in group_pattern(cfg))
    return ecfg.kv_layout if has_attn else "dense"


def _require_extend_capable(cfg, ecfg: EngineConfig, feature: str) -> None:
    """Both prefix sharing and speculative verify run :func:`lm_extend` —
    "prefill semantics starting mid-cache" — which only attention caches
    support: a recurrent carry can neither start mid-sequence (splice) nor
    roll back rejected positions (verify), and an SWA ring wraps writes
    into pages another request may share. Fails fast, before the device."""
    from repro_torch.models.attention import cache_len

    non_attn = [m for m, _ in group_pattern(cfg) if m != "attn"]
    if non_attn:
        raise ValueError(
            f"{cfg.name}: {feature} requires attention-only mixers, found "
            f"{sorted(set(non_attn))} — a recurrent carry cannot be spliced "
            "mid-sequence or rolled back after a rejected draft"
        )
    if cache_len(cfg, ecfg.max_seq) != ecfg.max_seq:
        raise ValueError(
            f"{cfg.name}: {feature} requires a full (non-ring) KV cache, but "
            f"sliding_window={cfg.sliding_window} < max_seq={ecfg.max_seq} "
            "makes decode writes wrap into earlier pages — a wrapped write "
            "would land in a page another request shares"
        )


def check_accelerations(cfg, ecfg: EngineConfig, has_drafter: bool = True) -> None:
    """The decode worker's refusals of the prefix cache and speculative
    decoding (``has_drafter``: whether a drafter was given) for this arch,
    raised before any device work; the launcher turns them into its exit
    message."""
    layout = engine_layout(cfg, ecfg)
    if ecfg.prefix_cache:
        if layout != "paged":
            raise ValueError(
                f"{cfg.name}: prefix_cache requires the paged layout, but this "
                "arch has no attention KV to page (it degrades to dense)"
            )
        _require_extend_capable(cfg, ecfg, "prefix_cache")
    if ecfg.spec_k > 0:
        if not has_drafter:
            raise ValueError(
                "spec_k > 0 but no drafter: pass drafter=(cfg, params) — any "
                "registry config with attention-only mixers (e.g. a reduced "
                "smollm-135m) can draft"
            )
        if layout != "paged":
            raise ValueError(
                f"{cfg.name}: spec_decode requires the paged layout — the "
                "batched verify is an lm_extend over the page-table view"
            )
        _require_extend_capable(cfg, ecfg, "spec_decode")


def _fresh_stats(registry: Optional[MetricsRegistry] = None, replica: int = 0) -> StatsView:
    """One engine's stats: a dict-shaped view over the ``serve.*`` names of
    :data:`SERVE_ENGINE_METRICS`, labelled with the replica id. Without a
    registry the engine gets a private, always-on one: its stats must count
    whether or not the run exports telemetry."""
    if registry is None:
        registry = MetricsRegistry()
    return registry.view(SERVE_ENGINE_METRICS, replica=replica)


def _device_of(params) -> torch.device:
    return params["embed"]["table"].device


class PrefillWorker:
    """Admission half of the serving pair: bucketed prefill sealed into
    :class:`KVHandoff`s, with its own sampling generator and (paged layout)
    a staging pool bounding in-flight handoff pages."""

    def __init__(self, cfg, params, ecfg: EngineConfig, *, stats: Optional[StatsView] = None,
                 registry: Optional[MetricsRegistry] = None, replica: int = 0, mesh=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.mesh = mesh
        self.local = on_this_rank(mesh)
        self.params = params
        self.device = _device_of(params)
        self.layout = engine_layout(cfg, ecfg)
        self.replica = replica
        self.staging: Optional[KVPool] = KVPool(cfg, ecfg) if self.layout == "paged" else None
        self.stats = stats if stats is not None else _fresh_stats(registry, replica)
        self.reset()

    def reset(self) -> None:
        self._gen = torch.Generator(device=self.device).manual_seed(self.ecfg.seed + 1)  # decode owns seed
        if self.staging is not None:
            self.staging.reset()

    def bucket_len(self, prompt_len: int) -> int:
        return bucket_len(self.cfg, self.ecfg, prompt_len)

    @device_program
    def _prefill(self, tokens: torch.Tensor, true_lens: torch.Tensor):
        """Prefill N prompts, sample their first tokens, seal the KV."""
        cfg, e = self.cfg, self.ecfg
        n = tokens.shape[0]
        st1 = shard_state(init_lm_state(cfg, n, e.max_seq, device=self.device), self.mesh)
        with mesh_context(self.mesh):
            logits, st1 = lm_prefill(self.params, cfg, {"tokens": tokens}, st1, last_index=true_lens - 1)
        toks0 = sample_tokens(logits[:, 0], self._gen, e.temperature)  # (N,)
        if self.layout != "paged":
            return st1, toks0
        ps = self.staging.page_size
        n_alloc = self.staging.required_pages(tokens.shape[1])
        # recurrent carries travel as their dense rows
        sealed = {name: leaf for name, leaf in st1.items() if name not in ("k", "v")}
        for pages_name, dense_name in (("k_pages", "k"), ("v_pages", "v")):
            one = st1[dense_name]  # (L_attn, N, cl, KH, hd)
            pad = (-one.shape[2]) % ps
            if pad:
                one = torch.nn.functional.pad(one, (0, 0, 0, 0, 0, pad))
            # re-view the bucketed prefill as page units and keep only the
            # pages it filled: the shape the adopting pool copies verbatim
            sealed[pages_name] = one.reshape(one.shape[0], n, -1, ps, *one.shape[3:])[:, :, :n_alloc]
        return sealed, toks0

    def prefill_group(self, group) -> KVHandoff:
        """Prefill one same-bucket group of ``(tokens, budget)`` pairs in one
        batch and seal it for handoff. The caller sizes groups in powers of
        two."""
        n = len(group)
        lb = self.bucket_len(max(len(t) for t, _ in group))
        padded = np.zeros((n, lb), np.int32)
        lens = np.zeros((n,), np.int32)
        buds = np.zeros((n,), np.int32)
        for j, (tokens, budget) in enumerate(group):
            padded[j, : len(tokens)] = tokens
            lens[j], buds[j] = len(tokens), budget
        staging_id, n_alloc = -1, 0
        if self.staging is not None:
            # backpressure: the staging pool caps how many sealed-but-not-
            # adopted pages can be in flight; adopt() donates them back
            n_alloc = self.staging.required_pages(lb)
            staging_id, _ = self.staging.stage(n * n_alloc)
        with obs.span("serve.prefill", replica=self.replica, n=n, bucket=lb):
            # (None, None) on a rank outside this worker's mesh
            sealed, toks0 = self._prefill(
                torch.as_tensor(padded, device=self.device), torch.as_tensor(lens, device=self.device)
            ) or (None, None)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += n * lb
        return KVHandoff(
            sealed=sealed, first_tok=toks0, true_lens=lens, budgets=buds,
            n_alloc=n_alloc, staging_id=staging_id, source=self, tokens=padded,
        )

    def release(self, handoff: KVHandoff) -> None:
        """Donate a handoff's staging reservation back (the adopting worker
        has copied the sealed pages)."""
        if self.staging is not None and handoff.staging_id >= 0:
            self.staging.donate(handoff.staging_id)


class DecodeWorker:
    """Decode half of the serving pair: owns the slots, the KV pool and the
    chunked decode loop; ingests sealed prefills through ``adopt``, and
    hot-prefix admissions through ``admit_spliced`` (the matched pages are
    resident in this worker's pool). With ``ecfg.spec_k`` and a
    ``drafter=(cfg, params)`` the chunk drafts and verifies through
    :class:`repro_torch.serve.spec_decode.SpecDecoder`."""

    def __init__(self, cfg, params, ecfg: EngineConfig, *, stats: Optional[StatsView] = None,
                 registry: Optional[MetricsRegistry] = None, drafter=None, replica: int = 0, mesh=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.mesh = mesh
        self.local = on_this_rank(mesh)
        # the process group a cross-mesh handoff travels over (ServeEngine
        # sets it for a pair on disjoint meshes)
        self.handoff_group = None
        self.params = params
        self.device = _device_of(params)
        self.layout = engine_layout(cfg, ecfg)
        self.replica = replica
        self.pool: Optional[KVPool] = KVPool(cfg, ecfg) if self.layout == "paged" else None
        self.stats = stats if stats is not None else _fresh_stats(registry, replica)
        check_accelerations(cfg, ecfg, drafter is not None)
        self.prefix = None
        if ecfg.prefix_cache:
            from repro_torch.serve.prefix_cache import PrefixCache

            self.prefix = PrefixCache(self.pool)
        self._spec = None
        if ecfg.spec_k > 0:
            from repro_torch.serve.spec_decode import SpecDecoder

            self._spec = SpecDecoder(self, drafter[0], drafter[1], ecfg.spec_k)
        elif drafter is not None:
            raise ValueError("drafter given but spec_k == 0: set spec_k to enable it")
        self.reset()

    # -- device programs ----------------------------------------------------

    @device_program
    def _cow(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Copy-on-write, device half: duplicate pages ``src`` (M,) into
        ``dst`` (M,) on every layer's page buffers ((L, P, page, KH, hd)).
        The host half (``KVPool.cow``) already swapped the table entry;
        ``src == dst == scratch`` rows are self-copies of the scratch page,
        whose write order is moot."""
        for name in ("k_pages", "v_pages"):
            big = self._state.kv[name]
            write_rows(big, (slice(None), dst), take_rows(big, (slice(None), src)))

    @device_program
    def _splice(self, tokens, slot: int, start: int, last_idx: int, budget: int, true_len: int,
                table_row, cow_src, cow_dst) -> None:
        """One hot-prefix admission: the copy-on-write page duplicate
        (scratch onto scratch when none is needed), the slot's new page-table
        row (spliced prefix pages and fresh tail pages), the tail extend
        (only the tokens the radix match did not cover), first-token sampling
        from the true last prompt position and the slot's bookkeeping."""
        ds = self._state
        self._cow(cow_src, cow_dst)
        ds.page_table[slot] = table_row
        start_v = torch.full((1,), start, dtype=torch.int32, device=self.device)
        with mesh_context(self.mesh):
            logits, _ = lm_extend(self.params, self.cfg, tokens, ds.kv, start_v, table_row[None, :])
        tok0 = sample_tokens(logits[:, last_idx], self._gen, self.ecfg.temperature)[0]
        ds.last_tok[slot, 0] = tok0
        ds.pos[slot] = true_len
        ds.active[slot] = budget > 1
        ds.out[slot] = 0
        ds.out[slot, 0] = tok0
        ds.n_out[slot] = 1
        ds.budget[slot] = budget

    @device_program
    def _adopt(self, sealed, toks0, slots, true_lens, budgets, table_rows, page_ids) -> None:
        """Ingest one sealed burst: data movement only. Paged: the sealed
        page units land in this worker's pool at the ids its pool assigned
        (one copy per leaf for the whole burst; ids are disjoint across
        rows). Dense, and every recurrent carry in either layout: the rows
        land on their slots, overwriting whatever the slot's carries held
        (an idle slot's carries keep stepping in decode chunks)."""
        ds = self._state
        for name, rows in sealed.items():
            big = ds.kv[name]
            if name in ("k_pages", "v_pages"):
                write_rows(big, (slice(None), page_ids), rows)  # (L_attn, P, ps, KH, hd)
            else:
                write_rows(big, (slice(None), slots), rows)
        if self.layout == "paged":
            ds.page_table[slots] = table_rows
        ds.last_tok[slots, 0] = toks0
        ds.pos[slots] = true_lens
        ds.active[slots] = budgets > 1
        ds.out[slots] = 0
        ds.out[slots, 0] = toks0
        ds.n_out[slots] = 1
        ds.budget[slots] = budgets

    @device_program
    def _chunk(self, steps: int) -> None:
        """``steps`` batched decode steps, on the device only: no value is
        read back, so the host never waits inside a chunk."""
        cfg, e, s = self.cfg, self.ecfg, self._state
        rows = torch.arange(e.max_slots, device=self.device)
        paged = self.layout == "paged"
        for _ in range(steps):
            with mesh_context(self.mesh):
                logits, _ = lm_decode(
                    self.params, cfg, s.last_tok, s.kv, s.pos, page_table=s.page_table if paged else None
                )
            nxt = sample_tokens(logits[:, -1], self._gen, e.temperature)
            write = s.active & (s.n_out < e.max_new)
            idx = torch.clamp(s.n_out, max=e.max_new - 1).long()
            s.out[rows, idx] = torch.where(write, nxt, s.out[rows, idx])
            s.n_out += write.to(torch.int32)
            finished = s.n_out >= s.budget
            if e.eos_token >= 0:
                finished |= (nxt == e.eos_token) & s.active
            s.last_tok = torch.where(s.active[:, None], nxt[:, None], s.last_tok)
            s.pos += s.active.to(torch.int32)
            s.active &= ~finished

    # -- host API -----------------------------------------------------------

    def reset(self) -> None:
        """(Re)build the device state: all slots free, caches zeroed. Stats
        are not zeroed here (they belong to the composition)."""
        cfg, e, dev = self.cfg, self.ecfg, self.device
        self.free_slots: List[int] = list(range(e.max_slots))
        # host-side per-slot metadata for page planning: (true_len, budget)
        # and a conservative position estimate (reconciled downward at sync)
        self._meta: Dict[int, Tuple[int, int]] = {}
        self._pos_est: Dict[int, int] = {}
        # per resident slot: its budget, and the tokens it may still
        # generate as of the last sync (bounds the next chunk's steps)
        self._budget: Dict[int, int] = {}
        self._left: Dict[int, int] = {}
        # finished slots' output rows, on the host until fetched, and the
        # slots the last sync found finished whose rows are still to come
        self._held: Dict[int, np.ndarray] = {}
        self.finishing: List[int] = []
        # pages a slot borrowed from the prefix cache instead of allocating
        # (its billed load is discounted by exactly this many pages)
        self._spliced: Dict[int, int] = {}
        # evicted slots whose table rows still point at returned pages; their
        # ride-along writes must be re-aimed at the scratch page before the
        # next chunk (unless adoption rewrites the row first)
        self._stale_slots: set = set()
        self._gen = torch.Generator(device=dev).manual_seed(e.seed)
        if self.prefix is not None:
            self.prefix.clear()  # refcounts are wiped by pool.reset() below
        if self.pool is not None:
            self.pool.reset()
        if self._spec is not None:
            self._spec.reset()
        self._state: Optional[DecodeState] = None
        if not self.local:
            return  # another rank's worker: host bookkeeping only
        if self.pool is not None:
            # +1: the scratch page — the write target of idle slots' frozen
            # ride-along positions (never allocated, reads always masked)
            kv = init_lm_state(
                cfg, e.max_slots, e.max_seq, kv_pages=self.pool.n_pages + 1,
                kv_page_size=self.pool.page_size, device=dev,
            )
            table0 = torch.full((e.max_slots, self.pool.pages_per_slot), self.pool.scratch_page, dtype=torch.int32, device=dev)
        else:
            kv = init_lm_state(cfg, e.max_slots, e.max_seq, device=dev)
            table0 = torch.zeros((e.max_slots, 1), dtype=torch.int32, device=dev)
        zeros = lambda *shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype, device=dev)
        self._state = DecodeState(
            kv=shard_state(kv, self.mesh),
            last_tok=zeros(e.max_slots, 1),
            pos=zeros(e.max_slots),
            active=zeros(e.max_slots, dtype=torch.bool),
            out=zeros(e.max_slots, e.max_new),
            n_out=zeros(e.max_slots),
            budget=zeros(e.max_slots),
            page_table=table0,
        )

    def _lifetime_pages(self, prompt_len: int, budget: int) -> int:
        """A request's total page bill over its life: the bucketed prefill
        plus every decode position its budget can reach (ring-clamped)."""
        lb = bucket_len(self.cfg, self.ecfg, prompt_len)
        return self.pool.required_pages(max(lb, prompt_len + budget))

    def request_load(self, prompt_len: int, budget: int) -> int:
        """The admission-load unit a router bills for one request: lifetime
        pages in the paged layout, one slot otherwise."""
        if self.pool is None:
            return 1
        return self._lifetime_pages(prompt_len, budget)

    def billed_pages(self) -> int:
        """Resident load: the lifetime page bill of every resident request
        (paged) or the resident count (dense). Spliced pages are discounted:
        a request serving its prompt off shared prefix pages loads the pool
        (and the router's least-loaded comparison) only by the pages it
        grows into privately."""
        if self.pool is None:
            return self.ecfg.max_slots - len(self.free_slots)
        return sum(
            self._lifetime_pages(tl, b) - self._spliced.get(slot, 0)
            for slot, (tl, b) in self._meta.items()
        )

    def prefix_probe(self, tokens) -> int:
        """Resident full prefix pages for a prompt (0 without the cache);
        read-only: no LRU touch, so capacity checks and router affinity
        probes never age the cache."""
        if self.prefix is None:
            return 0
        return self.prefix.probe(np.asarray(tokens, np.int32).reshape(-1))

    def _headroom(self) -> int:
        """Pages obtainable for growth right now: the free list plus every
        cache-only page eviction could reclaim on demand."""
        free = self.pool.free_pages
        if self.prefix is not None:
            free += self.prefix.reclaimable()
        return free

    def _make_room(self, n_pages: int) -> None:
        """Ensure ``n_pages`` are on the free list, evicting LRU cache-only
        pages if needed (their refcount drops to zero: truly orphaned)."""
        if self.prefix is not None and n_pages > self.pool.free_pages:
            self.prefix.make_room(n_pages - self.pool.free_pages)

    def _committed_growth(self) -> int:
        """Pages resident requests may still demand: lifetime bill minus the
        pages already in their tables (attached prefix pages count: they
        never need allocating again)."""
        return sum(
            max(self._lifetime_pages(tl, b) - len(self.pool.owned(slot)), 0)
            for slot, (tl, b) in self._meta.items()
        )

    def can_ever_admit(self, prompt_len: int, budget: int) -> bool:
        """Whether an empty instance of this worker could admit the request."""
        if self.pool is None:
            return True
        return self._lifetime_pages(prompt_len, budget) <= self.pool.n_pages

    def max_admissible(self, requests) -> int:
        """Largest prefix of ``requests`` ((tokens, budget) pairs) admissible
        right now: bounded by free slots and, in the paged layout, by pool
        capacity net of every resident request's remaining growth. Billing
        lifetimes means residents can always grow to their full budget, so
        a scheduler that admits through this never exhausts the pool
        mid-decode.

        With the prefix cache, capacity is free pages plus reclaimable cache
        pages, and each candidate still bills its full lifetime: a spliced
        admission takes ``lifetime - matched`` fresh pages but pins its
        ``matched`` pages (and a fully-covered prompt trades one splice for
        one CoW page), so the lifetime is the exact worst-case claim either
        way; the sharing shows in residents' committed growth."""
        n = min(len(requests), len(self.free_slots))
        if self.pool is None:
            return n
        free = self._headroom() - self._committed_growth()
        count = 0
        for tokens, budget in list(requests)[:n]:
            need = self._lifetime_pages(len(np.asarray(tokens).reshape(-1)), budget)
            if need > free:
                break
            free -= need
            count += 1
        return count

    def adopt(self, handoff: KVHandoff) -> List[int]:
        """Land one sealed burst on this worker's slots and pool. Atomic
        with respect to pool exhaustion: the whole burst's page bill is
        checked before a slot is popped or a page adopted."""
        n = handoff.n
        if n > len(self.free_slots):
            raise RuntimeError(f"{n} adoptions but only {len(self.free_slots)} free slots")
        if self.pool is not None:
            if handoff.n_alloc == 0:
                raise ValueError(
                    "dense handoff offered to a paged decode worker: the prefill and "
                    "decode halves of a pair must share kv_layout"
                )
            self._make_room(n * handoff.n_alloc)
            if n * handoff.n_alloc > self.pool.free_pages:
                raise RuntimeError(
                    f"KV pool cannot adopt this burst: its sealed prefills need "
                    f"{n * handoff.n_alloc} pages but only {self.pool.free_pages}/"
                    f"{self.pool.n_pages} are free (page_size={self.pool.page_size}). "
                    "Adopt fewer requests, raise --pool-pages, or lower --max-slots."
                )
        sealed, toks0 = handoff.sealed, handoff.first_tok
        if self.mesh is not None and handoff.source.mesh is not self.mesh:
            # cross-mesh transport: the burst was sealed on the prefill
            # worker's mesh (the reference replicates it onto this one)
            with obs.span("serve.handoff", replica=self.replica, n=n):
                sealed, toks0 = self._receive(handoff)
        elif toks0 is not None and toks0.device != self.device:
            # cross-device transport: the burst was sealed by a prefill worker
            # on another device (the meshless pair)
            with obs.span("serve.handoff", replica=self.replica, n=n):
                sealed = {k: v.to(self.device) for k, v in sealed.items()}
                toks0 = toks0.to(self.device)
        gslots = [self.free_slots.pop() for _ in range(n)]
        width = self.pool.pages_per_slot if self.pool is not None else 1
        table_rows = np.zeros((n, width), np.int32)
        page_ids = np.zeros((n, max(handoff.n_alloc, 1)), np.int64)
        for j, slot in enumerate(gslots):
            self._budget[slot] = int(handoff.budgets[j])
            self._left[slot] = self._budget[slot] - 1
            if self.pool is not None:
                page_ids[j] = self.pool.adopt(slot, handoff.n_alloc)
                table_rows[j] = self.pool.table_row(slot)
                self._meta[slot] = (int(handoff.true_lens[j]), int(handoff.budgets[j]))
                self._pos_est[slot] = int(handoff.true_lens[j])
                self._spliced[slot] = 0
                self._stale_slots.discard(slot)  # row fully rewritten
        self.stats["pages_allocated"] += n * max(handoff.n_alloc, 0)
        dev = self.device
        with obs.span("serve.adopt", replica=self.replica, n=n):
            self._adopt(
                sealed,
                toks0,
                torch.as_tensor(gslots, dtype=torch.long, device=dev),
                torch.as_tensor(handoff.true_lens, device=dev),
                torch.as_tensor(handoff.budgets, device=dev),
                torch.as_tensor(table_rows, device=dev),
                torch.as_tensor(page_ids, device=dev),
            )
        handoff.source.release(handoff)
        if self._spec is not None:
            self._spec.on_admit(gslots, np.asarray(handoff.tokens), [int(t) for t in handoff.true_lens])
        self.stats["admitted"] += n
        self.stats["handoffs"] += 1
        return gslots

    def _receive(self, handoff: KVHandoff):
        """The cross-mesh hop of a sealed burst. DTensor cannot redistribute
        from one mesh to another, so the prefill half makes the burst whole
        (a gather inside its mesh) and its first rank broadcasts the bytes
        of every leaf and the first tokens, in one collective over the
        ranks of both halves (``handoff_group``); each rank of this
        worker's mesh then keeps its shard by this worker's own specs
        (:func:`~repro_torch.sharding.shard_engine_state`), with no further
        communication. Returns ``(sealed, first tokens)`` there and
        ``(None, None)`` on every other rank."""
        import torch.distributed as dist

        src_ranks = mesh_ranks(handoff.source.mesh)
        rank = dist.get_rank()
        if rank not in src_ranks and not self.local:
            return None, None
        names = sorted(self._state.kv if handoff.sealed is None else handoff.sealed)
        if handoff.sealed is not None:  # a rank of the prefill half
            parts = [whole(handoff.sealed[k]) for k in names] + [handoff.first_tok]
            layout = [(t.shape, t.dtype) for t in parts]
            buf = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in parts])
        else:
            n, n_alloc = handoff.n, handoff.n_alloc
            layout = []
            for k in names:
                big = self._state.kv[k]  # (L, pages or slots, ...)
                rows = (n, n_alloc) if k in ("k_pages", "v_pages") else (n,)
                layout.append(((big.shape[0], *rows, *big.shape[2:]), big.dtype))
            layout.append(((n,), torch.int32))
            size = sum(math.prod(shape) * torch.empty((), dtype=dt).element_size() for shape, dt in layout)
            buf = torch.empty(size, dtype=torch.uint8, device=self.device)
        dist.broadcast(buf, src=src_ranks[0], group=self.handoff_group)
        if not self.local:
            return None, None
        parts, at = [], 0
        for shape, dt in layout:
            nbytes = math.prod(shape) * torch.empty((), dtype=dt).element_size()
            parts.append(buf[at : at + nbytes].clone().view(dt).reshape(shape))  # clone: aligned to dt
            at += nbytes
        sealed = dict(zip(names, parts[:-1]))
        sealed = shard_whole(sealed, shard_engine_state(sealed, mesh_axes=mesh_axes_of(self.mesh)), self.mesh)
        return sealed, parts[-1]

    def admit_spliced(self, tokens, budget: int) -> Optional[int]:
        """Hot-prefix admission: splice the longest resident radix run into
        a fresh slot's page table (``KVPool.attach``) and prefill only the
        uncovered tail. Returns the slot, or ``None`` when the cache holds no
        full page of this prompt (the caller takes the classic prefill).

        The spliced pages hold the KV a full prefill of the same prompt
        would write (same params, same positions), and the tail extend
        continues with prefill semantics, so greedy tokens match the cold
        admission. A prompt the cache covers entirely (tail length 0) must
        replay its last token to recover that token's logits; the replay
        writes one position of the final matched page, which others may
        share, so it always goes through copy-on-write."""
        if self.prefix is None:
            return None
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        true_len = len(tokens)
        pages = self.prefix.match(tokens)
        if not pages:
            return None
        if not self.free_slots:
            raise RuntimeError("spliced admission with no free slot")
        e, ps = self.ecfg, self.pool.page_size
        m = len(pages)
        r = true_len - m * ps  # uncovered tail tokens
        fresh = self.pool.required_pages(true_len) - m + (1 if r == 0 else 0)
        self._make_room(fresh)
        if fresh > self.pool.free_pages:
            raise RuntimeError(
                f"KV pool cannot admit this spliced request: its tail needs "
                f"{fresh} fresh pages but only {self.pool.free_pages}/"
                f"{self.pool.n_pages} are free (page_size={ps}). Drain a "
                "request, raise --pool-pages, or lower --max-slots."
            )
        slot = self.free_slots.pop()
        self.pool.attach(slot, pages)
        cow_src = cow_dst = self.pool.scratch_page  # a self-copy of the scratch page
        if r > 0:
            self.pool.alloc(slot, self.pool.required_pages(true_len))
            tb = min(-(-r // e.prefill_bucket) * e.prefill_bucket, e.max_seq)
            start, last_idx = m * ps, r - 1
            tail = np.zeros((1, tb), np.int32)
            tail[0, :r] = tokens[m * ps :]
        else:
            # fully-covered prompt: CoW the final matched page, then replay
            # the last prompt token into the private copy to recover its
            # logits (the cache stores KV, not logits)
            cow_src, cow_dst = self.pool.cow(slot, m - 1)
            if cow_src != cow_dst:
                self.stats["cow_copies"] += 1
            tb, start, last_idx = 1, true_len - 1, 0
            tail = tokens[None, -1:].copy()
        table_row = self.pool.table_row(slot)  # after the CoW: private ids only
        dev = self.device
        with obs.span("serve.splice", replica=self.replica, matched=m, tail=tb):
            self._splice(
                torch.as_tensor(tail, device=dev), slot, start, last_idx, budget, true_len,
                torch.as_tensor(table_row, device=dev),
                torch.as_tensor([cow_src], dtype=torch.long, device=dev),
                torch.as_tensor([cow_dst], dtype=torch.long, device=dev),
            )
        self._meta[slot] = (true_len, budget)
        self._pos_est[slot] = true_len
        self._budget[slot] = budget
        self._left[slot] = budget - 1
        self._spliced[slot] = m
        self._stale_slots.discard(slot)  # row fully rewritten by the splice
        if self._spec is not None:
            # the drafter shares no pages: it prefills the full prompt into
            # its own dense cache (cheap: the drafter is small by design)
            lb = bucket_len(self.cfg, e, true_len)
            padded = np.zeros((1, lb), np.int32)
            padded[0, :true_len] = tokens
            self._spec.on_admit([slot], padded, [true_len])
        self.stats["admitted"] += 1
        self.stats["prefix_hits"] += 1
        self.stats["spliced_admissions"] += 1
        self.stats["spliced_pages"] += m
        self.stats["prefill_tokens"] += tb
        self.stats["pages_allocated"] += fresh
        return slot

    def _ensure_chunk_pages(self) -> None:
        """Grow resident slots' page tables to cover the positions the next
        chunk can write, copy shared pages those writes would reach, and
        re-aim stale rows at the scratch page. The position estimate only
        moves down at sync, so back-to-back chunks without a sync stay safe
        (a page is appended at worst one chunk early, never late)."""
        # a speculative chunk's verify extend can write up to steps*(k+1)
        # positions (plus rejected-draft values the next verify overwrites;
        # writes past the planned coverage go to the scratch page)
        horizon = self._spec.horizon if self._spec is not None else self.ecfg.decode_chunk
        # phase 1 — plan, no mutation: exhaustion raises with the engine untouched
        growth: List[Tuple[int, int, int]] = []  # (slot, have, need)
        cows: List[Tuple[int, int]] = []  # (slot, page index) to copy-on-write
        total_new = 0
        ps = self.pool.page_size
        for slot, (true_len, budget) in self._meta.items():
            est = self._pos_est[slot]
            end = min(est + horizon, true_len + budget)
            need = self.pool.required_pages(end)
            owned = self.pool.owned(slot)
            if need > len(owned):
                growth.append((slot, len(owned), need))
                total_new += need - len(owned)
            # a write reaching a page another slot (or the prefix cache)
            # still references must copy first: sharing is read-only
            for idx in range(est // ps, min(-(-end // ps), len(owned))):
                if self.pool.refcount(owned[idx]) > 1:
                    cows.append((slot, idx))
                    total_new += 1
        self._make_room(total_new)
        if total_new > self.pool.free_pages:
            raise RuntimeError(
                f"KV pool exhausted mid-decode: growing {len(growth)} slot(s) for "
                f"the next chunk needs {total_new} pages but only "
                f"{self.pool.free_pages}/{self.pool.n_pages} are free "
                f"(page_size={self.pool.page_size}). Raise --pool-pages or admit "
                "fewer/shorter requests; the engine state is unchanged."
            )
        # phase 2 — commit: stale rows re-aimed and new pages mapped in one
        # table update; the stale set is cleared once the device table
        # carries the re-aim
        upd_rows: List[int] = []
        upd_cols: List[int] = []
        upd_vals: List[int] = []
        for slot in sorted(self._stale_slots):
            for k in range(self.pool.pages_per_slot):
                upd_rows.append(slot)
                upd_cols.append(k)
                upd_vals.append(self.pool.scratch_page)
            self.stats["table_resets"] += 1
        for slot, have, need in growth:
            pages = self.pool.alloc(slot, need)
            for k in range(have, need):
                upd_rows.append(slot)
                upd_cols.append(k)
                upd_vals.append(pages[k])
            self.stats["page_appends"] += need - have
            self.stats["pages_allocated"] += need - have
        cow_src: List[int] = []
        cow_dst: List[int] = []
        for slot, idx in cows:
            src, dst = self.pool.cow(slot, idx)
            if src == dst:
                continue  # became private since the plan (same-batch dedup)
            cow_src.append(src)
            cow_dst.append(dst)
            upd_rows.append(slot)
            upd_cols.append(idx)
            upd_vals.append(dst)
            self.stats["cow_copies"] += 1
            self.stats["pages_allocated"] += 1
        for slot, (true_len, budget) in self._meta.items():
            self._pos_est[slot] = min(self._pos_est[slot] + horizon, true_len + budget - 1)
        dev = self.device
        if upd_rows and self.local:
            self._state.page_table[
                torch.as_tensor(upd_rows, device=dev), torch.as_tensor(upd_cols, device=dev)
            ] = torch.as_tensor(upd_vals, dtype=torch.int32, device=dev)
        if cow_src:
            self._cow(torch.as_tensor(cow_src, device=dev), torch.as_tensor(cow_dst, device=dev))
        self._stale_slots.clear()

    def decode_chunk(self) -> None:
        """Up to ``decode_chunk`` batched decode steps (or, with speculative
        decoding, up to ``SpecDecoder.steps`` draft/verify rounds) with no
        host sync. Every active row emits at least one token a step or a
        round, so the largest remaining budget bounds both. The span
        brackets the enqueueing only."""
        with obs.span("serve.decode_chunk", replica=self.replica):
            if self.pool is not None:
                self._ensure_chunk_pages()
            limit = self._spec.steps if self._spec is not None else self.ecfg.decode_chunk
            steps = min(limit, max(self._left.values(), default=0))
            if self._spec is not None:
                self._spec.chunk(steps)
            else:
                self._chunk(steps)
        for slot in self._left:
            self._left[slot] = max(self._left[slot] - steps, 0)
        self.stats["decode_chunks"] += 1

    def head_len(self) -> int:
        """The length of :meth:`head`'s vector."""
        return 2 * self.ecfg.max_slots + (3 if self._spec is not None else 0)

    def head(self) -> torch.Tensor:
        """What the host reads of the slots every chunk, as one int32
        vector on the device: ``active``, ``n_out`` and the draft counters
        ``[proposed, accepted, steps]`` (speculative decoding). A fleet
        over several ranks shares one rank's copy
        (:class:`repro_torch.serve.scheduler.SharedHost`)."""
        s = self._state
        parts = [s.active.to(torch.int32), s.n_out]
        if self._spec is not None:
            parts.append(self._spec.counts)
        return torch.cat(parts)

    def read_head(self) -> np.ndarray:
        """:meth:`head` on the host, in one device-to-host transfer."""
        with obs.span("serve.sync", replica=self.replica):
            return self.head().cpu().numpy()

    def sync(self) -> Tuple[np.ndarray, np.ndarray]:
        """The once-per-chunk host sync: ``(active, n_out)`` as numpy
        (:meth:`advance` on this rank's :meth:`head`), holding the output
        rows of the slots that finished since the last sync on the host
        for :meth:`fetch`."""
        active, n_out = self.advance(self.read_head())
        if self.finishing:
            self.hold(self.rows().cpu().numpy())
        return active, n_out

    def advance(self, head: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Reconcile the host's position estimates and remaining budgets to
        a :meth:`head` read on the host (this rank's, or the one the
        fleet's ranks share); with speculative decoding the draft counters
        ride the same vector (cumulative since reset: assigned, not
        incremented). Lists the resident slots that finished since the
        last sync in ``finishing``, whose rows :meth:`hold` takes next.
        Returns ``(active, n_out)``."""
        n = self.ecfg.max_slots
        active, n_out = head[:n].astype(bool), head[n : 2 * n]
        if self._spec is not None:
            proposed, accepted, steps = (int(v) for v in head[2 * n : 2 * n + 3])
            self.stats["draft_proposed"] = proposed
            self.stats["draft_accepted"] = accepted
            self.stats["spec_steps"] = steps
        self.stats["host_syncs"] += 1
        for slot in self._left:
            self._left[slot] = self._budget[slot] - int(n_out[slot]) if active[slot] else 0
        if self.pool is not None:
            for slot, (true_len, _) in self._meta.items():
                self._pos_est[slot] = true_len + int(n_out[slot]) - 1
        self.finishing = [s for s in sorted(self._budget) if not active[s] and s not in self._held]
        return active, n_out

    def rows(self) -> torch.Tensor:
        """The output rows of the ``finishing`` slots, (n, max_new) int32
        on the device (finished rows stay frozen there)."""
        return self._state.out[torch.as_tensor(self.finishing, dtype=torch.long, device=self.device)]

    def hold(self, rows: np.ndarray) -> None:
        """Keep the ``finishing`` slots' output rows (:meth:`rows`, on the
        host) for :meth:`fetch`."""
        self._held.update(zip(self.finishing, rows))
        self.finishing = []

    def publish_gauges(self) -> None:
        """Push the pool and prefix-cache occupancy gauges into the stats
        registry, at snapshot/dump time (occupancy is a point-in-time
        value)."""
        if self.pool is None:
            return
        reg, labels = self.stats.registry, self.stats.labels
        reg.set_gauge(KV_GAUGES["free_pages"], self.pool.free_pages, **labels)
        reg.set_gauge(KV_GAUGES["pages_in_use"], self.pool.pages_in_use, **labels)
        reg.set_gauge(KV_GAUGES["capacity_pages"], self.pool.n_pages, **labels)
        if self.prefix is not None:
            reg.set_gauge(KV_GAUGES["reclaimable_pages"], self.prefix.reclaimable(), **labels)

    def fetch(self, slot: int, n_out: int) -> np.ndarray:
        """A slot's tokens, held on the host since the sync that found it
        finished (else read from the device), and free the slot (returning
        its orphaned pages to the pool in the paged layout; pages the
        prefix cache pins stay resident for later splices)."""
        row = self._held.pop(slot, None)
        if row is None:
            row = self._state.out[slot].cpu().numpy()
        # a copy: on the CPU .cpu() aliases the slot's row, which the next request reuses
        toks = row[:n_out].copy()
        self.free_slots.append(slot)
        self._left.pop(slot, None)
        self._budget.pop(slot, None)
        if self.pool is not None:
            self.pool.free_slot(slot)
            self._meta.pop(slot, None)
            self._pos_est.pop(slot, None)
            self._spliced.pop(slot, None)
            self._stale_slots.add(slot)
        self.stats["evicted"] += 1
        return toks


class ServeEngine:
    """One replica: a :class:`PrefillWorker` and a :class:`DecodeWorker`
    behind the engine API that :class:`repro_torch.serve.scheduler.FleetRouter`
    (and ``ContinuousScheduler``) drives from the request queue. ``drafter``
    is ``(cfg, params)`` of the speculative drafter (with ``ecfg.spec_k``).

    Colocated by default: both workers share ``params`` on their device
    (or, with ``mesh``, their shards on that mesh). A disaggregated pair
    (paged layout only) puts the prefill worker elsewhere, with its own
    copy of the parameters made here, once; each admission then hands its
    sealed pages across to the decode worker's pool:

    * ``prefill_mesh`` (the reference's; with ``mesh``): the prefill
      worker on another mesh, typically the other half of a replica's
      ranks (``launch.mesh.disagg_submeshes``). The burst crosses in one
      broadcast over the ranks of both meshes (:meth:`DecodeWorker._receive`).
    * ``prefill_device`` (meshless): the prefill worker on another device
      of this process.

    Either way admission runs the same programs. Every rank builds every
    replica (group creation is collective), but a rank runs only the
    device work of the meshes it is on; ``ranks`` are the ranks this
    replica spans (empty when meshless)."""

    def __init__(self, cfg, params, ecfg: EngineConfig, *, mesh=None, prefill_mesh=None, prefill_device=None,
                 drafter=None, registry: Optional[MetricsRegistry] = None, replica: int = 0):
        if cfg.is_encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: nothing to decode")
        if cfg.frontend == "vision":
            raise ValueError(
                f"{cfg.name} needs per-request vision prefix embeddings, which "
                "the slot engine does not thread through admission yet; serve "
                "vlm archs with the static batch path"
            )
        if prefill_mesh is not None and prefill_device is not None:
            raise ValueError(
                "prefill_mesh places the prefill worker on a mesh, prefill_device on a device "
                "of a meshless pair: give one"
            )
        if prefill_mesh is not None and mesh is None:
            raise ValueError("prefill_mesh needs the decode worker's mesh too (mesh=...)")
        if mesh is not None and prefill_device is not None:
            raise ValueError(
                "a sharded engine places its prefill worker with prefill_mesh, not prefill_device"
            )
        if prefill_mesh is mesh:
            prefill_mesh = None  # colocated on one mesh
        self.cfg = cfg
        self.ecfg = ecfg
        self.mesh = mesh
        self.layout = engine_layout(cfg, ecfg)
        self.replica = replica
        self.stats: StatsView = _fresh_stats(registry, replica)
        if prefill_mesh is not None or prefill_device is not None:
            if self.layout != "paged" and ecfg.kv_layout == "paged":
                raise ValueError(
                    f"{cfg.name} has no attention layers: its serving state degrades "
                    "to the dense layout, which has no page units to hand off — a "
                    "disaggregated prefill/decode pair is paged-only."
                )
            if self.layout != "paged":
                raise ValueError(
                    'a disaggregated pair (prefill_mesh or prefill_device) requires kv_layout="paged": '
                    "the prefill->decode handoff moves sealed KV PAGES between worker pools, and "
                    "the dense per-slot rectangle has no page units to hand off."
                )
        prefill_params = params
        if mesh is not None:
            # the reference's _shard_params: distributed whenever a mesh is
            # given, a 1x1 mesh included; each half of a pair on its own
            # mesh, and nothing on a rank outside a mesh (its worker runs
            # no device work)
            if prefill_mesh is not None and on_this_rank(prefill_mesh):
                prefill_params = shard_params(params, prefill_mesh)
            if on_this_rank(mesh):
                params = shard_params(params, mesh)
                if drafter is not None:
                    drafter = (drafter[0], shard_params(drafter[1], mesh))
            if prefill_mesh is None:
                prefill_params = params
        self.params = params
        if prefill_device is not None:
            dev = torch.device(prefill_device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            if dev != _device_of(params):
                prefill_params = tree_map(lambda t: t.to(dev), params)
        self.prefill = PrefillWorker(cfg, prefill_params, ecfg, stats=self.stats, replica=replica,
                                     mesh=mesh if prefill_mesh is None else prefill_mesh)
        self.decode = DecodeWorker(cfg, params, ecfg, stats=self.stats, drafter=drafter, replica=replica, mesh=mesh)
        # the ranks this replica spans; a pair on disjoint meshes hands off
        # over a group of both halves (made on every rank, in the same order)
        self.ranks = tuple(sorted(set(mesh_ranks(mesh)) | set(mesh_ranks(prefill_mesh))))
        if prefill_mesh is not None and (self.prefill.local or self.decode.local):
            self.decode.handoff_group = group_over(self.ranks)

    # -- delegation (the device state lives on the workers) -----------------

    @property
    def pool(self) -> Optional[KVPool]:
        return self.decode.pool

    @property
    def prefix(self):
        """The decode worker's radix prefix cache (None when disabled)."""
        return self.decode.prefix

    @property
    def spec(self):
        """The decode worker's :class:`SpecDecoder` (None when off)."""
        return self.decode._spec

    @property
    def free_slots(self) -> List[int]:
        return self.decode.free_slots

    @property
    def _state(self) -> DecodeState:
        return self.decode._state

    def reset(self) -> None:
        """(Re)build both workers' device state and zero the stats (so a
        warm-up run never contaminates timed counters)."""
        for k in list(self.stats):
            self.stats[k] = 0
        self.prefill.reset()
        self.decode.reset()

    def bucket_len(self, prompt_len: int) -> int:
        return bucket_len(self.cfg, self.ecfg, prompt_len)

    def request_load(self, prompt_len: int, budget: int) -> int:
        return self.decode.request_load(prompt_len, budget)

    def billed_pages(self) -> int:
        return self.decode.billed_pages()

    def can_ever_admit(self, prompt_len: int, budget: int) -> bool:
        return self.decode.can_ever_admit(prompt_len, budget)

    def max_admissible(self, requests) -> int:
        return self.decode.max_admissible(requests)

    def prefix_hit_pages(self, tokens) -> int:
        """Resident full prefix pages for a prompt (0 without the cache):
        the router's prefix-affinity signal. Read-only: never ages the LRU."""
        return self.decode.prefix_probe(tokens)

    def admit(self, tokens: np.ndarray, max_new_tokens: int) -> int:
        """Prefill one prompt (1-D int32) into a free slot; returns its id."""
        return self.admit_many([(tokens, max_new_tokens)])[0]

    def admit_many(self, requests) -> List[int]:
        """Admit several prompts; returns their slots, input-aligned.

        Prompts sharing a bucket length prefill together, split into
        power-of-two admission batches (4+2+1…); each batch is one prefill
        sealed into a KVHandoff and one adoption on the decode worker. With
        the prefix cache, a prompt with resident full pages is spliced
        instead (:meth:`DecodeWorker.admit_spliced`), and every admitted
        prompt's full pages are indexed afterwards. Admission is atomic with
        respect to pool exhaustion: the whole burst's page bill is checked
        first."""
        e = self.ecfg
        prepped = []
        for tokens, max_new_tokens in requests:
            tokens = np.asarray(tokens, np.int32).reshape(-1)
            if len(tokens) + max_new_tokens > e.max_seq:
                raise ValueError(f"prompt ({len(tokens)}) + budget ({max_new_tokens}) exceeds max_seq={e.max_seq}")
            if not 1 <= max_new_tokens <= e.max_new:
                raise ValueError(f"max_new_tokens must be in [1, {e.max_new}], got {max_new_tokens}")
            prepped.append((tokens, max_new_tokens))
        if len(prepped) > len(self.free_slots):
            raise RuntimeError(f"{len(prepped)} admissions but only {len(self.free_slots)} free slots")
        prefix = self.decode.prefix
        # probe (read-only) before any admission: duplicates within a burst
        # do not share with each other — sharing starts on the next tick,
        # once the first copy's pages are indexed below
        hot = set()
        if prefix is not None:
            hot = {i for i, (tokens, _) in enumerate(prepped) if self.decode.prefix_probe(tokens) > 0}
        if self.pool is not None:
            # hot requests bill only their uncovered tail (+1 for the
            # fully-covered replay's CoW page): evicting a matched page to
            # make room frees exactly the page its splice would have saved
            ps = self.pool.page_size
            need = 0
            for i, (tokens, _) in enumerate(prepped):
                if i in hot:
                    m = self.decode.prefix_probe(tokens)
                    r = len(tokens) - m * ps
                    need += self.pool.required_pages(len(tokens)) - m + (1 if r == 0 else 0)
                else:
                    need += self.pool.required_pages(self.bucket_len(len(tokens)))
            self.decode._make_room(need)
            if need > self.pool.free_pages:
                raise RuntimeError(
                    f"KV pool cannot admit this burst: its bucketed prefills need "
                    f"{need} pages but only {self.pool.free_pages}/{self.pool.n_pages} "
                    f"are free (page_size={self.pool.page_size}). Admit fewer "
                    "requests, raise --pool-pages, or lower --max-slots."
                )
        slots = [0] * len(prepped)
        cold: List[int] = []
        for i in range(len(prepped)):
            slot = self.decode.admit_spliced(*prepped[i]) if i in hot else None
            if slot is None:  # no hot prefix, or its match was evicted since the probe
                cold.append(i)
            else:
                slots[i] = slot
        by_bucket: Dict[int, List[int]] = {}
        for i in cold:
            by_bucket.setdefault(self.bucket_len(len(prepped[i][0])), []).append(i)
        for idxs in by_bucket.values():
            while idxs:
                n = 1 << (len(idxs).bit_length() - 1)  # largest pow2 <= len
                group, idxs = idxs[:n], idxs[n:]
                handoff = self.prefill.prefill_group([prepped[i] for i in group])
                for j, slot in zip(group, self.decode.adopt(handoff)):
                    slots[j] = slot
        if prefix is not None:
            # index every admitted prompt's full pages: spliced prompts map
            # their chunks to the very pages they attached, so only fresh
            # tails add nodes; the next burst with these prefixes splices
            for i, (tokens, _) in enumerate(prepped):
                prefix.insert(tokens, self.pool.owned(slots[i]))
        return slots

    def warmup(self, prompt: np.ndarray, budget: int = 2) -> None:
        """Run every admission size a serving run can hit — one per power of
        two up to ``max_slots`` for ``prompt``'s bucket — and a decode chunk
        each (and, with the prefix cache, both splice paths), then reset:
        the first timed burst then finds the kernels built and the
        allocator warm."""
        budget = min(budget, self.ecfg.max_new)
        n = 1
        while n <= self.ecfg.max_slots:
            self.reset()
            reqs = [(prompt, budget)] * n
            if self.max_admissible(reqs) < n:
                break  # a tight pool caps the burst; larger sizes can't fit either
            self.admit_many(reqs)
            self.decode_chunk()
            self._warm_sync()
            n *= 2
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if (
            self.decode.prefix is not None
            and len(prompt) >= self.ecfg.page_size
            and self.ecfg.max_slots >= 2
            and len(prompt) + 1 + budget <= self.ecfg.max_seq
        ):
            # both splice paths: admit cold (seeds the cache), then re-admit
            # the same prompt (fully-covered replay, tail of 1) and a
            # one-token-longer prompt (tail extend, one prefill bucket)
            self.reset()
            self.admit(prompt, budget)
            if self.max_admissible([(prompt, budget)]) >= 1:
                self.admit(prompt, budget)
            longer = np.concatenate([prompt, prompt[-1:]])
            if self.max_admissible([(longer, budget)]) >= 1:
                self.admit(longer, budget)
            self.decode_chunk()
            self._warm_sync()
        self.reset()

    def _warm_sync(self) -> None:
        # the warm-up's syncs read the decode worker's own device (its ranks
        # hold the slots replicated); another rank has nothing to read, and
        # the reset after the warm-up drops its host state either way
        if self.decode.local:
            self.sync()

    def decode_chunk(self) -> None:
        self.decode.decode_chunk()

    def sync(self):
        return self.decode.sync()

    def fetch(self, slot: int, n_out: int) -> np.ndarray:
        return self.decode.fetch(slot, n_out)

    def publish_gauges(self) -> None:
        """Push the pool and prefix-cache occupancy gauges into the stats registry."""
        self.decode.publish_gauges()
