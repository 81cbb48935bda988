"""Serving engine for the distilled server LM (the port's copy of
``repro.serve.engine``): a prefill/decode worker pair composed into the
colocated :class:`ServeEngine`.

* :class:`PrefillWorker` — admission: prefills a bucketed burst of prompts
  in one batch (padded to a ``prefill_bucket`` multiple; the pad tail is
  never attended because decode overwrites position ``p`` before reading
  it), samples each row's first token from its true last prompt position,
  and seals the result into a :class:`KVHandoff`: the attention KV re-viewed
  as page units ``(L, N, n_alloc, page, KH, hd)`` (paged layout) or the
  dense rows. A staging :class:`~repro_torch.serve.kv_pool.KVPool` accounts
  the in-flight handoff pages.
* :class:`DecodeWorker` — owns the device-resident per-slot
  :class:`DecodeState` (each request lives in one of ``max_slots`` slots
  with its own position), ``adopt``s handoffs (pool ids from its pool, the
  sealed pages copied into its buffers: data movement, no model forward)
  and runs decode chunks with on-device sampling. The host reads back only
  the ``(active, n_out)`` vectors once per chunk (``sync``) and a finished
  request's tokens once at eviction (``fetch``).

The reference runs a chunk as one ``lax.while_loop`` dispatch. Here a
chunk is a Python loop of device ops that never reads the device: finished
rows stay frozen on the device, and the host bounds the loop by the largest
remaining budget it knows from the last sync (the step at which the
reference's loop condition would stop, when no EOS token is set), so there
is still one host sync per chunk.

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
``serve.adopt``, ``serve.decode_chunk``, ``serve.sync``) bracket the hot
path's actions and never force a device sync. Disaggregated fleets, the
prefix cache and speculative decoding are not ported yet and raise; their
counters stay 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models.transformer import init_lm_state, lm_decode, lm_prefill
from repro_torch.obs import KV_GAUGES, SERVE_ENGINE_METRICS, MetricsRegistry, StatsView
from repro_torch.serve.kv_pool import KVPool

KV_LAYOUTS = ("paged", "dense")


def sample_tokens(logits: torch.Tensor, gen: Optional[torch.Generator], temperature: float) -> torch.Tensor:
    """On-device sampling. logits: (B, V) -> (B,) int32. ``temperature <= 0``
    is greedy (argmax, first index on ties); otherwise temperature-scaled
    categorical from ``gen``."""
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
    disagg: bool = False  # not ported yet
    prefix_cache: bool = False  # not ported yet
    spec_k: int = 0  # not ported yet

    def __post_init__(self):
        for field in ("max_slots", "max_seq", "max_new", "decode_chunk", "prefill_bucket"):
            if getattr(self, field) < 1:
                raise ValueError(f"EngineConfig.{field} must be >= 1, got {getattr(self, field)}")
        if self.kv_layout not in KV_LAYOUTS:
            raise ValueError(f"EngineConfig.kv_layout must be one of {KV_LAYOUTS}, got {self.kv_layout!r}")
        if self.spec_k < 0:
            raise ValueError(f"EngineConfig.spec_k must be >= 0, got {self.spec_k}")
        for field, on in (("disagg", self.disagg), ("prefix_cache", self.prefix_cache), ("spec_k", self.spec_k > 0)):
            if on:
                raise NotImplementedError(f"EngineConfig.{field}: not ported yet")
        if self.kv_layout != "paged":
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

    sealed: Dict[str, torch.Tensor]  # paged: (L, N, n_alloc, page, KH, hd); dense: (L, N, cl, KH, hd)
    first_tok: torch.Tensor  # (N,) int32 — first sampled token per row
    true_lens: np.ndarray  # (N,) host — true prompt lengths
    budgets: np.ndarray  # (N,) host — generation budgets
    n_alloc: int  # sealed pages per row (0 for the dense layout)
    staging_id: int  # staging-pool reservation on the source (-1 when none)
    source: Any  # the PrefillWorker that sealed this burst

    @property
    def n(self) -> int:
        return len(self.true_lens)


def bucket_len(cfg, ecfg: EngineConfig, prompt_len: int) -> int:
    """The padded prefill length of a prompt."""
    b = ecfg.prefill_bucket
    lb = min(-(-prompt_len // b) * b, ecfg.max_seq)
    if cfg.sliding_window > 0:
        # the SWA cache is a ring of min(window, max_seq) slots holding the
        # LAST cache-len prefill positions; padding past the ring length
        # would evict real prompt tokens in favour of pad garbage.
        cl = min(cfg.sliding_window, ecfg.max_seq)
        lb = prompt_len if prompt_len > cl else min(lb, cl)
    return lb


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
                 registry: Optional[MetricsRegistry] = None, replica: int = 0):
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.device = _device_of(params)
        self.layout = ecfg.kv_layout
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

    @torch.inference_mode()
    def _prefill(self, tokens: torch.Tensor, true_lens: torch.Tensor):
        """Prefill N prompts, sample their first tokens, seal the KV."""
        cfg, e = self.cfg, self.ecfg
        n = tokens.shape[0]
        st1 = init_lm_state(cfg, n, e.max_seq, device=self.device)
        logits, st1 = lm_prefill(self.params, cfg, {"tokens": tokens}, st1, last_index=true_lens - 1)
        toks0 = sample_tokens(logits[:, 0], self._gen, e.temperature)  # (N,)
        if self.layout != "paged":
            return st1, toks0
        ps = self.staging.page_size
        n_alloc = self.staging.required_pages(tokens.shape[1])
        sealed = {}
        for pages_name, dense_name in (("k_pages", "k"), ("v_pages", "v")):
            one = st1[dense_name]  # (L, N, cl, KH, hd)
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
            sealed, toks0 = self._prefill(
                torch.as_tensor(padded, device=self.device), torch.as_tensor(lens, device=self.device)
            )
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += n * lb
        return KVHandoff(
            sealed=sealed, first_tok=toks0, true_lens=lens, budgets=buds,
            n_alloc=n_alloc, staging_id=staging_id, source=self,
        )

    def release(self, handoff: KVHandoff) -> None:
        """Donate a handoff's staging reservation back (the adopting worker
        has copied the sealed pages)."""
        if self.staging is not None and handoff.staging_id >= 0:
            self.staging.donate(handoff.staging_id)


class DecodeWorker:
    """Decode half of the serving pair: owns the slots, the KV pool and the
    chunked decode loop; ingests sealed prefills through ``adopt``."""

    def __init__(self, cfg, params, ecfg: EngineConfig, *, stats: Optional[StatsView] = None,
                 registry: Optional[MetricsRegistry] = None, replica: int = 0):
        self.cfg = cfg
        self.ecfg = ecfg
        self.params = params
        self.device = _device_of(params)
        self.layout = ecfg.kv_layout
        self.replica = replica
        self.pool: Optional[KVPool] = KVPool(cfg, ecfg) if self.layout == "paged" else None
        self.stats = stats if stats is not None else _fresh_stats(registry, replica)
        self.reset()

    # -- device programs ----------------------------------------------------

    @torch.inference_mode()
    def _adopt(self, sealed, toks0, slots, true_lens, budgets, table_rows, page_ids) -> None:
        """Ingest one sealed burst: data movement only. Paged: the sealed
        page units land in this worker's pool at the ids its pool assigned
        (one copy per leaf for the whole burst; ids are disjoint across
        rows). Dense: the rows land on their slots."""
        ds = self._state
        if self.layout == "paged":
            for name in ("k_pages", "v_pages"):
                big = ds.kv[name]  # (L, P, ps, KH, hd)
                big[:, page_ids] = sealed[name].to(big.dtype)
            ds.page_table[slots] = table_rows
        else:
            for name in ("k", "v"):
                ds.kv[name][:, slots] = sealed[name].to(ds.kv[name].dtype)
        ds.last_tok[slots, 0] = toks0
        ds.pos[slots] = true_lens
        ds.active[slots] = budgets > 1
        ds.out[slots] = 0
        ds.out[slots, 0] = toks0
        ds.n_out[slots] = 1
        ds.budget[slots] = budgets

    @torch.inference_mode()
    def _chunk(self, steps: int) -> None:
        """``steps`` batched decode steps, on the device only: no value is
        read back, so the host never waits inside a chunk."""
        cfg, e, s = self.cfg, self.ecfg, self._state
        rows = torch.arange(e.max_slots, device=self.device)
        paged = self.layout == "paged"
        for _ in range(steps):
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
        # evicted slots whose table rows still point at returned pages; their
        # ride-along writes must be re-aimed at the scratch page before the
        # next chunk (unless adoption rewrites the row first)
        self._stale_slots: set = set()
        self._gen = torch.Generator(device=dev).manual_seed(e.seed)
        if self.pool is not None:
            self.pool.reset()
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
            kv=kv,
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
        (paged) or the resident count (dense)."""
        if self.pool is None:
            return self.ecfg.max_slots - len(self.free_slots)
        return sum(self._lifetime_pages(tl, b) for tl, b in self._meta.values())

    def _committed_growth(self) -> int:
        """Pages resident requests may still demand: lifetime bill minus the
        pages already in their tables."""
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
        mid-decode."""
        n = min(len(requests), len(self.free_slots))
        if self.pool is None:
            return n
        free = self.pool.free_pages - self._committed_growth()
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
            if n * handoff.n_alloc > self.pool.free_pages:
                raise RuntimeError(
                    f"KV pool cannot adopt this burst: its sealed prefills need "
                    f"{n * handoff.n_alloc} pages but only {self.pool.free_pages}/"
                    f"{self.pool.n_pages} are free (page_size={self.pool.page_size}). "
                    "Adopt fewer requests, raise --pool-pages, or lower --max-slots."
                )
        sealed, toks0 = handoff.sealed, handoff.first_tok
        if toks0.device != self.device:
            # cross-device transport: the burst was sealed by a prefill worker
            # on another device (the reference's cross-mesh replicate)
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
        self.stats["admitted"] += n
        self.stats["handoffs"] += 1
        return gslots

    def _ensure_chunk_pages(self) -> None:
        """Grow resident slots' page tables to cover the positions the next
        chunk can write, and re-aim stale rows at the scratch page. The
        position estimate only moves down at sync, so back-to-back chunks
        without a sync stay safe (a page is appended at worst one chunk
        early, never late)."""
        horizon = self.ecfg.decode_chunk
        # phase 1 — plan, no mutation: exhaustion raises with the engine untouched
        growth: List[Tuple[int, int, int]] = []  # (slot, have, need)
        total_new = 0
        for slot, (true_len, budget) in self._meta.items():
            end = min(self._pos_est[slot] + horizon, true_len + budget)
            need = self.pool.required_pages(end)
            have = len(self.pool.owned(slot))
            if need > have:
                growth.append((slot, have, need))
                total_new += need - have
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
        for slot, (true_len, budget) in self._meta.items():
            self._pos_est[slot] = min(self._pos_est[slot] + horizon, true_len + budget - 1)
        if upd_rows:
            dev = self.device
            self._state.page_table[
                torch.as_tensor(upd_rows, device=dev), torch.as_tensor(upd_cols, device=dev)
            ] = torch.as_tensor(upd_vals, dtype=torch.int32, device=dev)
        self._stale_slots.clear()

    def decode_chunk(self) -> None:
        """Up to ``decode_chunk`` batched decode steps with no host sync. The
        span brackets the steps' enqueueing only."""
        with obs.span("serve.decode_chunk", replica=self.replica):
            if self.pool is not None:
                self._ensure_chunk_pages()
            steps = min(self.ecfg.decode_chunk, max(self._left.values(), default=0))
            self._chunk(steps)
        for slot in self._left:
            self._left[slot] = max(self._left[slot] - steps, 0)
        self.stats["decode_chunks"] += 1

    def sync(self) -> Tuple[np.ndarray, np.ndarray]:
        """The once-per-chunk host sync: ``(active, n_out)`` as numpy, in one
        device-to-host transfer. Reconciles the host's position estimates
        and remaining budgets to the truth."""
        with obs.span("serve.sync", replica=self.replica):
            both = torch.stack([self._state.active.to(torch.int32), self._state.n_out]).cpu().numpy()
        active, n_out = both[0].astype(bool), both[1]
        self.stats["host_syncs"] += 1
        for slot in self._left:
            self._left[slot] = self._budget[slot] - int(n_out[slot]) if active[slot] else 0
        if self.pool is not None:
            for slot, (true_len, _) in self._meta.items():
                self._pos_est[slot] = true_len + int(n_out[slot]) - 1
        return active, n_out

    def publish_gauges(self) -> None:
        """Push the pool occupancy gauges into the stats registry, at
        snapshot/dump time (occupancy is a point-in-time value)."""
        if self.pool is None:
            return
        reg, labels = self.stats.registry, self.stats.labels
        reg.set_gauge(KV_GAUGES["free_pages"], self.pool.free_pages, **labels)
        reg.set_gauge(KV_GAUGES["pages_in_use"], self.pool.pages_in_use, **labels)
        reg.set_gauge(KV_GAUGES["capacity_pages"], self.pool.n_pages, **labels)

    def fetch(self, slot: int, n_out: int) -> np.ndarray:
        """Copy a finished slot's tokens to the host and free the slot
        (returning its pages to the pool in the paged layout)."""
        # a copy: on the CPU .cpu() would alias the slot's row, which the next request reuses
        toks = self._state.out[slot, :n_out].to("cpu", copy=True).numpy()
        self.free_slots.append(slot)
        self._left.pop(slot, None)
        self._budget.pop(slot, None)
        if self.pool is not None:
            self.pool.free_slot(slot)
            self._meta.pop(slot, None)
            self._pos_est.pop(slot, None)
            self._stale_slots.add(slot)
        self.stats["evicted"] += 1
        return toks


class ServeEngine:
    """One replica: a :class:`PrefillWorker` and a :class:`DecodeWorker`
    behind the engine API that :class:`repro_torch.serve.scheduler.FleetRouter`
    (and ``ContinuousScheduler``) drives from the request queue."""

    def __init__(self, cfg, params, ecfg: EngineConfig, *, registry: Optional[MetricsRegistry] = None,
                 replica: int = 0):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.layout = ecfg.kv_layout
        self.replica = replica
        self.stats: StatsView = _fresh_stats(registry, replica)
        self.prefill = PrefillWorker(cfg, params, ecfg, stats=self.stats, replica=replica)
        self.decode = DecodeWorker(cfg, params, ecfg, stats=self.stats, replica=replica)

    # -- delegation (the device state lives on the workers) -----------------

    @property
    def pool(self) -> Optional[KVPool]:
        return self.decode.pool

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

    def admit(self, tokens: np.ndarray, max_new_tokens: int) -> int:
        """Prefill one prompt (1-D int32) into a free slot; returns its id."""
        return self.admit_many([(tokens, max_new_tokens)])[0]

    def admit_many(self, requests) -> List[int]:
        """Admit several prompts; returns their slots, input-aligned.

        Prompts sharing a bucket length prefill together, split into
        power-of-two admission batches (4+2+1…); each batch is one prefill
        sealed into a KVHandoff and one adoption on the decode worker.
        Admission is atomic with respect to pool exhaustion: the whole
        burst's page bill is checked first."""
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
        if self.pool is not None:
            need = sum(self.pool.required_pages(self.bucket_len(len(t))) for t, _ in prepped)
            if need > self.pool.free_pages:
                raise RuntimeError(
                    f"KV pool cannot admit this burst: its bucketed prefills need "
                    f"{need} pages but only {self.pool.free_pages}/{self.pool.n_pages} "
                    f"are free (page_size={self.pool.page_size}). Admit fewer "
                    "requests, raise --pool-pages, or lower --max-slots."
                )
        slots = [0] * len(prepped)
        by_bucket: Dict[int, List[int]] = {}
        for i, (tokens, _) in enumerate(prepped):
            by_bucket.setdefault(self.bucket_len(len(tokens)), []).append(i)
        for idxs in by_bucket.values():
            while idxs:
                n = 1 << (len(idxs).bit_length() - 1)  # largest pow2 <= len
                group, idxs = idxs[:n], idxs[n:]
                handoff = self.prefill.prefill_group([prepped[i] for i in group])
                for j, slot in zip(group, self.decode.adopt(handoff)):
                    slots[j] = slot
        return slots

    def warmup(self, prompt: np.ndarray, budget: int = 2) -> None:
        """Run every admission size a serving run can hit — one per power of
        two up to ``max_slots`` for ``prompt``'s bucket — and a decode chunk
        each, then reset: the first timed burst then finds the kernels
        built and the allocator warm."""
        budget = min(budget, self.ecfg.max_new)
        n = 1
        while n <= self.ecfg.max_slots:
            self.reset()
            reqs = [(prompt, budget)] * n
            if self.max_admissible(reqs) < n:
                break  # a tight pool caps the burst; larger sizes can't fit either
            self.admit_many(reqs)
            self.decode_chunk()
            self.sync()
            n *= 2
        self.reset()

    def decode_chunk(self) -> None:
        self.decode.decode_chunk()

    def sync(self):
        return self.decode.sync()

    def fetch(self, slot: int, n_out: int) -> np.ndarray:
        return self.decode.fetch(slot, n_out)

    def publish_gauges(self) -> None:
        """Push the pool occupancy gauges into the stats registry."""
        self.decode.publish_gauges()
