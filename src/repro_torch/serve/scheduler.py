"""Request routing and scheduling for serving (the port's copy of
``repro.serve.scheduler``, host code).

A :class:`FleetRouter` over N engine replicas (each a
:class:`repro_torch.serve.engine.ServeEngine`):

* requests become visible at their ``arrival`` time on a ``Clock`` (real
  monotonic time when serving, a :class:`ManualClock` in tests that only
  advances when the loop sleeps, keeping admission order deterministic)
  and are routed to the least-loaded replica: load is the billed lifetime
  page count of everything resident plus everything queued there (slot
  counts in the dense layout), queue depth breaking ties;
* per replica, queued prompts are admitted into free slots in bursts,
  interleaved with decode chunks over everything resident;
* a queue head its replica cannot admit right now may requeue to an idle
  replica that can (requeue-on-defer);
* after each chunk one host sync per replica reads the per-slot status;
  finished sequences are drained and their slots are refillable at once.

``ContinuousScheduler`` is the N=1 router. Completions record
``arrival``, ``admitted``, ``first_token`` and ``finished`` separately, so
queue wait and TTFT can be read apart from decode time.

Telemetry (:mod:`repro_torch.obs`): the router's stats are a
:class:`~repro_torch.obs.StatsView` over the ``serve.router.*`` names
(:data:`repro_torch.obs.ROUTER_METRICS`), in the engines' registry, so
router and engine series land in one snapshot; ``affinity_hits`` stays 0
until the prefix cache is ported. Each completion observes
``serve.request.{latency,queue_wait,ttft}_s`` under its replica label;
routing is an ``obs.instant("serve.route")`` and each admission burst a
``serve.admit`` span.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.obs import ROUTER_METRICS, MetricsRegistry, StatsView
from repro_torch.serve.engine import ServeEngine


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # (L,) int32 prompt
    max_new_tokens: int
    arrival: float = 0.0  # seconds since scheduler start


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: np.ndarray  # (n,) int32 generated tokens (incl. first)
    arrival: float
    admitted: float  # when the admitting prefill dispatch began (not arrival!)
    finished: float
    replica: int = 0  # which fleet replica served it
    first_token: Optional[float] = None  # when the first token existed (TTFT)

    @property
    def latency(self) -> float:
        """End-to-end: arrival -> finished (queue wait + service)."""
        return self.finished - self.arrival

    @property
    def queue_wait(self) -> float:
        """Time spent queued/deferred before the admitting prefill ran —
        the router-attributable share of latency."""
        return self.admitted - self.arrival

    @property
    def service(self) -> float:
        """Time spent resident on a replica: admission -> finished."""
        return self.finished - self.admitted

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token: arrival -> the admitting prefill's return
        (every admission path samples the first token inside that dispatch).
        None on hand-built completions that never recorded the stamp."""
        if self.first_token is None:
            return None
        return self.first_token - self.arrival


class MonotonicClock:
    """Real wall-clock: origin at construction."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class ManualClock:
    """Deterministic test clock: time moves only via sleep()/advance(), plus
    an optional fixed ``tick`` per now() call — the tick stands in for decode
    wall time, so staggered arrivals become visible MID-decode and the
    admit-into-freed-slot path gets exercised deterministically."""

    def __init__(self, tick: float = 0.0):
        self._t = 0.0
        self._tick = tick

    def now(self) -> float:
        self._t += self._tick
        return self._t

    def sleep(self, dt: float) -> None:
        self._t += max(dt, 0.0)

    advance = sleep


class FleetRouter:
    """Least-loaded admission + eviction loop over N engine replicas;
    returns one Completion per request (tagged with its replica)."""

    def __init__(self, engines: Sequence[ServeEngine], clock=None, registry: Optional[MetricsRegistry] = None):
        if not engines:
            raise ValueError("FleetRouter needs at least one engine replica")
        self.engines: List[ServeEngine] = list(engines)
        self.clock = clock
        if registry is None:
            # the replicas' registry, so router and engine series land in one
            # snapshot; engines whose stats are no view give the router its own
            st = self.engines[0].stats
            registry = st.registry if isinstance(st, StatsView) else MetricsRegistry()
        self.registry = registry
        self.stats: StatsView = registry.view(ROUTER_METRICS)

    # -- routing policy -----------------------------------------------------

    def _bill(self, eng: ServeEngine, req: Request) -> int:
        return eng.request_load(len(req.tokens), req.max_new_tokens)

    def _load(self, i: int, queues: List[deque]) -> Tuple[int, int, int]:
        """A replica's admission-load key: billed lifetime pages of
        everything resident AND everything already queued there (queued
        work is committed load — ignoring it would shotgun a burst of
        arrivals onto whichever replica drained most recently), queue
        depth breaking page ties, replica index making the order total."""
        eng = self.engines[i]
        q = queues[i]
        return (
            eng.billed_pages() + sum(self._bill(eng, r) for r in q),
            len(q),
            i,
        )

    def _route(self, req: Request, queues: List[deque]) -> int:
        """Least-loaded replica among those that could ever admit the
        request (an empty pool fits its lifetime bill). The reference leads
        this key with prefix-cache affinity; the port has no prefix cache
        yet."""
        feasible = [
            i
            for i, eng in enumerate(self.engines)
            if eng.can_ever_admit(len(req.tokens), req.max_new_tokens)
        ]
        if not feasible:
            raise RuntimeError(
                f"request rid={req.rid} (prompt {len(req.tokens)} tokens, "
                f"budget {req.max_new_tokens}) can never be admitted: its "
                "lifetime page bill outruns the EMPTY KV pool on every "
                "replica, so no amount of draining frees enough pages. Raise "
                "--pool-pages or shrink the prompt/budget."
            )
        self.stats["routed"] += 1
        best = min(feasible, key=lambda i: self._load(i, queues))
        obs.instant("serve.route", rid=req.rid, replica=best, prefix_hits=0)
        return best

    # -- the serving loop ---------------------------------------------------

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        clock = self.clock or MonotonicClock()
        for eng in self.engines:
            eng.reset()
        for k in list(self.stats):
            self.stats[k] = 0
        pending = deque(sorted(requests, key=lambda r: r.arrival))
        queues: List[deque] = [deque() for _ in self.engines]
        # per replica: slot -> (request, admitted_time, first_token_time)
        resident: List[dict] = [{} for _ in self.engines]
        done: List[Completion] = []

        def _admit(i: int, burst: List[Request]) -> None:
            # admitted is stamped BEFORE the prefill dispatch and first_token
            # AFTER it: the dispatch samples every admitted sequence's first
            # token, so the gap between the two stamps is prefill service —
            # part of TTFT but not of queue wait.
            t_admit = clock.now()
            with obs.span("serve.admit", replica=i, n=len(burst)):
                slots = self.engines[i].admit_many(
                    [(r.tokens, r.max_new_tokens) for r in burst]
                )
            t_first = clock.now()
            for slot, req in zip(slots, burst):
                resident[i][slot] = (req, t_admit, t_first)

        while pending or any(queues) or any(resident):
            now = clock.now()
            while pending and pending[0].arrival <= now:
                req = pending.popleft()
                queues[self._route(req, queues)].append(req)

            # per-replica burst admission: bounded by free slots AND (paged
            # layout) by free KV pages — excess requests stay queued and
            # admit when a drain returns capacity, instead of crashing
            for i, eng in enumerate(self.engines):
                if queues[i] and eng.free_slots:
                    n = eng.max_admissible(
                        [(r.tokens, r.max_new_tokens) for r in queues[i]]
                    )
                    if n:
                        _admit(i, [queues[i].popleft() for _ in range(n)])

            # requeue-on-defer: arrival-time routing goes stale as pages
            # drain — a queue head blocked on ITS replica moves to an IDLE
            # (empty-queue) replica that can admit it immediately. Only the
            # head moves (later entries would jump the arrival order) and
            # only to empty queues (a requeued request must admit now, not
            # trade one wait for another).
            for i, eng in enumerate(self.engines):
                if not queues[i]:
                    continue
                head = queues[i][0]
                pair = [(head.tokens, head.max_new_tokens)]
                if eng.max_admissible(pair):
                    continue  # admits here next tick; no defer to fix
                targets = [
                    j
                    for j, other in enumerate(self.engines)
                    if j != i and not queues[j] and other.max_admissible(pair)
                ]
                if targets:
                    j = min(targets, key=lambda j: self._load(j, queues))
                    queues[i].popleft()
                    _admit(j, [head])
                    self.stats["requeued"] += 1

            if any(resident):
                for i, eng in enumerate(self.engines):
                    if not resident[i]:
                        continue
                    eng.decode_chunk()
                    active, n_out = eng.sync()
                    t_done = clock.now()
                    for slot in [s for s in resident[i] if not active[s]]:
                        req, t_admit, t_first = resident[i].pop(slot)
                        toks = eng.fetch(slot, int(n_out[slot]))
                        comp = Completion(
                            rid=req.rid,
                            prompt_len=len(req.tokens),
                            tokens=toks,
                            arrival=req.arrival,
                            admitted=t_admit,
                            finished=t_done,
                            replica=i,
                            first_token=t_first,
                        )
                        self.registry.observe("serve.request.latency_s", comp.latency, replica=i)
                        self.registry.observe("serve.request.queue_wait_s", comp.queue_wait, replica=i)
                        self.registry.observe("serve.request.ttft_s", comp.ttft, replica=i)
                        done.append(comp)
            elif pending and not any(queues):
                clock.sleep(pending[0].arrival - now)
        return sorted(done, key=lambda c: c.rid)


class ContinuousScheduler(FleetRouter):
    """The N=1 fleet: one engine, no routing choice — the single-engine
    scheduler earlier revisions had, preserved as the parity oracle the
    fleet tests compare against."""

    def __init__(self, engine: ServeEngine, clock=None):
        super().__init__([engine], clock)
        self.engine = engine
