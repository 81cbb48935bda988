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

On several ranks (engines on meshes, one process a rank) there is no
single controller: every rank the fleet spans runs this same loop, and
every rank must take the same routing, admission, requeue and drain
decisions in the same order, since each decision launches collectives on
some replica's mesh. The decisions read the engines' host state, the
clock and the readbacks, so the last two are shared (:class:`SharedHost`):
each tick takes the first rank's reading of the clock (one broadcast; a
:class:`ManualClock` advances the same everywhere and is read as is), and
after the tick's decode chunks every replica's head (``active``,
``n_out``, the draft counters) comes from the first rank of its decode
mesh, all replicas in one all-reduce; on a tick where slots finish, their
output rows follow in one more. A rank outside a
replica's mesh advances its host state from those readbacks alone. The
admission and completion stamps are each rank's own clock readings (equal
under a :class:`ManualClock`); no decision reads them. A collective that
fails raises, on every rank. One rank (a meshless fleet, a world of one,
or one engine on a mesh of one) issues no collective.

Telemetry (:mod:`repro_torch.obs`): the router's stats are a
:class:`~repro_torch.obs.StatsView` over the ``serve.router.*`` names
(:data:`repro_torch.obs.ROUTER_METRICS`), in the engines' registry, so
router and engine series land in one snapshot (``affinity_hits`` counts
routes that prefix affinity decided). Each completion observes
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
import torch

from repro_torch import obs
from repro_torch.launch.mesh import group_over, mesh_ranks
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


class SharedHost:
    """The host inputs of a router that several ranks run: the ranks the
    engines span (their decode and prefill meshes), a process group over
    them, and for each replica the rank whose readback every rank uses
    (the first of its decode mesh; a meshless replica's, the first rank).
    ``active`` is False when the engines span one rank or none: then each
    engine is read where it is and no collective is issued."""

    def __init__(self, engines: Sequence[ServeEngine]):
        self.workers = [eng.decode for eng in engines]
        ranks = sorted({r for eng in engines for r in eng.ranks})
        self.active = len(ranks) > 1
        if not self.active:
            return
        import torch.distributed as dist

        self.rank = dist.get_rank()
        if self.rank not in ranks:
            raise RuntimeError(f"rank {self.rank} runs a router over ranks {ranks} it is not one of")
        self.ranks = ranks
        self.group = group_over(ranks)
        self.device = self.workers[0].device
        self.roots = [mesh_ranks(w.mesh)[0] if w.mesh is not None else ranks[0] for w in self.workers]

    def now(self, clock) -> float:
        """The tick's clock reading, the same on every rank: the first
        rank's (a broadcast), or the :class:`ManualClock`'s own."""
        t = clock.now()
        if not self.active or isinstance(clock, ManualClock):
            return t
        import torch.distributed as dist

        buf = torch.tensor([t], dtype=torch.float64, device=self.device)
        dist.broadcast(buf, src=self.ranks[0], group=self.group)
        return float(buf.item())

    def _share(self, parts: Sequence[tuple]) -> List[np.ndarray]:
        """One all-reduce of the int32 pieces ``parts`` (``(replica, size,
        read)``, ``read()`` the piece on the device), each filled in by its
        replica's root alone and zero elsewhere, so the sum is each root's
        piece on every rank; the volume is the pieces', whatever the
        world's size."""
        import torch.distributed as dist

        sizes = [size for _, size, _ in parts]
        buf = torch.zeros(sum(sizes), dtype=torch.int32, device=self.device)
        at = 0
        for i, size, read in parts:
            if self.roots[i] == self.rank:
                buf[at : at + size] = read().reshape(-1)
            at += size
        dist.all_reduce(buf, group=self.group)
        return np.split(buf.cpu().numpy(), np.cumsum(sizes)[:-1])

    def heads(self, live: Sequence[int]) -> dict:
        """``{replica: head}`` for the ``live`` replicas
        (:meth:`~repro_torch.serve.engine.DecodeWorker.head` on the host):
        each worker's own on one rank, else its root's, in one collective."""
        if not self.active:
            return {i: self.workers[i].read_head() for i in live}
        with obs.span("serve.sync", replicas=len(live)):
            got = self._share([(i, self.workers[i].head_len(), self.workers[i].head) for i in live])
        return dict(zip(live, got))

    def hold_rows(self, live: Sequence[int]) -> None:
        """Hand each ``live`` worker the output rows of its ``finishing``
        slots (:meth:`~repro_torch.serve.engine.DecodeWorker.hold`): read
        where it is on one rank, else its root's, in one collective on a
        tick where any slot finished and none on the others."""
        done = [i for i in live if self.workers[i].finishing]
        if not done:
            return
        if not self.active:
            for i in done:
                self.workers[i].hold(self.workers[i].rows().cpu().numpy())
            return
        width = {i: self.workers[i].ecfg.max_new for i in done}
        parts = [(i, len(self.workers[i].finishing) * width[i], self.workers[i].rows) for i in done]
        for i, flat in zip(done, self._share(parts)):
            self.workers[i].hold(flat.reshape(-1, width[i]))


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
        request (an empty pool fits its lifetime bill). With prefix caching
        on, **prefix affinity** leads the key: replicas' radix caches are
        private, so a request lands where most of its prompt is already
        resident (a splice there skips that much prefill and allocation);
        billed-page load only breaks affinity ties, which keeps cold traffic
        routed least-loaded as before."""
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
        hits = {i: self.engines[i].prefix_hit_pages(req.tokens) for i in feasible}
        best = min(feasible, key=lambda i: (-hits[i],) + self._load(i, queues))
        if hits[best] > 0:
            self.stats["affinity_hits"] += 1
        obs.instant("serve.route", rid=req.rid, replica=best, prefix_hits=hits[best])
        return best

    # -- the serving loop ---------------------------------------------------

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        clock = self.clock or MonotonicClock()
        shared = SharedHost(self.engines)
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
            now = shared.now(clock)
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
                # every live replica's chunk, then the tick's readbacks
                live = [i for i, r in enumerate(resident) if r]
                for i in live:
                    self.engines[i].decode_chunk()
                heads = shared.heads(live)
                finished = {}
                for i in live:
                    active, n_out = self.engines[i].decode.advance(heads[i])
                    finished[i] = [(s, int(n_out[s])) for s in resident[i] if not active[s]]
                shared.hold_rows(live)
                for i in live:
                    t_done = clock.now()
                    for slot, n in finished[i]:
                        req, t_admit, t_first = resident[i].pop(slot)
                        toks = self.engines[i].fetch(slot, n)
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
