"""Speculative decoding for the continuous-batching engine (the port's copy
of ``repro.serve.spec_decode``).

A small **drafter** proposes ``k`` greedy tokens per round from its own
dense per-slot cache; the target :class:`repro_torch.serve.engine.DecodeWorker`
verifies all of them (plus one bonus position) in one batched
:func:`repro_torch.models.transformer.lm_extend` forward and accepts the
longest run that matches its own greedy choices. Every emitted token is the
target's argmax: **greedy token parity with the plain engine is the
contract**; the drafter only decides how many target tokens one round
certifies, never what they are.

Rollback (why the gates below exist):

* the target writes draft KV at ``pos..pos+k`` during verify; rejected
  positions are never attended (the causal mask stops at each query) and
  the next verify's write range covers them, so a full attention cache
  rolls back for free. An SWA ring does not (wrapped writes alias earlier
  positions), so spec mode requires a full cache, and a recurrent carry
  cannot roll back at all;
* the drafter's dense cache holds the accepted prefix exactly, and values
  past the new position are overwritten before they are attended, so the
  drafter must be attention-only with a full cache too.

The reference runs a chunk as one ``lax.while_loop`` that stops when every
row has finished. A round emits a data-dependent number of tokens, so the
host here cannot know that step without reading the device: the chunk runs
every round the largest remaining budget allows (each active row emits at
least one token a round). A round after every row has finished changes no
output, no position and no counter: ``spec_steps`` grows by ``any(active)``
on the device, the draft counters by masked sums. Its KV writes land where
the reference's rounds already write for finished rows: a slot's own pages
at positions past its last emitted token (never a shared prompt page, since
the prefix cache pins full prompt pages only), the scratch page past the
slot's pages, and the slot's own drafter rows. The counters ride the
engine's one host read per chunk.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models.attention import write_rows
from repro_torch.models.transformer import group_pattern, init_lm_state, lm_decode, lm_extend, lm_prefill
from repro_torch.serve.engine import device_program, shard_state
from repro_torch.sharding.partition import mesh_context, whole


class SpecDecoder:
    """The drafter's state and the draft/verify chunk. Owned by a
    :class:`repro_torch.serve.engine.DecodeWorker` (``ecfg.spec_k > 0``);
    the worker hands its ``decode_chunk`` here, reads the draft counters
    (``counts``) with its slots, and forwards every admission so the
    drafter can prefill its own cache."""

    def __init__(self, worker, dcfg, dparams, k: int):
        non_attn = sorted({m for m, _ in group_pattern(dcfg) if m != "attn"})
        if non_attn:
            raise ValueError(
                f"drafter {dcfg.name}: speculative drafting requires attention-"
                f"only mixers, found {non_attn} — a recurrent carry cannot roll "
                "back past a rejected draft"
            )
        if dcfg.sliding_window > 0:
            raise ValueError(
                f"drafter {dcfg.name}: sliding_window={dcfg.sliding_window} makes "
                "the drafter cache a ring — stale rejected-draft writes would "
                "alias earlier positions after rollback. Draft with a full-"
                "attention config."
            )
        if dcfg.vocab_size != worker.cfg.vocab_size:
            raise ValueError(
                f"drafter {dcfg.name} vocab ({dcfg.vocab_size}) != target "
                f"{worker.cfg.name} vocab ({worker.cfg.vocab_size}): drafted ids "
                "would be meaningless to the verifier — pick a same-tokenizer "
                "drafter"
            )
        self.worker = worker
        self.dcfg = dcfg
        self.dparams = dparams
        self.k = int(k)
        # one verify certifies up to k+1 tokens, so a chunk of decode_chunk
        # token-steps takes about decode_chunk/(k+1) rounds; the worker's
        # page planning uses `horizon` (tokens a chunk may emit)
        self.steps = max(1, worker.ecfg.decode_chunk // (self.k + 1))
        self.horizon = self.steps * (self.k + 1)

    def reset(self) -> None:
        """(Re)build the drafter's dense cache (all slots) and zero the
        device counters ``[proposed, accepted, steps]`` (which the worker's
        readback carries) and the prefill count. A worker on another rank
        keeps only the count."""
        # the drafter's prefills since reset, each one forward of the
        # drafter over a bucket-padded admission group
        self.prefill_dispatches = 0
        w = self.worker
        if not w.local:
            return
        # the drafter's dense cache shards by the same k, v suffix rules as
        # the target's dense engine state
        draft = init_lm_state(self.dcfg, w.ecfg.max_slots, w.ecfg.max_seq, device=w.device)
        self._draft = shard_state({"draft": draft}, w.mesh)["draft"]
        self.counts = torch.zeros(3, dtype=torch.int32, device=w.device)

    def on_admit(self, slots: List[int], token_rows: np.ndarray, true_lens) -> None:
        """Prefill the drafter's cache rows for an admitted group. The
        drafter shares no pages: it always consumes the full (bucket-padded)
        prompt, even when the target spliced its prefix. Pad positions past
        each true length are overwritten by drafting before they are
        attended."""
        self._prefill_rows(slots, token_rows)
        self.prefill_dispatches += 1

    @device_program
    def _prefill_rows(self, slots: List[int], token_rows: np.ndarray) -> None:
        w = self.worker
        dev = w.device
        tokens = torch.as_tensor(np.asarray(token_rows, np.int32), device=dev)
        st1 = shard_state(init_lm_state(self.dcfg, tokens.shape[0], w.ecfg.max_seq, device=dev), w.mesh)
        with mesh_context(w.mesh):
            lm_prefill(self.dparams, self.dcfg, {"tokens": tokens}, st1)
        rows = torch.as_tensor(slots, dtype=torch.long, device=dev)
        for name, big in self._draft.items():
            write_rows(big, (slice(None), rows), st1[name])

    @device_program
    def chunk(self, rounds: int) -> None:
        """``rounds`` draft→verify rounds, on the device only. Each round:
        the drafter greedily unrolls k tokens from the batch's last tokens,
        the target scores ``[last_tok, d_1..d_k]`` in one extend, and the
        longest draft run matching the target's own argmax is emitted (plus
        the bonus token the verify got for free), through the plain chunk's
        per-token masking, so budgets, EOS and output rows behave the same."""
        w = self.worker
        cfg, dcfg, e, k = w.cfg, self.dcfg, w.ecfg, self.k
        s, d = w._state, self._draft
        rows = torch.arange(e.max_slots, device=w.device)
        with obs.span("serve.spec.verify", replica=w.replica):
            for _ in range(rounds):
                # 1) draft: k greedy single-token steps. Inactive slots ride
                # along, rewriting their frozen position in their own rows
                dt, dpos, drafts = s.last_tok, s.pos, []
                for _ in range(k):
                    with mesh_context(w.mesh):
                        dlog, _ = lm_decode(self.dparams, dcfg, dt, d, dpos)
                    nxt = torch.argmax(whole(dlog[:, -1]), dim=-1).to(torch.int32)
                    drafts.append(nxt)
                    dt, dpos = nxt[:, None], dpos + 1
                # one more cache fill: when every draft and the bonus token
                # are accepted, the next round resumes at pos+k+1, and
                # position pos+k (token d_k) must already be in the cache
                with mesh_context(w.mesh):
                    lm_decode(self.dparams, dcfg, dt, d, dpos)
                dmat = torch.stack(drafts, dim=1)  # (S, k)
                # 2) verify: one target forward over [last_tok, d_1..d_k] at
                # pos..pos+k; tgt[:, j] is the target's greedy choice after
                # x[:, :j+1], what the plain engine would have sampled
                x = torch.cat([s.last_tok, dmat], dim=1)  # (S, k+1)
                with mesh_context(w.mesh):
                    vlog, _ = lm_extend(w.params, cfg, x, s.kv, s.pos, s.page_table)
                tgt = torch.argmax(whole(vlog), dim=-1).to(torch.int32)  # (S, k+1)
                match = (dmat == tgt[:, :k]).to(torch.int32)
                n_acc = torch.cumprod(match, dim=1).sum(dim=1)  # (S,) in [0, k]
                act = s.active
                self.counts += torch.stack([
                    k * act.sum(), torch.where(act, n_acc, 0).sum(), act.any().long()
                ]).to(torch.int32)
                # 3) emit tgt[:, 0..n_acc] per slot: candidate j does not
                # happen for rows whose accepted run ended earlier
                for j in range(k + 1):
                    tok = tgt[:, j]
                    step = s.active & (j <= n_acc)
                    write = step & (s.n_out < e.max_new)
                    idx = torch.clamp(s.n_out, max=e.max_new - 1).long()
                    s.out[rows, idx] = torch.where(write, tok, s.out[rows, idx])
                    s.n_out += write.to(torch.int32)
                    finished = s.n_out >= s.budget
                    if e.eos_token >= 0:
                        finished |= (tok == e.eos_token) & step
                    s.last_tok = torch.where(step[:, None], tok[:, None], s.last_tok)
                    s.pos += step.to(torch.int32)
                    s.active &= ~finished
