"""Cross-tier speculative decoding: a cheap draft replica proposes, an
accurate verify replica disposes.

`SpecDecodeCoordinator` pairs two `ServingEngine`s with identical slot
and pool geometry: a DRAFT engine (typically the fxp4 view of a
`TieredWeights` bank) and a VERIFY engine (fxp8, fxp16 or bf16). Each
decode round the draft proposes up to k tokens autoregressively (one
chunked ingest and k-1 one-token decodes), then the verifier scores all
k+1 positions in ONE chunked dispatch of `ModelExecutor.verify`, the same
ragged `decode_step(n_valid, last_only=False)` that chunked prefill runs
(its SSM layers stepped token by token on the verify side, so that each
position scores as a one-token decode would).
Greedy acceptance takes the longest draft prefix that matches the
verifier's per-position argmax plus the verifier's correction token, so
the emitted stream is token-identical to running the verify tier alone
whenever the verify policy's numerics do not depend on how the chunk is
composed (bf16, or no policy; under an FxP verifier the per-tensor
activation scale spans every row of the dispatch, so they do). That is
why `submit` rejects temperature and top-k sampling.

Rejected suffixes roll back: `Scheduler.rollback` truncates the slot's
length mirror and returns every pool block past the accepted frontier
(generated blocks are never prefix-shared, so the return is a plain
refcounted free, asserted), and the block ledger is audited by
`check_invariants()` after every rollback round. The SSM and hybrid
families carry a recurrent state that no length clamp truncates, so
their rollback is checkpoint, restore, replay: the recurrent rows are
copied before each speculative dispatch, and a rejected round restores
them and replays the accepted tokens through the same chunked verify
step (the KV rewrite is deterministic, so the window comes back equal).

Both engines own their KV pools and admit in lockstep (the same
geometry, the same no-skip reservation admission and the same submission
order give the same placement, asserted every tick), which keeps every
scheduler invariant locally checkable. The `spec_*` counters expose the
trade: proposed, accepted, acceptance rate, verify steps, rolled-back
tokens and tokens per verify step (a perfectly drafting pair emits k+1
tokens per verify dispatch).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.precision import tier_policy
from ..core.qtensor import TieredWeights
from .api import FinishedRequest, Request, RequestOutput
from .engine import ServingEngine

__all__ = ["SpecDecodeCoordinator"]


class _SpecState:
    """Per-request speculative bookkeeping shared by both engine slots."""

    def __init__(self, request: Request):
        self.request = request
        self.emitted: List[int] = []    # accepted tokens, oldest first
        # the newest emitted token: its KV is unwritten on BOTH sides (the
        # verify dispatch that produced it was rolled back past it, or it
        # was seeded from prefill logits), so every round starts by
        # feeding it
        self.pending: Optional[int] = None
        # after a fully accepted round the draft is one token further
        # behind: its last proposal was emitted but never consumed as an
        # input, so the next draft ingest replays [catchup, pending]
        self.catchup: Optional[int] = None
        self.done = False
        self.proposed = 0
        self.accepted = 0
        self.verify_steps = 0
        self.rolled_back = 0

    def stamp(self, out: RequestOutput):
        out.spec_proposed = self.proposed
        out.spec_accepted = self.accepted
        out.spec_verify_steps = self.verify_steps
        out.spec_rolled_back = self.rolled_back


class SpecDecodeCoordinator:
    """Draft/verify engine pair behind the single-engine serving surface
    (`submit`, `step`, `events`, `stream`, `run`, `abort`, `stats`),
    emitting verify-tier greedy streams in fewer verify dispatches. See
    the module docstring for the protocol; `from_tiers` builds the pair
    off one `TieredWeights` bank."""

    def __init__(self, cfg, draft_params, verify_params, *,
                 draft_policy=None, verify_policy=None, k: int = 4,
                 **engine_kw):
        if k < 1:
            raise ValueError("speculative depth k must be >= 1")
        prefill_chunk = engine_kw.get("prefill_chunk", 32)
        if k > prefill_chunk + 1:
            raise ValueError(
                f"k={k} exceeds the verify window the cache allocation "
                f"supports (k <= prefill_chunk + 1 = {prefill_chunk + 1})")
        engine_kw.pop("overlap", None)   # rounds sync at acceptance anyway
        self.k = k
        self.cfg = cfg
        self.draft = ServingEngine(cfg, draft_params, policy=draft_policy,
                                   **engine_kw)
        self.verify = ServingEngine(cfg, verify_params,
                                    policy=verify_policy, **engine_kw)
        if self.draft.ex.paged != self.verify.ex.paged:
            raise ValueError("draft and verify engines must share a KV "
                             "layout (both paged or both contiguous)")
        self.draft.ex.ensure_verify_step(k + 1)
        self.verify.ex.ensure_verify_step(k + 1)
        self.tier = self.verify.tier          # the tier the stream equals
        self.draft_tier = self.draft.tier
        self.max_slots = self.verify.max_slots
        # the draft's greedy decodes read no generator (temperature 0)
        self._no_gens = [None] * self.max_slots
        self._spec: Dict[int, _SpecState] = {}      # row -> state
        self._out_buffer: deque = deque()
        self.tick = 0
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self.prefill_tokens_computed = 0
        self.busy_slot_ticks = 0
        self.total_slot_ticks = 0
        self.aborted_requests = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_verify_steps = 0
        self.spec_rolled_back = 0

    @classmethod
    def from_tiers(cls, cfg, params, draft: str, verify: str, *,
                   backend: str = "reference", k: int = 4, **engine_kw):
        """Build the pair off one quantize-once `TieredWeights` bank:
        `params` is a float tree (a bank over {draft, verify} is built) or
        a bank that already holds both tiers."""
        bank = (params if isinstance(params, TieredWeights)
                else TieredWeights(params, (draft, verify)))
        return cls(cfg, bank.for_tier(draft), bank.for_tier(verify),
                   draft_policy=tier_policy(draft, backend=backend),
                   verify_policy=tier_policy(verify, backend=backend),
                   k=k, **engine_kw)

    # -- engine-compatible views --------------------------------------------

    @property
    def sched(self):
        """The verify scheduler: the one the coordinator's admission, tier
        pins and the router's audits hold against."""
        return self.verify.sched

    @property
    def load(self) -> int:
        return self.verify.load

    def prefix_peek(self, keys) -> int:
        return self.verify.prefix_peek(keys)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, request: Request) -> int:
        """Greedy only: acceptance compares the draft's proposal with the
        verifier's argmax per position, and a sampled stream has no
        per-position ground truth to accept against."""
        s = request.sampling
        if s.temperature > 0.0 or s.top_k > 0:
            raise ValueError(
                "speculative decoding serves greedy requests only "
                "(temperature<=0, top_k==0): acceptance is defined "
                "against the verifier's argmax")
        rid = self.verify.sched.submit(request, self.tick)
        # the same Request object: the verify submit assigned the id, and
        # the draft's tier deliberately differs from any pin
        self.draft.sched.submit(request, self.tick, check_tier=False)
        return rid

    def abort(self, rid: int) -> bool:
        """Release a queued or mid-speculation request on BOTH engines;
        emits one terminal 'aborted' event with the tokens accepted so
        far. False when `rid` is unknown or already finished."""
        req = self.verify.sched.abort_pending(rid)
        if req is not None:
            self.draft.sched.abort_pending(rid)
            self.aborted_requests += 1
            self._out_buffer.append(RequestOutput(
                id=rid, new_tokens=[], tokens=[],
                prompt_len=len(req.prompt), tick=self.tick, finished=True,
                finish_reason="aborted", prompt=req.prompt, tier=self.tier))
            return True
        found = self.verify.sched.find_slot(rid)
        if found is None:
            return False
        b, vslot = found
        sp = self._spec.pop(b)
        sp.done = True
        self.verify.sched.release(b, self.verify.ex)
        self.draft.sched.release(b, self.draft.ex)
        self.aborted_requests += 1
        self.prompt_tokens += vslot.prefill_pos
        self.generated_tokens += len(sp.emitted)
        out = RequestOutput(
            id=rid, new_tokens=[], tokens=list(sp.emitted),
            prompt_len=vslot.prompt_len, tick=self.tick, finished=True,
            finish_reason="aborted", prompt=vslot.request.prompt,
            admitted_tick=vslot.admitted_tick,
            prefix_hit_tokens=vslot.prefix_hit, tier=self.tier)
        sp.stamp(out)
        self._out_buffer.append(out)
        return True

    def has_work(self) -> bool:
        return self.verify.sched.has_work() or bool(self._out_buffer)

    # -- one coordinator tick ------------------------------------------------

    def _admit(self):
        """Lockstep admission on both schedulers. The same geometry, the
        same no-skip reservation policy and the same submission order
        place requests identically; asserted, because every later
        dispatch pairs slot rows by position."""
        vad = self.verify.sched.admit(self.tick, self.verify.ex)
        dad = self.draft.sched.admit(self.tick, self.draft.ex)
        assert ([(b, s.request.id) for b, s in vad]
                == [(b, s.request.id) for b, s in dad]), (
            "draft/verify admission diverged: geometry mismatch?")
        for b, vslot in vad:
            self._spec[b] = _SpecState(vslot.request)

    def _advance_prefill(self, eng: ServingEngine) -> List[int]:
        """One chunked-prefill dispatch per still-prefilling slot of one
        engine; returns the rows that completed their prompt this tick.
        The sides progress independently (their prefix-cache hits
        differ), so one can finish prefill ticks before the other."""
        sched, ex = eng.sched, eng.ex
        plan = []
        for b, slot in enumerate(sched.slots):
            if slot is not None and slot.prefilling:
                tokens, take = eng._prefill_block(slot)
                sched.ensure_blocks(b, slot.cache_len + take, ex)
                plan.append((b, slot, tokens, take))
        ex.flush()
        finished_rows = []
        for b, slot, tokens, take in plan:
            lg = ex.prefill(b, tokens, take)
            slot.prefill_pos += take
            slot.cache_len += take
            if eng is self.verify:
                self.prefill_tokens_computed += take
                if not slot.prefilling:
                    # the first token comes from the final chunk's logits
                    slot.first_logits = lg
            if not slot.prefilling:
                finished_rows.append(b)
            sched.register_prefix_blocks(b)
        return finished_rows

    def _seed_rows(self, rows: List[int], events: List[RequestOutput]):
        """Emit each newly prefilled row's first token: the argmax of the
        verify engine's prefill logits over the true vocab in f32
        (`sample_tokens`' greedy branch)."""
        vocab = self.cfg.vocab
        for b in rows:
            vslot = self.verify.sched.slots[b]
            sp = self._spec[b]
            lg = vslot.first_logits
            del vslot.first_logits
            t0 = int(torch.argmax(lg[:vocab].float()))
            sp.emitted.append(t0)
            sp.pending = t0
            self._emit(b, vslot, sp, [t0], events)

    def _emit(self, b: int, vslot, sp: _SpecState, new: List[int],
              events: List[RequestOutput]):
        """Append one accepted-token event; a finish (EOS inside the
        window, or the length) releases BOTH slots."""
        if vslot.first_token_time is None:
            vslot.first_token_time = time.monotonic()
        req = sp.request
        out = RequestOutput(
            id=req.id, new_tokens=list(new), tokens=list(sp.emitted),
            prompt_len=vslot.prompt_len, tick=self.tick, prompt=req.prompt,
            admitted_tick=vslot.admitted_tick,
            prefix_hit_tokens=vslot.prefix_hit, tier=self.tier)
        hit_eos = req.eos_id is not None and sp.emitted[-1] == req.eos_id
        if hit_eos or len(sp.emitted) >= req.max_new_tokens:
            sp.done = True
            out.finished = True
            out.finish_reason = "eos" if hit_eos else "length"
            out.ttft_s = vslot.first_token_time - vslot.submit_time
            sp.stamp(out)
            self.prompt_tokens += vslot.prompt_len
            self.generated_tokens += len(sp.emitted)
            self.verify.sched.release(b, self.verify.ex)
            self.draft.sched.release(b, self.draft.ex)
            self._spec.pop(b)
        events.append(out)

    def _spec_round(self, events: List[RequestOutput]):
        """One speculative round over every slot whose prompt is prefilled
        on BOTH sides: draft up to k tokens, verify k+1 positions in one
        chunked dispatch, accept the longest matching prefix and the
        correction token, roll rejected suffixes back."""
        dex, vex = self.draft.ex, self.verify.ex
        dsched, vsched = self.draft.sched, self.verify.sched
        ready = []
        for b, sp in sorted(self._spec.items()):
            dslot = dsched.slots[b]
            vslot = vsched.slots[b]
            if (sp.pending is not None and not sp.done
                    and not dslot.prefilling and not vslot.prefilling):
                ready.append((b, sp))
        if not ready:
            return
        B, S = self.max_slots, self.k + 1

        # per-row draft depth: never propose past the request's budget;
        # the round always emits >= 1 token (the verifier's), so at most
        # remaining - 1 proposals are useful
        plan = {}
        for b, sp in ready:
            remaining = sp.request.max_new_tokens - len(sp.emitted)
            plan[b] = min(self.k, remaining - 1)
        drafting = [(b, sp) for b, sp in ready if plan[b] >= 1]

        # --- draft phase: one chunked ingest + (k_row - 1) decodes ---
        drafts: Dict[int, List[int]] = {}
        d_ck = None
        d_start = {}
        if drafting:
            if dex.has_ssm:
                d_ck = dex.checkpoint_ssm()
            grid = np.zeros((B, S), np.int64)
            n_val = np.zeros((B,), np.int32)
            for b, sp in drafting:
                dslot = dsched.slots[b]
                d_start[b] = (dslot.cache_len,
                              1 if sp.catchup is not None else 0)
                seq = ([sp.catchup, sp.pending]
                       if sp.catchup is not None else [sp.pending])
                grid[b, :len(seq)] = seq
                n_val[b] = len(seq)
                dsched.ensure_blocks(
                    b, dslot.cache_len + len(seq) + plan[b] - 1, dex)
            dex.flush()
            ing = dex.verify(grid, n_val, ssm_stepwise=False)
            for b, sp in drafting:
                dsched.slots[b].cache_len += int(n_val[b])
            ing_host = ing.cpu().numpy()
            for b, sp in drafting:
                drafts[b] = [int(ing_host[b, n_val[b] - 1])]
            zeros_f = np.zeros((B,), np.float32)
            zeros_i = np.zeros((B,), np.int32)
            step_toks = []
            for i in range(1, max(plan[b] for b, _ in drafting)):
                nv = np.zeros((B,), np.int32)
                for b, sp in drafting:
                    if plan[b] >= i + 1:
                        nv[b] = 1
                        dsched.slots[b].cache_len += 1
                toks = dex.decode_and_sample(nv, self._no_gens, zeros_f,
                                             zeros_i)
                step_toks.append((nv, toks))
            for nv, toks in step_toks:
                h = toks.cpu().numpy()
                for b, sp in drafting:
                    if nv[b]:
                        drafts[b].append(int(h[b]))

        # --- verify phase: score all k_row + 1 positions in one dispatch ---
        v_ck = vex.checkpoint_ssm() if vex.has_ssm else None
        grid = np.zeros((B, S), np.int64)
        n_val = np.zeros((B,), np.int32)
        v_start = {}
        for b, sp in ready:
            vslot = vsched.slots[b]
            v_start[b] = vslot.cache_len
            seq = [sp.pending] + drafts.get(b, [])
            grid[b, :len(seq)] = seq
            n_val[b] = len(seq)
            vsched.ensure_blocks(b, vslot.cache_len + len(seq), vex)
        vex.flush()
        v_host = vex.verify(grid, n_val).cpu().numpy()
        for b, sp in ready:
            vsched.slots[b].cache_len += int(n_val[b])
        self.spec_verify_steps += 1

        # --- acceptance + rollback ---
        v_replay, d_replay = [], []       # (row, tokens) for the SSM rebuild
        rolled_any = False
        for b, sp in ready:
            k_row = plan[b]
            d = drafts.get(b, [])
            v = [int(v_host[b, j]) for j in range(k_row + 1)]
            n_acc = 0
            while n_acc < k_row and d[n_acc] == v[n_acc]:
                n_acc += 1
            emit = d[:n_acc] + [v[n_acc]]
            sp.proposed += k_row
            sp.accepted += n_acc
            sp.verify_steps += 1
            self.spec_proposed += k_row
            self.spec_accepted += n_acc
            eos = sp.request.eos_id
            if eos is not None and eos in emit:
                emit = emit[:emit.index(eos) + 1]
            sp.emitted.extend(emit)
            vslot = vsched.slots[b]
            prev_pending = sp.pending
            self._emit(b, vslot, sp, emit, events)
            if sp.done:
                continue                   # both slots already released
            # verify rollback: drop the k_row - n_acc rejected positions (a
            # full accept leaves the length exactly at the frontier)
            rejected = k_row - n_acc
            sp.rolled_back += rejected
            self.spec_rolled_back += rejected
            target_v = v_start[b] + 1 + n_acc
            if rejected:
                rolled_any = True
                vsched.rollback(b, target_v, vex)
                if vex.has_ssm:
                    # a recurrent carry cannot truncate: rewind the row to
                    # its checkpoint and replay the accepted tokens
                    vex.set_length(b, v_start[b])
                    vslot.cache_len = v_start[b]
                    v_replay.append((b, [prev_pending] + d[:n_acc]))
            # draft rollback: on a partial accept the draft's suffix past
            # the accepted frontier is dead too
            if n_acc == k_row:
                sp.catchup = d[-1] if d else None
                sp.pending = v[n_acc]
            else:
                len0, had_catchup = d_start[b]
                # the accepted d_{n_acc}'s KV stays: both sides truncate
                # to the same logical frontier
                target_d = v_start[b] + 1 + n_acc
                dslot = dsched.slots[b]
                if dslot.cache_len > target_d:
                    rolled_any = True
                    dsched.rollback(b, target_d, dex)
                    if dex.has_ssm:
                        dex.set_length(b, len0)
                        dslot.cache_len = len0
                        seq = [prev_pending] + d[:n_acc]
                        if had_catchup:
                            seq = [sp.catchup] + seq
                        d_replay.append((b, seq))
                sp.catchup = None
                sp.pending = v[n_acc]

        # --- SSM restore + replay (one extra dispatch per side) ---
        for eng, replay, ck in ((self.verify, v_replay, v_ck),
                                (self.draft, d_replay, d_ck)):
            if not replay:
                continue
            ex, sched = eng.ex, eng.sched
            ex.restore_ssm_rows([b for b, _ in replay], ck)
            grid = np.zeros((B, S), np.int64)
            nv = np.zeros((B,), np.int32)
            for b, seq in replay:
                assert len(seq) <= S
                grid[b, :len(seq)] = seq
                nv[b] = len(seq)
            ex.flush()
            # outputs discarded: KV and state rebuild only, each side as
            # its own dispatches built them
            ex.verify(grid, nv, ssm_stepwise=eng is self.verify)
            for b, _ in replay:
                sched.slots[b].cache_len += int(nv[b])

        if rolled_any:
            # the ledger is audited after every rollback round, not only
            # in tests
            vsched.check_invariants()
            dsched.check_invariants()

    def step(self) -> List[RequestOutput]:
        """One coordinator tick: lockstep admission, one prefill chunk per
        still-prefilling slot per side, first-token seeding, then one
        speculative round over every ready slot."""
        events: List[RequestOutput] = list(self._out_buffer)
        self._out_buffer.clear()
        self._admit()
        self._advance_prefill(self.draft)
        seeded = self._advance_prefill(self.verify)
        self._seed_rows(seeded, events)
        self._spec_round(events)
        occupied = sum(s is not None for s in self.verify.sched.slots)
        self.busy_slot_ticks += occupied
        self.total_slot_ticks += self.max_slots
        self.tick += 1
        return events

    # -- output streams (the engine's surface) -------------------------------

    def events(self):
        while self.has_work():
            yield from self.step()

    def stream(self, request: Request):
        rid = self.submit(request)
        while self.has_work():
            outs = self.step()
            mine = [o for o in outs if o.id == rid]
            self._out_buffer.extend(o for o in outs if o.id != rid)
            for out in mine:
                yield out
                if out.finished:
                    return
            if not mine and not self.verify.sched.has_work():
                return

    def run(self, requests: Optional[List[Request]] = None
            ) -> List[FinishedRequest]:
        for r in requests or ():
            self.submit(r)
        done = [out.to_finished() for out in self.events() if out.finished]
        return sorted(done, key=lambda f: f.id)

    # -- introspection -------------------------------------------------------

    def check_invariants(self):
        self.verify.sched.check_invariants()
        self.draft.sched.check_invariants()
        vids = {s.request.id for s in self.verify.sched.slots
                if s is not None}
        dids = {s.request.id for s in self.draft.sched.slots
                if s is not None}
        assert vids == dids, f"slot pairing drift: {vids} vs {dids}"

    def stats(self) -> dict:
        util = self.busy_slot_ticks / max(self.total_slot_ticks, 1)
        st = {"ticks": self.tick,
              "prompt_tokens": self.prompt_tokens,
              "generated_tokens": self.generated_tokens,
              "prefill_tokens_computed": self.prefill_tokens_computed,
              "slot_utilization": util,
              "h2d_updates": (self.verify.ex.h2d_updates
                              + self.draft.ex.h2d_updates),
              "overlap": False,
              # acceptance is a host decision: every round syncs
              "sample_syncs_per_token": 1.0,
              "wasted_decodes": 0,
              "aborted_requests": self.aborted_requests,
              "spec_draft_tier": self.draft_tier,
              "spec_k": self.k,
              "spec_proposed": self.spec_proposed,
              "spec_accepted": self.spec_accepted,
              "spec_acceptance_rate": (self.spec_accepted
                                       / max(self.spec_proposed, 1)),
              "spec_verify_steps": self.spec_verify_steps,
              "spec_rolled_back": self.spec_rolled_back,
              "spec_tokens_per_verify_step": (
                  self.generated_tokens / max(self.spec_verify_steps, 1))}
        st.update(self.verify.sched.stats())
        if self.verify.ex.paged:
            st["cow_copies"] = (self.verify.ex.cow_copies
                                + self.draft.ex.cow_copies)
        return st
