"""Continuous-batching serving engine — scheduler/executor split with an
overlap-dispatch loop.

All host policy (admission, slot assignment, block reservation, prefix
matching) lives in `scheduler.Scheduler`, all device state (params,
cache, control-array mirrors, the sampled-token feedback buffer) in
`executor.ModelExecutor`; the engine runs the tick loop between them and
turns drained samples into `RequestOutput` events.

One tick runs two kinds of step:
  * per-slot chunked prefill — tokens [1, prefill_chunk] against ONE
    slot's cache row;
  * fused pool decode + sample — tokens [B, 1] read from the executor's
    device-resident token buffer, per-row `n_valid` (0 rows untouched),
    sampled tokens written straight back into the buffer on device.

Two loop modes, token-identical (both run the same dispatch sequence):
  * `overlap=False`: each tick's samples are read back right after
    dispatch.
  * `overlap=True`: the host enqueues tick N+1 before reading tick N's
    samples, so the device-to-host sync overlaps the next tick's device
    work. Length finishes are predicted from the scheduled count and
    release their slot at dispatch time; only EOS is seen one tick late
    (at most one discarded decode per EOS'd request, `wasted_decodes`).

Prefix caching (`prefix_cache=True`, paged layout only) shares prompt KV
across requests at block granularity: admission points a slot's table at
the longest cached block-aligned prefix and starts its prefill there,
and a slot that must append into a block it shares first copies it to a
private block (copy-on-write). Families with a recurrent SSM state
cannot enter a prompt mid-stream, so there the flag does nothing.

Sampling with temperature draws from one `torch.Generator` per request,
seeded from the request's seed or from (engine seed, request id). Greedy
requests (temperature 0) are the cross-package parity contract.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Optional, Union

import numpy as np
import torch

from ..core.backend import resolve_device
from ..core.precision import policy_tier
from .api import FinishedRequest, Request, RequestOutput, SamplingParams
from .executor import ModelExecutor, to_device
from .prefix_cache import PrefixCache
from .scheduler import Scheduler, SchedulingPolicy, SlotState

__all__ = ["ServingEngine", "Request", "RequestOutput", "FinishedRequest",
           "SamplingParams", "params_to"]


def params_to(tree, device):
    """Move a param tree (tensors and QuantizedTensors) to `device`."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@dataclasses.dataclass
class _InFlight:
    """One dispatched tick whose sampled tokens are not yet read back."""
    tick: int
    dec: List                    # [(row, SlotState, token_index)]
    dec_toks: Any                # device [max_slots] or None
    pf: List                     # [(row, SlotState, token_index)]
    pf_toks: Any                 # device [len(pf)] or None


class ServingEngine:
    """Slot-based continuous-batching engine.

    Usage:
        eng = ServingEngine(cfg, params, policy=pol, max_slots=4,
                            max_len=256, overlap=True)
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=8))
        for out in eng.events():        # RequestOutput per-token stream
            print(out.id, out.new_tokens, out.finished)

    Runs on CUDA unless `device` says otherwise; raises when CUDA is
    absent and no device is given.
    """

    def __init__(self, cfg, params, policy=None, max_slots: int = 4,
                 max_len: int = 256, prefill_chunk: int = 32, seed: int = 0,
                 kv_block_size: Optional[int] = None,
                 kv_blocks: Optional[int] = None, prefix_cache: bool = False,
                 scheduler: Union[str, SchedulingPolicy] = "fifo",
                 overlap: bool = False, device=None):
        self.device = resolve_device(device)
        if kv_blocks is not None and kv_block_size is None:
            raise ValueError("kv_blocks requires kv_block_size (a pool size "
                             "only makes sense for the paged layout)")
        if prefix_cache and kv_block_size is None:
            raise ValueError("prefix_cache requires kv_block_size (prefix "
                             "sharing is a property of the paged layout)")
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.policy = policy
        self.tier = policy_tier(policy)
        self.max_slots = max_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.seed = seed
        self.overlap = overlap
        self.ex = ModelExecutor(cfg, self.params, policy=policy,
                                device=self.device, max_slots=max_slots,
                                max_len=max_len, prefill_chunk=prefill_chunk,
                                kv_block_size=kv_block_size,
                                kv_blocks=kv_blocks)
        prefix = (PrefixCache(kv_block_size)
                  if prefix_cache and self.ex.paged and not self.ex.has_ssm
                  else None)
        self.sched = Scheduler(
            max_slots, max_len, policy=scheduler,
            kv_block_size=kv_block_size if self.ex.paged else None,
            num_blocks=self.ex.num_blocks, paged=self.ex.paged,
            has_ssm=self.ex.has_ssm, prefix_cache=prefix, tier=self.tier)
        self.tick = 0
        self._inflight: deque = deque()      # dispatched, not yet drained
        self._out_buffer: deque = deque()    # events awaiting a consumer
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self.emitted_tokens = 0
        self.busy_slot_ticks = 0
        self.total_slot_ticks = 0
        self.prefill_tokens_computed = 0
        self.sample_sync_tokens = 0          # tokens whose sync gated dispatch
        self.wasted_decodes = 0              # overlap: post-EOS/abort drains
        self.aborted_requests = 0

    @property
    def paged(self) -> bool:
        return self.ex.paged

    @property
    def load(self) -> int:
        """Live requests on this engine: occupied slots + its own pending
        queue (what the router's least-loaded placement balances)."""
        return (sum(s is not None for s in self.sched.slots)
                + len(self.sched.pending))

    def prefix_peek(self, keys) -> int:
        """How many leading chain-keyed prompt blocks this engine's prefix
        cache holds (0 without a cache): the router's affinity probe,
        read-only (no LRU or hit-count change)."""
        prefix = self.sched._prefix
        return prefix.peek(keys) if prefix is not None else 0

    # -- request lifecycle ---------------------------------------------------

    def submit(self, request: Request) -> int:
        return self.sched.submit(request, self.tick)

    def abort(self, rid: int) -> bool:
        """Release a queued or in-flight request and emit its terminal
        `finish_reason='aborted'` event. False when `rid` is unknown or
        already finished."""
        req = self.sched.abort_pending(rid)
        if req is not None:
            self.aborted_requests += 1
            self._out_buffer.append(RequestOutput(
                id=rid, new_tokens=[], tokens=[],
                prompt_len=len(req.prompt), tick=self.tick, finished=True,
                finish_reason="aborted", prompt=req.prompt, tier=self.tier))
            return True
        found = self.sched.find_slot(rid)
        if found is None:
            return False
        b, slot = found
        slot.done = True                 # in-flight drains become discards
        self.sched.release(b, self.ex)
        self.aborted_requests += 1
        self.prompt_tokens += slot.prefill_pos
        self.generated_tokens += len(slot.generated)
        self._out_buffer.append(RequestOutput(
            id=rid, new_tokens=[], tokens=list(slot.generated),
            prompt_len=slot.prompt_len, tick=self.tick, finished=True,
            finish_reason="aborted", prompt=slot.request.prompt,
            admitted_tick=slot.admitted_tick,
            prefix_hit_tokens=slot.prefix_hit, tier=self.tier))
        return True

    def has_work(self) -> bool:
        return (self.sched.has_work() or bool(self._inflight)
                or bool(self._out_buffer))

    def _request_generator(self, req: Request) -> torch.Generator:
        seed = (req.seed if req.seed is not None
                else self.seed * 1_000_003 + req.id)
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- one engine tick -----------------------------------------------------

    def _prefill_block(self, slot: SlotState):
        """[1, chunk] block holding this slot's next prompt chunk (zero
        padded: the padding rows enter the per-tensor activation scale
        exactly as in the reference)."""
        chunk = self.prefill_chunk
        take = min(chunk, slot.prompt_len - slot.prefill_pos)
        block = np.zeros((1, chunk), np.int64)
        block[0, :take] = np.asarray(
            slot.request.prompt[slot.prefill_pos:slot.prefill_pos + take])
        return to_device(block, self.device), take

    def _dispatch_tick(self) -> bool:
        """Admit, then enqueue this tick's device work (prefill chunks,
        fused decode + sample, prefill-seed sampling) WITHOUT reading any
        sampled value. False when there was nothing to dispatch."""
        sched, ex = self.sched, self.ex
        for _, slot in sched.admit(self.tick, ex):
            slot.key = self._request_generator(slot.request)

        occupied = [(b, s) for b, s in enumerate(sched.slots)
                    if s is not None and not s.done]
        prefill_plan = []                        # (row, slot, tokens, take)
        for b, slot in occupied:
            if slot.prefilling:
                tokens, take = self._prefill_block(slot)
                sched.ensure_blocks(b, slot.cache_len + take, ex)
                prefill_plan.append((b, slot, tokens, take))
        dec = [(b, s) for b, s in occupied
               if not s.prefilling
               and 0 < s.scheduled < s.request.max_new_tokens]
        for b, s in dec:
            sched.ensure_blocks(b, s.cache_len + 1, ex)
        if not prefill_plan and not dec:
            return False
        ex.flush()

        # 1) chunked prefill, one chunk per prefilling slot; the final
        #    chunk's last-valid logits seed the first sample
        pf_items, pf_rows, pf_logits, pf_gens = [], [], [], []
        pf_temps, pf_topks = [], []
        for b, slot, tokens, take in prefill_plan:
            lg = ex.prefill(b, tokens, take)
            slot.prefill_pos += take
            slot.cache_len += take
            self.prefill_tokens_computed += take
            if not slot.prefilling:
                pf_items.append((b, slot, slot.scheduled))
                pf_rows.append(b)
                pf_logits.append(lg)
                pf_gens.append(slot.key)
                pf_temps.append(slot.request.sampling.temperature)
                pf_topks.append(slot.request.sampling.top_k)
                slot.scheduled += 1
            sched.register_prefix_blocks(b)

        # 2) fused pool decode + sample for device-seeded frontier rows
        dec_items, dec_toks = [], None
        if dec:
            n_valid = np.zeros((self.max_slots,), np.int32)
            gens = [None] * self.max_slots
            temps = np.zeros((self.max_slots,), np.float32)
            topks = np.zeros((self.max_slots,), np.int32)
            for b, s in dec:
                n_valid[b] = 1
                gens[b] = s.key
                temps[b] = s.request.sampling.temperature
                topks[b] = s.request.sampling.top_k
                dec_items.append((b, s, s.scheduled))
                s.scheduled += 1
                s.cache_len += 1
            dec_toks = ex.decode_and_sample(n_valid, gens, temps, topks)

        # 3) sample + device-seed rows that finished prefill this tick
        pf_toks = None
        if pf_items:
            pf_toks = ex.seed_tokens(pf_rows, pf_logits, pf_gens,
                                     np.asarray(pf_temps, np.float32),
                                     np.asarray(pf_topks, np.int32))

        # length finishes are host-predictable: release at dispatch so the
        # overlapped admission timing equals the sync loop's
        for b, s, _ in dec_items + pf_items:
            if s.scheduled >= s.request.max_new_tokens and not s.released:
                sched.release(b, self.ex)

        self._inflight.append(_InFlight(self.tick, dec_items, dec_toks,
                                        pf_items, pf_toks))
        self.busy_slot_ticks += len(occupied)
        self.total_slot_ticks += self.max_slots
        self.tick += 1
        return True

    def _drain_one(self, events: List[RequestOutput]):
        """Read back the oldest in-flight tick's sampled tokens and turn
        them into events: per-token deltas, EOS/length finishes, and
        discards for slots that finished or aborted after the dispatch."""
        ent = self._inflight.popleft()
        gating = not self._inflight
        dec = ent.dec_toks.cpu().numpy() if ent.dec_toks is not None else None
        pf = ent.pf_toks.cpu().numpy() if ent.pf_toks is not None else None
        items = [(b, slot, idx, dec[b]) for b, slot, idx in ent.dec]
        items += [(b, slot, idx, pf[i])
                  for i, (b, slot, idx) in enumerate(ent.pf)]
        now = time.monotonic()
        emitted = 0
        for b, slot, idx, val in sorted(items, key=lambda it: it[0]):
            if slot.done:
                self.wasted_decodes += 1
                continue
            assert idx == len(slot.generated), "drain out of order"
            t = int(val)
            slot.generated.append(t)
            emitted += 1
            self.emitted_tokens += 1
            if slot.first_token_time is None:
                slot.first_token_time = now
            req = slot.request
            out = RequestOutput(
                id=req.id, new_tokens=[t], tokens=list(slot.generated),
                prompt_len=slot.prompt_len, tick=ent.tick, prompt=req.prompt,
                admitted_tick=slot.admitted_tick,
                prefix_hit_tokens=slot.prefix_hit, tier=self.tier)
            hit_eos = req.eos_id is not None and t == req.eos_id
            if hit_eos or len(slot.generated) >= req.max_new_tokens:
                slot.done = True
                out.finished = True
                out.finish_reason = "eos" if hit_eos else "length"
                out.ttft_s = slot.first_token_time - slot.submit_time
                self.prompt_tokens += slot.prompt_len
                self.generated_tokens += len(slot.generated)
                if not slot.released:       # EOS before the predicted end
                    self.sched.release(b, self.ex)
            events.append(out)
        if gating:
            self.sample_sync_tokens += emitted

    def step(self) -> List[RequestOutput]:
        """Dispatch the next tick, then drain sampled tokens — right away
        in sync mode, one tick behind with `overlap=True`."""
        events: List[RequestOutput] = list(self._out_buffer)
        self._out_buffer.clear()
        dispatched = self._dispatch_tick()
        depth = 1 if (self.overlap and dispatched) else 0
        while len(self._inflight) > depth:
            self._drain_one(events)
        return events

    # -- output streams ------------------------------------------------------

    def events(self):
        """Run ticks until idle, yielding `RequestOutput` events."""
        while self.has_work():
            yield from self.step()

    def stream(self, request: Request):
        """Submit `request` and yield ITS events until its terminal one;
        other requests' events stay buffered for `events()`."""
        rid = self.submit(request)
        while self.has_work():
            outs = self.step()
            mine = [o for o in outs if o.id == rid]
            self._out_buffer.extend(o for o in outs if o.id != rid)
            for out in mine:
                yield out
                if out.finished:
                    return
            if not mine and not (self.sched.has_work() or self._inflight):
                return

    def run(self, requests: Optional[List[Request]] = None
            ) -> List[FinishedRequest]:
        """Completion-only view: submit `requests`, drive to completion,
        return `FinishedRequest`s sorted by id."""
        for r in requests or ():
            self.submit(r)
        done = [out.to_finished() for out in self.events() if out.finished]
        return sorted(done, key=lambda f: f.id)

    # -- introspection -------------------------------------------------------

    def check_invariants(self):
        self.sched.check_invariants()

    def stats(self) -> dict:
        util = self.busy_slot_ticks / max(self.total_slot_ticks, 1)
        st = {"ticks": self.tick,
              "prompt_tokens": self.prompt_tokens,
              "generated_tokens": self.generated_tokens,
              "prefill_tokens_computed": self.prefill_tokens_computed,
              "slot_utilization": util,
              "h2d_updates": self.ex.h2d_updates,
              "overlap": self.overlap,
              "sample_syncs_per_token": (self.sample_sync_tokens
                                         / max(self.emitted_tokens, 1)),
              "wasted_decodes": self.wasted_decodes,
              "aborted_requests": self.aborted_requests}
        st.update(self.sched.stats())
        if self.ex.paged:
            st["cow_copies"] = self.ex.cow_copies
        return st
