"""Pure-host scheduling policy for the serving engine.

The `Scheduler` owns every host-side policy decision the engine makes
between device dispatches: request validation and queueing, slot
assignment order (pluggable FIFO vs shortest-prompt-first), worst-case
block reservation over the paged KV pool, on-demand block claims,
refcounted release, and prefix-cache matching (including deciding
copy-on-write forks). It never touches a device array — all device-side
effects are expressed as calls against an executor *protocol* (set a
length mirror, write a block-table entry, reset an SSM row, fork a pool
block), so the whole object is unit-testable against a mock executor
with no model, no torch, and no device.

The split mirrors the Flex-PE control story: the paper's pipeline mode
keeps the PE array 100% time-multiplexed precisely because the
controller's reconfiguration decisions never serialize against the
compute fabric. Here the scheduler is that controller — everything it
does is host bookkeeping the device never waits on.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# the tier ladder lives in core.tiers, which imports nothing device-side —
# so this module stays host-only through tier validation
from ..core.tiers import tier_index
from .api import Request
from .prefix_cache import PrefixCache


class SlotState:
    """Host-side state of one occupied decode slot."""

    def __init__(self, request: Request, tick: int, blocks_need: int = 0):
        self.request = request
        self.key = None                      # per-request base PRNG key
        self.prefill_pos = 0                 # prompt tokens consumed
        self.generated: List[int] = []       # tokens drained to the host
        self.scheduled = 0                   # samples dispatched (>= drained)
        self.done = False                    # finished/aborted: drop drains
        self.released = False                # slot/blocks already returned
        self.admitted_tick = tick
        self.submit_time = 0.0               # set at admission (see submit)
        self.cache_len = 0                   # tokens written to the cache
        self.blocks_need = blocks_need       # worst-case paged reservation
        self.blocks: List[int] = []          # pool blocks held (paged mode)
        self.prefix_hit = 0                  # prompt tokens matched cached
        self.prefix_keys: List[str] = []     # chain keys of full blocks
        self.registered = 0                  # prompt blocks offered to cache
        self.first_token_time: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.request.prompt)

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.prompt_len


class SchedulingPolicy:
    """Admission-order policy: picks which pending request a free slot
    takes next. Admission is no-skip within the policy's order — if the
    picked request's block reservation doesn't fit, nothing behind it is
    admitted either, so no request can be starved by later arrivals."""

    name = "fifo"

    def pick(self, pending: List[Request]) -> int:
        """Index into `pending` of the next request to admit."""
        return 0


class ShortestPromptFirst(SchedulingPolicy):
    """Shortest prompt first (ties break FIFO): minimizes mean time-to-
    first-token on mixed workloads at the cost of long-prompt latency."""

    name = "spf"

    def pick(self, pending: List[Request]) -> int:
        return min(range(len(pending)),
                   key=lambda i: (len(pending[i].prompt), i))


POLICIES = {"fifo": SchedulingPolicy, "spf": ShortestPromptFirst}


def make_policy(policy: Union[str, SchedulingPolicy]) -> SchedulingPolicy:
    if isinstance(policy, SchedulingPolicy):
        return policy
    if policy not in POLICIES:
        raise ValueError(f"unknown scheduling policy {policy!r}; "
                         f"choose from {sorted(POLICIES)}")
    return POLICIES[policy]()


class Scheduler:
    """Host-only admission/slot/block policy object.

    The executor argument of `admit` / `ensure_blocks` only needs the
    mirror-write protocol: `set_length(row, v)`, `write_table(row, i,
    blk)`, `reset_table_row(row)`, `reset_ssm_row(row)`,
    `fork_block(src, dst)`. Tests drive the scheduler with a mock
    recording those calls.
    """

    def __init__(self, max_slots: int, max_len: int,
                 policy: Union[str, SchedulingPolicy] = "fifo",
                 kv_block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None, paged: bool = False,
                 has_ssm: bool = False,
                 prefix_cache: Optional[PrefixCache] = None,
                 block_shards: int = 1, tier: Optional[str] = None):
        self.max_slots = max_slots
        self.max_len = max_len
        # named precision tier this engine serves (None: untiered — an
        # off-ladder policy; tier-pinned requests are then unservable)
        self.tier = tier
        self.policy = make_policy(policy)
        self.kv_block_size = kv_block_size
        self.paged = paged
        self.has_ssm = has_ssm
        # >1 when the device pool's block axis is partitioned over that
        # many mesh shards (contiguous ranges of block ids per shard):
        # allocation then round-robins across shards so live KV — and the
        # scatter/gather traffic it drives — balances instead of piling
        # onto whichever shard's ids top the free list. Pure preference:
        # ids stay global, the ledger/invariants don't change, and any
        # block still serves any request.
        self.block_shards = max(int(block_shards), 1)
        self._next_shard = 0
        self.slots: List[Optional[SlotState]] = [None] * max_slots
        self.pending: List[Request] = []
        self._next_id = 0
        self._active_ids: set = set()     # pending + in-flight request ids
        # id -> (monotonic submit time, submit tick) while pending; moved
        # onto the SlotState at admission, popped on pending-abort — no
        # path leaves a dead entry behind
        self._submitted: Dict[int, Tuple[float, int]] = {}
        # paged allocator state
        self._committed = 0          # worst-case blocks promised to slots
        if paged:
            self.num_blocks = int(num_blocks)
            self._free: List[int] = list(range(self.num_blocks))
            self._ref = np.zeros((self.num_blocks,), np.int32)  # slot holds
            self._cached_unheld = 0      # cached blocks with zero slot refs
            self.peak_blocks_used = 0
        self._prefix = prefix_cache
        # cumulative stats
        self.prefix_tokens_reused = 0
        self.queue_wait_max = 0
        self._queue_wait_sum = 0
        self._queue_wait_n = 0

    # -- request lifecycle ---------------------------------------------------

    def blocks_need(self, request: Request) -> int:
        """Worst-case pool blocks this request can ever hold."""
        if not self.paged:
            return 0
        bs = self.kv_block_size
        return -(-(len(request.prompt) + request.max_new_tokens) // bs)

    def validate(self, request: Request, check_tier: bool = True):
        """Raise ValueError if `request` can never be served by this
        scheduler's geometry. Pure — no state mutates, so an external
        admission front (the multi-engine router) can pre-validate
        against any replica before deciding placement. `check_tier=False`
        skips the single-engine tier-match check (the router owns tier
        placement fleet-wide and runs its own unknown/unsupported-tier
        checks before any state mutates anywhere)."""
        if check_tier and request.tier is not None:
            tier_index(request.tier)         # unknown name -> ValueError
            if request.tier != self.tier:
                raise ValueError(
                    f"request pinned to tier {request.tier!r} but this "
                    f"engine serves "
                    + (f"tier {self.tier!r}" if self.tier is not None
                       else "no ladder tier")
                    + "; route it to a matching replica")
        plen = len(request.prompt)
        if plen < 1:
            raise ValueError("empty prompt: a request needs at least one "
                             "token to prefill")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if plen + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({request.max_new_tokens})"
                f" exceeds engine max_len ({self.max_len})")
        if self.paged and self.blocks_need(request) > self.num_blocks:
            raise ValueError(
                f"request needs {self.blocks_need(request)} KV blocks but "
                f"the pool only has {self.num_blocks}")

    def submit(self, request: Request, tick: int,
               check_tier: bool = True) -> int:
        """Validate and enqueue. Every check runs before any state
        mutates, so a rejected request can't leak an id, a queue entry,
        or a `_submitted` timestamp. `check_tier=False` skips the
        tier-match check for callers that own tier placement themselves
        (the speculative-decode coordinator mirrors every request into
        its draft engine's scheduler, whose tier deliberately differs
        from the tier the request was admitted under)."""
        self.validate(request, check_tier=check_tier)
        if request.id is not None and request.id in self._active_ids:
            # two live requests with one id would share a fold_in RNG
            # stream and collide in the event stream
            raise ValueError(
                f"request id {request.id} is already pending or in flight; "
                "ids must be unique among live requests")
        if request.id is None:
            request.id = self._next_id
        self._next_id = max(self._next_id, request.id) + 1
        self._active_ids.add(request.id)
        self._submitted[request.id] = (time.monotonic(), tick)
        self.pending.append(request)
        return request.id

    def abort_pending(self, rid: int) -> Optional[Request]:
        """Remove a still-queued request; returns it, or None if `rid`
        isn't in the queue. Drops its id and submit bookkeeping."""
        for i, req in enumerate(self.pending):
            if req.id == rid:
                self.pending.pop(i)
                self._active_ids.discard(rid)
                self._submitted.pop(rid, None)
                return req
        return None

    def find_slot(self, rid: int) -> Optional[Tuple[int, SlotState]]:
        for b, slot in enumerate(self.slots):
            if slot is not None and slot.request.id == rid:
                return b, slot
        return None

    def has_work(self) -> bool:
        return bool(self.pending) or any(s is not None for s in self.slots)

    # -- paged block allocator ----------------------------------------------

    def _alloc_block(self) -> int:
        """Claim an unreferenced physical block: pop the free list, or
        evict the LRU cached-but-unheld prefix block. Unreachable under
        reservation admission unless the pool is fully committed AND the
        prefix cache holds nothing evictable — which reservation rules
        out (an admitted request's worst case is always covered by free
        plus evictable blocks)."""
        if self._free:
            blk = self._pop_free()
        else:
            blk = (self._prefix.evict_lru(lambda b: self._ref[b] == 0)
                   if self._prefix is not None else None)
            if blk is None:
                raise RuntimeError("KV block pool exhausted mid-flight")
            self._cached_unheld -= 1     # the evicted entry was unheld
        # peak CONCURRENT demand (what to size kv_blocks from): blocks
        # held by in-flight requests plus this one — cached-but-unheld
        # residency is reclaimable and must not inflate the high-water
        # mark, so it is subtracted back out. `_cached_unheld` is
        # maintained incrementally (ref 0<->1 transitions, evictions):
        # this hot path never scans the cache.
        in_use = (self.num_blocks - len(self._free) - self._cached_unheld)
        self.peak_blocks_used = max(self.peak_blocks_used, in_use)
        return blk

    def _shard_of(self, blk: int) -> int:
        """Which pool shard holds block `blk` (contiguous id ranges)."""
        return blk // (self.num_blocks // self.block_shards)

    def _pop_free(self) -> int:
        """Pop a free block, round-robining the preferred shard when the
        pool is partitioned. Scans from the tail so the single-shard case
        degenerates to exactly the historical `_free.pop()` (LIFO reuse
        keeps recently-touched blocks hot); if the preferred shard has no
        free block the plain pop serves — preference never blocks
        allocation."""
        if self.block_shards == 1:
            return self._free.pop()
        want = self._next_shard
        self._next_shard = (want + 1) % self.block_shards
        for i in range(len(self._free) - 1, -1, -1):
            if self._shard_of(self._free[i]) == want:
                return self._free.pop(i)
        return self._free.pop()

    def _unref(self, blk: int):
        """Drop one slot's hold on `blk`; recycle it only when no slot
        references it AND it doesn't back a prefix-cache entry (cached
        blocks stay resident, evictable LRU when allocation needs them)."""
        self._ref[blk] -= 1
        if self._ref[blk] == 0:
            if self._prefix is not None and self._prefix.holds(blk):
                self._cached_unheld += 1     # stays resident, evictable
            else:
                self._free.append(blk)

    def _match_prefix(self, b: int, slot: SlotState, executor) -> int:
        """Point slot b's table at the longest cached block-aligned prefix
        of its prompt; returns the starting prefill position (0 = cold).
        A full-prompt match still recomputes the final token (sampling
        needs its logits), which appends into the last matched block —
        that block is forked copy-on-write (via `executor.fork_block`) so
        the cached KV and any other holder stay bit-identical."""
        slot.prefix_keys = self._prefix.block_keys(slot.request.prompt)
        blocks = self._prefix.match(slot.prefix_keys)
        if not blocks:
            return 0
        bs = self.kv_block_size
        matched = len(blocks) * bs
        start = min(matched, slot.prompt_len - 1)
        for i, blk in enumerate(blocks):
            if self._ref[blk] == 0:
                self._cached_unheld -= 1     # cached block gains a holder
            self._ref[blk] += 1
            executor.write_table(b, i, blk)
            slot.blocks.append(blk)
        if start < matched:
            # copy-on-write fork: our ref on src keeps it un-evictable
            # while the replacement block is claimed
            src = blocks[-1]
            dst = self._alloc_block()
            executor.fork_block(src, dst)
            self._ref[dst] += 1
            self._unref(src)
            slot.blocks[-1] = dst
            executor.write_table(b, len(blocks) - 1, dst)
        slot.prefix_hit = start
        slot.registered = len(blocks)     # shared blocks are already cached
        self.prefix_tokens_reused += start
        return start

    def register_prefix_blocks(self, b: int):
        """Offer slot b's newly completed full prompt blocks to the cache
        (first writer wins; losers keep their private copy)."""
        if self._prefix is None:
            return
        slot = self.slots[b]
        full = min(slot.cache_len, slot.prompt_len) // self.kv_block_size
        for i in range(slot.registered, full):
            self._prefix.insert(slot.prefix_keys[i], slot.blocks[i])
        slot.registered = max(slot.registered, full)

    # -- admission / release -------------------------------------------------

    def admit(self, tick: int, executor) -> List[Tuple[int, SlotState]]:
        """Fill free slots from the pending queue in policy order; applies
        mirror writes through `executor` and returns the (row, slot)
        admissions. No-skip: when the picked request's reservation doesn't
        fit the pool, admission stops for this tick."""
        admissions = []
        for b in range(self.max_slots):
            if self.slots[b] is not None or not self.pending:
                continue
            pick = self.policy.pick(self.pending)
            req = self.pending[pick]
            need = self.blocks_need(req)
            if self.paged and self._committed + need > self.num_blocks:
                # pool exhausted: the request queues (no head-of-line
                # skipping) until finished requests return enough blocks
                # for its worst case, which guarantees an admitted
                # request never stalls mid-flight waiting for a block
                break
            self.pending.pop(pick)
            slot = SlotState(req, tick, blocks_need=need)
            slot.submit_time, submit_tick = self._submitted.pop(req.id)
            wait = tick - submit_tick
            self.queue_wait_max = max(self.queue_wait_max, wait)
            self._queue_wait_sum += wait
            self._queue_wait_n += 1
            self.slots[b] = slot
            self._committed += need
            start = 0
            if self.paged:
                # hygiene: a fresh table row points at block 0 until
                # blocks are claimed (reads above the row's length are
                # masked either way)
                executor.reset_table_row(b)
                if self._prefix is not None:
                    start = self._match_prefix(b, slot, executor)
            # the row's position counter starts at the matched prefix
            # boundary (0 when cold); stale KV above a row's length is
            # masked per row, so the KV cache needs no zeroing
            slot.prefill_pos = start
            slot.cache_len = start
            executor.set_length(b, start)
            if self.has_ssm:
                # SSM state is a recurrent carry, not a masked window —
                # a reused slot must start from the zero state
                executor.reset_ssm_row(b)
            admissions.append((b, slot))
        return admissions

    def ensure_blocks(self, b: int, upto: int, executor):
        """Grow slot b's block table to cover logical positions [0, upto):
        claim blocks and write them through the executor's host table
        mirror (flushed once per tick)."""
        if not self.paged:
            return
        slot = self.slots[b]
        need = -(-upto // self.kv_block_size)
        while len(slot.blocks) < need:
            blk = self._alloc_block()
            self._ref[blk] += 1
            executor.write_table(b, len(slot.blocks), blk)
            slot.blocks.append(blk)

    def rollback(self, b: int, new_len: int, executor):
        """Truncate slot b's KV back to `new_len` logical positions:
        shrink the length mirror and return every block past the new
        boundary to the pool. Speculative decode uses this to discard a
        rejected draft suffix. The popped blocks are always
        generation-written and generated blocks are never offered to the
        prefix cache (`register_prefix_blocks` stops at the prompt), so
        each must be privately held by this slot alone — asserted,
        because unwinding a *shared* block here would corrupt another
        slot's KV. Positions in [new_len, old_len) inside the surviving
        tail block are stale, which is fine: reads above a row's length
        are masked, and the next write at position new_len overwrites in
        place."""
        slot = self.slots[b]
        assert 0 < new_len <= slot.cache_len, (new_len, slot.cache_len)
        slot.cache_len = new_len
        executor.set_length(b, new_len)
        if not self.paged:
            return
        keep = -(-new_len // self.kv_block_size)
        while len(slot.blocks) > keep:
            blk = slot.blocks.pop()
            assert self._ref[blk] == 1 and not (
                self._prefix is not None and self._prefix.holds(blk)), (
                "speculative rollback popped a shared/cached block")
            executor.clear_table_entry(b, len(slot.blocks))
            self._unref(blk)

    def release(self, b: int, executor=None):
        """Free slot b (EOS / length / abort): refcounted block return —
        a block reaches the free list only when no slot holds it and it
        backs no prefix-cache entry — and drop the request id. Length
        finishes release at DISPATCH time (the host predicts them from
        the scheduled count), which keeps overlapped admission timing
        identical to the sync loop; any still-in-flight device work for
        the row lands before the next occupant's writes in dispatch
        order, so the stale KV is overwritten-or-masked as usual.

        When `executor` is given, the freed row's device mirrors are
        reset (length -> 0, table row -> sentinel) so a dead row attends
        over NOTHING until re-admitted. This is a correctness point, not
        hygiene: activation quantization uses a per-tensor dynamic scale
        (max|x| over the whole batch), so a dead row left gathering
        whatever now occupies its released — possibly recycled — pool
        blocks feeds allocation-order-dependent garbage into every live
        row's quantization grid. Resetting the mirrors makes decode
        output a function of the LIVE batch only, independent of
        physical block-id assignment (which tensor-parallel round-robin
        allocation deliberately perturbs)."""
        slot = self.slots[b]
        if self.paged:
            for blk in slot.blocks:
                self._unref(blk)
        if executor is not None:
            executor.set_length(b, 0)
            if self.paged:
                executor.reset_table_row(b)
        self._committed -= slot.blocks_need
        self._active_ids.discard(slot.request.id)
        slot.released = True
        self.slots[b] = None

    # -- introspection -------------------------------------------------------

    def check_invariants(self):
        """Allocator/accounting consistency — every physical block is in
        exactly one of: free list, held by >=1 slot, cached-but-unheld.
        Raises AssertionError on drift (tests call this after every
        tick, including overlapped ticks with drains in flight)."""
        assert self._committed == sum(
            s.blocks_need for s in self.slots if s is not None), (
            "committed_blocks drifted from in-flight reservations: "
            f"{self._committed} vs slot sum")
        live = {s.request.id for s in self.slots if s is not None}
        live |= {r.id for r in self.pending}
        assert live == self._active_ids, (
            f"active-id drift: {self._active_ids} vs live {live}")
        assert set(self._submitted) == {r.id for r in self.pending}, (
            "_submitted entries must track exactly the pending queue "
            f"(leak?): {sorted(self._submitted)} vs pending")
        if not self.paged:
            return
        held = int(np.sum(self._ref > 0))
        scanned = (sum(1 for blk in self._prefix.blocks()
                       if self._ref[blk] == 0)
                   if self._prefix is not None else 0)
        assert scanned == self._cached_unheld, (
            f"cached-unheld counter drift: counter={self._cached_unheld} "
            f"vs scan={scanned}")
        free = len(self._free)
        assert free + held + self._cached_unheld == self.num_blocks, (
            f"block ledger drift: free={free} held={held} "
            f"cached={self._cached_unheld} != pool {self.num_blocks}")
        # cross-checks: refcounts match slot holdings; free blocks are
        # unreferenced and uncached
        holds = np.zeros((self.num_blocks,), np.int32)
        for s in self.slots:
            if s is not None:
                for blk in s.blocks:
                    holds[blk] += 1
        assert np.array_equal(holds, self._ref), "refcount drift"
        for blk in self._free:
            assert self._ref[blk] == 0, f"free block {blk} still referenced"
            assert self._prefix is None or not self._prefix.holds(blk), (
                f"free block {blk} still backs a prefix-cache entry")

    def stats(self) -> dict:
        st = {"pending_requests": len(self.pending),
              "queue_wait_ticks_max": self.queue_wait_max,
              "queue_wait_ticks_mean": (self._queue_wait_sum
                                        / max(self._queue_wait_n, 1)),
              "scheduler_policy": self.policy.name,
              "committed_blocks": self._committed,
              "prefix_tokens_reused": self.prefix_tokens_reused,
              "tier": self.tier}
        if self.paged:
            st["kv_blocks"] = self.num_blocks
            st["kv_block_size"] = self.kv_block_size
            st["peak_blocks_used"] = self.peak_blocks_used
            st["free_blocks"] = len(self._free)
            st["held_blocks"] = int(np.sum(self._ref > 0))
            st["cached_blocks"] = self._cached_unheld
        if self._prefix is not None:
            st["prefix_cache"] = self._prefix.stats()
        return st
