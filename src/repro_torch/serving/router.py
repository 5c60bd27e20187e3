"""Data-parallel multi-engine router: one admission queue over N engines.

`EngineRouter` owns a single admission queue and fans requests out across
N independent `ServingEngine` replicas, each with its own slot pool and
paged block pool, all on the one card and all sharing one `seed`.

Routing policy is pluggable:

  * `round-robin` — next replica in the candidate class per request.
    Always dispatches immediately.
  * `least-loaded` — fewest live requests (occupied slots + replica
    queue), ties to the lowest index. Holds requests at the router while
    every candidate replica is saturated.
  * `prefix-affinity` — requests whose prompt shares a chain-hashed
    block prefix (the chain hash of `serving/prefix_cache.py`) steer to
    the replica that holds those blocks (each replica's `prefix_peek`, a
    read-only probe of its prefix cache) or, for prefixes routed but not
    yet cached, was last given them (a router-side sticky map), bounded
    by `stickiness`: when the affinity replica's load runs more than
    `stickiness` requests ahead of the least-loaded one, the request
    spills there and re-sticks.
  * `tiered` — least-loaded placement within the precision-tier class
    picked per request (requires `tiers`).

**Precision tiers** (`tiers=['fxp8', 'fxp16']`): replica i runs the
`PrecisionPolicy` of ladder tier `tiers[i]` (`core.tiers.TIERS`), all
serving from one shared `TieredWeights` bank. A `TierPolicy` picks each
request's tier before the routing policy picks a replica inside that
class: an explicit `Request.tier` pin is honored unconditionally,
`priority > 0` takes the best (most accurate) tier, `priority < 0` the
cheapest, and `priority == 0` walks best -> cheapest taking the first tier
whose queue pressure — (class live load + 1) / class slot capacity —
clears `tier_threshold` (1.0: degrade exactly when the better tier would
have to queue the request). Placement across tiers changes numerics by
design, so a pin is a hard contract: the tier a request lands on is
stamped on every `RequestOutput`, and a pinned request is never degraded.
Within a tier, an all-pinned stream gives the replica the batch
composition a single engine at that tier would see, so its tokens equal
that engine's (the per-tensor activation scales depend on the batch).

**Speculative decoding** (`spec_decode='fxp4:bf16'`): replicas serving
the verify tier are built as `SpecDecodeCoordinator`s: a hidden
cheap-tier draft engine proposes k tokens a round and the verify-tier
engine scores them in one chunked dispatch, emitting the verify tier's
greedy stream (see `serving/speculative.py`). With `tiers`, only the
verify-tier class turns speculative (its draft codes ride the same
`TieredWeights` bank); every other class keeps plain replicas. On an
untiered fleet every replica becomes a coordinator. Acceptance is
defined against the verifier's argmax, so a speculative fleet is
greedy-only: `submit` rejects sampled requests up front.

The router exposes the surface of a single engine — `submit`, `step`,
`events`, `stream`, `abort`, `run` — with one merged tick driving every
replica, and `stats()` aggregates fleet totals plus `per_engine` and
per-tier breakdowns.
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.precision import tier_policy as make_tier_policy
from ..core.qtensor import TieredWeights
from ..core.tiers import tier_index
from .api import FinishedRequest, Request, RequestOutput
from .engine import ServingEngine
from .prefix_cache import PrefixCache
from .speculative import SpecDecodeCoordinator

__all__ = ["EngineRouter", "RoutingPolicy", "RoundRobin", "LeastLoaded",
           "Tiered", "PrefixAffinity", "ROUTING_POLICIES",
           "make_routing_policy", "TierPolicy"]


class RoutingPolicy:
    """Pluggable placement policy: picks the replica index for the next
    request from `candidates` (the replica indices of the request's tier
    class; the whole fleet when untiered). `holds_when_saturated` lets a
    policy keep the head of the router queue un-dispatched while every
    candidate is at capacity (occupied slots + replica queue >=
    max_slots), so the first freed slot in the class serves it."""

    name = "round-robin"
    holds_when_saturated = False

    def pick(self, router: "EngineRouter", request: Request,
             loads: List[int], candidates: Sequence[int]) -> int:
        raise NotImplementedError


class RoundRobin(RoutingPolicy):
    """Next candidate replica per request — the classic data-parallel
    front, rotating independently per candidate class. Dispatches
    unconditionally; replicas queue internally."""

    name = "round-robin"

    def __init__(self):
        self._next: Dict[tuple, int] = {}

    def pick(self, router, request, loads, candidates):
        key = tuple(candidates)
        i = self._next.get(key, 0)
        self._next[key] = (i + 1) % len(candidates)
        return candidates[i]


class LeastLoaded(RoutingPolicy):
    """Fewest live requests wins, ties to the lowest replica index.
    Holds at the router when the whole candidate class is saturated."""

    name = "least-loaded"
    holds_when_saturated = True

    def pick(self, router, request, loads, candidates):
        return min(candidates, key=lambda i: (loads[i], i))


class Tiered(LeastLoaded):
    """The canonical heterogeneous-fleet policy: `TierPolicy` picks the
    tier class, then least-loaded picks the replica inside it. Requires
    the router to be constructed with `tiers`."""

    name = "tiered"


class PrefixAffinity(RoutingPolicy):
    """Steer shared-prefix requests to the candidate replica already
    holding their chain-hashed prompt blocks; fall back to least-loaded,
    bounded by `stickiness` (max load lead the affinity replica may have
    before the request spills — and re-sticks its prefix — elsewhere).
    Probes and sticky entries are scoped to the candidate class, so
    affinity only ever sticks within a tier."""

    name = "prefix-affinity"
    holds_when_saturated = True

    def __init__(self, stickiness: int = 4):
        if stickiness < 0:
            raise ValueError("stickiness must be >= 0")
        self.stickiness = stickiness
        self.affinity_hits = 0       # dispatches that followed affinity
        self.affinity_spills = 0     # affinity overridden by the bound

    def pick(self, router, request, loads, candidates):
        lo = min(candidates, key=lambda i: (loads[i], i))
        keys = router._chain_keys(request.prompt)
        # sticky entries key on (prefix, candidate class): one prefix may
        # legitimately be hot on a replica of EVERY tier it is pinned to
        skey = (keys[0], tuple(candidates)) if keys else None
        # deepest cached match wins (ties to the lowest index); the probe
        # is PrefixCache.peek — read-only, no LRU/stat perturbation
        aff, depth = None, 0
        for i in candidates:
            d = router.engines[i].prefix_peek(keys)
            if d > depth:
                aff, depth = i, d
        if aff is None and skey is not None:
            # routed-but-not-yet-cached prefixes (prefill still running,
            # or contiguous replicas with no prefix cache at all)
            aff = router._sticky.get(skey)
        if aff is not None:
            if loads[aff] - loads[lo] <= self.stickiness:
                self.affinity_hits += 1
                target = aff
            else:
                self.affinity_spills += 1
                target = lo
        else:
            target = lo
        if skey is not None:
            router._sticky[skey] = target
        return target


ROUTING_POLICIES = {
    "round-robin": RoundRobin,
    "least-loaded": LeastLoaded,
    "prefix-affinity": PrefixAffinity,
    "tiered": Tiered,
}


def make_routing_policy(policy: Union[str, RoutingPolicy],
                        stickiness: Optional[int] = None) -> RoutingPolicy:
    if isinstance(policy, RoutingPolicy):
        return policy
    if policy not in ROUTING_POLICIES:
        raise ValueError(f"unknown routing policy {policy!r}; choose from "
                         f"{sorted(ROUTING_POLICIES)}")
    if policy == "prefix-affinity" and stickiness is not None:
        return PrefixAffinity(stickiness=stickiness)
    return ROUTING_POLICIES[policy]()


class TierPolicy:
    """Per-request precision-tier selection for a heterogeneous fleet.

    `pick()` is pure (safe to re-evaluate while the head of the queue is
    held); the router calls `note()` once per ACTUAL placement so the
    pinned/degraded counters never double-count a hold-retry.

      * explicit `Request.tier` — honored unconditionally (the router
        validated fleet support at submit).
      * `priority > 0` — the best (most accurate) served tier, always.
      * `priority < 0` — the cheapest tier, always.
      * `priority == 0` — best -> cheapest walk, first tier whose
        pressure clears `threshold`; cheapest if nothing does. Pressure
        is (class live load + 1) / class slot capacity — "+1" counts the
        request being placed, live load counts replica queues — so
        threshold 1.0 degrades exactly when the tier would queue it.
    """

    def __init__(self, ladder: Sequence[str], threshold: float = 1.0):
        if not ladder:
            raise ValueError("TierPolicy needs at least one served tier")
        if threshold <= 0:
            raise ValueError("tier_threshold must be > 0")
        # cheap -> best, the global ladder order
        self.ladder = sorted(dict.fromkeys(ladder), key=tier_index)
        self.threshold = threshold
        self.pinned = 0          # placements that honored an explicit pin
        self.degraded = 0        # priority-0 placements pushed off best
        self.placed = {t: 0 for t in self.ladder}

    @property
    def best(self) -> str:
        return self.ladder[-1]

    @property
    def cheapest(self) -> str:
        return self.ladder[0]

    def pick(self, request: Request, pressures: Dict[str, float]) -> str:
        if request.tier is not None:
            return request.tier
        if request.priority > 0:
            return self.best
        if request.priority < 0:
            return self.cheapest
        for t in reversed(self.ladder):
            if pressures[t] <= self.threshold:
                return t
        return self.cheapest

    def note(self, request: Request, tier: str):
        """Record an actual placement (called once per dispatch)."""
        self.placed[tier] += 1
        if request.tier is not None:
            self.pinned += 1
        elif request.priority == 0 and tier != self.best:
            self.degraded += 1


def _check_bank(weights: TieredWeights, tiers):
    for t in tiers:
        if t not in weights:
            raise ValueError(
                f"tier {t!r} has no bank in the supplied TieredWeights "
                f"(has {list(weights.tier_names)})")


class EngineRouter:
    """Single admission queue fanning out over N `ServingEngine` replicas.

        router = EngineRouter(cfg, params, tiers=["fxp8", "fxp16"],
                              routing="tiered", backend="kernels",
                              max_slots=4, max_len=256, kv_block_size=16)
        router.submit(Request(prompt=[1, 2, 3], max_new_tokens=8))
        for out in router.events():
            ...

    Heterogeneous fleet: `tiers` (one ladder name per replica; it
    overrides `engines`) derives each replica's policy with
    `core.precision.tier_policy(t, backend)` and its weights from a shared
    `TieredWeights` (built from `params` when a plain tree is passed).
    Untiered fleets share one `params` tree. Engine keywords (`max_len`,
    `prefill_chunk`, `kv_blocks`, `scheduler`, `overlap`, `device`, and
    `policy` when untiered) apply to every replica; `seed` is shared, so
    placement never changes a sampled request's draws.

    Speculative fleet: `spec_decode="draft:verify"` (and `spec_k`) builds
    the verify-tier replicas as `SpecDecodeCoordinator`s over the same
    bank (every replica, when untiered). Greedy requests only."""

    def __init__(self, cfg, params, *, engines: int = 2,
                 routing: Union[str, RoutingPolicy] = "least-loaded",
                 stickiness: Optional[int] = None, max_slots: int = 4,
                 kv_block_size: Optional[int] = None,
                 tiers: Optional[Sequence[str]] = None,
                 tier_threshold: float = 1.0, backend: str = "reference",
                 spec_decode: Optional[str] = None, spec_k: int = 4,
                 **engine_kw):
        self.routing = make_routing_policy(routing, stickiness=stickiness)
        self.spec_decode: Optional[tuple] = None
        self.spec_k = spec_k
        if spec_decode is not None:
            draft, _, verify = spec_decode.partition(":")
            if not draft or not verify:
                raise ValueError(
                    f"spec_decode must be 'draft:verify' (ladder tier "
                    f"names), got {spec_decode!r}")
            if tier_index(draft) >= tier_index(verify):
                raise ValueError(
                    f"spec_decode draft tier {draft!r} must sit below the "
                    f"verify tier {verify!r} on the ladder: a draft at or "
                    "above the verifier's precision has nothing to "
                    "accelerate")
            self.spec_decode = (draft, verify)

        def spec_coordinator(weights, verify_t):
            d, _ = self.spec_decode
            return SpecDecodeCoordinator(
                cfg, weights.for_tier(d), weights.for_tier(verify_t),
                draft_policy=make_tier_policy(d, backend=backend),
                verify_policy=make_tier_policy(verify_t, backend=backend),
                k=spec_k, max_slots=max_slots,
                kv_block_size=kv_block_size, **engine_kw)

        if tiers is not None:
            if "policy" in engine_kw:
                raise ValueError(
                    "pass either tiers (per-replica policies derive from "
                    "the ladder) or policy, not both")
            if not tiers:
                raise ValueError("tiers must name at least one replica")
            for t in tiers:
                tier_index(t)                # unknown tier -> ValueError
            bank_tiers = list(tiers) + list(self.spec_decode or ())
            weights = (params if isinstance(params, TieredWeights)
                       else TieredWeights(params, bank_tiers))
            _check_bank(weights, bank_tiers)
            if self.spec_decode and self.spec_decode[1] not in tiers:
                raise ValueError(
                    f"spec_decode verify tier {self.spec_decode[1]!r} has "
                    f"no replica in this fleet (tiers={list(tiers)}); the "
                    "speculative pair accelerates the verify-tier class")
            self.tiered_weights: Optional[TieredWeights] = weights
            self.engines = [
                spec_coordinator(weights, t)
                if self.spec_decode and t == self.spec_decode[1]
                else ServingEngine(
                    cfg, weights.for_tier(t),
                    policy=make_tier_policy(t, backend=backend),
                    max_slots=max_slots, kv_block_size=kv_block_size,
                    **engine_kw)
                for t in tiers]
        else:
            if isinstance(self.routing, Tiered):
                raise ValueError(
                    "routing='tiered' requires a heterogeneous fleet: "
                    "pass tiers=['fxp8', 'fxp16', ...]")
            if engines < 1:
                raise ValueError("engines must be >= 1")
            if self.spec_decode is not None:
                if "policy" in engine_kw:
                    raise ValueError(
                        "pass either spec_decode (per-side policies "
                        "derive from the tier pair) or policy, not both")
                weights = (params if isinstance(params, TieredWeights)
                           else TieredWeights(params, self.spec_decode))
                _check_bank(weights, self.spec_decode)
                self.tiered_weights = weights
                self.engines = [spec_coordinator(weights, self.spec_decode[1])
                                for _ in range(engines)]
            else:
                self.tiered_weights = None
                self.engines = [
                    ServingEngine(cfg, params, max_slots=max_slots,
                                  kv_block_size=kv_block_size, **engine_kw)
                    for _ in range(engines)]
        self.max_slots = max_slots
        # tier class map: ladder tier -> replica indices serving it (an
        # untiered fleet lands here too, so explicit pins still route)
        self._tier_members: Dict[str, List[int]] = {}
        for i, eng in enumerate(self.engines):
            if eng.tier is not None:
                self._tier_members.setdefault(eng.tier, []).append(i)
        self.tier_policy = (TierPolicy(list(self._tier_members),
                                       threshold=tier_threshold)
                            if tiers is not None else None)
        self._keyer = PrefixCache(kv_block_size or 16)
        self._sticky: Dict[tuple, int] = {}
        self.pending: deque = deque()        # the single admission queue
        self._placement: Dict[int, int] = {}  # live rid -> replica index
        self._active_ids: set = set()        # router queue + placed
        self._next_id = 0
        self._out_buffer: deque = deque()
        self.tick = 0
        self.dispatched = [0] * len(self.engines)
        self.aborted_requests = 0

    # -- affinity keying -----------------------------------------------------

    def _chain_keys(self, prompt) -> List[str]:
        """Chain keys of the prompt's full blocks (the prefix-cache hash);
        a prompt shorter than one block keys on its whole content."""
        keys = self._keyer.block_keys(prompt)
        if keys:
            return keys
        arr = np.asarray(prompt)
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int64, copy=False)
        return [hashlib.sha1(arr.tobytes()).hexdigest()]

    # -- tier accounting -----------------------------------------------------

    @property
    def served_tiers(self) -> List[str]:
        """Ladder tiers this fleet serves, cheap -> best."""
        return sorted(self._tier_members, key=tier_index)

    def tier_loads(self) -> Dict[str, dict]:
        """Per-tier-class live load, slot capacity and admission pressure
        (what `TierPolicy` degrades on)."""
        out = {}
        for t, members in self._tier_members.items():
            load = sum(self.engines[i].load for i in members)
            cap = self.max_slots * len(members)
            out[t] = {"load": load, "capacity": cap,
                      "pressure": (load + 1) / cap}
        return out

    def _candidates(self, request: Request):
        """(tier, replica indices) the routing policy may place `request`
        on; tier selection re-reads the queue pressure on every call."""
        if self.tier_policy is not None:
            pressures = {t: v["pressure"]
                         for t, v in self.tier_loads().items()}
            tier = self.tier_policy.pick(request, pressures)
            return tier, self._tier_members[tier]
        if request.tier is not None:
            return request.tier, self._tier_members[request.tier]
        return None, list(range(len(self.engines)))

    # -- request lifecycle ---------------------------------------------------

    def submit(self, request: Request) -> int:
        """Validate against the replica geometry and the fleet's served
        tiers, assign a router-unique id and queue. Every check runs
        before any state changes, and ids are unique across the fleet."""
        if self.spec_decode is not None:
            s = request.sampling
            if s.temperature > 0.0 or s.top_k > 0:
                raise ValueError(
                    "a spec_decode fleet serves greedy requests only "
                    "(temperature<=0, top_k==0): speculative acceptance "
                    "is defined against the verifier's argmax, and tier "
                    "selection must never decide whether a request may "
                    "sample")
        self.engines[0].sched.validate(request, check_tier=False)
        if request.tier is not None:
            tier_index(request.tier)         # unknown name -> ValueError
            if request.tier not in self._tier_members:
                raise ValueError(
                    f"request pinned to tier {request.tier!r} but this "
                    f"fleet serves {self.served_tiers}; add a replica at "
                    "that tier or drop the pin")
        if request.id is not None and request.id in self._active_ids:
            raise ValueError(
                f"request id {request.id} is already pending or in flight "
                "on this router; ids must be unique among live requests")
        if request.id is None:
            request.id = self._next_id
        self._next_id = max(self._next_id, request.id) + 1
        self._active_ids.add(request.id)
        self.pending.append(request)
        return request.id

    def abort(self, rid: int) -> bool:
        """Abort wherever the request lives: queued at the router (the
        terminal event comes from here) or on a replica (delegated).
        False for unknown or finished ids."""
        for i, req in enumerate(self.pending):
            if req.id == rid:
                del self.pending[i]
                self._active_ids.discard(rid)
                self.aborted_requests += 1
                self._out_buffer.append(RequestOutput(
                    id=rid, new_tokens=[], tokens=[],
                    prompt_len=len(req.prompt), tick=self.tick,
                    finished=True, finish_reason="aborted",
                    prompt=req.prompt, tier=req.tier))
                return True
        eng_i = self._placement.get(rid)
        if eng_i is None:
            return False
        if self.engines[eng_i].abort(rid):
            self._placement.pop(rid, None)
            self._active_ids.discard(rid)
            return True
        return False

    def has_work(self) -> bool:
        return (bool(self.pending) or bool(self._out_buffer)
                or any(e.has_work() for e in self.engines))

    # -- the merged tick loop ------------------------------------------------

    def _dispatch(self):
        """Drain the admission queue through tier selection and the
        routing policy, FIFO without skipping: the head is placed (or
        held) before anything behind it."""
        while self.pending:
            req = self.pending[0]
            tier, candidates = self._candidates(req)
            loads = [e.load for e in self.engines]
            if (self.routing.holds_when_saturated
                    and min(loads[i] for i in candidates) >= self.max_slots):
                break        # candidate class saturated: hold at the router
            self.pending.popleft()
            target = self.routing.pick(self, req, loads, candidates)
            if target not in candidates:
                raise RuntimeError(
                    f"routing policy {self.routing.name} left the tier "
                    f"class: {target} not in {candidates}")
            if self.tier_policy is not None:
                self.tier_policy.note(req, tier)
            self.engines[target].submit(req)
            self._placement[req.id] = target
            self.dispatched[target] += 1

    def step(self) -> List[RequestOutput]:
        """One router tick: route queued requests, then one tick of every
        replica with work; returns the merged events."""
        events: List[RequestOutput] = list(self._out_buffer)
        self._out_buffer.clear()
        self._dispatch()
        for eng in self.engines:
            if eng.has_work():
                events.extend(eng.step())
        for out in events:
            if out.finished:
                self._placement.pop(out.id, None)
                self._active_ids.discard(out.id)
        self.tick += 1
        return events

    # -- output streams ------------------------------------------------------

    def events(self):
        """Run router ticks until idle, yielding every replica's events."""
        while self.has_work():
            yield from self.step()

    def stream(self, request: Request):
        """Submit `request` and yield its events; other requests' events
        stay buffered for `events()`."""
        rid = self.submit(request)
        while self.has_work():
            outs = self.step()
            mine = [o for o in outs if o.id == rid]
            self._out_buffer.extend(o for o in outs if o.id != rid)
            for out in mine:
                yield out
                if out.finished:
                    return
            if not mine and not (self.pending
                                 or any(e.has_work() for e in self.engines)):
                return

    def run(self, requests: Optional[List[Request]] = None
            ) -> List[FinishedRequest]:
        """Completion-only view, as `ServingEngine.run()`."""
        for r in requests or ():
            self.submit(r)
        done = [out.to_finished() for out in self.events() if out.finished]
        return sorted(done, key=lambda f: f.id)

    # -- introspection -------------------------------------------------------

    def check_invariants(self):
        """Every replica's block ledger audits clean; queued + placed ids
        equal the live ids; every live pinned request sits on a replica
        of its tier."""
        for eng in self.engines:
            eng.check_invariants()
        queued = {r.id for r in self.pending}
        assert queued | set(self._placement) == self._active_ids, (
            f"router id drift: queued {sorted(queued)} + placed "
            f"{sorted(self._placement)} != active "
            f"{sorted(self._active_ids)}")
        assert not (queued & set(self._placement)), (
            "a request is both queued at the router and placed on a "
            f"replica: {sorted(queued & set(self._placement))}")
        for rid, i in self._placement.items():
            assert 0 <= i < len(self.engines), (rid, i)
        for eng in self.engines:
            for holder in list(eng.sched.pending) + [
                    s.request for s in eng.sched.slots if s is not None]:
                assert holder.tier is None or holder.tier == eng.tier, (
                    f"tier pin broken: request {holder.id} pinned to "
                    f"{holder.tier!r} is live on a {eng.tier!r} replica")
        if self.tier_policy is not None:
            assert sum(self.tier_policy.placed.values()) == sum(
                self.dispatched), "tier placement counter drift"

    def stats(self) -> dict:
        """Fleet totals plus `per_engine` and per-tier breakdowns
        (`slot_utilization` weighted by each replica's slot-ticks;
        `prefix_hit_rate` the prompt tokens a replica served from its
        prefix cache over the prompt tokens it processed)."""
        per = [e.stats() for e in self.engines]
        busy = sum(e.busy_slot_ticks for e in self.engines)
        total = sum(e.total_slot_ticks for e in self.engines)
        st = {
            "engines": len(self.engines),
            "routing_policy": self.routing.name,
            "ticks": self.tick,
            "pending_requests": len(self.pending),
            "dispatched": list(self.dispatched),
            "aborted_requests": (self.aborted_requests
                                 + sum(s["aborted_requests"] for s in per)),
            "prompt_tokens": sum(s["prompt_tokens"] for s in per),
            "generated_tokens": sum(s["generated_tokens"] for s in per),
            "prefill_tokens_computed": sum(s["prefill_tokens_computed"]
                                           for s in per),
            "prefix_tokens_reused": sum(s["prefix_tokens_reused"]
                                        for s in per),
            "slot_utilization": busy / max(total, 1),
        }
        if isinstance(self.routing, PrefixAffinity):
            routed = self.routing.affinity_hits + self.routing.affinity_spills
            st["affinity_hits"] = self.routing.affinity_hits
            st["affinity_spills"] = self.routing.affinity_spills
            st["affinity_hit_rate"] = (self.routing.affinity_hits
                                       / max(sum(self.dispatched), 1))
            st["affinity_spill_rate"] = (self.routing.affinity_spills
                                         / max(routed, 1))
        st["tiers"] = [e.tier for e in self.engines]
        if self.spec_decode is not None:
            proposed = sum(s.get("spec_proposed", 0) for s in per)
            accepted = sum(s.get("spec_accepted", 0) for s in per)
            st["spec_decode"] = ":".join(self.spec_decode)
            st["spec_k"] = self.spec_k
            st["spec_proposed"] = proposed
            st["spec_accepted"] = accepted
            st["spec_acceptance_rate"] = accepted / max(proposed, 1)
            st["spec_verify_steps"] = sum(s.get("spec_verify_steps", 0)
                                          for s in per)
            st["spec_rolled_back"] = sum(s.get("spec_rolled_back", 0)
                                         for s in per)
        if self.tier_policy is not None:
            st["tier_threshold"] = self.tier_policy.threshold
            st["tier_pinned"] = self.tier_policy.pinned
            st["tier_degraded"] = self.tier_policy.degraded
            st["tier_placed"] = dict(self.tier_policy.placed)
            st["tier_loads"] = self.tier_loads()
        st["per_engine"] = [{
            "tier": self.engines[i].tier,
            "queue_depth": s["pending_requests"],
            "slot_utilization": s["slot_utilization"],
            "prompt_tokens": s["prompt_tokens"],
            "generated_tokens": s["generated_tokens"],
            "prefill_tokens_computed": s["prefill_tokens_computed"],
            "prefix_hit_rate": (s["prefix_tokens_reused"]
                                / max(s["prompt_tokens"], 1)),
            "dispatched": self.dispatched[i],
        } for i, s in enumerate(per)]
        return st
