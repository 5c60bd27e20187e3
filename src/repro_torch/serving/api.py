"""Public request/response types of the serving API.

The engine's output surface is the `RequestOutput` event stream: one event
per sampled token (`new_tokens` is that tick's delta, `tokens` the
cumulative generation) plus a terminal event with `finished=True` and a
`finish_reason`. `FinishedRequest` survives as a deprecated completion-only
view (`RequestOutput.to_finished()`); `ServingEngine.run()` still returns
it so completion-style callers keep working unchanged.

Nothing in this module touches torch — the types are shared by the pure-host
`Scheduler` and the device-owning `ModelExecutor` without dragging either
one's dependencies into the other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (temperature<=0 -> greedy)."""
    temperature: float = 0.0
    top_k: int = 0          # 0 -> no top-k filter


@dataclasses.dataclass
class Request:
    """One generation request. `prompt` is a [P] int token array/list (or
    [P, d_model] float embeds for embeds-mode archs).

    `tier` pins the request to a named precision tier of the serving
    ladder (`core.tiers.TIERS`: 'fxp4' | 'fxp8' | 'fxp16' | 'bf16');
    None lets the router's TierPolicy place it by `priority` and queue
    pressure. A pinned tier is a hard SLO: the scheduler rejects it when
    the engine/fleet doesn't serve that tier, and placement never
    silently degrades it. `priority` is the soft knob for unpinned
    requests: > 0 always takes the fleet's best (most accurate) tier,
    < 0 always the cheapest, 0 degrades under pressure."""
    prompt: Any
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    seed: Optional[int] = None      # None -> derived from engine seed + id
    id: Optional[int] = None        # assigned at submit() when None
    tier: Optional[str] = None      # explicit precision-tier pin
    priority: int = 0               # SLO class for unpinned placement


@dataclasses.dataclass
class FinishedRequest:
    """Deprecated completion-only view of a finished request — the pre-
    streaming API. New code should consume `RequestOutput` events; this
    remains the return type of `ServingEngine.run()`."""
    id: int
    prompt: Any
    tokens: List[int]               # generated tokens (incl. EOS if hit)
    finish_reason: str              # 'eos' | 'length' | 'aborted'
    prompt_len: int
    admitted_tick: int
    finished_tick: int
    prefix_hit_tokens: int = 0      # prompt tokens served from the cache
    ttft_s: float = 0.0         # submit -> first sampled token (monotonic)
    tier: Optional[str] = None  # precision tier the request was served at
    # speculative-decode counters (all zero when served non-speculatively)
    spec_proposed: int = 0      # draft tokens proposed for this request
    spec_accepted: int = 0      # draft tokens the verifier accepted
    spec_verify_steps: int = 0  # chunked verify dispatches consumed
    spec_rolled_back: int = 0   # rejected draft tokens rolled back from KV

    @property
    def spec_acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens (0.0 when not speculative)."""
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)


@dataclasses.dataclass
class RequestOutput:
    """One event in a request's output stream.

    A non-terminal event carries this tick's sampled token(s) in
    `new_tokens` (`tokens` is the cumulative generation so far). The
    terminal event has `finished=True`, a `finish_reason`, and the
    completion metadata (`ttft_s`, `prefix_hit_tokens`, tick bounds);
    an abort produces a terminal event with `finish_reason='aborted'`
    and whatever tokens had drained by then.
    """
    id: int
    new_tokens: List[int]
    tokens: List[int]
    prompt_len: int
    tick: int
    finished: bool = False
    finish_reason: Optional[str] = None   # 'eos' | 'length' | 'aborted'
    prompt: Any = None
    admitted_tick: int = -1
    prefix_hit_tokens: int = 0
    ttft_s: float = 0.0
    tier: Optional[str] = None    # precision tier of the serving engine
    # speculative-decode counters (populated on terminal events by the
    # SpecDecodeCoordinator; zero under plain engines/routers)
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_verify_steps: int = 0
    spec_rolled_back: int = 0

    @property
    def spec_acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens (0.0 when not speculative)."""
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

    def to_finished(self) -> FinishedRequest:
        """Deprecated-view conversion; only terminal events convert."""
        if not self.finished:
            raise ValueError("only a finished RequestOutput converts to "
                             "FinishedRequest")
        return FinishedRequest(
            id=self.id, prompt=self.prompt, tokens=self.tokens,
            finish_reason=self.finish_reason, prompt_len=self.prompt_len,
            admitted_tick=self.admitted_tick, finished_tick=self.tick,
            prefix_hit_tokens=self.prefix_hit_tokens, ttft_s=self.ttft_s,
            tier=self.tier, spec_proposed=self.spec_proposed,
            spec_accepted=self.spec_accepted,
            spec_verify_steps=self.spec_verify_steps,
            spec_rolled_back=self.spec_rolled_back)
