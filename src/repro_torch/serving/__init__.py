"""Continuous-batching serving: a pure-host `Scheduler` (admission, slot
and block policy), a device-owning `ModelExecutor` (cache, control-array
mirrors, on-device sampled-token feedback) and a thin `ServingEngine`
loop with sync and overlap-dispatch modes streaming `RequestOutput`
events; `EngineRouter` fans one admission queue out over several engines,
of one precision tier or of several (`TierPolicy`), and
`SpecDecodeCoordinator` pairs a cheap draft engine with a verify engine
(cross-tier speculative decoding)."""
from .api import FinishedRequest, Request, RequestOutput, SamplingParams
from .engine import ServingEngine
from .executor import ModelExecutor
from .prefix_cache import PrefixCache
from .router import EngineRouter, RoutingPolicy, TierPolicy
from .scheduler import (POLICIES, Scheduler, SchedulingPolicy,
                        ShortestPromptFirst)
from .speculative import SpecDecodeCoordinator

__all__ = ["Request", "RequestOutput", "FinishedRequest", "SamplingParams",
           "ServingEngine", "Scheduler", "SchedulingPolicy",
           "ShortestPromptFirst", "POLICIES", "ModelExecutor", "PrefixCache",
           "EngineRouter", "RoutingPolicy", "TierPolicy",
           "SpecDecodeCoordinator"]
