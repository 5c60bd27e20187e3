"""The named precision-tier ladder — serving's runtime view of Flex-PE's
precision_sel register.

The paper's whole pitch is ONE time-multiplexed datapath serving FxP4 /
FxP8 / FxP16 at 16x / 8x / 4x relative throughput, reconfigured at run
time; POLARON (the paper's sequel) turns that into a workload-driven
knob. This module names those operating points as serving *tiers* so the
router can place requests on a heterogeneous fleet (replicas pinned to
different `PrecisionPolicy` tiers) by SLO and queue pressure.

Each tier records the paper-derived facts placement decisions need:

  * `throughput_x` — Table I relative throughput of the datapath mode
    (the cost model: a cheaper tier is one with more SIMD lanes).
  * `hr_stages` / `lv_stages` — the CORDIC stage Pareto pick for the
    tier's bit width (`core.cordic.PARETO_STAGES`, paper §II-E Fig. 3).
  * `mae_bound` — ceiling on the measured Monte-Carlo MAE of any CORDIC
    AF (sigmoid/tanh/softmax) at that stage pick, normalised by the
    AF's output range. `cordic_excess_bound` is the paper's ≤2%
    accuracy-loss envelope applied to what the stage pick actually
    controls: the CORDIC approximation error IN EXCESS of the tier's
    pure output-quantization floor. `tests/test_precision_tiers.py`
    re-measures both against `core.pareto.af_error`, so the ladder is
    validated, not hand-asserted. (FxP4's raw MAE bound is wider than
    2% — at 4 bits the output grid itself costs ~3% — and its recorded
    excess bound is 3%: the 8-way softmax's quotients ~1/8 sit near the
    4-stage LV division resolution, so its CORDIC excess runs ~2.5%.
    The paper's 2% claim is end-network accuracy; sigmoid and tanh —
    the scalar AFs of its Fig. 3 Pareto study — hold the 2% excess
    envelope on EVERY tier, which the test asserts separately.)

This module is deliberately torch-free: the pure-host `serving.Scheduler`
validates request tiers and must keep importing nothing device-side.
`core.precision` re-exports the ladder next to `PrecisionPolicy` and owns
the tier -> policy mapping; a consistency test pins the literal stage /
throughput numbers here to `core.cordic.PARETO_STAGES` /
`core.fxp.FORMATS`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["PrecisionTier", "TIERS", "TIER_LADDER", "tier_index"]


@dataclasses.dataclass(frozen=True)
class PrecisionTier:
    """One rung of the serving-precision ladder (ordered cheap -> best)."""
    name: str                    # 'fxp4' | 'fxp8' | 'fxp16' | 'bf16'
    bits: Optional[int]          # FxP bit width; None = native bf16
    throughput_x: int            # paper Table I relative SIMD throughput
    hr_stages: Optional[int]     # CORDIC Pareto pick (None: exact AFs)
    lv_stages: Optional[int]
    mae_bound: float             # max range-relative AF MAE at the pick
    cordic_excess_bound: float   # paper envelope on CORDIC-induced loss

    @property
    def quantized(self) -> bool:
        return self.bits is not None


#: Cheapest (most degraded, highest throughput) first — the order the
#: pressure-degradation walk falls DOWN and the quality walk climbs UP.
TIER_LADDER: tuple = (
    PrecisionTier("fxp4", 4, 16, 4, 4, mae_bound=0.045,
                  cordic_excess_bound=0.03),
    PrecisionTier("fxp8", 8, 8, 4, 5, mae_bound=0.02,
                  cordic_excess_bound=0.02),
    PrecisionTier("fxp16", 16, 4, 4, 5, mae_bound=0.02,
                  cordic_excess_bound=0.02),
    # native precision: exact AFs, no CORDIC datapath, no quantization —
    # the zero-accuracy-loss anchor of the ladder
    PrecisionTier("bf16", None, 1, None, None, mae_bound=0.0,
                  cordic_excess_bound=0.0),
)

TIERS: dict = {t.name: t for t in TIER_LADDER}


def tier_index(name: str) -> int:
    """Ladder position of `name` (0 = cheapest). Raises ValueError with
    the valid names for anything unknown — the error surface request
    validation and the router lean on."""
    for i, t in enumerate(TIER_LADDER):
        if t.name == name:
            return i
    raise ValueError(f"unknown precision tier {name!r}; choose from "
                     f"{[t.name for t in TIER_LADDER]}")
