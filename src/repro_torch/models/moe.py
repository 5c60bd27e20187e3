"""Mixture-of-Experts layer: top-k capacity routing (GShard-style) over
fine-grained routed experts plus always-on shared experts (DeepSeekMoE).

Dispatch is group-local, as in the reference: tokens are viewed as
[G, Sg, D] groups of about 512, each token's k choices take the next
free slot of their expert's queue (capacity `cap`), and an index scatter
fills the [G, E, cap, D] expert input. The expert banks run through
`qeinsum` (one batched GEMM launch per bank on the kernels backend), and
a gather with zero fill brings each choice's output back, weighted by
its renormalised gate.

The router softmax is a Flex-PE call site: under a CORDIC policy the
gate probabilities come from the HR-exp + LV-divide datapath, snapped to
the FxP grid, so ties between experts are common. `top_k` breaks them
toward the lower expert index, as `jax.lax.top_k` does (`torch.topk`
does not promise an order among equal values).

Serving only: the load-balance aux loss and expert-parallel sharding of
the reference are not ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.precision import (PrecisionPolicy, qeinsum, qmatmul,
                              quantize_activation)

__all__ = ["CAPACITY_FACTOR", "moe_init", "moe_ffn", "top_k"]

CAPACITY_FACTOR = 1.25


def moe_init(normal, n_layers: int, cfg, dtype=torch.bfloat16):
    """Layer-stacked MoE weights with the reference's distributions: an
    f32 router N(0, 1/d), routed banks [L, E, K, N] scaled by 1/sqrt(d)
    (w1, w3) and 1/sqrt(ff) (w2), shared experts N(0, 1/d_in).
    `normal(shape, std, dtype)` draws one leaf."""
    L, d, e = n_layers, cfg.d_model, cfg.n_experts
    ff = cfg.expert_ff or cfg.d_ff
    p = {"router": normal((L, d, e), 1.0 / math.sqrt(d), torch.float32),
         "w1": normal((L, e, d, ff), 1.0 / math.sqrt(d), dtype),
         "w3": normal((L, e, d, ff), 1.0 / math.sqrt(d), dtype),
         "w2": normal((L, e, ff, d), 1.0 / math.sqrt(ff), dtype)}
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        p["shared"] = {"w1": normal((L, d, sff), 1.0 / math.sqrt(d), dtype),
                       "w3": normal((L, d, sff), 1.0 / math.sqrt(d), dtype),
                       "w2": normal((L, sff, d), 1.0 / math.sqrt(sff),
                                    dtype)}
    return p


def top_k(x: torch.Tensor, k: int):
    """The k largest values of the last axis and their indices, largest
    first, equal values in increasing index order (`jax.lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _act(h, act, policy):
    if policy is not None and policy.af is not None:
        return policy.act(h, "silu" if act == "silu" else "gelu")
    if act == "silu":
        return torch.nn.functional.silu(h)
    return torch.nn.functional.gelu(h, approximate="tanh")


def moe_ffn(p, x: torch.Tensor, cfg, policy: Optional[PrecisionPolicy] = None,
            n_groups: int = 0, dropless: bool = False, shard=None):
    """x: [B, S, D] -> [B, S, D] (the reference's output without its aux
    metrics). `dropless` sizes every queue for the worst case, as serving
    does: no (token, choice) is dropped."""
    if shard is not None:
        raise NotImplementedError("sharded MoE is ROADMAP.md queue 1, item 9")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    tokens = b * s
    g = n_groups or max(1, tokens // 512)
    while tokens % g:
        g -= 1
    sg = tokens // g
    xt = x.reshape(g, sg, d)

    logits = qmatmul(xt.float(), p["router"], None)          # [G, Sg, E]
    if policy is not None and policy.attn_softmax == "cordic":
        probs = policy.softmax(logits, axis=-1)
    else:
        probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                    # [G, Sg, k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    cap = sg * k if dropless else int(max(k * sg / e * CAPACITY_FACTOR, 4))
    # A token's k experts are distinct, so no queue holds more than Sg
    # entries: slots past Sg stay zero rows whatever cap says. Zero rows
    # change no per-tensor activation scale and give zero outputs that no
    # token gathers, so cutting cap to Sg gives the same bits with fewer
    # rows (4 instead of 24 per expert at decode).
    cap = min(cap, sg)
    # each (token, choice)'s slot in its expert's queue, token-major
    flat = torch.nn.functional.one_hot(gate_idx, e).reshape(g, sg * k, e)
    pos = ((torch.cumsum(flat, dim=1) - 1) * flat).sum(-1).reshape(g, sg, k)
    keep = pos < cap
    gate_vals = gate_vals * keep
    slot = torch.where(keep, gate_idx * cap + pos, e * cap)  # e*cap: dropped
    slot_flat = slot.reshape(g, sg * k, 1).expand(g, sg * k, d)

    # index dispatch: kept slots are distinct, dropped ones land in a
    # spare row that is cut off
    src = xt.repeat_interleave(k, dim=1)                     # [G, Sg*k, D]
    buf = torch.zeros((g, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, slot_flat, src)
    xe = buf[:, :e * cap].reshape(g, e, cap, d)

    h = qeinsum("gecd,edf->gecf", xe, p["w1"], policy)
    h = _act(h, cfg.act, policy)
    if "w3" in p and cfg.act == "silu":
        h = h * qeinsum("gecd,edf->gecf", xe, p["w3"], policy)
    ye = qeinsum("gecf,efd->gecd", h, p["w2"], policy)       # [G,E,cap,D]

    # combine: a zero row stands for the dropped slot; the k weighted
    # choices are summed in f32 and rounded once, as XLA's bf16 sum does
    ye_flat = torch.cat([ye.reshape(g, e * cap, d),
                         torch.zeros((g, 1, d), dtype=ye.dtype,
                                     device=ye.device)], dim=1)
    picked = torch.gather(ye_flat, 1, slot_flat).reshape(g, sg, k, d)
    y = (picked * gate_vals.reshape(g, sg, k, 1).to(ye.dtype)
         ).float().sum(2).to(ye.dtype)                       # [G, Sg, D]

    if "shared" in p:
        sh = p["shared"]
        xa = quantize_activation(xt, sh["w1"], policy)     # one grid for both
        hs = _act(qmatmul(xa, sh["w1"], policy), cfg.act, policy)
        if cfg.act == "silu":
            hs = hs * qmatmul(xa, sh["w3"], policy)
        y = y + qmatmul(hs, sh["w2"], policy)
    return y.reshape(b, s, d)
